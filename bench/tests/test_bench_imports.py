"""What the benchmark loads: no module of JAX or of the JAX package,
compared by whole top-level name, and a reference that imports nothing
of the program."""
import ast
import os
import subprocess
import sys

from bench import harness

BENCH = os.path.join(harness.ROOT, "bench")


def test_forbidden_is_a_whole_top_level_name(monkeypatch):
    for name in ("repro_torch", "repro_torch.core", "reproducible", "jaxx"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert not any(m.split(".")[0] in ("repro", "jax")
                   for m in harness.forbidden_modules())
    for name in ("repro", "repro.core.codec", "jax.numpy", "jaxlib", "flax"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert {"repro", "repro.core.codec", "jax.numpy", "jaxlib",
            "flax"} <= set(harness.forbidden_modules())


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            tops = {m.split(".")[0] for m in _imports(os.path.join(ref, f))}
            assert not tops & {"repro_torch", "repro", "jax", "jaxlib",
                               "flax"}, (f, tops)


def test_no_bench_file_imports_jax_or_the_jax_package():
    for dirpath, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                tops = {m.split(".")[0]
                        for m in _imports(os.path.join(dirpath, f))}
                assert not tops & {"repro", "jax", "jaxlib", "flax"}, f


def test_what_a_run_loads_has_no_jax():
    """Everything a run imports, in a fresh process."""
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "from bench import harness, training, calibrate\n"
            "from bench.drivers import train, recover\n"
            "from repro_torch.core.runtime import MANARuntime\n"
            "print(harness.forbidden_modules())\n"
            "from bench.reference import model, image\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] == "
            "'repro_torch' and m not in ('repro_torch',)) == [] or 'x')\n"
            % (harness.ROOT, os.path.join(harness.ROOT, "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=dict(os.environ,
                                                          PYTHONPATH=""))
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[0] == "[]"


def test_reference_alone_loads_no_program():
    code = ("import sys; sys.path[:0] = [%r]\n"
            "from bench.reference import model, image\n"
            "print([m for m in sys.modules if m.split('.')[0] in "
            "('repro_torch', 'repro', 'jax')])\n" % harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=dict(os.environ,
                                                          PYTHONPATH=""))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
