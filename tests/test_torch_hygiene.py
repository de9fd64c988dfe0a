"""Import hygiene of the port: `repro_torch` imports neither JAX nor any
module of the JAX package, and the modules (and functions) it keeps as
verbatim copies of `repro` stay equal to their originals after the
`repro.` -> `repro_torch.` prefix swap (and with the reference's
history tags dropped), so they cannot drift silently."""
import ast
import os
import re
import subprocess
import sys

import pytest

import repro_torch

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _swap(text: str) -> str:
    """The copy rule: the import prefix swapped, and the reference's
    upper-case history tags with a number, "(TAG 6)", "(TAG 3; ..." or
    "(..., TAG 10)", dropped from comments and docstrings."""
    text = re.sub(r"[A-Z]+ \d+; ", "", text)
    text = re.sub(r" ?\([A-Z]+ \d+\)", "", text)
    text = re.sub(r", [A-Z]+ \d+\)", ")", text)
    return re.sub(r"\brepro\.", "repro_torch.", text)


def _read(pkg: str, rel: str) -> str:
    with open(os.path.join(SRC, pkg, rel)) as f:
        return f.read()


def test_port_imports_no_jax_and_nothing_of_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert len(names) > 40, names\n"
        "for m in ('repro_torch.models.moe', 'repro_torch.models.attention',\n"
        "          'repro_torch.examples.serve_with_snapshot',\n"
        "          'repro_torch.comm.transport.harness',\n"
        "          'repro_torch.core.restore', 'repro_torch.core.image_store',\n"
        "          'repro_torch.examples.multirank_simulation',\n"
        "          'repro_torch.launch.train',\n"
        "          'repro_torch.examples.quickstart',\n"
        "          'repro_torch.examples.train_with_preemption'):\n"
        "    assert m in names, m\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


def test_package_import_stays_light():
    """Socket rank processes import the package: it must not pull in
    torch (nor JAX) before a rank asks for a tensor."""
    code = ("import sys, repro_torch, repro_torch.comm.transport.harness\n"
            "repro_torch.restore_world, repro_torch.open_store\n"
            "assert 'torch' not in sys.modules\n"
            "assert 'jax' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


@pytest.mark.parametrize("rel", repro_torch.VERBATIM_COPIES)
def test_verbatim_module_copies(rel):
    assert _read("repro_torch", rel) == _swap(_read("repro", rel)), rel


def _top_level(source: str, name: str) -> str:
    for node in ast.parse(source).body:
        if (isinstance(node, (ast.FunctionDef, ast.ClassDef))
                and node.name == name):
            return ast.get_source_segment(source, node)
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == name for t in node.targets):
            return ast.get_source_segment(source, node)
    raise AssertionError(f"{name} not found")


@pytest.mark.parametrize("rel,name", repro_torch.VERBATIM_FUNCTIONS)
def test_verbatim_function_copies(rel, name):
    ours = _top_level(_read("repro_torch", rel), name)
    theirs = _top_level(_swap(_read("repro", rel)), name)
    assert ours == theirs, f"{rel}:{name}"


_ROOT = os.path.join(os.path.dirname(__file__), "..")
_CARD_SCRIPTS = ["chip_smoke.py"] + sorted(
    os.path.join("tools", f) for f in os.listdir(os.path.join(_ROOT, "tools"))
    if f.endswith(".py"))


@pytest.mark.parametrize("rel", _CARD_SCRIPTS)
def test_card_scripts_import_no_jax_and_nothing_of_repro(rel):
    """The scripts run on the card's machine, which has no JAX: every
    import in them, at any depth of the file, is of the port or of
    neither package."""
    with open(os.path.join(_ROOT, rel)) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module and not n.level]
    assert any(m.startswith("repro_torch") for m in names), rel
    bad = [m for m in names if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, (rel, bad)


# PyTorch's fused attention and compiler, and packages of finished
# attention kernels: the port's attention is its own kernel
_LIBRARY_CALLS = {"scaled_dot_product_attention",
                  "_scaled_dot_product_flash_attention",
                  "_scaled_dot_product_efficient_attention",
                  "_scaled_dot_product_cudnn_attention",
                  "_flash_attention_forward", "flex_attention"}
_KERNEL_PACKAGES = ("flash_attn", "flash_attn_interface", "xformers",
                    "flashinfer", "transformer_engine", "apex", "triton",
                    "torch._dynamo", "torch._inductor", "torch.nn.attention")
_PORT_MODULES = sorted(
    os.path.relpath(os.path.join(d, f), os.path.join(SRC, "repro_torch"))
    for d, _, fs in os.walk(os.path.join(SRC, "repro_torch"))
    for f in fs if f.endswith(".py"))


@pytest.mark.parametrize("rel", _PORT_MODULES)
def test_port_calls_no_library_attention_or_compiler(rel):
    """No module of the port calls `scaled_dot_product_attention` (or
    another of PyTorch's fused attention ops) or `torch.compile`, or
    imports a package of finished attention kernels."""
    tree = ast.parse(_read("repro_torch", rel))
    bad = [n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)
           and (n.attr in _LIBRARY_CALLS or (
               n.attr == "compile" and isinstance(n.value, ast.Name)
               and n.value.id == "torch"))]
    bad += [n.id for n in ast.walk(tree)
            if isinstance(n, ast.Name) and n.id in _LIBRARY_CALLS]
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module and not n.level]
    bad += [m for m in names
            if any(m == p or m.startswith(p + ".") for p in _KERNEL_PACKAGES)]
    bad += [a.name for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)
            for a in n.names if a.name in _LIBRARY_CALLS]
    assert not bad, (rel, bad)
