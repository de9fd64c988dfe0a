"""The port's entry points on the CPU: the training CLI
(`python -m repro_torch.launch.train`), the quickstart and preemption
twins, and the runtime's process-wide footprint (the SIGUSR1 handler,
the deterministic-algorithms switch).  Reduced qwen2-0.5b, and reduced
hymba-1.5b, rwkv6-3b, whisper-large-v3 and llama-3.2-vision-11b for a
fresh / resumed / uninterrupted CLI run each, B 2 x S 64,
`--device cpu`; the CLI and the quickstart run in subprocesses, the
independent ones side by side, shared through a module-scoped fixture.

Images cross packages both ways: an image written by the reference CLI
(`python -m repro.launch.train`, JAX on the CPU) resumes under the
port's `--resume`, and the reverse.  The two stacks draw their initial
params differently, so fresh runs are never compared across packages;
after a restore both hold the same params, bit for bit.

Tolerances: none within the port (a resume prints the uninterrupted
run's losses exactly) and for the images' `extra` (`run_meta`, `data`:
equal); across packages the resumed losses agree with the other
package's uninterrupted run to 2e-2 relative, the bf16 tolerance of
tests/test_torch_model.py.
"""
import json
import math
import os
import shutil
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, reduced_config
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.core.runtime import MANARuntime

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
FLAGS = ["--arch", "qwen2-0.5b", "--reduced", "--batch", "2", "--seq", "64",
         "--ckpt-every-steps", "2", "--delta-params"]
PORT = [sys.executable, "-m", "repro_torch.launch.train", *FLAGS,
        "--device", "cpu"]
HYBRID = [*PORT[:4], "hymba-1.5b", *PORT[5:]]
RWKV = [*PORT[:4], "rwkv6-3b", *PORT[5:]]
WHISPER = [*PORT[:4], "whisper-large-v3", *PORT[5:]]
VISION = [*PORT[:4], "llama-3.2-vision-11b", *PORT[5:]]
REFERENCE = [sys.executable, "-m", "repro.launch.train", *FLAGS]
ENV = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")


def _start(argv, ckpt_dir=None):
    if ckpt_dir is not None:
        argv = [*argv, "--ckpt-dir", str(ckpt_dir)]
    return subprocess.Popen(argv, env=ENV, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(proc):
    """Standard output lines of a finished run; its JSON lines parsed."""
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    lines = out.splitlines()
    return lines, [json.loads(x) for x in lines if x.startswith("{")]


def _latest_dropped(src, dst):
    """A copy of an image directory without its newest image (6), so
    that `--resume` restores step 4."""
    shutil.copytree(src, dst)
    shutil.rmtree(os.path.join(dst, "ckpt_0000000006"))
    return dst


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every subprocess run of this file, in two waves of runs that may
    go side by side: fresh and uninterrupted runs, then the resumes."""
    d = tmp_path_factory.mktemp("entrypoints")
    first = {
        "fresh": _start(PORT + ["--steps", "4"], d / "a"),
        "port6": _start(PORT + ["--steps", "6"], d / "b"),
        "ref6": _start(REFERENCE + ["--steps", "6"], d / "r"),
        "socket_int8": _start(PORT + ["--steps", "4", "--transport", "socket",
                                      "--quantize-moments"], d / "s"),
        "quickstart": _start([sys.executable, "-m",
                              "repro_torch.examples.quickstart", "--device",
                              "cpu", "--ckpt-dir", str(d / "q")]),
        "hybrid_fresh": _start(HYBRID + ["--steps", "4"], d / "h"),
        "hybrid6": _start(HYBRID + ["--steps", "6"], d / "h6"),
        "rwkv_fresh": _start(RWKV + ["--steps", "4"], d / "w"),
        "rwkv6": _start(RWKV + ["--steps", "6"], d / "w6"),
        "whisper_fresh": _start(WHISPER + ["--steps", "4"], d / "e"),
        "whisper6": _start(WHISPER + ["--steps", "6"], d / "e6"),
        "vision_fresh": _start(VISION + ["--steps", "4"], d / "v"),
        "vision6": _start(VISION + ["--steps", "6"], d / "v6"),
    }
    out = {k: _finish(p) for k, p in first.items()}
    second = {
        "resume": _start(PORT + ["--steps", "2", "--resume"], d / "a"),
        "port_from_ref": _start(PORT + ["--steps", "2", "--resume"],
                                _latest_dropped(d / "r", d / "x")),
        "ref_from_port": _start(REFERENCE + ["--steps", "2", "--resume"],
                                _latest_dropped(d / "b", d / "y")),
        "socket_int8_resume": _start(
            PORT + ["--steps", "2", "--resume", "--transport", "socket",
                    "--quantize-moments"], d / "s"),
        "hybrid_resume": _start(HYBRID + ["--steps", "2", "--resume"],
                                d / "h"),
        "rwkv_resume": _start(RWKV + ["--steps", "2", "--resume"], d / "w"),
        "whisper_resume": _start(WHISPER + ["--steps", "2", "--resume"],
                                 d / "e"),
        "vision_resume": _start(VISION + ["--steps", "2", "--resume"],
                                d / "v"),
    }
    out.update({k: _finish(p) for k, p in second.items()})
    out["dir"] = d
    return out


def _losses(hist, steps=(4, 5)):
    return [h["loss"] for h in hist if h["step"] in steps]


def test_cli_resume_repeats_the_uninterrupted_run(runs):
    lines, resumed = runs["resume"]
    assert lines[0] == "resumed from step 4"
    assert [h["step"] for h in resumed] == [4, 5]
    assert _losses(resumed) == _losses(runs["port6"][1])
    assert runs["fresh"][0][0] == "initialized fresh"
    assert runs["fresh"][0][-1] == "checkpoints taken: 2; dir: [2, 4]"
    assert lines[-1] == "checkpoints taken: 1; dir: [2, 4, 6]"


def test_cli_hybrid_resume_repeats_the_uninterrupted_run(runs):
    """`--arch hymba-1.5b --reduced`: 4 steps fresh, `--resume` for 2;
    the resumed losses equal the uninterrupted run's steps 4-5, and the
    images hold the SSM leaves as XOR deltas."""
    lines, resumed = runs["hybrid_resume"]
    assert HYBRID[3:5] == ["--arch", "hymba-1.5b"]
    assert runs["hybrid_fresh"][0][0] == "initialized fresh"
    assert lines[0] == "resumed from step 4"
    assert [h["step"] for h in resumed] == [4, 5]
    assert _losses(resumed) == _losses(runs["hybrid6"][1])
    assert all(math.isfinite(h["loss"]) for h in runs["hybrid6"][1])
    with open(os.path.join(runs["dir"], "h", "ckpt_0000000004",
                           "manifest.json")) as f:
        arrays = json.load(f)["arrays"]
    assert arrays["params/blocks/mamba/A_log"]["base_step"] == 2
    assert arrays["opt/v/blocks/mamba/conv_w"]["dtype"] == "float32"


def test_cli_rwkv_resume_repeats_the_uninterrupted_run(runs):
    """`--arch rwkv6-3b --reduced`: 4 steps fresh, `--resume` for 2; the
    resumed losses equal the uninterrupted run's steps 4-5, and the
    images hold the time-mix leaves as XOR deltas."""
    lines, resumed = runs["rwkv_resume"]
    assert RWKV[3:5] == ["--arch", "rwkv6-3b"]
    assert runs["rwkv_fresh"][0][0] == "initialized fresh"
    assert lines[0] == "resumed from step 4"
    assert [h["step"] for h in resumed] == [4, 5]
    assert _losses(resumed) == _losses(runs["rwkv6"][1])
    assert all(math.isfinite(h["loss"]) for h in runs["rwkv6"][1])
    with open(os.path.join(runs["dir"], "w", "ckpt_0000000004",
                           "manifest.json")) as f:
        arrays = json.load(f)["arrays"]
    assert arrays["params/blocks/tm/w0"]["base_step"] == 2
    assert arrays["opt/m/blocks/cm/wck"]["dtype"] == "float32"


def test_cli_encdec_resume_repeats_the_uninterrupted_run(runs):
    """`--arch whisper-large-v3 --reduced`: 4 steps fresh, `--resume` for
    2; the resumed losses equal the uninterrupted run's steps 4-5, and
    the images hold the encoder and cross-attention leaves as XOR
    deltas."""
    lines, resumed = runs["whisper_resume"]
    assert WHISPER[3:5] == ["--arch", "whisper-large-v3"]
    assert runs["whisper_fresh"][0][0] == "initialized fresh"
    assert lines[0] == "resumed from step 4"
    assert [h["step"] for h in resumed] == [4, 5]
    assert _losses(resumed) == _losses(runs["whisper6"][1])
    assert all(math.isfinite(h["loss"]) for h in runs["whisper6"][1])
    with open(os.path.join(runs["dir"], "e", "ckpt_0000000004",
                           "manifest.json")) as f:
        arrays = json.load(f)["arrays"]
    assert arrays["params/enc_blocks/attn/wq"]["base_step"] == 2
    assert arrays["params/blocks/xattn/wk"]["base_step"] == 2
    assert arrays["opt/v/enc_ln_f"]["dtype"] == "float32"


def test_cli_vision_resume_repeats_the_uninterrupted_run(runs):
    """`--arch llama-3.2-vision-11b --reduced`: 4 steps fresh, `--resume`
    for 2; the resumed losses equal the uninterrupted run's steps 4-5,
    and the images hold the self and cross blocks as XOR deltas."""
    lines, resumed = runs["vision_resume"]
    assert VISION[3:5] == ["--arch", "llama-3.2-vision-11b"]
    assert runs["vision_fresh"][0][0] == "initialized fresh"
    assert lines[0] == "resumed from step 4"
    assert [h["step"] for h in resumed] == [4, 5]
    assert _losses(resumed) == _losses(runs["vision6"][1])
    assert all(math.isfinite(h["loss"]) for h in runs["vision6"][1])
    with open(os.path.join(runs["dir"], "v", "ckpt_0000000004",
                           "manifest.json")) as f:
        arrays = json.load(f)["arrays"]
    assert arrays["params/self_blocks/attn/wq"]["base_step"] == 2
    assert arrays["params/cross_blocks/xattn/wk"]["base_step"] == 2
    assert arrays["opt/v/cross_blocks/lnx"]["dtype"] == "float32"


def test_cli_socket_transport_and_int8_moments_resume(runs):
    """Over the socket transport, with int8 moments: the resume restores
    step 4 with its params exact (so step 4's loss repeats exactly; step
    5 follows dequantized moments)."""
    lines, resumed = runs["socket_int8_resume"]
    assert lines[0] == "resumed from step 4"
    assert [h["step"] for h in resumed] == [4, 5]
    assert resumed[0]["loss"] == _losses(runs["port6"][1], (4,))[0]
    assert all(math.isfinite(h["loss"]) for h in resumed)
    with open(os.path.join(runs["dir"], "s", "ckpt_0000000004",
                           "manifest.json")) as f:
        arrays = json.load(f)["arrays"]
    assert {e["encoding"] for p, e in arrays.items()
            if p.startswith("opt/m")} == {"int8_block"}


@pytest.mark.parametrize("resumed,other", [("port_from_ref", "ref6"),
                                           ("ref_from_port", "port6")])
def test_cli_images_resume_across_packages(runs, resumed, other):
    lines, hist = runs[resumed]
    assert lines[0] == "resumed from step 4"
    np.testing.assert_allclose(_losses(hist), _losses(runs[other][1]),
                               rtol=2e-2)


def test_cli_images_carry_the_same_extra_in_both_packages(runs):
    extra = {}
    for d in ("r", "b"):
        with open(os.path.join(runs["dir"], d, "ckpt_0000000004",
                               "manifest.json")) as f:
            extra[d] = json.load(f)["extra"]
    for key in ("run_meta", "data"):
        assert extra["r"][key] == extra["b"][key], key
    assert extra["b"]["data"] == {"seed": 0, "step": 4}


def test_quickstart_twin_restores_and_resumes(runs):
    lines, _ = runs["quickstart"]
    assert "restored at step 16" in lines
    resumed = [x for x in lines if x.endswith("(resumed)")]
    assert [int(x.split()[1]) for x in resumed] == [16, 17, 18, 19, 20]


def test_preemption_twin_passes(monkeypatch, capsys, tmp_path):
    from repro_torch.examples import train_with_preemption as twin

    monkeypatch.setattr(twin, "make_cfg",
                        lambda: reduced_config(ARCHS["qwen2-0.5b"]))
    twin.main(["--steps", "6", "--device", "cpu", "--ckpt-dir",
               str(tmp_path / "p")])
    out = capsys.readouterr().out.splitlines()
    assert "checkpointed at step 4; crashing now" in out
    assert out[-1].startswith("PASS: 2 post-restart steps bit-identical")


def _runtime(tmp_path, **kw):
    cfg = reduced_config(ARCHS["qwen2-0.5b"])
    rc = RunConfig(model=cfg, shape=ShapeConfig("s", 64, 2, "train"),
                   loss_chunk=32, attn_chunk=16)
    return MANARuntime(cfg, rc, ckpt_dir=str(tmp_path), device="cpu", **kw)


def test_sigusr1_checkpoints_at_the_next_safe_point(tmp_path):
    """SIGUSR1 during step 1 commits an image at step 2; close() puts
    the handler it replaced back."""
    prev = signal.getsignal(signal.SIGUSR1)
    mine = lambda *_: None
    signal.signal(signal.SIGUSR1, mine)
    try:
        rt = _runtime(tmp_path, install_signal_handler=True)
        assert signal.getsignal(signal.SIGUSR1) is not mine
        rt.initialize()
        rt.run(3, on_metrics=lambda s, m: s == 1 and os.kill(
            os.getpid(), signal.SIGUSR1))
        assert rt.checkpoints_taken == 1 and rt.ckpt.steps() == [2]
        rt.close()
        assert signal.getsignal(signal.SIGUSR1) is mine
    finally:
        signal.signal(signal.SIGUSR1, prev)


@pytest.mark.parametrize("mode", [False, True])
def test_runtime_leaves_the_deterministic_switch_as_it_found_it(tmp_path,
                                                                mode):
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(mode)
    try:
        rt = _runtime(tmp_path, ckpt_every_steps=2, delta_params=True)
        rt.initialize()
        rt.run(3)
        assert rt.restore(2) == 2
        rt.close()
        assert torch.are_deterministic_algorithms_enabled() is mode
    finally:
        torch.use_deterministic_algorithms(was)


def test_cli_without_a_card_exits_and_names_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the CLI would run on it")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen2-0.5b", "--reduced", "--steps", "1", "--ckpt-dir",
         str(tmp_path)], env=ENV, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0
    assert "CUDA" in out.stderr
    assert not os.listdir(tmp_path)
