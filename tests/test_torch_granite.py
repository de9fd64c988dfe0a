"""granite-4.0-h-micro in the port: the `layer_types` stack of Mamba-2
and GQA attention blocks, and its chunked SSD.

The SSD (`linear_attention.chunked_ssd`) against a step-by-step float64
recurrence, with per-step log decays dt A far below the engine's clamp
(-2.5): forward, final state and gradients.  The program's model against
the benchmark's plain reference (`bench/reference/hybrid.py`) on the
benchmark's seeded state at a reduced size with the published pattern
(one period: 5 Mamba-2, 1 attention, 4 Mamba-2) and multipliers, in
float32: the loss, every leaf's gradient, and three AdamW steps; the
reference's SSD runs at another chunk than the program's.  The image of
a hybrid state written and restored through `MANARuntime` bit for bit;
serving raises; the spans of the mixers and their backward; whole
CPU runs of the benchmark's `train_hybrid` driver (in a process of their
own, which loads no JAX), sound and with a half-batch step planted.
"""
import copy
import dataclasses
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench import harness  # noqa: E402
from bench import hybrid_state as HS  # noqa: E402
from bench import state as S  # noqa: E402
from bench.drivers import train_hybrid as D  # noqa: E402
from bench.reference import hybrid as ref_hybrid  # noqa: E402
from bench.reference.model import Ops  # noqa: E402
from repro_torch import trace  # noqa: E402
from repro_torch.configs import ARCHS, reduced_config  # noqa: E402
from repro_torch.configs.base import RunConfig, ShapeConfig  # noqa: E402
from repro_torch.core.runtime import MANARuntime  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.linear_attention import chunked_ssd  # noqa: E402
from repro_torch.training.step import (abstract_train_state,  # noqa: E402
                                       make_train_step)

CELL = "granite-4.0-h-micro.train-ckpt-hybrid"
ARCH = "granite-4.0-h-micro"


def tiny_config(dtype: str = "float32") -> dict:
    """The benchmark's configuration at CPU widths, one published period:
    4 heads over 2 KV heads of 16 (stored 8 over 2, padded), 4 SSM heads
    of 16, state 8; the reference's SSD chunk 16, the program's 8."""
    c = harness.load_json(os.path.join(ROOT, "bench", "configs",
                                       ARCH + ".json"))
    period = c["layer_types"][:10]
    c.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
             intermediate_size=128, shared_intermediate_size=128,
             vocab_size=256, mamba_n_heads=4, mamba_d_head=16,
             mamba_d_state=8, mamba_chunk_size=16, num_hidden_layers=10,
             layer_types=period)
    c["run"] = dict(c["run"], pad_to=8, loss_chunk=32, attn_chunk=16,
                    ssd_chunk=8, dtype=dtype)
    return c


def _recurrence(x, dt, A, Bm, Cm):
    b, S_, H, P = x.shape
    G, N = Bm.shape[2:]
    g = torch.arange(H) * G // H
    h = torch.zeros(b, H, P, N, dtype=x.dtype)
    ys = []
    for t in range(S_):
        h = (h * torch.exp(dt[:, t] * A)[..., None, None]
             + (dt[:, t, :, None] * x[:, t])[..., None]
             * Bm[:, t][:, g][:, :, None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Cm[:, t][:, g]))
    return torch.stack(ys, 1), h


@pytest.mark.parametrize("chunk", [1, 5, 8, 64])
def test_ssd_matches_the_recurrence_past_the_clamp(chunk):
    """Per-step log decays down to -30 (the engine clamps at -2.5):
    outputs, final state and the gradients of x, dt, A, B and C agree
    with the float64 recurrence to f32 rounding."""
    gen = torch.Generator().manual_seed(chunk)
    b, S_, H, P, G, N = 2, 40, 4, 3, 2, 5
    f64 = torch.float64
    x = torch.randn(b, S_, H, P, generator=gen, dtype=f64)
    dt = torch.rand(b, S_, H, generator=gen, dtype=f64) * 2
    A = -torch.tensor([1.0, 4.0, 9.0, 16.0], dtype=f64)
    Bm = torch.randn(b, S_, G, N, generator=gen, dtype=f64)
    Cm = torch.randn(b, S_, G, N, generator=gen, dtype=f64)
    assert float((dt * A).min()) < -20 and (dt * A < -2.5).double().mean() > 0.5
    ins = [t.requires_grad_(True) for t in (x, dt, A, Bm, Cm)]
    y, h = chunked_ssd(*(t.float() for t in ins), chunk=chunk)
    yr, hr = _recurrence(*ins)
    w = torch.randn(yr.shape, generator=gen, dtype=f64)
    assert (y.double() - yr).norm() <= 1e-5 * yr.norm()
    assert (h.double() - hr).norm() <= 1e-5 * hr.norm()
    got = torch.autograd.grad((y.double() * w).sum(), ins)
    want = torch.autograd.grad((yr * w).sum(), ins)
    for name, a, e in zip("x dt A B C".split(), got, want):
        assert (a - e).norm() <= 1e-4 * e.norm(), name


def test_published_counts():
    cfg = ARCHS[ARCH]
    cut = dataclasses.replace(cfg, n_layers=20, layer_types=cfg.layer_types[:20])
    assert cfg.layer_types.count("attention") == 4
    assert [i for i, t in enumerate(cfg.layer_types) if t == "attention"] \
        == [5, 15, 25, 35]
    assert cfg.param_count() == 3_191_396_096
    assert cut.param_count() == 1_698_459_520
    assert reduced_config(cfg).layer_types == cfg.layer_types[:10]


def test_layout_is_the_programs():
    """The benchmark's hybrid state layout at the published sizes (20
    layers) is the program's abstract train state's."""
    c = harness.load_json(os.path.join(ROOT, "bench", "configs",
                                       ARCH + ".json"))
    cfg, rc = D.program_config(c, {"name": "t", "batch": 1, "seq": 256})
    theirs = {k: tuple(v.shape) for k, v in
              S.flat(abstract_train_state(cfg, rc)["params"]).items()}
    mine = {k[len("params/"):]: s for k, (s, _) in
            HS.param_layout(c).items()}
    assert mine == theirs
    assert sum(v.numel() for v in S.flat(abstract_train_state(cfg, rc)[
        "params"]).values()) == cfg.param_count() == 1_698_459_520


def test_frozen_flops_count_the_layouts_products():
    """`bench/hybrid_flops.py` at the published sizes: its matmul params
    are the layout's product leaves (the tied embedding once, as the
    head), and a step of B 1 x S 32768 adds the 2 attention layers'
    causal pairs and the 18 Mamba layers' SSD recurrence."""
    import math

    from bench.hybrid_flops import matmul_params, train_step_flops

    c = harness.load_json(os.path.join(ROOT, "bench", "configs",
                                       ARCH + ".json"))
    products = ("in_proj", "out_proj", "wi", "wg", "wo", "wq", "wk", "wv",
                "embedding")
    n = sum(math.prod(s) for p, (s, _) in HS.param_layout(c).items()
            if p.rsplit("/", 1)[-1] in products)
    assert matmul_params(c) == n == 1_697_906_688
    S_ = 32768
    assert train_step_flops(c, 1, S_) == (
        6 * n * S_ + 3 * 4 * 64 * 32 * (S_ * (S_ + 1) // 2) * 2
        + 3 * 4 * 128 * 64 * 64 * S_ * 18)


def _batches(c, n, batch=2, seq=64, seed=5):
    data = S.TokenBatches(c["vocab_size"], batch, seq, seed)
    return [{k: torch.from_numpy(v) for k, v in data.get_batch(i).items()}
            for i in range(n)]


def test_program_follows_the_reference():
    """Seeded state, float32: the loss and every leaf's gradient of the
    program's `forward_loss` against the reference's, then three AdamW
    steps of the program's train step against the reference's."""
    c = tiny_config()
    cfg, rc = D.program_config(c, {"name": "t", "batch": 2, "seq": 64})
    batches = _batches(c, 3)
    p0 = {k[len("params/"):]: v for k, v in HS.make_params(c, 5, "cpu").items()}
    leaves = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    loss, _ = T.forward_loss(S.nest(leaves), cfg, rc, None, batches[0])
    grads = torch.autograd.grad(loss, list(leaves.values()))
    rl = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    ref_loss = ref_hybrid.loss_fn(c, Ops("f32"), S.nest(rl),
                                  batches[0]["tokens"], batches[0]["labels"],
                                  chunk=32)
    ref_grads = torch.autograd.grad(ref_loss, list(rl.values()))
    assert float(loss.detach()) == pytest.approx(float(ref_loss.detach()),
                                                rel=1e-5)
    for k, g, r in zip(leaves, grads, ref_grads):
        assert (g - r).norm() <= 2e-4 * r.norm() + 1e-9, k
    step = make_train_step(cfg, rc)
    state = HS.make_train_state(c, 5, "cpu")
    losses = []
    for b in batches:
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))
    ref = ref_hybrid.train(c, p0, batches)
    assert losses == pytest.approx(ref["losses"], rel=1e-5)
    got = S.flat(state["params"])
    for k, v in ref["params"].items():
        torch.testing.assert_close(got[k], v, rtol=1e-4, atol=1e-6)


def _rt(cfg, d, **kw):
    rc = RunConfig(model=cfg, shape=ShapeConfig("t", 32, 2, "train"),
                   loss_chunk=16, attn_chunk=16, dtype="float32")
    return MANARuntime(cfg, rc, ckpt_dir=str(d), device="cpu", **kw)


def test_image_round_trip_through_the_runtime(tmp_path):
    """Two steps and an image at step 2 of the reduced model (program
    init); a fresh runtime restores it bit for bit, and its next step's
    loss is the uninterrupted run's."""
    cfg = reduced_config(ARCHS[ARCH])
    rt = _rt(cfg, tmp_path, ckpt_every_steps=2)
    rt.initialize()
    rt.run(2)
    held = {k: v.clone() for k, v in S.flat(rt.state).items()}
    after = rt.run(1)[-1]["loss"]
    rt.close()
    rt2 = _rt(cfg, tmp_path)
    assert rt2.restore(2) == 2
    got = S.flat(rt2.state)
    assert sorted(got) == sorted(held)
    assert all(torch.equal(got[k], held[k]) for k in held)
    assert any(k.startswith("params/mamba_blocks/mamba/") for k in held)
    assert rt2.run(1)[-1]["loss"] == after
    rt2.close()


@pytest.mark.parametrize("entry", ["prefill", "decode_step",
                                   "init_decode_state"])
def test_serving_raises(entry):
    cfg = reduced_config(ARCHS[ARCH])
    rc = RunConfig(model=cfg, shape=ShapeConfig("t", 16, 1, "prefill"),
                   dtype="float32")
    tokens = torch.zeros((1, 16), dtype=torch.int32)
    call = {"prefill": lambda: T.prefill({}, cfg, rc, None,
                                         {"tokens": tokens}),
            "decode_step": lambda: T.decode_step({}, cfg, rc, None, {},
                                                 tokens[:, :1]),
            "init_decode_state": lambda: T.init_decode_state(
                cfg, rc.shape, rc, "cpu")}[entry]
    with pytest.raises(NotImplementedError, match="layer_types"):
        call()


def test_mixer_spans_forward_recompute_and_backward():
    """One train step under remat "full" while recording: each Mamba-2
    layer's mixer and SSD forward twice (the recompute) and backward
    once, each with its layer, seq and chunk, children of a span."""
    cfg = reduced_config(ARCHS[ARCH])
    rc = RunConfig(model=cfg, shape=ShapeConfig("t", 32, 2, "train"),
                   loss_chunk=16, attn_chunk=16, dtype="float32")
    from repro_torch.training.step import init_train_state

    state = init_train_state(cfg, rc, torch.Generator().manual_seed(0), "cpu")
    batch = _batches({"vocab_size": 256}, 1, seq=32)[0]
    trace.reset()
    with trace.recording():
        make_train_step(cfg, rc)(state, batch)
    sp = trace.spans()
    trace.reset()
    mamba = [i for i, t in enumerate(cfg.layer_types) if t == "mamba"]
    for name, per in (("mixer.mamba", 2), ("mixer.mamba.ssd", 2),
                      ("mixer.mamba.backward", 1),
                      ("mixer.mamba.ssd.backward", 1)):
        got = [s for s in sp if s["name"] == name]
        assert sorted(s["attrs"]["layer"] for s in got) == sorted(mamba * per)
        assert all(s["attrs"]["seq"] == 32 and s["attrs"]["chunk"] == 8
                   and s["parent"] is not None for s in got), name


def _pieces(batch=2, seq=64):
    man = harness.manifest()
    p = copy.deepcopy(harness.resolve(man, harness.find_cell(man, CELL)))
    p["config"] = tiny_config()
    p["traffic"] = dict(p["traffic"], batch=batch, seq=seq)
    return p


def _run(seed=2 ** 31 + 29, halve=False):
    """One tiny CPU run of the cell; with `halve` every program step
    trains on the first half of its rows."""
    import repro_torch.training.step as step_mod

    make = step_mod.make_train_step

    def halved(cfg, rc, rules=None):
        inner = make(cfg, rc, rules)
        return lambda state, batch: inner(
            state, {k: v[:v.shape[0] // 2] for k, v in batch.items()})

    if halve:
        step_mod.make_train_step = halved
    try:
        return harness.execute(harness.manifest(), CELL, seed, 1.0, False,
                               device="cpu", pieces=_pieces(),
                               log=lambda *a: None)
    finally:
        step_mod.make_train_step = make


_CELL_RUNS = """
import json, sys
sys.path[:0] = {paths!r}
import test_torch_granite as G
print(json.dumps({{"sound": G._run(), "halved": G._run(halve=True)}}))
"""


@pytest.fixture(scope="module")
def cell_lines():
    """Both runs in a process of their own: the harness refuses to run
    where JAX or the JAX package is loaded, as other test files of a
    worker load them."""
    import json
    import subprocess

    paths = [ROOT, os.path.join(ROOT, "src"), os.path.dirname(__file__)]
    out = subprocess.run([sys.executable, "-c", _CELL_RUNS.format(paths=paths)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_train_hybrid_cell_is_correct(cell_lines):
    line = cell_lines["sound"]
    assert line["correct"], line["checks"]
    assert {"loss_gap", "grad_gap", "change_gap", "resume_grad_gap",
            "resume_change_gap", "image_digests_bad", "image_raw_differ",
            "image_int8_err"} <= set(line["checks"])
    assert line["metrics"]["train_tokens_per_s.ckpt"]["value"] > 0


def test_train_hybrid_cell_fails_with_half_batch(cell_lines):
    line = cell_lines["halved"]
    assert not line["correct"], line["checks"]
