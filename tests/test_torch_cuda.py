"""The port's kernels, runtime and serving path on a CUDA card: each
kernel bit for bit against its plain PyTorch version, launch counting,
a bit-identical resume through MANARuntime, and serving with live
decode-state images (bit-identical continuation after a delta-chain
restore, the SWA ring wrap, MoE capacity drops, the checksum and XOR
launches of a decode-state image), and the wire codec and worlds with
rank state on the card (`SnapshotCodec` blobs from CUDA tensors equal
those from CPU tensors, `decode_chain(device="cuda")` equals the host
decode, a 2-rank socket world of card shards commits and restores).
Marked `cuda`; without a card every test skips.  Run on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: none for kernels, resume and the restore continuation (bit
for bit); card against CPU in float32 (ring wrap, MoE): rtol 1e-4 with
an absolute floor of 1e-4 of the largest magnitude (other summation
orders, as tests/test_torch_model.py).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, reduced_config
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.kernels.checksum import ops as cops
from repro_torch.kernels.checksum import ref as cref
from repro_torch.kernels.delta import ops as dops
from repro_torch.kernels.delta import ref as dref
from repro_torch.kernels.quantize import ops as qops
from repro_torch.kernels.quantize import ref as qref
from repro_torch.tree import tree_map

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("offset,nbytes", [(0, 1), (0, 8192), (3, 8191),
                                           (0, 3 * 8192 + 5), (16, 100000)])
def test_checksum_kernel(dev, offset, nbytes):
    raw = np.random.RandomState(nbytes).randint(0, 256, offset + nbytes)
    t = torch.from_numpy(raw.astype(np.uint8)).to(dev)
    before = cops.launches
    got = cops.checksum(t, offset, nbytes)
    assert cops.launches == before + 1
    assert got == cref.checksum_torch(t, offset, nbytes)
    assert got == cref.checksum_np(raw.astype(np.uint8)[offset:])


@pytest.mark.parametrize("n", [1, 16, 17, 4099, 1 << 20])
def test_xor_kernel(dev, n):
    g = torch.Generator(device=dev)
    g.manual_seed(n)
    a = torch.randint(0, 256, (n + 1,), dtype=torch.uint8, device=dev,
                      generator=g)
    b = torch.randint(0, 256, (n + 1,), dtype=torch.uint8, device=dev,
                      generator=g)
    for x, y in ((a[:n], b[:n]), (a[1:], b[:n])):      # aligned, unaligned
        assert torch.equal(dops.xor_bytes(x, y), dref.xor_torch(x, y))


@pytest.mark.parametrize("n", [1000, 1024, 5000, 3 * 1024 * 1024 + 7])
def test_quantize_kernel(dev, n):
    g = torch.Generator(device=dev)
    g.manual_seed(n)
    x = torch.randn(n, generator=g, device=dev) * 1e-3
    q, s, pad = qops.quantize(x)
    q2, s2, pad2 = qref.quantize_torch(x)
    assert pad == pad2 and torch.equal(q, q2) and torch.equal(s, s2)
    qn, sn, _ = qref.quantize_np(x.cpu().numpy())
    np.testing.assert_array_equal(q.cpu().numpy(), qn)
    np.testing.assert_array_equal(s.cpu().numpy(), sn)


@pytest.mark.parametrize("n", [1000, 1024, 5000, 3 * 1024 * 1024 + 7])
def test_dequantize_kernel(dev, n):
    g = torch.Generator(device=dev)
    g.manual_seed(n)
    q, s, pad = qref.quantize_torch(torch.randn(n, generator=g, device=dev))
    before = qops.dequantize_launches
    x = qops.dequantize(q, s, pad, (n,))
    assert qops.dequantize_launches == before + 1
    assert torch.equal(x, qref.dequantize_torch(q.view(-1), s.view(-1), n))
    np.testing.assert_array_equal(x.cpu().numpy(), qref.dequantize_np(
        q.cpu().numpy(), s.cpu().numpy(), pad, (n,), np.float32))
    # unaligned codes and output take the scalar path
    q1 = torch.empty(q.numel() + 1, dtype=torch.int8, device=dev)[1:]
    q1.copy_(q.view(-1))
    assert torch.equal(qops.dequantize(q1, s, pad, (n,)), x)


def test_runtime_resume_on_card(dev, tmp_path):
    """Delta params + int8 moments launch all four kernels on the main
    path (writes and a restore); with delta params alone the resume is
    bit-identical."""
    from repro_torch.core.runtime import MANARuntime

    cfg = reduced_config(ARCHS["qwen2-0.5b"])
    rc = RunConfig(model=cfg, shape=ShapeConfig("s", 64, 2, "train"),
                   loss_chunk=32, attn_chunk=16)
    counts = lambda: (cops.launches, dops.launches, qops.launches,
                      qops.dequantize_launches)
    before = counts()
    rt = MANARuntime(cfg, rc, ckpt_dir=str(tmp_path / "int8"),
                     ckpt_every_steps=2, delta_params=True,
                     quantize_moments=True)
    rt.initialize()
    rt.run(4)
    assert rt.ckpt.restore(4)[0]["params"]["ln_f"].device.type == "cuda"
    assert all(c > c0 for c, c0 in zip(counts(), before))

    torch.use_deterministic_algorithms(True)
    try:
        rt = MANARuntime(cfg, rc, ckpt_dir=str(tmp_path / "delta"),
                         ckpt_every_steps=2, delta_params=True)
        rt.initialize()
        hist = rt.run(4)
        rt2 = MANARuntime(cfg, rc, ckpt_dir=str(tmp_path / "delta"),
                          delta_params=True)
        assert rt2.restore(2) == 2
        assert [h["loss"] for h in rt2.run(2)] == \
            [h["loss"] for h in hist][2:4]
    finally:
        torch.use_deterministic_algorithms(False)


# ---------------------------------------------------------------------------
# serving on the card
# ---------------------------------------------------------------------------

def _serve(dev, dtype="bfloat16"):
    from repro_torch.models.transformer import init_params
    from repro_torch.training.step import make_serve_steps

    cfg = reduced_config(ARCHS["mixtral-8x7b"])      # MoE + SWA 32
    rc = RunConfig(model=cfg, shape=ShapeConfig("s", 64, 2, "prefill"),
                   attn_chunk=16, dtype=dtype)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    params, _ = init_params(cfg, gen, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                         dtype=torch.int32)
    return (cfg, rc, make_serve_steps(cfg, rc),
            tree_map(lambda t: t.to(dev), params), params, toks)


def test_serve_restore_continuation_on_card(dev, tmp_path):
    """Images at token 6 (full) and 10 (XOR delta); a fresh manager
    restores 10 through the chain on the card; tokens 11-15 and their
    logits equal the uninterrupted run bit for bit.  The writes and the
    restore launch the checksum and XOR kernels."""
    from repro_torch.core.checkpoint import CheckpointManager
    from repro_torch.models.transformer import decode_state_logical

    cfg, rc, (prefill, serve), params, _, toks = _serve(dev)
    torch.use_deterministic_algorithms(True)
    try:
        logits, st = prefill(params, {"tokens": toks.to(dev)})
        mgr = CheckpointManager(str(tmp_path), delta_keys=("decode",),
                                device=dev)
        c0, x0 = cops.launches, dops.launches
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        outs, gen = [], []
        for i in range(16):
            logits, st = serve(params, st, tok)
            tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
            outs.append(logits)
            gen.append(tok)
            if i in (6, 10):
                mgr.save(i, {"decode": st},
                         {"decode": decode_state_logical(cfg)})
        restored, _ = CheckpointManager(str(tmp_path), device=dev).restore(10)
        assert cops.launches > c0 and dops.launches > x0
        st2, tok2 = restored["decode"], gen[10]
        assert st2["layers"]["k"].device.type == torch.device(dev).type
        for i in range(11, 16):
            logits2, st2 = serve(params, st2, tok2)
            tok2 = torch.argmax(logits2[:, -1], -1).to(torch.int32)[:, None]
            assert torch.equal(logits2, outs[i]) and torch.equal(tok2, gen[i])
    finally:
        torch.use_deterministic_algorithms(False)


def _f32_close(a, b):
    a, b = a.float().cpu().numpy(), b.float().cpu().numpy()
    np.testing.assert_allclose(a, b, rtol=1e-4,
                               atol=1e-4 * float(np.abs(b).max()))


def test_ring_wrap_on_card(dev):
    """Prefill of 64 tokens over a window of 32, then decodes at 64-67
    write ring slots 0-3: the card agrees with the CPU (float32)."""
    cfg, rc, (prefill, serve), params, cpu_params, toks = _serve(
        dev, "float32")
    lc, sc = prefill(cpu_params, {"tokens": toks})
    lg, sg = prefill(params, {"tokens": toks.to(dev)})
    _f32_close(lg, lc)
    for i in range(4):
        tok = toks[:, i:i + 1]
        lc, sc = serve(cpu_params, sc, tok)
        lg, sg = serve(params, sg, tok.to(dev))
        _f32_close(lg, lc)
        for key in ("k", "v"):
            _f32_close(sg["layers"][key], sc["layers"][key])
    assert sg["layers"]["k"].shape[2] == cfg.sliding_window
    assert int(sg["pos"]) == 68


def test_moe_capacity_drop_on_card(dev):
    """A capacity of 4 per 32-token group drops tokens: the card drops
    the same ones (integer cumsum) and agrees with the CPU (float32)."""
    from repro_torch.models.moe import init_moe, moe_apply

    gen = torch.Generator(device="cpu")
    gen.manual_seed(3)
    p, _ = init_moe(gen, 16, 32, 4, 2, device="cpu")
    x = torch.randn(2, 16, 16, generator=gen)
    kw = dict(num_experts=4, top_k=2, split=2, capacity_factor=0.25,
              group_size=32)
    torch.use_deterministic_algorithms(True)
    try:
        yg, ag = moe_apply({k: v.to(dev) for k, v in p.items()}, x.to(dev),
                           **kw)
    finally:
        torch.use_deterministic_algorithms(False)
    yc, ac = moe_apply(p, x, **kw)
    dropped = (yc == 0).all(-1)
    assert dropped.any()
    assert torch.equal((yg.cpu() == 0).all(-1), dropped)
    _f32_close(yg, yc)
    _f32_close(ag["moe_aux"], ac["moe_aux"])


def test_decode_state_image_launches_kernels(dev, tmp_path):
    """A decode-state image digests every chunk on the card (checksum);
    a delta image XORs every leaf against its base (XOR); the restore
    verifies and applies them again."""
    from repro_torch.core.checkpoint import CheckpointManager

    cfg, rc, (prefill, serve), params, _, toks = _serve(dev)
    _, st = prefill(params, {"tokens": toks.to(dev)})
    mgr = CheckpointManager(str(tmp_path), delta_keys=("decode",), device=dev)
    c0, x0 = cops.launches, dops.launches
    mgr.save(1, {"decode": st})
    assert cops.launches == c0 + 3 and dops.launches == x0   # k, v, pos
    _, st2 = serve(params, st, toks[:, :1].to(dev))
    mgr.save(2, {"decode": st2})
    # base read back and verified (3) + delta chunks digested (3); 3 XORs
    assert cops.launches == c0 + 9 and dops.launches == x0 + 3
    got, _ = mgr.restore(2)
    assert cops.launches == c0 + 15 and dops.launches == x0 + 6
    for key in ("k", "v"):
        assert torch.equal(got["decode"]["layers"][key], st2["layers"][key])
    assert int(got["decode"]["pos"]) == 65


# ---------------------------------------------------------------------------
# wire codec and worlds with rank state on the card
# ---------------------------------------------------------------------------

def _wire_arrays(seed):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(3, 5000).astype(np.float32),
            "i": np.arange(4099, dtype=np.int64),
            "q": rng.randn(70000).astype(np.float32)}


@pytest.mark.parametrize("quantize", [(), ("q",)])
def test_snapshot_codec_cuda_blobs_equal_cpu(dev, quantize):
    from repro_torch.core.codec import SnapshotCodec
    a = _wire_arrays(0)
    b = {k: v.copy() for k, v in a.items()}
    b["w"][1, 10:300] += 1.0
    b["q"][:5000] *= 2.0
    codec = SnapshotCodec(quantize_keys=quantize)
    cpu = [{k: torch.from_numpy(v) for k, v in d.items()} for d in (a, b)]
    card = [{k: v.to(dev) for k, v in d.items()} for d in cpu]
    n_xor = 3 - len(quantize)      # every delta cell but the int8 one
    x0, q0 = dops.launches, qops.launches
    full = codec.encode(1, card[0], extra={"e": 1})
    delta = codec.encode(2, card[1], base=(1, card[0]))
    assert dops.launches - x0 == n_xor
    assert qops.launches - q0 == 2 * len(quantize)
    assert full == codec.encode(1, cpu[0], extra={"e": 1})
    assert delta == codec.encode(2, cpu[1], base=(1, cpu[0]))
    host = codec.decode_chain({1: full, 2: delta}, 2)
    x0, d0 = dops.launches, qops.dequantize_launches
    got = codec.decode_chain({1: full, 2: delta}, 2, device="cuda")
    assert dops.launches - x0 == n_xor
    assert qops.dequantize_launches - d0 == 2 * len(quantize)
    for k, v in host.items():
        assert got[k].device.type == "cuda"
        np.testing.assert_array_equal(got[k].cpu().numpy(), v)


def test_incremental_stage_on_card_is_a_private_copy(dev):
    from repro_torch.core.codec import (ChainPolicy, IncrementalSnapshotter,
                                        restore_rank_arrays)
    snap = IncrementalSnapshotter(ChainPolicy(full_every=4))
    x = torch.randn(1 << 20, device=dev)
    p1 = snap.stage(1, {"x": x})
    x[:1000] += 1.0
    cut = x.clone()
    p2 = snap.stage(2, {"x": x})
    x += 5.0          # the live array moves on before the encode runs
    image = {"epoch": 2, "n_ranks": 1, "ranks": {0: p2()},
             "chains": {0: {1: p1()}}}
    arrays, _ = restore_rank_arrays(image, 0, device="cuda")
    assert torch.equal(arrays["x"], cut)


def test_socket_world_of_card_shards_commits_and_restores(dev, tmp_path):
    from repro_torch.core.codec import image_to_bytes
    from repro_torch.examples import multirank_simulation as twin
    image, m = twin.run_pipeline(2, "socket", 1 << 20, dev, seed=3,
                                 tmpdir=str(tmp_path))
    assert m["delta_epochs"] and m["rank_process"]["xor_delta"] > 0
    _, m2 = twin.run_pipeline(2, "socket", 1 << 20, dev, seed=3,
                              image=image_to_bytes(image),
                              steps=twin.PIPE_EVERY + 1,
                              tmpdir=str(tmp_path))
    assert m2["rank_process"]["xor_delta"] > 0   # chain applied on the card
