"""The port's kernels, runtime and serving path on a CUDA card: each
kernel bit for bit against its plain PyTorch version, launch counting,
a bit-identical resume through MANARuntime, and serving with live
decode-state images (bit-identical continuation after a delta-chain
restore, the SWA ring wrap, MoE capacity drops, the checksum and XOR
launches of a decode-state image, reduced hymba with a padded KV head
and reduced rwkv6-3b with a padded head and reduced whisper-large-v3
with padded KV heads and reduced llama-3.2-vision-11b with padded
heads: a train step and a decode step against the CPU and its
decode-state image), and the wire codec and worlds with
rank state on the card (`SnapshotCodec` blobs from CUDA tensors equal
those from CPU tensors, `decode_chain(device="cuda")` equals the host
decode, a 2-rank socket world of card shards commits and restores).
Marked `cuda`; without a card every test skips.  Run on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Every test runs with `torch.use_deterministic_algorithms` off, as a
user runs the port.  Tolerance: none for kernels (also at a full-width
Mixtral expert leaf), resume (through `MANARuntime` and the training
CLI) and the restore continuation (bit for bit); card against CPU in
float32 (ring wrap, MoE capacity drops, the reduced Mixtral loss, aux
loss and gradients): rtol 1e-4 with
an absolute floor of 1e-4 of the largest magnitude (other summation
orders, as tests/test_torch_model.py).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, reduced_config
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.kernels import as_bytes
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


@pytest.mark.parametrize("tiles,extra,offsets", [
    (0, 1, None), (0, 16, None), (0, 17, None), (0, 4099, None),
    (0, 1 << 20, None),
    (1, 0, (0, 0, None)),                   # exactly one CTA's tile
    (1, 16, (0, 0, None)),                  # one tile + 16 bytes
    (1, 1, (0, 0, None)),                   # one tile + 1 byte
    (0, (1 << 26) + 48, (0, 0, None)),      # many waves of CTAs
    (3, 16 * 5 + 15, (0, 0, None)),         # the longest tail
    (5, 7, (3, 3, 3)),                      # shared misalignment: the peel
    (2, 5, (1, 2, None)),                   # mismatched: the byte loop
])
def test_xor_kernel(dev, tiles, extra, offsets):
    """n = `tiles` of the kernel's tile (bytes of each input a CTA takes)
    + `extra` bytes.  `offsets` None: an aligned pair and an unaligned one
    (a[1:], b); else the byte offsets of a, b and out (None: `xor_bytes`
    allocates it), the out view going straight to the C entry point."""
    from repro_torch.kernels import _build

    n = tiles * dops.tile() + extra
    g = torch.Generator(device=dev)
    g.manual_seed(n)
    a = torch.randint(0, 256, (n + 16,), dtype=torch.uint8, device=dev,
                      generator=g)
    b = torch.randint(0, 256, (n + 16,), dtype=torch.uint8, device=dev,
                      generator=g)
    if offsets is None:
        cases = ((a[:n], b[:n], None), (a[1:n + 1], b[:n], None))
    else:
        oa, ob, oo = offsets
        out = None if oo is None else torch.empty(
            n + 16, dtype=torch.uint8, device=dev)[oo:oo + n]
        cases = ((a[oa:oa + n], b[ob:ob + n], out),)
    for x, y, out in cases:
        if out is None:
            before = dops.launches
            out = dops.xor_bytes(x, y)
            assert dops.launches == before + 1
        else:
            _build.check(_build.library("delta").xor_launch(
                x.data_ptr(), y.data_ptr(), out.data_ptr(), n,
                _build.stream_ptr(x)), "xor")
            torch.cuda.synchronize()
        assert torch.equal(out, dref.xor_torch(x, y))
    if (tiles, extra) == (1, 1):
        np.testing.assert_array_equal(out.cpu().numpy(), dref.delta_np(
            x.cpu().numpy(), y.cpu().numpy()))


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


def test_kernels_at_an_expert_leaf_of_full_width_mixtral(dev):
    """XOR, quantize and dequantize bit for bit against their plain
    versions at (16, 4096, 7168) f32 (1,879,048,192 bytes), the largest
    leaf the kernels see (full-width Mixtral-8x7B experts, 2 virtual
    experts each), as train_moe in chip_smoke.py writes and restores."""
    g = torch.Generator(device=dev)
    g.manual_seed(16)
    x = torch.randn((16, 4096, 7168), generator=g, device=dev) * 1e-3
    y = x.clone()
    y.view(-1)[::7] += 1e-3
    assert torch.equal(dops.xor_bytes(x, y),
                       dref.xor_torch(as_bytes(x), as_bytes(y)))
    del y
    q, s, pad = qops.quantize(x)
    q2, s2, pad2 = qref.quantize_torch(x.reshape(-1))
    assert pad == pad2 == 0 and torch.equal(q, q2) and torch.equal(s, s2)
    del q2, s2
    want = qref.dequantize_torch(q.view(-1), s.view(-1), x.numel())
    assert torch.equal(qops.dequantize(q, s, pad, x.shape).view(-1), want)


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

    # with the process-wide deterministic switch off, as users run it
    assert not torch.are_deterministic_algorithms_enabled()
    rt = MANARuntime(cfg, rc, ckpt_dir=str(tmp_path / "delta"),
                     ckpt_every_steps=2, delta_params=True)
    rt.initialize()
    hist = rt.run(4)
    rt2 = MANARuntime(cfg, rc, ckpt_dir=str(tmp_path / "delta"),
                      delta_params=True)
    assert rt2.restore(2) == 2
    assert [h["loss"] for h in rt2.run(2)] == [h["loss"] for h in hist][2:4]


def test_moe_train_step_on_card_matches_cpu(dev):
    """Reduced Mixtral (MoE + SWA) in float32: loss, `moe_aux` and every
    gradient on the card agree with the CPU."""
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves, tree_unflatten

    cfg = reduced_config(ARCHS["mixtral-8x7b"])
    rc = RunConfig(model=cfg, shape=ShapeConfig("s", 64, 2, "train"),
                   loss_chunk=32, attn_chunk=16, dtype="float32")
    gen = torch.Generator(device="cpu")
    gen.manual_seed(5)
    params, _ = T.init_params(cfg, gen, "cpu")
    batch = SyntheticDataset(cfg, rc.shape, seed=5).get_batch(0)

    def loss_and_grads(device):
        leaves = [p.to(device).requires_grad_(True)
                  for p in tree_leaves(params)]
        b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        loss, m = T.forward_loss(tree_unflatten(params, leaves), cfg, rc,
                                 None, b)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), m["moe_aux"].detach(), grads

    lg, ag, gg = loss_and_grads(dev)
    lc, ac, gc = loss_and_grads("cpu")
    _f32_close(lg, lc)
    _f32_close(ag, ac)
    for a, b in zip(gg, gc):
        _f32_close(a, b)


def test_cli_resume_on_card(dev, tmp_path):
    """`python -m repro_torch.launch.train --device cuda`: 4 steps, then
    `--resume` for 2, print the losses of steps 4-5 of an uninterrupted
    6-step run exactly."""
    import json
    import os
    import subprocess
    import sys

    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    flags = ["--arch", "qwen2-0.5b", "--reduced", "--batch", "2", "--seq",
             "64", "--ckpt-every-steps", "2", "--delta-params", "--device",
             "cuda"]

    def cli(d, *more):
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", *flags,
             "--ckpt-dir", str(tmp_path / d), *more], env=env,
            capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-2000:]
        return [json.loads(x) for x in out.stdout.splitlines()
                if x.startswith("{")]

    cli("a", "--steps", "4")
    resumed = cli("a", "--steps", "2", "--resume")
    full = cli("b", "--steps", "6")
    assert [h["step"] for h in resumed] == [4, 5]
    assert [h["loss"] for h in resumed] == \
        [h["loss"] for h in full if h["step"] >= 4]


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
            mgr.save(i, {"decode": st}, {"decode": decode_state_logical(cfg)})
    restored, _ = CheckpointManager(str(tmp_path), device=dev).restore(10)
    assert cops.launches > c0 and dops.launches > x0
    st2, tok2 = restored["decode"], gen[10]
    assert st2["layers"]["k"].device.type == torch.device(dev).type
    for i in range(11, 16):
        logits2, st2 = serve(params, st2, tok2)
        tok2 = torch.argmax(logits2[:, -1], -1).to(torch.int32)[:, None]
        assert torch.equal(logits2, outs[i]) and torch.equal(tok2, gen[i])


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
    yg, ag = moe_apply({k: v.to(dev) for k, v in p.items()}, x.to(dev), **kw)
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


def test_hybrid_padded_train_step_and_decode_image_on_card(dev, tmp_path):
    """Reduced hymba-1.5b with the full-width config's head padding (25
    heads over 5 KV heads, stored as 48 over 6): a train step's loss and
    every gradient on the card agree with the CPU (float32); prefill and
    a decode step on the card agree with the CPU, SSM state and conv tail
    included; a decode-state image digests its 5 leaves (checksum), a
    delta image XORs its 4 cache leaves and the 0-d pos, and the restore
    gives the live state back bit for bit."""
    from repro_torch.core.checkpoint import CheckpointManager
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.models import transformer as T
    from repro_torch.training.step import make_serve_steps
    from repro_torch.tree import tree_leaves, tree_unflatten

    cfg = reduced_config(ARCHS["hymba-1.5b"], n_heads=25, n_kv_heads=5,
                         head_dim=8, pad_to=16)
    assert (cfg.n_heads_padded, cfg.n_kv_heads_padded) == (48, 6)
    rc = RunConfig(model=cfg, shape=ShapeConfig("s", 64, 2, "train"),
                   loss_chunk=32, attn_chunk=16, dtype="float32")
    gen = torch.Generator(device="cpu")
    gen.manual_seed(7)
    params, _ = T.init_params(cfg, gen, "cpu")
    batch = SyntheticDataset(cfg, rc.shape, seed=7).get_batch(0)

    def loss_and_grads(device):
        leaves = [p.to(device).requires_grad_(True)
                  for p in tree_leaves(params)]
        b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        loss, _ = T.forward_loss(tree_unflatten(params, leaves), cfg, rc,
                                 None, b)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    lg, gg = loss_and_grads(dev)
    lc, gc = loss_and_grads("cpu")
    _f32_close(lg, lc)
    for a, b in zip(gg, gc):
        _f32_close(a, b)

    prefill, serve = make_serve_steps(cfg, rc)
    toks = torch.from_numpy(batch["tokens"])
    card = tree_map(lambda t: t.to(dev), params)
    _, sc = prefill(params, {"tokens": toks})
    _, sg = prefill(card, {"tokens": toks.to(dev)})
    mgr = CheckpointManager(str(tmp_path), delta_keys=("decode",), device=dev)
    c0, x0 = cops.launches, dops.launches
    mgr.save(1, {"decode": sg}, {"decode": T.decode_state_logical(cfg)})
    lc, sc = serve(params, sc, toks[:, :1])
    lg, sg = serve(card, sg, toks[:, :1].to(dev))
    _f32_close(lg, lc)
    assert sorted(sg["layers"]) == ["conv", "k", "ssm", "v"]
    for key in sg["layers"]:
        _f32_close(sg["layers"][key], sc["layers"][key])
    mgr.save(2, {"decode": sg}, {"decode": T.decode_state_logical(cfg)})
    assert cops.launches == c0 + 15 and dops.launches == x0 + 5
    got, _ = mgr.restore(2)
    for key in sg["layers"]:
        assert torch.equal(got["decode"]["layers"][key], sg["layers"][key])
    assert got["decode"]["layers"]["k"].device.type == "cuda"


def test_rwkv_padded_train_step_and_decode_image_on_card(dev, tmp_path):
    """Reduced rwkv6-3b with a padded head and no grouping (5 heads
    stored as 6, as the full-width config's 40 are stored as 48): a train
    step's loss and every gradient on the card agree with the CPU
    (float32); prefill and a decode step on the card agree with the CPU,
    the `la` and token-shift states included; a decode-state image
    digests its 4 leaves (checksum), a delta image XORs them, and the
    restore gives the live state back bit for bit."""
    from repro_torch.core.checkpoint import CheckpointManager
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.models import transformer as T
    from repro_torch.training.step import make_serve_steps
    from repro_torch.tree import tree_leaves, tree_unflatten

    cfg = reduced_config(ARCHS["rwkv6-3b"], n_heads=5, n_kv_heads=5,
                         head_dim=8, pad_to=2)
    assert cfg.n_heads_padded == 6
    rc = RunConfig(model=cfg, shape=ShapeConfig("s", 64, 2, "train"),
                   loss_chunk=32, attn_chunk=16, dtype="float32")
    gen = torch.Generator(device="cpu")
    gen.manual_seed(8)
    params, _ = T.init_params(cfg, gen, "cpu")
    batch = SyntheticDataset(cfg, rc.shape, seed=8).get_batch(0)

    def loss_and_grads(device):
        leaves = [p.to(device).requires_grad_(True)
                  for p in tree_leaves(params)]
        b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        loss, _ = T.forward_loss(tree_unflatten(params, leaves), cfg, rc,
                                 None, b)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    lg, gg = loss_and_grads(dev)
    lc, gc = loss_and_grads("cpu")
    _f32_close(lg, lc)
    for a, b in zip(gg, gc):
        _f32_close(a, b)

    prefill, serve = make_serve_steps(cfg, rc)
    toks = torch.from_numpy(batch["tokens"])
    card = tree_map(lambda t: t.to(dev), params)
    _, sc = prefill(params, {"tokens": toks})
    _, sg = prefill(card, {"tokens": toks.to(dev)})
    mgr = CheckpointManager(str(tmp_path), delta_keys=("decode",), device=dev)
    c0, x0 = cops.launches, dops.launches
    mgr.save(1, {"decode": sg}, {"decode": T.decode_state_logical(cfg)})
    lc, sc = serve(params, sc, toks[:, :1])
    lg, sg = serve(card, sg, toks[:, :1].to(dev))
    _f32_close(lg, lc)
    assert sorted(sg["layers"]) == ["la", "shift_a", "shift_c"]
    for key in sg["layers"]:
        _f32_close(sg["layers"][key], sc["layers"][key])
    mgr.save(2, {"decode": sg}, {"decode": T.decode_state_logical(cfg)})
    # 4 digests, then the base read back (4) and the delta digested (4)
    assert cops.launches == c0 + 12 and dops.launches == x0 + 4
    got, _ = mgr.restore(2)
    for key in sg["layers"]:
        assert torch.equal(got["decode"]["layers"][key], sg["layers"][key])
    assert got["decode"]["layers"]["la"].device.type == "cuda"


def test_encdec_padded_train_step_and_decode_image_on_card(dev, tmp_path):
    """Reduced whisper-large-v3 with KV heads padded without grouping (5
    over 5 stored as 8 over 8, as the full-width config stores 20 as 32):
    a train step's loss and every gradient on the card agree with the CPU
    (float32; the encoder's gradients, which every cross attention feeds,
    to 1e-3 of their norm, as tests/test_torch_model.py holds them);
    prefill and a decode step on the card agree with the CPU, the cross
    K/V included; a decode-state image digests its 5 leaves (checksum), a
    delta image XORs them (the cross K/V's delta is all zero bytes), and
    the restore gives the live state back bit for bit."""
    from repro_torch.core.checkpoint import CheckpointManager
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.models import transformer as T
    from repro_torch.training.step import make_serve_steps
    from repro_torch.tree import tree_leaves, tree_unflatten

    cfg = reduced_config(ARCHS["whisper-large-v3"], n_heads=5, n_kv_heads=5,
                         head_dim=8, pad_to=8)
    assert cfg.padded_heads() == (8, 1)
    rc = RunConfig(model=cfg, shape=ShapeConfig("s", 64, 2, "train"),
                   loss_chunk=32, attn_chunk=16, dtype="float32")
    gen = torch.Generator(device="cpu")
    gen.manual_seed(9)
    params, _ = T.init_params(cfg, gen, "cpu")
    batch = SyntheticDataset(cfg, rc.shape, seed=9).get_batch(0)

    def loss_and_grads(device):
        leaves = [p.to(device).requires_grad_(True)
                  for p in tree_leaves(params)]
        b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        loss, _ = T.forward_loss(tree_unflatten(params, leaves), cfg, rc,
                                 None, b)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    lg, gg = loss_and_grads(dev)
    lc, gc = loss_and_grads("cpu")
    _f32_close(lg, lc)
    for path, a, b in zip(_leaf_paths(params), gg, gc):
        if path.startswith("enc_blocks/"):
            a, b = a.cpu().double(), b.double()
            assert float((a - b).norm() / b.norm()) < 1e-3, path
        else:
            _f32_close(a, b)

    prefill, serve = make_serve_steps(cfg, rc)
    toks = torch.from_numpy(batch["tokens"])
    frames = torch.from_numpy(batch["frames"])
    card = tree_map(lambda t: t.to(dev), params)
    _, sc = prefill(params, {"tokens": toks, "frames": frames})
    _, sg = prefill(card, {"tokens": toks.to(dev), "frames": frames.to(dev)})
    mgr = CheckpointManager(str(tmp_path), delta_keys=("decode",), device=dev)
    c0, x0 = cops.launches, dops.launches
    mgr.save(1, {"decode": sg}, {"decode": T.decode_state_logical(cfg)})
    lc, sc = serve(params, sc, toks[:, :1])
    lg, sg = serve(card, sg, toks[:, :1].to(dev))
    _f32_close(lg, lc)
    assert sorted(sg["layers"]) == ["k", "v", "xk", "xv"]
    for key in sg["layers"]:
        _f32_close(sg["layers"][key], sc["layers"][key])
    mgr.save(2, {"decode": sg}, {"decode": T.decode_state_logical(cfg)})
    assert cops.launches == c0 + 15 and dops.launches == x0 + 5
    got, _ = mgr.restore(2)
    for key in sg["layers"]:
        assert torch.equal(got["decode"]["layers"][key], sg["layers"][key])
    assert got["decode"]["layers"]["xk"].device.type == "cuda"


def test_vision_padded_train_step_and_decode_image_on_card(dev, tmp_path):
    """Reduced llama-3.2-vision-11b with padded heads (6 over 2 KV heads
    stored as 8 over 2): a train step's loss on the card agrees with the
    CPU and every gradient to 1e-3 of its norm (float32; random-init
    depth amplifies rounding, as tests/test_torch_model.py holds the
    vision gradients); prefill and two decode steps on the card agree
    with the CPU, the 6-D self K/V and the cross K/V included; a
    decode-state image digests its 5 leaves (checksum), a delta image
    XORs them (the cross K/V's delta is all zero bytes), and the restore
    gives the live state back bit for bit."""
    from repro_torch.core.checkpoint import CheckpointManager
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.models import transformer as T
    from repro_torch.training.step import make_serve_steps
    from repro_torch.tree import tree_leaves, tree_unflatten

    cfg = reduced_config(ARCHS["llama-3.2-vision-11b"], n_heads=6,
                         n_kv_heads=2, head_dim=8, pad_to=4)
    assert (cfg.n_heads_padded, cfg.n_kv_heads_padded) == (8, 2)
    rc = RunConfig(model=cfg, shape=ShapeConfig("s", 64, 2, "train"),
                   loss_chunk=32, attn_chunk=16, dtype="float32")
    gen = torch.Generator(device="cpu")
    gen.manual_seed(9)
    params, _ = T.init_params(cfg, gen, "cpu")
    batch = SyntheticDataset(cfg, rc.shape, seed=9).get_batch(0)

    def loss_and_grads(device):
        leaves = [p.to(device).requires_grad_(True)
                  for p in tree_leaves(params)]
        b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        loss, _ = T.forward_loss(tree_unflatten(params, leaves), cfg, rc,
                                 None, b)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    lg, gg = loss_and_grads(dev)
    lc, gc = loss_and_grads("cpu")
    _f32_close(lg, lc)
    for path, a, b in zip(_leaf_paths(params), gg, gc):
        a, b = a.cpu().double(), b.double()
        assert float((a - b).norm() / b.norm()) < 1e-3, path

    prefill, serve = make_serve_steps(cfg, rc)
    toks = torch.from_numpy(batch["tokens"])
    patches = torch.from_numpy(batch["patches"])
    card = tree_map(lambda t: t.to(dev), params)
    _, sc = prefill(params, {"tokens": toks, "patches": patches})
    _, sg = prefill(card, {"tokens": toks.to(dev),
                           "patches": patches.to(dev)})
    assert sg["layers"]["k"].dim() == 6
    mgr = CheckpointManager(str(tmp_path), delta_keys=("decode",), device=dev)
    c0, x0 = cops.launches, dops.launches
    mgr.save(1, {"decode": sg}, {"decode": T.decode_state_logical(cfg)})
    for i in range(2):
        lc, sc = serve(params, sc, toks[:, i:i + 1])
        lg, sg = serve(card, sg, toks[:, i:i + 1].to(dev))
        _f32_close(lg, lc)
    assert sorted(sg["layers"]) == ["k", "v", "xk", "xv"]
    for key in sg["layers"]:
        _f32_close(sg["layers"][key], sc["layers"][key])
    mgr.save(2, {"decode": sg}, {"decode": T.decode_state_logical(cfg)})
    assert cops.launches == c0 + 15 and dops.launches == x0 + 5
    got, _ = mgr.restore(2)
    for key in sg["layers"]:
        assert torch.equal(got["decode"]["layers"][key], sg["layers"][key])
    assert got["decode"]["layers"]["xk"].device.type == "cuda"


def _leaf_paths(tree, prefix=""):
    """The "a/b/c" paths of a tree's leaves, in `tree_leaves` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _leaf_paths(tree[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


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
