"""The fused attention kernels (`repro_torch.kernels.attention`) on a
CUDA card: output and the three gradients against the plain chunked
attention (`_chunked_attention`, the version the CPU tests hold against
the JAX reference) on the same bf16 inputs, at the main path's shape
for one layer and at the edges (a length that is no multiple of a
tile, cross attention with S != T, head dims 128 and 160, one query
head a KV head, one row of batch, the reduced configs' head dim 16);
a backward that gives the same bits twice; what the autograd node
keeps; the launch counters over a remat "full" step.  Those are marked
`cuda` and skip without a card; run them on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_attention_kernel.py

Tolerances.  Kernel and plain version round at the same places (q
scaled in bf16, p and ds rounded to bf16, every product summed in f32,
the output rounded to bf16), but not on the same values: the kernel
rounds p = exp(s - m) at the running max of its key tiles and rescales
the f32 sums as the max grows, the plain version rounds at the row's
final max; f32 sums are taken in another order; and delta and ds follow
from an output that differs in its last bf16 bit.  Each such difference
is a rounding of a bf16 value (relative 2^-9), so the two differ by a
few of those in norm: relative norm gap <= 1e-2 for the output and 2e-2
for a gradient (ds = p * (dp - delta) loses digits where dp is near
delta), and where the exact f64 attention of the same inputs fits on the
card, the kernel's own error is at most twice the plain version's plus
1e-3.

Against the JAX package (`repro.models.attention.flash_attention`, its
forward and its `jax.vjp`), which does not run on the card: its answers
on fixed bf16 inputs at small edge shapes are kept in
`tests/data/attention_jax_bf16.npz` (`tests/_attention_jax_ref.py`),
and the kernel's output and three gradients on the card, and the plain
version's on the CPU, are held to them to 2e-2 of each tensor's norm,
the bf16 tolerance of tests/test_torch_model.py (bf16 keeps 8 bits of
mantissa and the two round p and ds at different maxima).  On the CPU
the file is checked against the JAX package itself, to 1e-3 of the norm
(bit for bit where it was written; XLA may sum in another order on
another CPU).

On the CPU (tier 1): which version a call runs is a function of the
input's device, dtype and head dim alone; the wrapper imports without a
card or `nvcc`; CPU tensors run the plain version and launch nothing;
the JAX file and the plain version against it.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _attention_jax_ref as jref
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.kernels.attention import ops as aops
from repro_torch.models import attention as attn

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.mark.parametrize("device,dtype,hd,kernel", [
    ("cpu", torch.bfloat16, 64, False),
    ("cpu", torch.float16, 64, False),
    ("cpu", torch.float32, 64, False),
    ("cpu", torch.bfloat16, 96, False),     # the plain version takes any
    ("cuda", torch.float32, 64, False),
    ("cuda", torch.float32, 96, False),
    ("cuda", torch.float64, 128, False),
    ("cuda", torch.bfloat16, 16, True),
    ("cuda", torch.bfloat16, 64, True),
    ("cuda", torch.bfloat16, 128, True),
    ("cuda", torch.bfloat16, 160, True),
    ("cuda", torch.float16, 64, False),     # no config computes in f16
    ("meta", torch.bfloat16, 64, False),
])
def test_dispatch_by_device_dtype_and_head_dim(device, dtype, hd, kernel):
    assert aops.takes(device, dtype, hd) is kernel


@pytest.mark.parametrize("hd", [8, 32, 80, 96, 256])
def test_dispatch_raises_for_a_head_dim_without_a_kernel(hd):
    with pytest.raises(ValueError, match="head dims"):
        aops.takes("cuda", torch.bfloat16, hd)


def test_fake_tensor_takes_the_plain_version():
    """The dry-run's fake CUDA tensors have no memory to launch on."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        q = torch.empty(2, 64, 4, 64, dtype=torch.bfloat16, device="cuda")
    assert aops.takes("cuda", q.dtype, 64) and not aops.runs_kernel(q)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_tensor_takes_the_plain_version(dtype):
    assert not aops.runs_kernel(torch.zeros(1, 4, 2, 64, dtype=dtype))


def test_ops_imports_without_a_card_or_nvcc():
    """The wrapper and the model import with no card and no `nvcc` on the
    path, and build nothing: a kernel builds at its first launch."""
    code = ("import repro_torch.models.attention as a\n"
            "from repro_torch.kernels import _build\n"
            "from repro_torch.kernels.attention import ops\n"
            "assert set(_build.SIGNATURES['attention']) == {\n"
            "    'attention_fwd_launch', 'attention_bwd_launch'}\n"
            "assert _build.SOURCES['attention'].endswith('attention.cu')\n"
            "assert not _build._libs and ops.attention_fwd_launches == 0\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC), PATH="/usr/bin:/bin",
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


@pytest.mark.parametrize("causal,T", [(True, 96), (False, 96), (False, 40)])
def test_cpu_runs_the_plain_version(causal, T):
    """bf16 on the CPU: `flash_attention` is `_chunked_attention` bit for
    bit, forward and backward, and launches no kernel."""
    gen = torch.Generator().manual_seed(T)
    r = lambda *s: torch.randn(s, generator=gen).to(torch.bfloat16)
    q, k, v, dout = r(2, 96, 4, 16), r(2, T, 2, 16), r(2, T, 2, 16), \
        r(2, 96, 4, 16)
    before = (aops.attention_fwd_launches, aops.attention_bwd_launches)
    got = _run(lambda q, k, v: attn.flash_attention(q, k, v, causal=causal,
                                                    chunk=32), q, k, v, dout)
    want = _run(lambda q, k, v: attn._chunked_attention(q, k, v, causal, 32),
                q, k, v, dout)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert (aops.attention_fwd_launches,
            aops.attention_bwd_launches) == before


@pytest.mark.parametrize("case", list(jref.CASES))
def test_jax_reference_file_is_the_reference(case):
    """The kept answers are the JAX package's on the case's inputs."""
    want = jref.jax_reference(case)
    for n, got in jref.load()[case].items():
        gap = _rel(got, jref.values(want[n]))
        assert gap <= 1e-3, (n, gap)


def _against_jax(case, device, fn=attn.flash_attention):
    """Relative norm gaps {o, dq, dk, dv} of `fn`'s output and
    gradients, on `case`'s inputs on `device`, from the JAX package's."""
    causal, want = jref.CASES[case][-1], jref.load()[case]
    q, k, v, dout = (t.to(device) for t in jref.inputs(case))
    got = _run(lambda q, k, v: fn(q, k, v, causal=causal), q, k, v, dout)
    return {n: _rel(g, want[n].to(device)) for n, g in zip(jref.NAMES, got)}


@pytest.mark.parametrize("case", list(jref.CASES))
def test_plain_version_matches_jax_reference(case):
    """bf16 on the CPU (the plain version): output and the three
    gradients against the JAX package's."""
    gaps = _against_jax(case, "cpu")
    assert max(gaps.values()) < 2e-2, gaps


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# name: (B, S, T, H, K, hd, causal)
SHAPES = {
    "main": (14, 4096, 4096, 16, 2, 64, True),     # qwen2-0.5b's layer
    "ragged": (3, 1000, 1000, 16, 2, 64, True),     # S no multiple of a tile
    "cross": (2, 448, 1500, 20, 20, 64, False),     # whisper's cross attention
    "hd128": (2, 1024, 1024, 32, 8, 128, True),
    "hd128_cross": (2, 300, 1601, 32, 8, 128, False),
    "hd160": (2, 777, 777, 32, 8, 160, True),
    "g1": (2, 1024, 1024, 16, 16, 64, True),
    "b1": (1, 2048, 2048, 16, 2, 64, True),
    "hd16": (2, 64, 64, 4, 2, 16, True),
}
# the exact f64 attention's scores fit on the card below this many
EXACT_SCORES = 1 << 28


def _inputs(dev, shape, seed):
    B, S, T, H, K, hd, causal = shape
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)
    return r(B, S, H, hd), r(B, T, K, hd), r(B, T, K, hd), r(B, S, H, hd)


def _run(fn, q, k, v, dout):
    ins = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = fn(*ins)
    return (out.detach(), *torch.autograd.grad(out, ins, dout))


def _exact(q, k, v, dout, causal):
    """Attention in f64 of the same inputs, q scaled in bf16 as both
    versions scale it."""
    scale = attn._scale(q).double()
    ins = [t.detach().double().requires_grad_(True) for t in (q, k, v)]
    qd, kd, vd = ins
    B, S, H, hd = q.shape
    K = k.shape[2]
    qs = (qd * scale).reshape(B, S, K, H // K, hd)
    s = torch.einsum("bskgh,btkh->bkgst", qs, kd)
    if causal:
        keep = (torch.arange(S, device=q.device)[:, None]
                >= torch.arange(k.shape[1], device=q.device)[None, :])
        s = s.masked_fill(~keep, float("-inf"))
    o = torch.einsum("bkgst,btkh->bskgh", torch.softmax(s, -1), vd)
    o = o.reshape(B, S, H, hd)
    return (o.detach(), *torch.autograd.grad(o, ins, dout.double()))


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SHAPES))
def test_kernel_matches_plain(dev, name):
    shape = SHAPES[name]
    B, S, T, H, K, hd, causal = shape
    q, k, v, dout = _inputs(dev, shape, seed=list(SHAPES).index(name))
    before = (aops.attention_fwd_launches, aops.attention_bwd_launches)
    got = _run(lambda q, k, v: attn.flash_attention(q, k, v, causal=causal),
               q, k, v, dout)
    assert (aops.attention_fwd_launches, aops.attention_bwd_launches) == (
        before[0] + 1, before[1] + 1)
    want = _run(lambda q, k, v: attn._chunked_attention(q, k, v, causal, 512),
                q, k, v, dout)
    gaps = [_rel(a, b) for a, b in zip(got, want)]
    print(f"{name}: kernel against plain, relative norm gaps "
          f"o {gaps[0]:.3e} dq {gaps[1]:.3e} dk {gaps[2]:.3e} "
          f"dv {gaps[3]:.3e}")
    for t in got:
        assert torch.isfinite(t).all()
    assert gaps[0] <= 1e-2 and max(gaps[1:]) <= 2e-2, gaps
    if B * H * S * T <= EXACT_SCORES:
        ex = _exact(q, k, v, dout, causal)
        mine = [_rel(a, e) for a, e in zip(got, ex)]
        plain = [_rel(a, e) for a, e in zip(want, ex)]
        print(f"{name}: against f64, kernel {[f'{x:.3e}' for x in mine]}, "
              f"plain {[f'{x:.3e}' for x in plain]}")
        for m, p in zip(mine, plain):
            assert m <= 2 * p + 1e-3, (mine, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(jref.CASES))
def test_kernel_matches_jax_reference(dev, case):
    """bf16 on the card (the kernels): output and the three gradients
    against the JAX package's on the same inputs."""
    before = (aops.attention_fwd_launches, aops.attention_bwd_launches)
    gaps = _against_jax(case, dev)
    assert (aops.attention_fwd_launches, aops.attention_bwd_launches) == (
        before[0] + 1, before[1] + 1)
    print(f"{case}: kernel against JAX, relative norm gaps "
          + " ".join(f"{n} {g:.3e}" for n, g in gaps.items()))
    assert max(gaps.values()) < 2e-2, gaps


@pytest.mark.cuda
def test_backward_is_bit_identical(dev):
    """Two backward runs from one state give the same bits (no atomics)."""
    q, k, v, dout = _inputs(dev, SHAPES["ragged"], seed=3)
    fn = lambda q, k, v: attn.flash_attention(q, k, v, causal=True)
    a, b = _run(fn, q, k, v, dout), _run(fn, q, k, v, dout)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_saves_no_scores(dev):
    """The autograd node keeps q, k, v, the output and the row
    log-sum-exp: nothing of a score block's size (B * H * S * T here is
    16 times q's size)."""
    q, k, v, dout = _inputs(dev, (2, 1024, 1024, 16, 2, 64, True), seed=4)
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    ins = [t.requires_grad_(True) for t in (q, k, v)]
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = attn.flash_attention(*ins, causal=True)
    out.backward(dout)
    B, S, H, hd = q.shape
    K = k.shape[2]
    for want in ((B, S, H, hd), tuple(k.shape), (B, K, S * H // K)):
        assert want in saved, saved
    assert max(torch.Size(s).numel() for s in saved) <= q.numel(), saved


@pytest.mark.cuda
def test_launches_in_a_remat_full_step(dev):
    """A train step's forward and backward under remat "full" launch the
    forward kernel twice a layer (the block's recompute) and the
    backward once."""
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves, tree_unflatten

    cfg = dataclasses.replace(reduced_config(ARCHS["qwen2-0.5b"]), n_layers=3)
    rc = RunConfig(model=cfg, shape=ShapeConfig("s", 64, 2, "train"),
                   loss_chunk=32, attn_chunk=16, remat_policy="full")
    assert rc.dtype == "bfloat16" and aops.takes("cuda", torch.bfloat16,
                                                 cfg.head_dim)
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    params, _ = T.init_params(cfg, gen, dev)
    batch = {k: torch.from_numpy(x).to(dev) for k, x in
             SyntheticDataset(cfg, rc.shape, seed=6).get_batch(0).items()}
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    before = (aops.attention_fwd_launches, aops.attention_bwd_launches)
    loss, _ = T.forward_loss(tree_unflatten(params, leaves), cfg, rc, None,
                             batch)
    torch.autograd.grad(loss, leaves)
    assert (aops.attention_fwd_launches - before[0],
            aops.attention_bwd_launches - before[1]) == (2 * cfg.n_layers,
                                                         cfg.n_layers)
