"""Fused attention entry points: the CUDA kernels of `csrc/attention.cu`
for CUDA tensors in bf16.  The plain version, which CPU tensors and any
other dtype take, is `repro_torch.models.attention`'s chunked attention
(`_chunked_attention`); `runs_kernel` says which of the two a call runs.

Layouts are the model's: q (B, S, H, hd) already scaled, k and v
(B, T, K, hd) with H a multiple of K (query head h reads KV head
h // (H / K)).  The inputs are read in place through their strides
(batch, position, head), which must leave the last dim contiguous and
rows 16-byte aligned, else they are copied once; the outputs are
contiguous.  lse is the f32 row log-sum-exp, (B, K, S * H / K): the
query rows of each KV head in (position, head of the group) order.
"""
from __future__ import annotations

import ctypes
import sys

from repro_torch.kernels import _build, count_launch, require_cuda

# head dims the kernels are compiled for: every attention config's (64,
# 128, 160) and the reduced configs' 16 that the card's tests train in
# bf16
HEAD_DIMS = (16, 64, 128, 160)

# kernel launches (the plain version does not count): one a forward,
# one a backward (its three kernels)
attention_fwd_launches = 0
attention_bwd_launches = 0


def takes(device_type: str, dtype, head_dim: int) -> bool:
    """Whether attention on tensors of this device type, dtype and head
    dim runs the kernels (True) or the plain version (False): the
    kernels for CUDA tensors in bf16, the plain version for any other
    device or dtype.  A head dim the kernels are not compiled for raises
    there."""
    import torch

    if device_type != "cuda" or dtype != torch.bfloat16:
        return False
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"the attention kernels take head dims {HEAD_DIMS}, "
                         f"not {head_dim}")
    return True


def runs_kernel(q) -> bool:
    """Whether flash attention over the query tensor `q` (B, S, H, hd)
    runs the kernels: `takes` of its device type, dtype and head dim.
    A fake tensor (the dry-run's) has no memory to launch on and takes
    the plain version, so the dry-run counts the plain version's
    products and peak."""
    from torch._subclasses.fake_tensor import is_fake

    return not is_fake(q) and takes(q.device.type, q.dtype, q.shape[-1])


def _readable(t):
    """`t` as the kernels read it: the last dim contiguous, the base and
    every other stride a multiple of 16 bytes (a copy where not)."""
    n = t.element_size()
    if (t.stride(-1) != 1 or t.data_ptr() % 16
            or any(s * n % 16 for s in t.stride()[:-1])):
        t = t.contiguous()
    return t


def _dims(q, k, causal: bool):
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    return (ctypes.c_longlong * 7)(B, S, T, H, K, hd, int(causal))


def _strides(*ts):
    vals = [s for t in ts for s in t.stride()[:3]]
    vals += [0] * (15 - len(vals))
    return (ctypes.c_longlong * 15)(*vals)


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"attention takes q (B,S,H,hd) and k, v (B,T,K,hd); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not attend k, v "
                         f"{tuple(k.shape)}: batch and head dim must match "
                         f"and the KV heads divide the query heads")
    if k.shape[1] == 0:
        raise ValueError("attention over no keys")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"attention over {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"attention across devices {q.device}, {k.device}, "
                         f"{v.device}")
    require_cuda(q, "attention")
    takes(q.device.type, q.dtype, hd)


def forward(q, k, v, causal: bool):
    """(o (B, S, H, hd) in q's dtype, lse (B, K, S * H / K) f32)."""
    import torch

    _check(q, k, v)
    q, k, v = _readable(q), _readable(k), _readable(v)
    B, S, H, hd = q.shape
    K = k.shape[2]
    o = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, K, S * (H // K)), dtype=torch.float32,
                      device=q.device)
    if o.numel():
        lib = _build.library("attention")
        with torch.cuda.device(q.device):
            _build.check(lib.attention_fwd_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), _dims(q, k, causal), _strides(q, k, v),
                _build.stream_ptr(q)), "attention forward")
        count_launch(sys.modules[__name__], "attention_fwd_launches")
    return o, lse


def backward(q, k, v, o, lse, dout, causal: bool):
    """(dq, dk, dv) of `forward`'s (q, k, v) given its (o, lse) and the
    output's gradient `dout`, each in its input's dtype, contiguous.
    No atomics: the same inputs give the same bits."""
    import torch

    _check(q, k, v)
    if dout.shape != o.shape or dout.dtype != o.dtype:
        raise ValueError(f"dout {tuple(dout.shape)} {dout.dtype} for an "
                         f"output {tuple(o.shape)} {o.dtype}")
    q, k, v = _readable(q), _readable(k), _readable(v)
    o, dout = _readable(o), _readable(dout)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if dq.numel():
        delta = torch.empty_like(lse)
        lib = _build.library("attention")
        with torch.cuda.device(q.device):
            _build.check(lib.attention_bwd_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), dout.data_ptr(),
                delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                _dims(q, k, causal), _strides(q, k, v, o, dout),
                _build.stream_ptr(q)), "attention backward")
        count_launch(sys.modules[__name__], "attention_bwd_launches")
    else:
        dk.zero_()
        dv.zero_()
    return dq, dk, dv
