"""Mamba-2-style SSM head (the parallel-to-attention branch in hymba).

Port of `repro.models.mamba`.  Scalar-per-head decay a_t =
-softplus(dt_t + dt_bias) * exp(A_log), state size N per head; maps onto
the shared chunked linear-attention engine (q=C_t, k=dt_t*B_t, v=x_t).
Depthwise causal conv (width 4) on the input path, SiLU gate z, per-head
skip D.  Parameter names, shapes and logical axes are the reference's,
and so are the points where values change dtype: the softplus input is
upcast to f32 before `dt_bias` is added, the log decay is formed in f32,
and `k` is `B_t` times `dt` cast down to the compute dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _dense_init, hold_placements, pad_dim
from repro_torch.models.linear_attention import (
    chunked_linear_attention,
    linear_attention_step,
)

CONV_W = 4


def mamba_heads(d_in: int) -> int:
    """SSM head count: 16 heads (width d_in/16) when the inner dim is
    16-divisible (the reference's layout, kept so images move between
    the packages), else one head per 64 channels."""
    return 16 if d_in % 16 == 0 else max(1, d_in // 64)


def init_mamba(gen, d_model: int, ssm_state: int, expand: int, *, device,
               stack: int = 0):
    d_in = expand * d_model
    n_heads = mamba_heads(d_in)
    lead = (stack,) if stack else ()
    dense = lambda shape, **kw: _dense_init(gen, shape, device=device,
                                            stack=stack, **kw)
    full = lambda n, value: torch.full((*lead, n), value, dtype=torch.float32,
                                       device=device)
    params = {
        "wx": dense((d_model, d_in)),
        "wz": dense((d_model, d_in)),
        "conv_w": dense((CONV_W, d_in), in_axis=0).mul_(0.5),
        "conv_b": full(d_in, 0.0),
        "wB": dense((d_in, ssm_state)),
        "wC": dense((d_in, ssm_state)),
        "wdt": dense((d_in, n_heads)),
        "dt_bias": full(n_heads, -1.0),
        "A_log": full(n_heads, 0.0),
        "D": full(n_heads, 1.0),
        "wo": dense((d_in, d_model)),
    }
    logical = {
        "wx": (None, "d_inner"),
        "wz": (None, "d_inner"),
        "conv_w": (None, "d_inner"),
        "conv_b": ("d_inner",),
        "wB": ("d_inner", None),
        "wC": ("d_inner", None),
        "wdt": ("d_inner", None),
        "dt_bias": (None,),
        "A_log": (None,),
        "D": (None,),
        "wo": ("d_inner", None),
    }
    return params, logical


def causal_conv(xi, w, b):
    """Depthwise causal conv via shifted adds. xi: (B,S,C), w: (W,C)
    (w[-1] weighs the current position; W is CONV_W here, granite's
    `mamba_conv` in `repro_torch.models.mamba2`), b: (C,)."""
    W = w.shape[0]
    out = xi * w[-1]
    for i in range(1, W):
        shifted = pad_dim(xi, i, 1)[:, :-i]
        out = out + shifted * w[W - 1 - i]
    return out + b


def _held(y):
    """A projection `y` of the inner channels, on a mesh (a DTensor
    partial over "model", which splits them) reduced, with its gradient
    placed as `y` is before the projection's backward: DTensor may leave
    that gradient split on the sequence over "model", which the
    projection's backward cannot flatten with the batch (hymba-1.5b x
    train_4k on 2x16x16, in the dry-run).  Plain tensors pass as they
    are."""
    if not hasattr(y, "device_mesh"):
        return y
    from torch.distributed.tensor import Replicate

    return hold_placements(y, y.device_mesh, [
        Replicate() if q.is_partial() else q for q in y.placements])


def _ssm_inputs(p, xc, dtype):
    """Shared projection math. xc: (B, S, d_in) post-conv activations.

    `F.softplus` returns its input above 20 where JAX's computes
    log1p(exp(x)); they differ there by less than exp(-20), below f32
    rounding of a value over 20."""
    n_heads = p["wdt"].shape[1]
    N = p["wB"].shape[1]
    Bt = _held(torch.einsum("bsd,dn->bsn", xc, p["wB"].to(dtype)))
    Ct = _held(torch.einsum("bsd,dn->bsn", xc, p["wC"].to(dtype)))
    dt = F.softplus(
        _held(torch.einsum("bsd,dh->bsh", xc, p["wdt"].to(dtype))).to(
            torch.float32) + p["dt_bias"])
    lw = -dt * torch.exp(p["A_log"])                     # (B,S,H) log decay
    q = Ct[:, :, None, :].expand(*dt.shape, N)
    k = Bt[:, :, None, :] * dt[..., None].to(dtype)
    B_, S = xc.shape[0], xc.shape[1]
    v = xc.reshape(B_, S, n_heads, -1)
    lw_full = lw[..., None].expand(*dt.shape, N)
    return q, k.to(dtype), v, lw_full


def mamba_apply(p, x, chunk: int = 32):
    """x: (B,S,d) -> (out (B,S,d), final SSM state (B,H,N,d_in/H) f32,
    the last CONV_W - 1 pre-conv inputs (B,3,d_in)).  Full-sequence
    (train / prefill) path."""
    dt_ = x.dtype
    B, S, _ = x.shape
    xi = torch.einsum("bsd,de->bse", x, p["wx"].to(dt_))
    z = torch.einsum("bsd,de->bse", x, p["wz"].to(dt_))
    xc = F.silu(causal_conv(xi, p["conv_w"].to(dt_), p["conv_b"].to(dt_)))
    q, k, v, lw = _ssm_inputs(p, xc, dt_)
    y, state = chunked_linear_attention(q, k, v, lw, mode="mamba", chunk=chunk)
    y = y + v * p["D"].to(dt_)[None, None, :, None]
    y = y.reshape(B, S, -1) * F.silu(z)
    out = torch.einsum("bse,ed->bsd", y, p["wo"].to(dt_))
    return out, state, xi[:, -(CONV_W - 1):]             # conv tail as state


def mamba_decode_step(p, x, conv_state, ssm_state):
    """x: (B,1,d); conv_state: (B,3,d_in); ssm_state: (B,H,N,hd).

    Returns (out (B,1,d), new conv state, new SSM state); the given
    states are left as they were."""
    dt_ = x.dtype
    B = x.shape[0]
    xi = torch.einsum("bsd,de->bse", x, p["wx"].to(dt_))
    z = torch.einsum("bsd,de->bse", x, p["wz"].to(dt_))
    window = torch.cat([conv_state, xi], dim=1)          # (B,4,d_in)
    xc = torch.einsum("btd,td->bd", window, p["conv_w"].to(dt_))
    xc = F.silu(xc + p["conv_b"].to(dt_))[:, None]       # (B,1,d_in)
    q, k, v, lw = _ssm_inputs(p, xc, dt_)
    y, ssm_state = linear_attention_step(
        q[:, 0], k[:, 0], v[:, 0], lw[:, 0], mode="mamba", state=ssm_state)
    y = y + v[:, 0] * p["D"].to(dt_)[None, :, None]
    y = y.reshape(B, 1, -1) * F.silu(z)
    out = torch.einsum("bse,ed->bsd", y, p["wo"].to(dt_))
    return out, window[:, 1:], ssm_state
