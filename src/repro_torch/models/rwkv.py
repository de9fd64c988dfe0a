"""RWKV-6 (Finch): attention-free time-mix with data-dependent per-channel
decay, plus squared-ReLU channel-mix.

Port of `repro.models.rwkv`.  The data-dependent decay LoRA
(w = exp(-exp(w0 + tanh(x_w A) B))) is implemented; the token-shift
interpolations use learned static coefficients (RWKV-5 style), as in the
reference.  Parameter names, shapes, dtypes, logical axes and constants
are the reference's, and so are the points where values change dtype:
`mu` is cast to the activations' dtype inside `_lerp`, the decay LoRA
runs in the compute dtype and its clipped exponent in f32, the bonus `u`
is f32, and the per-head norm and SiLU gate come before the padded-head
mask, which comes before `wo`.  The recurrence is the shared
chunked linear-attention engine in mode "rwkv".
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _dense_init, head_rms_norm, pad_dim
from repro_torch.models.linear_attention import (
    chunked_linear_attention,
    linear_attention_step,
)

DECAY_LORA = 64


def init_rwkv_time_mix(gen, d_model: int, n_heads: int, head_dim: int, *,
                       device, stack: int = 0):
    lead = (stack,) if stack else ()
    dense = lambda shape, **kw: _dense_init(gen, shape, device=device,
                                            stack=stack, **kw)
    full = lambda shape, value: torch.full((*lead, *shape), value,
                                           dtype=torch.float32, device=device)
    params = {
        # token-shift lerp coefficients for r,k,v,g,w
        "mu": full((5, d_model), 0.5),
        "wr": dense((d_model, n_heads, head_dim)),
        "wk": dense((d_model, n_heads, head_dim)),
        "wv": dense((d_model, n_heads, head_dim)),
        "wg": dense((d_model, n_heads, head_dim)),
        "wo": dense((n_heads, head_dim, d_model), in_axis=0),
        # data-dependent decay lora: lw = -exp(w0 + tanh(x A) B)
        "w0": full((n_heads, head_dim), -0.6),
        "wA": dense((d_model, DECAY_LORA)),
        "wB": dense((DECAY_LORA, n_heads, head_dim)).mul_(0.1),
        # per-channel bonus for the current token ("time_faaaa")
        "u": full((n_heads, head_dim), 0.5),
    }
    logical = {
        "mu": (None, None),
        "wr": (None, "heads", None),
        "wk": (None, "heads", None),
        "wv": (None, "heads", None),
        "wg": (None, "heads", None),
        "wo": ("heads", None, None),
        "w0": ("heads", None),
        "wA": (None, None),
        "wB": (None, "heads", None),
        "u": ("heads", None),
    }
    return params, logical


def init_rwkv_channel_mix(gen, d_model: int, d_ff: int, *, device,
                          stack: int = 0):
    lead = (stack,) if stack else ()
    params = {
        "mu_ck": torch.full((*lead, d_model), 0.5, dtype=torch.float32,
                            device=device),
        "mu_cr": torch.full((*lead, d_model), 0.5, dtype=torch.float32,
                            device=device),
        "wck": _dense_init(gen, (d_model, d_ff), device=device, stack=stack),
        "wcv": _dense_init(gen, (d_ff, d_model), device=device, stack=stack),
        "wcr": _dense_init(gen, (d_model, d_model), device=device,
                           stack=stack),
    }
    logical = {
        "mu_ck": (None,),
        "mu_cr": (None,),
        "wck": (None, "ffn"),
        "wcv": ("ffn", None),
        "wcr": (None, None),
    }
    return params, logical


def _lerp(x, xprev, mu):
    return x + (xprev - x) * mu.to(x.dtype)


def _shifted(x):
    """The previous position's input along S, zeros before the first."""
    return pad_dim(x, 1, 1)[:, :-1]


def _time_mix_projections(p, x, xprev):
    dt = x.dtype
    mu = p["mu"]
    proj = lambda i, w: torch.einsum(
        "bsd,dhk->bshk", _lerp(x, xprev, mu[i]), p[w].to(dt))
    r, k, v, g = (proj(i, w) for i, w in enumerate(("wr", "wk", "wv", "wg")))
    xw = _lerp(x, xprev, mu[4])
    lora = torch.einsum(
        "bsl,lhk->bshk",
        torch.tanh(torch.einsum("bsd,dl->bsl", xw, p["wA"].to(dt))),
        p["wB"].to(dt))
    lw = -torch.exp(torch.clamp(p["w0"] + lora.to(torch.float32), -8.0, 4.0))
    return r, k, v, g, lw


def _gated_out(p, y, g, mask):
    y = head_rms_norm(y) * F.silu(g)
    if mask is not None:
        y = y * mask[None, None, :, None].to(y.dtype)
    return torch.einsum("bshk,hkd->bsd", y, p["wo"].to(y.dtype))


def rwkv_time_mix(p, x, chunk: int = 32, mask=None):
    """x: (B,S,d) -> (B,S,d), final la-state (B,H,dk,dv) f32, shift-state
    (B,d).

    `mask` (H_pad,) zeroes TP-padding heads exactly (see
    attention.head_mask)."""
    r, k, v, g, lw = _time_mix_projections(p, x, _shifted(x))
    y, state = chunked_linear_attention(
        r, k, v, lw, mode="rwkv", u=p["u"].to(torch.float32), chunk=chunk)
    return _gated_out(p, y, g, mask), state, x[:, -1]


def rwkv_time_mix_step(p, x, la_state, shift_state, mask=None):
    """x: (B,1,d); la_state: (B,H,dk,dv) f32; shift_state: (B,d).

    Returns (out (B,1,d), new la-state, new shift-state); the given
    states are left as they were."""
    xprev = shift_state[:, None].to(x.dtype)
    r, k, v, g, lw = _time_mix_projections(p, x, xprev)
    y, la_state = linear_attention_step(
        r[:, 0], k[:, 0], v[:, 0], lw[:, 0], mode="rwkv",
        u=p["u"].to(torch.float32), state=la_state)
    return _gated_out(p, y[:, None], g, mask), la_state, x[:, 0]


def _channel_mix(p, x, xprev):
    dt = x.dtype
    kx = _lerp(x, xprev, p["mu_ck"])
    rx = _lerp(x, xprev, p["mu_cr"])
    kk = torch.square(F.relu(torch.einsum("bsd,df->bsf", kx,
                                          p["wck"].to(dt))))
    vv = torch.einsum("bsf,fd->bsd", kk, p["wcv"].to(dt))
    rr = torch.sigmoid(torch.einsum("bsd,de->bse", rx, p["wcr"].to(dt)))
    return rr * vv


def rwkv_channel_mix(p, x):
    """x: (B,S,d) -> (B,S,d), shift-state (B,d)."""
    return _channel_mix(p, x, _shifted(x)), x[:, -1]


def rwkv_channel_mix_step(p, x, shift_state):
    """x: (B,1,d); shift_state: (B,d) -> (out (B,1,d), new shift-state)."""
    return _channel_mix(p, x, shift_state[:, None].to(x.dtype)), x[:, 0]
