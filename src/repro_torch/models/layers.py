"""Shared model layers: norms, RoPE, MLP, embeddings (dense path).

Port of `repro.models.layers`.  Every init_* returns a pair of trees:
(params, logical_axes); the logical tree mirrors params with tuples of
logical axis names, identical to the reference's, so images move
between the two packages.  Params are stored f32; compute runs in the
activations' dtype (`rc.dtype`), with norms and RoPE in f32 inside.
Initial values come from a `torch.Generator` and do not match JAX's.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _norm_init(shape, device):
    return torch.ones(shape, dtype=torch.float32, device=device)


def _dense_init(gen, shape, in_axis: int = -2, *, device, stack: int = 0):
    """N(0, 1/fan_in) f32; `stack` > 0 prepends a layer axis (fan-in is
    per layer, as the reference's vmapped per-layer init).  On the meta
    device (`gen` None) only the shape is made."""
    fan_in = shape[in_axis] if len(shape) > 1 else shape[0]
    full = (stack, *shape) if stack else tuple(shape)
    if gen is None:
        return torch.empty(full, dtype=torch.float32, device=device)
    w = torch.randn(full, generator=gen, dtype=torch.float32, device=device)
    return w.mul_(1.0 / math.sqrt(fan_in))


def rms_norm(x, scale, eps: float = 1e-5):
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale).to(dt)


# --------------------------------------------------------------------------
# Rotary position embeddings
# --------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, hd); positions: (B, S) or (S,) integer."""
    if theta <= 0:
        return x
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions.to(torch.float32)[..., None] * freqs   # (..., S, half)
    angles = angles[..., None, :]                             # over heads
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Gated MLP (SwiGLU)
# --------------------------------------------------------------------------


def init_mlp(gen, d_model: int, d_ff: int, *, device, stack: int = 0):
    params = {
        "wi": _dense_init(gen, (d_model, d_ff), device=device, stack=stack),
        "wg": _dense_init(gen, (d_model, d_ff), device=device, stack=stack),
        "wo": _dense_init(gen, (d_ff, d_model), device=device, stack=stack),
    }
    logical = {
        "wi": (None, "ffn"),
        "wg": (None, "ffn"),
        "wo": ("ffn", None),
    }
    return params, logical


def mlp_apply(p, x):
    h = torch.einsum("bsd,df->bsf", x, p["wg"].to(x.dtype))
    g = F.silu(h)
    u = torch.einsum("bsd,df->bsf", x, p["wi"].to(x.dtype))
    return torch.einsum("bsf,fd->bsd", g * u, p["wo"].to(x.dtype))


# --------------------------------------------------------------------------
# Embedding / LM head
# --------------------------------------------------------------------------


def init_embed(gen, vocab: int, d_model: int, tie: bool, *, device):
    params = {"embedding": _dense_init(gen, (vocab, d_model), in_axis=-1,
                                       device=device)}
    logical = {"embedding": ("vocab", None)}
    if not tie:
        params["head"] = _dense_init(gen, (d_model, vocab), device=device)
        logical["head"] = (None, "vocab")
    return params, logical


def embed_apply(p, tokens, dtype):
    """Row gather of the embedding table.  `index_select` has a
    deterministic backward on CUDA under
    `torch.use_deterministic_algorithms(True)`."""
    table = p["embedding"].to(dtype)
    rows = torch.index_select(table, 0, tokens.reshape(-1).to(torch.int64))
    return rows.reshape(*tokens.shape, table.shape[-1])


def head_matrix(p):
    if "head" in p:
        return p["head"]
    return p["embedding"].T


def vocab_logit_mask(v_padded: int, v_real: int, device=None):
    """Additive mask (-1e9 on TP-padding vocab columns), or None."""
    if v_padded == v_real:
        return None
    cols = torch.arange(v_padded, device=device)
    return torch.where(cols < v_real, 0.0, -1e9).to(torch.float32)


def chunked_softmax_xent(h, head, labels, mask, chunk: int,
                         valid_vocab: int = 0):
    """Sequence-chunked cross entropy: never materializes (B,S,V) logits.

    h: (B,S,d) activations; head: (d,V); labels: (B,S); mask: (B,S)
    float; valid_vocab: real vocab size (columns beyond it are padding,
    excluded from the softmax).  Returns (sum, count).

    The target logit is a gather, `logits[b, c, label]`.  The reference
    contracts a one-hot instead because a gather on a vocab-sharded
    axis makes GSPMD replicate; both select the same single f32 value,
    so the math is the same, and the gather never builds the
    (B, c, V) one-hot (2.5 GB per chunk at vocab 151936).
    """
    B, S, d = h.shape
    chunk = min(chunk, S)
    n = S // chunk
    assert S % chunk == 0, (S, chunk)
    vmask = vocab_logit_mask(head.shape[-1], valid_vocab or head.shape[-1],
                             h.device)
    w = head.to(h.dtype)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        hx, lx, mx = h[:, sl], labels[:, sl], mask[:, sl]
        logits = torch.einsum("bcd,dv->bcv", hx, w).to(torch.float32)
        if vmask is not None:
            logits = logits + vmask
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, lx.to(torch.int64)[..., None])[..., 0]
        loss = (lse - tgt) * mx
        tot = tot + loss.sum()
        cnt = cnt + mx.sum()
    return tot, cnt
