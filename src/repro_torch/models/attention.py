"""Attention, dense path: GQA projections and causal attention.

Port of `repro.models.attention` (dense self-attention only; sliding
window, cross attention and decode are listed in ROADMAP.md).  The
reference's `flash_attention` is chunked pure jnp with a custom VJP (no
Pallas kernel), so the port writes it as plain PyTorch ops under
autograd: f32 scores and softmax, probabilities rounded to the compute
dtype before the value product as in the reference, GQA by grouping the
query heads (K/V are never repeated).  Its memory is bounded by the
per-block recompute in `transformer.forward`, not by chunking.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import _dense_init, apply_rope

NEG_INF = -1e9


def head_mask(cfg, device=None):
    """(H_pad,) 0/1 mask of real heads in the padded (K_pad, G_pad) grid.

    Dummy heads exist only so head dims tile evenly over the model axis;
    multiplying attention output by this mask zeroes their contribution
    AND their gradient (wo sees zero activations), keeping padded and
    unpadded models mathematically identical.
    """
    kp, gp = cfg.padded_heads()
    K, G = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    k_idx = torch.arange(kp, device=device)[:, None]
    g_idx = torch.arange(gp, device=device)[None, :]
    return ((k_idx < K) & (g_idx < G)).to(torch.float32).reshape(-1)


def init_attention(gen, d_model: int, n_heads: int, n_kv_heads: int,
                   head_dim: int, qkv_bias: bool = False, *, device,
                   stack: int = 0):
    lead = (stack,) if stack else ()
    params = {
        "wq": _dense_init(gen, (d_model, n_heads, head_dim), device=device,
                          stack=stack),
        "wk": _dense_init(gen, (d_model, n_kv_heads, head_dim),
                          device=device, stack=stack),
        "wv": _dense_init(gen, (d_model, n_kv_heads, head_dim),
                          device=device, stack=stack),
        "wo": _dense_init(gen, (n_heads, head_dim, d_model), in_axis=0,
                          device=device, stack=stack),
    }
    logical = {
        "wq": (None, "heads", None),
        "wk": (None, "kv_heads", None),
        "wv": (None, "kv_heads", None),
        "wo": ("heads", None, None),
    }
    if qkv_bias:
        z = lambda *s: torch.zeros((*lead, *s), dtype=torch.float32,
                                   device=device)
        params["bq"] = z(n_heads, head_dim)
        params["bk"] = z(n_kv_heads, head_dim)
        params["bv"] = z(n_kv_heads, head_dim)
        logical["bq"] = ("heads", None)
        logical["bk"] = ("kv_heads", None)
        logical["bv"] = ("kv_heads", None)
    return params, logical


def qkv_proj(p, x, rope_theta: float, positions):
    """x: (B,S,d) -> q (B,S,H,hd), k,v (B,S,K,hd) with RoPE applied."""
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(dt))
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    return q, k, v


def out_proj(p, o):
    return torch.einsum("bshk,hkd->bsd", o, p["wo"].to(o.dtype))


def _group(q, n_kv: int):
    """(B,S,H,hd) -> (B,S,K,G,hd) grouped query heads."""
    B, S, H, hd = q.shape
    return q.reshape(B, S, n_kv, H // n_kv, hd)


def flash_attention(q, k, v, *, causal: bool, chunk: int = 128):
    """q: (B,S,H,hd); k,v: (B,T,K,hd) -> (B,S,H,hd).

    The reference's online softmax over `chunk`-wide key blocks is, in
    exact arithmetic, this single pass over all T keys; `chunk` is kept
    for the signature.  As there: q is scaled in its own dtype, scores
    and the softmax normaliser are f32, the unnormalised probabilities
    are rounded to q's dtype before the value product, which
    accumulates in f32."""
    B, S, H, hd = q.shape
    K, T = k.shape[2], k.shape[1]
    scale = (1.0 / torch.sqrt(torch.tensor(hd, dtype=torch.float32))).to(q.dtype)
    qg = _group(q * scale.to(q.device), K)                  # (B,S,K,G,hd)
    s = torch.einsum("bskgh,btkh->bskgt", qg.to(torch.float32),
                     k.to(torch.float32))
    if causal:
        keep = (torch.arange(S, device=q.device)[:, None]
                >= torch.arange(T, device=q.device)[None, :])
        s = s.masked_fill(~keep[None, :, None, None, :], NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).to(q.dtype)
    l = p.to(torch.float32).sum(dim=-1)                     # (B,S,K,G)
    acc = torch.einsum("bskgt,btkh->bskgh", p.to(torch.float32),
                       v.to(torch.float32))
    o = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    return o.reshape(B, S, H, hd)
