"""Mixture-of-Experts: top-k routing with GShard-style dispatch einsums.

Port of `repro.models.moe` (plain tensor code in the reference too: no
Pallas kernel).  Expert weights are stored in the reference's
*virtual-expert* layout: each real expert's gated MLP is split
column-wise into `split` virtual experts (SwiGLU decomposes exactly:
out = sum_h (silu(x Wg_h) * (x Wi_h)) Wo_h), so E_virtual = E * split;
a token routed to real expert e goes to all of e's virtual experts with
the same gate weight.  Parameter names, shapes and logical axes are the
reference's, so images move between the packages.

The reference's four sharding constraints on the dispatch
(`src/repro/models/moe.py:103-121`, `ep` and `tp` modes) are not ported
yet: MoE models do not train on a mesh (`LowerHalf.build` raises, and
ROADMAP.md §A queues them), and without a mesh they do nothing.  Capacity positions are an integer cumsum, so
token drops are exact and deterministic (a float cumsum has no
deterministic CUDA implementation), and the dispatch one-hot is built
by comparison with `arange(cap)`, which gives a zero row for a position
at or past the capacity, as `jax.nn.one_hot` does (`F.one_hot` raises).
Every one-hot here is such a comparison.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _dense_init


def init_moe(gen, d_model: int, d_ff: int, num_experts: int, split: int, *,
             device, stack: int = 0):
    ev = num_experts * split
    fv = d_ff // split
    params = {
        "router": _dense_init(gen, (d_model, num_experts), device=device,
                              stack=stack),
        "wi": _dense_init(gen, (ev, d_model, fv), in_axis=1, device=device,
                          stack=stack),
        "wg": _dense_init(gen, (ev, d_model, fv), in_axis=1, device=device,
                          stack=stack),
        "wo": _dense_init(gen, (ev, fv, d_model), in_axis=1, device=device,
                          stack=stack),
    }
    logical = {
        "router": (None, None),
        "wi": ("expert", None, "expert_ffn"),
        "wg": ("expert", None, "expert_ffn"),
        "wo": ("expert", "expert_ffn", None),
    }
    return params, logical


def _one_hot(idx, n: int):
    """Boolean one-hot over the last axis; an index outside [0, n) gives
    a zero row."""
    return idx[..., None] == torch.arange(n, device=idx.device)


def _topk_by_argmax(logits, k: int):
    """(..., E) -> (vals (..., k), idx (..., k)); descending, stable (the
    first of equal maxima wins, as `jnp.argmax`)."""
    vals, idxs = [], []
    cur = logits
    for _ in range(k):
        i = torch.argmax(cur, dim=-1)
        vals.append(torch.amax(cur, dim=-1))
        idxs.append(i)
        sel = _one_hot(i, logits.shape[-1])
        cur = cur.masked_fill(sel, float("-inf"))
    return torch.stack(vals, dim=-1), torch.stack(idxs, dim=-1)


def moe_apply(p, x, *, num_experts: int, top_k: int, split: int,
              capacity_factor: float, rules=None, group_size: int = 512):
    """x: (B,S,d) -> (B,S,d), aux-loss dict."""
    B, S, d = x.shape
    ev = num_experts * split
    kv = top_k * split  # virtual choices per token
    N = B * S
    f32 = torch.float32

    # ---- routing over *real* experts --------------------------------------
    logits = torch.einsum("bsd,de->bse", x, p["router"].to(x.dtype)).to(f32)
    gate_vals, gate_idx = _topk_by_argmax(logits, top_k)        # (B,S,k)
    gate_w = torch.softmax(gate_vals, dim=-1)                   # renormalized
    # Switch-style load-balance aux loss
    probs = torch.softmax(logits, dim=-1)
    sel_real = _one_hot(gate_idx, num_experts).to(f32).sum(dim=2)  # (B,S,E)
    aux_loss = num_experts * torch.sum(
        probs.mean(dim=(0, 1)) * sel_real.mean(dim=(0, 1)) / top_k)

    # ---- virtual-expert selection and gates, per token ---------------------
    v_idx = (gate_idx[..., None] * split
             + torch.arange(split, device=x.device))            # (B,S,k,split)
    v_oh = _one_hot(v_idx.reshape(B, S, kv), ev).to(f32)      # (B,S,kv,Ev)
    sel = v_oh.sum(dim=2)                                       # (B,S,Ev) 0/1
    # each gate repeated `split` times by a broadcast, whose backward is
    # a sum over the copies (`repeat_interleave` backs through an
    # `index_add_`, which adds with atomics on CUDA)
    gate_v = gate_w[..., None].expand(B, S, top_k, split).reshape(B, S, kv)
    gates = torch.einsum("bske,bsk->bse", v_oh, gate_v)

    # ---- group tokens, assign capacity positions ---------------------------
    T = min(group_size, N)
    G = N // T
    assert N % T == 0, (N, T)
    sel_i = sel.to(torch.int32).reshape(G, T, ev)
    gates = gates.reshape(G, T, ev)
    cap = int(capacity_factor * kv * T / ev)
    cap = max(4, ((cap + 3) // 4) * 4)
    pos = torch.cumsum(sel_i, dim=1, dtype=torch.int32) - sel_i  # exclusive
    keep = (sel_i > 0) & (pos < cap)
    disp = (_one_hot(pos, cap) & keep[..., None]).to(x.dtype)  # (G,T,Ev,C)
    combine = disp * gates[..., None].to(x.dtype)

    # ---- dispatch -> expert MLP -> combine ----------------------------------
    xg = x.reshape(G, T, d)
    xin = torch.einsum("gtec,gtd->gecd", disp, xg)
    h = F.silu(torch.einsum("gecd,edf->gecf", xin, p["wg"].to(x.dtype)))
    u = torch.einsum("gecd,edf->gecf", xin, p["wi"].to(x.dtype))
    yout = torch.einsum("gecf,efd->gecd", h * u, p["wo"].to(x.dtype))
    y = torch.einsum("gtec,gecd->gtd", combine, yout)
    return y.reshape(B, S, d), {"moe_aux": aux_loss}
