"""Mixture-of-Experts: top-k routing with GShard-style dispatch einsums.

Port of `repro.models.moe` (plain tensor code in the reference too: no
Pallas kernel).  Expert weights are stored in the reference's
*virtual-expert* layout: each real expert's gated MLP is split
column-wise into `split` virtual experts (SwiGLU decomposes exactly:
out = sum_h (silu(x Wg_h) * (x Wi_h)) Wo_h), so E_virtual = E * split;
a token routed to real expert e goes to all of e's virtual experts with
the same gate weight.  Parameter names, shapes and logical axes are the
reference's, so images move between the packages.

On a mesh (`rules` set, leaves DTensors) the dispatch carries the
reference's four sharding constraints (`src/repro/models/moe.py:103-121`)
as `redistribute`s (`sharding.rules.constrain`): the dispatch and
combine one-hots on ("batch", None, "expert", None), the per-expert
buffers `xin` and `yout` on ("batch", "expert", None, None).  In `ep`
mode "expert" is the model axis, so each rank runs only its own experts
and the expert weights are never gathered; in `tp` mode "expert" maps
to no axis, the weights shard on "expert_ffn" instead and the
constraints place only the batch.  The combine contracts the experts:
in `ep` its output is the one partial sum over the model axis; in `tp`
the partial sum over the expert's ffn dim is reduced where `yout` is
constrained.  The expert MLP between the constraints and the combine
run on local shards (`_experts`, `_combine`); every other op
propagates its DTensor sharding, the integer cumsum and the `arange`
comparisons (under the step's `implicit_replication`) included.  Token
groups of T = 512 are cut from the batch-sharded (B, S) tokens by a
reshape (`_grouped`): where every data shard holds whole groups (S a
multiple of T, or G divisible by the data ranks) the groups keep the
batch shard; where a group would straddle two ranks the tokens are
first replicated over the data axes (the same values; DTensor raises on
that reshape), and the constraints then leave G replicated, as the
reference's tiling rule drops a mapping that does not divide.

Capacity positions are an integer cumsum, so token drops are exact and
deterministic (a float cumsum has no deterministic CUDA
implementation), and the dispatch one-hot is built by comparison with
`arange(cap)`, which gives a zero row for a position at or past the
capacity, as `jax.nn.one_hot` does (`F.one_hot` raises).
Every one-hot here is such a comparison.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _dense_init
from repro_torch.sharding.rules import constrain, on_local_shards


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


def _grouped(t, G: int, T: int):
    """(B, S, ...) -> (G, T, ...) token groups.  A DTensor keeps its
    batch shard where every data shard holds whole groups (G divides by
    the ranks that split the batch); where a group would straddle two
    ranks (DTensor raises on such a reshape), or S is split, those mesh
    dims are replicated first."""
    if hasattr(t, "device_mesh"):
        from torch.distributed.tensor import Replicate

        mesh, pl = t.device_mesh, t.placements
        rows = [i for i, p in enumerate(pl) if p.is_shard(0)]
        n = 1
        for i in rows:
            n *= mesh.size(i)
        drop = [i for i, p in enumerate(pl)
                if p.is_shard(1) or (G % n and i in rows)]
        if drop:
            t = t.redistribute(mesh, [Replicate() if i in drop else p
                                      for i, p in enumerate(pl)])
    return t.reshape(G, T, *t.shape[2:])


def _expert_mlp(xin, wi, wg, wo):
    """(G,Ev,C,d) per-expert buffers through each expert's gated MLP."""
    dt = xin.dtype
    h = F.silu(torch.einsum("gecd,edf->gecf", xin, wg.to(dt)))
    u = torch.einsum("gecd,edf->gecf", xin, wi.to(dt))
    return torch.einsum("gecf,efd->gecd", h * u, wo.to(dt))


def _experts(xin, wi, wg, wo):
    """`_expert_mlp`; on a mesh (DTensor inputs) it runs on each rank's
    local shards (`on_local_shards`), because DTensor's backward of these
    einsums fails in `tp` mode (a `view` of a permuted, group-sharded
    gradient: "view size is not compatible").  On each mesh dim, by
    `xin`'s placement: experts split (`ep`: `xin` on Shard(1), the
    weights on Shard(0)) give Shard(1); groups split (Shard(0), the data
    axes) take whole weights and give Shard(0); a replicated `xin`
    against weights split on the expert's ffn dim (`tp`) gives a
    `Partial` sum, reduced by the constraint that follows; any other dim
    is replicated.  Each element is the mesh-free einsums' over the same
    operands."""
    if not hasattr(xin, "device_mesh"):
        return _expert_mlp(xin, wi, wg, wo)
    from torch.distributed.tensor import Partial, Replicate, Shard

    R = Replicate()
    pls = []                                    # (xin, wi/wg, wo, out)
    for px, pw, po in zip(xin.placements, wi.placements, wo.placements):
        if px == Shard(1) and pw == Shard(0) and po == Shard(0):
            pls.append((px, pw, po, Shard(1)))
        elif px == Shard(0):
            pls.append((px, R, R, Shard(0)))
        elif px == R and pw == Shard(2) and po == Shard(1):
            pls.append((R, pw, po, Partial()))
        else:
            pls.append((R, R, R, R))
    px, pw, po, out = (tuple(c) for c in zip(*pls))
    return on_local_shards(_expert_mlp, (xin, wi, wg, wo), (px, pw, pw, po),
                           out)


def _combine_einsum(combine, yout):
    return torch.einsum("gtec,gecd->gtd", combine, yout)


def _combine(combine, yout):
    """(G,T,Ev,C) combine weights against (G,Ev,C,d) expert outputs ->
    (G,T,d).  On a mesh it runs on local shards (`on_local_shards`): the
    card's torch (2.11) cannot plan this einsum with the experts split
    (an `_unsafe_view` that flattens (C, Ev) with Ev sharded).  On each
    mesh dim: experts split on either operand (`ep`) give a partial sum
    over them; groups split give Shard(0); else both are replicated."""
    if not hasattr(combine, "device_mesh"):
        return _combine_einsum(combine, yout)
    from torch.distributed.tensor import Partial, Replicate, Shard

    R = Replicate()
    pls = []                                    # (combine, yout, out)
    for pc, py in zip(combine.placements, yout.placements):
        if pc == Shard(2) or py == Shard(1):
            pls.append((Shard(2), Shard(1), Partial()))
        elif pc == Shard(0) or py == Shard(0):
            pls.append((Shard(0), Shard(0), Shard(0)))
        else:
            pls.append((R, R, R))
    pc, py, out = (tuple(c) for c in zip(*pls))
    return on_local_shards(_combine_einsum, (combine, yout), (pc, py), out)


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
    sel_i = _grouped(sel.to(torch.int32), G, T)
    gates = _grouped(gates, G, T)
    cap = int(capacity_factor * kv * T / ev)
    cap = max(4, ((cap + 3) // 4) * 4)
    pos = torch.cumsum(sel_i, dim=1, dtype=torch.int32) - sel_i  # exclusive
    keep = (sel_i > 0) & (pos < cap)
    disp = (_one_hot(pos, cap) & keep[..., None]).to(x.dtype)  # (G,T,Ev,C)
    combine = disp * gates[..., None].to(x.dtype)
    disp = constrain(disp, rules, ("batch", None, "expert", None))
    combine = constrain(combine, rules, ("batch", None, "expert", None))

    # ---- dispatch -> expert MLP -> combine ----------------------------------
    xg = _grouped(x, G, T)
    xin = torch.einsum("gtec,gtd->gecd", disp, xg)      # local per shard
    # the per-expert buffers on the expert shards: else the expert
    # WEIGHTS may be gathered over the model axis instead
    xin = constrain(xin, rules, ("batch", "expert", None, None))
    yout = _experts(xin, p["wi"], p["wg"], p["wo"])
    yout = constrain(yout, rules, ("batch", "expert", None, None))
    y = _combine(combine, yout)                         # all-reduce(model)
    return y.reshape(B, S, d), {"moe_aux": aux_loss}
