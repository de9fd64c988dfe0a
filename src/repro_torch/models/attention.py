"""Attention: GQA projections, causal, sliding-window and cross
attention over a sequence, and single-token decode against a KV cache.

Port of `repro.models.attention`.  The reference's flash and
sliding-window attention are chunked pure jnp with custom VJPs (no
Pallas kernel), so the port writes them as plain PyTorch ops: f32 scores
and softmax, probabilities rounded to the compute dtype before the value
product as in the reference, GQA by grouping the query heads (K/V are
never repeated).  Both loop over blocks of `chunk` queries, each against
its keys (all T keys for flash attention, so queries and keys may differ
in length, as cross attention needs), so the score tensor of one call is
O(chunk) rows, never (S, T).  Each block is one `_Attend`, the
reference's custom VJP: it keeps its inputs, its output and the row
log-sum-exp, and its backward recomputes the probabilities, so a
block's backward, too, holds one block's scores at a time.  Queries,
keys and values are laid out heads first, (B, K, ., hd), once per
call, so that every product of a block is a batched matrix product
over (B, K) that reads its operands where they lie.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models.layers import (_dense_init, apply_rope,
                                       hold_placements, pad_dim)
from repro_torch.models.remat import saved_result
from repro_torch.sharding.rules import on_local_shards

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
    if hasattr(q, "device_mesh"):
        q = _whole_groups(q, n_kv)
    return q.reshape(B, S, n_kv, H // n_kv, hd)


def _whole_groups(q, n_kv: int):
    """A DTensor q (B,S,H,hd) whose heads are split over more mesh ranks
    than the K groups can follow (K not divisible by their count): those
    mesh dims are replicated, so the reshape to (B,S,K,G,hd) splits only
    whole groups (e.g. H 4 over a "model" axis of 4 with K 2)."""
    from torch.distributed.tensor import Replicate

    mesh = q.device_mesh
    split = [i for i, p in enumerate(q.placements) if p.is_shard(2)]
    n = 1
    for i in split:
        n *= mesh.size(i)
    if n_kv % n == 0:
        return q
    return q.redistribute(mesh, [Replicate() if i in split else p
                                 for i, p in enumerate(q.placements)])


def _scale(q):
    hd = q.shape[-1]
    return (1.0 / torch.sqrt(torch.tensor(hd, dtype=torch.float32))).to(
        dtype=q.dtype, device=q.device)


def _heads_first(q, k, v):
    """Scaled queries (B,S,H,hd) -> (B,K,S,G,hd) in their dtype, and k, v
    (B,T,K,hd) -> (B,K,T,hd) f32, each copied once per call into the
    layout in which every block's products are batched matrix products
    over (B, K) with no further copy."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    qh = _group(q * _scale(q), K).permute(0, 2, 1, 3, 4).contiguous()
    kh, vh = (x.transpose(1, 2).to(torch.float32,
                                   memory_format=torch.contiguous_format)
              for x in (k, v))
    return qh, kh, vh


def _block(qh, start: int, c: int, kh, vh, keep):
    """Queries start..start+c of `qh` against the keys `kh`/`vh`
    (B,K,t,hd), `keep` (c,t) bool or None -> (B,K,c,G,hd)."""
    B, K, _, G, hd = qh.shape
    q = qh[:, :, start:start + c].reshape(B, K, c * G, hd)
    if keep is not None:
        keep = keep[:, None, :].expand(c, G, keep.shape[1]).reshape(c * G, -1)
    return _attend(q, kh, vh, keep).reshape(B, K, c, G, hd)


def _attend(q, k, v, keep):
    """`_Attend` of one block.  On a mesh (DTensor inputs) it runs on
    each rank's own (B, K) block: a block's attention is independent
    across batch rows and KV heads, so q, k and v are placed alike,
    split at most on those two dims, and the local tensors go through
    the same ops as without a mesh (DTensor would otherwise plan a
    sharding for each op of each block shape, ~25 s of the first step on
    a (2 x 2) CPU mesh)."""
    if not hasattr(q, "device_mesh"):
        return _Attend.apply(q, k, v, keep)
    from torch.distributed.tensor import Replicate, Shard

    pl = tuple(p if type(p) is Shard and p.dim in (0, 1) else Replicate()
               for p in q.placements)
    return on_local_shards(lambda q, k, v: _Attend.apply(q, k, v, keep),
                           (q, k, v), (pl, pl, pl), pl)


def _heads_last(blocks):
    """(B,K,c,G,hd) blocks in query order -> (B,S,H,hd).  On a mesh the
    gradient keeps the output's placements: the output projection's
    backward would split its heads over "model" as the weights are,
    which the view back to (K, G) cannot take where the K groups do not
    divide over those ranks (`_whole_groups`; qwen2-0.5b's 2 KV heads
    on the production mesh's 16)."""
    o = blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=2)
    B, K, S, G, hd = o.shape
    o = o.permute(0, 2, 1, 3, 4).reshape(B, S, K * G, hd)
    if hasattr(o, "device_mesh"):
        o = hold_placements(o, o.device_mesh, o.placements)
    return o


def _scores(q, k, keep):
    """f32 scores (B,K,M,t) of queries q (B,K,M,hd) against keys k
    (B,K,t,hd), -1e9 where `keep` (M,t) is False."""
    s = torch.matmul(q.to(torch.float32), k.transpose(-1, -2))
    if keep is not None:
        s = s.masked_fill(~keep, NEG_INF)
    return s


def _attend_forward(q, k, v, keep):
    """`_Attend`'s forward -> (out, row log-sum-exp)."""
    dtype = q.dtype
    s = _scores(q, k, keep)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).to(dtype).to(torch.float32)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    return (torch.matmul(p, v) / l).to(dtype), m + torch.log(l)


class _Attend(torch.autograd.Function):
    """One block of queries against its keys, one softmax pass.

    q: (B,K,M,hd) scaled queries in the compute dtype (M = c * G, a
    block's rows of each KV head's group); k, v: (B,K,t,hd) f32; keep:
    (M,t) bool or None.  Scores and the normaliser are f32, the
    unnormalised probabilities are rounded to the compute dtype before
    the value product, which accumulates in f32.  The backward is the
    reference's `_flash_bwd` for this block: probabilities recomputed
    from the saved log-sum-exp, delta = rowsum(dout * out), ds rounded
    to the compute dtype."""

    @staticmethod
    def forward(ctx, q, k, v, keep):
        # under remat "dots" one saved product, as the reference's custom
        # VJP is to XLA's remat (`repro_torch.models.remat.saved_result`)
        out, lse = saved_result(_attend_forward, q, k, v, keep)
        ctx.save_for_backward(q, k, v, keep, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, keep, out, lse = ctx.saved_tensors
        dtype = q.dtype
        f32 = torch.float32
        p = torch.exp(_scores(q, k, keep) - lse).to(dtype).to(f32)
        do = dout.to(f32)
        delta = (do * out.to(f32)).sum(dim=-1, keepdim=True)
        dv = torch.matmul(p.transpose(-1, -2), do)
        ds = (p * (torch.matmul(do, v.transpose(-1, -2)) - delta)).to(
            dtype).to(f32)
        dq = torch.matmul(ds, k).to(dtype)
        dk = torch.matmul(ds.transpose(-1, -2), q.to(f32))
        return dq, dk, dv, None


def flash_attention(q, k, v, *, causal: bool, chunk: int = 128):
    """q: (B,S,H,hd); k,v: (B,T,K,hd) -> (B,S,H,hd).

    Blocks of `chunk` queries, each against all T keys (T may differ
    from S: non-causal cross attention), or, causal, against the keys up
    to its last query (the later keys would get probability exactly
    0): the reference's online softmax over key blocks is, in exact
    arithmetic, this single pass over every key of a query row.  As
    there, q is scaled in its own dtype.  Memory O(B * chunk * H * T)
    for the scores, forward and backward."""
    S, T = q.shape[1], k.shape[1]
    qh, kh, vh = _heads_first(q, k, v)
    chunk = max(1, min(chunk, S))
    tpos = torch.arange(T, device=q.device)
    outs = []
    for i in range(0, S, chunk):
        c = min(chunk, S - i)
        t, keep = T, None
        if causal:
            t = min(T, i + c)
            keep = (torch.arange(i, i + c, device=q.device)[:, None]
                    >= tpos[None, :t])
        outs.append(_block(qh, i, c, kh[:, :, :t], vh[:, :, :t], keep))
    return _heads_last(outs)


def _fit_chunk(total: int, chunk: int) -> int:
    """Largest divisor of `total` that is <= `chunk`."""
    chunk = min(chunk, total)
    while total % chunk:
        chunk -= 1
    return chunk


def _swa_mask(start: int, window: int, chunk: int, span: int, device):
    qpos = start + torch.arange(chunk, device=device)
    tpos = start - window + torch.arange(span, device=device)
    diff = qpos[:, None] - tpos[None, :]
    return (diff >= 0) & (diff < window) & (tpos[None, :] >= 0)


def sliding_window_attention(q, k, v, *, window: int, chunk: int = 128):
    """Causal SWA: O(S * window) compute, O(chunk * (window + chunk))
    scores per block.  k/v are padded by `window` in front; block i of
    queries attends to its `window + chunk` key span."""
    S = q.shape[1]
    chunk = _fit_chunk(S, chunk)
    span = window + chunk
    qh, kh, vh = _heads_first(q, k, v)
    kh, vh = (pad_dim(x, window, 2) for x in (kh, vh))
    outs = []
    for start in range(0, S, chunk):
        keep = _swa_mask(start, window, chunk, span, q.device)
        outs.append(_block(qh, start, chunk, kh[:, :, start:start + span],
                           vh[:, :, start:start + span], keep))
    return _heads_last(outs)


# ==========================================================================
# Single-token decode against a KV cache
# ==========================================================================


def decode_attention(q, k_cache, v_cache, pos, window: int = 0):
    """q: (B,1,H,hd); caches: (B,T,K,hd) (T = capacity; ring iff
    window > 0) -> (B,1,H,hd).

    `pos` (an int) is the position of the new token, already written to
    the cache.  Keys in the cache are stored post-RoPE.  Ring slot s
    holds position pos - ((pos - s) mod T), with a non-negative mod.  On
    a mesh (DTensor caches) it runs on each rank's local shards
    (`_decode_attention_on_mesh`)."""
    if hasattr(k_cache, "device_mesh"):
        return _decode_attention_on_mesh(q, k_cache, v_cache, pos, window)
    return _decode_attend(q, k_cache, v_cache, pos, window, k_cache.shape[1])


def _decode_attend(q, k_cache, v_cache, pos: int, window: int, T: int,
                   start: int = 0, time_groups=()):
    """`decode_attention` on plain tensors whose cache holds slots
    start..start+t of a capacity of T.  With `time_groups` (the process
    groups of the mesh dims that split the cache's time dim) the softmax
    runs over every rank's slots: the row max and the exponentials' sum
    are all-reduced over them, each rank weighs its own values with the
    probabilities rounded to the compute dtype, and the f32 products are
    summed over them."""
    B, _, H, hd = q.shape
    K = k_cache.shape[2]
    qg = _group(q * _scale(q), K)[:, 0]                     # (B,K,G,hd)
    s = torch.einsum("bkgh,btkh->bkgt", qg.to(torch.float32),
                     k_cache.to(torch.float32))
    slots = torch.arange(start, start + k_cache.shape[1], device=q.device)
    if window:
        slot_pos = pos - torch.remainder(pos - slots, T)
        valid = (slot_pos >= 0) & (slot_pos > pos - window)
    else:
        valid = slots <= pos
    s = s.masked_fill(~valid[None, None, None, :], NEG_INF)
    if time_groups:
        m = s.amax(dim=-1, keepdim=True)
        for g in time_groups:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=g)
        e = torch.exp(s - m)
        total = e.sum(dim=-1, keepdim=True)
        for g in time_groups:
            dist.all_reduce(total, group=g)
        w = (e / total).to(q.dtype)
    else:
        w = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bkgt,btkh->bkgh", w.to(torch.float32),
                     v_cache.to(torch.float32))
    for g in time_groups:
        dist.all_reduce(o, group=g)
    return o.to(q.dtype).reshape(B, 1, H, hd)


def _decode_attention_on_mesh(q, k_cache, v_cache, pos: int, window: int):
    """`decode_attention` of DTensors on local shards: q is placed as the
    caches (both alike, by the decode state's specs) on their batch and
    KV-head dims (whole groups of query heads
    follow their KV head), and each rank attends over its own cache
    slots, the softmax and the value sum reduced over the ranks that
    split the time dim (`_decode_attend`).  DTensor's own einsum here
    merges the batch and head dims in a view, which the card's torch
    (2.11) cannot plan where both are sharded (ROADMAP.md section C,
    "DTensor ops on local shards")."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = k_cache.device_mesh
    cache_pl = tuple(k_cache.placements)
    q_pl = tuple(p if p.is_shard(0) or p.is_shard(2) else Replicate()
                 for p in cache_pl)
    start, _ = _time_range(k_cache)
    groups = [mesh.get_group(i) for i, p in enumerate(cache_pl)
              if p.is_shard(1) and mesh.size(i) > 1]
    o = _decode_attend(q.redistribute(mesh, q_pl).to_local(),
                       k_cache.to_local(), v_cache.to_local(), pos, window,
                       k_cache.shape[1], start, groups)
    return DTensor.from_local(o, mesh, q_pl, run_check=False)


def _time_range(cache):
    """(first slot, slot count) of this rank's local shard of a DTensor
    cache (B,T,K,hd): `torch.chunk`'s split of each mesh dim that shards
    the time dim, in mesh-dim order."""
    mesh = cache.device_mesh
    start, length = 0, cache.shape[1]
    for i, (p, c) in enumerate(zip(cache.placements, mesh.get_coordinate())):
        if p.is_shard(1):
            step = -(-length // mesh.size(i))
            start += c * step
            length = max(0, min(step, length - c * step))
    return start, length


def write_slot_(k_cache, v_cache, k_new, v_new, pos: int,
                window: int = 0) -> None:
    """In place: one token's (already-RoPE'd) K/V into slot `pos` (ring
    slot pos mod T iff SWA; else pos, which must be below the capacity
    T).  A slice at a host integer: deterministic on CUDA.  A DTensor
    cache whose time dim is sharded is written on local shards
    (`_write_local_slot_`)."""
    T = k_cache.shape[1]
    slot = pos % T if window else pos
    if not 0 <= slot < T:
        raise ValueError(f"KV cache full: position {pos}, capacity {T}")
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        if hasattr(cache, "device_mesh") and any(
                p.is_shard(1) for p in cache.placements):
            _write_local_slot_(cache, new, slot)
        else:
            cache[:, slot] = new[:, 0].to(cache.dtype)


def _write_local_slot_(cache, new, slot: int) -> None:
    """`cache[:, slot] = new[:, 0]` for a DTensor cache (B,T,K,hd) whose
    time dim is sharded, written into the local shard of the ranks that
    hold the slot, at its local index; `new` (B,1,K,hd) is first placed
    as the cache on its batch and head dims (a collective of every
    rank).  DTensor's own slice write there lands elsewhere and raises
    nothing (ROADMAP.md section C, "DTensor ops on local shards")."""
    from torch.distributed.tensor import Replicate

    new = new.redistribute(cache.device_mesh, [
        Replicate() if p.is_shard(1) else p for p in cache.placements])
    start, length = _time_range(cache)
    local = cache.to_local()
    if local.shape[1] != length:
        raise AssertionError(f"local time shard of {local.shape[1]}, "
                             f"expected {length}")
    if start <= slot < start + length:
        local[:, slot - start] = new.to_local()[:, 0].to(local.dtype)


def cache_write(k_cache, v_cache, k_new, v_new, pos, window: int = 0):
    """Functional, as the reference: new caches with one token's K/V
    written at `pos`; the given caches are left as they were."""
    k_cache, v_cache = k_cache.clone(), v_cache.clone()
    write_slot_(k_cache, v_cache, k_new, v_new, int(pos), window)
    return k_cache, v_cache
