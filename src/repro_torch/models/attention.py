"""Attention: GQA projections, causal, sliding-window and cross
attention over a sequence, and single-token decode against a KV cache.

Port of `repro.models.attention`.  The reference's flash and
sliding-window attention are chunked pure jnp with custom VJPs (no
Pallas kernel).  On a CUDA tensor in bf16, flash attention runs the
hand-written kernels of `repro_torch.kernels.attention` (`_Fused`: bf16
tensor-core products summed in f32, the softmax on chip, a backward
without atomics); the choice follows only the input's device, dtype and
head dim (`attention.ops.runs_kernel`).  Everywhere else (CPU tensors,
other dtypes, the dry-run's fake tensors), and for sliding-window
attention, the port writes the reference as plain PyTorch ops: f32
scores and softmax, probabilities rounded to the compute dtype before
the value product as in the reference, GQA by grouping the query heads
(K/V are never repeated).  Both loop over blocks of `chunk` queries,
each against its keys (all T keys for flash attention, so queries and
keys may differ in length, as cross attention needs), so the score
tensor of one call is O(chunk) rows, never (S, T).  Each block is one
`_Attend`, the reference's custom VJP: it keeps its inputs, its output and the row
log-sum-exp, and its backward recomputes the probabilities, so a
block's backward, too, holds one block's scores at a time.  Queries,
keys and values are laid out heads first, (B, K, ., hd), once per
call, so that every product of a block is a batched matrix product
over (B, K) that reads its operands where they lie.
"""
from __future__ import annotations

import functools
import itertools
import math

import torch
import torch.distributed as dist

from repro_torch.kernels.attention import ops as attention_ops
from repro_torch.models.layers import _dense_init, apply_rope, pad_dim
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


def qkv_proj(p, x, rope_theta: float, positions, rope: bool = True):
    """x: (B,S,d) -> q (B,S,H,hd), k,v (B,S,K,hd) with RoPE applied
    (none where `rope` is False)."""
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(dt))
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if rope:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v


def out_proj(p, o):
    return torch.einsum("bshk,hkd->bsd", o, p["wo"].to(o.dtype))


def _group(q, n_kv: int):
    """(B,S,H,hd) -> (B,S,K,G,hd) grouped query heads."""
    B, S, H, hd = q.shape
    return q.reshape(B, S, n_kv, H // n_kv, hd)


def _kv_of_heads(h0: int, n: int, group: int):
    """The KV head of each run of the query heads h0..h0+n-1, where a KV
    head serves `group` consecutive query heads: runs of gcd(n, group)
    heads, each inside one group (a whole group where the heads are
    whole groups), so that grouping the n heads by the runs is a
    reshape."""
    s = math.gcd(n, group)
    return [(h0 + j * s) // group for j in range(n // s)]


def _pick_heads(x, idx, dim: int = 2):
    """x with its heads dim `dim` (K) cut to the heads `idx` (a
    non-decreasing list), in order: each head's run of repeats is one
    expanded view, so the backward sums a run in a fixed order (an
    indexed gather's backward adds repeats with atomics on CUDA)."""
    parts = []
    for k, run in itertools.groupby(idx):
        part = x.narrow(dim, k, 1)
        shape = list(part.shape)
        shape[dim] = len(list(run))
        parts.append(part.expand(shape))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


def _head_range(x, dims, dim: int = 2):
    """(first head, heads) of this rank's block of DTensor `x`'s heads
    dim `dim`, split evenly over the mesh dims `dims` in mesh order."""
    mesh = x.device_mesh
    lo, n = 0, x.shape[dim]
    for i in dims:
        n //= mesh.size(i)
        lo += mesh.get_local_rank(i) * n
    return lo, n


def kv_for_query_heads(p):
    """Attention params `p` whose K/V projections (`wk`, `wv`, and `bk`,
    `bv`) are cut, on each rank, to the KV heads of its own query heads,
    where the query heads split over mesh ranks that the K groups do not
    divide (K replicated there): each becomes a DTensor of (d, n * J,
    hd) split over those n ranks, rank r's J heads being the KV head of
    each run of its query heads (`_kv_of_heads`), so the projections
    make only the K/V its heads read, as the reference's partitioner
    does, and `_on_mesh` then finds whole groups on every rank.  Each
    weight's gradient is the partial sum of the ranks' picks.  For
    training: a prefill keeps the K/V of every head (its caches), and
    without such a split `p` is returned as it is."""
    wq = p["wq"]
    if not hasattr(wq, "device_mesh"):
        return p
    from torch.distributed.tensor import Replicate, Shard

    mesh = wq.device_mesh
    heads = [i for i, pl in enumerate(wq.placements) if pl == Shard(1)]
    n, H, K = (math.prod(mesh.size(i) for i in heads), wq.shape[1],
               p["wk"].shape[1])
    if K % n == 0 or H % n:
        return p
    idx = _kv_of_heads(*_head_range(wq, heads, dim=1), H // K)

    def pick(w, dim):
        pl = tuple(Replicate() if i in heads else q
                   for i, q in enumerate(w.placements))
        out = tuple(Shard(dim) if i in heads else q for i, q in enumerate(pl))
        return on_local_shards(lambda w: _pick_heads(w, idx, dim), (w,),
                               (pl,), out)

    return dict(p, **{k: pick(p[k], 1 if k[0] == "w" else 0)
                      for k in ("wk", "wv", "bk", "bv") if k in p})


def _on_mesh(fn, q, k, v):
    """`fn(q, k, v)` (an attention over plain tensors: q (B,S,H,hd), k, v
    (B,T,K,hd) -> (B,S,H,hd)) of DTensors, on each rank's local shards.
    q is split on its batch and query heads where it is, and replicated
    on any other mesh dim; k and v alike on the batch, and on the heads
    where the ranks that split the query heads split the K groups too
    (each rank then holds whole groups).  Where they do not (qwen2-0.5b's
    2 KV heads over a "model" axis of 16, hymba's 6 over 16), k and v
    stay whole on those dims and each rank picks the KV heads of its own
    query heads [h0, h1) (`_kv_of_heads`, `_pick_heads`): every rank
    attends only its own heads, as the reference's partitioner splits
    the (H) -> (K, G) reshape over both factors where the heads of a
    rank lie in one group.  A rank's heads that straddle two groups
    (hymba's 3 a rank with groups of 8) are split too, where the
    reference's partitioner runs every head on each rank.  k and v then
    get their gradient as a partial sum over those ranks
    (`on_local_shards`).  Training has cut the K/V projections to each
    rank's heads first (`kv_for_query_heads`), so there the groups are
    whole.  DTensor would otherwise plan a sharding for each op of each
    block shape (~25 s of the first step on a (2 x 2) CPU mesh)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = q.device_mesh
    heads = [i for i, p in enumerate(q.placements) if p == Shard(2)]
    n, H, K = math.prod(mesh.size(i) for i in heads), q.shape[2], k.shape[2]
    if H % n:
        heads, n = [], 1            # an uneven split: whole heads
    q_pl = tuple(p if p == Shard(0) or i in heads else Replicate()
                 for i, p in enumerate(q.placements))
    whole = K % n == 0
    kv_pl = tuple(p if p == Shard(0) or whole else Replicate() for p in q_pl)
    local = fn
    if not whole:
        idx = _kv_of_heads(*_head_range(q, heads), H // K)
        local = lambda q, k, v: fn(q, _pick_heads(k, idx),
                                   _pick_heads(v, idx))
    return on_local_shards(local, (q, k, v), (q_pl, kv_pl, kv_pl), q_pl)


def _scale(q, scale=None):
    """The softmax scale in q's dtype: `scale`, or 1/sqrt(head_dim)."""
    if scale is not None:
        return torch.tensor(scale, dtype=torch.float32).to(dtype=q.dtype,
                                                           device=q.device)
    hd = q.shape[-1]
    return (1.0 / torch.sqrt(torch.tensor(hd, dtype=torch.float32))).to(
        dtype=q.dtype, device=q.device)


def _heads_first(q, k, v, scale=None):
    """Scaled queries (B,S,H,hd) -> (B,K,S,G,hd) in their dtype, and k, v
    (B,T,K,hd) -> (B,K,T,hd) f32, each copied once per call into the
    layout in which every block's products are batched matrix products
    over (B, K) with no further copy."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    qh = _group(q * _scale(q, scale), K).permute(0, 2, 1, 3, 4).contiguous()
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
    return _Attend.apply(q, kh, vh, keep).reshape(B, K, c, G, hd)


def _heads_last(blocks):
    """(B,K,c,G,hd) blocks in query order -> (B,S,H,hd)."""
    o = blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=2)
    B, K, S, G, hd = o.shape
    return o.permute(0, 2, 1, 3, 4).reshape(B, S, K * G, hd)


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


class _Fused(torch.autograd.Function):
    """Flash attention through the kernels of
    `repro_torch.kernels.attention`: q (B,S,H,hd) scaled, k, v (B,T,K,hd),
    all in the compute dtype, read where they lie.  It keeps q, k, v, the
    output and the row log-sum-exp (B, K, S * G), never a score: the
    backward kernels recompute the probabilities, as the reference's
    `_flash_bwd` does."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        # one product to remat "dots", as `_Attend`
        out, lse = saved_result(attention_ops.forward, q, k, v, causal)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*attention_ops.backward(q, k, v, out, lse, dout, ctx.causal),
                None)


def flash_attention(q, k, v, *, causal: bool, chunk: int = 128,
                    scale=None):
    """q: (B,S,H,hd); k,v: (B,T,K,hd) -> (B,S,H,hd).

    On the card in bf16 (`attention_ops.runs_kernel`), one `_Fused`
    (the kernels; `chunk` is not read).  Else `_chunked_attention`.  As
    in the reference, q is scaled in its own dtype, by `scale` (None:
    1/sqrt(head_dim)).  On a mesh (DTensors) it runs on local shards
    (`_on_mesh`)."""
    if hasattr(q, "device_mesh"):
        return _on_mesh(functools.partial(flash_attention, causal=causal,
                                          chunk=chunk, scale=scale), q, k, v)
    if attention_ops.runs_kernel(q):
        return _Fused.apply(q * _scale(q, scale), k, v, causal)
    return _chunked_attention(q, k, v, causal, chunk, scale)


def _chunked_attention(q, k, v, causal: bool, chunk: int, scale=None):
    """`flash_attention`'s plain version, on plain tensors.

    Blocks of `chunk` queries, each against all T keys (T may differ
    from S: non-causal cross attention), or, causal, against the keys up
    to its last query (the later keys would get probability exactly
    0): the reference's online softmax over key blocks is, in exact
    arithmetic, this single pass over every key of a query row.  Memory
    O(B * chunk * H * T) for the scores, forward and backward."""
    S, T = q.shape[1], k.shape[1]
    qh, kh, vh = _heads_first(q, k, v, scale)
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
    queries attends to its `window + chunk` key span.  On a mesh
    (DTensors) it runs on local shards (`_on_mesh`)."""
    if hasattr(q, "device_mesh"):
        return _on_mesh(functools.partial(sliding_window_attention,
                                          window=window, chunk=chunk),
                        q, k, v)
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
    KV-head dims (whole groups of query heads follow their KV head), and
    each rank attends over its own cache slots, the softmax and the
    value sum reduced over the ranks that split the time dim
    (`_decode_attend`).  Where the caches' KV heads do not divide over
    the ranks that split q's heads, and those ranks hold the caches
    whole, q keeps its head split and each rank picks the KV heads of its
    own heads, as in training (`_on_mesh`).  DTensor's own einsum here
    merges the batch and head dims in a view, which the card's torch
    (2.11) cannot plan where both are sharded (ROADMAP.md section C,
    "DTensor ops on local shards")."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = k_cache.device_mesh
    cache_pl = tuple(k_cache.placements)
    heads = [] if any(p.is_shard(2) for p in cache_pl) else [
        i for i, (p, c) in enumerate(zip(q.placements, cache_pl))
        if p == Shard(2) and c == Replicate()]
    if q.shape[2] % math.prod(mesh.size(i) for i in heads):
        heads = []
    q_pl = tuple(p if p.is_shard(0) or p.is_shard(2) else
                 Shard(2) if i in heads else Replicate()
                 for i, p in enumerate(cache_pl))
    start, _ = _time_range(k_cache)
    groups = [mesh.get_group(i) for i, p in enumerate(cache_pl)
              if p.is_shard(1) and mesh.size(i) > 1]
    q = q.redistribute(mesh, q_pl)
    k, v = k_cache.to_local(), v_cache.to_local()
    if heads:
        idx = _kv_of_heads(*_head_range(q, heads), q.shape[2] // k.shape[2])
        k, v = _pick_heads(k, idx), _pick_heads(v, idx)
    o = _decode_attend(q.to_local(), k, v, pos, window, k_cache.shape[1],
                       start, groups)
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
