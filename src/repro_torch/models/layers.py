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

from repro_torch.models.remat import checkpoint_name


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


def head_rms_norm(x, eps: float = 1e-5):
    """Per-head RMS norm (rwkv group-norm analogue). x: (..., H, hd)."""
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(dt)


def hold_placements(x, mesh, want):
    """DTensor `x` redistributed to `want`, and its gradient too in the
    backward, which DTensor would otherwise leave as the op that made it
    chose (the transpose of the reference's sharding constraint, which
    constrains the cotangent as well)."""
    return _Hold.apply(x, mesh, tuple(want))


class _Hold(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, want):
        ctx.mesh, ctx.want = mesh, want
        return x if tuple(x.placements) == want else x.redistribute(mesh,
                                                                      want)

    @staticmethod
    def backward(ctx, grad):
        if tuple(grad.placements) != ctx.want:
            grad = grad.redistribute(ctx.mesh, ctx.want)
        return grad, None, None


def pad_dim(x, n: int, dim: int, *, end: bool = False):
    """`x` with `n` zeros along `dim`, in front or, with `end`, after it:
    `F.pad`'s values, built by a concatenation, because on a DTensor
    `F.pad` of the card's torch (2.11) gives a result whose shape misses
    the pad."""
    shape = list(x.shape)
    shape[dim] = n
    zeros = torch.zeros_like(x.narrow(dim, 0, 1)).expand(shape)
    return torch.cat([x, zeros] if end else [zeros, x], dim=dim)


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


def sinusoidal_positions(n_pos: int, d_model: int, device=None):
    """(n_pos, d_model) f32 absolute positions, [sin | cos] of
    pos * exp(-log(1e4) * i / half) (the enc-dec encoder's)."""
    pos = torch.arange(n_pos, dtype=torch.float32, device=device)[:, None]
    half = d_model // 2
    log_base = torch.log(torch.tensor(10_000.0, device=device))
    div = torch.exp(-log_base * torch.arange(half, dtype=torch.float32,
                                             device=device) / half)
    ang = pos * div
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


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
    gu, wo = g * u, p["wo"].to(x.dtype)
    with checkpoint_name("mlp_out"):
        return torch.einsum("bsf,fd->bsd", gu, wo)


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


@torch.library.custom_op("repro_torch::sum_rows_by_id", mutates_args=())
def sum_rows_by_id(rows: torch.Tensor, ids: torch.Tensor,
                   n: int) -> torch.Tensor:
    """(N, d) `rows` summed per id into an (n, d) float32 tensor, the
    rows of each id added in an order fixed by the ids alone: a stable
    sort puts equal ids together, and each run of equal ids is summed
    pairwise (rank r takes rank r + s, s = 1, 2, 4, ...).  Every write
    goes to distinct rows, so no two adds race, and the result is the
    same bits on every run and every device (an `index_add_` on CUDA
    adds repeated ids with atomics, in no fixed order).  An op of its
    own, so that a step runs on fake tensors too (the dry-run): its
    shapes depend on the ids' values, and its fake version gives the
    (n, d) result from the shapes alone."""
    if ids.numel() == 0:
        return rows.new_zeros((n, rows.shape[1]), dtype=torch.float32)
    order = torch.argsort(ids, stable=True)
    ids = ids[order]
    acc = rows[order].to(torch.float32)
    first = torch.ones_like(ids, dtype=torch.bool)
    first[1:] = ids[1:] != ids[:-1]
    starts = torch.nonzero(first).squeeze(1)
    lengths = torch.diff(starts, append=starts.new_tensor([ids.numel()]))
    run = torch.cumsum(first, 0) - 1            # integer: exact in any order
    rank = torch.arange(ids.numel(), device=ids.device) - starts[run]
    length = lengths[run]
    step, longest = 1, int(lengths.max())
    while step < longest:
        i = torch.nonzero((rank % (2 * step) == 0)
                          & (rank + step < length)).squeeze(1)
        acc[i] = acc[i] + acc[i + step]
        step *= 2
    out = acc.new_zeros((n, acc.shape[1]))
    out[ids[starts]] = acc[starts]
    return out


@sum_rows_by_id.register_fake
def _(rows, ids, n):
    return rows.new_empty((n, rows.shape[1]), dtype=torch.float32)


@torch.library.custom_op("repro_torch::sum_block_rows_by_id", mutates_args=())
def sum_block_rows_by_id(rows: torch.Tensor, ids: torch.Tensor, lo: int,
                         n: int) -> torch.Tensor:
    """`sum_rows_by_id` of the rows whose ids fall in lo..lo+n-1 (a
    rank's block of a table's rows), into (n, d) at id - lo; an op of
    its own for the same reason."""
    keep = (ids >= lo) & (ids < lo + n)
    return sum_rows_by_id(rows[keep], ids[keep] - lo, n)


@sum_block_rows_by_id.register_fake
def _(rows, ids, lo, n):
    return rows.new_empty((n, rows.shape[1]), dtype=torch.float32)

class _EmbedGather(torch.autograd.Function):
    """rows = table[ids] cast to `dtype`; the backward sums the gradient
    rows of repeated ids with `sum_rows_by_id` (float32, fixed order),
    so a training step is bit-reproducible on CUDA without
    `torch.use_deterministic_algorithms`."""

    @staticmethod
    def forward(ctx, table, ids, dtype):
        ctx.save_for_backward(ids)
        ctx.n_rows = table.shape[0]
        return torch.index_select(table, 0, ids).to(dtype)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        return sum_rows_by_id(grad, ids, ctx.n_rows), None, None


def _vocab_range(n_rows: int, mesh, dims):
    """(first row, rows) of this rank's block of a table of `n_rows`
    rows split evenly on dim 0 over the mesh dims `dims`, in mesh
    order."""
    lo, size = 0, n_rows
    for i in dims:
        size //= mesh.size(i)
        lo += mesh.get_local_rank(i) * size
    return lo, size


class _MeshEmbedGather(torch.autograd.Function):
    """The embedding gather on a mesh, run on local shards: no sharding
    rule of DTensor covers the fixed-order backward (`sum_rows_by_id`
    sorts and selects with `nonzero`).

    table: DTensor (V, d), split on dim 0 over the mesh dims `vdims`
    (the vocabulary over "model") and replicated over the others; tokens:
    DTensor (B, S).  Forward: each rank looks up its local ids that fall
    in its block of rows and zeroes the rest, so the rows are `Partial`
    (summed) over `vdims` and keep the tokens' placements elsewhere.
    Backward: the ids and the gradient rows are gathered whole (over the
    data axes), and each rank sums, with `sum_rows_by_id`, the rows of
    the ids in its block in the global order of the tokens: every id's
    sum is the one the mesh-free backward makes, bit for bit, on any
    mesh, and the table gradient has the table's placements."""

    @staticmethod
    def forward(ctx, table, tokens, dtype, vdims):
        from torch.distributed.tensor import DTensor, Partial

        mesh = table.device_mesh
        lo, size = _vocab_range(table.shape[0], mesh, vdims)
        ids = tokens.to_local().reshape(-1).to(torch.int64)
        keep = (ids >= lo) & (ids < lo + size)
        rows = torch.index_select(table.to_local(), 0,
                                  torch.where(keep, ids - lo, 0))
        rows = torch.where(keep[:, None], rows, 0).to(dtype)
        ctx.save_for_backward(tokens)
        ctx.table_spec = (mesh, table.placements, table.shape, vdims)
        out = [Partial() if i in vdims else pl
               for i, pl in enumerate(tokens.placements)]
        local = rows.reshape(*tokens.to_local().shape, table.shape[-1])
        return DTensor.from_local(local, mesh, out, run_check=False)

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import DTensor

        (tokens,) = ctx.saved_tensors
        mesh, table_pl, table_shape, vdims = ctx.table_spec
        ids = tokens.full_tensor().reshape(-1).to(torch.int64)
        g = grad.full_tensor().reshape(ids.numel(), -1)
        lo, size = _vocab_range(table_shape[0], mesh, vdims)
        local = sum_block_rows_by_id(g, ids, lo, size)
        return (DTensor.from_local(local, mesh, table_pl, run_check=False),
                None, None, None)


def _mesh_embed(table, tokens, dtype):
    """`_MeshEmbedGather` of a DTensor table: the table is first
    redistributed (with autograd) so that it is split on dim 0 only over
    the mesh dims that do not split the tokens, and replicated over the
    rest (an FSDP table is gathered over the data axes here)."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = table.device_mesh
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh,
                                    [Replicate()] * mesh.ndim,
                                    run_check=False)
    vdims = tuple(i for i, (tp, pl) in enumerate(zip(tokens.placements,
                                                     table.placements))
                  if pl.is_shard(0) and not tp.is_shard())
    want = tuple(table.placements[i] if i in vdims else Replicate()
                 for i in range(mesh.ndim))
    if tuple(table.placements) != want:
        table = table.redistribute(mesh, want)
    return _MeshEmbedGather.apply(table, tokens, dtype, vdims)


def embed_apply(p, tokens, dtype):
    """Row gather of the embedding table in `dtype` (the f32 rows are
    cast after the gather, which is the same as gathering from the cast
    table).  Its backward is deterministic on CUDA (`_EmbedGather`; on a
    mesh `_MeshEmbedGather`, bit-equal to it)."""
    table = p["embedding"]
    if hasattr(table, "device_mesh"):
        return _mesh_embed(table, tokens, dtype)
    ids = tokens.reshape(-1).to(torch.int64)
    rows = _EmbedGather.apply(table, ids, dtype)
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


def _logsumexp(logits):
    """`torch.logsumexp` over the last dim, keepdim.  On a mesh (DTensor
    logits) `_MeshLogSumExp`: DTensor's own gathers a vocab-split dim
    whole first (5.0 GB a loss chunk of qwen2-0.5b's train_4k cell on
    the 16 x 16 mesh, in the dry-run)."""
    if not hasattr(logits, "device_mesh"):
        return torch.logsumexp(logits, dim=-1, keepdim=True)
    return _MeshLogSumExp.apply(logits)


class _MeshLogSumExp(torch.autograd.Function):
    """ATen's logsumexp, op for op (the row max, the exponentials' sum,
    its log plus the max; backward grad * exp(x - lse)), on DTensors: a
    vocab-split dim is reduced by partial sums of (B, c, 1) values, and
    on one device the bits are `torch.logsumexp`'s."""

    @staticmethod
    def forward(ctx, x):
        m = x.amax(dim=-1, keepdim=True)
        m = m.masked_fill(m.abs() == math.inf, 0)
        lse = (x - m).exp().sum(dim=-1, keepdim=True).log() + m
        ctx.save_for_backward(x, lse)
        return lse

    @staticmethod
    def backward(ctx, grad):
        x, lse = ctx.saved_tensors
        return grad * (x - lse).exp()


def _target_logit(logits, idx):
    """`torch.gather(logits, -1, idx)`, (B, c, 1).  On a mesh (DTensor
    logits) on local shards: each rank picks the labels that fall in
    its block of the vocabulary and zero elsewhere, a partial sum over
    the mesh dims that split the vocabulary, whose sum is the gathered
    value exactly (one term is nonzero).  DTensor's own gather on a
    vocab-split dim keeps a masked partial sum, and its backward makes
    a zero tensor of the global (B, c, V) logits on every rank (79.7 GB
    a loss chunk of qwen2-0.5b's train_4k cell on the 16 x 16 mesh, in
    the dry-run); here the backward writes each rank's own block."""
    if not hasattr(logits, "device_mesh"):
        return torch.gather(logits, -1, idx)
    from torch.distributed.tensor import Partial

    from repro_torch.sharding.rules import on_local_shards

    mesh, pl = logits.device_mesh, tuple(logits.placements)
    vdims = tuple(i for i, p in enumerate(pl) if p.is_shard(2))
    lo, size = _vocab_range(logits.shape[-1], mesh, vdims)

    def pick(logits, idx):
        keep = (idx >= lo) & (idx < lo + size)
        got = torch.gather(logits, -1, torch.where(keep, idx - lo, 0))
        return torch.where(keep, got, 0.0)

    out = tuple(Partial() if i in vdims else p for i, p in enumerate(pl))
    return on_local_shards(pick, (logits, idx), (pl, idx.placements), out)


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
    (B, c, V) one-hot (2.5 GB per chunk at vocab 151936).  On a mesh
    the gather runs on local shards (`_target_logit`).
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
        lse = _logsumexp(logits)
        # (B, c, 1) until the difference: on a vocab-sharded mesh the
        # picked value is a partial sum, reduced at this shape
        tgt = _target_logit(logits, lx.to(torch.int64)[..., None])
        loss = (lse - tgt)[..., 0] * mx
        tot = tot + loss.sum()
        cnt = cnt + mx.sum()
    return tot, cnt
