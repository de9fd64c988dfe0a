"""Chunked linear attention with per-channel decay: the shared engine of
the Mamba-2-style SSM heads (hymba) and RWKV-6 time-mix; and the chunked
SSD of Mamba-2 (`chunked_ssd`, granite-4.0-h's mixers).

Port of `repro.models.linear_attention`.  Recurrences (state S:
(B, H, dk, dv), f32):

  mode="mamba":  S_t = exp(lw_t) * S_{t-1} + k_t^T v_t ;  y_t = q_t S_t
  mode="rwkv":   y_t = r_t S_{t-1} + (r_t * (u * k_t)) v_t ;
                 S_t = exp(lw_t) * S_{t-1} + k_t^T v_t

(lw = per-channel log decay <= 0, applied along dk.)  The semantics are
the reference's: chunks of C = the largest divisor of S not above
min(request, S, SAFE_CHUNK); inside a chunk the pairwise decays factor as
exp(W_i - W_j) = exp(W_i) * exp(-W_j), with W the in-chunk cumulative
log decay, which stays inside f32's exp range because each step's log
decay is clipped to [-LW_MIN, 0] first (span <= C * LW_MIN = 80 < 88);
the body runs in f32 whatever the inputs' dtype, the output is cast
back to q's dtype and the state stays f32.

The reference scans the chunks one after another (`lax.scan`, ~15 ops a
chunk).  Eager PyTorch pays a launch per op, so here everything that does
not depend on the carried state is computed for all n = S / C chunks at
once, in the reference's einsums: the decays, the masked (C, C)
intra-chunk term, each chunk's state contribution k_fut^T v and its
decay exp(w_last).  Only the recurrence state_c = state_{c-1} * decay_c
+ delta_c runs as a loop of n steps (the state before each chunk kept),
and one batched einsum reads every chunk's carried state out.  Results
agree with the reference's to f32 rounding.  The per-chunk contributions
take (B, n, H, dk, dv) f32.

`chunked_ssd` is the state-space dual of Mamba-2 (arXiv:2405.21060 §7)
with one scalar decay a head and B, C shared by the heads of a group:

  h_t = exp(dt_t A) h_{t-1} + dt_t x_t^T B_t ;  y_t = C_t h_t

with no clamp of the log decay dt_t A.  Inside a chunk the decay from
position s to l is exp(segsum), the in-chunk cumulative log decay at l
less that at s, masked to -inf above the diagonal before `exp`, so no
factor can overflow however strong the decay; C B^T is formed once per
group and chunk; each chunk's state contribution is carried across
chunks by one (n + 1, n + 1) product of chunk decays (their segsum over
the chunks' totals, a masked cumulative sum).  Everything is f32.
"""
from __future__ import annotations

import torch

from repro_torch.sharding.rules import on_local_shards

DEFAULT_CHUNK = 32
LW_MIN = 2.5   # per-step log-decay floor
SAFE_CHUNK = 32  # hard cap: chunk * LW_MIN = 80 < 88 (f32 exp range)


def _check_mode(mode: str) -> None:
    if mode not in ("mamba", "rwkv"):
        raise ValueError(f"mode must be 'mamba' or 'rwkv', not {mode!r}")


def chunked_linear_attention(q, k, v, lw, *, mode: str, u=None,
                             state0=None, chunk: int = DEFAULT_CHUNK):
    """q,k: (B,S,H,dk); v: (B,S,H,dv); lw: (B,S,H,dk) log-decay <= 0.

    Returns (out (B,S,H,dv) in q.dtype, final_state (B,H,dk,dv) f32).
    On a mesh (DTensor inputs) it runs on each rank's local shards
    (`_on_local_shards`).
    """
    _check_mode(mode)
    if hasattr(v, "device_mesh"):
        return _on_local_shards(q, k, v, lw, mode=mode, u=u, state0=state0,
                                chunk=chunk)
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    chunk = min(chunk, S, SAFE_CHUNK)
    while S % chunk:  # largest divisor <= requested
        chunk -= 1
    n = S // chunk
    f32 = torch.float32

    def to_chunks(x):                            # (B, n, C, H, *) in f32
        return x.reshape(B, n, chunk, *x.shape[2:]).to(f32)

    qf, kf, vf = map(to_chunks, (q, k, v))
    lx = torch.clamp(to_chunks(lw), -LW_MIN, 0.0)
    W = torch.cumsum(lx, dim=2)                  # inclusive in-chunk decay
    if mode == "mamba":
        q_dec = qf * torch.exp(W)                # readout after decay+add
    else:
        q_dec = qf * torch.exp(W - lx)           # readout before this step
    k_dec = kf * torch.exp(-W)
    # intra-chunk pairwise terms (lower-triangular (C, C) products)
    causal_lower = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                         device=q.device),
                              diagonal=0 if mode == "mamba" else -1)
    A = torch.einsum("bnihk,bnjhk->bnhij", q_dec, k_dec)
    A = torch.where(causal_lower, A, torch.zeros((), dtype=f32,
                                                 device=q.device))
    if mode == "rwkv":
        diag = torch.einsum("bnihk,bnihk->bnhi", qf, kf * u.to(f32))
        A = A + torch.diag_embed(diag)
    out = torch.einsum("bnhij,bnjhv->bnihv", A, vf)
    # each chunk's state contribution and decay, then the recurrence
    w_last = W[:, :, -1:]                        # (B,n,1,H,dk)
    k_fut = kf * torch.exp(w_last - W)
    delta = torch.einsum("bnjhk,bnjhv->bnhkv", k_fut, vf)
    decay = torch.exp(w_last[:, :, 0])[..., None]          # (B,n,H,dk,1)
    state = (torch.zeros((B, H, dk, dv), dtype=f32, device=q.device)
             if state0 is None else state0.to(f32))
    before = []
    for c in range(n):
        before.append(state)
        state = state * decay[:, c] + delta[:, c]
    # inter-chunk contribution from the state carried into each chunk
    out = out + torch.einsum("bnihk,bnhkv->bnihv", q_dec,
                             torch.stack(before, dim=1))
    return out.reshape(B, S, H, dv).to(q.dtype), state


def _on_local_shards(q, k, v, lw, *, mode, u, state0, chunk):
    """`chunked_linear_attention` of DTensors on each rank's own (B, H)
    block: the recurrence is independent across batch rows and heads,
    so q, k, v and lw are placed as v is on the batch and head dims
    (dims 0 and 2; a replicated operand is sliced locally, a partial one
    reduced), `u` and `state0` alike on their head dim (`u`, whole over
    the data axes, gets its gradient there as a partial sum), and the
    local tensors go through the same ops as without a mesh
    (`on_local_shards`).  DTensor would otherwise plan a sharding for
    each op of the engine at each shape: most of a first step on a
    (2 x 2) CPU mesh."""
    from torch.distributed.tensor import Replicate, Shard

    R = Replicate()
    pl = tuple(p if type(p) is Shard and p.dim in (0, 2) else R
               for p in v.placements)
    # the (B,H,dk,dv) state and the (H,dk) bonus split as the heads
    state_pl = tuple(Shard(1) if p == Shard(2) else p for p in pl)
    u_pl = tuple(Shard(0) if p == Shard(2) else R for p in pl)

    def engine(q, k, v, lw, u, state0):
        return chunked_linear_attention(q, k, v, lw, mode=mode, u=u,
                                        state0=state0, chunk=chunk)

    return on_local_shards(engine, (q, k, v, lw, u, state0),
                           (pl, pl, pl, pl, u_pl, state_pl), (pl, state_pl))


def linear_attention_step(q, k, v, lw, *, mode: str, u=None, state=None):
    """Single-token recurrence for decode. q,k: (B,H,dk); v: (B,H,dv);
    lw: (B,H,dk).  Returns (out (B,H,dv), new_state (B,H,dk,dv) f32).
    On a mesh (DTensor inputs) it runs on local shards
    (`_step_on_local_shards`)."""
    _check_mode(mode)
    if hasattr(q, "device_mesh"):
        return _step_on_local_shards(q, k, v, lw, mode=mode, u=u,
                                     state=state)
    B, H, dk = q.shape
    dv = v.shape[-1]
    f32 = torch.float32
    if state is None:
        state = torch.zeros((B, H, dk, dv), dtype=f32, device=q.device)
    qf, kf, vf = (x.to(f32) for x in (q, k, v))
    kv = torch.einsum("bhk,bhv->bhkv", kf, vf)
    lwf = torch.clamp(lw.to(f32), -LW_MIN, 0.0)
    decay = torch.exp(lwf)[..., None]                     # (B,H,dk,1)
    if mode == "mamba":
        state = state * decay + kv
        out = torch.einsum("bhk,bhkv->bhv", qf, state)
    else:
        read = state + kv * u.to(f32)[None, :, :, None]
        out = torch.einsum("bhk,bhkv->bhv", qf, read)
        state = state * decay + kv
    return out.to(q.dtype), state


def _step_on_local_shards(q, k, v, lw, *, mode, u, state):
    """`linear_attention_step` of DTensors on each rank's own (B, H)
    block, placed as the state is on its batch and head dims
    (dims 0 and 1), `u` alike on its head dim: the recurrence is
    independent across batch rows and heads.  DTensor's own einsums
    here merge the batch and head dims in a view, which the card's
    torch (2.11) cannot plan where both are sharded (ROADMAP.md section
    C, "DTensor ops on local shards")."""
    from torch.distributed.tensor import Replicate, Shard

    R = Replicate()
    pl = tuple(p if type(p) is Shard and p.dim in (0, 1) else R
               for p in state.placements)
    u_pl = tuple(Shard(0) if p == Shard(1) else R for p in pl)

    def step(q, k, v, lw, u, state):
        return linear_attention_step(q, k, v, lw, mode=mode, u=u,
                                     state=state)

    return on_local_shards(step, (q, k, v, lw, u, state),
                           (pl, pl, pl, pl, u_pl, pl), (pl, pl))


def _segsum(x):
    """x: (..., T) -> (..., T, T) with [i, j] = x[j+1] + ... + x[i] for
    j <= i (0 on the diagonal) and -inf above it: the sum of the
    increments taken as a masked cumulative sum, never as a difference
    of two cumulative sums, so it loses nothing to cancellation."""
    T = x.shape[-1]
    xx = x[..., None].expand(*x.shape, T)             # [i, j] = x[i]
    below = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device),
                       diagonal=-1)
    seg = torch.cumsum(xx.masked_fill(~below, 0.0), dim=-2)
    keep = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device))
    return seg.masked_fill(~keep, float("-inf"))


def chunked_ssd(x, dt, A, Bm, Cm, *, chunk: int = 256, state0=None):
    """Mamba-2's SSD over a full sequence.

    x: (B, S, H, P); dt: (B, S, H) step sizes (after softplus); A: (H,)
    negative; Bm, Cm: (B, S, G, N), G dividing H (heads h * G // H ..
    share group g).  Returns (y (B, S, H, P) f32, final state (B, H, P,
    N) f32); the D skip is the caller's.  `chunk` is cut to the largest
    divisor of S not above it."""
    f32 = torch.float32
    b, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    hg = H // G
    l = min(chunk, S)
    while S % l:
        l -= 1
    c = S // l
    dA = (dt.to(f32) * A.to(f32)).reshape(b, c, l, H)      # log decay <= 0
    X = (x.to(f32) * dt.to(f32)[..., None]).reshape(b, c, l, H, P)
    Bc = Bm.to(f32).reshape(b, c, l, G, N)
    Cc = Cm.to(f32).reshape(b, c, l, G, N)
    At = torch.cumsum(dA, dim=2).transpose(2, 3)          # (b, c, H, l)
    # 1. inside each chunk: y_l = sum_{s<=l} C_l.B_s exp(seg[l, s]) X_s
    keep = torch.tril(torch.ones(l, l, dtype=torch.bool, device=x.device))
    seg = (At[..., :, None] - At[..., None, :]).masked_fill(~keep,
                                                             float("-inf"))
    CB = torch.einsum("bclgn,bcsgn->bcgls", Cc, Bc)       # per group
    M = (torch.exp(seg).view(b, c, G, hg, l, l) * CB[:, :, :, None]).view(
        b, c, H, l, l)
    y = torch.einsum("bchls,bcshp->bclhp", M, X)
    # 2. each chunk's state at its end, from its own inputs
    Xd = X * torch.exp(At[..., -1:] - At).transpose(2, 3)[..., None]
    states = torch.einsum("bcsgn,bcsgq->bcgqn", Bc,
                          Xd.reshape(b, c, l, G, hg * P))
    states = states.reshape(b, c, H, P, N)
    # 3. carried across chunks: the state entering chunk z sums chunk k's
    # (k < z) decayed by the chunks between
    h0 = (torch.zeros((b, 1, H, P, N), dtype=f32, device=x.device)
          if state0 is None else state0.to(f32)[:, None])
    states = torch.cat([h0, states], dim=1)               # (b, c+1, ...)
    tot = torch.nn.functional.pad(At[..., -1].transpose(1, 2), (1, 0))
    carry = torch.exp(_segsum(tot))                       # (b, H, c+1, c+1)
    states = torch.einsum("bhzk,bkhpn->bzhpn", carry, states)
    # 4. the state entering each chunk, read at each position
    before = states[:, :-1].reshape(b, c, G, hg * P, N)
    y_off = torch.einsum("bclgn,bcgqn->bclgq", Cc, before).reshape(
        b, c, l, H, P)
    y = y + y_off * torch.exp(At).transpose(2, 3)[..., None]
    return y.reshape(b, S, H, P), states[:, -1]
