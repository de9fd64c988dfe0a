"""Collectives over the p2p fabric, used by the MANA-2.0 protocol layer
(the paper's lesson §III-M: use the parallel fabric for bookkeeping, not
the coordinator).  Protocol traffic runs on negative tags, invisible to
the application-level drain counters.

All collectives follow MPI call-ordering semantics: every member of a
communicator issues them in the same order, so a per-(endpoint, gid)
sequence number yields matching tags without any central coordination.

Algorithm selection
-------------------
Every collective takes ``algo`` ("tree" | "linear"; default
``DEFAULT_ALGO``).  All members of a communicator must pass the same
``algo`` for a given call — the round structure must agree, exactly as a
real MPI library picks one algorithm per communicator-wide operation.

  "linear"  — the reference arms: root fan-out bcast, root fan-in
              gather, gather+bcast barrier and allreduce, direct-send
              alltoall.  O(n) serial work at the root; kept for
              equivalence tests and as the benchmark baseline.
  "tree"    — the scalable arms (O(log n) critical path):
                bcast     binomial tree rooted at ``root``
                gather    binomial tree (fan-in), subtree dicts merged
                          on the way up
                barrier   binomial combining tree (arrival wave up,
                          release wave down)
                allreduce binomial reduce to position 0 + binomial
                          bcast: message count stays at the linear
                          arm's minimum 2(n-1) while the root's serial
                          occupancy drops from O(n) to O(log^2 n);
                          reduction order is kept identical to the
                          linear arm (position-ascending), so any
                          *associative* op gives bit-identical results
                          on both arms
                alltoall  gather-transpose-scatter through the minimum
                          rank: 2(n-1) total messages (vs the pairwise
                          exchange's n^2 — n-1 sequential blocking
                          rounds per rank, which dominated the SIII-B
                          drain's scalar counter exchange at 512 ranks)

`allreduce_recursive_doubling` is additionally exposed as a third,
latency-optimal allreduce arm (MPICH-style non-power-of-two pre/post
phase).  On a real parallel network its ceil(log2 n) round critical
path beats the binomial tree's; in this GIL-bound simulation its
n*log(n) total message count makes it slower (the equivalence tests
cover its correctness, including the non-power-of-two fixup).

All algorithms are expressed as plain p2p sends on the SAME negative tag
space, so they stay wire-uniform: the drain/2PC protocol layer
(`core/drain.py`, `core/two_phase_commit.py`) runs unchanged on top, and
the §III-E mixed-semantics deadlock remains impossible by construction.
The tree arms consume one tag slot per call (multiple rounds between
the same pair rely on the fabric's per-(src, tag) FIFO order); the
linear barrier and allreduce consume two (nested gather + bcast) —
one more reason every rank must pass the same ``algo`` for a given
call, or the per-(endpoint, gid) tag sequences diverge.
"""
from __future__ import annotations

import pickle
from typing import Any, Callable, List, Optional, Sequence

from repro_torch.comm.fabric import Endpoint

ALGOS = ("tree", "linear")
DEFAULT_ALGO = "tree"


def set_default_algo(algo: str) -> str:
    """Set the module-wide default algorithm; returns the previous one."""
    global DEFAULT_ALGO
    if algo not in ALGOS:
        raise ValueError(f"unknown collective algo {algo!r}; one of {ALGOS}")
    prev, DEFAULT_ALGO = DEFAULT_ALGO, algo
    return prev


def _resolve(algo) -> str:
    algo = algo or DEFAULT_ALGO
    if algo not in ALGOS:
        raise ValueError(f"unknown collective algo {algo!r}; one of {ALGOS}")
    return algo


def _next_tag(ep: Endpoint, gid: int) -> int:
    # per-(endpoint, gid) sequence numbers live ON the endpoint: a module
    # dict keyed by id(fabric) is unsound (ids are reused after GC, which
    # leaks stale counters across simulations — found under pytest)
    seq = ep.coll_seq[gid] = ep.coll_seq.get(gid, 0) + 1
    # negative tag space: fold (gid, seq) into a distinct negative int
    return -(((gid & 0xFFFF) << 24) | (seq & 0xFFFFFF)) - 1


# ---------------------------------------------------------------------------
# bcast
# ---------------------------------------------------------------------------

def bcast(ep: Endpoint, ranks: Sequence[int], root: int, obj: Any,
          gid: int = 0, timeout: float = 60.0, algo: Optional[str] = None) -> Any:
    algo = _resolve(algo)  # validate BEFORE consuming a tag slot: a
    # rejected call must not desynchronize the per-gid tag sequence
    tag = _next_tag(ep, gid)
    if algo == "linear":
        return _bcast_linear(ep, ranks, root, obj, tag, timeout)
    return _bcast_tree(ep, ranks, root, obj, tag, timeout)


def _bcast_linear(ep, ranks, root, obj, tag, timeout):
    if ep.rank == root:
        payload = pickle.dumps(obj)
        for r in ranks:
            if r != root:
                ep.send(r, payload, tag)
        return obj
    return pickle.loads(ep.recv(root, tag, timeout=timeout).payload)


def _bcast_tree(ep, ranks, root, obj, tag, timeout):
    """Binomial tree over positions in `ranks`, re-rooted at `root`."""
    n = len(ranks)
    idx = ranks.index(ep.rank)
    root_idx = ranks.index(root)
    vr = (idx - root_idx) % n  # virtual rank: root is 0
    if vr == 0:
        mask = 1
        while mask < n:
            mask <<= 1
        mask >>= 1
    else:
        lsb = vr & -vr
        parent = ranks[(vr - lsb + root_idx) % n]
        obj = pickle.loads(ep.recv(parent, tag, timeout=timeout).payload)
        mask = lsb >> 1
    payload = None
    while mask:
        child = vr + mask
        if child < n:
            if payload is None:
                payload = pickle.dumps(obj)
            ep.send(ranks[(child + root_idx) % n], payload, tag)
        mask >>= 1
    return obj


# ---------------------------------------------------------------------------
# gather
# ---------------------------------------------------------------------------

def gather(ep: Endpoint, ranks: Sequence[int], root: int, obj: Any,
           gid: int = 0, timeout: float = 60.0, algo: Optional[str] = None) -> List[Any]:
    algo = _resolve(algo)  # validate before consuming a tag slot
    tag = _next_tag(ep, gid)
    if algo == "linear":
        return _gather_linear(ep, ranks, root, obj, tag, timeout)
    return _gather_tree(ep, ranks, root, obj, tag, timeout)


def _gather_linear(ep, ranks, root, obj, tag, timeout):
    if ep.rank == root:
        out = []
        for r in ranks:
            out.append(obj if r == root
                       else pickle.loads(ep.recv(r, tag, timeout=timeout).payload))
        return out
    ep.send(root, pickle.dumps(obj), tag)
    return []


def _gather_tree(ep, ranks, root, obj, tag, timeout):
    """Binomial fan-in: each node merges its children's subtree dicts
    (position -> obj) and forwards one message to its parent."""
    n = len(ranks)
    idx = ranks.index(ep.rank)
    root_idx = ranks.index(root)
    vr = (idx - root_idx) % n
    acc = {idx: obj}
    mask = 1
    while mask < n and not (vr & mask):
        child = vr + mask
        if child < n:
            src = ranks[(child + root_idx) % n]
            acc.update(pickle.loads(ep.recv(src, tag, timeout=timeout).payload))
        mask <<= 1
    if vr != 0:
        parent = ranks[(vr - (vr & -vr) + root_idx) % n]
        ep.send(parent, pickle.dumps(acc), tag)
        return []
    return [acc[i] for i in range(n)]


# ---------------------------------------------------------------------------
# barrier
# ---------------------------------------------------------------------------

def barrier(ep: Endpoint, ranks: Sequence[int], gid: int = 0,
            timeout: float = 60.0, algo: Optional[str] = None) -> None:
    if _resolve(algo) == "linear":
        # reference arm: gather-to-root then bcast (two tag slots)
        root = min(ranks)
        gather(ep, ranks, root, None, gid, timeout, algo="linear")
        bcast(ep, ranks, root, None, gid, timeout, algo="linear")
        return
    tag = _next_tag(ep, gid)
    _barrier_binomial(ep, ranks, tag, timeout)


def _children(idx: int, n: int) -> List[int]:
    """Binomial-tree children of position idx (tree rooted at 0)."""
    out = []
    mask = 1
    while mask < n and not (idx & mask):
        if idx + mask < n:
            out.append(idx + mask)
        mask <<= 1
    return out


def _barrier_binomial(ep, ranks, tag, timeout):
    """Combining tree: arrival wave up to position 0, release wave down.
    Up and down messages travel opposite directions on one tag, so the
    per-(src, tag) streams never collide."""
    n = len(ranks)
    idx = ranks.index(ep.rank)
    kids = _children(idx, n)
    for c in kids:
        ep.recv(ranks[c], tag, timeout=timeout)   # child subtree arrived
    if idx:
        parent = ranks[idx - (idx & -idx)]
        ep.send(parent, b"", tag)
        ep.recv(parent, tag, timeout=timeout)     # wait for release
    for c in kids:
        ep.send(ranks[c], b"", tag)


# ---------------------------------------------------------------------------
# allreduce
# ---------------------------------------------------------------------------

def allreduce(ep: Endpoint, ranks: Sequence[int], obj: Any,
              op: Callable[[Any, Any], Any], gid: int = 0,
              timeout: float = 60.0, algo: Optional[str] = None) -> Any:
    if _resolve(algo) == "linear":
        root = min(ranks)
        vals = gather(ep, ranks, root, obj, gid, timeout, algo="linear")
        red = None
        if ep.rank == root:
            red = vals[0]
            for v in vals[1:]:
                red = op(red, v)
        return bcast(ep, ranks, root, red, gid, timeout, algo="linear")
    tag = _next_tag(ep, gid)
    return _allreduce_binomial(ep, ranks, obj, op, tag, timeout)


def _allreduce_binomial(ep, ranks, obj, op, tag, timeout):
    """Binomial reduce to position 0, then binomial bcast of the result.

    Children are folded in ascending position order and each child's
    subtree covers the positions contiguously following its parent's, so
    the fold is position-ascending end to end — identical to the linear
    arm's left fold for any associative op (the equivalence tests rely
    on this).  Reduce (up) and bcast (down) messages travel opposite
    directions, so one tag serves both phases.
    """
    n = len(ranks)
    idx = ranks.index(ep.rank)
    val = obj
    for c in _children(idx, n):
        cv = pickle.loads(ep.recv(ranks[c], tag, timeout=timeout).payload)
        val = op(val, cv)
    if idx:
        ep.send(ranks[idx - (idx & -idx)], pickle.dumps(val), tag)
    return _bcast_tree(ep, ranks, ranks[0], val, tag, timeout)


def allreduce_recursive_doubling(ep: Endpoint, ranks: Sequence[int],
                                 obj: Any, op: Callable[[Any, Any], Any],
                                 gid: int = 0, timeout: float = 60.0) -> Any:
    """Latency-optimal allreduce arm (see module docstring): ceil(log2 n)
    rounds of pairwise exchange, n*log(n) total messages.  Call-ordering
    semantics match the other arms (one tag slot per call)."""
    tag = _next_tag(ep, gid)
    return _allreduce_recursive_doubling(ep, ranks, obj, op, tag, timeout)


def _allreduce_recursive_doubling(ep, ranks, obj, op, tag, timeout):
    """Recursive doubling with the standard non-power-of-two fixup.

    Reduction order is rank-ascending (lower positions always the LEFT
    operand), so for associative ops the result is identical to the
    linear arm's left fold — the equivalence tests rely on this.
    """
    n = len(ranks)
    idx = ranks.index(ep.rank)
    pof2 = 1
    while pof2 * 2 <= n:
        pof2 *= 2
    rem = n - pof2
    val = obj
    if idx < 2 * rem:
        if idx % 2 == 0:
            # pre-phase: fold into the odd neighbour, sit out, get result
            ep.send(ranks[idx + 1], pickle.dumps(val), tag)
            return pickle.loads(
                ep.recv(ranks[idx + 1], tag, timeout=timeout).payload)
        peer = pickle.loads(ep.recv(ranks[idx - 1], tag, timeout=timeout).payload)
        val = op(peer, val)
        new_idx = idx // 2
    else:
        new_idx = idx - rem
    mask = 1
    while mask < pof2:
        pn = new_idx ^ mask
        partner = ranks[2 * pn + 1] if pn < rem else ranks[pn + rem]
        ep.send(partner, pickle.dumps(val), tag)
        pv = pickle.loads(ep.recv(partner, tag, timeout=timeout).payload)
        val = op(pv, val) if pn < new_idx else op(val, pv)
        mask <<= 1
    if idx < 2 * rem:  # idx is odd here: hand the result to the even peer
        ep.send(ranks[idx - 1], pickle.dumps(val), tag)
    return val


# ---------------------------------------------------------------------------
# alltoall
# ---------------------------------------------------------------------------

def alltoall(ep: Endpoint, ranks: Sequence[int], rows: List[Any],
             gid: int = 0, timeout: float = 60.0, algo: Optional[str] = None) -> List[Any]:
    """rows[i] goes to ranks[i]; returns the rows addressed to this rank.

    This is the §III-B drain exchange: O(1) traffic to the coordinator
    (none, in fact), all bookkeeping over the data plane.
    """
    algo = _resolve(algo)  # validate before consuming a tag slot
    if algo == "linear":
        return _alltoall_linear(ep, ranks, rows, _next_tag(ep, gid),
                                timeout)
    return _alltoall_transpose(ep, ranks, rows, gid, timeout)


def _alltoall_linear(ep, ranks, rows, tag, timeout):
    out: List[Any] = [None] * len(ranks)
    my_idx = list(ranks).index(ep.rank)
    for i, r in enumerate(ranks):
        if r != ep.rank:
            ep.send(r, pickle.dumps(rows[i]), tag)
    out[my_idx] = rows[my_idx]
    for i, r in enumerate(ranks):
        if r != ep.rank:
            out[i] = pickle.loads(ep.recv(r, tag, timeout=timeout).payload)
    return out


def _alltoall_transpose(ep, ranks, rows, gid, timeout):
    """Tree arm: binomial gather of every rank's row vector to the
    minimum rank, transpose at the root, direct column scatter back —
    2(n-1) messages total (two tag slots, like the linear barrier).

    The previous tree arm was the classic pairwise exchange (step s:
    send to idx+s, recv from idx-s) — bandwidth-optimal on a real
    network, but its n-1 SEQUENTIAL blocking rounds per rank are n^2
    total messages, which is exactly the wrong shape for the SIII-B
    drain's scalar counter exchange: at 512 GIL-bound inproc ranks the
    counter alltoall alone took minutes.  The transpose arm trades
    O(n) root-serial work (trivial for bookkeeping-sized rows) for a
    250x message-count reduction at n=512."""
    n = len(ranks)
    idx = ranks.index(ep.rank)
    if n == 1:
        _next_tag(ep, gid)  # keep the two-slot tag discipline uniform
        _next_tag(ep, gid)
        return [rows[idx]]
    root = min(ranks)
    matrix = gather(ep, ranks, root, list(rows), gid, timeout, algo="tree")
    tag = _next_tag(ep, gid)
    if ep.rank == root:
        root_idx = ranks.index(root)
        out = [matrix[i][root_idx] for i in range(n)]
        for i, r in enumerate(ranks):
            if r != root:
                ep.send(r, pickle.dumps([matrix[j][i] for j in range(n)]),
                        tag)
        return out
    return pickle.loads(ep.recv(root, tag, timeout=timeout).payload)
