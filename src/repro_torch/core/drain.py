"""Point-to-point message drain at checkpoint time (paper §III-B).

MANA-2.0's algorithm, reproduced step for step:

  1. Each rank keeps per-peer byte counters (sent[j], recvd[j]) updated by
     the send/recv wrappers at runtime (fabric.Endpoint does this).
  2. At checkpoint, one MPI_Alltoall of the `sent` vectors tells every
     rank — locally, with no further communication and no coordinator
     round-trips — how many bytes it was expected to receive from each
     peer (expected[s] = sent_s[this_rank]).
  3. Each rank drains its own deficit: while recvd[s] < expected[s],
     use Iprobe+Recv to pull messages out of the network into the drain
     buffer.
  4. The Iprobe-miss case: if the deficit persists but Iprobe sees
     nothing, a posted Irecv has already claimed the message; MPI_Test
     the existing Irecv records to complete them (§III-B, last para).

Contrast with MANA-1 (implemented in `centralized_drain` below for the
benchmark): per-rank TOTALS are shipped to the coordinator every round,
which is both O(ranks) coordinator traffic per round and unable to say
*which* pair is missing bytes — the paper's two stated drawbacks.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

from repro_torch.comm import collectives as coll
from repro_torch.comm.fabric import Endpoint


class DrainError(RuntimeError):
    pass


def drain_rank(ep: Endpoint, ranks: Sequence[int], gid: int = 0,
               timeout: float = 30.0, algo: Optional[str] = None) -> Dict:
    """Run the §III-B drain for one rank (call concurrently on all ranks).

    `algo` selects the collective algorithm for the bookkeeping alltoall
    (all ranks must agree).  Returns drain stats for EXPERIMENTS.md
    §Protocol.
    """
    # step 2: one alltoall — rank r sends peer s the scalar sent[r->s];
    # afterwards expected[s] = bytes peer s claims to have sent here.
    rows = [ep.sent_bytes[dst] for dst in ranks]
    got = coll.alltoall(ep, ranks, rows, gid=gid, algo=algo)
    expected = {s: got[i] for i, s in enumerate(ranks)}

    drained = 0
    deadline = time.monotonic() + timeout
    while True:
        deficit = [s for s in ranks
                   if s != ep.rank and ep.recvd_bytes[s] < expected[s]]
        if not deficit:
            break
        progressed = False
        for s in deficit:
            # step 3: probe the network
            while ep.iprobe(s) and ep.recvd_bytes[s] < expected[s]:
                if ep.drain_one(s) is not None:
                    drained += 1
                    progressed = True
            # step 4: Iprobe-miss — test existing Irecv records
            if ep.recvd_bytes[s] < expected[s]:
                for req in ep.pending_irecvs:
                    if req.src == s and req.try_complete():
                        progressed = True
        if not progressed:
            if getattr(ep, "poisoned", None):
                # world torn down under us (a peer failed): unwind now
                # instead of spinning out the drain deadline
                from repro_torch.comm.transport.base import TransportClosed
                raise TransportClosed(f"rank {ep.rank}: {ep.poisoned}")
            if time.monotonic() > deadline:
                raise DrainError(
                    f"rank {ep.rank}: undrainable deficit "
                    f"{[(s, expected[s] - ep.recvd_bytes[s]) for s in deficit]}")
            time.sleep(0.001)
    return {"drained_messages": drained,
            "buffered_bytes": sum(m.nbytes for m in ep.drain_buffer),
            "pending_irecvs": len(ep.pending_irecvs)}


def centralized_drain(endpoints: List[Endpoint], max_rounds: int = 10_000):
    """MANA-1 baseline (§III-B 'previous work'): coordinator-mediated
    TOTALS-only bookkeeping.  Used by benchmarks/drain_scaling.py to
    reproduce the paper's motivation numbers.  Runs sequentially over all
    ranks to model the coordinator round-trips; returns the number of
    coordinator messages exchanged.
    """
    coord_msgs = 0
    for _ in range(max_rounds):
        # every rank ships its totals to the coordinator...
        total_sent = sum(sum(ep.sent_bytes) for ep in endpoints)
        total_recvd = sum(sum(ep.recvd_bytes) for ep in endpoints)
        coord_msgs += 2 * len(endpoints)  # N reports + N replies
        if total_sent == total_recvd:
            return coord_msgs
        # ...and probes the network for anything missing
        for ep in endpoints:
            for s in range(ep.fabric.n_ranks):
                while ep.iprobe(s):
                    ep.drain_one(s)
            for req in ep.pending_irecvs:
                req.try_complete()
    raise DrainError("centralized drain did not converge")
