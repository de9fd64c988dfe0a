"""Hybrid two-phase-commit checkpoint protocol — rank-side agent
(paper §III-D/E/J/L).

Three selectable algorithms, matching the paper's evaluation arms:

  "mana1"  — original MANA: a barrier is inserted before EVERY collective
             (§III-D).  Reproduces both the 2–3x collective slowdown
             (benchmarks/two_phase_commit_bench.py) and the §III-E
             deadlock (tests exercise the Bcast-root scenario).
  "nobarrier" — the intermediate revision that assumed no stragglers
             (§III-J "modified algorithm ... found to have some flaws"):
             ranks park unconditionally, with no collective-count
             handshake — a peer blocked inside a collective aborts the
             checkpoint (the flaw, demonstrated in tests).
  "hybrid" — MANA-2.0 (as adapted, DESIGN.md §2): steady-state
             collectives run natively with zero added synchronization
             and zero coordinator traffic.  Once a checkpoint is
             pending, wrappers additionally report per-comm collective
             counts (keyed by the locally-computed §III-K gid) and ranks
             park at step boundaries under the coordinator's
             count-equalization rule; parked blockers are told to
             CONTINUE (§III-K "unblock").  Collectives stay
             wire-uniform, so the §III-E mixed-semantics deadlock cannot
             occur by construction; the drain (§III-B) covers app p2p
             traffic, and count-equalization guarantees no collective
             payload is in flight at the cut.
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Any, Callable, Dict, Optional, Sequence

from repro_torch.comm import collectives as coll
from repro_torch.comm.fabric import Endpoint
from repro_torch.core.coordinator import CheckpointAborted, Coordinator
from repro_torch.core.drain import drain_rank
from repro_torch.core.virtual import VirtualCommTable, VirtualRequestTable, comm_gid


class RankAgent:
    """Per-rank MANA-2.0 agent: interposition wrappers + 2PC state machine."""

    def __init__(self, rank: int, ep: Endpoint, coordinator: Coordinator,
                 world: Sequence[int], mode: str = "hybrid",
                 coll_algo: Optional[str] = None,
                 transport: str = "inproc", async_commit: bool = False,
                 writer=None):
        assert mode in ("mana1", "nobarrier", "hybrid")
        self.rank = rank
        self.ep = ep
        # a shared-memory `Coordinator` (the in-process degenerate case)
        # or a `repro_torch.core.control.CoordinatorClient` stub speaking the
        # wire protocol — the agent cannot tell them apart
        self.coord = coordinator
        self.mode = mode
        # which fabric backend this agent runs over; recorded in every
        # checkpoint image so a restore can prove it crossed transports
        self.transport = transport
        # collective algorithm ("tree" | "linear"; None = module default)
        # — must agree across all ranks of a job
        self.coll_algo = coll_algo
        # asynchronous 2PC split: stage the snapshot at the cut, resume
        # compute immediately, and let a background writer
        # (repro_torch.core.snapshot_writer) do serialization + upload; the
        # coordinator's commit is gated on the writer's ack
        self.async_commit = async_commit
        self._writer = writer
        self.done_epoch = 0
        self.ckpt_epoch = 0  # adopted epoch of the snapshot in progress
        # post-closure compute stall of the LAST checkpoint taken at
        # this rank: seconds from the "safe" park verdict (the drain
        # barrier) back to compute — drain + snapshot/stage + (sync:
        # ship + commit round trips | async: writer submit).  This is
        # the §III quantity the async split shrinks, and what the
        # ckpt_stall benchmark records; park/alignment time is excluded
        # (workload skew, not protocol cost).
        self.last_commit_stall_s = 0.0
        # upper-half tables (serialized into every checkpoint)
        self.comms = VirtualCommTable()
        self.requests = VirtualRequestTable()
        self.world_comm = self.comms.create(tuple(world), real=ep)
        self.coord.register_comm(comm_gid(tuple(world)), tuple(world))
        # per-gid collective counters (exited); upper-half state
        self.coll_counts: Dict[int, int] = defaultdict(int)
        # DMTCP_PLUGIN_DISABLE_CKPT analogue: cheap depth counter, no lock
        self.in_lower_half = 0
        self.stats = {"collectives": 0, "barriers_inserted": 0,
                      "coordinator_reports": 0, "continues": 0,
                      "async_stages": 0}

    # ---- interposition helpers ------------------------------------------------
    def _ckpt_pending(self) -> bool:
        # single int compare — the §III-I hot-path lesson
        return self.coord.intent_epoch > self.done_epoch

    def comm_ranks(self, vcomm: int):
        return self.comms.get(vcomm).world_ranks

    def create_comm(self, world_ranks) -> int:
        vcomm = self.comms.create(tuple(world_ranks), real=self.ep)
        self.coord.register_comm(comm_gid(tuple(world_ranks)),
                                 tuple(world_ranks))
        return vcomm

    # ---- wrapped p2p ------------------------------------------------------------
    def send(self, dst: int, payload: bytes, tag: int = 0) -> None:
        self.in_lower_half += 1
        try:
            self.ep.send(dst, payload, tag)
        finally:
            self.in_lower_half -= 1

    def recv(self, src: int, tag: Optional[int] = None,
             timeout: Optional[float] = None):
        self.in_lower_half += 1
        try:
            return self.ep.recv(src, tag, timeout=timeout)
        finally:
            self.in_lower_half -= 1

    def irecv(self, src: int, tag: Optional[int] = None) -> int:
        req = self.ep.irecv(src, tag)
        return self.requests.create(req, kind="p2p", src=src, tag=tag)

    def test(self, vreq: int) -> bool:
        return self.requests.test(vreq, lambda r: r.try_complete())

    def wait(self, vreq: int) -> None:
        self.requests.wait(vreq, lambda r: r.try_complete(),
                           spin=lambda: time.sleep(0.0005))

    # ---- wrapped collectives ------------------------------------------------------
    def collective(self, vcomm: int, fn: Callable[..., Any], *args, **kw) -> Any:
        """Run collective `fn(ep, ranks, *args, gid=..., **kw)` under the
        selected 2PC algorithm.  The implementation is ALWAYS the native
        one (wire-uniform); algorithms differ only in synchronization and
        reporting."""
        ranks = self.comm_ranks(vcomm)
        gid = comm_gid(ranks)
        self.stats["collectives"] += 1
        pending = self._ckpt_pending()

        if self.mode == "mana1":
            # original MANA: unconditional barrier before the collective
            self.stats["barriers_inserted"] += 1
            coll.barrier(self.ep, ranks, gid=gid, algo=self.coll_algo)
        report = pending and self.mode == "hybrid"
        self.in_lower_half += 1
        try:
            if report:
                self.stats["coordinator_reports"] += 1
                self.coord.collective_enter(self.rank, gid,
                                            self.coll_counts[gid] + 1)
            out = fn(self.ep, ranks, *args, gid=gid, algo=self.coll_algo, **kw)
            self.coll_counts[gid] += 1
            if report:
                self.coord.collective_exit(self.rank, gid,
                                           self.coll_counts[gid])
        finally:
            self.in_lower_half -= 1
        return out

    def bcast(self, vcomm: int, root: int, obj: Any) -> Any:
        return self.collective(vcomm, coll.bcast, root, obj)

    def allreduce(self, vcomm: int, obj: Any, op) -> Any:
        return self.collective(vcomm, coll.allreduce, obj, op)

    def barrier_op(self, vcomm: int) -> None:
        return self.collective(vcomm, coll.barrier)

    def alltoall(self, vcomm: int, rows) -> Any:
        return self.collective(vcomm, coll.alltoall, rows)

    # ---- the async 2PC split (background writer plumbing) ---------------------------
    def _ensure_writer(self):
        if self._writer is None:
            from repro_torch.core.snapshot_writer import make_snapshot_writer
            self._writer = make_snapshot_writer(self.transport)
        return self._writer

    def _writer_done(self, epoch: int, ok: bool, payload) -> None:
        """Runs on the background writer's collector thread once the
        staged snapshot has been produced: ship the blob to the
        launcher-side image collector, then ack (snap before ack on the
        same endpoint = FIFO guarantees the server holds the blob
        before the ack gates the commit).  A produce failure becomes a
        NACK, which aborts the epoch instead of wedging the world."""
        if ok and payload is not None and hasattr(self.coord,
                                                  "ship_snapshot"):
            try:
                self.coord.ship_snapshot(epoch, payload)
            except Exception:  # noqa: BLE001 — upload failed: NACK
                ok, payload = False, "snap upload failed"
        self.coord.writer_ack(self.rank, epoch, ok=ok,
                              err=None if ok else str(payload))

    def drain_writer(self, timeout: float = 30.0) -> None:
        """Block until every in-flight background snapshot has shipped
        and acked.  Called by the harness before the clean-exit goodbye
        — a rank must not disappear while its writer still owes the
        coordinator an ack."""
        if self._writer is not None:
            self._writer.close(timeout)

    # ---- the safe point (step boundary) ---------------------------------------------
    def safe_point(self, snapshot: Callable[[], None],
                   timeout: float = 60.0) -> bool:
        """Call at every step boundary.  Fast path: one int compare.

        Under a pending checkpoint: park under the coordinator's
        count-equalization rule (phase 1); once closed, drain p2p
        (§III-B), snapshot, and commit (phase 2).  Returns True iff a
        checkpoint was taken at THIS boundary.

        Synchronous mode (default): `snapshot()` does all its work at
        the cut, and the rank waits out the commit/release round trips
        — the paper-faithful baseline.

        Async mode (`async_commit=True`): `snapshot()` only STAGES —
        capture the cut's values cheaply and return either None
        (nothing to upload / already handled) or a zero-arg callable
        that produces the blob to ship (a binary snapshot container or
        a JSON-safe dict).  The rank resumes
        compute immediately; serialization, delta-encoding and the
        `snap` upload run on the background writer, and the
        coordinator finalizes the epoch only after every rank's writer
        ack (`Coordinator.writer_ack`).
        """
        if not self._ckpt_pending():
            return False
        epoch = self.coord.intent_epoch
        assert self.in_lower_half == 0, "safe point inside lower half"
        if self.mode == "nobarrier":
            # flawed revision: park unconditionally, no count handshake
            verdict = self.coord.try_park(self.rank, epoch, {},
                                          timeout=timeout)
        else:
            verdict = self.coord.try_park(self.rank, epoch,
                                          dict(self.coll_counts),
                                          timeout=timeout)
        if verdict == "continue":
            self.stats["continues"] += 1
            return False
        if verdict == "abort":
            self.done_epoch = epoch
            return False
        # phase 1 closed: every rank parked, no collective in flight.
        # Adopt the newest closed epoch: if a second request landed
        # mid-phase-1, ranks parked under different epoch numbers all
        # completed the SAME physical cut, and phase 2 must agree on one
        # epoch or commit/release bookkeeping misaligns
        stall_t0 = time.monotonic()
        epoch = max(epoch, self.coord.last_closed_epoch)
        world = self.comm_ranks(self.world_comm)
        drain_rank(self.ep, world, gid=comm_gid(world), timeout=timeout,
                   algo=self.coll_algo)
        ok = False
        # the adopted epoch this snapshot belongs to — snapshot
        # callbacks that ship their blob to the launcher-side image
        # collector (CoordinatorClient.ship_snapshot) read it here
        self.ckpt_epoch = epoch
        if self.async_commit:
            # the 2PC split: stage at the cut, hand the expensive tail
            # to the background writer, resume compute NOW.  `committed`
            # here means "staged"; the epoch finalizes at writer-ack.
            staged = snapshot()
            self.coord.report_committed(self.rank, epoch)
            self.stats["async_stages"] += 1
            produce = staged if callable(staged) else (lambda: None)
            self._ensure_writer().submit(
                epoch, produce,
                lambda e, okk, payload: self._writer_done(e, okk, payload))
            self.done_epoch = epoch
            self.last_commit_stall_s = time.monotonic() - stall_t0
            return True
        try:
            snapshot()
            self.coord.report_committed(self.rank)
            if self.rank == min(world):
                self.coord.wait_all_committed(epoch, timeout=timeout)
            ok = self.coord.wait_released(epoch, timeout=timeout)
        except CheckpointAborted:
            ok = False
        self.done_epoch = epoch
        self.last_commit_stall_s = time.monotonic() - stall_t0
        return ok

    # ---- serialization (upper half) -----------------------------------------------
    def serialize(self) -> Dict:
        return {"rank": self.rank,
                "transport": self.transport,
                "comms": self.comms.serialize(),
                "requests": self.requests.serialize(),
                "coll_counts": dict(self.coll_counts),
                "drain_buffer": [(m.src, m.dst, m.tag, m.payload.hex())
                                 for m in self.ep.drain_buffer]}
