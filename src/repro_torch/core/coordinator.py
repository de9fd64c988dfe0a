"""Centralized checkpoint coordinator (the DMTCP-coordinator analogue).

Per the paper's lessons, the coordinator is a *control-plane only*
component: it receives O(1)-sized state words per rank and issues
checkpoint commands; ALL data-plane bookkeeping (drain counters) travels
over the rank-to-rank fabric (§III-M).  Ranks poll `intent_epoch` with a
single unlocked integer read — the analogue of MANA-2.0 replacing
hot-path locks with cheap flags (§III-I).

This class is the STATE MACHINE only.  Direct method calls are the
in-process degenerate case (unit tests, workload benchmarks); real
worlds talk to it through the wire protocol in `repro_torch.core.control`
(CoordinatorServer wraps an instance behind a fabric endpoint, ranks
hold CoordinatorClient stubs), which is what makes the checkpoint
protocol transport-agnostic.

Phase-1 closure — the §III-J/§III-K problem.  Ranks reach their safe
points at *different* step boundaries, so a parked rank can leave a peer
blocked inside a collective it has not yet joined.  MANA-2.0 solves this
with comm-gid reports + "which ranks must continue to unblock later
collective calls".  Our adaptation (DESIGN.md §2): once a checkpoint is
pending, wrappers report per-communicator collective COUNTS (entered /
exited, keyed by the §III-K gid, computed locally).  The coordinator
closes phase 1 only when every live rank is parked AND, for every
communicator, all members' exited counts are equal — which implies no
rank is inside any collective.  A parked rank that lags a peer's entered
count is told to CONTINUE (it is the blocker); a watchdog withdraws all
parked ranks if closure stalls (e.g. a peer raced past the intent flag
into a collective and cannot report).  Progress is preserved: withdrawn
ranks keep training — a straggler delays the checkpoint, never the fleet
(§III-J).

Scalability (§III-I): phase-1 closure is EVENT-DRIVEN, not polled.  The
closure predicate can only flip at a park or a death, so it is evaluated
exactly there; the §III-K "continue" verdict for a lagging parked rank
is pushed by the peer's collective_enter report; and parked ranks sleep
on the condition variable until one of those events (or their watchdog
window) fires.  The earlier design had every parked rank rescan all
comm counts every 10ms under the one coordinator lock — O(ranks x
comms) scans per second that saturated the control plane long before
256 ranks.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple


class CheckpointAborted(RuntimeError):
    pass


class Coordinator:
    RUNNING = "running"
    IN_COLLECTIVE = "in_collective"
    PARKED = "parked"
    COMMITTED = "committed"
    DEAD = "dead"

    def __init__(self, n_ranks: int, unblock_window: float = 0.25):
        self.n = n_ranks
        self.unblock_window = unblock_window
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # hot-path flag: ranks read this without taking the lock
        self.intent_epoch = 0
        self.done_epoch = 0
        self.aborted_epochs: set = set()
        self.phase1_closed: set = set()
        # newest epoch whose phase 1 has closed: when one closure event
        # releases ranks parked under DIFFERENT epoch numbers (a second
        # request landed mid-phase-1), they all adopt this epoch for
        # phase 2 so commit/release bookkeeping stays aligned
        self.last_closed_epoch = 0
        self.rank_state: Dict[int, str] = {r: self.RUNNING
                                           for r in range(n_ranks)}
        self.in_gid: Dict[int, Optional[int]] = {r: None for r in range(n_ranks)}
        self.last_seen: Dict[int, float] = {r: time.monotonic()
                                            for r in range(n_ranks)}
        self.comm_members: Dict[int, Tuple[int, ...]] = {}
        # per-gid per-rank collective counts (reported only while pending)
        self.entered: Dict[int, Dict[int, int]] = {}
        self.exited: Dict[int, Dict[int, int]] = {}
        # event-driven park bookkeeping: the exited snapshot each parked
        # rank brought, the epoch it parked under, and verdicts pushed
        # to parked ranks by events
        self.parked_exited: Dict[int, Dict[int, int]] = {}
        self.parked_epoch: Dict[int, int] = {}
        self.park_verdict: Dict[int, str] = {}
        # last time ANY rank parked: the watchdog measures staleness
        # from the newest park event, not each rank's own park — while
        # parks keep arriving, phase 1 is making progress and nobody
        # withdraws (see try_park)
        self._last_park_t = 0.0
        self._commit_count = 0
        # async pipeline bookkeeping, PER EPOCH (the shared
        # _commit_count belongs to one sync commit round at a time, but
        # an async epoch can still be waiting on writer acks while the
        # next epoch's round begins): ranks that staged at the cut
        # (report_committed with an epoch) and ranks whose background
        # writer acked the image as durable — the commit completes only
        # when every live rank has done BOTH
        self.staged: Dict[int, set] = {}
        self.writer_acked: Dict[int, set] = {}
        self.failed_ranks: List[int] = []
        self.stats = {"checkpoints": 0, "aborts": 0, "control_messages": 0,
                      "continues_issued": 0, "watchdog_withdrawals": 0,
                      "rank_failures": 0}

    # ---- control plane -------------------------------------------------------
    def request_checkpoint(self) -> int:
        """Hybrid 2PC trigger: AFTER this, wrappers report collective
        counts and ranks park at step boundaries.  Before it, the data
        path runs with zero added synchronization."""
        with self._cv:
            self.intent_epoch += 1
            # NOTE: _commit_count is deliberately NOT reset here — a new
            # request may land while a previous epoch's phase 2 is still
            # committing, and zeroing the count would falsely abort it.
            # The count resets at phase-1 closure (_try_close), where a
            # new commit round actually begins (COMMITTED ranks block
            # closure, so no in-flight round can be clobbered).
            self._cv.notify_all()
            return self.intent_epoch

    def register_comm(self, gid: int, ranks: Tuple[int, ...]) -> None:
        with self._lock:
            self.comm_members[gid] = tuple(ranks)
            self.stats["control_messages"] += 1

    def collective_enter(self, rank: int, gid: int, entered_count: int) -> None:
        with self._cv:
            self.rank_state[rank] = self.IN_COLLECTIVE
            self.in_gid[rank] = gid
            self.entered.setdefault(gid, {})[rank] = entered_count
            self.last_seen[rank] = time.monotonic()
            self.stats["control_messages"] += 1
            # §III-K unblock, pushed at the event: any parked member of
            # this comm lagging the new entered count is the blocker
            woke = False
            for r, mine in self.parked_exited.items():
                if (r != rank and self.rank_state.get(r) == self.PARKED
                        and gid in mine and entered_count > mine[gid]):
                    self.rank_state[r] = self.RUNNING
                    self.park_verdict[r] = "continue"
                    self.stats["continues_issued"] += 1
                    woke = True
            if woke:
                self._cv.notify_all()

    def collective_exit(self, rank: int, gid: int, exited_count: int) -> None:
        with self._cv:
            self.rank_state[rank] = self.RUNNING
            self.in_gid[rank] = None
            self.exited.setdefault(gid, {})[rank] = exited_count
            self.last_seen[rank] = time.monotonic()
            self.stats["control_messages"] += 1
            # closure cannot flip here: this rank is not parked, so the
            # all-parked predicate is false — no wakeup needed

    def mark_dead(self, rank: int) -> None:
        """VOLUNTARY departure (a rank leaving the job): death is a
        phase-1 closure event — the checkpoint proceeds with the
        survivors (§III-J)."""
        with self._cv:
            self.rank_state[rank] = self.DEAD
            if self.intent_epoch > self.done_epoch:
                self._try_close(self.intent_epoch)
            # a departure shrinks the live set, so an async commit
            # round that was only waiting on THIS rank's stage/ack can
            # complete now — writer_ack is the only other finalize
            # site, and the departed rank's ack will never come
            for e in sorted(set(self.staged) | set(self.writer_acked)):
                if e > self.done_epoch and e not in self.aborted_epochs:
                    self._try_finalize(e)
            self._cv.notify_all()

    def fail_rank(self, rank: int) -> bool:
        """A rank CRASHED (endpoint EOF without a goodbye, or missed
        heartbeats).  Unlike `mark_dead`, a crash invalidates every
        in-flight checkpoint epoch: the dead rank's in-network bytes
        can never be drained and its snapshot can never be shipped, so
        no cut that includes it can commit.  Every epoch newer than the
        last completed one is aborted, which withdraws all parked ranks
        ("abort" verdict) and unblocks phase-2 waiters — the supervisor
        then tears the world down and restarts from the last COMMITTED
        image.  Returns False if the rank was already dead."""
        with self._cv:
            if self.rank_state.get(rank) == self.DEAD:
                return False
            self.rank_state[rank] = self.DEAD
            self.failed_ranks.append(rank)
            self.stats["rank_failures"] += 1
            for e in range(self.done_epoch + 1, self.intent_epoch + 1):
                if e not in self.aborted_epochs:
                    self.aborted_epochs.add(e)
                    self.stats["aborts"] += 1
            self._cv.notify_all()
            return True

    def _live(self) -> List[int]:
        return [r for r, s in self.rank_state.items() if s != self.DEAD]

    # ---- phase 1: park / continue / close --------------------------------------
    def _counts_consistent(self) -> bool:
        """No rank inside a collective: per gid, every member that has
        ever entered has also exited the same count."""
        for gid, ent in self.entered.items():
            ex = self.exited.get(gid, {})
            for r, n_in in ent.items():
                if self.rank_state[r] == self.DEAD:
                    continue
                if ex.get(r, 0) < n_in:
                    return False
        return True

    def _lagging(self, rank: int, my_exited: Dict[int, int]) -> bool:
        """True if some member of a comm containing `rank` has entered
        more collectives on it than `rank` has exited — `rank` is the
        blocker and must continue (§III-K 'unblock')."""
        for gid, mine in my_exited.items():
            peers = self.entered.get(gid, {})
            for r, cnt in peers.items():
                if r != rank and cnt > mine:
                    return True
        return False

    def _n_parked(self) -> int:
        return sum(1 for r in self._live()
                   if self.rank_state[r] == self.PARKED)

    def _try_close(self, epoch: int) -> bool:
        """Evaluate the phase-1 closure predicate.  Called ONLY at the
        events that can flip it (a park, a death) — never polled.

        Closes EVERY epoch some rank is parked under, not just the
        caller's: when a new checkpoint request lands mid-phase-1, early
        parkers hold the older epoch number, and the cut (all ranks at
        safe points, counts consistent) is equally valid for both —
        releasing only the newest would strand the early parkers."""
        live = self._live()
        # `live` must be non-empty: with every rank dead the all()
        # predicate would be vacuously true and close a zero-participant
        # checkpoint
        if (live and epoch not in self.aborted_epochs
                and all(self.rank_state[r] == self.PARKED for r in live)
                and self._counts_consistent()):
            closed = {epoch} | {e for e in self.parked_epoch.values()
                                if e not in self.aborted_epochs}
            self.phase1_closed.update(closed)
            self.last_closed_epoch = max(self.last_closed_epoch,
                                         max(closed))
            self._commit_count = 0  # the commit round for this cut begins
            self._cv.notify_all()
            return True
        return False

    def try_park(self, rank: int, epoch: int, my_exited: Dict[int, int],
                 timeout: float = 60.0) -> str:
        """Rank-side phase 1.  Returns "safe" | "continue" | "abort"."""
        deadline = time.monotonic() + timeout
        with self._cv:
            self.stats["control_messages"] += 1
            if self._lagging(rank, my_exited):
                self.stats["continues_issued"] += 1
                return "continue"
            self.rank_state[rank] = self.PARKED
            self.parked_exited[rank] = dict(my_exited)
            self.parked_epoch[rank] = epoch
            self.park_verdict.pop(rank, None)
            for gid, cnt in my_exited.items():
                self.exited.setdefault(gid, {})[rank] = cnt
                self.entered.setdefault(gid, {}).setdefault(rank, cnt)
            self.last_seen[rank] = time.monotonic()
            park_t = time.monotonic()
            self._last_park_t = park_t
            try:
                self._try_close(epoch)
                while True:
                    if epoch in self.aborted_epochs:
                        self.rank_state[rank] = self.RUNNING
                        return "abort"
                    if epoch in self.phase1_closed:
                        return "safe"
                    if self.park_verdict.get(rank) == "continue":
                        # §III-K unblock pushed by a peer's enter report
                        # (state was already set back to RUNNING there)
                        return "continue"
                    now = time.monotonic()
                    missing = len(self._live()) - self._n_parked()
                    # the watchdog window measures staleness of the
                    # NEWEST park event, not this rank's own: while
                    # parks keep arriving phase 1 is converging, and
                    # withdrawing early parkers at scale (hundreds of
                    # GIL-bound ranks park over seconds) just forces a
                    # re-park storm that can livelock closure.  Only
                    # when no one has parked for a full window AND
                    # ranks are missing is someone truly stuck (raced
                    # past the intent flag) — withdraw and retry.
                    ref_t = max(park_t, self._last_park_t)
                    if now - ref_t > self.unblock_window and missing:
                        self.rank_state[rank] = self.RUNNING
                        self.stats["watchdog_withdrawals"] += 1
                        return "continue"
                    if now > deadline:
                        self.aborted_epochs.add(epoch)
                        self.stats["aborts"] += 1
                        # un-park before raising, or this rank stays
                        # PARKED in coordinator state forever and a later
                        # epoch could close on an invalid cut
                        self.rank_state[rank] = self.RUNNING
                        self._cv.notify_all()
                        raise CheckpointAborted(
                            f"phase-1 timeout; stragglers: "
                            f"{self.straggler_report()}")
                    # sleep until an event; wake early only for the
                    # watchdog window or the deadline
                    wait_t = min(0.2, deadline - now)
                    if missing:
                        wait_t = min(wait_t, max(
                            0.001, self.unblock_window - (now - ref_t)))
                    self._cv.wait(wait_t)
            finally:
                self.parked_exited.pop(rank, None)
                self.parked_epoch.pop(rank, None)
                self.park_verdict.pop(rank, None)

    # ---- phase 2: commit -------------------------------------------------------
    def report_committed(self, rank: int, epoch: Optional[int] = None) -> None:
        """Phase-2 report.  Sync mode: the snapshot is fully written
        (no epoch needed — one commit round is in flight at a time).
        Async mode: the snapshot is STAGED at the cut for `epoch`;
        durability arrives later via `writer_ack`, and both are tracked
        per epoch because a staged epoch can still be in flight when
        the next round begins."""
        with self._cv:
            self.rank_state[rank] = self.COMMITTED
            self._commit_count += 1
            self.stats["control_messages"] += 1
            if epoch is not None:
                self.staged.setdefault(epoch, set()).add(rank)
            # notify only when the round can actually complete: a
            # per-report notify_all wakes every phase-2 waiter (n
            # wait_released workers) n times — a quadratic wakeup storm
            # under the one coordinator lock that dominated the SYNC
            # commit round at 512 ranks.  wait_all_committed's 0.2s
            # poll cap covers the no-notify window; deaths/aborts
            # notify on their own paths.
            if self._commit_count >= len(self._live()):
                self._cv.notify_all()

    def wait_all_committed(self, epoch: int, timeout: float = 120.0) -> None:
        deadline = time.monotonic() + timeout
        with self._cv:
            while True:
                if epoch in self.aborted_epochs:
                    # a rank crashed mid-commit (fail_rank): the cut is
                    # invalid even when the SHRUNKEN live set satisfies
                    # the count — checked before the count, or a crash
                    # of the one unreported rank would falsely commit
                    raise CheckpointAborted(
                        f"epoch {epoch} aborted by rank failure "
                        f"{self.failed_ranks}")
                if self._commit_count >= len(self._live()):
                    break
                if time.monotonic() > deadline:
                    self.aborted_epochs.add(epoch)
                    self.stats["aborts"] += 1
                    self._cv.notify_all()
                    raise CheckpointAborted("phase-2 timeout")
                self._cv.wait(0.2)  # event-driven: report_committed notifies
            self.done_epoch = epoch
            self.stats["checkpoints"] += 1
            for r in self._live():
                self.rank_state[r] = self.RUNNING
            self._cv.notify_all()

    def writer_ack(self, rank: int, epoch: int, ok: bool = True,
                   err: Optional[str] = None) -> None:
        """Async phase 2 (the 2PC split): `rank`'s BACKGROUND writer
        reports that the epoch's snapshot blob is durably at the
        launcher (ok=True) or that producing it failed (ok=False).

        In the async pipeline ranks resume compute right after staging
        (their `report_committed` means "staged at the cut", not
        "written"), so the commit round completes HERE — gating
        `done_epoch` on every live rank's writer ack preserves the
        committed-image invariant: an epoch the supervisor may restart
        from has every rank's blob at the launcher.  A failed writer
        aborts the epoch (the image can never be complete), exactly
        like a phase-2 timeout would.
        """
        with self._cv:
            self.stats["control_messages"] += 1
            if epoch <= self.done_epoch or epoch in self.aborted_epochs:
                return
            if not ok:
                self.aborted_epochs.add(epoch)
                self.stats["aborts"] += 1
                # un-wedge the world: staged ranks are compute-running
                # already but still COMMITTED here, which would block
                # the next phase-1 closure forever
                for r in self._live():
                    if self.rank_state[r] == self.COMMITTED:
                        self.rank_state[r] = self.RUNNING
                self._cv.notify_all()
                return
            self.writer_acked.setdefault(epoch, set()).add(rank)
            self._try_finalize(epoch)

    def _try_finalize(self, epoch: int) -> None:
        """Complete an async commit round: every live rank staged at the
        cut AND every live rank's writer acked durability.  Caller holds
        the lock."""
        live = self._live()
        staged = self.staged.get(epoch, set())
        acked = self.writer_acked.get(epoch, set())
        if (live and epoch in self.phase1_closed
                and all(r in staged for r in live)
                and all(r in acked for r in live)):
            self.done_epoch = max(self.done_epoch, epoch)
            self.stats["checkpoints"] += 1
            for r in live:
                if self.rank_state[r] == self.COMMITTED:
                    self.rank_state[r] = self.RUNNING
            for e in [e for e in self.writer_acked if e <= epoch]:
                del self.writer_acked[e]
            for e in [e for e in self.staged if e <= epoch]:
                del self.staged[e]
            self._cv.notify_all()

    def wait_released(self, epoch: int, timeout: float = 120.0) -> bool:
        deadline = time.monotonic() + timeout
        with self._cv:
            while self.done_epoch < epoch:
                if epoch in self.aborted_epochs:
                    return False
                if time.monotonic() > deadline:
                    raise CheckpointAborted("release timeout")
                self._cv.wait(0.2)  # event-driven: release notifies
            return True

    # ---- straggler introspection (§III-J) --------------------------------------
    def straggler_report(self, threshold: float = 0.5) -> Dict[int, Dict]:
        now = time.monotonic()
        out = {}
        with self._lock:
            for r, state in self.rank_state.items():
                if state in (self.PARKED, self.COMMITTED, self.DEAD):
                    continue
                age = now - self.last_seen[r]
                entry: Dict = {"state": state, "age_s": round(age, 3)}
                gid = self.in_gid.get(r)
                if gid is not None:
                    entry["collective_gid"] = gid
                    entry["collective_members"] = self.comm_members.get(gid)
                if age >= threshold or state == self.IN_COLLECTIVE:
                    out[r] = entry
        return out
