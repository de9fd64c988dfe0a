"""Message-based checkpoint control plane: the coordinator as an
ENDPOINT, not a shared object.

Pre-transport, ranks called `Coordinator` methods directly — which only
works because every rank is a thread in one process.  This module turns
the coordinator<->rank interaction into a wire protocol on reserved
control tags (`repro_torch.comm.transport.base`: TAG_CTRL / TAG_INTENT, below
the collective tag space), so drain, the hybrid 2PC and §III-J/K
phase-1 closure run unchanged over ANY transport backend — threads,
processes over TCP, or anything a future backend brings.

  CoordinatorServer — owns the `Coordinator` state machine (unchanged:
      same closure predicate, watchdog, epoch-adoption semantics) and
      services requests arriving on its endpoint.  Blocking operations
      (park, commit-wait, release-wait) are handed to per-request
      worker threads so the serve loop never stalls — the coordinator
      stays a CONTROL-plane-only component with O(1)-sized messages
      (§III-M), and every state transition still happens under the one
      coordinator lock.
  CoordinatorClient — the rank-side stub.  Presents the exact
      `Coordinator` surface `RankAgent` consumes (`intent_epoch`,
      `register_comm`, `collective_enter/exit`, `try_park`,
      `report_committed`, `wait_all_committed`, `wait_released`,
      `last_closed_epoch`, `mark_dead`, `straggler_report`), so the
      agent cannot tell a wire coordinator from a shared-memory one.

Wire protocol (pickled dicts):
  rank -> coord on TAG_CTRL:   {"op": ..., ...}
  coord -> rank on TAG_CTRL:   one reply per BLOCKING op ({"error":
      "aborted", ...} re-raises `CheckpointAborted` client-side);
      fire-and-forget ops (register_comm, enter, exit, committed,
      mark_dead, hb, bye, snap) get no reply — per-(src, tag) FIFO
      order guarantees the server observes them before any later
      blocking op from the same rank.
  coord -> rank on TAG_INTENT: {"epoch": e} pushes.  The client caches
      the newest epoch and `intent_epoch` drains pending pushes with a
      nonblocking claim — the wire analogue of the §III-I lock-free
      intent flag (a single store lookup on the hot path, no round
      trip).

Failure detection and recovery (see README "Fault model"):
  * "hb"   — liveness heartbeat; with a heartbeat timeout configured,
      a rank that goes silent is declared failed (hung-but-connected).
  * "bye"  — clean-exit goodbye.  The socket switch synthesizes an
      "eof" op when a rank's connection closes, ordered AFTER the
      rank's final traffic: EOF-without-bye is a crash (FIN vs RST).
  * "snap" — a rank's checkpoint snapshot, shipped at commit time to
      the LAUNCHER-side image collector (a crashed rank's memory is
      gone); an epoch with all snapshots and a completed commit round
      is the committed image `run_world_supervised` restarts from.
  Either detection path calls `Coordinator.fail_rank`: abort every
  in-flight epoch, withdraw parked ranks, wake `failure_event` so the
  harness raises a typed `RankFailure` instead of hanging.
"""
from __future__ import annotations

import pickle
import threading
import time
import traceback
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.comm.transport.base import TAG_CTRL, TAG_INTENT, Endpoint
from repro_torch.core.codec import WorldMismatchError, blob_base_epoch
from repro_torch.core.coordinator import CheckpointAborted, Coordinator

# ---------------------------------------------------------------------------
# the op registry — the normative table of the coordinator wire protocol.
# docs/PROTOCOL.md renders this table and a drift-guard test
# (tests/test_docs.py) diffs the doc against THIS dict, so adding an op
# without documenting it fails CI.  "blocking" ops get exactly one reply
# frame; fire-and-forget ops rely on per-(src, tag) FIFO ordering.
# ---------------------------------------------------------------------------
CTRL_OPS: Dict[str, Dict[str, object]] = {
    "request_ckpt": dict(
        dir="rank->coord", blocking=True,
        doc="bump the checkpoint epoch; intent is pushed to every rank"),
    "register_comm": dict(
        dir="rank->coord", blocking=False,
        doc="announce a communicator (gid, member ranks) for SIII-K "
            "count-equalization"),
    "enter": dict(
        dir="rank->coord", blocking=False,
        doc="collective-enter count report (only while a checkpoint is "
            "pending)"),
    "exit": dict(
        dir="rank->coord", blocking=False,
        doc="collective-exit count report (only while a checkpoint is "
            "pending)"),
    "park": dict(
        dir="rank->coord", blocking=True,
        doc="phase-1 park at a safe point; reply carries the verdict "
            "(safe/continue/abort) + newest closed epoch"),
    "committed": dict(
        dir="rank->coord", blocking=False,
        doc="phase-2 report: snapshot staged at the cut (sync mode: "
            "snapshot fully written)"),
    "writer_ack": dict(
        dir="rank->coord", blocking=False,
        doc="async pipeline: the rank's BACKGROUND writer confirms its "
            "snapshot blob is durably at the launcher (ok=False aborts "
            "the epoch); the commit round completes only when every "
            "live rank has acked"),
    "wait_all_committed": dict(
        dir="rank->coord", blocking=True,
        doc="sync mode: block until every live rank reported committed "
            "(completes the epoch)"),
    "wait_released": dict(
        dir="rank->coord", blocking=True,
        doc="block until the epoch's commit round completes; reply "
            "says whether it committed"),
    "straggler_report": dict(
        dir="rank->coord", blocking=True,
        doc="SIII-J introspection: ranks not yet at a safe point"),
    "mark_dead": dict(
        dir="rank->coord", blocking=False,
        doc="voluntary departure; a phase-1 closure event (SIII-J)"),
    "hb": dict(
        dir="rank->coord", blocking=False,
        doc="liveness heartbeat; silence beyond the timeout declares "
            "the rank failed"),
    "bye": dict(
        dir="rank->coord", blocking=False,
        doc="clean-exit goodbye: the upcoming EOF is a departure, not "
            "a crash"),
    "snap": dict(
        dir="rank->coord", blocking=False,
        doc="checkpoint snapshot blob for the launcher-side image "
            "collector (delta blobs carry ckpt_base_epoch for chain GC)"),
    "hello": dict(
        dir="rank->coord", blocking=True,
        doc="restore-time world validation: the rank announces the "
            "image's origin world (n_from) and the world it believes it "
            "is joining (n_to); a reply of world_mismatch raises a "
            "typed WorldMismatchError instead of silently misassigning "
            "shards"),
    "eof": dict(
        dir="transport->coord", blocking=False,
        doc="synthesized when a rank's connection closes; goodbye-less "
            "EOF = crash -> fail_rank"),
}

# ops whose coordinator method blocks; served by a worker thread each
_BLOCKING_OPS = tuple(op for op, meta in CTRL_OPS.items()
                      if meta["blocking"])
# extra slack on the client's reply wait beyond the server-side timeout:
# the server always answers (success, verdict, or aborted-error) within
# its own deadline, so a client-side TimeoutError means the server died
_REPLY_SLACK_S = 15.0


class RankFailure(RuntimeError):
    """One or more ranks crashed (endpoint EOF without a goodbye,
    missed heartbeats, or an injected kill).  Raised by the world
    harness instead of hanging; carries everything the supervisor
    needs to relaunch from the last committed checkpoint image."""

    def __init__(self, ranks, transport: Optional[str] = None,
                 committed_image: Optional[Dict] = None,
                 partial_results: Optional[Dict] = None,
                 detected_at: float = 0.0):
        ranks = sorted(set(ranks))
        super().__init__(
            f"rank(s) {ranks} failed on transport {transport!r}"
            + ("" if committed_image is None else
               f"; last committed image: epoch {committed_image['epoch']}"))
        self.ranks = ranks
        self.transport = transport
        self.committed_image = committed_image   # {"epoch", "n_ranks", "ranks"}
        self.partial_results = partial_results or {}
        self.detected_at = detected_at           # time.monotonic() at detection


class CoordinatorServer:
    """Serves the checkpoint control plane over an endpoint.

    The launcher owns this object: `coord` (the state machine and its
    `stats`) stays inspectable from the launcher process, while ranks —
    wherever they live — speak only messages.
    """

    def __init__(self, endpoint: Endpoint, n_ranks: int,
                 unblock_window: float = 0.25,
                 heartbeat_timeout: Optional[float] = None,
                 store=None, retain_epochs: int = 1):
        self.ep = endpoint
        self.n_ranks = n_ranks
        self.coord = Coordinator(n_ranks, unblock_window=unblock_window)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name="coordinator-server")
        # ---- failure detection ------------------------------------------
        # ranks that said goodbye (clean exit): their EOF is not a crash
        self._byed: set = set()
        self.failed: "list[int]" = []
        self.failure_event = threading.Event()
        # last-heartbeat times; monitored only when heartbeat_timeout set
        self._hb: Dict[int, float] = {}
        self._hb_timeout = heartbeat_timeout
        self._hb_thread: Optional[threading.Thread] = None
        # ---- checkpoint image collection --------------------------------
        # epoch -> {rank: blob}; an epoch with all n_ranks snapshots AND
        # coordinator-confirmed completion is a COMMITTED image the
        # supervisor can restart from (rank snapshots must live on the
        # launcher side: in a multi-process world a crashed rank's
        # memory is gone)
        self._snaps: Dict[int, Dict[int, Dict]] = {}
        self._snap_lock = threading.Lock()
        # RAM tier retention: keep the last K committed epochs (plus
        # their transitive delta-base chains) instead of only the
        # newest, so point-in-time restore has something to point at
        self.retain_epochs = max(1, int(retain_epochs))
        # ---- durable tier: async store uploads ---------------
        # newly committed epochs are uploaded to `store` (an
        # `image_store.EpochStore`) by a background thread — bounded
        # retry/backoff lives inside the store; failures are recorded
        # in `store_errors`, never raised into the serve loop
        self.store = store
        self.store_errors: "list[tuple[int, str]]" = []
        self._uploaded: set = set()
        self._upload_thread: Optional[threading.Thread] = None

    # ---- lifecycle ---------------------------------------------------------
    def start(self) -> "CoordinatorServer":
        self._thread.start()
        if self._hb_timeout is not None:
            self._hb_thread = threading.Thread(
                target=self._hb_monitor, daemon=True,
                name="coordinator-hb-monitor")
            self._hb_thread.start()
        if self.store is not None:
            self._upload_thread = threading.Thread(
                target=self._upload_loop, daemon=True,
                name="coordinator-store-uploader")
            self._upload_thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        """Signal the serve loop to exit (it wakes within its 0.5s recv
        timeout).  timeout=0 returns without joining — used by GC-time
        teardown where a join pause is unacceptable."""
        self._stop.set()
        if timeout > 0:
            self._thread.join(timeout=timeout)
            if self._upload_thread is not None:
                self._upload_thread.join(timeout=timeout)
                # the serve loop's exit drain may have completed a final
                # epoch after the uploader's last scan: flush it so the
                # durable tier holds everything the RAM tier committed
                self._upload_pass()

    # ---- launcher-side convenience ----------------------------------------
    def request_checkpoint(self) -> int:
        """Trigger a checkpoint from the launcher (e.g. a preemption
        notice): bump the epoch and push intent to every rank."""
        epoch = self.coord.request_checkpoint()
        self._push_intent(epoch)
        return epoch

    def straggler_report(self, threshold: float = 0.5) -> Dict:
        return self.coord.straggler_report(threshold)

    @property
    def stats(self) -> Dict:
        return self.coord.stats

    # ---- failure detection --------------------------------------------------
    def notify_eof(self, rank: int) -> None:
        """A rank's endpoint reached EOF.  Clean exits said goodbye
        first (conn FIFO guarantees the goodbye is observed before the
        EOF notice); a goodbye-less EOF is a crash: mark the rank
        failed, abort the in-flight 2PC and wake the harness."""
        if rank in self._byed:
            return
        if self.coord.fail_rank(rank):
            self.failed.append(rank)
            self.failure_event.set()

    def _hb_monitor(self) -> None:
        """Missed-heartbeat detection: a rank that has heartbeated at
        least once and then goes silent longer than the timeout is
        declared failed (covers hung-but-connected ranks that never
        produce an EOF)."""
        interval = max(0.01, self._hb_timeout / 4)
        while not self._stop.wait(interval):
            now = time.monotonic()
            for rank, last in list(self._hb.items()):
                if (now - last > self._hb_timeout
                        and rank not in self._byed):
                    self.notify_eof(rank)

    # ---- checkpoint image collection ---------------------------------------
    @staticmethod
    def _blob_base(blob) -> Optional[int]:
        """Delta-chain link of a shipped blob, if it advertises one
        (the `repro_torch.core.codec` incremental-snapshot convention) —
        parsed from the compact header of a binary container, or the
        dict key of a legacy/app blob."""
        return blob_base_epoch(blob)

    def _committed_epochs(self) -> "list[int]":
        """Restartable epochs, ascending: full snapshot set, completed
        commit round, AND resolvable delta chains.  Caller holds
        `_snap_lock`."""
        done = self.coord.done_epoch
        return sorted(e for e, s in self._snaps.items()
                      if e <= done and len(s) == self.n_ranks
                      and self._chains_for(e, s) is not None)

    def _prune_snaps(self) -> None:
        """Chain-aware snapshot GC: drop epochs superseded by the
        newest `retain_epochs` committed images — EXCEPT the transitive
        delta-base chain of every retained epoch (an incremental blob
        is useless without its bases), so launcher memory stays bounded
        by the retention policy instead of growing with job length.
        Caller holds `_snap_lock`."""
        # restartable = full snapshot set AND resolvable delta chains;
        # an epoch whose chain broke (aborted base) must not become the
        # GC horizon, or it would delete the older image committed_image
        # falls back to
        committed = self._committed_epochs()
        if len(committed) < self.retain_epochs:
            return
        # the GC horizon is the OLDEST retained committed epoch — with
        # retain_epochs=1 this is exactly the old newest-only behavior
        horizon = committed[-self.retain_epochs]
        keep = {e for e in self._snaps if e >= horizon}
        frontier = list(keep)
        while frontier:
            for blob in self._snaps.get(frontier.pop(), {}).values():
                base = self._blob_base(blob)
                if base is not None and base not in keep:
                    keep.add(base)
                    frontier.append(base)
        for e in [e for e in self._snaps if e not in keep]:
            del self._snaps[e]

    def _chains_for(self, epoch: int, snaps: Dict[int, Dict],
                    ) -> Optional[Dict]:
        """Per-rank base-chain blobs ({rank: {base_epoch: blob}}) for an
        image at `epoch` — restore walks these to reconstruct arrays
        from base+deltas.  Empty for full (non-incremental) blobs.

        Returns None when some rank's chain cannot be fully resolved —
        e.g. a delta whose base epoch was ABORTED before that rank's
        blob arrived (writer NACK, crash mid-upload).  An epoch with a
        broken chain is NOT restartable no matter what the commit round
        says, so `committed_image` must fall back to an older epoch
        rather than hand the supervisor an image that raises
        `DeltaChainError` at restore.  Caller holds `_snap_lock`."""
        chains: Dict[int, Dict[int, Dict]] = {}
        for rank, blob in snaps.items():
            links: Dict[int, Dict] = {}
            base = self._blob_base(blob)
            while base is not None and base not in links:
                ancestor = self._snaps.get(base, {}).get(rank)
                if ancestor is None:
                    return None  # broken chain: epoch not restartable
                links[base] = ancestor
                base = self._blob_base(ancestor)
            if links:
                chains[rank] = links
        return chains

    def image_for_epoch(self, epoch: int) -> Optional[Dict]:
        """The restartable image of one specific committed epoch (the
        store uploader's unit of work), or None if that epoch is not
        restartable — point-in-time restore at the RAM tier."""
        with self._snap_lock:
            snaps = self._snaps.get(epoch)
            if (snaps is None or epoch > self.coord.done_epoch
                    or len(snaps) != self.n_ranks):
                return None
            chains = self._chains_for(epoch, snaps)
            if chains is None:
                return None
            return {"epoch": epoch, "n_ranks": self.n_ranks,
                    "ranks": dict(snaps), "chains": chains}

    def committed_image(self) -> Optional[Dict]:
        """Newest checkpoint image that is restartable: every rank's
        snapshot arrived, the coordinator completed the epoch's commit
        round (in the async pipeline that includes every rank's writer
        ack), AND every delta chain resolves inside the collector.
        Incremental images carry their per-rank delta base chains under
        "chains".  None if no epoch qualifies (yet)."""
        done = self.coord.done_epoch
        with self._snap_lock:
            for epoch in sorted(self._snaps, reverse=True):
                snaps = self._snaps[epoch]
                if epoch > done or len(snaps) != self.n_ranks:
                    continue
                chains = self._chains_for(epoch, snaps)
                if chains is None:
                    continue  # broken base chain: try an older epoch
                return {"epoch": epoch, "n_ranks": self.n_ranks,
                        "ranks": dict(snaps), "chains": chains}
        return None

    # ---- durable tier: async uploads ----------------------------
    def _upload_pass(self) -> None:
        """Commit every not-yet-uploaded committed epoch to the store.
        The image is assembled under `_snap_lock`; the (possibly slow)
        store I/O runs outside it, so uploads never stall the serve
        loop or the ranks — blobs are immutable once shipped, so the
        assembled dict stays valid after the lock drops."""
        with self._snap_lock:
            pending = [e for e in self._committed_epochs()
                       if e not in self._uploaded]
        for epoch in pending:
            image = self.image_for_epoch(epoch)
            if image is None:
                continue  # pruned or invalidated since the scan
            try:
                self.store.commit(image)
                self._uploaded.add(epoch)
            except Exception as e:  # noqa: BLE001 — a store failure
                # (typed StoreError or not) must degrade to a recorded
                # error, never kill the uploader or the serve loop
                self._uploaded.add(epoch)   # do not retry forever
                self.store_errors.append((epoch, str(e)))

    def _upload_loop(self) -> None:
        while not self._stop.wait(0.05):
            self._upload_pass()

    # ---- serve loop --------------------------------------------------------
    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                # wakeups are event-driven (enqueue notifies the recv
                # cv); the timeout only bounds stop() latency
                msg = self.ep.recv(None, TAG_CTRL, timeout=0.5)
            except TimeoutError:
                continue
            except Exception:  # noqa: BLE001 — endpoint torn down
                return
            self._dispatch(msg)
        # drain: frames already queued when stop() landed must still be
        # processed — the async pipeline's final snap/writer_ack are
        # fire-and-forget, and dropping them here would lose the last
        # epoch's finalize (sync mode never raced this: its blocking
        # round trips forced processing before ranks exited)
        while True:
            try:
                msg = self.ep.recv(None, TAG_CTRL, timeout=0)
            except Exception:  # noqa: BLE001 — empty or torn down
                return
            self._dispatch(msg)

    def _dispatch(self, msg) -> None:
        # the serve loop must survive any malformed request — a
        # dead control plane turns into n ranks hanging on reply
        # timeouts with no hint of the real error
        try:
            req = pickle.loads(msg.payload)
        except Exception:  # noqa: BLE001
            traceback.print_exc()
            return
        if req.get("op") in _BLOCKING_OPS:
            # one short-lived worker per blocking request.  Clients
            # are synchronous (at most ONE blocking request in
            # flight per rank), so concurrency is bounded by
            # n_ranks; only creation churn scales with park retries
            threading.Thread(target=self._handle, daemon=True,
                             args=(msg.src, req)).start()
        else:
            self._handle(msg.src, req)

    def _reply(self, dst: int, rep: Dict) -> None:
        self.ep.send(dst, pickle.dumps(rep), TAG_CTRL)

    def _push_intent(self, epoch: int) -> None:
        blob = pickle.dumps({"epoch": epoch})
        for r in range(self.n_ranks):
            self.ep.send(r, blob, TAG_INTENT)

    def _handle(self, src: int, req: Dict) -> None:
        op = req["op"]
        c = self.coord
        try:
            if op == "register_comm":
                c.register_comm(req["gid"], tuple(req["ranks"]))
            elif op == "enter":
                c.collective_enter(req["rank"], req["gid"], req["count"])
            elif op == "exit":
                c.collective_exit(req["rank"], req["gid"], req["count"])
            elif op == "committed":
                c.report_committed(req["rank"], req.get("epoch"))
            elif op == "writer_ack":
                c.writer_ack(req["rank"], req["epoch"],
                             ok=req.get("ok", True), err=req.get("err"))
            elif op == "mark_dead":
                c.mark_dead(req["rank"])
            elif op == "hb":
                self._hb[req["rank"]] = time.monotonic()
                c.last_seen[req["rank"]] = time.monotonic()
            elif op == "bye":
                self._byed.add(req["rank"])
            elif op == "eof":
                # synthesized by the transport (the socket switch) when
                # a rank's connection closes; conn FIFO ordered it after
                # everything the rank sent while alive
                self.notify_eof(req["rank"])
            elif op == "snap":
                with self._snap_lock:
                    self._snaps.setdefault(req["epoch"], {})[req["rank"]] \
                        = req["blob"]
                    self._prune_snaps()
            elif op == "request_ckpt":
                epoch = c.request_checkpoint()
                self._push_intent(epoch)
                self._reply(src, {"epoch": epoch})
            elif op == "park":
                verdict = c.try_park(req["rank"], req["epoch"],
                                     req["exited"], timeout=req["timeout"])
                self._reply(src, {"verdict": verdict,
                                  "last_closed": c.last_closed_epoch})
            elif op == "wait_all_committed":
                c.wait_all_committed(req["epoch"], timeout=req["timeout"])
                self._reply(src, {"ok": True})
            elif op == "wait_released":
                released = c.wait_released(req["epoch"],
                                           timeout=req["timeout"])
                self._reply(src, {"released": released})
            elif op == "straggler_report":
                self._reply(src, {"report": c.straggler_report(
                    req["threshold"])})
            elif op == "hello":
                # elastic-restore handshake: the coordinator
                # is the one component that knows the LIVE world size,
                # so it is where an image restored into the wrong world
                # gets rejected.  n_from != n_to is fine — that is what
                # a RestorePlan is for — but the rank's believed n_to
                # must match this world or its shard assignment is
                # garbage.
                if req["n_to"] != self.n_ranks:
                    self._reply(src, {
                        "error": "world_mismatch",
                        "msg": (f"rank {src} restoring an image planned "
                                f"for n_to={req['n_to']} into a world of "
                                f"n_ranks={self.n_ranks} "
                                f"(image origin n_from={req['n_from']})"),
                    })
                else:
                    self._reply(src, {"ok": True, "n_ranks": self.n_ranks})
            else:
                raise ValueError(f"unknown control op {op!r}")
        except CheckpointAborted as e:
            self._reply(src, {"error": "aborted", "msg": str(e)})
        except Exception:  # noqa: BLE001 — ship it to the caller:
            # a silent worker death leaves the rank hanging on a reply
            self._reply(src, {"error": "server",
                              "msg": traceback.format_exc()})


class CoordinatorClient:
    """Rank-side stub of the coordinator; speaks only messages.

    One instance per rank (NOT thread-safe across ranks — exactly like
    a rank's slice of the direct `Coordinator` API).  At most one
    blocking request is in flight at a time, which is how `RankAgent`
    drives the protocol, so a single per-rank reply FIFO suffices.
    """

    def __init__(self, endpoint: Endpoint, coord_rank: Optional[int] = None):
        self.ep = endpoint
        self.coord_rank = (endpoint.transport.coord_rank
                           if coord_rank is None else coord_rank)
        self._intent = 0
        self._last_closed = 0

    # ---- the §III-I hot path ----------------------------------------------
    @property
    def intent_epoch(self) -> int:
        """Newest checkpoint epoch this rank has heard of.  Drains any
        pending intent pushes nonblockingly — no coordinator round
        trip on the steady-state path."""
        while True:
            msg = self.ep._claim(self.coord_rank, TAG_INTENT)
            if msg is None:
                break
            self._intent = max(self._intent,
                               pickle.loads(msg.payload)["epoch"])
        return self._intent

    @property
    def last_closed_epoch(self) -> int:
        """Newest closed epoch, piggybacked on the park verdict reply
        (the rank only needs it right after a "safe" verdict)."""
        return self._last_closed

    # ---- plumbing ----------------------------------------------------------
    def _send(self, req: Dict) -> None:
        self.ep.send(self.coord_rank, pickle.dumps(req), TAG_CTRL)

    def _call(self, req: Dict, timeout: float) -> Dict:
        self._send(req)
        msg = self.ep.recv(self.coord_rank, TAG_CTRL,
                           timeout=timeout + _REPLY_SLACK_S)
        rep = pickle.loads(msg.payload)
        if rep.get("error") == "aborted":
            raise CheckpointAborted(rep["msg"])
        if rep.get("error") == "world_mismatch":
            raise WorldMismatchError(rep["msg"])
        if rep.get("error"):
            raise RuntimeError(f"coordinator server error:\n{rep['msg']}")
        return rep

    # ---- elastic-restore handshake -------------------------------
    def hello(self, n_from: int, n_to: int, timeout: float = 60.0) -> int:
        """Validate this rank's restore plan against the live world.

        Raises `WorldMismatchError` if the plan's target world (n_to)
        is not the world the coordinator is actually running; returns
        the coordinator's n_ranks on success."""
        rep = self._call({"op": "hello", "n_from": int(n_from),
                          "n_to": int(n_to)}, timeout)
        return rep["n_ranks"]

    # ---- the Coordinator surface RankAgent consumes ------------------------
    def request_checkpoint(self, timeout: float = 60.0) -> int:
        rep = self._call({"op": "request_ckpt"}, timeout)
        self._intent = max(self._intent, rep["epoch"])
        return rep["epoch"]

    def register_comm(self, gid: int, ranks: Sequence[int]) -> None:
        self._send({"op": "register_comm", "gid": gid,
                    "ranks": tuple(ranks)})

    def collective_enter(self, rank: int, gid: int, entered: int) -> None:
        self._send({"op": "enter", "rank": rank, "gid": gid,
                    "count": entered})

    def collective_exit(self, rank: int, gid: int, exited: int) -> None:
        self._send({"op": "exit", "rank": rank, "gid": gid,
                    "count": exited})

    def try_park(self, rank: int, epoch: int, my_exited: Dict[int, int],
                 timeout: float = 60.0) -> str:
        rep = self._call({"op": "park", "rank": rank, "epoch": epoch,
                          "exited": dict(my_exited), "timeout": timeout},
                         timeout)
        self._last_closed = max(self._last_closed, rep["last_closed"])
        return rep["verdict"]

    def report_committed(self, rank: int, epoch: Optional[int] = None) -> None:
        self._send({"op": "committed", "rank": rank, "epoch": epoch})

    def writer_ack(self, rank: int, epoch: int, ok: bool = True,
                   err: Optional[str] = None) -> None:
        """Async pipeline: this rank's background writer confirms (or,
        with ok=False, renounces) durability of its epoch snapshot.
        Fire-and-forget, sent AFTER the writer's `snap` upload on the
        same endpoint, so per-(src, tag) FIFO guarantees the server
        holds the blob before the ack gates the commit."""
        self._send({"op": "writer_ack", "rank": rank, "epoch": epoch,
                    "ok": ok, "err": err})

    def wait_all_committed(self, epoch: int, timeout: float = 120.0) -> None:
        self._call({"op": "wait_all_committed", "epoch": epoch,
                    "timeout": timeout}, timeout)

    def wait_released(self, epoch: int, timeout: float = 120.0) -> bool:
        rep = self._call({"op": "wait_released", "epoch": epoch,
                          "timeout": timeout}, timeout)
        return rep["released"]

    def mark_dead(self, rank: int) -> None:
        self._send({"op": "mark_dead", "rank": rank})

    # ---- failure / recovery plumbing ---------------------------------------
    def ship_snapshot(self, epoch: int, blob) -> None:
        """Ship this rank's checkpoint snapshot to the launcher-side
        image collector (fire-and-forget, ordered before the rank's
        `committed` report by per-(src, tag) FIFO).  `blob` is a binary
        snapshot container (`repro_torch.core.codec.SnapshotCodec`) or a
        JSON-safe dict: the supervisor materializes the assembled image
        through the transport-free `image_to_bytes` container before
        restarting from it, so live transport state cannot smuggle
        through."""
        self._send({"op": "snap", "rank": self.ep.rank, "epoch": epoch,
                    "blob": blob})

    def bye(self) -> None:
        """Clean-exit goodbye: tells the server this endpoint's
        upcoming EOF is a departure, not a crash."""
        self._send({"op": "bye", "rank": self.ep.rank})

    def start_heartbeat(self, interval: float) -> None:
        """Start the liveness heartbeat (daemon thread; stops at
        `stop_heartbeat` or when the endpoint goes away)."""
        self._hb_stop = threading.Event()

        def beat():
            while not self._hb_stop.wait(interval):
                try:
                    self._send({"op": "hb", "rank": self.ep.rank})
                except Exception:  # noqa: BLE001 — endpoint torn down
                    return

        threading.Thread(target=beat, daemon=True,
                         name=f"hb-r{self.ep.rank}").start()

    def stop_heartbeat(self) -> None:
        if getattr(self, "_hb_stop", None) is not None:
            self._hb_stop.set()

    def straggler_report(self, threshold: float = 0.5,
                         timeout: float = 30.0) -> Dict:
        return self._call({"op": "straggler_report",
                           "threshold": threshold}, timeout)["report"]


def make_control_plane(world, unblock_window: float = 0.25,
                       heartbeat_timeout: Optional[float] = None,
                       store=None, retain_epochs: int = 1,
                       ) -> Tuple[CoordinatorServer, "list[CoordinatorClient]"]:
    """Wire a coordinator server onto a transport world's reserved
    endpoint and hand every local rank endpoint a client stub."""
    server = CoordinatorServer(world.coord_endpoint(), world.n_ranks,
                               unblock_window=unblock_window,
                               heartbeat_timeout=heartbeat_timeout,
                               store=store,
                               retain_epochs=retain_epochs).start()
    clients = [CoordinatorClient(ep) for ep in world.endpoints]
    return server, clients
