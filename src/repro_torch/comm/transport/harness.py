"""World harness: run one rank function per rank over any transport —
and SUPERVISE it through rank failures.

The launcher picture, uniform across backends:

    run_world("inproc", n, fn)   n threads in this process
    run_world("socket", n, fn)   n spawned OS processes over loopback TCP
                                 (real parallelism — no shared GIL)

In BOTH cases the checkpoint control plane is wire-only: the launcher
runs a `CoordinatorServer` on the world's reserved coordinator
endpoint, and each rank talks to it through a `CoordinatorClient` —
ranks never touch a shared coordinator object, so the same `fn` runs
unchanged whether its world is threads or processes (the paper's
network-agnosticism, reproduced at the harness level).

`fn(ctx)` receives a `WorldContext` (rank, n, ep, agent, coord,
transport, faults) and returns a picklable result.  Socket ranks ship
their result back to the launcher over the fabric itself on TAG_RESULT
— the harness has no side channel the transport doesn't provide.

Failure semantics (the NERSC-production half of the paper's story):

  * an injected `RankKilled` hard-exits a socket rank process (no
    goodbye, no result — the switch sees a raw EOF and synthesizes an
    EOF notice to the coordinator) and, for inproc, unwinds the rank
    thread with the harness reporting the death to the server — both
    backends land in `CoordinatorServer.notify_eof`;
  * the server aborts the in-flight 2PC (`Coordinator.fail_rank`),
    which withdraws parked ranks, and sets its `failure_event`;
  * the harness tears the world down promptly (poisoning surviving
    inproc endpoints / terminating socket processes) and raises a
    typed `RankFailure` carrying the last COMMITTED checkpoint image
    assembled from the snapshots ranks shipped at commit time;
  * `run_world_supervised` catches `RankFailure` and relaunches all
    ranks from that image — optionally on a different backend (the
    image is forced through the transport-free binary image container,
    `repro_torch.core.codec.image_to_bytes`) — bounding lost work to the
    checkpoint interval.

Port of `repro.comm.transport.harness`, with two changes that CUDA
forces (the rest is the reference's code):

  * socket ranks are SPAWNED, not forked: a child forked from a process
    that has initialised CUDA cannot use CUDA.  Spawn pickles the rank
    function and its arguments into every child, so on the socket
    backend `fn` must be picklable — a module-level function, a
    `functools.partial`, or an instance of a module-level class with
    `__call__`; a closure or lambda raises `TypeError` before any
    process starts.  Give each rank what it needs to restore its own
    arrays (image bytes, a path, a store key), not a whole world's
    shards.  A `FaultPlan` crosses to the children without its lock.
    Each spawned rank that touches the card owns its own CUDA context
    (about half a GB of device memory and a second or more to start),
    so socket worlds on the card stay small; large worlds run `inproc`
    threads sharing one context.
  * the async checkpoint pipeline uses the THREAD snapshot writer on
    every backend (`_make_agent`): a forked writer child cannot touch
    the card.  This gives up the reference's escape from the rank's
    GIL on the socket backend; zlib and the device-to-host copy
    release the GIL.
"""
from __future__ import annotations

import copyreg
import dataclasses
import json
import os
import pickle
import threading
import time
import traceback
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

from repro_torch.comm.transport.base import TAG_RESULT, Endpoint, TransportClosed
from repro_torch.comm.transport.faults import FaultPlan, RankKilled
from repro_torch.comm.transport.inproc import InprocTransport
from repro_torch.comm.transport.tcp import FabricSwitch, SocketTransport
from repro_torch.core.codec import image_to_bytes
from repro_torch.core.control import (CoordinatorClient, CoordinatorServer,
                                RankFailure, make_control_plane)


@dataclasses.dataclass
class WorldContext:
    rank: int
    n: int
    ep: Endpoint
    agent: Any                      # RankAgent
    coord: CoordinatorClient
    transport: Any
    faults: Optional[FaultPlan] = None


@dataclasses.dataclass
class WorldResult:
    results: Dict[int, Any]         # rank -> fn(ctx) return value
    vclocks: List[float]            # per-rank virtual clocks at exit
    coord_stats: Dict               # coordinator stats snapshot
    transport: str


def row_width(n: int) -> int:
    """Row-communicator width for the demo/benchmark topology: worlds
    split into rows of 16 when possible (the examples' and benchmarks'
    shared convention — the chaos schedule's straggler placement and
    the guarded 64-rank pipeline records both assume it)."""
    return 16 if n % 16 == 0 else max(d for d in (8, 4, 2, 1) if n % d == 0)


class WorldError(RuntimeError):
    def __init__(self, errors):
        super().__init__(f"{len(errors)} rank(s) failed: "
                         + "; ".join(f"rank {r}: {e.splitlines()[-1]}"
                                     for r, e in sorted(errors.items())[:3]))
        self.errors = errors


def _rebuild_fault_plan(state: Dict) -> FaultPlan:
    plan = FaultPlan.__new__(FaultPlan)
    plan.__dict__.update(state)
    plan._lock = threading.Lock()
    return plan


def _reduce_fault_plan(plan: FaultPlan):
    """Pickle a `FaultPlan` without its lock (spawned socket ranks
    receive their plan by pickle)."""
    return _rebuild_fault_plan, ({k: v for k, v in plan.__dict__.items()
                                  if k != "_lock"},)


copyreg.pickle(FaultPlan, _reduce_fault_plan)


def _make_agent(rank: int, ep: Endpoint, coord, n: int, mode: str,
                coll_algo: Optional[str], transport_name: str,
                async_ckpt: bool = False):
    from repro_torch.core.two_phase_commit import RankAgent
    writer = None
    if async_ckpt:
        # a thread on every backend: a forked writer cannot use CUDA
        from repro_torch.core.snapshot_writer import ThreadSnapshotWriter
        writer = ThreadSnapshotWriter()
    return RankAgent(rank, ep, coord, range(n), mode=mode,
                     coll_algo=coll_algo, transport=transport_name,
                     async_commit=async_ckpt, writer=writer)


def restore_agent_from_blob(ctx: "WorldContext", agent_blob: Dict) -> None:
    """DEPRECATED shim over `repro_torch.restore_world`.

    The §III-C restore ritual now lives behind the one public
    entrypoint — build a plan-resolved world and `bind` it instead:

        repro_torch.restore_world(image).bind(ctx)

    This shim performs the same-world (identity-plan) rebind of one
    serialized `RankAgent` blob for callers that predate `RestorePlan`.
    App-held comm HANDLES (world/row vids) are application upper-half
    state and are NOT reassigned here — reassign them from your own
    image fields, or scan `ctx.agent.comms.active()`.
    """
    from repro_torch.core.restore import _bind_agent_blob, deprecated_once
    deprecated_once(
        "restore_agent_from_blob",
        "harness.restore_agent_from_blob is deprecated; use "
        "repro_torch.restore_world(image).bind(ctx) instead")
    _bind_agent_blob(ctx, agent_blob)


def run_world(transport: str, n: int, fn: Callable[[WorldContext], Any], *,
              msg_cost_us: float = 0.0, unblock_window: float = 0.5,
              mode: str = "hybrid", coll_algo: Optional[str] = "tree",
              timeout: float = 300.0, faults: Optional[FaultPlan] = None,
              heartbeat_s: Optional[float] = None,
              async_ckpt: bool = False,
              store=None, retain_epochs: int = 1,
              on_running: Optional[Callable[[CoordinatorServer], None]] = None,
              ) -> WorldResult:
    """Run `fn` on every rank of a fresh `transport` world and tear the
    world down.  Raises `RankFailure` if a rank crashes (fault
    injection, process death, missed heartbeats) and `WorldError` if a
    rank raises an ordinary application error.

    `fn(ctx)` receives a `WorldContext` and its return value lands in
    `WorldResult.results[ctx.rank]`:

    >>> res = run_world("inproc", 2, lambda ctx: ctx.rank * 10)
    >>> res.results == {0: 0, 1: 10}
    True
    >>> res.transport
    'inproc'

    With `async_ckpt=True` rank agents run the ASYNC 2PC split: safe
    points stage the snapshot and return immediately, a per-rank
    background writer thread (on both backends) does serialization +
    `snap` upload, and the coordinator finalizes
    the epoch only on every rank's writer ack — see
    `repro_torch.core.snapshot_writer`.
    """
    if transport == "inproc":
        return _run_inproc(n, fn, msg_cost_us, unblock_window, mode,
                           coll_algo, timeout, faults, heartbeat_s,
                           async_ckpt, store, retain_epochs, on_running)
    if transport == "socket":
        return _run_socket(n, fn, msg_cost_us, unblock_window, mode,
                           coll_algo, timeout, faults, heartbeat_s,
                           async_ckpt, store, retain_epochs, on_running)
    from repro_torch.comm.transport import available_transports
    raise ValueError(f"unknown transport {transport!r}; "
                     f"registered: {available_transports()}")


# ---------------------------------------------------------------------------
# inproc: threads
# ---------------------------------------------------------------------------

def _run_inproc(n, fn, msg_cost_us, unblock_window, mode, coll_algo,
                timeout, faults, heartbeat_s, async_ckpt,
                store, retain_epochs, on_running) -> WorldResult:
    import threading

    world = InprocTransport(n, msg_cost_us=msg_cost_us, fault_plan=faults)
    server, clients = make_control_plane(
        world, unblock_window=unblock_window,
        heartbeat_timeout=None if heartbeat_s is None else 5 * heartbeat_s,
        store=store, retain_epochs=retain_epochs)
    results: Dict[int, Any] = {}
    errors: Dict[int, str] = {}

    def work(r):
        ep = world.endpoints[r]
        coord = clients[r]
        agent = _make_agent(r, ep, coord, n, mode, coll_algo, "inproc",
                            async_ckpt)
        if heartbeat_s is not None:
            coord.start_heartbeat(heartbeat_s)
        try:
            results[r] = fn(WorldContext(r, n, ep, agent, coord, world,
                                         faults))
            # async pipeline: the rank owes the coordinator its writer
            # acks — finish them before the result counts as clean
            agent.drain_writer()
        except RankKilled as e:
            # an inproc "crash" is a thread unwinding; the harness (the
            # launcher, playing resource manager) reports the death —
            # the socket backend's raw-EOF path lands in the same place
            errors[r] = str(e)
            server.notify_eof(r)
        except TransportClosed as e:
            # collateral teardown after a PEER failed — not this rank's
            # error; recorded for the logs only
            errors.setdefault(r, f"torn down: {e}")
        except Exception:  # noqa: BLE001 — reported via WorldError
            errors[r] = traceback.format_exc()
        finally:
            coord.stop_heartbeat()
            # clean-exit goodbye, exactly like _socket_child: without
            # it the heartbeat monitor would declare an early-finishing
            # rank crashed once its beats go stale.  A killed rank's
            # notify_eof already fired above, so this cannot mask it.
            coord.bye()

    threads = [threading.Thread(target=work, args=(r,), daemon=True)
               for r in range(n)]
    for t in threads:
        t.start()
    if on_running is not None:
        on_running(server)
    deadline = time.monotonic() + timeout
    while any(t.is_alive() for t in threads):
        if server.failure_event.is_set():
            break
        if time.monotonic() > deadline:
            break
        server.failure_event.wait(0.02)
    if server.failure_event.is_set():
        # capture the image BEFORE stopping the server, then unwind the
        # survivors promptly (they may be blocked on the dead rank)
        image = server.committed_image()
        detected = time.monotonic()
        for ep in world.endpoints:
            ep.poison(f"rank(s) {server.failed} failed; world torn down")
        join_by = time.monotonic() + 10.0
        for t in threads:
            t.join(timeout=max(0.0, join_by - time.monotonic()))
        server.stop()
        world.close()
        raise RankFailure(server.failed, transport="inproc",
                          committed_image=image,
                          partial_results=dict(results),
                          detected_at=detected)
    hung = [r for r, t in enumerate(threads) if t.is_alive()]
    server.stop()
    stats = dict(server.coord.stats)
    vclocks = [ep.vclock for ep in world.endpoints]
    world.close()
    if hung:
        errors.update({r: "rank hung (join timeout)" for r in hung})
    if errors:
        raise WorldError(errors)
    return WorldResult(results, vclocks, stats, "inproc")


# ---------------------------------------------------------------------------
# socket: one spawned OS process per rank
# ---------------------------------------------------------------------------

def _socket_child(rank, n, addr, fn, msg_cost_us, mode, coll_algo, faults,
                  heartbeat_s, async_ckpt):
    tr = SocketTransport(n, rank, addr, msg_cost_us=msg_cost_us,
                         fault_plan=faults)
    ep = tr.endpoint
    coord = CoordinatorClient(ep)
    if heartbeat_s is not None:
        coord.start_heartbeat(heartbeat_s)
    envelope: Dict[str, Any]
    try:
        agent = _make_agent(rank, ep, coord, n, mode, coll_algo, "socket",
                            async_ckpt)
        out = fn(WorldContext(rank, n, ep, agent, coord, tr, faults))
        agent.drain_writer()  # writer acks must precede the goodbye
        envelope = {"ok": out, "vclock": ep.vclock}
    except RankKilled:
        # a CRASH, not an error report: no result, no goodbye — the
        # switch sees a raw EOF, exactly like a powered-off node
        os._exit(17)
    except Exception:  # noqa: BLE001 — shipped to the launcher
        envelope = {"err": traceback.format_exc(), "vclock": ep.vclock}
    ep.send(tr.coord_rank, pickle.dumps((rank, envelope)), TAG_RESULT)
    coord.bye()       # clean exit: the upcoming EOF is a departure
    time.sleep(0.05)  # let the frames flush before the fd closes
    tr.close()


def _run_socket(n, fn, msg_cost_us, unblock_window, mode, coll_algo,
                timeout, faults, heartbeat_s, async_ckpt,
                store, retain_epochs, on_running) -> WorldResult:
    import multiprocessing

    try:
        pickle.dumps(fn)
    except (pickle.PicklingError, AttributeError, TypeError) as e:
        raise TypeError(
            f"socket ranks are spawned processes, so the rank function "
            f"must be picklable (a module-level function, a "
            f"functools.partial, or an instance of a module-level class "
            f"with __call__); got {fn!r}: {e}") from e
    ctx = multiprocessing.get_context("spawn")

    switch = FabricSwitch(coord_rank=n)
    coord_tr = SocketTransport(n, n, switch.addr)  # coordinator = rank n
    server = CoordinatorServer(
        coord_tr.endpoint, n, unblock_window=unblock_window,
        heartbeat_timeout=None if heartbeat_s is None else 5 * heartbeat_s,
        store=store, retain_epochs=retain_epochs,
    ).start()
    procs = [ctx.Process(target=_socket_child, daemon=True,
                         args=(r, n, switch.addr, fn, msg_cost_us, mode,
                               coll_algo, faults, heartbeat_s, async_ckpt))
             for r in range(n)]
    for p in procs:
        p.start()
    if on_running is not None:
        on_running(server)
    results: Dict[int, Any] = {}
    errors: Dict[int, str] = {}
    vclocks = [0.0] * n
    deadline = time.monotonic() + timeout
    failure: Optional[RankFailure] = None
    died = False
    try:
        while len(results) + len(errors) < n:
            # a spawned rank that exits before it reports (an import or
            # start-up error; 17 is a killed rank, left to EOF detection)
            # fails the world now instead of at the timeout
            dead = {r: p.exitcode for r, p in enumerate(procs)
                    if r not in results and r not in errors
                    and p.exitcode not in (None, 0, 17)}
            if dead:
                errors.update({r: f"rank process exited with code {c} "
                                  f"before reporting a result"
                               for r, c in dead.items()})
                died = True
                break
            if server.failure_event.is_set():
                failure = RankFailure(server.failed, transport="socket",
                                      committed_image=server.committed_image(),
                                      partial_results=dict(results),
                                      detected_at=time.monotonic())
                break
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                missing = sorted(set(range(n)) - set(results) - set(errors))
                errors.update({r: "no result before timeout (rank hung "
                                  "or crashed hard)" for r in missing})
                break
            try:
                msg = coord_tr.endpoint.recv(None, TAG_RESULT,
                                             timeout=min(remaining, 0.25))
            except TimeoutError:
                continue
            rank, envelope = pickle.loads(msg.payload)
            vclocks[rank] = envelope.get("vclock", 0.0)
            if "err" in envelope:
                errors[rank] = envelope["err"]
            else:
                results[rank] = envelope["ok"]
    finally:
        join_by = time.monotonic() + (2.0 if failure is not None or died
                                      else 10.0)
        for p in procs:
            p.join(timeout=max(0.0, join_by - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.terminate()
        server.stop()
        stats = dict(server.coord.stats)
        coord_tr.close()
        switch.close()
    if failure is not None:
        raise failure
    if errors:
        raise WorldError(errors)
    return WorldResult(results, vclocks, stats, "socket")


# ---------------------------------------------------------------------------
# supervisor: auto-restart from the last committed image
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SupervisedRun:
    result: WorldResult             # the successful (final) attempt
    attempts: int                   # worlds launched (failures + 1)
    failures: List[Dict]            # one record per failed attempt
    final_transport: str
    image: Optional[Dict]           # image the final attempt started from
    final_n: int = 0                # world size of the successful attempt


def _image_restorable(image: Dict) -> bool:
    """Verify a committed image actually decodes: every binary snapshot
    blob's chain walks and digests check (typed `ImageError` paths in
    `repro_torch.core.codec`).  JSON-safe app-dict blobs have nothing to
    verify — they round-tripped through the container already."""
    from repro_torch.core.codec import ImageError, is_snap_blob, restore_rank_arrays
    try:
        for r, blob in image.get("ranks", {}).items():
            if is_snap_blob(blob):
                restore_rank_arrays(image, r)
        return True
    except (ImageError, KeyError, TypeError, ValueError):
        return False


def run_world_supervised(
        transports: Union[str, Sequence[str]], n: int,
        fn_factory: Callable[[int, Optional[Dict]], Callable],
        *, max_restarts: int = 8,
        faults_for_attempt: Optional[Callable[[int], Optional[FaultPlan]]] = None,
        image: Optional[Dict] = None,
        log_dir: Optional[str] = None,
        elastic: bool = False,
        capacity_for_attempt: Optional[Callable[[int, Optional[RankFailure]],
                                                Optional[int]]] = None,
        store=None, retain_epochs: int = 1,
        **run_kw) -> SupervisedRun:
    """Supervise a world through rank failures.

    `fn_factory(attempt, image)` builds the per-rank function for one
    attempt; `image` is None on a cold start, else the last COMMITTED
    checkpoint image (`{"epoch", "n_ranks", "ranks": {str(rank): blob}}`)
    — normalized through `repro_torch.restore_world` (the transport-free
    binary image container round trip: binary snapshot blobs are inert
    bytes, dict blobs must be JSON-safe, so a blob that smuggled live
    transport state would fail loudly), so restarting on a DIFFERENT
    backend (pass a sequence of transport names to cycle through) is
    correct by construction.

    ELASTIC mode (`elastic=True`): the supervisor relaunches
    at whatever capacity is available instead of insisting on `n` —
    after a failure the next attempt runs at `n - len(failed ranks)`
    (kill 3 of 64 -> resume at 61), and `capacity_for_attempt(attempt,
    last_failure)` can override per attempt (return the original `n` to
    grow back once capacity returns; None keeps the computed size).
    Whenever the attempt's world size differs from the image's, the
    image gets a `RestorePlan` attached ("remap" header field) so the
    ranks' `repro_torch.restore_world(image).bind(ctx)` reshards and remaps
    automatically.

    On `RankFailure`: record it (to `log_dir` if given), adopt the
    failure's committed image if it carries one AND it verifies, and
    relaunch.  Raises the last `RankFailure` once `max_restarts` is
    exhausted.

    DURABLE tier (`store=`, an `image_store.EpochStore`):
    the coordinator uploads every committed epoch asynchronously, and
    restore picks the newest VERIFIED epoch — a cold start (image=None,
    e.g. a relaunch after the launcher itself died) adopts the newest
    store epoch that passes digest verification, and a corrupt or torn
    epoch falls back a generation with a typed `EpochFallbackWarning`
    instead of failing the restart.  `retain_epochs` bounds both the
    RAM collector and the store retention.

    A fault-free supervised run is one attempt:

    >>> sup = run_world_supervised(
    ...     "inproc", 2, lambda attempt, image: (lambda ctx: ctx.rank))
    >>> (sup.attempts, sup.failures, sup.result.results, sup.final_n)
    (1, [], {0: 0, 1: 1}, 2)
    """
    from repro_torch.core.restore import RestorePlan, restore_world

    names = [transports] if isinstance(transports, str) else list(transports)
    failures: List[Dict] = []
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
    if image is None and store is not None:
        # cold start with a durable tier: the launcher (or a previous
        # incarnation of it) may have committed epochs before dying —
        # adopt the newest VERIFIED one; corrupt/torn epochs fall back
        # a generation (EpochFallbackWarning) inside the store
        fallback = store.load_newest_verified()
        if fallback is not None:
            image = restore_world(fallback).image
    user_on_running = run_kw.pop("on_running", None)
    prev_detect = [0.0]   # monotonic time the previous failure was detected

    def on_running(server):
        # recovery latency: failure detection -> restarted world running
        if prev_detect[0]:
            failures[-1]["recovery_s"] = round(
                time.monotonic() - prev_detect[0], 4)
            prev_detect[0] = 0.0
        if user_on_running is not None:
            user_on_running(server)

    last_failure: Optional[RankFailure] = None
    n_attempt = n
    for attempt in range(max_restarts + 1):
        transport = names[attempt % len(names)]
        if capacity_for_attempt is not None:
            cap = capacity_for_attempt(attempt, last_failure)
            if cap is not None:
                n_attempt = max(1, int(cap))
        faults = faults_for_attempt(attempt) if faults_for_attempt else None
        if image is not None and (
                image.get("n_ranks") != n_attempt
                or (image.get("remap") or {}).get("n_to",
                                                  n_attempt) != n_attempt):
            # elastic relaunch: record the plan INTO the image so every
            # restore path downstream (fn closures, log_dir replays)
            # sees the same remapping; also overwrites a stale remap
            # left by a previous attempt at a different size
            image = RestorePlan.for_image(image, n_attempt,
                                          transport).attach(image)
        fn = fn_factory(attempt, image)
        try:
            res = run_world(transport, n_attempt, fn, faults=faults,
                            store=store, retain_epochs=retain_epochs,
                            on_running=on_running, **run_kw)
            return SupervisedRun(res, attempt + 1, failures, transport,
                                 image, final_n=n_attempt)
        except RankFailure as rf:
            last_failure = rf
            prev_detect[0] = rf.detected_at
            record = {"attempt": attempt, "transport": transport,
                      "n": n_attempt, "failed_ranks": rf.ranks,
                      "image_epoch": None if rf.committed_image is None
                      else rf.committed_image["epoch"]}
            if rf.committed_image is not None and (
                    store is None or _image_restorable(rf.committed_image)):
                # normalize through the one public restore entrypoint
                # (container round trip; see the docstring)
                image = restore_world(rf.committed_image).image
            elif store is not None and (rf.committed_image is not None
                                        or image is None):
                # the in-RAM image fails digest/chain verification (or
                # nothing was committed this attempt and we hold no
                # earlier image): fall back to the newest VERIFIED
                # store epoch instead of failing the restart —
                # graceful degradation a generation back
                from repro_torch.core.image_store import EpochFallbackWarning
                if rf.committed_image is not None:
                    warnings.warn(
                        "committed image for epoch "
                        f"{rf.committed_image.get('epoch')} failed "
                        "verification; falling back to the image store",
                        EpochFallbackWarning, stacklevel=2)
                fallback = store.load_newest_verified()
                if fallback is not None:
                    image = restore_world(fallback).image
                    record["image_epoch"] = fallback.get("epoch")
            if elastic:
                # relaunch with the survivors; capacity_for_attempt may
                # still grow the next attempt back
                n_attempt = max(1, n_attempt - len(rf.ranks))
            failures.append(record)
            if log_dir:
                with open(os.path.join(log_dir,
                                       f"attempt_{attempt:03d}.json"),
                          "w") as f:
                    json.dump({**record,
                               "partial_result_ranks":
                                   sorted(rf.partial_results)}, f, indent=1)
                if image is not None:
                    # atomic retire: write-to-tmp + fsync + rename so a
                    # launcher crash mid-write can never leave a torn
                    # image (same idiom as CheckpointManager._write)
                    dst = os.path.join(log_dir, "last_image.bin")
                    tmp = dst + ".tmp"
                    with open(tmp, "wb") as f:
                        f.write(image_to_bytes(image))
                        f.flush()
                        os.fsync(f.fileno())
                    os.replace(tmp, dst)
    assert last_failure is not None
    raise last_failure
