"""Background snapshot writers: the async half of the 2PC split.

The synchronous protocol serializes, delta-encodes, ships the `snap`
blob and waits out the commit round INSIDE the safe point — every rank
stalls for the slowest writer in the world.  The async pipeline stages
the snapshot at the cut (cheap: capture values, nothing leaves the
rank) and hands the expensive tail — `produce()` (serialization +
delta-encoding) and the launcher-side upload — to a background writer,
so ranks return to compute immediately.  The coordinator's commit is
gated on each rank's WRITER ACK (`repro_torch.core.coordinator.writer_ack`),
which preserves the committed-image invariant: an epoch only becomes
restartable once every rank's blob is durably at the launcher.

Two implementations behind one `submit(epoch, produce, on_done)` API:

  `ThreadSnapshotWriter` — one daemon worker thread per rank; the
      right shape for the `inproc` backend (ranks are threads already)
      and any platform without fork.
  `ForkSnapshotWriter`  — `os.fork()` per checkpoint, issued from the
      worker thread (never from the safe point: on core-starved hosts
      a fork costs more than the encode, and it must not sit in the
      post-drain stall window); the right shape for the `socket`
      backend (one OS process per rank), where the encode burns a
      separate core instead of fighting the rank's GIL.  The child
      runs `produce()` only — the writer contract requires produce to
      be a PURE closure over state captured at staging time, so a
      child process sees exactly the cut.  It must not touch the
      rank's endpoint or any lock another thread might hold at fork
      time; the pickled blob comes back over a pipe and `on_done`
      ships + acks parent-side.

`on_done(epoch, ok, payload)` always runs in the RANK process (the
writer's worker thread), where the endpoint lives: payload is the
produced blob on success (None if produce returned None) or the
formatted traceback on failure.

`MANA_SNAPSHOT_WRITER=thread|fork` overrides the per-backend default —
e.g. force the thread writer on hosts where fork is pathologically
expensive (tiny containers, gVisor-style sandboxes).
"""
from __future__ import annotations

import os
import pickle
import queue
import threading
import traceback
from typing import Callable, Dict, Optional

OnDone = Callable[[int, bool, Optional[object]], None]


class SnapshotWriter:
    """Interface: run `produce` off the critical path, then `on_done`."""

    def submit(self, epoch: int, produce: Callable[[], Optional[Dict]],
               on_done: OnDone) -> None:
        raise NotImplementedError

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until every submitted job has completed (its on_done
        returned).  True if drained within the timeout."""
        raise NotImplementedError

    def close(self, timeout: float = 30.0) -> None:
        """Drain pending jobs and release resources.  Idempotent."""
        self.wait(timeout)


def _run_job(epoch: int, produce, on_done: OnDone) -> None:
    try:
        payload = produce()
        ok = True
    except Exception:  # noqa: BLE001 — failure becomes a writer NACK
        ok, payload = False, traceback.format_exc()
    try:
        on_done(epoch, ok, payload)
    except Exception:  # noqa: BLE001 — endpoint torn down mid-flight
        pass  # (world dying): drop like a NIC, keep accounting sane


class ThreadSnapshotWriter(SnapshotWriter):
    """Single background worker thread draining a job queue in order."""

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()
        self._inflight = 0
        self._cv = threading.Condition()
        self._thread: Optional[threading.Thread] = None

    def _loop(self) -> None:
        while True:
            job = self._q.get()
            if job is None:
                return
            _run_job(*job)
            with self._cv:
                self._inflight -= 1
                self._cv.notify_all()

    def submit(self, epoch, produce, on_done):
        with self._cv:
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, daemon=True, name="snapshot-writer")
                self._thread.start()
            self._inflight += 1
        self._q.put((epoch, produce, on_done))

    def wait(self, timeout=None):
        with self._cv:
            return self._cv.wait_for(lambda: self._inflight == 0,
                                     timeout=timeout)

    def close(self, timeout: float = 30.0) -> None:
        self.wait(timeout)
        if self._thread is not None:
            self._q.put(None)
            self._thread.join(timeout=5.0)
            self._thread = None


class ForkSnapshotWriter(ThreadSnapshotWriter):
    """One forked child per checkpoint; blob pickled back over a pipe.

    `submit` is a queue append — the rank returns to compute without
    even paying the fork (on core-starved or sandboxed hosts a fork of
    a large process costs more than the encode itself, and it must not
    sit in the post-drain stall window).  The writer's worker thread
    forks; the child runs `produce()` only — by the writer contract it
    is a PURE closure over state captured at staging time (e.g.
    `IncrementalSnapshotter.stage`), so running it later and in a child
    process is equivalent to running it at the cut.  The child must not
    touch the rank's endpoint (its fds are shared with the parent);
    `on_done` runs parent-side on the worker thread.
    """

    def _loop(self) -> None:  # worker thread: fork + collect per job
        while True:
            job = self._q.get()
            if job is None:
                return
            self._fork_job(*job)
            with self._cv:
                self._inflight -= 1
                self._cv.notify_all()

    def _fork_job(self, epoch: int, produce, on_done: OnDone) -> None:
        r, w = os.pipe()
        pid = os.fork()
        if pid == 0:  # child: produce, pipe, vanish
            os.close(r)
            try:
                try:
                    payload = pickle.dumps((True, produce()))
                except Exception:  # noqa: BLE001 — NACK via the pipe
                    payload = pickle.dumps((False, traceback.format_exc()))
                off = 0
                while off < len(payload):
                    off += os.write(w, payload[off:off + (1 << 16)])
                os.close(w)
            finally:
                os._exit(0)
        os.close(w)
        chunks = []
        while True:
            chunk = os.read(r, 1 << 16)
            if not chunk:
                break
            chunks.append(chunk)
        os.close(r)
        os.waitpid(pid, 0)
        try:
            ok, payload = pickle.loads(b"".join(chunks))
        except Exception:  # noqa: BLE001 — child died mid-write
            ok, payload = False, ("snapshot writer child died before "
                                  "delivering its blob")
        try:
            on_done(epoch, ok, payload)
        except Exception:  # noqa: BLE001 — endpoint torn down
            pass


def make_snapshot_writer(transport_name: str) -> SnapshotWriter:
    """Writer for a backend: forked writer for one-process-per-rank
    backends ("socket"), a thread for shared-process backends — and as
    the universal fallback on platforms without fork.  The
    MANA_SNAPSHOT_WRITER env var ("thread" | "fork") overrides."""
    kind = os.environ.get("MANA_SNAPSHOT_WRITER")
    if kind == "thread":
        return ThreadSnapshotWriter()
    if kind == "fork" and hasattr(os, "fork"):
        return ForkSnapshotWriter()
    if transport_name == "socket" and hasattr(os, "fork"):
        return ForkSnapshotWriter()
    return ThreadSnapshotWriter()
