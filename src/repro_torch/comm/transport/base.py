"""Transport abstraction: the network-agnostic substrate of the fabric.

MANA-2.0's headline claim is that the checkpointing layer is
*network-agnostic*: the lower half (the real network) is rebuilt from
scratch at restart, so a checkpoint written over one interconnect can be
restored over another.  This package reproduces that split for the
simulated fabric:

  * `Transport` (here) is the substrate interface: it routes a
    `Message` to the destination rank's endpoint, wherever that rank
    lives (a thread in this process, another OS process, in principle
    another host).
  * `Endpoint` (here) is the rank-facing API — send/recv/irecv/iprobe,
    §III-B byte counters, drain buffer, virtual-time clock.  It is
    IDENTICAL across backends: all matching semantics (indexed
    (src, tag) FIFO claims, wildcard recv, iprobe visibility, the
    irecv eager-claim subtlety) live in the endpoint's local store, so
    a backend only has to move bytes.
  * backends register under a name (`repro_torch.comm.transport.get_transport`):
      "inproc" — every rank is a thread in one process; delivery is a
                 direct enqueue under the destination's condition
                 variable (the original `Fabric`, reference semantics).
      "socket" — every rank is an OS process speaking length-prefixed
                 frames over loopback TCP through a rendezvous switch —
                 escaping the GIL so multi-rank runs get real
                 parallelism.

Reserved control-plane tags
---------------------------
Collectives encode (gid, seq) into negative tags no smaller than
``-(1 << 40)`` (see `repro_torch.comm.collectives._next_tag`).  Tags at or
below ``CTRL_BASE = -(1 << 41)`` are reserved for the coordinator wire
protocol (`repro_torch.core.control`) and the world harness:

  TAG_CTRL    rank -> coordinator requests and coordinator -> rank
              replies (pickled dicts, one blocking request in flight
              per rank)
  TAG_INTENT  coordinator -> rank checkpoint-intent pushes (the wire
              analogue of the §III-I shared intent_epoch flag)
  TAG_RESULT  rank -> launcher result envelopes (world harness)

Control traffic is exempt from the §III-B byte counters (it is not
application state) and from the virtual-time occupancy model (the
paper's control plane is O(1) and off the critical path), and the
destination-side store gives ctrl tags an any-source index so a
coordinator can serve requests from every rank through one endpoint.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# -- reserved control-plane tag space (see module docstring) ---------------
CTRL_BASE = -(1 << 41)
TAG_CTRL = CTRL_BASE - 1
TAG_INTENT = CTRL_BASE - 2
TAG_RESULT = CTRL_BASE - 3


def is_ctrl_tag(tag: int) -> bool:
    return tag <= CTRL_BASE


class TransportClosed(RuntimeError):
    """Raised out of blocking endpoint operations after the endpoint is
    poisoned — the harness's way of promptly unwinding rank threads
    that would otherwise block forever on messages from a dead peer."""


@dataclass
class Message:
    src: int
    dst: int
    tag: int
    payload: bytes
    # set once when some index hands the message out; other indexes that
    # still hold a reference skip it lazily
    consumed: bool = field(default=False, repr=False, compare=False)
    # sender's virtual-time stamp (occupancy model; see Transport)
    vtime: float = field(default=0.0, repr=False, compare=False)

    @property
    def nbytes(self) -> int:
        return len(self.payload)


class _IndexedStore:
    """(src, tag)-indexed message store.

    Three indexes (a message lives in several at once; a claim through
    one marks it consumed and the others discard it lazily):

      * per-(src, tag) FIFO deque — exact-tag claim/iprobe are O(1)
        amortized;
      * per-src FIFO of application messages (tag >= 0) — wildcard
        recv, iprobe(src) and checkpoint drain_one(src) are O(1);
      * per-tag FIFO for CONTROL tags only (tag <= CTRL_BASE) — the
        coordinator's any-source recv; app traffic never pays for it.

    Plus a per-src live-byte counter so queued_bytes_from() is O(1)
    (it sits inside the §III-B drain loop).

    Not thread-safe by itself — the owner serializes access (Endpoint
    uses its own lock for the network store; the drain buffer is only
    touched by its own rank's thread).
    """

    def __init__(self):
        self._by_src_tag: Dict[Tuple[int, int], deque] = {}
        self._app_by_src: Dict[int, deque] = {}   # tag >= 0 only
        self._ctrl_by_tag: Dict[int, deque] = {}  # tag <= CTRL_BASE only
        self._app_bytes: Dict[int, int] = {}
        self._order: deque = deque()              # arrival order (lazy)
        self._live = 0

    def __len__(self) -> int:
        return self._live

    def __iter__(self):
        return iter([m for m in self._order if not m.consumed])

    def add(self, msg: Message) -> None:
        self._by_src_tag.setdefault((msg.src, msg.tag), deque()).append(msg)
        if msg.tag >= 0:
            self._app_by_src.setdefault(msg.src, deque()).append(msg)
            self._app_bytes[msg.src] = (self._app_bytes.get(msg.src, 0)
                                        + msg.nbytes)
        elif is_ctrl_tag(msg.tag):
            self._ctrl_by_tag.setdefault(msg.tag, deque()).append(msg)
        self._order.append(msg)
        self._live += 1

    def app_bytes(self, src: int) -> int:
        return self._app_bytes.get(src, 0)

    @staticmethod
    def _prune(q: Optional[deque]) -> Optional[deque]:
        """Drop consumed messages off the head; empty deques are falsy."""
        while q and q[0].consumed:
            q.popleft()
        return q

    def _pop_live(self, index: Dict, key) -> Optional[Message]:
        q = index.get(key)
        msg = None
        while q:
            m = q.popleft()
            if not m.consumed:
                msg = m
                break
        if q is not None and not q:
            del index[key]  # tags are per-collective-call: reap dead keys
        return msg

    def claim(self, src: Optional[int], tag: Optional[int]) -> Optional[Message]:
        """Claim the oldest matching live message.

        tag=None is the app-level wildcard: it matches tag >= 0 only,
        never protocol traffic (collectives always address messages
        with explicit tags).  src=None is the CONTROL-plane any-source
        match and requires a ctrl tag — it is how the coordinator
        endpoint serves requests from every rank.
        """
        if src is None:
            assert tag is not None and is_ctrl_tag(tag), \
                "any-source claim is control-plane only"
            msg = self._pop_live(self._ctrl_by_tag, tag)
        elif tag is None:
            msg = self._pop_live(self._app_by_src, src)
        else:
            msg = self._pop_live(self._by_src_tag, (src, tag))
        if msg is None:
            return None
        msg.consumed = True
        if msg.tag >= 0:
            self._app_bytes[msg.src] -= msg.nbytes
        self._live -= 1
        # amortized compaction: a message claimed through one index stays
        # consumed in the OTHER indexes (and in _order) until either it
        # surfaces at a deque head or this rebuild filters it out — both
        # must be swept or memory grows with total messages ever received
        if len(self._order) > 64 and self._live * 2 < len(self._order):
            self._order = deque(m for m in self._order if not m.consumed)
            for index in (self._by_src_tag, self._app_by_src,
                          self._ctrl_by_tag):
                for key, q in list(index.items()):
                    live_q = deque(m for m in q if not m.consumed)
                    if live_q:
                        index[key] = live_q
                    else:
                        del index[key]
        return msg

    def peek(self, src: Optional[int], tag: Optional[int]) -> bool:
        """iprobe support: is a live matching message present?"""
        if src is None:
            return bool(self._prune(self._ctrl_by_tag.get(tag)))
        if tag is None:
            return bool(self._prune(self._app_by_src.get(src)))
        return bool(self._prune(self._by_src_tag.get((src, tag))))


class _DrainBuffer(_IndexedStore):
    """Indexed drain buffer that still iterates in arrival order for
    checkpoint serialization (`RankAgent.serialize`) and byte sums."""

    def append(self, msg: Message) -> None:
        self.add(msg)


class _IrecvRequest:
    """A pending nonblocking receive; may claim a queued message eagerly."""

    def __init__(self, endpoint: "Endpoint", src: int, tag: Optional[int]):
        self.endpoint = endpoint
        self.src = src
        self.tag = tag
        self.message: Optional[Message] = None
        self.consumed = False

    def try_complete(self) -> bool:
        if self.message is not None:
            return True
        msg = self.endpoint._claim(self.src, self.tag)
        if msg is not None:
            self.message = msg
            return True
        return False


class _CompletedSend:
    def try_complete(self) -> bool:
        return True


class Transport:
    """Substrate interface: route messages between rank endpoints.

    A backend provides `route(msg)` — deliver `msg` to `msg.dst`'s
    endpoint, wherever that rank lives.  Everything else (matching,
    counters, occupancy, drain) is shared `Endpoint` logic.

    msg_cost_us > 0 enables the LogP-style VIRTUAL-TIME occupancy model:
    each endpoint carries a logical clock (`Endpoint.vclock`, seconds).
    A send advances the sender's clock by the cost and stamps the
    message; a network receive advances the receiver's clock to
    max(own clock, message stamp) + cost.  `max(ep.vclock)` after a run
    is the simulated completion time — the critical path through
    per-endpoint serial occupancy, which is exactly the serial root
    fan-out / O(ranks) drain cost MANA-2.0 is designed around and which
    zero-cost wall-clock timing on a GIL-bound host cannot expose.
    Virtual latencies are DETERMINISTIC whenever receives name their
    source (collectives always do), which is what makes benchmark
    numbers comparable across machines, and — because the model rides
    in the transport-agnostic Endpoint — across BACKENDS.
    Control-plane traffic (ctrl tags) is occupancy-exempt.
    """

    name = "abstract"

    def __init__(self, n_ranks: int, msg_cost_us: float = 0.0,
                 fault_plan=None):
        self.n_ranks = n_ranks
        self.msg_cost_s = msg_cost_us * 1e-6
        # deterministic fault injection (repro_torch.comm.transport.faults);
        # None = no faults.  Consulted by Endpoint.send for app traffic.
        self.fault_plan = fault_plan

    # the coordinator endpoint's rank id (one past the app world)
    @property
    def coord_rank(self) -> int:
        return self.n_ranks

    def route(self, msg: Message) -> None:
        raise NotImplementedError

    def close(self) -> None:
        """Tear down backend resources (sockets, threads).  Idempotent."""


class Endpoint:
    """Rank-facing fabric API, shared by every transport backend.

    Semantics mirror MPI + the paper's bookkeeping needs:
      * send() is buffered-asynchronous (message is routed to the
        destination's store immediately; "in the network" = enqueued
        but not yet recv'd);
      * per-(src,dst) BYTE COUNTERS are updated at send/recv time — the
        small-grain counters of §III-B;
      * irecv() eagerly claims a matching message if one is queued
        (moving it out of iprobe's sight) — reproducing the exact
        Iprobe-miss subtlety §III-B has to handle;
      * a drain_buffer holds messages drained by the checkpoint
        protocol; app recv() consults it first after restart.
    """

    def __init__(self, transport: Transport, rank: int):
        self.transport = transport
        self.rank = rank
        n = transport.n_ranks
        # §III-B: per-pair byte counters, kept by the wrappers at runtime
        self.sent_bytes = [0] * n
        self.recvd_bytes = [0] * n
        # messages drained by the checkpoint protocol, re-delivered post-restart
        self.drain_buffer = _DrainBuffer()
        self.pending_irecvs: List[_IrecvRequest] = []
        self.vclock = 0.0  # virtual-time occupancy clock (see Transport)
        self.coll_seq: Dict[int, int] = {}  # per-gid collective seq (upper half)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._store = _IndexedStore()
        # fault injection (see Transport.fault_plan): app-send sequence
        # number (the deterministic per-message fault key) and the
        # delayed-delivery worker (created on the first delayed send)
        self._send_seq = 0
        self._fault_q: Optional[deque] = None
        self._fault_cv = threading.Condition()
        self._fault_stop = False
        self._poisoned: Optional[str] = None

    @property
    def fabric(self) -> Transport:
        """Back-compat alias: pre-transport code reached the shared
        `Fabric` through `ep.fabric` (n_ranks, msg_cost_s)."""
        return self.transport

    # ---- inbound (called by the transport) ---------------------------------
    def enqueue(self, msg: Message) -> None:
        """Deliver an arriving message into the local store (the
        backend's receive path: a direct call for inproc, the socket
        reader thread for tcp)."""
        with self._cv:
            self._store.add(msg)
            self._cv.notify_all()

    # ---- send side ---------------------------------------------------------
    def send(self, dst: int, payload: bytes, tag: int = 0) -> None:
        """Buffered send (the Isend-with-immediate-completion model).

        Fault injection acts here, at the backend-agnostic boundary:
        control-plane traffic is exempt and does not advance the fault
        sequence number (its volume is timing-dependent, and counting
        it would break cross-run determinism of the fault schedule).
        """
        plan = self.transport.fault_plan
        faulted = plan is not None and not is_ctrl_tag(tag)
        if faulted:
            # the kill fires BEFORE counters: the message never left
            plan.check_kill_send(self.rank, self._send_seq)
        msg = Message(self.rank, dst, tag, payload)
        if tag >= 0:  # internal/protocol traffic (tag<0) is not app state
            self.sent_bytes[dst] += msg.nbytes
        if self.transport.msg_cost_s and not is_ctrl_tag(tag):
            # sender-side occupancy; stamp BEFORE delivery so the
            # receiver's clock advance observes it
            self.vclock += self.transport.msg_cost_s
            msg.vtime = self.vclock
        if not faulted:
            self.transport.route(msg)
            return
        decision = plan.decide(self.rank, dst, tag, self._send_seq)
        self._send_seq += 1
        if decision.action == "drop":
            return  # accounted but never delivered (lost on the wire)
        if decision.action == "delay" or self._fault_q is not None:
            # once a delay worker exists, ALL later sends go through it:
            # a delayed message blocks the sender's subsequent traffic
            # behind it (an in-order slow link), preserving per-sender
            # FIFO — the fabric contract is delay-invariant
            self._fault_enqueue(msg, decision.delay_s,
                                dup=decision.action == "dup")
            return
        self.transport.route(msg)
        if decision.action == "dup":
            self.transport.route(self._dup(msg))

    @staticmethod
    def _dup(msg: Message) -> Message:
        # a fresh instance: indexes track consumption per-object, so a
        # duplicate must not share the original's `consumed` flag
        m = Message(msg.src, msg.dst, msg.tag, msg.payload)
        m.vtime = msg.vtime
        return m

    # ---- delayed delivery (fault injection) --------------------------------
    def _fault_enqueue(self, msg: Message, delay_s: float, dup: bool) -> None:
        with self._fault_cv:
            if self._fault_q is None:
                self._fault_q = deque()
                threading.Thread(target=self._fault_loop, daemon=True,
                                 name=f"fault-delay-r{self.rank}").start()
            self._fault_q.append((time.monotonic() + delay_s, msg, dup))
            self._fault_cv.notify()

    def _fault_loop(self) -> None:
        while True:
            with self._fault_cv:
                while not self._fault_q and not self._fault_stop:
                    self._fault_cv.wait(0.25)
                if not self._fault_q:
                    return  # stopped and drained
                release, msg, dup = self._fault_q[0]
                wait = release - time.monotonic()
                if wait > 0 and not self._fault_stop:
                    self._fault_cv.wait(min(wait, 0.25))
                    continue
                self._fault_q.popleft()
            try:
                self.transport.route(msg)
                if dup:
                    self.transport.route(self._dup(msg))
            except (OSError, RuntimeError):
                return  # backend torn down mid-flight; drop like a NIC

    def stop_faults(self) -> None:
        """Flush and stop the delayed-delivery worker (world teardown)."""
        with self._fault_cv:
            self._fault_stop = True
            self._fault_cv.notify_all()

    # ---- failure teardown ---------------------------------------------------
    @property
    def poisoned(self) -> Optional[str]:
        return self._poisoned

    def poison(self, reason: str) -> None:
        """Make every blocked/future recv raise `TransportClosed` — the
        harness calls this on surviving ranks after a peer failure so
        they unwind promptly instead of waiting out their timeouts."""
        with self._cv:
            self._poisoned = reason
            self._cv.notify_all()
        self.stop_faults()

    def isend(self, dst: int, payload: bytes, tag: int = 0):
        self.send(dst, payload, tag)
        return _CompletedSend()

    # ---- receive side -------------------------------------------------------
    def _claim(self, src: Optional[int], tag: Optional[int]) -> Optional[Message]:
        """Claim a matching message from the drain buffer (already counted
        at drain time) or the network store (counted here)."""
        msg = self.drain_buffer.claim(src, tag)
        if msg is not None:
            return msg
        with self._lock:
            msg = self._store.claim(src, tag)
            if msg is not None and msg.tag >= 0:
                self.recvd_bytes[msg.src] += msg.nbytes
        if (msg is not None and self.transport.msg_cost_s
                and not is_ctrl_tag(msg.tag)):
            self._vreceive(msg)
        return msg

    def _vreceive(self, msg: Message) -> None:
        """Receiver-side occupancy: the message cannot complete before
        the sender stamped it, and draining it occupies this endpoint."""
        self.vclock = max(self.vclock, msg.vtime) + self.transport.msg_cost_s

    def recv(self, src: Optional[int], tag: Optional[int] = None,
             timeout: Optional[float] = None) -> Message:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            msg = self.drain_buffer.claim(src, tag)
            if msg is not None:
                return msg  # occupancy was already paid at drain time
            if self._poisoned is not None:
                raise TransportClosed(
                    f"rank {self.rank}: {self._poisoned}")
            with self._cv:
                # claim and wait under ONE lock hold: enqueue() notifies
                # under the same lock, so a message landing between a
                # failed claim and the wait cannot be missed (the old
                # claim-then-wait pattern lost that race and fell back
                # on a 10ms poll — the dominant cost at 64+ ranks)
                msg = self._store.claim(src, tag)
                if msg is not None:
                    if msg.tag >= 0:
                        self.recvd_bytes[msg.src] += msg.nbytes
                else:
                    remaining = (None if deadline is None
                                 else deadline - time.monotonic())
                    if remaining is not None and remaining <= 0:
                        raise TimeoutError(
                            f"rank {self.rank} recv from {src} timed out")
                    # 0.25s safety cap only; wakeups are event-driven
                    self._cv.wait(timeout=0.25 if remaining is None
                                  else min(0.25, remaining))
            if msg is not None:
                if self.transport.msg_cost_s and not is_ctrl_tag(msg.tag):
                    self._vreceive(msg)
                return msg

    def irecv(self, src: int, tag: Optional[int] = None) -> _IrecvRequest:
        req = _IrecvRequest(self, src, tag)
        req.try_complete()   # eager claim — creates the Iprobe-miss case
        self.pending_irecvs.append(req)
        return req

    def iprobe(self, src: int, tag: Optional[int] = None) -> bool:
        if tag is not None and tag < 0:
            # iprobe is an APP-level operation: protocol traffic is invisible
            return False
        with self._lock:
            return self._store.peek(src, tag)

    # ---- drain support (§III-B) ---------------------------------------------
    def queued_bytes_from(self, src: int) -> int:
        with self._lock:
            return self._store.app_bytes(src)

    def drain_one(self, src: int) -> Optional[Message]:
        """Checkpoint-time drain: pull an app message out of the network
        into the drain buffer (re-delivered to the app on restart)."""
        with self._lock:
            msg = self._store.claim(src, None)
        if msg is not None:
            if self.transport.msg_cost_s:
                self._vreceive(msg)  # a drain IS a receive
            self.recvd_bytes[src] += msg.nbytes
            # fresh copy: the network store still holds lazy references to
            # the claimed instance and relies on its `consumed` flag
            msg = Message(msg.src, msg.dst, msg.tag, msg.payload)
            self.drain_buffer.append(msg)
        return msg

    def gc_pending_irecvs(self) -> None:
        self.pending_irecvs = [r for r in self.pending_irecvs if not r.consumed]
