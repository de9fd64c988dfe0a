"""Socket transport backend ("socket"): one OS process per rank over
loopback TCP.

Escapes the GIL — each rank is a real process, so multi-rank runs get
real parallelism — while keeping the exact fabric semantics: matching,
byte counters, drain and the `msg_cost_us` virtual-time model all live
in the shared `Endpoint`, and messages cross process boundaries as
length-prefixed frames.

Topology: a star through a rendezvous SWITCH rather than an O(n^2)
connection mesh.  The switch is the world bootstrap point (its address
is the only thing a rank needs to join the job — the "rendezvous
server"), and it forwards frames between ranks:

    rank process                switch (launcher process)
    ------------                -------------------------
    SocketTransport --HELLO r--> register conn[r], ack version,
                                 flush any frames queued for r
    Endpoint.send -> frame ----> look up conn[msg.dst] ---> dst's
                                 (queue if not joined yet)   reader
                                                             thread
                                                             enqueues
                                                             into the
                                                             local
                                                             indexed
                                                             store

Wire frame format v2 (the default; normative spec in docs/PROTOCOL.md,
kept in lockstep by docs/check_docs_drift.py against FRAME_V2_LAYOUT):

    u32 len | u32 dst | u32 src | s64 tag | f64 vtime | payload bytes

One struct-packed 28-byte header and the payload verbatim — the send
side writes both in a single vectored syscall (`sendmsg`: the payload
is never copied into a frame buffer), the receive side reads into a
reusable buffer with `recv_into`, and the switch routes on the
fixed-offset `dst` without touching the payload.  Pickle survives only
INSIDE control-plane payloads (ctrl-tag dicts, the HELLO) — app
payloads are raw application bytes end to end.  The `vtime` stamp
crosses the wire so the virtual-time occupancy model stays
deterministic across backends.

The HELLO negotiates the wire version: the client announces its
version, the switch acks with its own, and a mismatch raises loudly at
connect time on BOTH sides instead of corrupting frames.  Setting
``MANA_WIRE_V1=1`` forces the legacy v1 framing (`u32 len | u32 dst |
pickle((src, tag, vtime, payload))`) — an escape hatch only, logged as
deprecated, exercised by one CI matrix cell until removal.

The coordinator joins the same switch as rank ``n_ranks`` (one past the
app world) — the control plane is wire-only, exactly like any other
peer (see `repro_torch.core.control`).
"""
from __future__ import annotations

import os
import pickle
import socket
import struct
import sys
import threading
import time
from collections import defaultdict
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

from repro_torch.comm.transport.base import TAG_CTRL, Endpoint, Message, Transport

_LEN = struct.Struct(">I")
_DST = struct.Struct(">I")
# v2 frame body (everything after the u32 length prefix): routing +
# matching metadata at fixed offsets, payload verbatim behind it
_V2_BODY = struct.Struct(">IIqd")          # dst, src, tag, vtime
# full v2 header, length prefix included — packed in ONE struct call on
# the send path so a frame is exactly (header, payload)
_V2_HEAD = struct.Struct(">IIIqd")         # len, dst, src, tag, vtime

WIRE_VERSION = 2
# normative byte-level layout of a v2 frame; docs/check_docs_drift.py
# diffs docs/PROTOCOL.md's frame table against THIS tuple
FRAME_V2_LAYOUT = (
    ("len", 4, "u32", "byte length of the frame after this field"),
    ("dst", 4, "u32", "destination rank (switch routes on this "
                      "fixed offset, payload untouched)"),
    ("src", 4, "u32", "source rank"),
    ("tag", 8, "s64", "message tag (ctrl tags are large negative)"),
    ("vtime", 8, "f64", "sender's virtual-time stamp (occupancy model)"),
    ("payload", None, "raw", "application bytes verbatim (ctrl tags: "
                             "pickled dict)"),
)

_warned_v1 = False


def default_wire_version() -> int:
    """The process-wide wire version: 2 unless the deprecated
    MANA_WIRE_V1=1 escape hatch is set."""
    global _warned_v1
    if os.environ.get("MANA_WIRE_V1") == "1":
        if not _warned_v1:
            _warned_v1 = True
            print("MANA_WIRE_V1=1: wire frame v1 (pickled tuples) is "
                  "DEPRECATED and will be removed; v2 binary framing "
                  "is the default", file=sys.stderr)
        return 1
    return WIRE_VERSION


class WireFormatError(RuntimeError):
    """A frame that cannot be parsed under the negotiated wire version
    (truncated header, garbage bytes).  Typed so transport fuzzing
    never surfaces a raw struct/pickle traceback."""


# ---------------------------------------------------------------------------
# frame I/O
# ---------------------------------------------------------------------------

def _sendv(sock: socket.socket, hdr: bytes, payload: bytes = b"") -> None:
    """Write header + payload as ONE vectored syscall (`sendmsg`): the
    payload crosses into the kernel straight from the caller's buffer,
    never copied into a frame buffer.  Falls back to a concatenating
    sendall where sendmsg is unavailable."""
    if not payload:
        sock.sendall(hdr)
        return
    if not hasattr(sock, "sendmsg"):
        sock.sendall(hdr + payload)
        return
    sent = sock.sendmsg((hdr, payload))
    total = len(hdr) + len(payload)
    while sent < total:  # partial vectored write: finish the tail
        if sent < len(hdr):
            sent += sock.sendmsg((memoryview(hdr)[sent:], payload))
        else:
            sent += sock.send(memoryview(payload)[sent - len(hdr):])


def _send_frame(sock: socket.socket, blob) -> None:
    """Length-prefix + body in one vectored write (the switch's forward
    path and every v1/bootstrap frame)."""
    _sendv(sock, _LEN.pack(len(blob)), blob)


class _FrameReader:
    """Per-connection frame reader with a REUSABLE receive buffer:
    header and body land via `recv_into` (no per-chunk allocations, no
    accumulate-then-join copies); `next_frame` hands out a memoryview
    of the body, valid until the next call — callers that keep a frame
    (the switch's forward queue) take their own bytes() copy."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._hdr = bytearray(_LEN.size)
        self._buf = bytearray(1 << 16)

    def _fill(self, view: memoryview) -> bool:
        got = 0
        while got < len(view):
            n = self._sock.recv_into(view[got:])
            if n == 0:
                return False  # peer closed
            got += n
        return True

    def next_frame(self) -> Optional[memoryview]:
        if not self._fill(memoryview(self._hdr)):
            return None
        n = _LEN.unpack_from(self._hdr)[0]
        if n > len(self._buf):
            self._buf = bytearray(max(n, 2 * len(self._buf)))
        view = memoryview(self._buf)[:n]
        if not self._fill(view):
            return None
        return view


# ---------------------------------------------------------------------------
# frame codecs (v2 default; v1 behind MANA_WIRE_V1)
# ---------------------------------------------------------------------------

def _encode_v1(msg: Message) -> bytes:
    return (_DST.pack(msg.dst)
            + pickle.dumps((msg.src, msg.tag, msg.vtime, msg.payload)))


def _decode_v1(blob) -> Message:
    try:
        dst = _DST.unpack_from(blob)[0]
        src, tag, vtime, payload = pickle.loads(memoryview(blob)[_DST.size:])
    except Exception as e:  # noqa: BLE001 — malformed v1 frame
        raise WireFormatError(f"undecodable v1 frame: {e}") from e
    m = Message(src, dst, tag, payload)
    m.vtime = vtime
    return m


def _decode_v2(blob) -> Message:
    """v2 frame body -> Message: struct header + payload slice.  The
    single bytes() is the one copy the receive path pays — the Message
    must own its payload beyond the reader's reusable buffer."""
    if len(blob) < _V2_BODY.size:
        raise WireFormatError(
            f"undecodable v2 frame: body {len(blob)} bytes, header "
            f"needs {_V2_BODY.size}")
    dst, src, tag, vtime = _V2_BODY.unpack_from(blob)
    m = Message(src, dst, tag, bytes(memoryview(blob)[_V2_BODY.size:]))
    m.vtime = vtime
    return m


def _decode(blob, version: int) -> Message:
    return _decode_v2(blob) if version == 2 else _decode_v1(blob)


def _frame_parts(msg: Message, version: int) -> Tuple[bytes, bytes]:
    """(header, payload) of one outbound frame.  v2 header packing is
    O(1) in the payload size — the `wire_codec_throughput` benchmark
    guards this against the v1 pickle path."""
    if version == 2:
        return (_V2_HEAD.pack(_V2_BODY.size + len(msg.payload), msg.dst,
                              msg.src, msg.tag, msg.vtime),
                msg.payload)
    blob = _encode_v1(msg)
    return _LEN.pack(len(blob)), blob


# pre-packed control frames: HELLO and the synthesized EOF notice are
# identical per (rank, version) for the life of the process, and the
# supervised/chaos paths rebuild worlds over the same ranks repeatedly
# — re-pickling them per connection was visible allocation churn in the
# switch serve loop at 256+ ranks.
@lru_cache(maxsize=4096)
def _hello_blob(rank: int, version: int) -> bytes:
    return pickle.dumps(("hello", rank, version))


@lru_cache(maxsize=4096)
def _eof_body(rank: int, coord_rank: int, version: int) -> bytes:
    msg = Message(rank, coord_rank, TAG_CTRL,
                  pickle.dumps({"op": "eof", "rank": rank}))
    hdr, payload = _frame_parts(msg, version)
    # body only (no length prefix): _forward length-prefixes uniformly
    return (hdr[_LEN.size:] + payload) if version == 2 else payload


class FabricSwitch:
    """Rendezvous + frame forwarding for one job (runs in the launcher).

    Accepts HELLO(rank, wire_version) registrations — acking each with
    its OWN wire version, so a version mismatch fails loudly on both
    sides at connect time — and forwards every subsequent frame to the
    destination rank's connection.  Frames addressed to a rank that has
    not joined yet are queued and flushed at its HELLO — so ranks may
    start (and send) in any order, which is the rendezvous half of the
    world bootstrap.

    FAILURE DETECTION: with `coord_rank` set, a rank connection closing
    makes the switch synthesize an `{"op": "eof"}` control frame from
    that rank to the coordinator endpoint.  Because the frame is
    forwarded on the coordinator's connection AFTER everything the rank
    sent while alive, the coordinator is guaranteed to observe a clean
    rank's goodbye (`{"op": "bye"}`) before its EOF — so a raw EOF
    without a goodbye is a crash, exactly like TCP FIN vs RST.  The
    coordinator's own connection never generates a notice.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 coord_rank: Optional[int] = None,
                 wire_version: Optional[int] = None):
        self.coord_rank = coord_rank
        self.wire_version = (wire_version if wire_version is not None
                             else default_wire_version())
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(1024)
        self.addr: Tuple[str, int] = self._listener.getsockname()
        self._conns: Dict[int, socket.socket] = {}
        self._wlocks: Dict[int, threading.Lock] = {}
        self._pending: Dict[int, List[bytes]] = defaultdict(list)
        self._departed: set = set()
        self._lock = threading.Lock()
        self._closed = False
        self._threads: List[threading.Thread] = []
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return  # listener closed
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _serve_conn(self, conn: socket.socket) -> None:
        reader = _FrameReader(conn)
        try:
            hello = reader.next_frame()
        except OSError:
            hello = None
        if hello is None:
            conn.close()
            return
        try:
            parts = pickle.loads(bytes(hello))
            kind, rank, peer_version = (parts if len(parts) == 3
                                        else (*parts, 1))
        except Exception as e:  # noqa: BLE001 — garbage bootstrap
            conn.close()
            raise WireFormatError(f"malformed HELLO: {e}") from e
        assert kind == "hello", f"expected HELLO, got {kind!r}"
        # version handshake: ack with OUR version either way — the
        # client raises the loud mismatch error; we just refuse to
        # register a peer that would corrupt every subsequent frame
        try:
            _send_frame(conn, pickle.dumps(("hello-ack",
                                            self.wire_version)))
        except OSError:
            conn.close()
            return
        if peer_version != self.wire_version:
            conn.close()
            print(f"switch: refused rank {rank}: speaks wire "
                  f"v{peer_version}, this switch is v{self.wire_version}",
                  file=sys.stderr)
            return
        # register and flush the pre-join backlog while HOLDING the new
        # connection's write lock (acquired inside the registry lock, so
        # no _forward can have it yet): a frame forwarded directly the
        # instant the conn becomes visible must not overtake queued
        # older frames from the same source, or the per-(src, tag) FIFO
        # contract breaks
        with self._lock:
            wlock = threading.Lock()
            wlock.acquire()
            self._conns[rank] = conn
            self._wlocks[rank] = wlock
            backlog = self._pending.pop(rank, [])
        try:
            for blob in backlog:
                try:
                    _send_frame(conn, blob)
                except OSError:
                    break
        finally:
            wlock.release()
        while True:
            try:
                view = reader.next_frame()
            except OSError:
                view = None  # connection reset: a crash is an EOF too
            if view is None:
                break  # rank exited (cleanly or not)
            # dst rides at a fixed offset in BOTH wire versions: route
            # without decoding — but the forward queue outlives the
            # reader's reusable buffer, so take the one owned copy here
            self._forward(_DST.unpack_from(view)[0], bytes(view))
        with self._lock:
            if self._conns.get(rank) is conn:
                del self._conns[rank]
                self._wlocks.pop(rank, None)
            # departed ranks take no more traffic: frames to them are
            # dropped like a real NIC's, not queued forever
            self._departed.add(rank)
            self._pending.pop(rank, None)
        conn.close()
        if (self.coord_rank is not None and rank != self.coord_rank
                and not self._closed):
            # EOF notice to the coordinator (see class docstring);
            # ordered after every frame the rank sent while alive.
            # Pre-packed per (rank, version) — see _eof_body.
            self._forward(self.coord_rank,
                          _eof_body(rank, self.coord_rank,
                                    self.wire_version))

    def _forward(self, dst: int, blob: bytes) -> None:
        with self._lock:
            conn = self._conns.get(dst)
            if conn is None:
                if not self._closed and dst not in self._departed:
                    self._pending[dst].append(blob)
                return
            wlock = self._wlocks[dst]
        try:
            with wlock:
                _send_frame(conn, blob)
        except OSError:
            pass  # destination went away mid-write; drop like a real NIC

    def close(self) -> None:
        self._closed = True
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            c.close()


class SocketTransport(Transport):
    """One rank's view of the socket fabric (runs in the rank's process).

    Owns exactly one local endpoint; `route` writes frames to the
    switch, and a reader thread enqueues inbound frames into the
    endpoint's indexed store.  Self-sends short-circuit locally (no
    wire round trip), matching inproc semantics bit for bit.
    """

    name = "socket"

    def __init__(self, n_ranks: int, rank: int, addr: Tuple[str, int],
                 msg_cost_us: float = 0.0, fault_plan=None,
                 wire_version: Optional[int] = None):
        super().__init__(n_ranks, msg_cost_us, fault_plan=fault_plan)
        self.rank = rank
        self.wire_version = (wire_version if wire_version is not None
                             else default_wire_version())
        self.endpoint = Endpoint(self, rank)
        if fault_plan is not None:
            # slow-joiner injection: HELLO (and the connect itself) is
            # late, so peers' frames queue at the switch pre-join
            hd = fault_plan.hello_delay(rank)
            if hd:
                time.sleep(hd)
        self._sock = socket.create_connection(addr, timeout=30)
        self._sock.settimeout(None)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._wlock = threading.Lock()
        self._reader_buf = _FrameReader(self._sock)
        with self._wlock:
            _send_frame(self._sock, _hello_blob(rank, self.wire_version))
        # HELLO ack: the switch's wire version, read synchronously
        # before any frame traffic — an old/new mismatch is a LOUD
        # connect-time error on both sides, never silent frame garbage
        ack = self._reader_buf.next_frame()
        if ack is None:
            raise WireFormatError(
                f"rank {rank}: switch closed during the HELLO handshake")
        kind, switch_version = pickle.loads(bytes(ack))
        assert kind == "hello-ack", f"expected hello-ack, got {kind!r}"
        if switch_version != self.wire_version:
            self._sock.close()
            raise WireFormatError(
                f"rank {rank}: wire version mismatch — switch speaks "
                f"v{switch_version}, this transport was configured for "
                f"v{self.wire_version} (MANA_WIRE_V1 set on one side "
                f"only?)")
        self._closed = False
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()

    def _read_loop(self) -> None:
        version = self.wire_version
        reader = self._reader_buf
        while True:
            try:
                view = reader.next_frame()
            except OSError:
                return
            if view is None:
                return  # switch closed
            self.endpoint.enqueue(_decode(view, version))

    def route(self, msg: Message) -> None:
        if msg.dst == self.rank:
            self.endpoint.enqueue(msg)
            return
        if self._closed:
            raise RuntimeError(f"rank {self.rank}: transport closed")
        hdr, payload = _frame_parts(msg, self.wire_version)
        with self._wlock:
            _sendv(self._sock, hdr, payload)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.endpoint.stop_faults()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
        self._reader.join(timeout=5)


class LoopbackSocketWorld(Transport):
    """All ranks of a socket world hosted in ONE process (plus the
    switch), each rank a `SocketTransport` client over real loopback
    TCP.  Presents the same surface as `InprocTransport` (`endpoints`,
    `coord_endpoint()`), so fabric-level conformance tests and the
    single-rank `MANARuntime` can exercise the socket wire path without
    spawning processes.  Multi-process execution is the world harness's
    job (`repro_torch.comm.transport.harness`).
    """

    name = "socket"

    def __init__(self, n_ranks: int, msg_cost_us: float = 0.0,
                 fault_plan=None):
        super().__init__(n_ranks, msg_cost_us, fault_plan=fault_plan)
        self.switch = FabricSwitch(coord_rank=n_ranks)
        self._clients = [SocketTransport(n_ranks, r, self.switch.addr,
                                         msg_cost_us, fault_plan=fault_plan)
                         for r in range(n_ranks)]
        self.endpoints = [t.endpoint for t in self._clients]
        self._coord_client: Optional[SocketTransport] = None
        self._coord_lock = threading.Lock()

    def coord_endpoint(self) -> Endpoint:
        with self._coord_lock:
            if self._coord_client is None:
                self._coord_client = SocketTransport(
                    self.n_ranks, self.coord_rank, self.switch.addr,
                    self.msg_cost_s * 1e6)
            return self._coord_client.endpoint

    def route(self, msg: Message) -> None:
        """Route on behalf of a local endpoint: each endpoint belongs to
        its own SocketTransport client, so this is only reachable if an
        endpoint was constructed against the world directly — which the
        world never does."""
        raise NotImplementedError(
            "LoopbackSocketWorld endpoints route through their own "
            "SocketTransport clients")

    def close(self) -> None:
        clients = list(self._clients)
        if self._coord_client is not None:
            clients.append(self._coord_client)
        for c in clients:
            c.close()
        self.switch.close()
