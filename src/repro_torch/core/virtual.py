"""Virtualized communication objects (paper §II-C, §III-A, §III-C, §III-K).

The application/framework layer only ever holds *virtual* IDs.  The
mapping virtual -> real is maintained here and rebound after restart, so
user-held handles survive the checkpoint-restart barrier while real
objects (mesh collectives, in-flight futures) are recreated fresh.

Implements, faithfully to MANA-2.0:
  * flat-dict (hash) tables, not ordered maps  (§III-I lesson 1)
  * communicators stored as their *world-rank group*; restart
    reconstructs only ACTIVE comms from membership, never by replaying
    creation calls                                   (§III-C)
  * globally-unique comm IDs computed locally by translating group
    ranks to world ranks and hashing                 (§III-K)
  * request virtualization with the TWO-STEP retirement algorithm for
    p2p requests whose application-side addresses are unknown (§III-A)
"""
from __future__ import annotations

import hashlib
import itertools
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

REQUEST_NULL = -1  # analogue of MPI_REQUEST_NULL


def comm_gid(world_ranks: Tuple[int, ...]) -> int:
    """Globally-unique communicator ID from world-rank membership (§III-K).

    Computed purely locally — no peer communication — exactly as MANA-2.0
    uses MPI_Group_translate_ranks + hash.
    """
    h = hashlib.sha256(",".join(map(str, sorted(world_ranks))).encode())
    return int.from_bytes(h.digest()[:8], "little")


@dataclass
class VirtualComm:
    vid: int
    world_ranks: Tuple[int, ...]   # membership in world ranks — THE identity
    real: Any = None               # lower-half object; never serialized

    @property
    def gid(self) -> int:
        return comm_gid(self.world_ranks)

    def translate(self, local_rank: int) -> int:
        """Local rank -> world rank (MPI_Group_translate_ranks analogue)."""
        return self.world_ranks[local_rank]


class VirtualCommTable:
    """virtual comm id -> VirtualComm; active-list semantics of §III-C."""

    def __init__(self):
        self._tab: Dict[int, VirtualComm] = {}
        self._next = itertools.count(1)
        self._lock = threading.Lock()

    def create(self, world_ranks: Iterable[int], real: Any = None) -> int:
        with self._lock:
            vid = next(self._next)
            self._tab[vid] = VirtualComm(vid, tuple(world_ranks), real)
            return vid

    def real(self, vid: int) -> Any:
        return self._tab[vid].real

    def get(self, vid: int) -> VirtualComm:
        return self._tab[vid]

    def free(self, vid: int) -> None:
        """Comm_free: drop from the active list; it will NOT be rebuilt."""
        self._tab.pop(vid, None)

    def active(self) -> Dict[int, Tuple[int, ...]]:
        return {vid: c.world_ranks for vid, c in self._tab.items()}

    def __len__(self) -> int:
        return len(self._tab)

    # ---- checkpoint / restart ---------------------------------------------
    def serialize(self) -> Dict:
        """Upper-half representation: membership only, no real objects.
        The id counter is persisted so freed ids are never reissued after
        restart (an app-held stale handle must not alias a new comm)."""
        nxt = next(self._next)
        self._next = itertools.count(nxt)  # peek without consuming
        return {"comms": {str(v): list(c.world_ranks)
                          for v, c in self._tab.items()},
                "next": nxt}

    @classmethod
    def restore(cls, blob: Dict,
                real_factory: Callable[[Tuple[int, ...]], Any]) -> "VirtualCommTable":
        """Rebuild ONLY the active comms, from group membership (§III-C)."""
        t = cls()
        max_vid = 0
        for vid_s, ranks in blob["comms"].items():
            vid = int(vid_s)
            ranks = tuple(ranks)
            t._tab[vid] = VirtualComm(vid, ranks, real_factory(ranks))
            max_vid = max(max_vid, vid)
        t._next = itertools.count(max(blob.get("next", 0), max_vid + 1))
        return t


@dataclass
class VirtualRequest:
    vid: int
    kind: str                      # "p2p" | "coll"
    real: Any = None               # future/handle, or REQUEST_NULL
    meta: Dict = field(default_factory=dict)


class VirtualRequestTable:
    """Virtualized requests with two-step retirement (§III-A).

    Collective requests ("coll"): the wrapper knows the application-side
    handle location, so a completed request is removed immediately and
    the app handle set to REQUEST_NULL (one step).

    Point-to-point requests ("p2p"): the app may have copied the handle
    anywhere, so retirement is two-step:
      step 1 (on completion): real <- REQUEST_NULL, entry KEPT;
      step 2 (next test/wait on that vid): entry removed, REQUEST_NULL
      returned to the app.
    """

    def __init__(self):
        self._tab: Dict[int, VirtualRequest] = {}
        self._next = itertools.count(1)
        self._lock = threading.Lock()
        self.retired = 0

    def create(self, real: Any, kind: str = "p2p", **meta) -> int:
        with self._lock:
            vid = next(self._next)
            self._tab[vid] = VirtualRequest(vid, kind, real, meta)
            return vid

    def real(self, vid: int) -> Any:
        req = self._tab.get(vid)
        return REQUEST_NULL if req is None else req.real

    def __len__(self) -> int:
        return len(self._tab)

    def live(self) -> Dict[int, VirtualRequest]:
        return {v: r for v, r in self._tab.items() if r.real is not REQUEST_NULL}

    def mark_complete(self, vid: int) -> None:
        """Retirement step 1: point the virtual id at REQUEST_NULL."""
        with self._lock:
            req = self._tab.get(vid)
            if req is not None:
                if req.kind == "coll":
                    # address known: retire immediately (single step)
                    del self._tab[vid]
                    self.retired += 1
                else:
                    req.real = REQUEST_NULL

    def test(self, vid: int, poll: Callable[[Any], bool]) -> bool:
        """MPI_Test analogue.  `poll(real)` returns completion for a real
        request.  Implements retirement step 2."""
        with self._lock:
            req = self._tab.get(vid)
            if req is None:
                return True                      # already fully retired
            if req.real is REQUEST_NULL or req.real == REQUEST_NULL:
                del self._tab[vid]               # step 2: reclaim
                self.retired += 1
                return True
        if poll(req.real):
            self.mark_complete(vid)
            # a completed coll request is gone; a p2p one awaits step 2
            return True
        return False

    def wait(self, vid: int, poll: Callable[[Any], bool],
             spin: Callable[[], None] = lambda: None) -> None:
        """MPI_Wait as a loop around MPI_Test (§III item 1)."""
        while not self.test(vid, poll):
            spin()

    # ---- checkpoint / restart ---------------------------------------------
    def serialize(self) -> Dict:
        """Live requests only (completed ones need no replay)."""
        nxt = next(self._next)
        self._next = itertools.count(nxt)
        return {"requests": {str(v): {"kind": r.kind, "meta": r.meta}
                             for v, r in self.live().items()},
                "next": nxt}

    @classmethod
    def restore(cls, blob: Dict,
                replay: Callable[[str, Dict], Any]) -> "VirtualRequestTable":
        """Re-instantiate real requests for live virtual ids by replaying
        the recorded call (paper conclusion: 'which processes must replay
        ... to re-instantiate virtual MPI requests')."""
        t = cls()
        max_vid = 0
        for vid_s, r in blob["requests"].items():
            vid = int(vid_s)
            t._tab[vid] = VirtualRequest(vid, r["kind"],
                                         replay(r["kind"], r["meta"]), r["meta"])
            max_vid = max(max_vid, vid)
        t._next = itertools.count(max(blob.get("next", 0), max_vid + 1))
        return t
