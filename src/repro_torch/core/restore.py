"""Elastic restore: rebind a committed image taken at N ranks onto a
world of M ranks (ROADMAP item 1 — the production autoscaling story).

MANA-2.0's split-process model makes this possible by construction: the
checkpointed upper half (arrays tagged with LOGICAL axis names, virtual
comm tables keyed by world-rank membership, drain buffers, per-comm
collective counts) never references physical resources, so nothing in a
committed image pins the world size except the rank numbering itself.
This module supplies the one missing ingredient — an explicit
old-rank -> new-rank remapping — and drives every restore path through
it:

  `RestorePlan`    — the remapping: which old ranks fold onto which new
      ranks (shrink), which new ranks start cold (grow), and which
      transport the new world runs on.  Identity plans (`N == M`, same
      mapping) make the elastic path a strict superset of the old
      same-world restore.
  `restore_world`  — the ONE public entrypoint (exported as
      `repro_torch.restore_world`): normalizes the image through the
      transport-free binary container, resolves the plan (explicit
      argument, the image's recorded "remap" field, or identity), and
      returns a `RestoredWorld` whose `bind(ctx)` performs the §III-C
      restore ritual per rank — comm memberships remapped, collective
      counts rekeyed to the remapped gids, drained in-flight messages
      replayed under the new rank numbering — and whose `reshard()`
      round-trips per-rank array shards through the logical-axis
      representation (`repro_torch.core.split_state` helpers, vocabulary
      shared with `repro_torch.sharding.rules`) to produce M shards from N.

Validation is layered: `restore_world` / `RestorePlan.for_image` raise
a typed `WorldMismatchError` (repro_torch.core.codec) when the image and plan
disagree, `bind(ctx)` re-checks the plan against the LIVE world, and the
coordinator validates image-vs-world compatibility at HELLO time (the
"hello" control op) — a mis-sized restore dies with a typed error on
every layer instead of silently misassigning shards.

This module stays importable from a jax-free process (socket rank
children fork per attempt); array resharding is pure numpy via the
lazily-imported `split_state` helpers.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.codec import (WorldMismatchError, image_from_bytes,
                              image_to_bytes, restore_rank_arrays)

__all__ = ["RestorePlan", "RestoredWorld", "WorldMismatchError",
           "parse_restore_spec", "restore_world", "snapshot_state"]


def parse_restore_spec(spec: str) -> Tuple[Optional[int], Optional[str]]:
    """Parse a ``--restore-to`` spec: ``N@transport``, ``N`` (same
    transport) or ``@transport`` (same world size).  The ONE shared
    parser for examples, tests and CI — a None slot means "unchanged".

    >>> parse_restore_spec("61@socket")
    (61, 'socket')
    >>> parse_restore_spec("61")
    (61, None)
    >>> parse_restore_spec("@inproc")
    (None, 'inproc')
    """
    s = str(spec).strip()
    n_part, sep, t_part = s.partition("@")
    n_part, t_part = n_part.strip(), t_part.strip()
    if (not sep and not n_part) or (sep and not n_part and not t_part):
        raise ValueError(f"empty --restore-to spec {spec!r}")
    try:
        n = int(n_part) if n_part else None
    except ValueError:
        raise ValueError(
            f"bad --restore-to spec {spec!r}: world size {n_part!r} "
            f"is not an integer (expected N@transport, N, or @transport)"
        ) from None
    if n is not None and n < 1:
        raise ValueError(f"bad --restore-to spec {spec!r}: world size "
                         f"must be >= 1")
    return n, (t_part or None)


def snapshot_state(blob: Any) -> Dict:
    """The app-level state dict of one rank's snapshot blob: binary
    containers yield their digest-verified `extra` cell, plain dict
    blobs (pre-codec app snapshots) pass through unchanged."""
    if isinstance(blob, dict):
        return blob
    from repro_torch.core.codec import SnapshotCodec
    return SnapshotCodec().decode_extra(blob)


@dataclasses.dataclass(frozen=True)
class RestorePlan:
    """An explicit old-rank -> new-rank remapping for one restore.

    `rank_map` maps EVERY old rank to a new rank.  Shrinking folds the
    tail (`old % n_to` by default): each surviving new rank adopts its
    identity-mapped old rank as PRIMARY and inherits the folded ranks'
    drained messages; growing maps old ranks identically and leaves the
    new tail ranks cold (they seed world collective counts from the
    plan so the next phase-1 count equalization still closes).

    Membership remap rule: the world communicator (membership ==
    range(n_from)) maps to range(n_to); any other comm maps member-wise
    through `rank_map` (topology-dependent comms — rows, rings — should
    be rebuilt by the app for the new world; their remapped registrations
    stay consistent for count equalization either way).

    >>> plan = RestorePlan.between(4, 3)
    >>> (plan.rank_map[3], plan.owned(0), plan.remap_members((0, 1, 2, 3)))
    (0, (0, 3), (0, 1, 2))
    >>> RestorePlan.between(3, 4).owned(3)   # grown rank starts cold
    ()
    """

    n_from: int
    n_to: int
    transport: Optional[str] = None
    rank_map: Mapping[int, int] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.n_from < 1 or self.n_to < 1:
            raise ValueError(f"world sizes must be >= 1 "
                             f"(got {self.n_from} -> {self.n_to})")
        if not self.rank_map:
            object.__setattr__(self, "rank_map",
                               {r: r % self.n_to
                                for r in range(self.n_from)})
        bad = {o: n for o, n in self.rank_map.items()
               if not 0 <= n < self.n_to}
        if bad or sorted(self.rank_map) != list(range(self.n_from)):
            raise ValueError(
                f"rank_map must map every old rank 0..{self.n_from - 1} "
                f"into 0..{self.n_to - 1} (got {dict(self.rank_map)})")

    # ---- constructors -------------------------------------------------------
    @classmethod
    def identity(cls, n: int, transport: Optional[str] = None,
                 ) -> "RestorePlan":
        return cls(n, n, transport)

    @classmethod
    def between(cls, n_from: int, n_to: int,
                transport: Optional[str] = None) -> "RestorePlan":
        """The default mod-fold plan between two world sizes."""
        return cls(n_from, n_to, transport)

    @classmethod
    def for_image(cls, image: Dict, n_to: int,
                  transport: Optional[str] = None) -> "RestorePlan":
        """Plan a restore of `image` onto `n_to` ranks; raises
        `WorldMismatchError` when the image carries no world size."""
        n_from = image.get("n_ranks")
        if n_from is None:
            raise WorldMismatchError(
                "image carries no n_ranks field; cannot plan an "
                "elastic restore from it")
        return cls(int(n_from), int(n_to), transport)

    @classmethod
    def from_spec(cls, n_from: int, spec: Dict) -> "RestorePlan":
        """Rebuild a plan from an image's recorded "remap" field."""
        rank_map = {int(o): int(n)
                    for o, n in spec.get("rank_map", {}).items()}
        return cls(int(n_from), int(spec["n_to"]),
                   spec.get("transport"), rank_map)

    # ---- queries ------------------------------------------------------------
    @property
    def is_identity(self) -> bool:
        return (self.n_from == self.n_to
                and all(o == n for o, n in self.rank_map.items()))

    def owned(self, new_rank: int) -> Tuple[int, ...]:
        """Old ranks whose state folds onto `new_rank` (sorted; the
        first is the PRIMARY whose protocol state the new rank adopts).
        Empty for a cold (grown) rank."""
        return tuple(sorted(o for o, n in self.rank_map.items()
                            if n == new_rank))

    def remap_members(self, ranks: Sequence[int]) -> Tuple[int, ...]:
        """Remap a communicator membership.  The world comm IS the
        world: full old membership maps to full new membership."""
        members = tuple(sorted(int(r) for r in ranks))
        if members == tuple(range(self.n_from)):
            return tuple(range(self.n_to))
        return tuple(sorted({self.rank_map[r] for r in members}))

    def spec(self) -> Dict:
        """The JSON-safe "remap" field recorded into an image header
        (see `repro_torch.core.codec.IMAGE_FIELDS`)."""
        return {"n_from": self.n_from, "n_to": self.n_to,
                "transport": self.transport,
                "rank_map": {str(o): n for o, n in self.rank_map.items()}}

    def attach(self, image: Dict) -> Dict:
        """Record this plan into an image's header (consumed by
        `restore_world` on the other side of a relaunch)."""
        out = dict(image)
        out["remap"] = self.spec()
        return out

    # ---- protocol-state remapping (tentpole b) ------------------------------
    def remap_agent_blob(self, blob: Dict,
                         extra_drains: Sequence[Tuple] = ()) -> Dict:
        """Rewrite one serialized `RankAgent` blob under the remapping:
        comm memberships translate member-wise (world comm -> new
        world), collective counts REKEY from old-membership gids to the
        remapped-membership gids (gids hash membership, so they change
        whenever membership does; counts merged under max when two old
        comms collapse to one new membership — legal because a committed
        cut equalized counts per comm), drained messages get their
        src/dst renumbered, and `extra_drains` (folded secondary ranks'
        drain entries, already remapped) are appended for replay."""
        from repro_torch.core.virtual import comm_gid

        comms_blob = blob.get("comms", {"comms": {}, "next": 1})
        old_members = {vid: tuple(int(r) for r in ranks)
                       for vid, ranks in comms_blob.get("comms", {}).items()}
        new_members = {vid: self.remap_members(ranks)
                       for vid, ranks in old_members.items()}
        gid_map = {comm_gid(old): comm_gid(new)
                   for old, new in zip(old_members.values(),
                                       new_members.values())}
        counts: Dict[str, int] = {}
        for g, c in blob.get("coll_counts", {}).items():
            ng = gid_map.get(int(g))
            if ng is None:
                continue  # a freed comm's residual counter: meaningless now
            counts[str(ng)] = max(counts.get(str(ng), 0), int(c))
        drains = [(self.rank_map[int(src)], self.rank_map[int(dst)],
                   int(tag), payload)
                  for src, dst, tag, payload in blob.get("drain_buffer", ())]
        drains.extend(extra_drains)
        out = dict(blob)
        out["rank"] = self.rank_map[int(blob["rank"])]
        if self.transport is not None:
            out["transport"] = self.transport
        out["comms"] = {"comms": {vid: list(ranks)
                                  for vid, ranks in new_members.items()},
                        "next": comms_blob.get("next", 1)}
        out["coll_counts"] = counts
        out["drain_buffer"] = drains
        if "requests" in blob:
            # live p2p requests record their peer in meta — renumber it
            reqs = dict(blob["requests"])
            reqs["requests"] = {
                vid: {**r, "meta": {k: (self.rank_map[int(v)]
                                        if k in ("src", "dst")
                                        and v is not None else v)
                                    for k, v in r.get("meta", {}).items()}}
                for vid, r in reqs.get("requests", {}).items()}
            out["requests"] = reqs
        return out


# the §III-C per-rank restore ritual, shared by the public
# `RestoredWorld.bind` and the deprecated `harness.restore_agent_from_blob`
# shim — kept in one place so the two cannot drift apart
def _bind_agent_blob(ctx, agent_blob: Dict) -> None:
    from repro_torch.comm.transport.base import Message
    from repro_torch.core.virtual import VirtualCommTable, comm_gid
    a, ep = ctx.agent, ctx.ep
    a.comms = VirtualCommTable.restore(agent_blob["comms"],
                                       real_factory=lambda ranks: ep)
    for ranks in a.comms.active().values():
        ctx.coord.register_comm(comm_gid(tuple(ranks)), tuple(ranks))
    a.coll_counts.update({int(g): c
                          for g, c in agent_blob["coll_counts"].items()})
    for src, dst, tag, hexpayload in agent_blob["drain_buffer"]:
        ep.drain_buffer.append(
            Message(src, dst, tag, bytes.fromhex(hexpayload)))


class RestoredWorld:
    """One restore, resolved: the normalized image + the plan.

    Launcher side: `reshard()` produces the new world's per-rank array
    shards (call once, close over the result — socket children inherit
    it through fork).  Rank side: `bind(ctx)` performs the remapped
    restore ritual onto a live `WorldContext` and returns the app state
    dicts of the old ranks this rank owns.
    """

    def __init__(self, image: Dict, plan: RestorePlan):
        self.image = image
        self.plan = plan
        self._states: Optional[Dict[int, Dict]] = None

    # ---- app state ----------------------------------------------------------
    def state(self, old_rank: int) -> Dict:
        """Decoded app state dict of ONE old rank's snapshot."""
        return self.states()[int(old_rank)]

    def states(self) -> Dict[int, Dict]:
        """Decoded app state dicts of every old rank (cached)."""
        if self._states is None:
            ranks = self.image["ranks"]
            self._states = {
                int(r): snapshot_state(ranks[r if r in ranks else str(r)])
                for r in range(self.plan.n_from)}
        return self._states

    def agent_blob(self, old_rank: int) -> Optional[Dict]:
        return self.state(old_rank).get("agent")

    # ---- array data plane (tentpole a) --------------------------------------
    def rank_arrays(self, old_rank: int) -> Dict:
        """One OLD rank's decoded arrays (delta chains walked,
        digests verified); empty for plain dict app blobs."""
        ranks = self.image["ranks"]
        blob = ranks.get(old_rank, ranks.get(str(old_rank)))
        if isinstance(blob, dict):
            return {}
        arrays, _ = restore_rank_arrays(self.image, old_rank)
        return arrays

    def reshard(self, logical: Optional[Dict[str, Sequence]] = None,
                zero1_keys: Sequence[str] = ()) -> List[Dict]:
        """Round-trip every array leaf through its logical-axis
        representation: gather the N old shards into the full logical
        array along the world-sharded dim, then scatter into M shards
        for the new world (`repro_torch.core.split_state.reshard_state`).
        `logical` defaults to the "logical" field of the old ranks' app
        state; leaves without a world-sharded axis are verified
        replica-consistent and replicated to M."""
        from repro_torch.core.split_state import reshard_state
        per_rank = [self.rank_arrays(r) for r in range(self.plan.n_from)]
        if logical is None:
            logical = {}
            for st in self.states().values():
                logical.update(st.get("logical", {}))
            zero1_keys = tuple(zero1_keys) or tuple(
                k for st in self.states().values()
                for k in st.get("zero1_keys", ()))
        return reshard_state(per_rank, logical, self.plan.n_to,
                             zero1_keys=zero1_keys)

    def drains_for(self, new_rank: int) -> List[Tuple]:
        """The remapped drained messages `bind` re-appends to
        `new_rank`'s endpoint — (src, dst, tag, hex payload) tuples
        under NEW rank numbering.  An app replays exactly these after an
        elastic bind before starting fresh traffic (under an identity
        plan this is just the old drain backlog)."""
        out: List[Tuple] = []
        for o in self.plan.owned(new_rank):
            blob = self.agent_blob(o)
            if not blob:
                continue
            out.extend(
                d for d in self.plan.remap_agent_blob(blob)["drain_buffer"]
                if d[1] == new_rank)
        return out

    # ---- per-rank rebind (tentpole b + c) -----------------------------------
    def bind(self, ctx, agent_blob: Optional[Dict] = None,
             ) -> Dict[int, Dict]:
        """Rebind the remapped upper half onto a live rank: validates
        plan-vs-world (typed `WorldMismatchError`), announces the
        restore to the coordinator (HELLO-time validation, the "hello"
        control op), then restores the PRIMARY owned old rank's comm
        table / counts / drain buffer under the remapping, folding in
        secondary old ranks' drained messages addressed here.  Cold
        (grown) ranks seed their world-comm collective count from the
        plan so the next phase-1 count equalization closes.  Returns
        {old_rank: app state dict} for the owned old ranks."""
        plan = self.plan
        if ctx.n != plan.n_to:
            raise WorldMismatchError(
                f"restore plan targets {plan.n_to} ranks but the live "
                f"world has {ctx.n} (image taken at {plan.n_from})")
        hello = getattr(ctx.coord, "hello", None)
        if hello is not None:
            hello(plan.n_from, plan.n_to)
        owned = plan.owned(ctx.rank)
        if not owned:
            self._seed_cold_rank(ctx)
            return {}
        primary = owned[0]
        if agent_blob is None:
            agent_blob = self.agent_blob(primary)
        if agent_blob is not None:
            extra = [d for o in owned[1:]
                     for d in plan.remap_agent_blob(
                         self.agent_blob(o) or {"rank": o, "comms":
                                                {"comms": {}, "next": 1},
                                                "coll_counts": {},
                                                "drain_buffer": []}
                     )["drain_buffer"]
                     if d[1] == ctx.rank]
            _bind_agent_blob(ctx, plan.remap_agent_blob(agent_blob,
                                                        extra_drains=extra))
        return {o: self.state(o) for o in owned}

    def _seed_cold_rank(self, ctx) -> None:
        """A grown rank has no snapshot — but the survivors restored
        nonzero world-comm collective counts, and phase-1 closure
        requires counts EQUAL per comm, so the cold rank adopts the
        (equalized-at-commit) world count from any restored blob."""
        from repro_torch.core.virtual import comm_gid
        world_gid = comm_gid(tuple(range(self.plan.n_to)))
        for old in range(self.plan.n_from):
            blob = self.agent_blob(old)
            if blob is None:
                continue
            remapped = self.plan.remap_agent_blob(blob)
            cnt = remapped["coll_counts"].get(str(world_gid))
            if cnt:
                ctx.agent.coll_counts[world_gid] = max(
                    ctx.agent.coll_counts.get(world_gid, 0), int(cnt))
            return


def restore_world(image, plan: Optional[RestorePlan] = None,
                  ) -> RestoredWorld:
    """THE restore entrypoint (`repro_torch.restore_world`): normalize a
    committed image through the transport-free binary container and
    resolve its `RestorePlan`.

    `image` is a committed-image dict or its `image_to_bytes` bytes.
    `plan` resolution order: the explicit argument, the image's
    recorded "remap" field (attached by an elastic supervisor), else
    identity.  Raises `WorldMismatchError` when the plan's source world
    disagrees with the image.

    >>> import numpy as np
    >>> from repro_torch.core.codec import SnapshotCodec
    >>> blob = SnapshotCodec().encode(1, {"w": np.arange(4, dtype=np.float32)},
    ...                               extra={"logical": {"w": ["batch"]}})
    >>> img = {"epoch": 1, "n_ranks": 1, "ranks": {0: blob}}
    >>> rw = restore_world(img, RestorePlan.between(1, 2))
    >>> [s["w"].tolist() for s in rw.reshard()]
    [[0.0, 1.0], [2.0, 3.0]]
    """
    if isinstance(image, (bytes, bytearray, memoryview)):
        image = image_from_bytes(image)
    else:
        # transport-free by construction: a blob smuggling live state
        # fails the container round trip loudly (the old supervisor
        # inline ritual, now behind the one entrypoint)
        image = image_from_bytes(image_to_bytes(image))
    n_from = image.get("n_ranks")
    if plan is None:
        remap = image.get("remap")
        if remap:
            plan = RestorePlan.from_spec(
                remap.get("n_from", n_from), remap)
        elif n_from is not None:
            plan = RestorePlan.identity(int(n_from))
        else:
            raise WorldMismatchError(
                "image carries neither n_ranks nor a remap field; "
                "pass an explicit RestorePlan")
    if n_from is not None and int(n_from) != plan.n_from:
        raise WorldMismatchError(
            f"image was taken at {n_from} ranks but the plan restores "
            f"from {plan.n_from}")
    return RestoredWorld(image, plan)


# ---------------------------------------------------------------------------
# deprecation plumbing: one-shot warnings for the retired restore rituals
# ---------------------------------------------------------------------------

_warned: set = set()


def deprecated_once(key: str, msg: str) -> None:
    """Emit one `DeprecationWarning` per retired entrypoint per process
    (the old helpers are shims over `restore_world` now)."""
    if key in _warned:
        return
    _warned.add(key)
    warnings.warn(msg, DeprecationWarning, stacklevel=3)
