"""Split-process state model (paper §II-A), port of
`repro.core.split_state` for one device.

Upper half — checkpointed, host-serializable, *never* references
physical resources: params / optimizer moments / step counter, the
data-pipeline cursor, and the virtual-object tables, drain buffers and
per-comm collective counts (`RankAgent.serialize()`).

Lower half — NEVER checkpointed, rebuilt from scratch at restart: the
train step and the message fabric (a transport WORLD picked by name from
the registry, so a checkpoint written over one backend restores over
another).  PyTorch runs eagerly, so there is no compiled executable, and
the mesh branch (`mesh` not None) is not ported (ROADMAP.md).  The
transport-era elastic reshard below is the reference's code.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.codec import ImageIntegrityError
from repro_torch.sharding.rules import WORLD_LOGICAL_AXES, zero1_pick_dim


@dataclasses.dataclass
class LowerHalf:
    mesh: Optional[Any]
    rules: Optional[Any]
    train_step: Callable
    state_specs: Optional[Any]
    # the comm substrate (a transport world from the registry); like the
    # mesh, it is physical state — never serialized, rebuilt at restart
    comm: Optional[Any] = None
    transport: str = "inproc"

    @classmethod
    def build(cls, cfg: ModelConfig, rc: RunConfig, mesh=None,
              transport: str = "inproc", n_ranks: int = 1,
              fault_plan=None) -> "LowerHalf":
        from repro_torch.comm.transport import create_world
        from repro_torch.training.step import make_train_step

        if mesh is not None:
            raise NotImplementedError(
                "mesh-sharded lower halves are not ported to repro_torch "
                "(ROADMAP.md)")
        # fault_plan: deterministic chaos injection on the rebuilt
        # lower half's fabric — physical state, never checkpointed
        comm = create_world(transport, n_ranks, fault_plan=fault_plan)
        return cls(None, None, make_train_step(cfg, rc, None), None, comm,
                   transport)


# ---------------------------------------------------------------------------
# transport-era elastic reshard: the logical-axis round trip, in numpy
# ---------------------------------------------------------------------------
# The transport world is a 1-D data mesh, so "reshard for a new world
# size" is exactly the upper-half promise cashed in: gather the N old
# shards of each leaf along its world-sharded logical dim into the FULL
# logical array, then scatter into M pieces.  `np.array_split` on both
# directions makes the round trip exact for ANY (N, M) — uneven
# divisors included — which is what buys bit-identical logical state
# across shrink -> grow cycles.  Shares the logical vocabulary and the
# ZeRO-1 dim choice with `repro_torch.sharding.rules` so the jax mesh path
# and this path cannot drift.

def leaf_shard_dim(logical: Sequence[Optional[str]], shape: Sequence[int],
                   n: int, *, zero1: bool = False) -> Optional[int]:
    """Which dim of a leaf is sharded across the 1-D world: the first
    dim whose logical name is data-parallel (`WORLD_LOGICAL_AXES`),
    else — for ZeRO-1 leaves — the first unsharded dim (uneven splits
    allowed; `array_split` semantics), else None (replicated)."""
    entries = list(logical) + [None] * (len(shape) - len(logical))
    for i, name in enumerate(entries):
        if name in WORLD_LOGICAL_AXES:
            return i
    if zero1:
        marked = [None if e is None else e for e in entries]
        return zero1_pick_dim(marked, shape, n, allow_uneven=True)
    return None


def gather_leaf(shards: Sequence[np.ndarray], dim: int) -> np.ndarray:
    """N per-rank shards -> the full logical array (rank order)."""
    return np.concatenate([np.asarray(s) for s in shards], axis=dim)


def scatter_leaf(full: np.ndarray, dim: int, n_to: int) -> List[np.ndarray]:
    """Full logical array -> M shards (`array_split`: uneven sizes land
    on the leading ranks, empty shards when n_to exceeds the dim)."""
    return [np.ascontiguousarray(s)
            for s in np.array_split(np.asarray(full), n_to, axis=dim)]


def reshard_state(per_rank: Sequence[Dict[str, np.ndarray]],
                  logical: Dict[str, Sequence[Optional[str]]],
                  n_to: int, *, zero1_keys: Sequence[str] = (),
                  ) -> List[Dict[str, np.ndarray]]:
    """Reshard N ranks' array dicts into `n_to` dicts via the logical
    axes.  Leaves without a world-sharded dim must be replica-consistent
    across the old ranks (verified — a divergent "replicated" leaf is an
    `ImageIntegrityError`, not a silent pick-one) and are replicated to
    the new world.  Leaves missing from some old ranks are an error for
    sharded dims (a hole in the logical array) and tolerated for
    replicated ones."""
    n_from = len(per_rank)
    zero1_keys = set(zero1_keys)
    names = sorted({k for d in per_rank for k in d})
    out: List[Dict[str, np.ndarray]] = [{} for _ in range(n_to)]
    for name in names:
        shards = [d.get(name) for d in per_rank]
        lg = tuple(logical.get(name, ()))
        present = [s for s in shards if s is not None]
        dim = leaf_shard_dim(lg, present[0].shape, n_from,
                             zero1=name in zero1_keys)
        if dim is None:
            ref = np.asarray(present[0])
            for s in present[1:]:
                if not np.array_equal(ref, np.asarray(s)):
                    raise ImageIntegrityError(
                        f"leaf {name!r} has no world-sharded logical "
                        f"axis but differs across ranks — cannot "
                        f"replicate a divergent leaf")
            for piece in out:
                piece[name] = ref.copy()
            continue
        if any(s is None for s in shards):
            missing = [r for r, s in enumerate(shards) if s is None]
            raise ImageIntegrityError(
                f"sharded leaf {name!r} missing from rank(s) {missing}")
        full = gather_leaf(shards, dim)
        for piece, shard in zip(out, scatter_leaf(full, dim, n_to)):
            piece[name] = shard
    return out
