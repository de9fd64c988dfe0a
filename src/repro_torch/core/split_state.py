"""Split-process state model (paper §II-A), port of
`repro.core.split_state`.

Upper half — checkpointed, host-serializable, *never* references
physical resources: params / optimizer moments / step counter, the
data-pipeline cursor, and the virtual-object tables, drain buffers and
per-comm collective counts (`RankAgent.serialize()`).

Lower half — NEVER checkpointed, rebuilt from scratch at restart: the
`DeviceMesh` and its sharding rules, the train step, and the message
fabric (a transport WORLD picked by name from the registry, so a
checkpoint written over one backend restores over another).  PyTorch
runs eagerly, so there is no compiled executable: on a mesh the train
step is wrapped to place its output state by the spec tree, as the
reference's jit places it by its `out_shardings`.  The mesh branch
holds the dense decoder family (ROADMAP.md §A); the other families
raise there.  The transport-era elastic reshard below is the
reference's code.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.codec import ImageIntegrityError
from repro_torch.sharding.rules import WORLD_LOGICAL_AXES, zero1_pick_dim


@dataclasses.dataclass
class UpperHalf:
    state: Any                      # {"params", "opt", "step"}
    logical: Any                    # mirrored logical-axes tree
    data_state: Dict                # {"seed", "step"}
    agent_blob: Optional[Dict]      # virtual tables etc.
    run_meta: Dict                  # arch id, shape name — for validation


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
        from repro_torch.sharding.rules import ShardingRules
        from repro_torch.training.step import (make_train_step,
                                               train_state_specs)

        if mesh is not None:
            family = _family_off_mesh(cfg)
            if family is not None:
                raise NotImplementedError(
                    f"{cfg.arch_id}: the {family} family does not train on "
                    f"a mesh yet (ROADMAP.md §A, 'the other families on a "
                    f"mesh'); only the dense decoder family does")
        # fault_plan: deterministic chaos injection on the rebuilt
        # lower half's fabric — physical state, never checkpointed
        comm = create_world(transport, n_ranks, fault_plan=fault_plan)
        if mesh is None:
            return cls(None, None, make_train_step(cfg, rc, None), None,
                       comm, transport)
        rules = ShardingRules(mesh, moe_mode=rc.moe_mode,
                              seq_shard=rc.seq_shard,
                              kv_time_shard=rc.kv_time_shard)
        specs = train_state_specs(cfg, rc, rules)
        step = _placed_step(make_train_step(cfg, rc, rules), mesh, specs)
        return cls(mesh, rules, step, specs, comm, transport)


def _family_off_mesh(cfg: ModelConfig) -> Optional[str]:
    """The model family of `cfg` if it has no mesh path yet, else None
    (the dense decoder, the one family held on a mesh)."""
    for family, has in (("MoE", cfg.moe is not None),
                        ("hybrid-SSM", bool(cfg.ssm_state)),
                        ("RWKV-6", cfg.rwkv),
                        ("encoder-decoder", cfg.enc_dec),
                        ("vision cross-attention", bool(cfg.cross_attn_every))):
        if has:
            return family
    return None


def _placed_step(train_step, mesh, specs):
    """`train_step` whose new state's DTensor leaves are placed by their
    specs (the update may leave a param with its moments' ZeRO-1
    placement)."""
    from repro_torch.sharding.rules import placements
    from repro_torch.tree import tree_map

    def place(x, spec):
        want = placements(spec, mesh)
        return x if tuple(x.placements) == want else x.redistribute(mesh,
                                                                    want)

    def step(state, batch):
        new_state, metrics = train_step(state, batch)
        return tree_map(place, new_state, specs), metrics

    return step


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
