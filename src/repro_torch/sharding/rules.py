"""Logical->physical sharding rules (DP / TP / EP / SP / ZeRO-1), port of
`repro.sharding.rules` over a `torch.distributed.device_mesh.DeviceMesh`.

Parameters and activations carry *logical* axis names; a `ShardingRules`
table maps logical names to mesh axes for the current mesh.  Checkpoints
store the logical names only (MANA-2.0 lesson: the upper half must never
reference lower-half/physical resources), so a restart may rebind them to
a different mesh shape (elastic restart).

A spec is the port's own `PartitionSpec`: a tuple with one entry per
tensor dim, each None (replicated), a mesh axis name, or a tuple of
names (the dim split over several mesh axes, major to minor).  The rules
that build specs are the reference's, entry for entry.  `placements`
turns a spec into DTensor placements, one `Shard(d)` or `Replicate()`
per mesh dim, which `distribute_tensor` and `DTensor.redistribute` take.
A dim split over ("pod", "data") becomes two mesh dims that both shard
it; DTensor splits them in mesh-dim order, which is JAX's major-to-minor
order because the rules only ever name axes in the mesh's own order
(`placements` checks it).

Importing this module does not import torch: the transport-era elastic
reshard (`repro_torch.core.split_state.reshard_state`) shares its
logical vocabulary from torch-free socket rank processes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

from repro_torch.tree import tree_map

# Logical axis vocabulary --------------------------------------------------
# "batch"   -> data-parallel axes (pod, data)
# "vocab"   -> tensor-parallel (model)
# "heads"   -> tensor-parallel (model)
# "kv_heads"-> tensor-parallel iff divisible, else replicated
# "ffn"     -> tensor-parallel (model)
# "expert"  -> expert-parallel (model) in ep mode, else unsharded
# "d_inner" -> tensor-parallel (model)  (mamba inner channels)
# "layers"  -> unsharded for params; ZeRO-1 shards it for optimizer state
# "seq"     -> sequence-parallel (model) when SP is enabled; else unsharded
# None      -> replicated

# logical names sharded across the DATA-parallel direction.  In the
# transport era the rank world IS the (1-D) data axis, so these are the
# names the elastic reshard (`split_state.reshard_state`) splits/merges
# across world sizes; everything else is replicated unless claimed by
# the ZeRO-1 rule below.
WORLD_LOGICAL_AXES: Tuple[str, ...] = ("batch",)


class PartitionSpec(tuple):
    """One entry per tensor dim: None, a mesh axis name, or a tuple of
    names.  Trailing dims past its length are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def _mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def zero1_pick_dim(entries: Sequence, shape: Sequence[int], dsize: int,
                   *, allow_uneven: bool = False) -> Optional[int]:
    """The ZeRO-1 dim choice, factored out so `zero1_shard` (mesh
    shardings; even tiling required by jit) and the transport-era
    elastic reshard (numpy `array_split`; uneven allowed) cannot
    disagree: the first currently-unsharded dim eligible for the data
    shard, or None to fall back to replication/param spec."""
    for i, (e, dim) in enumerate(zip(entries, shape)):
        if e is None and (allow_uneven or dim % dsize == 0):
            return i
    return None


def batch_axes(mesh) -> Tuple[str, ...]:
    """All data-parallel mesh axes present in this mesh ('pod' + 'data')."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def placements(spec: Sequence, mesh) -> Tuple[Any, ...]:
    """DTensor placements of `spec` on `mesh`: `Shard(d)` on each mesh
    dim that a tensor dim d names, `Replicate()` on the others."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            # DTensor splits a dim over several mesh dims in mesh order
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"axis order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec bound to a mesh: what `distribute_tensor(x, s.mesh,
    s.placements)` and `x.redistribute(s.mesh, s.placements)` take."""
    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> Tuple[Any, ...]:
        return placements(self.spec, self.mesh)


class ShardingRules:
    def __init__(self, mesh, *, moe_mode: str = "ep",
                 seq_shard: bool = False, kv_time_shard: bool = False):
        self.mesh = mesh
        self.moe_mode = moe_mode
        self.seq_shard = seq_shard
        self.kv_time_shard = kv_time_shard
        self._sizes = _mesh_sizes(mesh)
        batch = batch_axes(mesh)
        model = "model" if "model" in self._sizes else None
        self.table = {
            "batch": batch if batch else None,
            "vocab": model,
            "heads": model,
            "kv_heads": model,   # resolved per-shape below (divisibility)
            "ffn": model,
            "d_inner": model,
            "expert": model if moe_mode == "ep" else None,
            "expert_ffn": model if moe_mode == "tp" else None,
            "seq": model if seq_shard else None,
            "cache_time": model if kv_time_shard else None,
            "layers": None,
            "embed": None,
            "dt": None,
            None: None,
        }

    def model_axis_size(self) -> int:
        return self._sizes.get("model", 1)

    def spec(self, logical: Sequence[Optional[str]],
             shape: Optional[Sequence[int]] = None) -> PartitionSpec:
        """Translate logical axes to a PartitionSpec.

        If `shape` is given, any mapping that does not divide evenly is
        dropped (replicated), as the reference's jit argument shardings
        must tile evenly; model dims are pre-padded (configs.base
        padding) so anything still uneven is deliberately replicated.
        "seq" is exempt: it is only ever applied to intermediates.
        """
        allow_uneven = {"seq"}
        out = []
        used: set = set()
        for i, name in enumerate(logical):
            phys = self.table.get(name, None)
            if phys is None:
                out.append(None)
                continue
            axes = phys if isinstance(phys, tuple) else (phys,)
            if any(a in used for a in axes):
                # each mesh axis may shard one dim; first mapping wins
                # (e.g. kv_heads takes 'model' before cache_time can)
                out.append(None)
                continue
            if shape is not None:
                total = 1
                for a in axes:
                    total *= self._sizes[a]
                if shape[i] % total != 0 and name not in allow_uneven:
                    out.append(None)
                    continue
            used.update(axes)
            # unwrap 1-tuples, as the reference does
            out.append(axes[0] if len(axes) == 1 else phys)
        return PartitionSpec(*out)

    def named(self, logical: Sequence[Optional[str]],
              shape: Optional[Sequence[int]] = None) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec(logical, shape))


def make_rules(mesh, **kw) -> ShardingRules:
    return ShardingRules(mesh, **kw)


def logical_to_physical(rules: ShardingRules, logical_tree, shape_tree=None):
    """Map a tree of logical-axis tuples to PartitionSpecs (`shape_tree`:
    the same tree of shapes, or of tensors whose shapes count)."""
    if shape_tree is None:
        return tree_map(lambda lg: rules.spec(lg), logical_tree)
    return tree_map(lambda lg, sh: rules.spec(lg, tuple(
        getattr(sh, "shape", sh))), logical_tree, shape_tree)


def zero1_shard(spec: Sequence, shape: Sequence[int], mesh) -> PartitionSpec:
    """ZeRO-1: additionally shard optimizer state over the data axis.

    Picks the first dimension that is currently unsharded and divisible by
    the data-axis size and assigns it to 'data' (and 'pod' if present and
    still divisible).  Falls back to the param spec when nothing divides.
    """
    sizes = _mesh_sizes(mesh)
    if "data" not in sizes:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    used = {a for e in entries if e is not None
            for a in (e if isinstance(e, tuple) else (e,))}
    if "data" in used:
        return spec  # already data-sharded (e.g. FSDP params)
    dsize = sizes["data"]
    i = zero1_pick_dim(entries, shape, dsize)
    if i is not None:
        dim = shape[i]
        if "pod" in sizes and dim % (dsize * sizes["pod"]) == 0:
            entries[i] = ("pod", "data")
        else:
            entries[i] = "data"
        return PartitionSpec(*entries)
    return spec
