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


def placements(spec: Sequence, mesh,
               shape: Optional[Sequence[int]] = None) -> Tuple[Any, ...]:
    """DTensor placements of `spec` on `mesh`: `Shard(d)` on each mesh
    dim that a tensor dim d names, `Replicate()` on the others.  Given
    the tensor's `shape`, a dim of size 1 stays whole: its one row is
    the same values on every rank either way (`spec` names it only over
    axes of one device, or for "seq"), and DTensor cannot view such a
    shard away (a batch of 1 on a (1 x 1) mesh fails in the einsums'
    views)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None or (shape is not None and shape[d] == 1):
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
    shape: Optional[Tuple[int, ...]] = None

    @property
    def placements(self) -> Tuple[Any, ...]:
        return placements(self.spec, self.mesh, self.shape)


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
                # (e.g. a decode cache's cache_time, which comes before
                # its kv_heads, takes 'model' under kv_time_shard and
                # leaves the heads whole)
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
        return NamedSharding(self.mesh, self.spec(logical, shape),
                             None if shape is None else tuple(shape))


def place(x, spec, mesh):
    """`x` as a DTensor placed by `spec` on `mesh`: a DTensor is
    redistributed where its placements differ, a plain tensor (the same
    on every rank) is cut to this rank's shard with no collective."""
    want = placements(spec, mesh, x.shape)
    if not hasattr(x, "device_mesh"):
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(x, mesh, want, src_data_rank=None)
    return x if tuple(x.placements) == want else x.redistribute(mesh, want)


def constrain(x, rules: Optional[ShardingRules], logical):
    """`x` placed on the mesh by its logical axes, the reference's
    `with_sharding_constraint`: a DTensor is redistributed (its values
    do not change), anything else is returned as it is."""
    if rules is None or not hasattr(x, "device_mesh"):
        return x
    want = rules.named(logical, x.shape).placements
    if tuple(x.placements) == want:
        return x
    return x.redistribute(rules.mesh, want)


def _data_dims(x) -> Tuple[int, ...]:
    """The indices of the data axes (`batch_axes`) of DTensor `x`'s
    mesh."""
    names = tuple(x.device_mesh.mesh_dim_names)
    return tuple(names.index(a) for a in batch_axes(x.device_mesh))


def gather_over_data(tree):
    """`tree` with every DTensor leaf that is split over the data axes
    ("pod", "data") gathered whole over them, the rest of its placement
    kept: an FSDP leaf in its spec without the data shard, at its use,
    as the reference's partitioner gathers it.  The redistribution is
    autograd's, so the gradient comes back reduced onto the shards (a
    reduce-scatter of the partial sums over the data ranks)."""
    from torch.distributed.tensor import Replicate

    def gather(x):
        if not hasattr(x, "device_mesh"):
            return x
        pl = tuple(x.placements)
        data = _data_dims(x)
        want = tuple(Replicate() if i in data else p
                     for i, p in enumerate(pl))
        return x if want == pl else x.redistribute(x.device_mesh, want)

    return tree_map(gather, tree)


def off_lead_dims(tree, lead: int = 1):
    """`tree` with every DTensor leaf whose first `lead` dims (a stack's
    layer dims) are split over data axes redistributed so that those
    axes split another dim: the first one past `lead` that no mesh dim
    splits and that their size divides (else they are replicated).  It
    holds as many bytes a rank as before, and the stack can then be
    unbound into layers, each gathered at its use (`gather_over_data`);
    DTensor cannot unbind a split dim.  One all-to-all of each such
    leaf; the others are returned as they are."""
    from torch.distributed.tensor import Replicate, Shard

    def move(x):
        if not hasattr(x, "device_mesh"):
            return x
        pl = tuple(x.placements)
        data = [i for i in _data_dims(x)
                if isinstance(pl[i], Shard) and pl[i].dim < lead]
        if not data:
            return x
        n = 1
        for i in data:
            n *= x.device_mesh.size(i)
        taken = {p.dim for p in pl if isinstance(p, Shard)}
        to = next((d for d in range(lead, x.ndim)
                   if d not in taken and x.shape[d] % n == 0), None)
        want = tuple((Replicate() if to is None else Shard(to))
                     if i in data else p for i, p in enumerate(pl))
        return x.redistribute(x.device_mesh, want)

    return tree_map(move, tree)


def on_local_shards(fn, args, want, out):
    """`fn(*local shards of args)` as a DTensor (a tuple of them): each
    DTensor arg is first placed as `want` (one placement tuple for each;
    a None arg passes as None), and each result takes `out`'s placements
    (one tuple, or a tuple of them for a tuple of results).  An arg
    whole on a mesh dim where the results are not (the ranks there
    compute different parts) gets its gradient there as a partial sum
    over those ranks.  For ops whose DTensor sharding propagation is
    missing, faulty or planned anew at each shape (ROADMAP.md section C,
    "DTensor ops on local shards")."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    many = isinstance(out[0], tuple)
    outs = out if many else (out,)
    split = tuple(o != Replicate() for o in outs[0])
    mesh = next(a for a in args if a is not None).device_mesh

    def local(t, pl):
        if t is None:
            return None
        t = t if tuple(t.placements) == pl else t.redistribute(mesh, pl)
        return t.to_local(grad_placements=tuple(
            Partial() if p == Replicate() and s else p
            for p, s in zip(pl, split)))

    y = fn(*(local(t, pl) for t, pl in zip(args, want)))
    wrap = [DTensor.from_local(t, mesh, o, run_check=False)
            for t, o in zip(y if many else (y,), outs)]
    return tuple(wrap) if many else wrap[0]


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
