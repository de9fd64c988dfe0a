"""Per-device cost extraction for the roofline: the port of
`repro.launch.hlo_analysis`, which counts an eager step, not HLO text.

The reference parses the partitioned HLO of a compiled step and expands
its while loops by their trip counts (`cost_analysis` counts a scanned
body once).  Eager PyTorch has no HLO and no loop to expand: every layer
runs as its own ops.  So this module runs the step once under a
`TorchDispatchMode` (`OpCounter`) that sees each op the rank runs, and
the counts scale with the layer count by construction.

Counted, all PER DEVICE as the reference's are:
  * dot_flops        -- 2 * prod(result) * contracting size of every
                        matrix product (mm, addmm, bmm, baddbmm, mv, dot)
  * fusion_io_bytes  -- the HBM-traffic proxy: in eager mode every op is
                        a round trip to device memory, so this is
                        sum(operand + result bytes) of every op; views,
                        allocations and metadata ops count nothing
  * collectives      -- bytes of the local operands of every collective,
                        by the reference's kinds (`COLLECTIVES`), and
                        collective_count
  * peak_bytes       -- the live-set peak of the storages the step makes,
                        above what was alive when it began

On a mesh the ops arrive as DTensor ops.  The counter declines them
(returns NotImplemented), so DTensor runs its redistributions and the
local op, and the counter sees those with their local shapes: the
program of this rank.  DTensor's sharding propagation also runs each
new op once on fake tensors of the GLOBAL shapes to learn the output's
metadata; `OpCounter` marks that call and counts nothing inside it.
"""
from __future__ import annotations

import threading
import weakref
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

aten = torch.ops.aten
# matrix products -> index of the left operand (its last dim contracts)
_DOTS = {aten.mm.default: 0, aten.bmm.default: 0, aten.mv.default: 0,
         aten.dot.default: 0, aten.addmm.default: 1,
         aten.baddbmm.default: 1}
# element-producing transcendental functions (the reference's cost key)
_TRANSCENDENTAL = {aten.exp.default, aten.log.default, aten.tanh.default,
                   aten.sigmoid.default, aten.rsqrt.default,
                   aten.sqrt.default, aten.sin.default, aten.cos.default,
                   aten.silu.default, aten.softplus.default,
                   aten.log1p.default, aten.expm1.default,
                   aten.erf.default, aten.pow.Tensor_Scalar}
# ops that move no tensor data
_NO_TRAFFIC = {aten.empty.memory_format, aten.empty_strided.default,
               aten.empty_like.default, aten.new_empty.default,
               aten.new_empty_strided.default, aten.lift_fresh.default,
               torch.ops.prim.device.default}


def _collective_kinds():
    """{collective op: the reference's kind}: DTensor's functional
    collectives and the c10d ops a model calls directly."""
    f = torch.ops._c10d_functional
    c = torch.ops.c10d
    pairs = [(f.all_gather_into_tensor, "all-gather"),
             (f.all_gather_into_tensor_coalesced, "all-gather"),
             (f.all_reduce, "all-reduce"),
             (f.all_reduce_coalesced, "all-reduce"),
             (f.reduce_scatter_tensor, "reduce-scatter"),
             (f.reduce_scatter_tensor_coalesced, "reduce-scatter"),
             (f.all_to_all_single, "all-to-all"),
             (c.allreduce_, "all-reduce"), (c.allgather_, "all-gather"),
             (c._allgather_base_, "all-gather"),
             (c.reduce_scatter_, "reduce-scatter"),
             (c._reduce_scatter_base_, "reduce-scatter"),
             (c.alltoall_base_, "all-to-all"),
             (c.send, "collective-permute")]
    if hasattr(torch.ops, "_dtensor"):
        pairs.append((torch.ops._dtensor.shard_dim_alltoall, "all-to-all"))
    return dict(pairs)


_planning = threading.local()


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(*groups):
    """The tensors among `groups` (an op's args, kwargs values, outputs:
    tensors, or lists and tuples of them)."""
    out = []
    for group in groups:
        for x in group:
            if isinstance(x, torch.Tensor):
                out.append(x)
            elif isinstance(x, (list, tuple)):
                out.extend(t for t in x if isinstance(t, torch.Tensor))
    return out


class OpCounter(TorchDispatchMode):
    """Counts the ops run under it (see the module docstring); `summary()`
    gives the reference's keys.  Enter it where the step starts: the
    live-set peak is measured from there."""

    def __init__(self):
        super().__init__()
        self.dot_flops = 0
        self.fusion_io_bytes = 0
        self.transcendentals = 0
        self.collectives = {k: 0 for k in COLLECTIVES}
        self.collective_count = 0
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, int] = {}
        self._kinds = _collective_kinds()
        self._unpatch = None

    def __enter__(self):
        self._unpatch = _mark_sharding_propagation()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._unpatch()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # count the local ops DTensor runs
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if getattr(_planning, "on", False):
            return out                  # global-shape metadata run
        ins = _tensors(args, kwargs.values())
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,))
        packet = func.overloadpacket
        if packet in self._kinds or func in self._kinds:
            kind = self._kinds.get(packet) or self._kinds[func]
            self.collectives[kind] += sum(_nbytes(t) for t in ins)
            self.collective_count += 1
        elif func in _DOTS:
            lhs = args[_DOTS[func]]
            self.dot_flops += 2 * out.numel() * lhs.shape[-1]
        if func in _TRANSCENDENTAL:
            self.transcendentals += out.numel()
        if not func.is_view and func not in _NO_TRAFFIC:
            self.fusion_io_bytes += sum(_nbytes(t) for t in ins + outs)
        given = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            self._hold(t, given)
        return out

    def _hold(self, t, given) -> None:
        """Track `t`'s storage from here to its release, unless it is an
        input's (a view, an in-place result) or already tracked."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages or key in given:
            return
        n = st.nbytes()
        self._storages[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live -= self._storages.pop(key, 0)

    def summary(self) -> Dict[str, Any]:
        return {"dot_flops": self.dot_flops,
                "fusion_io_bytes": self.fusion_io_bytes,
                "collectives": dict(self.collectives),
                "collective_bytes": sum(self.collectives.values()),
                "collective_count": self.collective_count,
                "transcendentals": self.transcendentals}


def _mark_sharding_propagation():
    """Set `_planning.on` while DTensor propagates an op's sharding and
    metadata (runs of the op, or of its decomposition, on fake tensors of
    the global shapes); returns the undo.  Every entry point of the
    propagator that `DTensor` dispatches through is wrapped on the
    instance, those of older and newer torch alike."""
    from torch.distributed.tensor import DTensor

    prop = DTensor._op_dispatcher.sharding_propagator
    saved = {}
    for name in ("propagate_op_sharding", "propagate_op_sharding_non_cached",
                 "_propagate_tensor_meta", "_propagate_tensor_meta_non_cached"):
        if not hasattr(prop, name):
            continue
        saved[name] = prop.__dict__.get(name)
        setattr(prop, name, _marked(getattr(prop, name)))

    def undo():
        for name, was in saved.items():
            if was is None:
                del prop.__dict__[name]
            else:
                setattr(prop, name, was)

    return undo


def _marked(inner):
    def run(*a, **k):
        before = getattr(_planning, "on", False)
        _planning.on = True
        try:
            return inner(*a, **k)
        finally:
            _planning.on = before
    return run


def analyze_step(fn, *args, **kwargs) -> Dict[str, Any]:
    """Run `fn(*args, **kwargs)` once under an `OpCounter` and return its
    per-device counts (the reference's `analyze_hlo` keys, and
    `peak_bytes`: the live-set peak of what the step made)."""
    with OpCounter() as c:
        fn(*args, **kwargs)
    out = c.summary()
    out["peak_bytes"] = c.peak
    return out
