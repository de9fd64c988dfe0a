"""Per-block rematerialisation policies, the reference's `_remat`
(`repro.models.transformer`): "none" keeps every activation, "full"
keeps only a block's inputs and recomputes the rest in the backward,
"dots" keeps every matrix product's output, and "comm" keeps only the
block outputs named "attn_out", "mixer_out" and "mlp_out".

"full" is `torch.utils.checkpoint` (non-reentrant); "dots" and "comm"
are its selective form (`create_selective_checkpoint_contexts`), whose
policy sees each op as it is dispatched, never a value's name.  Under
"dots" the attention core is one product (`saved_result`).  So a
name marks the code that makes the value: `checkpoint_name(name)` around
the op that produces it (the reference's `checkpoint_name` tags the
value after it).  Under "comm" every op run inside a named block is
saved, but for views, reshapes and copies (dtype casts, the contiguous
copies and reshapes an einsum makes of its operands), so the backward's
recompute takes the saved output in place of running that op again, as
XLA drops the recompute of a saved value.  Values do not change under
any policy: only what is kept and what is recomputed.
"""
from __future__ import annotations

import contextlib
import functools
import threading

import torch
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

aten = torch.ops.aten
MATMULS = frozenset({aten.mm.default, aten.addmm.default, aten.bmm.default,
                     aten.baddbmm.default, aten.mv.default, aten.dot.default})
COMM_NAMES = ("attn_out", "mixer_out", "mlp_out")
# copies and reshapes, not the named value: never saved by "comm"
_COPIES = frozenset({aten._to_copy.default, aten.clone.default,
                     aten._unsafe_view.default})

_named = threading.local()


@contextlib.contextmanager
def checkpoint_name(name: str):
    """The ops run inside make the value called `name` (read by the
    "comm" policy; a no-op elsewhere)."""
    before = getattr(_named, "name", None)
    _named.name = name
    try:
        yield
    finally:
        _named.name = before


def _save_dots(ctx, func, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if func in MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _save_comm(ctx, func, *args, **kwargs):
    named = getattr(_named, "name", None) in COMM_NAMES
    keep = named and not func.is_view and func not in _COPIES
    return (CheckpointPolicy.MUST_SAVE if keep
            else CheckpointPolicy.PREFER_RECOMPUTE)


_results = threading.local()


@contextlib.contextmanager
def _results_kept(mode, inner):
    """`inner` (a selective checkpoint context), with `saved_result` in
    `mode`: ("keep", list) in a block's forward, ("reuse", list) in its
    recompute."""
    before = getattr(_results, "mode", None)
    _results.mode = mode
    try:
        with inner:
            yield
    finally:
        _results.mode = before


def _dots_contexts():
    forward, recompute = create_selective_checkpoint_contexts(_save_dots)
    kept = []
    return (_results_kept(("keep", kept), forward),
            _results_kept(("reuse", kept), recompute))


def saved_result(fn, *args):
    """`fn(*args)`, a function that is one product to "dots" (the
    attention core: its score products are internal, as in the
    reference's custom VJP, whose residuals XLA's remat keeps).  In a
    block's forward under "dots" it runs outside the selective
    checkpoint's record and its result is kept; in the block's recompute
    the kept result stands in for running it again.  So "dots" neither
    recomputes the core's products nor saves its score tensors."""
    from torch.utils._python_dispatch import (_get_current_dispatch_mode,
                                              _pop_mode_temporarily)

    mode = getattr(_results, "mode", None)
    if mode is None:
        return fn(*args)
    step, kept = mode
    if step == "reuse":
        got = kept.pop(0)
        return fn(*args) if got is None else got
    if type(_get_current_dispatch_mode()).__name__ != \
            "_CachingTorchDispatchMode":
        kept.append(None)       # recorded as it runs: recomputed as usual
        return fn(*args)
    with _pop_mode_temporarily():
        out = fn(*args)
    kept.append(tuple(t.detach() for t in out))
    return out


def checkpoint_kwargs(policy: str) -> dict:
    """`torch.utils.checkpoint.checkpoint` keywords for a policy other
    than "none" (any name but "dots" and "comm" is "full", as in the
    reference)."""
    kw = {"use_reentrant": False, "preserve_rng_state": False}
    if policy == "dots":
        kw["context_fn"] = _dots_contexts
    elif policy == "comm":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_comm)
    return kw
