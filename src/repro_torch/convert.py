"""Carry state between the JAX reference and the port.

A reference state is a tree of numpy arrays (training state: params,
opt {m, v, count}, step; decode state: pos, layers {k, v}), as
`repro.core.checkpoint.CheckpointManager.restore` returns it or as
`np.asarray` makes it from live JAX arrays.  The port's state is the
same tree of tensors.  Leaf paths, shapes and dtypes are the same in
both packages, so the conversion is leafwise; the tests use it to feed
both packages the same parameters and caches (JAX's threefry init is
never matched).

bfloat16 leaves (decode caches) cross bit for bit without `ml_dtypes`,
which the port does not depend on: going in, an array whose dtype is
named "bfloat16" is read through its uint16 bit pattern; going out, a
bf16 tensor comes back as that uint16 bit pattern, or viewed as the
caller's own bfloat16 numpy dtype when one is given.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import tree_map


def _to_tensor(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(a.view(np.int16), copy=True))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def state_from_numpy(tree, device):
    """Numpy-leaf tree -> tensor tree on `device` (copies)."""
    return tree_map(lambda a: _to_tensor(a, device), tree)


def _to_numpy(t, bfloat16):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).numpy().view(np.uint16).copy()
        return bits if bfloat16 is None else bits.view(bfloat16)
    return t.numpy().copy()


def state_to_numpy(state, bfloat16=None):
    """Tensor tree -> numpy-leaf tree on the host (copies).  bf16 leaves
    come out as their uint16 bit patterns, or as arrays of `bfloat16`
    (a numpy dtype the caller provides, e.g. `ml_dtypes.bfloat16`)."""
    return tree_map(lambda t: _to_numpy(t, bfloat16), state)
