"""Carry training state between the JAX reference and the port.

A reference state is a tree of numpy arrays (params, opt {m, v, count},
step), as `repro.core.checkpoint.CheckpointManager.restore` returns it
or as `np.asarray` makes it from live JAX arrays.  The port's state is
the same tree of tensors.  Leaf paths, shapes and dtypes are the same in
both packages, so the conversion is leafwise; the tests use it to feed
both packages the same parameters (JAX's threefry init is never
matched).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import tree_map


def state_from_numpy(tree, device):
    """Numpy-leaf tree -> tensor tree on `device` (copies)."""
    return tree_map(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(device), tree)


def state_to_numpy(state):
    """Tensor tree -> numpy-leaf tree on the host (copies)."""
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), state)
