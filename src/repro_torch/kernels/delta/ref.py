"""Plain versions of the XOR byte delta between checkpoints.

XOR against the base image turns unchanged bytes into zero runs and is
its own inverse, so one function encodes and applies; it works on the
bit pattern and is exact for every dtype.  `delta_np` / `apply_np` are
the reference's numpy twins, copied verbatim (`repro.kernels.delta.ref`);
`xor_torch` is the plain PyTorch version that a CPU tensor takes and
that the CUDA kernel is held against.
"""
from __future__ import annotations

import numpy as np


def delta_np(cur: np.ndarray, prev: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(cur).view(np.uint8).ravel()
    b = np.ascontiguousarray(prev).view(np.uint8).ravel()
    assert a.size == b.size
    return a ^ b


def apply_np(prev: np.ndarray, delta: np.ndarray, shape, dtype) -> np.ndarray:
    b = np.ascontiguousarray(prev).view(np.uint8).ravel()
    out = (b ^ delta).view(np.dtype(dtype))
    return out.reshape(shape)


def xor_torch(a, b):
    """Flat uint8 tensors of equal length -> a new uint8 tensor a ^ b."""
    import torch

    return torch.bitwise_xor(a, b)
