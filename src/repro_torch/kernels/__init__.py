"""Hand-written Hopper kernels of the checkpoint data path (checksum,
XOR delta, int8 quantize and dequantize), each beside its plain PyTorch
version.

A wrapper (`<kernel>/ops.py`) dispatches by its input's device: a CUDA
tensor launches the kernel built from `<kernel>/csrc/*.cu` (see
`_build.py`) or raises; a CPU tensor takes the plain version.  Each
wrapper counts its kernel launches in a module-level counter
(`launches`; `dequantize_launches` beside it in `quantize.ops`).
"""
from __future__ import annotations

import threading

_count_lock = threading.Lock()


def as_bytes(t):
    """A contiguous tensor's bytes as a flat uint8 view (0-d included)."""
    import torch

    if not t.is_contiguous():
        raise ValueError("kernel inputs must be contiguous")
    flat = t.reshape(-1)
    return flat if flat.dtype == torch.uint8 else flat.view(torch.uint8)


def count_launch(module, counter: str = "launches") -> None:
    """Add one to `module.<counter>` (wrappers run on writer threads too)."""
    with _count_lock:
        setattr(module, counter, getattr(module, counter) + 1)


def require_cuda(t, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: tensor on {t.device}; the kernel takes "
                         f"CUDA tensors and the plain version CPU tensors")
