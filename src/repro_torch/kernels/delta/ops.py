"""XOR delta entry point: the CUDA kernel for CUDA tensors
(`csrc/delta.cu`), the plain PyTorch version for CPU tensors."""
from __future__ import annotations

import sys

from repro_torch.kernels import _build, as_bytes, count_launch, require_cuda
from repro_torch.kernels.delta import ref

launches = 0  # kernel launches (the plain version does not count)


def xor_bytes(a, b):
    """Byte-wise a ^ b of two tensors with the same byte length (any
    dtypes) -> a new flat uint8 tensor.  Encodes a delta (cur ^ base)
    and applies one (base ^ delta)."""
    import torch

    ra, rb = as_bytes(a), as_bytes(b)
    if ra.numel() != rb.numel():
        raise ValueError(f"xor of {ra.numel()} and {rb.numel()} bytes")
    if ra.device != rb.device:
        raise ValueError(f"xor across devices {ra.device} and {rb.device}")
    if ra.device.type == "cpu":
        return ref.xor_torch(ra, rb)
    require_cuda(ra, "xor_bytes")
    out = torch.empty_like(ra)
    if ra.numel() == 0:
        return out
    lib = _build.library("delta")
    with torch.cuda.device(ra.device):
        _build.check(lib.xor_launch(ra.data_ptr(), rb.data_ptr(),
                                    out.data_ptr(), ra.numel(),
                                    _build.stream_ptr(ra)), "xor_bytes")
    count_launch(sys.modules[__name__])
    return out
