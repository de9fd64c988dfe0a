"""Checksum entry point: the CUDA kernel for a CUDA tensor
(`csrc/checksum.cu`), the plain PyTorch version for a CPU tensor."""
from __future__ import annotations

import ctypes
import sys

from repro_torch.kernels import _build, as_bytes, count_launch, require_cuda
from repro_torch.kernels.checksum import ref

launches = 0  # kernel launches (the plain version does not count)


def checksum(t, byte_offset: int = 0, nbytes=None) -> int:
    """uint32 digest of `nbytes` bytes of tensor `t` from `byte_offset`
    (default: to the end), bit for bit `ref.checksum_np` of those bytes.
    The bytes are read in place; only the digest comes back."""
    import torch

    raw = as_bytes(t)
    if nbytes is None:
        nbytes = raw.numel() - byte_offset
    if byte_offset < 0 or nbytes < 0 or byte_offset + nbytes > raw.numel():
        raise ValueError(f"byte range [{byte_offset}, +{nbytes}) outside a "
                         f"{raw.numel()}-byte tensor")
    if raw.device.type == "cpu":
        return ref.checksum_torch(raw, byte_offset, nbytes)
    require_cuda(raw, "checksum")
    if nbytes == 0:
        return 0
    lib = _build.library("checksum")
    n_blocks = -(-nbytes // (4 * ref.BLOCK))
    sums = torch.empty((n_blocks, 2), dtype=torch.int32, device=raw.device)
    out = torch.empty((1,), dtype=torch.int32, device=raw.device)
    with torch.cuda.device(raw.device):
        _build.check(lib.checksum_launch(
            ctypes.c_void_p(raw.data_ptr() + byte_offset), nbytes,
            sums.data_ptr(), out.data_ptr(), _build.stream_ptr(raw)),
            "checksum")
    count_launch(sys.modules[__name__])
    return int(out.item()) & 0xFFFFFFFF
