"""int8 quantize and dequantize entry points: the CUDA kernels for CUDA
tensors (`csrc/quantize.cu`), the plain PyTorch versions for CPU
tensors."""
from __future__ import annotations

import math
import sys

from repro_torch.kernels import _build, count_launch, require_cuda
from repro_torch.kernels.quantize import ref

# kernel launches (the plain versions do not count)
launches = 0              # quantize
dequantize_launches = 0


def quantize(x):
    """Any-shape float tensor -> (q int8 (n, QBLOCK), scales f32 (n, 1),
    pad), bit for bit `ref.quantize_np`.  f16/bf16 inputs go to f32
    first, as the reference does; the ragged last block is read as
    zeros and never padded on the device."""
    import torch

    flat = x.reshape(-1)
    if flat.dtype != torch.float32:
        flat = flat.to(torch.float32)
    flat = flat.contiguous()
    if flat.device.type == "cpu":
        return ref.quantize_torch(flat)
    require_cuda(flat, "quantize")
    n = flat.numel()
    n_rows = -(-n // ref.QBLOCK)
    q = torch.empty((n_rows, ref.QBLOCK), dtype=torch.int8, device=flat.device)
    scales = torch.empty((n_rows, 1), dtype=torch.float32, device=flat.device)
    if n:
        lib = _build.library("quantize")
        with torch.cuda.device(flat.device):
            _build.check(lib.quantize_launch(
                flat.data_ptr(), n, q.data_ptr(), scales.data_ptr(),
                _build.stream_ptr(flat)), "quantize")
        count_launch(sys.modules[__name__])
    return q, scales, (-n) % ref.QBLOCK


def dequantize(q, scales, pad: int, shape, dtype=None):
    """int8 blocks (n, QBLOCK) and f32 scales (n, 1), either may be flat,
    with the `pad` of `quantize` -> a tensor of `shape` in `dtype` (f32
    by default) on their device, bit for bit `ref.dequantize_np`.  Only
    the array's own values are computed: the pad is never
    materialised."""
    import torch

    dtype = torch.float32 if dtype is None else dtype
    q, scales = q.reshape(-1).contiguous(), scales.reshape(-1).contiguous()
    if q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"dequantize takes int8 codes and f32 scales, got "
                        f"{q.dtype} and {scales.dtype}")
    if q.device != scales.device:
        raise ValueError(f"dequantize across devices {q.device} and "
                         f"{scales.device}")
    n = math.prod(shape)
    if q.numel() != scales.numel() * ref.QBLOCK or n != q.numel() - pad:
        raise ValueError(f"{q.numel()} codes, {scales.numel()} scales and "
                         f"pad {pad} do not hold an array of shape {shape}")
    if q.device.type == "cpu":
        return ref.dequantize_torch(q, scales, n).reshape(shape).to(dtype)
    require_cuda(q, "dequantize")
    x = torch.empty(n, dtype=torch.float32, device=q.device)
    if n:
        lib = _build.library("quantize")
        with torch.cuda.device(q.device):
            _build.check(lib.dequantize_launch(
                q.data_ptr(), scales.data_ptr(), n, x.data_ptr(),
                _build.stream_ptr(q)), "dequantize")
        count_launch(sys.modules[__name__], "dequantize_launches")
    return x.reshape(shape).to(dtype)
