"""Plain versions of blockwise absmax int8 quantization.

Per block of QBLOCK values: amax = max|x|, scale = amax / 127 (1 when
amax == 0), q = clip(round-half-even(x / scale), -127, 127) as int8;
the input is flattened, taken to f32 and zero-padded to whole blocks.
Dequantization is x = f32(q) * scale, with the pad dropped.
`quantize_np` / `dequantize_np` are the reference's numpy twins, copied
verbatim (`repro.kernels.quantize.ref`).  `quantize_torch` and
`dequantize_torch` are the plain PyTorch versions that a CPU tensor
takes and that the CUDA kernels are held against.
"""
from __future__ import annotations

import numpy as np

QBLOCK = 1024  # elements per quantization block


def quantize_np(x: np.ndarray):
    flat = np.ravel(x).astype(np.float32)
    pad = (-flat.size) % QBLOCK
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, np.float32)])
    blocks = flat.reshape(-1, QBLOCK)
    amax = np.max(np.abs(blocks), axis=-1, keepdims=True)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(blocks / scale), -127, 127).astype(np.int8)
    return q, scale, pad


def dequantize_np(q: np.ndarray, scale: np.ndarray, pad: int, shape, dtype):
    out = (q.astype(np.float32) * scale).ravel()
    if pad:
        out = out[:-pad]
    return out.reshape(shape).astype(dtype)


def quantize_torch(flat):
    """Flat f32 tensor -> (q int8 (n, QBLOCK), scales f32 (n, 1), pad)."""
    import torch

    pad = (-flat.numel()) % QBLOCK
    blocks = torch.nn.functional.pad(flat, (0, pad)).view(-1, QBLOCK)
    amax = blocks.abs().amax(dim=-1, keepdim=True)
    # divide by a full tensor, not a scalar: PyTorch's CUDA division by a
    # scalar multiplies by its reciprocal, which is not IEEE amax / 127
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale, pad


def dequantize_torch(q, scales, n: int):
    """Flat int8 codes and f32 scales -> the first `n` values, f32."""
    import torch

    return (q.view(-1, QBLOCK).to(torch.float32)
            * scales.view(-1, 1)).reshape(-1)[:n]
