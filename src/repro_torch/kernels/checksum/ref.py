"""Plain versions of the blockwise Fletcher-style checksum.

Definition (the reference's, `repro.kernels.checksum.ref`): the bytes
are read as little-endian uint32 words in blocks of BLOCK words, the
last block zero-padded;

  per block b: s1_b = sum(w), s2_b = sum(i * w)
  fold:        f1 = sum(s1_b * (b+1)), f2 = sum(s2_b * (b+1)^2)
  digest:      f1 ^ (f2 << 1)

all mod 2^32.  `checksum_np` is the reference's numpy twin, copied
verbatim (the host path for bytes that live on the host);
`checksum_torch` is the plain PyTorch version that a CPU tensor takes
and that the CUDA kernel is held against.
"""
from __future__ import annotations

import numpy as np

BLOCK = 2048  # uint32 words per block

_M32 = 0xFFFFFFFF


def _block_sums_np(words: np.ndarray, idx: np.ndarray):
    s1 = np.add.reduce(words, axis=-1, dtype=np.uint32)
    s2 = np.add.reduce((words * idx).astype(np.uint32), axis=-1,
                       dtype=np.uint32)
    return s1, s2


def checksum_np(data: np.ndarray) -> int:
    """NumPy twin used on the host write path (identical definition).

    Vectorized over the WHOLE buffer in place: the aligned prefix is a
    zero-copy uint32 view (no pad-and-concatenate copy of the full
    payload — this sits on the per-shard digest hot path of both
    checkpoint pipelines); only the final partial block (< 8 KiB) is
    padded.  Zero padding contributes nothing to either partial sum, so
    the result is bit-identical to the padded-whole-buffer definition
    the Pallas kernel and the jnp oracle implement."""
    raw = np.ascontiguousarray(data).view(np.uint8).ravel()
    blk_bytes = 4 * BLOCK
    n_full = raw.size - raw.size % blk_bytes
    idx = np.arange(BLOCK, dtype=np.uint32)
    with np.errstate(over="ignore"):
        words = raw[:n_full].view("<u4").reshape(-1, BLOCK)
        s1, s2 = _block_sums_np(words, idx)
        if n_full < raw.size:  # pad ONLY the tail block
            tail = np.zeros(blk_bytes, np.uint8)
            tail[:raw.size - n_full] = raw[n_full:]
            t1, t2 = _block_sums_np(tail.view("<u4").reshape(1, BLOCK), idx)
            s1 = np.concatenate([s1, t1])
            s2 = np.concatenate([s2, t2])
        pos = (np.arange(s1.shape[0], dtype=np.uint32) + np.uint32(1))
        f1 = np.add.reduce(s1 * pos, dtype=np.uint32)
        f2 = np.add.reduce(s2 * pos * pos, dtype=np.uint32)
    return int(f1 ^ np.uint32((int(f2) << 1) & 0xFFFFFFFF))


def checksum_torch(raw, byte_offset: int = 0, nbytes=None) -> int:
    """Plain PyTorch checksum of `nbytes` bytes of the flat uint8 tensor
    `raw` from `byte_offset`, on whatever device `raw` lies on.

    PyTorch has no uint32 sum on the CPU, so the mod-2^32 arithmetic runs
    in int64 with a mask after every product: a word times its index is
    below 2^43 and 2048 of them sum below 2^54; the fold masks
    s2_b * (b+1) before the second factor, which would otherwise pass
    2^63 for large block counts."""
    import torch

    if nbytes is None:
        nbytes = raw.numel() - byte_offset
    b = raw[byte_offset:byte_offset + nbytes]
    blk = 4 * BLOCK
    n_blocks = -(-nbytes // blk)
    if n_blocks == 0:
        return 0
    padded = torch.zeros(n_blocks * blk, dtype=torch.uint8, device=b.device)
    padded[:nbytes] = b
    by = padded.view(n_blocks, BLOCK, 4)
    words = by[..., 0].to(torch.int64)
    for k in (1, 2, 3):
        words |= by[..., k].to(torch.int64) << (8 * k)
    idx = torch.arange(BLOCK, dtype=torch.int64, device=b.device)
    s1 = words.sum(-1) & _M32
    s2 = (words * idx).sum(-1) & _M32
    pos = torch.arange(1, n_blocks + 1, dtype=torch.int64, device=b.device)
    f1 = int(((s1 * pos) & _M32).sum()) & _M32
    f2 = int(((((s2 * pos) & _M32) * pos) & _M32).sum()) & _M32
    return f1 ^ ((f2 << 1) & _M32)
