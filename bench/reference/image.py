"""Plain reader of the checkpoint image format, with frozen copies of
its digest and its int8 decode, to judge what the program wrote.

An image is a directory: `manifest.json` (committed last) lists each
array's shape, dtype, encoding and chunk files, each chunk with its
digest.  Encodings read here: "raw" (the array's little-endian bytes)
and "int8_block" (part 0: int8 codes of blocks of 1024 values, the last
block zero-padded by `pad`; part 1: one f32 scale a block; value = code
x scale).  The digest of a chunk reads its bytes as little-endian
uint32 words in blocks of 2048 words, the last zero-padded: per block b,
s1_b = sum(w), s2_b = sum(i x w_i); f1 = sum(s1_b (b+1)), f2 =
sum(s2_b (b+1)^2); digest = f1 ^ (f2 << 1), all mod 2^32.

It imports nothing of the program.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import numpy as np
import torch

WORDS = 2048
QBLOCK = 1024
M32 = 0xFFFFFFFF


def digest(raw: torch.Tensor) -> int:
    """The digest of a flat uint8 tensor's bytes, on its device (int64
    arithmetic masked to 32 bits after every product)."""
    n = raw.numel()
    nblk = -(-n // (4 * WORDS))
    if nblk == 0:
        return 0
    padded = torch.zeros(nblk * 4 * WORDS, dtype=torch.uint8,
                         device=raw.device)
    padded[:n] = raw
    b = padded.view(nblk, WORDS, 4).to(torch.int64)
    words = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)
    i = torch.arange(WORDS, dtype=torch.int64, device=raw.device)
    s1 = words.sum(-1) & M32
    s2 = (words * i).sum(-1) & M32
    pos = torch.arange(1, nblk + 1, dtype=torch.int64, device=raw.device)
    f1 = int(((s1 * pos) & M32).sum()) & M32
    f2 = int(((((s2 * pos) & M32) * pos) & M32).sum()) & M32
    return f1 ^ ((f2 << 1) & M32)


def dequantize(q: torch.Tensor, scales: torch.Tensor, pad: int, shape):
    """int8 codes and f32 block scales -> f32 values of `shape`."""
    vals = (q.view(-1, QBLOCK).to(torch.float32)
            * scales.view(-1, 1)).reshape(-1)
    return vals[:vals.numel() - pad].reshape(shape)


def read_image(step_dir: str, device) -> Tuple[Dict[str, torch.Tensor],
                                               Dict[str, dict], Dict, Dict]:
    """(arrays by path decoded on `device`, the int8 arrays' codes and
    scales by path, the manifest's `extra`, a report: chunks read, bytes
    and the chunks whose digest differs from the manifest's)."""
    with open(os.path.join(step_dir, "manifest.json")) as f:
        man = json.load(f)
    arrays, coded = {}, {}
    report = {"chunks": 0, "bytes": 0, "bad_digests": []}
    for path, entry in sorted(man["arrays"].items()):
        parts: Dict[int, list] = {}
        for fm in entry["files"]:
            host = np.fromfile(os.path.join(step_dir, fm["file"]),
                               dtype=np.uint8)
            chunk = torch.from_numpy(host).to(device)
            if digest(chunk) != fm["checksum"] or chunk.numel() != fm["nbytes"]:
                report["bad_digests"].append(fm["file"])
            report["chunks"] += 1
            report["bytes"] += chunk.numel()
            parts.setdefault(fm["part"], []).append(chunk)
        data = [torch.cat(parts[i]) for i in sorted(parts)]
        shape = tuple(entry["shape"])
        if entry.get("compressed"):
            raise ValueError(f"{path}: compressed payloads are not read here")
        if entry["encoding"] == "raw":
            dt = getattr(torch, entry["dtype"])
            arrays[path] = data[0].view(dt).reshape(shape)
        elif entry["encoding"] == "int8_block":
            q, s = data[0].view(torch.int8), data[1].view(torch.float32)
            coded[path] = {"q": q, "scales": s, "pad": entry["pad"]}
            arrays[path] = dequantize(q, s, entry["pad"], shape)
        else:
            raise ValueError(f"{path}: encoding {entry['encoding']} is not "
                             f"one the benchmark's cells write")
    return arrays, coded, man["extra"], report


def quantization_error(orig: torch.Tensor, coded: dict) -> float:
    """The largest |orig - decoded| of an int8 array over half its
    block's scale (the codec's guarantee: at most 1), in float64."""
    q = coded["q"].view(-1, QBLOCK).to(torch.float64)
    s = coded["scales"].view(-1, 1).to(torch.float64)
    x = orig.reshape(-1).to(torch.float64)
    x = torch.cat([x, x.new_zeros(coded["pad"])]).view(-1, QBLOCK)
    return float(((x - q * s).abs() / (s / 2)).max())


ODD = -7046029254386353131     # 0x9E3779B97F4A7C15 as a signed int64


def fingerprint(x: torch.Tensor, chunk: int = 1 << 24) -> torch.Tensor:
    """Two int64 sums, wrapping, of a tensor's bits on its device: of its
    4-byte words (or bytes), and of each word times an odd weight drawn
    from its position.  Equal bits give equal sums; a changed value
    changes both, and a moved one the second.  Returned on the device,
    so that taking it does not wait for the device."""
    flat = x.detach().reshape(-1)
    flat = (flat.view(torch.int32) if flat.element_size() == 4
            else flat.view(torch.uint8))
    out = torch.zeros(2, dtype=torch.int64, device=x.device)
    for lo in range(0, flat.numel(), chunk):
        w = flat[lo:lo + chunk].to(torch.int64)
        pos = torch.arange(lo, lo + w.numel(), dtype=torch.int64,
                           device=x.device)
        out[0] += w.sum()
        out[1] += (w * (pos * ODD | 1)).sum()
    return out


def fingerprints(flat: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: fingerprint(v) for k, v in flat.items()}


def differing(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]):
    """Paths whose fingerprints differ or that only one side has."""
    out = sorted(set(a) ^ set(b))
    return out + [k for k in sorted(set(a) & set(b))
                  if not torch.equal(a[k].cpu(), b[k].cpu())]
