"""Checkpoint images on the card: the upper-half persistence layer
(paper §II-A, §II-B), port of `repro.core.checkpoint`.

The image format is the reference's byte for byte: per-array chunk
files with a Fletcher digest each, a manifest written last and
committed by atomic rename, the same codec stack (`repro_torch.core.
codec`: int8 moments, XOR-delta against the previous image, raw), the
same chain policy, retire dance and GC.  An image written by either
package restores in the other.

What moves to the card:
  * snapshot: `save_async` copies every state tensor to a fresh tensor
    on `device` (one device-to-device copy), so training may go on, and
    even update in place, while the writer thread encodes;
  * write: codecs run on the card (XOR and quantize kernels), each
    payload chunk is digested on the card over the tensor's own bytes
    at that chunk's byte range, and only the payload is copied to the
    host for the file.  With `compress=True` the payload is deflated on
    the host and the compressed bytes are digested there;
  * restore: each chunk is read, uploaded into its slice of the
    array's payload on `device`, verified there with the checksum
    kernel, and decoded on the card by the XOR and dequantize kernels (a
    delta base is read back the same way, so an XOR is always against
    the base image's decoded bytes).

`device=None` means "cuda" and raises when CUDA is absent; tests pass
`device="cpu"`, which takes each kernel's plain PyTorch version.
Sharded restore onto a mesh is not ported (ROADMAP.md).
"""
from __future__ import annotations

import json
import os
import shutil
import time
import zlib
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.codec import (DEFAULT_COMPRESS_LEVEL, ChainPolicy,
                                    CheckpointError, DeltaChainError,
                                    DeltaCodec, ImageCodec, ImageError,
                                    ImageIntegrityError, QuantizeCodec,
                                    RawCodec, dtype_name, shard_digest)

__all__ = ["CheckpointManager", "CheckpointError", "ImageError",
           "ImageIntegrityError", "DeltaChainError", "MANIFEST"]

MANIFEST = "manifest.json"
CHUNK_BYTES = 64 << 20  # 64 MiB chunks (burst-buffer-friendly writes)


def _flatten(tree, prefix="") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif (isinstance(tree, (list, tuple))
          and type(tree).__name__ != "PartitionSpec"):
        # PartitionSpec IS a tuple subclass but is a spec-tree LEAF: an
        # empty P() would otherwise vanish and a P('data', ...) would
        # shred into per-element paths, so elastic restore would bind
        # every array replicated (checked by name to keep jax lazy here)
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


class _EncodeCtx:
    """Write-side codec context: the delta base image (if the chain
    policy allows another delta)."""

    def __init__(self, mgr: "CheckpointManager", base_step: Optional[int]):
        self._mgr = mgr
        self.base_step = base_step

    def base_array(self, path: str) -> Optional[np.ndarray]:
        if self.base_step is None:
            return None
        return self._mgr._read_array(self._mgr.step_dir(self.base_step),
                                     path)


class _DecodeCtx:
    """Read-side codec context: resolves a path's delta base from
    another step's image, with the chain-depth bound enforced."""

    def __init__(self, mgr: "CheckpointManager", path: str, depth: int):
        self._mgr = mgr
        self._path = path
        self._depth = depth

    def read_base(self, step: int) -> Optional[np.ndarray]:
        return self._mgr._read_array(self._mgr.step_dir(step), self._path,
                                     _depth=self._depth + 1)


class CheckpointManager:
    """File-image checkpoint store with a pluggable codec stack, on a
    device.

    >>> import tempfile, torch
    >>> mgr = CheckpointManager(tempfile.mkdtemp(), keep=2,
    ...                         delta_keys=("w",), device="cpu")
    >>> _ = mgr.save(1, {"w": torch.zeros(512)})
    >>> _ = mgr.save(2, {"w": torch.ones(512)})   # XOR delta vs 1
    >>> mgr.steps()
    [1, 2]
    >>> out, extra = mgr.restore()          # newest step, chain rebuilt
    >>> float(out["w"].sum())
    512.0

    Keywords are the reference's, plus `device`, less `use_pallas`
    (the tensors' device selects the kernels).
    """

    def __init__(self, directory: str, keep: int = 3,
                 quantize_keys: Tuple[str, ...] = (),
                 delta_keys: Tuple[str, ...] = (), verify: bool = True,
                 full_every: int = 4, max_chain: int = ChainPolicy.max_chain,
                 codecs: Optional[Sequence[ImageCodec]] = None,
                 compress: bool = False,
                 compress_level: int = DEFAULT_COMPRESS_LEVEL, device=None):
        self.device = resolve_device(device)
        self.dir = directory
        self.keep = keep
        self.verify = verify
        self.compress = compress
        # deflate level for compress=True payload chunks
        self.compress_level = compress_level
        # delta checkpoints form chains; bound them with periodic fulls
        # on the write side and a reconstruction-depth cap on the read
        # side (the two sides may be different processes/configs)
        self.full_every = max(1, full_every)
        self.max_chain = max_chain
        self._since_full = 0
        if codecs is None:
            codecs = []
            if quantize_keys:
                codecs.append(QuantizeCodec(tuple(quantize_keys)))
            if delta_keys:
                codecs.append(DeltaCodec(tuple(delta_keys)))
        self.codecs: List[ImageCodec] = list(codecs) + [RawCodec()]
        # decode must handle EVERY known encoding regardless of the
        # configured write stack (a fresh manager reads old images)
        self._decoders: Dict[str, ImageCodec] = {}
        for codec in [*self.codecs, QuantizeCodec(), DeltaCodec()]:
            self._decoders.setdefault(codec.name, codec)
        os.makedirs(directory, exist_ok=True)
        # crash recovery for the re-checkpoint retire dance (_write): a
        # kill between retiring the old image and committing the new
        # one leaves the only valid image under retired.* — put it back;
        # a retired dir whose step also has a committed image is trash
        for name in os.listdir(directory):
            if not name.startswith("retired.ckpt_"):
                continue
            retired = os.path.join(directory, name)
            d = os.path.join(directory, name[len("retired."):])
            if os.path.exists(os.path.join(d, MANIFEST)):
                shutil.rmtree(retired, ignore_errors=True)
            else:
                shutil.rmtree(d, ignore_errors=True)  # partial commit
                os.replace(retired, d)
        self._writer = ThreadPoolExecutor(max_workers=1,
                                          thread_name_prefix="ckpt-writer")
        self._pending: Optional[Future] = None
        self.stats: List[Dict] = []

    # ---- public API -----------------------------------------------------------
    def step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:010d}")

    def save_async(self, step: int, state_tree, logical_tree=None,
                   extra: Optional[Dict] = None) -> Future:
        """Snapshot now (a copy on the device), write in the background.

        Returns a Future resolving to write stats.  A second save while
        one is in flight waits for it first (double buffering).
        """
        self.wait()
        t0 = time.monotonic()
        snap = _snapshot(state_tree, self.device)
        snap_s = time.monotonic() - t0
        logical_flat = (
            {k: list(v) if isinstance(v, tuple) else None
             for k, v in _flatten(logical_tree).items()}
            if logical_tree is not None else {})
        fut = self._writer.submit(self._write, step, snap, logical_flat,
                                  extra or {}, snap_s)
        self._pending = fut
        return fut

    def save(self, step: int, state_tree, logical_tree=None,
             extra: Optional[Dict] = None) -> Dict:
        return self.save_async(step, state_tree, logical_tree, extra).result()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            p = os.path.join(self.dir, name, MANIFEST)
            if name.startswith("ckpt_") and os.path.exists(p):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    # ---- write path -----------------------------------------------------------
    def _write(self, step: int, snap_tree, logical_flat, extra,
               snap_s: float) -> Dict:
        t0 = time.monotonic()
        d = self.step_dir(step)
        tmp = d + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        flat = _flatten(snap_tree)
        arrays: Dict[str, Dict] = {}
        total = 0
        prev_step = self.latest_step()
        delta_ok = (prev_step is not None
                    and self._since_full < self.full_every - 1)
        ctx = _EncodeCtx(self, prev_step if delta_ok else None)
        for path, arr in flat.items():
            for codec in self.codecs:
                encoded = codec.encode(path, arr, ctx)
                if encoded is not None:
                    break
            encoding, payloads, meta = encoded
            entry: Dict[str, Any] = {
                "shape": list(arr.shape),
                "dtype": dtype_name(arr),
                "logical": logical_flat.get(path),
                "encoding": encoding,
                **meta,
            }
            if self.compress:
                entry["compressed"] = True
                payloads = [zlib.compress(_host(p), self.compress_level)
                            for p in payloads]
            files = []
            for pi, payload in enumerate(payloads):
                for ci, o in enumerate(range(0, max(len(payload), 1),
                                             CHUNK_BYTES)):
                    chunk = payload[o:o + CHUNK_BYTES]
                    fname = f"{path.replace('/', '.')}-{pi}.{ci}"
                    # digest where the bytes are (on the card for a
                    # device payload), then copy only the payload out
                    digest = shard_digest(chunk)
                    with open(os.path.join(tmp, fname), "wb") as f:
                        f.write(_host(chunk))
                    files.append({"file": fname, "part": pi,
                                  "nbytes": len(chunk),
                                  "checksum": digest})
                    total += len(chunk)
            entry["files"] = files
            arrays[path] = entry
        manifest = {
            "format_version": 2,
            "step": step,
            "written_at": time.time(),
            "arrays": arrays,
            "extra": extra,
            "total_bytes": total,
        }
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(d):
            # re-checkpointing a step: retire the committed image aside
            # first, so no crash window leaves the step without one
            retired = os.path.join(self.dir,
                                   "retired." + os.path.basename(d))
            shutil.rmtree(retired, ignore_errors=True)
            os.replace(d, retired)
            os.replace(tmp, d)  # atomic commit
            shutil.rmtree(retired, ignore_errors=True)
        else:
            os.replace(tmp, d)  # atomic commit
        wrote_delta = any("base_step" in e for e in arrays.values())
        self._since_full = self._since_full + 1 if wrote_delta else 0
        stats = {"step": step, "bytes": total,
                 "snapshot_s": round(snap_s, 4),
                 "write_s": round(time.monotonic() - t0, 4)}
        self.stats.append(stats)
        self._gc()
        return stats

    def _gc(self) -> None:
        steps = self.steps()
        # protect the TRANSITIVE delta-base chain of every kept checkpoint
        needed: set = set()
        frontier = list(steps[-self.keep:]) if self.keep else []
        while frontier:
            s = frontier.pop()
            try:
                man = self._manifest(self.step_dir(s))
            except FileNotFoundError:
                continue
            for e in man["arrays"].values():
                b = e.get("base_step")
                if b is not None and b not in needed:
                    needed.add(b)
                    frontier.append(b)
        for s in steps[:-self.keep]:
            if s in needed:
                continue
            shutil.rmtree(self.step_dir(s), ignore_errors=True)

    # ---- read path -------------------------------------------------------------
    def _manifest(self, d: str) -> Dict:
        with open(os.path.join(d, MANIFEST)) as f:
            return json.load(f)

    def _read_payload(self, d: str, entry: Dict, part: int):
        """One payload part as a flat uint8 tensor on `self.device`:
        each chunk file is uploaded into its slice and verified there."""
        metas = [f for f in entry["files"] if f["part"] == part]
        sizes = [os.path.getsize(os.path.join(d, f["file"])) for f in metas]
        buf = torch.empty(sum(sizes), dtype=torch.uint8, device=self.device)
        o = 0
        for fmeta, n in zip(metas, sizes):
            host = np.fromfile(os.path.join(d, fmeta["file"]), dtype=np.uint8)
            chunk = buf[o:o + n]
            chunk.copy_(torch.from_numpy(host))
            if self.verify:
                got = shard_digest(chunk)
                if got != fmeta["checksum"]:
                    raise ImageIntegrityError(
                        f"checksum mismatch in {fmeta['file']}: "
                        f"{got} != {fmeta['checksum']}")
            o += n
        if entry.get("compressed"):
            raw = zlib.decompress(_host(buf))
            buf = torch.frombuffer(bytearray(raw), dtype=torch.uint8).to(
                self.device)
        return buf

    def _read_array(self, d: str, path: str, *,
                    _depth: int = 0) -> Optional[torch.Tensor]:
        if _depth > self.max_chain:
            raise DeltaChainError(
                f"{path}: delta chain longer than the max_chain bound "
                f"({self.max_chain})")
        try:
            man = self._manifest(d)
        except FileNotFoundError:
            return None
        entry = man["arrays"].get(path)
        if entry is None:
            return None
        codec = self._decoders.get(entry["encoding"])
        if codec is None:
            raise CheckpointError(f"unknown encoding {entry['encoding']}")
        n_parts = 1 + max((f["part"] for f in entry["files"]), default=0)
        parts = [self._read_payload(d, entry, pi) for pi in range(n_parts)]
        return codec.decode(parts, entry, _DecodeCtx(self, path, _depth))

    def restore(self, step: Optional[int] = None, *, mesh=None, specs=None,
                skeleton=None) -> Tuple[Any, Dict]:
        """Load a checkpoint onto `self.device`.  Returns (state_tree,
        extra).  Restore onto a mesh is not ported (`mesh` must be
        None)."""
        if mesh is not None:
            raise NotImplementedError(
                "sharded restore is not ported to repro_torch (ROADMAP.md)")
        step = self.latest_step() if step is None else step
        if step is None:
            raise CheckpointError("no checkpoints found")
        d = self.step_dir(step)
        man = self._manifest(d)
        flat = {p: self._read_array(d, p) for p in man["arrays"]}
        return _rebuild(flat), man["extra"]


def _snapshot(tree, device):
    """Every leaf as a fresh tensor on `device` (host arrays uploaded,
    device tensors copied)."""
    def snap(x):
        if isinstance(x, torch.Tensor):
            return x.detach().to(device, copy=True)
        return torch.from_numpy(np.array(x)).to(device)

    return _rebuild({p: snap(x) for p, x in _flatten(tree).items()})


def _host(payload):
    """A payload (chunk) as a host buffer: a tensor is copied off its
    device into a uint8 array."""
    if isinstance(payload, torch.Tensor):
        return payload.cpu().numpy()
    return payload


def _rebuild(flat: Dict[str, Any]):
    """Rebuild a nested dict tree from 'a/b/c' paths."""
    root: Dict[str, Any] = {}
    for path, val in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return root
