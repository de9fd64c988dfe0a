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

On a mesh (state leaves that are DTensors): the snapshot gathers each
DTensor leaf to its full tensor before anything is encoded or digested,
as the reference's `_to_host` does, so an image holds no mesh and
restores on any mesh or on none, in either package.  The gathers are
collectives: every mesh rank makes them at the safe point, on the main
thread (never on the writer thread, where they would interleave with
the next step's collectives).  Mesh rank 0 alone writes the image; every
rank waits for its commit in `wait()` (a barrier over the mesh), so no
rank goes on to restore a half-written image.  `restore(mesh=, specs=)`
has every rank read and verify the image and keep its own slice of each
leaf (`distribute_tensor(..., src_data_rank=None)`: no broadcast, the
restored shards are the bits that were written).
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
from repro_torch.sharding.rules import PartitionSpec, placements

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
        # the mesh of the pending save's state (None: no mesh), whose
        # ranks meet at a barrier once its image is committed
        self._pending_mesh = None
        self.stats: List[Dict] = []

    # ---- public API -----------------------------------------------------------
    def step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:010d}")

    def save_async(self, step: int, state_tree, logical_tree=None,
                   extra: Optional[Dict] = None) -> Future:
        """Snapshot now (a copy on the device), write in the background.

        Returns a Future resolving to write stats (to None on a mesh rank
        other than 0, which writes nothing).  A second save while one is
        in flight waits for it first (double buffering).
        """
        self.wait()
        t0 = time.monotonic()
        snap, mesh = _snapshot(state_tree, self.device)
        snap_s = time.monotonic() - t0
        if mesh is not None and any(mesh.get_coordinate()):
            # this rank took part in the gathers; mesh rank 0 writes
            fut: Future = Future()
            fut.set_result(None)
        else:
            logical_flat = (
                {k: list(v) if isinstance(v, tuple) else None
                 for k, v in _flatten(logical_tree).items()}
                if logical_tree is not None else {})
            fut = self._writer.submit(self._write, step, snap, logical_flat,
                                      extra or {}, snap_s)
        self._pending, self._pending_mesh = fut, mesh
        return fut

    def save(self, step: int, state_tree, logical_tree=None,
             extra: Optional[Dict] = None) -> Dict:
        fut = self.save_async(step, state_tree, logical_tree, extra)
        self.wait()
        return fut.result()

    def wait(self) -> None:
        """Wait for the pending write; on a mesh every rank also waits
        at a barrier until mesh rank 0 has committed (or failed) it."""
        if self._pending is None:
            return
        pending, mesh = self._pending, self._pending_mesh
        self._pending = self._pending_mesh = None
        try:
            pending.result()
        finally:
            if mesh is not None:
                _mesh_barrier(mesh)

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
        """Load a checkpoint onto `self.device`.  Elastic: pass a
        (possibly different) mesh + PartitionSpec tree to bind each leaf
        to the NEW topology as a DTensor (a leaf missing from `specs` is
        replicated); with mesh=None the leaves are full tensors.

        Returns (state_tree, extra).
        """
        step = self.latest_step() if step is None else step
        if step is None:
            raise CheckpointError("no checkpoints found")
        d = self.step_dir(step)
        man = self._manifest(d)
        flat = {p: self._read_array(d, p) for p in man["arrays"]}
        if mesh is not None:
            from torch.distributed.tensor import distribute_tensor

            spec_flat = _flatten(specs) if specs is not None else {}
            flat = {p: distribute_tensor(
                a, mesh, placements(spec_flat.get(p, PartitionSpec()), mesh),
                src_data_rank=None) for p, a in flat.items()}
        return _rebuild(flat), man["extra"]


def _snapshot(tree, device):
    """(every leaf as a fresh full tensor on `device`, the mesh of the
    tree's DTensor leaves or None).  Host arrays are uploaded, device
    tensors copied, and a DTensor leaf is gathered to its full tensor
    first (a collective of every rank of its mesh)."""
    from torch.distributed.tensor import DTensor

    mesh = None

    def snap(x):
        nonlocal mesh
        if isinstance(x, DTensor):
            mesh = x.device_mesh
            x = x.full_tensor()
        if isinstance(x, torch.Tensor):
            return x.detach().to(device, copy=True)
        return torch.from_numpy(np.array(x)).to(device)

    return _rebuild({p: snap(x) for p, x in _flatten(tree).items()}), mesh


def _mesh_barrier(mesh) -> None:
    """Every rank of `mesh` reaches this point before any leaves it: a
    one-element all-reduce over each mesh dim in turn (after dim i, each
    rank has met every rank that shares its coordinates past i)."""
    import torch.distributed as dist

    t = torch.zeros(1, device=mesh.device_type)
    for i in range(mesh.ndim):
        dist.all_reduce(t, group=mesh.get_group(i))


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
