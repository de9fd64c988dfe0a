"""Durable tiered image store: manifests, chain compaction, scheduled
scrub, and point-in-time fallback restore.

The NERSC production follow-up (arXiv:2103.08546) found that at scale
the dominant failure modes are checkpoint write bandwidth and image
INTEGRITY, not protocol cost.  Before this module, committed images
lived only in launcher RAM plus one overwritten `last_image.bin`: a
launcher crash, a torn write, or a single flipped bit in the newest
image lost ALL recoverable work.  This module is the durability tier —
behind an interface the transport never sees:

  ImageStore     — the minimal object-store-shaped backend contract:
      put/get/list/delete/exists over opaque slash-separated keys.
      The only backend today is `LocalDirStore` (a directory), but the
      surface is deliberately S3-shaped so a remote backend slots in
      without touching the collector or the supervisor.
  LocalDirStore  — keys are relative paths under a root; every put is
      ATOMIC (tmp file in the same dir + fsync + os.replace), so a
      crash mid-put leaves either the old object or nothing — never a
      torn object.
  EpochStore     — the durable epoch tier over any backend.  One
      digest-protected JSON MANIFEST per committed epoch (written
      LAST: the manifest is the commit point, so a crash between blob
      uploads and the manifest write leaves a torn epoch that restore
      simply never sees), per-blob length + Fletcher digests, delta
      chains deduplicated across epochs by keying blobs on their OWN
      epoch, retention of the last K epochs with chain-aware GC,
      `load_newest_verified` point-in-time fallback (a corrupt or torn
      epoch falls back a generation with a typed
      `EpochFallbackWarning` instead of failing the restart), a
      `scrub()` pass re-verifying every digest on a schedule, and a
      `compact()` pass folding long XOR-delta chains into fresh full
      images — bit-identical by construction, verified before the
      compacted manifest replaces the chain.
  StoreFaults    — FaultPlan-style seeded fault injection AT THE STORE
      BOUNDARY (bit-flip, truncation, transient upload failure, slow
      disk, crash-before-manifest), so the chaos suite exercises every
      degraded path deterministically on both transports.

Wiring (see `repro_torch.core.control` and `repro_torch.comm.transport.harness`):
the launcher-side image collector uploads newly committed epochs
asynchronously with bounded retry/backoff; `run_world_supervised`
restores from the newest VERIFIED epoch on a cold start and falls back
through older retained epochs on corruption.

Everything here is importable from a jax-free process.
"""
from __future__ import annotations

import json
import os
import threading
import time
import warnings
import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.codec import (ImageError, ImageIntegrityError, SnapshotCodec,
                              is_snap_blob, restore_rank_arrays, shard_digest,
                              snap_meta)

# ---------------------------------------------------------------------------
# typed errors + the fallback warning
# ---------------------------------------------------------------------------


class StoreError(ImageError):
    """Base class for image-store failures (an `ImageError`, so every
    existing degraded-restore path that catches ImageError handles
    store trouble the same way)."""


class StoreKeyError(StoreError, KeyError):
    """A requested key does not exist in the backend."""

    def __str__(self):  # KeyError quotes its arg; keep the message flat
        return StoreError.__str__(self)


class StoreWriteError(StoreError):
    """A put failed (transient upload failure, disk full...).  The
    epoch tier retries these with bounded backoff; past the retry
    budget the commit fails loudly — never silently."""


class EpochFallbackWarning(UserWarning):
    """Restore skipped a corrupt/torn epoch and fell back a generation
    (graceful degradation: bounded extra lost work instead of none of
    the work being recoverable)."""


# ---------------------------------------------------------------------------
# seeded store fault injection (the FaultPlan idiom, at the put boundary)
# ---------------------------------------------------------------------------


@dataclass
class _StoreRule:
    kind: str                     # "flip_bit" | "truncate" | "fail_put"
    #                             | "slow" | "crash_before_manifest"
    match: str = ""               # substring of the key ("" matches all)
    times: int = 1                # how many matching puts the rule bites
    frac: float = 0.5             # truncate: fraction of bytes kept
    seconds: float = 0.05         # slow: injected latency per put
    fired: List[str] = field(default_factory=list)   # keys acted on


class StoreCrash(StoreError):
    """Injected launcher death between blob upload and manifest commit
    (the torn-epoch scenario).  Raised out of `EpochStore.commit`; the
    chaos arm catches it and cold-restarts, proving the manifest-less
    epoch is invisible to restore."""


class StoreFaults:
    """Deterministic seeded fault schedule for one store, acting at the
    backend `put` boundary — the store analogue of the transport
    layer's `FaultPlan`.

    Every decision is a pure function of (seed, rule index, key), so a
    failing chaos seed reproduces exactly regardless of upload-thread
    scheduling.  Rules fire on the FIRST `times` puts of a matching
    key (per-key, so retries of a transient failure see the rule
    decay, which is what lets bounded retry/backoff succeed).
    """

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.rules: List[_StoreRule] = []
        self._put_counts: Dict[Tuple[int, str], int] = {}
        self._lock = threading.Lock()

    # ---- fluent builders ---------------------------------------------------
    def flip_bit(self, match: str = "", times: int = 1) -> "StoreFaults":
        """Flip one seeded bit in the data of a matching put (bit rot /
        torn DMA: the object lands on disk corrupt)."""
        self.rules.append(_StoreRule("flip_bit", match, times))
        return self

    def truncate(self, match: str = "", frac: float = 0.5,
                 times: int = 1) -> "StoreFaults":
        """Truncate a matching put to `frac` of its bytes (torn write
        that still replaced the object)."""
        self.rules.append(_StoreRule("truncate", match, times, frac=frac))
        return self

    def fail_put(self, match: str = "", times: int = 1) -> "StoreFaults":
        """Fail a matching put with a transient `StoreWriteError` the
        first `times` attempts (flaky upload link); retries past that
        succeed — exercising the bounded retry/backoff path."""
        self.rules.append(_StoreRule("fail_put", match, times))
        return self

    def slow(self, match: str = "", seconds: float = 0.05,
             times: int = 1000000) -> "StoreFaults":
        """Add `seconds` of latency to matching puts (slow disk)."""
        self.rules.append(_StoreRule("slow", match, times, seconds=seconds))
        return self

    def crash_before_manifest(self, match: str = "manifests/",
                              times: int = 1) -> "StoreFaults":
        """Raise `StoreCrash` INSTEAD of writing a matching manifest —
        the launcher died after the blob uploads but before the commit
        point, leaving a torn (manifest-less) epoch on disk."""
        self.rules.append(_StoreRule("crash_before_manifest", match, times))
        return self

    # ---- decisions ---------------------------------------------------------
    def _rng(self, rule_idx: int, key: str):
        import random
        return random.Random(zlib.crc32(
            f"{self.seed}:{rule_idx}:{key}".encode()))

    def on_put(self, key: str, data: bytes) -> bytes:
        """Consult the schedule for one put.  May raise (fail_put,
        crash_before_manifest), sleep (slow), or return corrupted data
        (flip_bit, truncate); returns `data` unchanged otherwise."""
        for idx, rule in enumerate(self.rules):
            if rule.match not in key:
                continue
            with self._lock:
                count = self._put_counts.get((idx, key), 0)
                if count >= rule.times:
                    continue
                self._put_counts[(idx, key)] = count + 1
                rule.fired.append(key)
            if rule.kind == "fail_put":
                raise StoreWriteError(
                    f"injected transient put failure for {key!r} "
                    f"(attempt {count + 1}/{rule.times})")
            if rule.kind == "crash_before_manifest":
                raise StoreCrash(
                    f"injected launcher crash before manifest {key!r}")
            if rule.kind == "slow":
                time.sleep(rule.seconds)
            elif rule.kind == "flip_bit" and data:
                bit = self._rng(idx, key).randrange(len(data) * 8)
                flipped = bytearray(data)
                flipped[bit // 8] ^= 1 << (bit % 8)
                data = bytes(flipped)
            elif rule.kind == "truncate":
                data = data[:max(0, int(len(data) * rule.frac))]
        return data


# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------


class ImageStore:
    """Minimal object-store-shaped backend contract: a flat namespace
    of opaque `a/b/c` keys mapping to immutable byte strings.  Every
    method is thread-safe; `put` must be atomic (readers see the old
    object or the new one, never a torn one)."""

    def put(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def get(self, key: str) -> bytes:
        raise NotImplementedError

    def list(self, prefix: str = "") -> List[str]:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def exists(self, key: str) -> bool:
        try:
            self.get(key)
            return True
        except StoreKeyError:
            return False


def _check_key(key: str) -> str:
    parts = key.split("/")
    if (not key or key.startswith("/")
            or any(p in ("", ".", "..") for p in parts)):
        raise StoreError(f"invalid store key {key!r}")
    return key


class LocalDirStore(ImageStore):
    """Directory-backed store: keys are relative paths under `root`.

    Puts are ATOMIC: the data is written to a tmp file in the SAME
    directory (os.replace across filesystems is not atomic), flushed,
    fsynced, and renamed over the final name — the same retire idiom
    `CheckpointManager._write` uses, so a launcher crash mid-put can
    never leave a torn object with the final name.

    `faults` (a `StoreFaults`) intercepts puts for the chaos suite.
    """

    def __init__(self, root: str, faults: Optional[StoreFaults] = None):
        self.root = os.path.abspath(root)
        self.faults = faults
        os.makedirs(self.root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, *_check_key(key).split("/"))

    def put(self, key: str, data: bytes) -> None:
        if self.faults is not None:
            data = self.faults.on_put(key, bytes(data))
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        try:
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except OSError as e:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise StoreWriteError(f"put {key!r} failed: {e}") from e

    def get(self, key: str) -> bytes:
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise StoreKeyError(f"no such key {key!r}") from None

    def list(self, prefix: str = "") -> List[str]:
        out = []
        for dirpath, _dirs, files in os.walk(self.root):
            rel = os.path.relpath(dirpath, self.root)
            for name in files:
                if name.endswith((".tmp",)) or ".tmp." in name:
                    continue
                key = name if rel == "." else "/".join(
                    rel.split(os.sep) + [name])
                if key.startswith(prefix):
                    out.append(key)
        return sorted(out)

    def delete(self, key: str) -> None:
        try:
            os.unlink(self._path(key))
        except FileNotFoundError:
            pass

    def exists(self, key: str) -> bool:
        return os.path.exists(self._path(key))


# ---------------------------------------------------------------------------
# the epoch tier: manifests, retention, scrub, compaction, fallback
# ---------------------------------------------------------------------------

# The normative field registry of the epoch MANIFEST — the JSON commit
# record `EpochStore.commit` writes LAST.  docs/PROTOCOL.md renders
# this table and `docs/check_docs_drift.py` diffs the doc against THIS
# dict, so adding a manifest field without documenting it fails CI.
MANIFEST_FIELDS: Dict[str, str] = {
    "manifest_format": "manifest schema version (currently 1)",
    "epoch": "checkpoint epoch this manifest commits",
    "n_ranks": "world size the epoch's snapshots were taken at",
    "blobs": "per-rank snapshot blob records keyed by source rank: "
             "{key, len, digest, enc} — `key` is the backend object "
             "key, `len`/`digest` protect the stored bytes, `enc` is "
             "'bin' (binary snapshot container, stored verbatim) or "
             "'json' (JSON-safe app dict, stored as UTF-8 JSON)",
    "chains": "per-rank delta base-chain blob records for incremental "
              "epochs ({rank: {base_epoch: record}}); records share "
              "keys with older epochs' blobs (content-addressed keys "
              "dedup chain storage across manifests)",
    "compacted": "true once the background compactor folded this "
                 "epoch's delta chain into fresh full blobs (restore "
                 "is bit-identical either way, verified before the "
                 "compacted manifest replaces the chain)",
    "meta": "pass-through committed-image header fields (e.g. the "
            "elastic `remap` spec) so a store round trip preserves "
            "everything `image_to_bytes` would",
    "digest": "Fletcher self-digest of the manifest JSON (computed "
              "with this field absent, sorted keys); a manifest whose "
              "digest does not verify is treated as torn and the "
              "restore falls back a generation",
}

MANIFEST_FORMAT = 1
_IMAGE_META_SKIP = ("epoch", "n_ranks", "ranks", "chains")


def _manifest_digest(man: Dict) -> int:
    body = {k: v for k, v in man.items() if k != "digest"}
    return shard_digest(json.dumps(body, sort_keys=True).encode())


def _blob_bytes(blob) -> Tuple[bytes, str]:
    """Serialize one snapshot blob for storage.  Binary containers are
    stored verbatim; JSON-safe app dicts as UTF-8 JSON (a blob that
    smuggled live state fails json.dumps loudly — the same transport-
    free-by-construction property `image_to_bytes` has)."""
    if isinstance(blob, (bytes, bytearray, memoryview)):
        return bytes(blob), "bin"
    return json.dumps(blob).encode(), "json"


def _blob_load(data: bytes, enc: str):
    if enc == "bin":
        return data
    try:
        return json.loads(data.decode())
    except Exception as e:  # noqa: BLE001 — corrupt json blob
        raise ImageIntegrityError(f"corrupt json blob: {e}") from e


class EpochStore:
    """The durable epoch tier over any `ImageStore` backend.

    Key layout (content-ADDRESSED — the Fletcher digest is part of the
    key, so identical chain members dedup to one object while a
    restart that rewinds the timeline and re-commits an epoch number
    with different bytes can never serve stale data):

        blobs/<epoch:08d>/rank_<r>.<digest>.blob   chain/full members
        blobs/<epoch:08d>/rank_<r>.<digest>.full   compactor re-encodes
        manifests/<epoch:08d>.json                 the COMMIT POINT
        quarantine/<epoch:08d>.json                scrub-condemned

    A manifest is written LAST: until it lands, the epoch does not
    exist as far as restore is concerned (a torn upload is invisible,
    not a failure).  Puts retry transient `StoreWriteError`s with
    bounded exponential backoff.

    >>> import numpy as np, tempfile
    >>> store = EpochStore(LocalDirStore(tempfile.mkdtemp()), retain=2)
    >>> blob = SnapshotCodec().encode(1, {"w": np.ones(3, np.float32)})
    >>> man = store.commit({"epoch": 1, "n_ranks": 1, "ranks": {0: blob}})
    >>> store.epochs()
    [1]
    >>> restore_rank_arrays(store.load(1), 0)[0]["w"].tolist()
    [1.0, 1.0, 1.0]
    """

    def __init__(self, backend: ImageStore, retain: int = 2,
                 codec: Optional[SnapshotCodec] = None,
                 max_retries: int = 3, backoff_s: float = 0.01):
        self.backend = backend
        self.retain = max(1, int(retain))
        self.codec = codec or SnapshotCodec()
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self._lock = threading.RLock()
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        # observability: (epoch, error-string) pairs from failed
        # commits/compactions, scrub reports
        self.errors: List[Tuple[int, str]] = []

    # ---- key layout --------------------------------------------------------
    @staticmethod
    def _blob_key(epoch: int, rank, digest: int,
                  full: bool = False) -> str:
        # CONTENT-ADDRESSED: the digest is part of the key, so a
        # re-commit of the same epoch number with different bytes (a
        # restart rewinds the timeline and replays epochs) can never
        # collide with — or serve stale bytes for — an older commit,
        # while identical chain members still dedup to one object
        kind = "full" if full else "blob"
        return (f"blobs/{int(epoch):08d}/"
                f"rank_{rank}.{int(digest) & 0xFFFFFFFF:08x}.{kind}")

    @staticmethod
    def _manifest_key(epoch: int) -> str:
        return f"manifests/{int(epoch):08d}.json"

    @staticmethod
    def _epoch_of(manifest_key: str) -> int:
        return int(manifest_key.rsplit("/", 1)[-1].split(".")[0])

    # ---- plumbing ----------------------------------------------------------
    def _put_retry(self, key: str, data: bytes) -> None:
        """Bounded retry with exponential backoff on transient write
        failures; the LAST error surfaces (typed) past the budget."""
        for attempt in range(self.max_retries + 1):
            try:
                self.backend.put(key, data)
                return
            except StoreWriteError:
                if attempt == self.max_retries:
                    raise
                time.sleep(self.backoff_s * (2 ** attempt))

    def _upload_blob(self, epoch: int, rank, blob,
                     full: bool = False) -> Dict:
        data, enc = _blob_bytes(blob)
        digest = shard_digest(data)
        key = self._blob_key(epoch, rank, digest, full=full)
        record = {"key": key, "len": len(data),
                  "digest": digest, "enc": enc}
        # content-addressed keys: an object already uploaded (a chain
        # member shared with an older epoch's commit, or an idempotent
        # re-commit) is skipped, not rewritten
        if not self.backend.exists(key):
            self._put_retry(key, data)
        return record

    def _fetch_blob(self, record: Dict, what: str):
        try:
            data = self.backend.get(record["key"])
        except StoreKeyError as e:
            raise ImageIntegrityError(f"{what}: blob {record['key']!r} "
                                      f"missing from the store") from e
        if len(data) != record["len"]:
            raise ImageIntegrityError(
                f"{what}: blob {record['key']!r} truncated "
                f"({len(data)} of {record['len']} bytes)")
        got = shard_digest(data)
        if got != record["digest"]:
            raise ImageIntegrityError(
                f"{what}: blob {record['key']!r} digest mismatch "
                f"({got} != {record['digest']})")
        return _blob_load(data, record.get("enc", "bin"))

    # ---- commit (upload + manifest-last) -----------------------------------
    def commit(self, image: Dict) -> Dict:
        """Upload one committed image ({"epoch", "n_ranks", "ranks",
        "chains"?, ...}) and write its manifest — the COMMIT POINT —
        last.  Returns the manifest.  Raises `StoreWriteError` if a
        blob put fails past the retry budget (the manifest is then
        never written: no torn epochs)."""
        epoch = int(image["epoch"])
        with self._lock:
            blobs = {str(r): self._upload_blob(epoch, r, b)
                     for r, b in image.get("ranks", {}).items()}
            chains = {str(r): {str(e): self._upload_blob(int(e), r, b)
                               for e, b in chain.items()}
                      for r, chain in (image.get("chains") or {}).items()}
            man = {"manifest_format": MANIFEST_FORMAT, "epoch": epoch,
                   "n_ranks": int(image["n_ranks"]), "blobs": blobs,
                   "chains": chains, "compacted": False,
                   "meta": {k: v for k, v in image.items()
                            if k not in _IMAGE_META_SKIP}}
            self._write_manifest(man)
            self.retire()
            return man

    def _write_manifest(self, man: Dict) -> None:
        man["digest"] = _manifest_digest(man)
        self._put_retry(self._manifest_key(man["epoch"]),
                        json.dumps(man, sort_keys=True).encode())

    # ---- read side ---------------------------------------------------------
    def epochs(self) -> List[int]:
        """Committed epochs present in the store, oldest first."""
        return sorted(self._epoch_of(k)
                      for k in self.backend.list("manifests/"))

    def manifest(self, epoch: int) -> Dict:
        """The verified manifest of `epoch`; raises a typed
        `ImageIntegrityError` on a missing, unparseable, or
        digest-mismatched (torn) manifest."""
        try:
            data = self.backend.get(self._manifest_key(epoch))
        except StoreKeyError as e:
            raise ImageIntegrityError(
                f"epoch {epoch}: no manifest in the store") from e
        try:
            man = json.loads(data.decode())
        except Exception as e:  # noqa: BLE001 — torn manifest
            raise ImageIntegrityError(
                f"epoch {epoch}: corrupt manifest: {e}") from e
        if not isinstance(man, dict) or "digest" not in man:
            raise ImageIntegrityError(
                f"epoch {epoch}: manifest is not a commit record")
        got = _manifest_digest(man)
        if got != man["digest"]:
            raise ImageIntegrityError(
                f"epoch {epoch}: manifest digest mismatch "
                f"({got} != {man['digest']})")
        return man

    def load(self, epoch: int) -> Dict:
        """Load epoch `epoch` as a committed image ({"epoch",
        "n_ranks", "ranks", "chains", ...meta}), verifying the
        manifest self-digest and every blob's length + digest.  Any
        corruption is a typed `ImageIntegrityError`."""
        man = self.manifest(epoch)
        what = f"epoch {epoch}"
        image = {"epoch": man["epoch"], "n_ranks": man["n_ranks"],
                 "ranks": {r: self._fetch_blob(rec, what)
                           for r, rec in man["blobs"].items()},
                 **man.get("meta", {})}
        if man.get("chains"):
            image["chains"] = {
                r: {e: self._fetch_blob(rec, what)
                    for e, rec in chain.items()}
                for r, chain in man["chains"].items()}
        return image

    def verify(self, epoch: int) -> None:
        """Scrub one epoch: re-verify the manifest digest and every
        referenced blob's bytes (length + Fletcher digest) WITHOUT
        decompressing payloads.  Raises `ImageIntegrityError`."""
        man = self.manifest(epoch)
        what = f"epoch {epoch}"
        for rec in man["blobs"].values():
            self._fetch_blob(rec, what)
        for chain in man.get("chains", {}).values():
            for rec in chain.values():
                self._fetch_blob(rec, what)

    def load_newest_verified(self, before: Optional[int] = None,
                             ) -> Optional[Dict]:
        """Point-in-time fallback restore: walk committed epochs newest
        to oldest (optionally strictly older than `before`) and return
        the first that fully verifies.  Every skipped epoch emits a
        typed `EpochFallbackWarning`; returns None when nothing in the
        store is restorable."""
        with self._lock:
            for epoch in sorted(self.epochs(), reverse=True):
                if before is not None and epoch >= before:
                    continue
                try:
                    return self.load(epoch)
                except ImageError as e:
                    warnings.warn(
                        f"epoch {epoch} failed verification "
                        f"({e}); falling back a generation",
                        EpochFallbackWarning, stacklevel=2)
        return None

    # ---- retention GC ------------------------------------------------------
    def retire(self, retain: Optional[int] = None) -> List[int]:
        """Keep the newest `retain` committed epochs; delete older
        manifests, then garbage-collect blobs referenced by NO
        surviving manifest (chain members an older retained epoch
        still needs survive by construction — the manifests reference
        them).  Returns the retired epochs."""
        retain = self.retain if retain is None else max(1, int(retain))
        with self._lock:
            epochs = self.epochs()
            retired = epochs[:-retain] if len(epochs) > retain else []
            for e in retired:
                self.backend.delete(self._manifest_key(e))
            referenced = set()
            for e in epochs[-retain:] if epochs else []:
                try:
                    man = self.manifest(e)
                except ImageError:
                    continue  # torn manifest: scrub will quarantine it
                for rec in man["blobs"].values():
                    referenced.add(rec["key"])
                for chain in man.get("chains", {}).values():
                    for rec in chain.values():
                        referenced.add(rec["key"])
            for key in self.backend.list("blobs/"):
                if key not in referenced:
                    self.backend.delete(key)
            return retired

    # ---- scrub -------------------------------------------------------------
    def scrub(self) -> Dict:
        """Re-verify every committed epoch's digests; QUARANTINE the
        corrupt ones (manifest moved to quarantine/, so restore and
        `epochs()` never see them again) and report what happened:
        {"checked": [...], "corrupt": {epoch: error}}."""
        report: Dict = {"checked": [], "corrupt": {}}
        with self._lock:
            for epoch in self.epochs():
                try:
                    self.verify(epoch)
                    report["checked"].append(epoch)
                except ImageError as e:
                    report["corrupt"][epoch] = str(e)
                    self.errors.append((epoch, f"scrub: {e}"))
                    self._quarantine(epoch)
        return report

    def _quarantine(self, epoch: int) -> None:
        key = self._manifest_key(epoch)
        try:
            data = self.backend.get(key)
            self.backend.put(f"quarantine/{int(epoch):08d}.json", data)
        except StoreError:
            pass  # manifest itself unreadable: just drop it
        self.backend.delete(key)

    # ---- compaction --------------------------------------------------------
    def chain_len(self, epoch: int) -> int:
        """Longest per-rank delta chain of a committed epoch (0 = all
        full blobs)."""
        man = self.manifest(epoch)
        return max((len(c) for c in man.get("chains", {}).values()),
                   default=0)

    def compact(self, epoch: int, max_chain: int = 64) -> Dict:
        """Fold `epoch`'s XOR-delta chains into fresh FULL blobs and
        replace its manifest (marked `compacted`), leaving restore
        BIT-IDENTICAL: every rank's arrays and extra dict are decoded
        from the chain, re-encoded full, decoded again and compared
        bit-for-bit before the new manifest lands.  Runs entirely on
        the launcher side against store bytes — ranks are never
        stalled.  Old chain blobs become garbage `retire()` collects
        once no other manifest references them."""
        import numpy as np
        with self._lock:
            image = self.load(epoch)
            man = self.manifest(epoch)
            blobs: Dict[str, Dict] = {}
            for r in list(image["ranks"]):
                blob = image["ranks"][r]
                if not is_snap_blob(blob):
                    blobs[str(r)] = man["blobs"][str(r)]
                    continue  # app-dict blob: nothing to fold
                arrays, extra = restore_rank_arrays(
                    image, r, self.codec, max_chain=max_chain)
                full = self.codec.encode(int(snap_meta(blob)["epoch"]),
                                         arrays, extra=extra or None)
                # the bit-identical proof, before the manifest flips:
                got = self.codec.decode(full)
                for name, arr in arrays.items():
                    if not np.array_equal(got[name], arr):
                        raise ImageIntegrityError(
                            f"epoch {epoch} rank {r}: compaction not "
                            f"bit-identical for array {name!r}")
                if self.codec.decode_extra(full) != (extra or {}):
                    raise ImageIntegrityError(
                        f"epoch {epoch} rank {r}: compaction dropped "
                        f"extra state")
                blobs[str(r)] = self._upload_blob(epoch, r, full,
                                                 full=True)
            new_man = {"manifest_format": MANIFEST_FORMAT,
                       "epoch": man["epoch"], "n_ranks": man["n_ranks"],
                       "blobs": blobs, "chains": {}, "compacted": True,
                       "meta": man.get("meta", {})}
            self._write_manifest(new_man)
            self.retire()
            return new_man

    # ---- background scrubber + compactor -----------------------------------
    def _spawn(self, name: str, interval_s: float,
               tick: Callable[[], None]) -> threading.Thread:
        def loop():
            while not self._stop.wait(interval_s):
                try:
                    tick()
                except Exception as e:  # noqa: BLE001 — keep ticking
                    self.errors.append((-1, f"{name}: {e}"))
        t = threading.Thread(target=loop, daemon=True, name=name)
        t.start()
        self._threads.append(t)
        return t

    def start_scrubber(self, interval_s: float = 30.0) -> threading.Thread:
        """Scheduled scrub: re-verify every epoch's Fletcher digests
        every `interval_s`, quarantining corruption as it is found
        (daemon thread; `stop()` halts it)."""
        return self._spawn("store-scrubber", interval_s, self.scrub)

    def start_compactor(self, interval_s: float = 30.0,
                        chain_threshold: int = 2) -> threading.Thread:
        """Background compactor: fold any committed epoch whose delta
        chain is at least `chain_threshold` links into fresh full
        images.  Pure launcher-side store I/O — never stalls ranks."""
        def tick():
            for epoch in self.epochs():
                try:
                    if (not self.manifest(epoch).get("compacted")
                            and self.chain_len(epoch) >= chain_threshold):
                        self.compact(epoch)
                except ImageError as e:
                    self.errors.append((epoch, f"compactor: {e}"))
        return self._spawn("store-compactor", interval_s, tick)

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=timeout)
        self._threads.clear()
        self._stop.clear()


def open_store(store_dir: str, retain: int = 2,
               faults: Optional[StoreFaults] = None) -> EpochStore:
    """Convenience constructor the example and CI use: a local-disk
    epoch store rooted at `store_dir` retaining `retain` epochs."""
    return EpochStore(LocalDirStore(store_dir, faults=faults),
                      retain=retain)
