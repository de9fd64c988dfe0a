"""Checkpoint -> drain -> CROSS-TRANSPORT restore round trip under the
hybrid two-phase-commit, with rank state on the card — the PyTorch twin
of the JAX package's `examples/multirank_simulation.py`.

Phase A runs an N-rank job over one transport with pipelined ring p2p
(receives lag sends, so messages are ALWAYS in flight at the checkpoint
cut) plus per-row tree allreduces, with one rank straggling while the
checkpoint is pending.  The drain pulls every in-flight byte into
per-rank drain buffers, each rank snapshots its serialized upper half,
and the launcher writes a transport-free JSON image.  Phase B
bootstraps a fresh world from that file alone for every `--restore-to`
spec — another transport, another world size, or both — through
`repro_torch.restore_world(image, plan)`, and runs a second traffic
epoch with a second checkpoint.

The async incremental arm (run after phase B) keeps a per-rank float32
shard on the rank's device, changes a small part of it every step, and
checkpoints it through `IncrementalSnapshotter(ChainPolicy(full_every=4))`
and the async writer: the first epoch is a full image, the next an XOR
delta (the XOR kernel for a CUDA shard).  The committed image then
restores on every `--restore-to` transport, onto the card, and must
equal each rank's shard at the cut bit for bit; the restored world runs
a second epoch with another checkpoint.

`--chaos` adds seeded rank kills + supervised auto-restart; `--elastic`
kills ranks, resumes at the surviving world size from the committed
image (the float64 state `x` resharded, protocol state remapped), loses
one more, then grows back — with `x` and the replicated counter `rep`
tensors on the rank's device (`x += 1` runs there) and bit-identical to
the logical `arange(G) + step` throughout.  `--reshard-to N@TRANSPORT`
then restores the final committed image into one more world of that
size and checks every slice again.  `--store-dir` adds the durable
image store and its degraded-path arms.

Where the twin departs from the reference:
  * rank functions are instances of module-level classes: socket ranks
    are spawned processes (CUDA cannot cross a fork), so a rank function
    must pickle.  A spawned rank restores from the image FILE, reading
    only the old ranks its slice needs; inproc ranks share the
    launcher's `RestoredWorld`.
  * the chaos and elastic schedules seed `random.Random` with strings
    (`f"{seed}:{attempt}"`, `f"{seed}:elastic"`), as the store arm
    already does: the reference seeds with tuples, which Python 3.11+
    rejects with a `TypeError` before any rank starts.
  * the deprecated `--transport-a` / `--transport-b` /
    `--flip-transport` spellings are not carried over.

    PYTHONPATH=src python -m repro_torch.examples.multirank_simulation \\
        [--quick] [--ranks N] [--transport inproc] [--restore-to N@socket] \\
        [--device cpu]

Runs on the card unless `--device cpu` is passed; exits non-zero on any
mismatch.
"""
from __future__ import annotations

import argparse
import os
import random
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

from repro_torch import (RestorePlan, parse_restore_spec, resolve_device,
                         restore_world)
from repro_torch.comm.transport import FaultPlan, available_transports
from repro_torch.comm.transport.harness import (row_width, run_world,
                                                run_world_supervised)
from repro_torch.core.codec import (DEFAULT_COMPRESS_LEVEL, ChainPolicy,
                                    ImageIntegrityError,
                                    IncrementalSnapshotter, SnapshotCodec,
                                    image_to_bytes, restore_rank_arrays,
                                    snap_meta)
from repro_torch.core.split_state import leaf_shard_dim

STEPS_A, STEPS_B, LAG = 10, 6, 2
CKPT_STEP_A, CKPT_STEP_B = 4, 3
# --chaos mode: training horizon, checkpoint cadence, injected kills
CHAOS_STEPS, CHAOS_CKPT_EVERY, CHAOS_KILLS = 24, 6, 3
# the async incremental arm: steps, checkpoint cadence, changed share,
# float32 values per rank
PIPE_STEPS, PIPE_EVERY, PIPE_FRAC, PIPE_NUMEL = 9, 3, 0.01, 2048


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--quick", action="store_true",
                   help="scale the job down for fast runs")
    p.add_argument("--ranks", type=int, default=None,
                   help="world size (default: 256, or 32 with --quick; "
                        "chaos mode: 64 / 16; MANA_DEMO_RANKS overrides)")
    p.add_argument("--transport", default="inproc",
                   choices=available_transports(),
                   help="transport the job launches (and is checkpointed) "
                        "under; default inproc")
    p.add_argument("--restore-to", action="append", default=None,
                   metavar="N@TRANSPORT",
                   help="restore spec, repeatable: N@transport, N (same "
                        "transport) or @transport (same world size); "
                        "chaos mode: transports here set the restart "
                        "transport cycle")
    p.add_argument("--image", default=None,
                   help="checkpoint image path (default: a temp file)")
    p.add_argument("--async-ckpt", action="store_true",
                   help="asynchronous checkpoint pipeline in the A/B, "
                        "chaos and elastic phases (the incremental arm "
                        "is always async)")
    p.add_argument("--compress-level", type=int,
                   default=DEFAULT_COMPRESS_LEVEL,
                   help="zlib level of binary snapshot containers")
    p.add_argument("--chaos", action="store_true",
                   help="supervised chaos mode: seeded rank kills + "
                        "auto-restart from the last committed image")
    p.add_argument("--elastic", action="store_true",
                   help="elastic chaos (implies --chaos): kill ranks, "
                        "resume at the surviving world size, then grow "
                        "back to full size")
    p.add_argument("--seed", type=int, default=0,
                   help="fault-schedule and shard seed (reproduces exactly)")
    p.add_argument("--kills", type=int, default=CHAOS_KILLS,
                   help="number of injected rank kills to survive")
    p.add_argument("--log-dir", default=None,
                   help="chaos mode: write attempt records, the failing "
                        "seed and the last image here")
    p.add_argument("--store-dir", default=None,
                   help="durable image store root; chaos mode then runs "
                        "the degraded-path arms (torn commit, corrupted "
                        "newest epoch -> fallback restore)")
    p.add_argument("--retain-epochs", type=int, default=2,
                   help="point-in-time restore window (default 2)")
    p.add_argument("--device", default="cuda",
                   help="device of the rank state (default cuda; there is "
                        "no fallback to the CPU)")
    p.add_argument("--elastic-numel", type=int, default=None,
                   help="elastic mode: length G of the logical float64 "
                        "state x (default 2 x ranks)")
    p.add_argument("--reshard-to", default=None, metavar="N@TRANSPORT",
                   help="elastic mode: restore the final committed image "
                        "into one more world of N ranks and check it")
    return p


def parse_args(argv=None):
    args = build_parser().parse_args(argv)
    if args.elastic:
        args.chaos = True
    if args.ranks is None:
        if args.chaos:
            args.ranks = int(os.environ.get("MANA_DEMO_RANKS",
                                            "16" if args.quick else "64"))
        else:
            args.ranks = int(os.environ.get("MANA_DEMO_RANKS",
                                            "32" if args.quick else "256"))
    return args


def restore_specs(args):
    """The launch transport and the restore specs, `(n, transport)`
    pairs from `parse_restore_spec`, None meaning "unchanged"."""
    specs = [parse_restore_spec(s) for s in (args.restore_to or [])]
    return args.transport, specs or [(None, None)]


def payload(src, seq):
    return src.to_bytes(2, "big") + seq.to_bytes(4, "big")


# ---------------------------------------------------------------------------
# rank functions that restore from an image
# ---------------------------------------------------------------------------

class RestoringWorker:
    """Base of the rank functions that start from an image.  Inproc ranks
    share the launcher's `RestoredWorld` (and, for a reshard, the
    launcher's `shards = rw.reshard()`, as the reference's ranks do); a
    spawned socket rank gets only the image's path and the plan, and
    restores from the file (so a world's shards are never pickled into a
    child); a spawned process holds one rank, so it reads the file
    once."""

    def __init__(self, rw=None, image_path=None, shards=None):
        self._rw = rw
        self.plan = None if rw is None else rw.plan
        self.image_path = image_path
        self.shards = shards

    def __getstate__(self):
        state = dict(self.__dict__)
        if state["_rw"] is not None:
            if self.image_path is None:
                raise TypeError(f"{type(self).__name__} restores from an "
                                f"image: a spawned rank needs its path")
            state["_rw"] = state["shards"] = None
        return state

    @property
    def rw(self):
        if self._rw is None and self.image_path is not None:
            with open(self.image_path, "rb") as f:
                self._rw = restore_world(f.read(), self.plan)
        return self._rw


def image_file(rw, directory: str) -> str:
    """Write `rw`'s image (plan attached) as one binary container."""
    path = os.path.join(directory, f"image_{time.monotonic_ns()}.bin")
    with open(path, "wb") as f:
        f.write(image_to_bytes(rw.plan.attach(rw.image)))
    return path


def restore_slice(rw, rank: int, device):
    """New rank `rank`'s arrays under `rw.plan`, decoded onto `device`
    from only the old ranks whose shards overlap its slice: the one-rank
    form of `RestoredWorld.reshard` that a spawned socket rank uses (one
    process, one rank, so it need not decode the whole world).  As in
    `reshard_state`, each leaf's world-sharded dim comes from
    `leaf_shard_dim` (the logical axes and ZeRO-1 keys of the old ranks'
    app state), the slice is `array_split`'s, and a replicated leaf must
    be equal on every old rank decoded."""
    image, plan = rw.image, rw.plan
    ranks = image["ranks"]
    metas = [snap_meta(ranks.get(o, ranks.get(str(o))))["arrays"]
             for o in range(plan.n_from)]
    logical, zero1 = {}, set()
    for st in rw.states().values():
        logical.update(st.get("logical", {}))
        zero1.update(st.get("zero1_keys", ()))
    names = sorted({k for m in metas for k in m})
    spans, replicated = {}, []
    for name in names:
        holders = [o for o in range(plan.n_from) if name in metas[o]]
        dim = leaf_shard_dim(tuple(logical.get(name, ())),
                             metas[holders[0]][name]["shape"], plan.n_from,
                             zero1=name in zero1)
        if dim is None:
            replicated.append((name, holders[0]))
            continue
        if len(holders) < plan.n_from:
            raise ImageIntegrityError(f"sharded leaf {name!r} missing from "
                                      f"some old ranks")
        lens = [m[name]["shape"][dim] for m in metas]
        offs = np.concatenate([[0], np.cumsum(lens)]).astype(int).tolist()
        q, rem = divmod(offs[-1], plan.n_to)
        lo = rank * q + min(rank, rem)
        hi = lo + q + (1 if rank < rem else 0)
        spans[name] = (dim, offs, lo, hi)
    need = {o for _dim, offs, lo, hi in spans.values()
            for o in range(plan.n_from) if offs[o] < hi and offs[o + 1] > lo}
    for name, first in replicated:
        if not any(name in metas[o] for o in need):
            need.add(first)
    if not need:   # an empty slice still needs its leaves' dtypes
        need.add(0)
    decoded = {o: restore_rank_arrays(image, o, device=device)[0]
               for o in sorted(need)}
    out = {}
    for name, first in replicated:
        held = [d[name] for d in decoded.values() if name in d]
        if any(not torch.equal(held[0], v) for v in held[1:]):
            raise ImageIntegrityError(
                f"leaf {name!r} has no world-sharded logical axis but "
                f"differs across ranks — cannot replicate a divergent leaf")
        out[name] = held[0]
    for name, (dim, offs, lo, hi) in spans.items():
        parts = [decoded[o][name].narrow(
                     dim, max(lo - offs[o], 0),
                     min(hi, offs[o + 1]) - max(lo, offs[o]))
                 for o in sorted(decoded)
                 if offs[o] < hi and offs[o + 1] > lo]
        out[name] = (torch.cat(parts, dim) if parts else
                     decoded[min(decoded)][name].narrow(dim, 0, 0))
    return out


# ---------------------------------------------------------------------------
# phase A: run under the launch transport, checkpoint mid-traffic, write
# the image
# ---------------------------------------------------------------------------

class PhaseA:
    """Phase A's rank function (pipelined ring + row allreduces, one
    straggler inside the checkpoint window)."""

    def __init__(self, n: int):
        self.row_w = row_width(n)
        self.straggler = min(7, n - 1)

    def __call__(self, ctx):
        a, r, n = ctx.agent, ctx.rank, ctx.n
        row_w = self.row_w
        base = (r // row_w) * row_w
        a.row = a.create_comm(range(base, base + row_w))
        snap_box = {}

        def snapshot():
            # the app's comm-handle bindings (world/row vids) are
            # upper-half state: vids survive restore by design
            snap_box.setdefault("snap", {
                "step": step, "recvd": recvd,
                "world_comm": a.world_comm, "row": a.row,
                "agent": a.serialize()})

        recvd = 0
        step = 0
        for step in range(STEPS_A):
            if r == 0 and step == CKPT_STEP_A:
                print(f">>> A: checkpoint requested (step {step})")
                ctx.coord.request_checkpoint()
            if (r == self.straggler and step == CKPT_STEP_A
                    and a._ckpt_pending()):
                time.sleep(0.3)  # straggler inside the ckpt window
            a.send((r + 1) % n, payload(r, step), tag=0)
            if step >= LAG:   # pipelined ring: receives lag sends
                m = a.recv((r - 1) % n, timeout=120)
                assert payload((r - 1) % n, recvd) == m.payload
                recvd += 1
            a.allreduce(a.row, 1, lambda x, y: x + y)
            if a.safe_point(snapshot) and r == 0:
                print(f">>> A: checkpoint committed (step {step})")
        # the LAG in-flight messages per ring pair are deliberately NOT
        # consumed: they are the drain's payload at the cut
        a.barrier_op(a.world_comm)
        while a._ckpt_pending():
            if a.safe_point(snapshot) and r == 0:
                print(">>> A: checkpoint committed")
            time.sleep(0.002)
        return snap_box["snap"]


def watch_stragglers(server):
    time.sleep(0.45)
    report = server.straggler_report(threshold=0.2)
    if report:
        sample = dict(list(report.items())[:3])
        print(f">>> A: straggler report while waiting: {len(report)} "
              f"rank(s) not at a safe point yet, e.g. {sample}")


def phase_a(n, transport, image_path, async_ckpt=False):
    import json
    res = run_world(transport, n, PhaseA(n), unblock_window=0.5,
                    timeout=300, async_ckpt=async_ckpt,
                    on_running=watch_stragglers)
    assert len(res.results) == n and res.coord_stats["checkpoints"] == 1
    drained = sum(len(s["agent"]["drain_buffer"])
                  for s in res.results.values())
    assert drained > 0, "expected in-flight messages at the cut"
    image = {"transport": transport, "n_ranks": n,
             "ranks": {str(r): s for r, s in res.results.items()}}
    with open(image_path, "w") as f:
        json.dump(image, f)
    print(f">>> A: {n} ranks snapshotted over {transport!r}; {drained} "
          f"messages were drained in flight; coordinator stats: "
          f"{res.coord_stats}")
    print(f">>> A: checkpoint image written: {image_path} "
          f"({os.path.getsize(image_path)} bytes, transport-free JSON)")


# ---------------------------------------------------------------------------
# phase B: bootstrap a fresh world from the image alone — any transport,
# any world size, all through repro_torch.restore_world
# ---------------------------------------------------------------------------

class PhaseB(RestoringWorker):
    """Phase B's rank function: restore, replay the drained backlog,
    then a fresh traffic epoch with a second checkpoint."""

    def __init__(self, rw, from_transport, to_transport, image_path=None):
        super().__init__(rw, image_path)
        self.from_transport = from_transport
        self.to_transport = to_transport

    def __call__(self, ctx):
        rw = self.rw
        a, r, ep, n = ctx.agent, ctx.rank, ctx.ep, ctx.n
        prev = (r - 1) % n
        owned = rw.bind(ctx)
        if rw.plan.is_identity:
            st = owned[r]
            assert st["agent"]["transport"] == self.from_transport
            a.world_comm = st["world_comm"]
            a.row = st["row"]
            # replay the backlog: sequence numbers continue at the cut
            backlog = len(ep.drain_buffer)
            expected = (rw.state(prev)["step"] + 1) - st["recvd"]
            assert backlog == expected, (r, backlog, expected)
            seq = st["recvd"]
            for _ in range(backlog):
                m = a.recv(prev, timeout=120)
                assert m.payload == payload(prev, seq), (r, seq)
                seq += 1
        else:
            # elastic restore: replay exactly the remapped backlog, then
            # rebuild the topology comms for the new world
            for src, _dst, tag, _ in rw.drains_for(r):
                a.recv(src, tag=tag, timeout=120)
            row_w = row_width(n)
            base = (r // row_w) * row_w
            a.row = a.create_comm(range(base, base + row_w))
        assert len(ep.drain_buffer) == 0
        recvd = 0
        step = 0
        for step in range(STEPS_B):
            if r == 0 and step == CKPT_STEP_B:
                print(f">>> B: second checkpoint requested (step {step})")
                ctx.coord.request_checkpoint()
            a.send((r + 1) % n, payload(r, step), tag=1)
            if step >= 1:
                m = a.recv(prev, tag=1, timeout=120)
                assert m.payload == payload(prev, recvd)
                recvd += 1
            a.allreduce(a.row, 1, lambda x, y: x + y)
            if a.safe_point(lambda: None) and r == 0:
                print(f">>> B: second checkpoint committed (step {step})")
        a.barrier_op(a.world_comm)
        while a._ckpt_pending():  # end-of-job safe-point service
            if a.safe_point(lambda: None) and r == 0:
                print(">>> B: second checkpoint committed")
            time.sleep(0.002)
        a.recv(prev, tag=1, timeout=120)   # pipeline tail (lag 1)
        assert a.transport == self.to_transport
        return {"sent": list(ep.sent_bytes), "recvd": list(ep.recvd_bytes)}


def phase_b(n_to, transport, image_path, async_ckpt=False):
    import json
    with open(image_path) as f:
        image = json.load(f)
    n_from = image["n_ranks"]
    rw = restore_world(image, RestorePlan.between(n_from, n_to, transport))
    rw.states()   # decode once, launcher-side
    print(f">>> B: restoring image written under {image['transport']!r} "
          f"at {n_from} ranks onto a fresh {transport!r} world of {n_to}")
    with tempfile.TemporaryDirectory(prefix="mana_b_") as tmp:
        path = image_file(rw, tmp) if transport == "socket" else None
        res = run_world(transport, n_to,
                        PhaseB(rw, image["transport"], transport, path),
                        unblock_window=0.5, timeout=300,
                        async_ckpt=async_ckpt)
    assert len(res.results) == n_to and res.coord_stats["checkpoints"] == 1
    if rw.plan.is_identity:
        # drain closure in the RESTORED world: every ring pair's byte
        # counters balance once phase B's traffic is consumed
        for r in range(n_to):
            for s in ((r - 1) % n_to, (r + 1) % n_to):
                assert (res.results[r]["recvd"][s]
                        == res.results[s]["sent"][r]), (r, s)
    print(f">>> B: world restored over {transport!r} at {n_to} ranks "
          f"committed a second checkpoint; coordinator stats: "
          f"{res.coord_stats}")


# ---------------------------------------------------------------------------
# the async incremental arm: a float32 shard per rank on its device,
# XOR-delta chains through the async writer
# ---------------------------------------------------------------------------

def process_counters(device) -> dict:
    """This process's kernel launch counts and peak device memory: a
    spawned socket rank reports its own, which the launcher's counters
    cannot see."""
    from repro_torch.kernels.checksum import ops as cops
    from repro_torch.kernels.delta import ops as dops
    from repro_torch.kernels.quantize import ops as qops
    return {"checksum": cops.launches, "xor_delta": dops.launches,
            "quantize_int8": qops.launches,
            "dequantize_int8": qops.dequantize_launches,
            "peak": (torch.cuda.max_memory_allocated(device)
                     if device.type == "cuda" else 0)}


def pipeline_shard(seed: int, rank: int, numel: int, device):
    """Rank `rank`'s initial shard, made on `device` from its own seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed * 100_003 + rank)
    return torch.randn(numel, generator=gen, device=device)


def pipeline_mutate(shard, step: int) -> None:
    """The change of one step: +1 on a PIPE_FRAC share of the shard."""
    k = max(1, int(shard.numel() * PIPE_FRAC))
    off = (step * k) % max(1, shard.numel() - k + 1)
    shard[off:off + k] += 1.0


def pipeline_expected(seed: int, rank: int, numel: int, step: int, device):
    """The shard of `rank` after steps 0..`step`: the value an image
    taken at that step must restore to, bit for bit."""
    shard = pipeline_shard(seed, rank, numel, device)
    for s in range(step + 1):
        pipeline_mutate(shard, s)
    return shard


class PipelineWorker(RestoringWorker):
    """The async incremental arm's rank function.  From `rw` (an
    identity restore) each rank first restores its own shard onto its
    device and checks it against `pipeline_expected`; then `steps`
    steps, each changing the shard and running a row and a world
    allreduce, with a checkpoint every `every` steps staged by an
    `IncrementalSnapshotter` and encoded on the async writer."""

    def __init__(self, numel: int, device, *, seed: int = 0,
                 steps: int = PIPE_STEPS, every: int = PIPE_EVERY,
                 rw=None, image_path=None):
        super().__init__(rw, image_path)
        self.numel, self.device, self.seed = numel, str(device), seed
        self.steps, self.every = steps, every

    def __call__(self, ctx):
        a, r, n = ctx.agent, ctx.rank, ctx.n
        dev = resolve_device(self.device)
        row_w = row_width(n)
        base = (r // row_w) * row_w
        a.row = a.create_comm(range(base, base + row_w))
        start, restore_s = 0, None
        if self.rw is None:
            shard = pipeline_shard(self.seed, r, self.numel, dev)
        else:
            t0 = time.monotonic()
            arrays, extra = restore_rank_arrays(self.rw.image, r, device=dev)
            shard = arrays["shard"]
            restore_s = time.monotonic() - t0
            assert extra["rank"] == r, (extra, r)
            want = pipeline_expected(self.seed, r, self.numel,
                                     extra["step"], dev)
            assert torch.equal(shard, want), f"rank {r}: restored != cut"
            start = extra["step"] + 1
        snapper = IncrementalSnapshotter(ChainPolicy(full_every=4))
        stalls, writes = [], []
        step = start

        def snapshot():
            produce = snapper.stage(a.ckpt_epoch, {"shard": shard},
                                    extra={"step": step, "rank": r})

            def timed():
                t0 = time.monotonic()
                blob = produce()
                writes.append(time.monotonic() - t0)
                return blob
            if a.async_commit:
                return timed   # encoded + shipped by the writer
            ctx.coord.ship_snapshot(a.ckpt_epoch, timed())

        for step in range(start, start + self.steps):
            if r == 0 and step > start and (step - start) % self.every == 0:
                ctx.coord.request_checkpoint()
            pipeline_mutate(shard, step)
            a.allreduce(a.row, 1, lambda x, y: x + y)
            # a world allreduce keeps the rows within a step of each
            # other, so each request closes before the next one lands
            a.allreduce(a.world_comm, 1, lambda x, y: x + y)
            if a._ckpt_pending():
                a.safe_point(snapshot)
                stalls.append(a.last_commit_stall_s)
        a.barrier_op(a.world_comm)
        while a._ckpt_pending():
            a.safe_point(snapshot)
            time.sleep(0.002)
        a.drain_writer()   # the encodes (and their launches) are done
        return {"start": start, "last": step, "stalls": stalls,
                "writes": writes, "restore_s": restore_s,
                "async_stages": a.stats["async_stages"],
                "process": process_counters(dev)}


def check_pipeline_image(image, n, numel, seed, device):
    """Restore every rank of a pipeline image onto `device` (8 ranks at
    a time: inflate and the uploads release the GIL) and hold it to the
    shard at its cut; returns (restore seconds, delta epochs)."""
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.monotonic()
    with ThreadPoolExecutor(8) as pool:
        restored = dict(zip(range(n), pool.map(
            lambda r: restore_rank_arrays(image, r, device=device),
            range(n))))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    restore_s = time.monotonic() - t0
    for r, (arrays, extra) in restored.items():
        want = pipeline_expected(seed, r, numel, extra["step"], device)
        if not torch.equal(arrays["shard"], want):
            raise AssertionError(f"rank {r}: image != its shard at step "
                                 f"{extra['step']}")
    ranks, chains = image["ranks"], image.get("chains", {})
    deltas = {int(snap_meta(b)["epoch"])
              for r in range(n)
              for b in [ranks.get(r, ranks.get(str(r)))]
              + list(chains.get(r, chains.get(str(r), {})).values())
              if snap_meta(b)["encoding"] == "delta"}
    return restore_s, sorted(deltas)


def run_pipeline(n, transport, numel, device, *, seed=0, image=None,
                 steps=PIPE_STEPS, every=PIPE_EVERY, tmpdir=None):
    """One world of the async incremental arm (from `image` when given)
    -> (its committed image, metrics).  Every rank of the committed
    image is restored onto `device` and checked."""
    box = {}
    rw = None if image is None else restore_world(image)
    path = None
    if rw is not None and transport == "socket":
        path = image_file(rw, tmpdir)
    t0 = time.monotonic()
    res = run_world(transport, n,
                    PipelineWorker(numel, device, seed=seed, steps=steps,
                                   every=every, rw=rw, image_path=path),
                    async_ckpt=True, timeout=600,
                    on_running=lambda s: box.setdefault("s", s))
    world_s = time.monotonic() - t0
    committed = box["s"].committed_image()
    want_ckpts = (steps - 1) // every
    assert res.coord_stats["checkpoints"] == want_ckpts, res.coord_stats
    assert all(v["async_stages"] == want_ckpts
               for v in res.results.values())
    restore_s, deltas = check_pipeline_image(committed, n, numel, seed,
                                             torch.device(device))
    blob = image_to_bytes(committed)
    return committed, {
        "ranks": n, "transport": transport,
        "card_bytes": 4 * numel * n if torch.device(device).type == "cuda"
        else 0,
        "image_bytes": len(blob), "delta_epochs": deltas,
        "stall_s": max(s for v in res.results.values() for s in v["stalls"]),
        "write_s": max(w for v in res.results.values() for w in v["writes"]),
        "rank_restore_s": max((v["restore_s"] or 0.0)
                              for v in res.results.values()),
        "restore_s": restore_s, "world_s": world_s,
        "rank_process": _sum_processes(res.results, transport)}


def _sum_processes(results, transport):
    """Launch counts summed over a socket world's rank processes (and
    their largest peak); None for inproc, whose ranks share the
    launcher's counters."""
    if transport != "socket":
        return None
    procs = [v["process"] for v in results.values()]
    out = {k: sum(p[k] for p in procs) for k in procs[0] if k != "peak"}
    out["peak"] = max(p["peak"] for p in procs)
    return out


def pipeline_main(n, transport, restores, numel, device, seed=0):
    """The arm: a world on `transport`, then a restore + second epoch on
    each (same-size) transport of `restores`."""
    with tempfile.TemporaryDirectory(prefix="mana_pipe_") as tmp:
        image, m = run_pipeline(n, transport, numel, device, seed=seed,
                                tmpdir=tmp)
        print(f">>> pipeline: {n} ranks x {numel} f32 on {device} over "
              f"{transport!r}; delta epochs {m['delta_epochs']}; image "
              f"{m['image_bytes']} bytes; stall {m['stall_s']:.4f} s, "
              f"write {m['write_s']:.4f} s, restore {m['restore_s']:.4f} s")
        out = [m]
        for n_to, t_to in restores:
            if n_to not in (None, n):
                raise ValueError("the incremental arm restores at its own "
                                 "world size; use --elastic to reshard")
            t_to = t_to or transport
            _, m2 = run_pipeline(n, t_to, numel, device, seed=seed,
                                 image=image_to_bytes(image),
                                 steps=PIPE_EVERY + 1, tmpdir=tmp)
            print(f">>> pipeline: restored over {t_to!r} onto {device}, "
                  f"every shard equal to its cut; second epoch committed "
                  f"and restored (stall {m2['stall_s']:.4f} s, write "
                  f"{m2['write_s']:.4f} s)")
            out.append(m2)
    return out


# ---------------------------------------------------------------------------
# --chaos: seeded rank kills + supervised auto-restart from the last
# committed image
# ---------------------------------------------------------------------------

def snap_state(blob):
    """A chaos snapshot's app state, whichever way it shipped: a plain
    JSON-safe dict (sync path) or a binary container's extra cell."""
    if isinstance(blob, (bytes, bytearray)):
        return SnapshotCodec().decode_extra(blob)
    return blob


class ChaosWorker(RestoringWorker):
    """One incarnation of the chaos job: a pipelined ring plus row
    allreduces, checkpointing every `ckpt_every` steps.  From an image
    it resumes at the cut: comms rebound, drained messages re-delivered,
    and every receive asserts the ring sequence continues exactly."""

    def __init__(self, n, rw, target, ckpt_every, async_ckpt=False,
                 compress_level=DEFAULT_COMPRESS_LEVEL, image_path=None):
        super().__init__(rw, image_path)
        self.row_w = row_width(n)
        self.target, self.ckpt_every = target, ckpt_every
        self.async_ckpt, self.compress_level = async_ckpt, compress_level

    def __call__(self, ctx):
        a, r, n = ctx.agent, ctx.rank, ctx.n
        target, ckpt_every = self.target, self.ckpt_every
        prev = (r - 1) % n
        if self.rw is None:
            start = recvd = 0
            base = (r // self.row_w) * self.row_w
            a.row = a.create_comm(range(base, base + self.row_w))
        else:
            blob = self.rw.bind(ctx)[r]
            a.world_comm = blob["world_comm"]
            a.row = blob["row"]
            start, recvd = blob["step"] + 1, blob["recvd"]
        step = start

        def snapshot():
            # captured at the cut under the ADOPTED epoch; JSON-safe
            state = {"step": step, "recvd": recvd,
                     "world_comm": a.world_comm, "row": a.row,
                     "agent": a.serialize()}
            if self.async_ckpt:
                epoch = a.ckpt_epoch
                codec = SnapshotCodec(compress_level=self.compress_level)
                return lambda: codec.encode(epoch, {}, extra=state)
            ctx.coord.ship_snapshot(a.ckpt_epoch, state)

        for step in range(start, target):
            if r == 0 and step and (step % ckpt_every == 0
                                    or step == start + 1):
                ctx.coord.request_checkpoint()
            a.send((r + 1) % n, payload(r, step), tag=0)
            while recvd <= step - LAG:
                m = a.recv(prev, timeout=120)
                assert m.payload == payload(prev, recvd), (r, recvd)
                recvd += 1
            a.allreduce(a.row, 1, lambda x, y: x + y)
            # sample intent ONCE and gate the park on the same sample
            pending = a._ckpt_pending()
            if ctx.faults is not None:
                ctx.faults.on_step(r, step, ckpt_pending=pending)
            if pending:
                a.safe_point(snapshot)
        a.barrier_op(a.world_comm)
        while a._ckpt_pending():
            if ctx.faults is not None:
                ctx.faults.on_step(r, step, ckpt_pending=True)
            a.safe_point(snapshot)
            time.sleep(0.002)
        while recvd < target:  # pipeline tail (and any replayed drain)
            m = a.recv(prev, timeout=120)
            assert m.payload == payload(prev, recvd), (r, recvd)
            recvd += 1
        return {"start": start, "step": target, "recvd": recvd}


def chaos_schedule(seed, n, kills, target):
    """The seeded fault schedule: attempt i < kills injects one rank
    kill (attempt 1 is the mid-phase-1 variant: the victim dies after
    observing checkpoint intent but before parking, while a straggler
    in another row holds phase 1 open); later attempts run fault-free.
    Reproduces exactly from (seed, n, kills)."""
    row_w = row_width(n)
    plans = {}
    for attempt in range(kills):
        rng = random.Random(f"{seed}:{attempt}")
        plan = FaultPlan(seed)
        victim = rng.randrange(n)
        if attempt == 1 and kills > 1:
            straggler = ((victim + row_w) % n if n > row_w
                         else (victim + 1) % n)
            plan.kill(victim, at_step=0, when_pending=True)
            plan.straggle(straggler, at_step=0, seconds=0.7,
                          when_pending=True)
            plans[attempt] = (plan, victim, "mid-phase-1")
        else:
            step = rng.randrange(2, target - 2)
            plan.kill(victim, at_step=step)
            plans[attempt] = (plan, victim, f"step {step}")
    return plans


def open_chaos_store(args):
    """The durable tier behind --store-dir (None without the flag)."""
    if not args.store_dir:
        return None
    from repro_torch.core.image_store import open_store
    return open_store(args.store_dir, retain=args.retain_epochs)


def _socket_image_paths(transports, tmpdir):
    """fn_factory helper: the path a socket attempt's ranks restore from
    (None for inproc attempts, whose ranks share the launcher's world)."""
    def path_for(attempt, rw):
        if rw is None or transports[attempt % len(transports)] != "socket":
            return None
        return image_file(rw, tmpdir)
    return path_for


def run_store_arms(args, transports, n_restart, fn_factory, check):
    """The degraded-path arms behind --store-dir, run after the chaos
    horizon: (1) a torn commit (crash between blob upload and manifest)
    stays invisible; (2) seeded bit flips in the newest epoch make a
    COLD restart fall back a generation with `EpochFallbackWarning` and
    still finish the horizon."""
    from repro_torch.core.image_store import (EpochFallbackWarning,
                                              StoreCrash, StoreFaults,
                                              open_store)
    sd, retain = args.store_dir, args.retain_epochs
    store = open_store(sd, retain=retain)
    eps = store.epochs()
    assert len(eps) >= 2, f"need >=2 retained epochs for fallback, got {eps}"

    torn = open_store(sd, retain=retain,
                      faults=StoreFaults(args.seed).crash_before_manifest())
    fake = dict(store.load(eps[-1]), epoch=eps[-1] + 1000)
    try:
        torn.commit(fake)
        raise AssertionError("crash_before_manifest never fired")
    except StoreCrash:
        pass
    assert open_store(sd, retain=retain).epochs() == eps, \
        "torn commit must be invisible (manifest-last protocol)"
    print(f">>> store arm 1: torn commit (crash before manifest) left "
          f"epochs {eps} unchanged")

    man = store.manifest(eps[-1])
    rng = random.Random(f"{args.seed}:store-flip")
    for rec in man["blobs"].values():
        path = os.path.join(sd, rec["key"])
        with open(path, "rb") as f:
            raw = bytearray(f.read())
        raw[rng.randrange(len(raw))] ^= 1 << rng.randrange(8)
        with open(path, "wb") as f:
            f.write(bytes(raw))
    cold = open_store(sd, retain=retain)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sup = run_world_supervised(
            transports, n_restart, fn_factory, max_restarts=0,
            store=cold, retain_epochs=retain, unblock_window=0.5,
            timeout=300, async_ckpt=args.async_ckpt)
    cold.stop()
    assert any(issubclass(w.category, EpochFallbackWarning)
               for w in caught), [w.category for w in caught]
    assert sup.image is not None and sup.image["epoch"] == eps[-2], \
        (sup.image and sup.image["epoch"], eps)
    check(sup)
    print(f">>> store arm 2: newest epoch {eps[-1]} corrupted (seeded "
          f"bit flips) -> cold restart fell back to epoch {eps[-2]} "
          f"with EpochFallbackWarning and finished the horizon")


def chaos_main(args, transport, specs):
    with tempfile.TemporaryDirectory(prefix="mana_chaos_") as tmp:
        _chaos(args, transport, specs, tmp)


def _chaos(args, transport, specs, tmp):
    n, seed, kills = args.ranks, args.seed, args.kills
    target, every = CHAOS_STEPS, CHAOS_CKPT_EVERY
    transports = [transport] + [t for _, t in specs if t]
    schedule = chaos_schedule(seed, n, kills, target)
    resume_steps = []   # min resume step per attempt (0 = cold start)
    path_for = _socket_image_paths(transports, tmp)

    def fn_factory(attempt, image):
        resume = (0 if image is None else 1 + min(
            int(snap_state(b)["step"]) for b in image["ranks"].values()))
        resume_steps.append(resume)
        what = (f"kill rank {schedule[attempt][1]} at "
                f"{schedule[attempt][2]}" if attempt in schedule
                else "no faults")
        print(f">>> chaos attempt {attempt}: resume step {resume} "
              f"(image epoch {image['epoch'] if image else None}), "
              f"{what}")
        rw = None if image is None else restore_world(image)
        if rw is not None:
            rw.states()   # decode once, launcher-side
        return ChaosWorker(n, rw, target, every, async_ckpt=args.async_ckpt,
                           compress_level=args.compress_level,
                           image_path=path_for(attempt, rw))

    t0 = time.perf_counter()
    store = open_chaos_store(args)
    print(f"=== {n}-rank CHAOS run: seed {seed}, {kills} injected kills, "
          f"checkpoint every {every} steps, transport(s) {transports}, "
          f"{'async' if args.async_ckpt else 'sync'} checkpoints"
          + (f", store {args.store_dir} (retain "
             f"{args.retain_epochs})" if store else "") + " ===")
    sup = run_world_supervised(
        transports, n, fn_factory, max_restarts=kills + 2,
        faults_for_attempt=lambda a: schedule.get(a, (None,))[0],
        unblock_window=0.5, timeout=300, log_dir=args.log_dir,
        store=store, retain_epochs=args.retain_epochs,
        async_ckpt=args.async_ckpt)

    assert len(sup.result.results) == n
    assert all(v["step"] == target and v["recvd"] == target
               for v in sup.result.results.values())
    assert len(sup.failures) == kills, sup.failures
    # bounded lost work: within 2 checkpoint intervals of each kill
    for f in sup.failures:
        attempt = f["attempt"]
        plan, victim, what = schedule[attempt]
        assert f["failed_ranks"] == [victim], f
        if what.startswith("step"):
            fired = max(int(what.split()[1]), resume_steps[attempt])
            lost = fired - resume_steps[attempt + 1]
            assert lost <= 2 * every + 2, (f, fired, resume_steps)
    assert all(a <= b for a, b in zip(resume_steps, resume_steps[1:])), \
        resume_steps  # progress is monotone: restarts never lose ground
    recoveries = [f.get("recovery_s") for f in sup.failures]
    print(f">>> chaos: survived {kills} kills in {sup.attempts} attempts; "
          f"resume steps {resume_steps}; recovery latencies "
          f"{[round(x, 3) for x in recoveries if x is not None]}s")
    if store is not None:
        store.stop()
        print(f">>> store: retained epochs {store.epochs()}")

        def arms_factory(attempt, image):
            assert image is not None, "cold restart must adopt a store epoch"
            rw = restore_world(image)
            rw.states()
            return ChaosWorker(n, rw, target, every,
                               async_ckpt=args.async_ckpt,
                               compress_level=args.compress_level,
                               image_path=path_for(attempt, rw))

        def check(sup2):
            assert len(sup2.result.results) == n
            assert all(v["step"] == target and v["recvd"] == target
                       for v in sup2.result.results.values())

        run_store_arms(args, transports, n, arms_factory, check)
    print(f"PASS ({time.perf_counter() - t0:.1f}s)")


# ---------------------------------------------------------------------------
# --elastic: shrink to the survivors, grow back when capacity returns,
# bit-identical logical state on the card throughout
# ---------------------------------------------------------------------------

def elastic_expected(G: int, n: int, rank: int, step: int, device):
    """Rank `rank`'s slice of the logical x = arange(G) + step."""
    q, rem = divmod(G, n)
    lo = rank * q + min(rank, rem)
    hi = lo + q + (1 if rank < rem else 0)
    return torch.arange(lo, hi, dtype=torch.float64, device=device) + step


class ElasticWorker(RestoringWorker):
    """One incarnation of the elastic chaos job.  The logical state is
    x = arange(G) + step (float64, logical axis "batch", split across
    whatever world size this attempt got) plus a replicated counter
    `rep`, both tensors on the rank's device; each step runs a lagged
    ring p2p (messages ALWAYS in flight at a cut), one world allreduce
    (count equalization pins every rank to the same step at a committed
    cut), then x += 1 on the device.  From an image an inproc rank moves
    its piece of the launcher's `shards` (`rw.reshard()`) onto the
    device, a spawned socket rank decodes only its own slice
    (`restore_slice`); either asserts it is bit-identical to the logical
    arange — across shrink, grow and both transports."""

    def __init__(self, G, rw, start, target, ckpt_every, device,
                 async_ckpt=False, compress_level=DEFAULT_COMPRESS_LEVEL,
                 image_path=None, shards=None):
        super().__init__(rw, image_path, shards)
        self.G, self.start, self.target = G, start, target
        self.ckpt_every, self.device = ckpt_every, str(device)
        self.async_ckpt, self.compress_level = async_ckpt, compress_level

    def __call__(self, ctx):
        a, r, n = ctx.agent, ctx.rank, ctx.n
        dev = resolve_device(self.device)
        start, target = self.start, self.target
        prev = (r - 1) % n
        restore_s = None
        if self.rw is None:
            x = elastic_expected(self.G, n, r, 0, dev)
            rep = torch.zeros((), dtype=torch.float64, device=dev)
        else:
            rw = self.rw
            rw.bind(ctx)   # remapped comms/counts/drains
            t0 = time.monotonic()
            if self.shards is not None:
                arrays = {k: torch.from_numpy(v).to(dev, copy=True)
                          for k, v in self.shards[r].items()}
            else:
                arrays = restore_slice(rw, r, dev)
            restore_s = time.monotonic() - t0
            x, rep = arrays["x"], arrays["rep"].reshape(())
            # the reshard is exact, not approximate
            want = elastic_expected(self.G, n, r, start, dev)
            assert torch.equal(x, want), (r, n, start)
            assert float(rep) == float(start), (r, float(rep), start)
            for src, _dst, tag, _ in rw.drains_for(r):
                a.recv(src, tag=tag, timeout=120)
        assert len(ctx.ep.drain_buffer) == 0
        recvd = start
        step = start
        stalls, writes = [], []

        def snapshot():
            epoch = a.ckpt_epoch
            codec = SnapshotCodec(compress_level=self.compress_level)
            arrays = {"x": x.clone(), "rep": rep.clone()}
            extra = {"step": step, "recvd": recvd,
                     "logical": {"x": ["batch"], "rep": []},
                     "agent": a.serialize()}

            def encode():
                t0 = time.monotonic()
                blob = codec.encode(epoch, arrays, extra=extra)
                writes.append(time.monotonic() - t0)
                return blob
            if self.async_ckpt:
                return encode
            ctx.coord.ship_snapshot(epoch, encode())

        for step in range(start, target):
            if r == 0 and step and (step % self.ckpt_every == 0
                                    or step == start + 1):
                ctx.coord.request_checkpoint()
            a.send((r + 1) % n, payload(r, step), tag=0)
            while recvd <= step - LAG:
                m = a.recv(prev, timeout=120)
                assert m.payload == payload(prev, recvd), (r, recvd)
                recvd += 1
            a.allreduce(a.world_comm, 1.0, lambda p, q: p + q)
            x += 1.0
            rep += 1.0
            pending = a._ckpt_pending()
            if ctx.faults is not None:
                ctx.faults.on_step(r, step, ckpt_pending=pending)
            if pending:
                a.safe_point(snapshot)
                stalls.append(a.last_commit_stall_s)
        a.barrier_op(a.world_comm)
        while a._ckpt_pending():
            if ctx.faults is not None:
                ctx.faults.on_step(r, step, ckpt_pending=True)
            a.safe_point(snapshot)
            time.sleep(0.002)
        while recvd < target:  # pipeline tail
            m = a.recv(prev, timeout=120)
            assert m.payload == payload(prev, recvd), (r, recvd)
            recvd += 1
        exact = torch.equal(x, elastic_expected(self.G, n, r, target, dev))
        a.drain_writer()   # the encodes (and their launches) are done
        return {"start": start, "numel": x.numel(), "exact": exact,
                "rep": float(rep), "stalls": stalls, "writes": writes,
                "restore_s": restore_s, "process": process_counters(dev)}


def elastic_main(args, transport, specs):
    """Kill `args.kills` of `args.ranks`, resume at the survivors, lose
    one more, grow back; then (`--reshard-to`) restore the final
    committed image into one more world.  Returns the run's metrics."""
    with tempfile.TemporaryDirectory(prefix="mana_elastic_") as tmp:
        return _elastic(args, transport, specs, tmp)


def _elastic(args, transport, specs, tmp):
    n0, seed, kills = args.ranks, args.seed, args.kills
    n1 = n0 - kills
    assert n1 >= 1, f"--kills {kills} leaves no survivors of {n0}"
    target, every = CHAOS_STEPS, CHAOS_CKPT_EVERY
    G = args.elastic_numel or 2 * n0
    device = resolve_device(args.device)
    transports = [transport] + [t for _, t in specs if t]
    # attempt 0 at n0 loses `kills` ranks at once (after the first
    # cadence commit), attempt 1 at n1 loses one more, attempt 2 grows
    # back to n0 and finishes the horizon fault-free
    rng = random.Random(f"{seed}:elastic")
    step0 = every + 2
    plan0 = FaultPlan(seed)
    victims0 = sorted(rng.sample(range(n0), kills))
    for v in victims0:
        plan0.kill(v, at_step=step0)
    plan1 = FaultPlan(seed)
    victim1 = rng.randrange(n1)
    plan1.kill(victim1, at_step=min(step0 + every, target - 2))
    schedule = {0: plan0, 1: plan1}
    capacities = {0: n0, 1: n1, 2: n0}
    path_for = _socket_image_paths(transports, tmp)
    sizes, origins, resume_steps, servers = [], [], [], []

    def fn_factory(attempt, image):
        if image is None:
            rw, resume = None, 0
        else:
            rw = restore_world(image)
            steps = {st["step"] for st in rw.states().values()}
            # counts-equalized commit => ONE global step at the cut
            assert len(steps) == 1, steps
            resume = steps.pop() + 1
        sizes.append(None if rw is None else rw.plan.n_to)
        origins.append(None if image is None else int(image["n_ranks"]))
        resume_steps.append(resume)
        print(f">>> elastic attempt {attempt}: "
              + ("cold start" if rw is None
                 else f"{rw.plan.n_from} -> {rw.plan.n_to} ranks")
              + f", resume step {resume}")
        path = path_for(attempt, rw)
        # launcher-side reshard for inproc ranks, as the reference does
        shards = None if rw is None or path else rw.reshard()
        return ElasticWorker(G, rw, resume, target, every, device,
                             async_ckpt=args.async_ckpt,
                             compress_level=args.compress_level,
                             image_path=path, shards=shards)

    t0 = time.perf_counter()
    store = open_chaos_store(args)
    print(f"=== ELASTIC chaos: {n0} ranks, kill {kills} -> resume at "
          f"{n1} -> grow back to {n0}; G {G} float64 on {device}; seed "
          f"{seed}, transport(s) {transports}"
          + (f", store {args.store_dir} (retain "
             f"{args.retain_epochs})" if store else "") + " ===")
    sup = run_world_supervised(
        transports, n0, fn_factory, max_restarts=4, elastic=True,
        faults_for_attempt=lambda a: schedule.get(a),
        capacity_for_attempt=lambda a, rf: capacities.get(a),
        unblock_window=0.5, timeout=600, log_dir=args.log_dir,
        store=store, retain_epochs=args.retain_epochs,
        async_ckpt=args.async_ckpt, on_running=servers.append)
    chaos_s = time.perf_counter() - t0

    results = sup.result.results
    assert sup.final_n == n0 and len(results) == n0
    assert [f["n"] for f in sup.failures] == [n0, n1], sup.failures
    assert sizes[1] == n1 and sizes[2] == n0, sizes
    # the grow-back attempt restored a COMMITTED image of the shrunken
    # world — progress made at n1 survived the growth
    assert origins[2] == n1, origins
    assert resume_steps[2] >= resume_steps[1] > 0, resume_steps
    # bit-identical logical state: every slice equals arange + target,
    # the slices tile [0, G), the replicated counter agrees
    assert all(v["exact"] for v in results.values()), \
        [r for r, v in results.items() if not v["exact"]]
    assert sum(v["numel"] for v in results.values()) == G
    assert all(v["rep"] == float(target) for v in results.values())
    recoveries = [round(f["recovery_s"], 3) for f in sup.failures
                  if f.get("recovery_s") is not None]
    print(f">>> elastic: {n0} -> {n1} -> {n0} ranks in {sup.attempts} "
          f"attempts; resume steps {resume_steps}; recovery latencies "
          f"{recoveries}s; final state bit-identical to the logical "
          f"arange + {target}")
    metrics = {
        "ranks": n0, "G": G, "attempts": sup.attempts,
        "resume_steps": resume_steps, "recovery_s": recoveries,
        "card_bytes": 8 * G if device.type == "cuda" else 0,
        "stall_s": max(s for v in results.values() for s in v["stalls"]),
        "write_s": max(w for v in results.values() for w in v["writes"]),
        "rank_restore_s": max(v["restore_s"] or 0.0
                              for v in results.values()),
        "chaos_s": chaos_s}
    if args.reshard_to:
        metrics["reshard"] = reshard_final(
            servers[-1].committed_image(), args.reshard_to, G, every,
            device, args, tmp)
    if store is not None:
        store.stop()
        print(f">>> store: retained epochs {store.epochs()}")

        # shrink-elastic fallback: the cold restart adopts the store
        # epoch at whatever size committed it and reshards down to n1
        def check(sup2):
            res2 = sup2.result.results
            assert sup2.final_n == n1 and len(res2) == n1
            assert all(v["exact"] for v in res2.values())
            assert sum(v["numel"] for v in res2.values()) == G

        run_store_arms(args, transports, n1, fn_factory, check)
    print(f"PASS ({time.perf_counter() - t0:.1f}s)")
    return metrics


def reshard_final(image, spec, G, every, device, args, tmpdir):
    """Restore the final committed elastic image into a world of the
    `spec`'s size and transport; every rank checks its slice against
    the logical arange and runs two more steps."""
    n_to, t_to = parse_restore_spec(spec)
    n_to, t_to = n_to or int(image["n_ranks"]), t_to or args.transport
    image_bytes = len(image_to_bytes(image))
    rw = restore_world(image, RestorePlan.for_image(image, n_to, t_to))
    steps = {st["step"] for st in rw.states().values()}
    assert len(steps) == 1, steps
    resume = steps.pop() + 1
    t0 = time.perf_counter()
    path = image_file(rw, tmpdir) if t_to == "socket" else None
    shards = None if path else rw.reshard()
    res = run_world(t_to, n_to,
                    ElasticWorker(G, rw, resume, resume + 2, every, device,
                                  image_path=path, shards=shards),
                    unblock_window=0.5, timeout=600)
    world_s = time.perf_counter() - t0
    results = res.results
    assert all(v["exact"] for v in results.values())
    assert sum(v["numel"] for v in results.values()) == G
    print(f">>> reshard: final image (epoch {image['epoch']}, "
          f"{rw.plan.n_from} ranks, {image_bytes} bytes) restored into "
          f"{n_to} {t_to!r} ranks; every slice equals arange + {resume} "
          f"bit for bit and ran 2 more steps ({world_s:.2f} s)")
    return {"n_from": rw.plan.n_from, "n_to": n_to, "transport": t_to,
            "image_bytes": image_bytes, "world_s": world_s,
            "rank_process": _sum_processes(results, t_to),
            "rank_restore_s": max(v["restore_s"] for v in results.values())}


def main(argv=None):
    args = parse_args(argv)
    transport, specs = restore_specs(args)
    device = resolve_device(args.device)
    if args.chaos:
        try:
            if args.elastic:
                elastic_main(args, transport, specs)
            else:
                chaos_main(args, transport, specs)
        except BaseException:
            if args.log_dir:
                os.makedirs(args.log_dir, exist_ok=True)
                with open(os.path.join(args.log_dir,
                                       "failing_seed.txt"), "w") as f:
                    f.write(f"seed={args.seed}\nargv: "
                            f"{' '.join(argv or sys.argv[1:])}\n")
            raise
        return 0
    n = args.ranks
    image_path = args.image or os.path.join(
        tempfile.mkdtemp(prefix="mana_image_"), "ckpt_image.json")
    t0 = time.perf_counter()
    restores = [(spec_n or n, spec_t or transport)
                for spec_n, spec_t in specs]
    print(f"=== {n}-rank checkpoint -> drain -> restore round trip "
          f"(rows of {row_width(n)}, tree collectives, "
          f"{transport} -> {', '.join(f'{rn}@{rt}' for rn, rt in restores)}, "
          f"{'async' if args.async_ckpt else 'sync'} checkpoints; rank "
          f"state on {device}) ===")
    phase_a(n, transport, image_path, args.async_ckpt)
    for n_to, t_to in restores:
        phase_b(n_to, t_to, image_path, args.async_ckpt)
    pipeline_main(n, transport, [(None, t) for _, t in restores],
                  PIPE_NUMEL, device, seed=args.seed)
    print(f"PASS ({time.perf_counter() - t0:.1f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
