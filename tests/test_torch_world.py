"""Multi-rank worlds of the port against the reference, on the CPU: the
wire codec (`SnapshotCodec`, `IncrementalSnapshotter`) taking tensors,
world images crossing between the packages in both directions, the
port's harness (`run_world` on inproc threads and spawned socket ranks,
`run_world_supervised` through a seeded kill), elastic 6 -> 4 -> 6
restores, the async incremental pipeline, and the example twin.

The same seeded numpy values go through both packages; every comparison
is exact (bytes equal, arrays bit for bit): the wire format and the
reshard are exact by design.
"""
import functools
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.comm.transport.harness import run_world as ref_run_world
from repro.core import codec as rcodec
from repro.core.restore import RestorePlan as RefRestorePlan
from repro.core.restore import restore_world as ref_restore_world
from repro_torch import RestorePlan, restore_world
from repro_torch.comm.transport import FaultPlan
from repro_torch.comm.transport.harness import (WorldError, run_world,
                                                run_world_supervised)
from repro_torch.core import codec as pcodec
from repro_torch.examples import multirank_simulation as twin

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CPU = torch.device("cpu")


def _arrays(seed):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(3, 1500).astype(np.float32),
            "i": np.arange(77, dtype=np.int64),
            "s": np.ones((), np.float64) * 2.5,
            "q": rng.randn(5000).astype(np.float32)}


def _tensors(arrays):
    return {k: torch.from_numpy(np.array(v, copy=True))
            for k, v in arrays.items()}


def _pair(seed=0):
    a = _arrays(seed)
    b = {k: np.array(v, copy=True) for k, v in a.items()}
    b["w"][1, 20:90] += 1.0
    b["i"][5] = -3
    b["q"][100:400] *= 3.0
    return a, b


# ---------------------------------------------------------------------------
# the wire codec: tensors in, the reference's bytes out
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cell", ["full", "delta", "int8"])
def test_snapshot_blobs_byte_identical_and_cross_decode(cell):
    a, b = _pair()
    keys = ("q",) if cell == "int8" else ()
    rc = rcodec.SnapshotCodec(quantize_keys=keys)
    pc = pcodec.SnapshotCodec(quantize_keys=keys)
    ta, tb = _tensors(a), _tensors(b)
    if cell == "full" or cell == "int8":
        ref = rc.encode(1, a, extra={"step": 1})
        ours = pc.encode(1, ta, extra={"step": 1})
        blobs_ref, blobs_ours, epoch = {1: ref}, {1: ours}, 1
    else:
        base_ref = rc.encode(1, a)
        ref = rc.encode(2, b, base=(1, a), extra={"step": 2})
        ours = pc.encode(2, tb, base=(1, ta), extra={"step": 2})
        assert pc.encode(1, ta) == base_ref
        assert rcodec.snap_meta(ours)["encoding"] == "delta"
        blobs_ref = {1: base_ref, 2: ref}
        blobs_ours = {1: base_ref, 2: ours}
        epoch = 2
    assert ours == ref
    want = rc.decode_chain(blobs_ref, epoch)
    from_ref = pc.decode_chain(blobs_ref, epoch, device="cpu")
    from_ours = rc.decode_chain(blobs_ours, epoch)
    host = pc.decode_chain(blobs_ours, epoch)
    for k, v in want.items():
        assert isinstance(from_ref[k], torch.Tensor)
        np.testing.assert_array_equal(from_ref[k].numpy(), v)
        np.testing.assert_array_equal(from_ours[k], v)
        np.testing.assert_array_equal(host[k], v)
    assert pc.decode_extra(ours) == rc.decode_extra(ref)


def test_incremental_snapshotter_stage_captures_tensor_at_the_cut():
    snap = pcodec.IncrementalSnapshotter(pcodec.ChainPolicy(full_every=4))
    ref = rcodec.IncrementalSnapshotter(rcodec.ChainPolicy(full_every=4))
    x = torch.from_numpy(np.random.RandomState(1).randn(4096).astype(
        np.float32))
    blobs, ref_blobs = {}, {}
    for e in range(1, 4):
        x[e * 10:e * 10 + 5] += 1.0
        produce = snap.stage(e, {"x": x}, extra={"e": e})
        ref_blobs[e] = ref.snapshot(e, {"x": x.numpy()}, extra={"e": e})
        cut = x.clone()
        x += 100.0                 # moves on before the encode runs
        blobs[e] = produce()
        x -= 100.0
        assert torch.equal(pcodec.SnapshotCodec().decode_chain(
            blobs, e, device="cpu")["x"], cut)
    assert blobs == ref_blobs
    assert [rcodec.snap_meta(b)["encoding"] for b in blobs.values()] == [
        "full", "delta", "delta"]


def test_device_decode_raises_typed_errors():
    a, b = _pair()
    pc = pcodec.SnapshotCodec()
    full = pc.encode(1, _tensors(a))
    delta = pc.encode(2, _tensors(b), base=(1, _tensors(a)))
    with pytest.raises(pcodec.DeltaChainError):
        pc.decode(delta, base_arrays={"w": torch.zeros(3)}, device="cpu")
    bad = bytearray(full)
    bad[-5] ^= 0x40
    with pytest.raises(pcodec.ImageIntegrityError):
        pc.decode(bytes(bad), device="cpu")


# ---------------------------------------------------------------------------
# world images cross between the packages
# ---------------------------------------------------------------------------

def _ref_pipeline_worker(numel=2048, steps=9, every=3):
    """The reference's async pipeline job on numpy ranks (a closure:
    it runs on the reference's inproc threads)."""
    import time

    def work(ctx):
        a, r = ctx.agent, ctx.rank
        snapper = rcodec.IncrementalSnapshotter(
            rcodec.ChainPolicy(full_every=4))
        state = {"shard": np.random.RandomState(r).randn(numel).astype(
            np.float32)}
        step = 0

        def snapshot():
            return snapper.stage(a.ckpt_epoch, state,
                                 extra={"step": step, "rank": r,
                                        "logical": {"shard": ["batch"]}})

        for step in range(steps):
            if r == 0 and step and step % every == 0:
                ctx.coord.request_checkpoint()
            state["shard"] = state["shard"].copy()
            state["shard"][step * 7:step * 7 + 50] += 1.0
            a.allreduce(a.world_comm, 1, lambda x, y: x + y)
            if a._ckpt_pending():
                a.safe_point(snapshot)
        a.barrier_op(a.world_comm)
        while a._ckpt_pending():
            a.safe_point(snapshot)
            time.sleep(0.002)
        return r

    return work


def test_reference_world_image_restores_in_port():
    n, box = 4, {}
    ref_run_world("inproc", n, _ref_pipeline_worker(), async_ckpt=True,
                  timeout=120, on_running=lambda s: box.setdefault("s", s))
    blob = rcodec.image_to_bytes(box["s"].committed_image())
    ref_image = rcodec.image_from_bytes(blob)
    ours = pcodec.image_from_bytes(blob)
    assert rcodec.snap_meta(ours["ranks"]["0"])["encoding"] == "delta"
    for r in range(n):
        want, want_extra = rcodec.restore_rank_arrays(ref_image, r)
        got, extra = pcodec.restore_rank_arrays(ours, r, device="cpu")
        assert extra == want_extra
        np.testing.assert_array_equal(got["shard"].numpy(), want["shard"])
    # resharded 4 -> 3 through both packages' restore_world
    want = ref_restore_world(blob, RefRestorePlan.between(4, 3)).reshard()
    rw = restore_world(blob, RestorePlan.between(4, 3))
    got = rw.reshard()
    for r in range(3):
        np.testing.assert_array_equal(got[r]["shard"], want[r]["shard"])
        sl = twin.restore_slice(rw, r, CPU)
        np.testing.assert_array_equal(sl["shard"].numpy(), want[r]["shard"])


def test_port_world_image_restores_in_reference():
    n, box = 4, {}
    run_world("inproc", n, twin.PipelineWorker(2048, "cpu", seed=4),
              async_ckpt=True, timeout=120,
              on_running=lambda s: box.setdefault("s", s))
    blob = pcodec.image_to_bytes(box["s"].committed_image())
    ref_image = rcodec.image_from_bytes(blob)
    assert rcodec.snap_meta(ref_image["ranks"]["1"])["encoding"] == "delta"
    for r in range(n):
        arrays, extra = rcodec.restore_rank_arrays(ref_image, r)
        want = twin.pipeline_expected(4, r, 2048, extra["step"], CPU)
        np.testing.assert_array_equal(arrays["shard"], want.numpy())
    # and the port's own restore_world of the same bytes agrees
    rw = restore_world(blob)
    for r in range(n):
        np.testing.assert_array_equal(rw.rank_arrays(r)["shard"],
                                      rcodec.restore_rank_arrays(
                                          ref_image, r)[0]["shard"])


# ---------------------------------------------------------------------------
# the port's harness
# ---------------------------------------------------------------------------

def _rank_times_ten(ctx):
    return ctx.rank * 10 + ctx.agent.allreduce(ctx.agent.world_comm, 1,
                                               lambda x, y: x + y)


@pytest.mark.parametrize("transport", ["inproc", "socket"])
def test_async_pipeline_commits_and_collects_chained_image(transport):
    """Mirror of the reference test of the same name, with the rank's
    shard a tensor and the socket ranks spawned."""
    n, box = 4, {}
    res = run_world(transport, n, twin.PipelineWorker(2048, "cpu", seed=6),
                    async_ckpt=True, timeout=120,
                    on_running=lambda s: box.setdefault("s", s))
    assert res.coord_stats["checkpoints"] == 2
    assert all(v["async_stages"] == 2 for v in res.results.values())
    image = box["s"].committed_image()
    assert image is not None and len(image["ranks"]) == n
    blob = image["ranks"][0]
    assert pcodec.snap_meta(blob)["encoding"] == "delta"
    assert pcodec.blob_base_epoch(blob) in {int(e) for e in image["chains"][0]}
    arrays, extra = pcodec.restore_rank_arrays(image, 2, device="cpu")
    want = twin.pipeline_expected(6, 2, 2048, extra["step"], CPU)
    assert torch.equal(arrays["shard"], want) and extra["rank"] == 2


def test_socket_world_rejects_a_closure_before_spawning():
    with pytest.raises(TypeError, match="picklable"):
        run_world("socket", 2, lambda ctx: ctx.rank, timeout=30)
    offset = 3

    def closure(ctx):
        return ctx.rank + offset
    with pytest.raises(TypeError, match="picklable"):
        run_world("socket", 2, closure, timeout=30)
    # picklable forms run on inproc the same way
    assert run_world("inproc", 2, functools.partial(
        _rank_times_ten)).results == {0: 2, 1: 12}


def test_fault_plan_pickles_without_its_lock():
    plan = FaultPlan(7).kill(1, at_step=3).straggle(0, at_step=1,
                                                    seconds=0.1)
    back = pickle.loads(pickle.dumps(plan))
    assert back._kills == plan._kills and back.seed == 7
    with back._lock:
        pass


def test_run_world_supervised_survives_a_seeded_kill():
    n, target, every = 4, 12, 3
    schedule = twin.chaos_schedule(11, n, 1, target)

    def factory(attempt, image):
        rw = None if image is None else restore_world(image)
        return twin.ChaosWorker(n, rw, target, every)

    sup = run_world_supervised(
        "inproc", n, factory, max_restarts=3,
        faults_for_attempt=lambda a: schedule.get(a, (None,))[0],
        unblock_window=0.5, timeout=120)
    assert sup.attempts == 2 and len(sup.failures) == 1
    assert sup.failures[0]["failed_ranks"] == [schedule[0][1]]
    assert all(v["step"] == target and v["recvd"] == target
               for v in sup.result.results.values())


def test_elastic_6_4_6_reshards_bit_for_bit(capsys):
    args = twin.parse_args(["--elastic", "--quick", "--ranks", "6",
                            "--kills", "2", "--seed", "5", "--device", "cpu",
                            "--elastic-numel", "30", "--reshard-to", "4"])
    m = twin.elastic_main(args, *twin.restore_specs(args))
    assert m["attempts"] == 3 and m["G"] == 30
    assert m["reshard"]["n_from"] == 6 and m["reshard"]["n_to"] == 4
    assert "6 -> 4 -> 6 ranks" in capsys.readouterr().out


def test_elastic_final_image_reshards_into_socket_ranks(capsys):
    """Spawned socket ranks restore their own slices (`restore_slice`)
    of the final elastic image, 6 -> 4, bit for bit."""
    args = twin.parse_args(["--elastic", "--quick", "--ranks", "6",
                            "--kills", "2", "--seed", "3", "--device", "cpu",
                            "--elastic-numel", "30",
                            "--reshard-to", "4@socket"])
    m = twin.elastic_main(args, *twin.restore_specs(args))
    assert m["reshard"]["transport"] == "socket"
    assert m["reshard"]["n_from"] == 6 and m["reshard"]["n_to"] == 4
    assert "restored into 4 'socket' ranks" in capsys.readouterr().out


def _sliced_image(n_from, G, rep=lambda r: 3.0):
    """An image of `n_from` ranks: x (logical "batch") split along dim
    0, m ([None, "batch"]) along dim 1, z (a ZeRO-1 key with no logical
    axis) along dim 0, and a replicated `rep` (per rank: `rep(r)`)."""
    codec = pcodec.SnapshotCodec()
    full = torch.arange(G, dtype=torch.float64) + 3
    m = torch.arange(3 * G, dtype=torch.int32).reshape(3, G)
    z = torch.arange(2 * G, dtype=torch.float32).reshape(G, 2)
    ranks = {r: codec.encode(
                 1, {"x": x.clone(), "m": mm.clone(), "z": zz.clone(),
                     "rep": torch.tensor(rep(r), dtype=torch.float64)},
                 extra={"step": 2, "zero1_keys": ["z"],
                        "logical": {"x": ["batch"], "m": [None, "batch"],
                                    "rep": []}})
             for r, (x, mm, zz) in enumerate(zip(
                 torch.tensor_split(full, n_from),
                 torch.tensor_split(m, n_from, dim=1),
                 torch.tensor_split(z, n_from)))}
    return pcodec.image_to_bytes({"epoch": 1, "n_ranks": n_from,
                                  "ranks": ranks})


@pytest.mark.parametrize("n_from,n_to", [(6, 4), (4, 6), (3, 7)])
def test_restore_slice_equals_reference_reshard(n_from, n_to):
    """Each new rank's slice, decoded from only the old ranks it needs,
    equals the reference's full `reshard()` of the same image: leaves
    sharded on dim 0 and on dim 1, a ZeRO-1 leaf, a replica."""
    G = 5 * n_from + 2
    blob = _sliced_image(n_from, G)
    want = ref_restore_world(blob, RefRestorePlan.between(
        n_from, n_to)).reshard()
    rw = restore_world(blob, RestorePlan.between(n_from, n_to))
    for r in range(n_to):
        got = twin.restore_slice(rw, r, CPU)
        assert sorted(got) == sorted(want[r])
        for k, v in want[r].items():
            assert got[k].dtype == torch.from_numpy(v).dtype, k
            np.testing.assert_array_equal(got[k].numpy(), v)
        assert torch.equal(got["x"], twin.elastic_expected(G, n_to, r, 3,
                                                            CPU))


def test_restore_slice_refuses_a_divergent_replica():
    """A leaf with no world-sharded axis that differs across the old
    ranks is an integrity error in the slice, as in `reshard()`."""
    blob = _sliced_image(4, 22, rep=lambda r: 3.0 + (r == 1))
    with pytest.raises(rcodec.ImageIntegrityError, match="divergent"):
        ref_restore_world(blob, RefRestorePlan.between(4, 2)).reshard()
    rw = restore_world(blob, RestorePlan.between(4, 2))
    with pytest.raises(pcodec.ImageIntegrityError, match="divergent"):
        twin.restore_slice(rw, 0, CPU)   # decodes old ranks 0 and 1


def test_socket_run_world_returns_results():
    res = run_world("socket", 2, _rank_times_ten, timeout=120)
    assert res.results == {0: 2, 1: 12} and res.transport == "socket"


def test_socket_rank_that_cannot_start_fails_the_world():
    with pytest.raises(WorldError, match="exited with code"):
        run_world("socket", 2, _FailsToStart(), timeout=120)


class _FailsToStart:
    """Pickles in the launcher, raises while a spawned rank unpickles it
    (the rank dies before it connects)."""

    def __init__(self):
        self.why = "start-up failure"

    def __call__(self, ctx):
        return ctx.rank

    def __setstate__(self, state):
        raise RuntimeError(state["why"])


# ---------------------------------------------------------------------------
# the example twin, as a user runs it
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["--quick", "--device", "cpu"],
    ["--elastic", "--quick", "--ranks", "6", "--kills", "2", "--seed", "5",
     "--device", "cpu"],
])
def test_example_twin_runs(argv):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.multirank_simulation",
         *argv], env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "PASS" in out.stdout
