"""The port's durable image store (`repro_torch.core.image_store`, a
verbatim copy of the reference's) with tensor-encoded images, on the
CPU: a store written by either package loads and restores in the other,
the launcher collector uploads committed epochs of a world whose rank
state is tensors, a corrupt newest epoch falls back a generation with
`EpochFallbackWarning`, and retention keeps the last K epochs with
their chain bases.  Mirrors of cases in tests/test_image_store.py;
every comparison is exact.
"""
import os
import random
import warnings

import numpy as np
import pytest
import torch

from repro.core import codec as rcodec
from repro.core import image_store as rstore
from repro_torch import EpochFallbackWarning, open_store, restore_world
from repro_torch.comm.transport.harness import run_world_supervised
from repro_torch.core import codec as pcodec
from repro_torch.examples import multirank_simulation as twin

CPU = torch.device("cpu")


def _full_image(epoch, n=2, seed=0):
    """A committed image whose blobs the port encoded from tensors."""
    gen = torch.Generator().manual_seed(seed * 1000 + epoch)
    codec = pcodec.SnapshotCodec()
    ranks = {r: codec.encode(epoch,
                             {"x": torch.randn(16, generator=gen,
                                               dtype=torch.float64),
                              "b": torch.arange(r + 2, dtype=torch.int32)},
                             extra={"step": epoch * 10 + r})
             for r in range(n)}
    return {"epoch": epoch, "n_ranks": n, "ranks": ranks}


def _chain_images(epochs, n=2):
    """Epoch `epochs[0]` full, later epochs XOR deltas of tensors against
    their predecessor, each image carrying its chain."""
    snappers = {r: pcodec.IncrementalSnapshotter(
        pcodec.ChainPolicy(full_every=len(epochs) + 1)) for r in range(n)}
    x = {r: torch.arange(32, dtype=torch.float64) + r for r in range(n)}
    blobs = {r: {} for r in range(n)}
    images = []
    for epoch in epochs:
        image = {"epoch": epoch, "n_ranks": n, "ranks": {}, "chains": {}}
        for r in range(n):
            x[r] += 1.0
            blobs[r][epoch] = snappers[r].snapshot(epoch, {"x": x[r]},
                                                   extra={"step": epoch})
            image["ranks"][r] = blobs[r][epoch]
            image["chains"][r] = {e: b for e, b in blobs[r].items()
                                  if e != epoch}
        images.append(image)
    return images, x


def _corrupt_newest(store, root, mode, seed=3):
    eps = store.epochs()
    rng = random.Random(f"{seed}:{mode}")
    for rec in store.manifest(eps[-1])["blobs"].values():
        path = os.path.join(root, rec["key"])
        with open(path, "rb") as f:
            raw = bytearray(f.read())
        if mode == "flip":
            raw[rng.randrange(len(raw))] ^= 1 << rng.randrange(8)
        else:
            raw = raw[:len(raw) // 2]
        with open(path, "wb") as f:
            f.write(bytes(raw))
    return eps


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_store_crosses_between_the_packages(tmp_path, writer):
    images, x = _chain_images([1, 2, 3])
    w = (open_store if writer == "port" else rstore.open_store)(
        str(tmp_path), retain=3)
    for img in images:
        w.commit(img)
    r = (rstore.open_store if writer == "port" else open_store)(
        str(tmp_path), retain=3)
    assert r.epochs() == [1, 2, 3]
    loaded = r.load_newest_verified()
    assert loaded["epoch"] == 3
    for rank in range(2):
        arrays, extra = rcodec.restore_rank_arrays(loaded, rank)
        got, extra2 = pcodec.restore_rank_arrays(loaded, rank, device="cpu")
        assert extra == extra2 == {"step": 3}
        np.testing.assert_array_equal(arrays["x"], x[rank].numpy())
        assert torch.equal(got["x"], x[rank])


def test_commit_load_roundtrip_of_tensor_image(tmp_path):
    store = open_store(str(tmp_path), retain=4)
    img = _full_image(1)
    store.commit(img)
    loaded = store.load(1)
    for r in range(2):
        want, want_extra = pcodec.restore_rank_arrays(img, r, device="cpu")
        got, extra = pcodec.restore_rank_arrays(loaded, r, device="cpu")
        assert extra == want_extra
        for k in want:
            assert torch.equal(got[k], want[k])


@pytest.mark.parametrize("mode", ["flip", "truncate"])
def test_fallback_restore_skips_corrupt_epoch(tmp_path, mode):
    store = open_store(str(tmp_path), retain=3)
    for e in (1, 2, 3):
        store.commit(_full_image(e))
    _corrupt_newest(store, str(tmp_path), mode)
    with pytest.warns(EpochFallbackWarning, match="epoch 3"):
        img = store.load_newest_verified()
    assert img["epoch"] == 2


def test_retention_keeps_last_k_and_chain_bases(tmp_path):
    store = open_store(str(tmp_path), retain=2)
    for e in (1, 2, 3, 4):
        store.commit(_full_image(e))
    assert store.epochs() == [3, 4]
    assert not any(k.startswith("blobs/00000001/")
                   for k in store.backend.list("blobs/"))
    chained = open_store(str(tmp_path / "chain"), retain=1)
    images, x = _chain_images([1, 2, 3])
    for img in images:
        chained.commit(img)
    assert chained.epochs() == [3]
    got, _ = pcodec.restore_rank_arrays(chained.load(3), 1, device="cpu")
    assert torch.equal(got["x"], x[1])     # the bases of 3 were kept


def test_collector_uploads_tensor_world_and_cold_restart_falls_back(
        tmp_path):
    """A world of tensor shards uploads every committed epoch; after the
    newest epoch is corrupted, a cold supervised restart adopts the one
    before it with `EpochFallbackWarning`."""
    store = open_store(str(tmp_path), retain=3)
    sup = run_world_supervised(
        "inproc", 2, lambda a, i: twin.PipelineWorker(1024, "cpu", seed=8),
        store=store, retain_epochs=3, max_restarts=0, timeout=120,
        async_ckpt=True)
    store.stop()
    assert len(sup.result.results) == 2
    eps = store.epochs()
    assert len(eps) == 2
    for e in eps:
        store.verify(e)
        img = store.load(e)
        for r in range(2):
            arrays, extra = pcodec.restore_rank_arrays(img, r, device="cpu")
            assert torch.equal(arrays["shard"], twin.pipeline_expected(
                8, r, 1024, extra["step"], CPU))
    _corrupt_newest(store, str(tmp_path), "flip")
    adopted = []

    def factory(attempt, image):
        adopted.append(image["epoch"])
        # each rank restores its shard and checks it against its cut
        return twin.PipelineWorker(1024, "cpu", seed=8, steps=1,
                                   rw=restore_world(image))

    cold = open_store(str(tmp_path), retain=3)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        run_world_supervised("inproc", 2, factory, store=cold,
                             retain_epochs=3, max_restarts=0, timeout=120)
    cold.stop()
    assert adopted == [eps[-2]]
    assert any(issubclass(w.category, EpochFallbackWarning) for w in caught)
