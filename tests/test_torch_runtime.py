"""The port's MANARuntime end to end on the CPU (the cases of
tests/test_runtime_resume.py), and checkpoint images carried across
packages: a JAX image restores in the port and a port image restores
in the JAX `CheckpointManager`, with delta params and int8 moments on.

Tolerance: none for images — restored params, steps, digests and chunk
bytes are compared exactly.  The one cross-package resume compares
losses at rtol 1e-4 (float32 compute; the model agrees to that, see
tests/test_torch_model.py).
"""
import json
import os

import jax
import numpy as np
import pytest

from repro.configs import ARCHS as JARCHS, reduced_config as jreduced
from repro.configs.base import RunConfig as JRunConfig, ShapeConfig as JShape
from repro.core.checkpoint import CheckpointManager as JCheckpointManager
from repro.core.runtime import MANARuntime as JMANARuntime
from repro.data.pipeline import SyntheticDataset as JSyntheticDataset
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core.checkpoint import CheckpointManager
from repro_torch.core.codec import ImageIntegrityError
from repro_torch.core.runtime import MANARuntime
from repro_torch.data.pipeline import SyntheticDataset
from repro_torch.kernels.checksum.ref import checksum_np

SHAPE = ShapeConfig("smoke", 64, 2, "train")


def _rc(cfg, **kw):
    return RunConfig(model=cfg, shape=SHAPE, loss_chunk=32, attn_chunk=16,
                     **kw)


def _jrc(cfg, **kw):
    return JRunConfig(model=cfg, shape=JShape("smoke", 64, 2, "train"),
                      loss_chunk=32, attn_chunk=16, **kw)


def _rt(cfg, rc, d, **kw):
    return MANARuntime(cfg, rc, ckpt_dir=str(d), device="cpu", **kw)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def test_bitwise_resume(tmp_path):
    cfg = reduced_config(ARCHS["qwen2-0.5b"])
    rc = _rc(cfg)
    rt = _rt(cfg, rc, tmp_path, ckpt_every_steps=4)
    rt.initialize()
    hist = rt.run(10)
    assert rt.checkpoints_taken == 2
    assert rt.ckpt.steps() == [4, 8]

    rt2 = _rt(cfg, rc, tmp_path)
    assert rt2.restore(8) == 8
    hist2 = rt2.run(2)
    assert [h["loss"] for h in hist][8:10] == [h["loss"] for h in hist2]


def test_delta_chain_resume(tmp_path):
    """XOR-delta params: images 2, 4 (delta on 2), 6 (delta on 4); a
    restore of step 4 walks the chain and resumes bit for bit."""
    cfg = reduced_config(ARCHS["qwen2-0.5b"])
    rc = _rc(cfg)
    rt = _rt(cfg, rc, tmp_path, ckpt_every_steps=2, delta_params=True)
    rt.initialize()
    hist = rt.run(6)
    with open(os.path.join(rt.ckpt.step_dir(6), "manifest.json")) as f:
        man = json.load(f)
    assert man["arrays"]["params/embed/embedding"]["base_step"] == 4
    rt2 = _rt(cfg, rc, tmp_path, delta_params=True)
    assert rt2.restore(4) == 4
    assert [h["loss"] for h in rt2.run(2)] == [h["loss"] for h in hist][4:6]


def test_async_pipeline_resume(tmp_path):
    cfg = reduced_config(ARCHS["qwen2-0.5b"])
    rc = _rc(cfg)
    rt = _rt(cfg, rc, tmp_path, ckpt_every_steps=4, async_ckpt=True)
    rt.initialize()
    hist = rt.run(6)
    assert rt.checkpoints_taken == 1
    assert rt.ckpt.steps() == [4]
    assert rt.agent.stats["async_stages"] == 1

    rt2 = _rt(cfg, rc, tmp_path)
    assert rt2.restore(4) == 4
    hist2 = rt2.run(2)
    assert [h["loss"] for h in hist][4:6] == [h["loss"] for h in hist2]


def test_resume_wrong_arch_rejected(tmp_path):
    """qwen1.5-0.5b stands in for the reference test's rwkv6-3b: the port
    builds only dense decoders, and the check is on the arch id."""
    cfg = reduced_config(ARCHS["qwen2-0.5b"])
    rt = _rt(cfg, _rc(cfg), tmp_path, ckpt_every_steps=2)
    rt.initialize()
    rt.run(3)
    cfg2 = reduced_config(ARCHS["qwen1.5-0.5b"])
    rt2 = _rt(cfg2, _rc(cfg2), tmp_path)
    with pytest.raises(ValueError, match="arch"):
        rt2.restore()


def test_explicit_preemption_request(tmp_path):
    cfg = reduced_config(ARCHS["qwen1.5-0.5b"])
    rt = _rt(cfg, _rc(cfg), tmp_path)
    rt.initialize()
    rt.run(2)
    assert rt.checkpoints_taken == 0
    rt.request_checkpoint()
    rt.run(1)
    assert rt.checkpoints_taken == 1
    assert rt.ckpt.latest_step() == 3


def test_dataset_matches_reference():
    """Batches are numpy Philox in both packages: bit-identical."""
    cfg = reduced_config(ARCHS["qwen2-0.5b"])
    jcfg = jreduced(JARCHS["qwen2-0.5b"])
    ds = SyntheticDataset(cfg, SHAPE, seed=5)
    jds = JSyntheticDataset(jcfg, JShape("smoke", 64, 2, "train"), seed=5)
    for step in (0, 17):
        a, b = ds.get_batch(step), jds.get_batch(step)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    c = SyntheticDataset.from_state(cfg, SHAPE, ds.state_dict(17))
    np.testing.assert_array_equal(c.get_batch(17)["tokens"],
                                  ds.get_batch(17)["tokens"])
    assert not np.array_equal(ds.get_batch(18)["tokens"],
                              ds.get_batch(17)["tokens"])


def test_agent_tables_serialized_into_checkpoint(tmp_path):
    cfg = reduced_config(ARCHS["qwen2-0.5b"])
    rt = _rt(cfg, _rc(cfg), tmp_path, ckpt_every_steps=2)
    rt.initialize()
    rt.run(3)
    _, extra = rt.ckpt.restore()
    assert "agent" in extra
    assert list(extra["agent"]["comms"]["comms"].values())[0] == [0]
    assert extra["run_meta"] == {"arch": "qwen2-0.5b", "shape": "smoke",
                                 "seed": 0}
    assert extra["data"] == {"seed": 0, "step": 2}


def test_runtime_runs_on_the_card_by_default(tmp_path):
    """device=None means CUDA: without a card the entry points refuse
    instead of running on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    cfg = reduced_config(ARCHS["qwen2-0.5b"])
    with pytest.raises(RuntimeError, match="CUDA"):
        MANARuntime(cfg, _rc(cfg), ckpt_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        CheckpointManager(str(tmp_path))


def test_corrupt_chunk_is_refused(tmp_path):
    cfg = reduced_config(ARCHS["qwen2-0.5b"])
    rt = _rt(cfg, _rc(cfg), tmp_path, ckpt_every_steps=2)
    rt.initialize()
    rt.run(2)
    d = rt.ckpt.step_dir(2)
    name = next(f for f in os.listdir(d) if f.startswith("params.ln_f"))
    raw = bytearray(open(os.path.join(d, name), "rb").read())
    raw[5] ^= 1
    open(os.path.join(d, name), "wb").write(bytes(raw))
    with pytest.raises(ImageIntegrityError):
        rt.ckpt.restore(2)


# ---------------------------------------------------------------------------
# images across packages
# ---------------------------------------------------------------------------

def _jax_run(d, steps=4, **kw):
    jcfg = jreduced(JARCHS["qwen2-0.5b"])
    jrt = JMANARuntime(jcfg, _jrc(jcfg, **kw), ckpt_dir=str(d),
                       ckpt_every_steps=2, delta_params=True,
                       quantize_moments=True)
    jrt.initialize()
    hist = jrt.run(steps)
    live = _flat(jax.tree.map(np.asarray, jrt.state))
    jrt.close()
    return hist, live


def test_jax_image_restores_in_port(tmp_path):
    """A JAX MANARuntime image (step 4: XOR delta on 2, int8 moments)
    restores in the port: digests verified, params and step exact, the
    moments exactly what the JAX manager decodes; the port then resumes
    within float32 tolerance of the JAX run."""
    hist, live = _jax_run(tmp_path, steps=6, dtype="float32")
    want, jextra = JCheckpointManager(str(tmp_path)).restore(4)
    mgr = CheckpointManager(str(tmp_path), device="cpu")
    got, extra = mgr.restore(4)
    assert extra == jextra
    want, got = _flat(want), _flat(state_to_numpy(got))
    assert sorted(got) == sorted(want)
    for path, arr in want.items():
        assert got[path].dtype == arr.dtype and got[path].shape == arr.shape
        np.testing.assert_array_equal(got[path], arr, err_msg=path)

    cfg = reduced_config(ARCHS["qwen2-0.5b"])
    rt = _rt(cfg, _rc(cfg, dtype="float32"), tmp_path)
    assert rt.restore(4) == 4
    resumed = [h["loss"] for h in rt.run(2)]
    np.testing.assert_allclose(resumed, [h["loss"] for h in hist][4:6],
                               rtol=1e-4)


def test_port_image_restores_in_jax(tmp_path):
    """A port MANARuntime image (step 4: XOR delta on 2, int8 moments)
    restores in the JAX CheckpointManager with verify=True: params and
    step equal the port's live state, every array equals the port's own
    restore, and every manifest digest is checksum_np of its file."""
    cfg = reduced_config(ARCHS["qwen2-0.5b"])
    rt = _rt(cfg, _rc(cfg), tmp_path, ckpt_every_steps=2, delta_params=True,
             quantize_moments=True)
    rt.initialize()
    rt.run(4)
    live = _flat(state_to_numpy(rt.state))
    ours = _flat(state_to_numpy(rt.ckpt.restore(4)[0]))
    theirs, extra = JCheckpointManager(str(tmp_path), verify=True).restore(4)
    theirs = _flat(theirs)
    assert sorted(theirs) == sorted(ours)
    for path, arr in theirs.items():
        np.testing.assert_array_equal(arr, ours[path], err_msg=path)
        if not path.startswith("opt/m/") and not path.startswith("opt/v/"):
            np.testing.assert_array_equal(arr, live[path], err_msg=path)
    assert extra["run_meta"]["arch"] == "qwen2-0.5b"
    with open(os.path.join(rt.ckpt.step_dir(4), "manifest.json")) as f:
        man = json.load(f)
    assert man["arrays"]["params/ln_f"]["base_step"] == 2
    assert man["arrays"]["opt/m/ln_f"]["encoding"] == "int8_block"
    for entry in man["arrays"].values():
        for fm in entry["files"]:
            data = np.fromfile(os.path.join(rt.ckpt.step_dir(4), fm["file"]),
                               np.uint8)
            assert checksum_np(data) == fm["checksum"]


def test_same_state_writes_identical_images(tmp_path):
    """One state, written by both managers with the same codec stack
    (delta params, int8 moments): identical manifests (but for the
    timestamp) and identical chunk files, at a full and a delta step."""
    _, live = _jax_run(tmp_path / "src", steps=2)
    tree = {}
    for path, arr in live.items():
        node = tree
        *head, last = path.split("/")
        for p in head:
            node = node.setdefault(p, {})
        node[last] = arr
    kw = dict(delta_keys=("params",), quantize_keys=("opt/m", "opt/v"))
    jmgr = JCheckpointManager(str(tmp_path / "jax"), **kw)
    mgr = CheckpointManager(str(tmp_path / "port"), device="cpu", **kw)
    bumped = jax.tree.map(lambda a: a + 1 if a.dtype == np.float32 else a,
                          tree)
    for step, state in ((1, tree), (2, bumped)):
        jmgr.save(step, state, extra={"k": step})
        mgr.save(step, state_from_numpy(state, "cpu"), extra={"k": step})
    for step in (1, 2):
        dj, dp = jmgr.step_dir(step), mgr.step_dir(step)
        mj, mp = (json.load(open(os.path.join(x, "manifest.json")))
                  for x in (dj, dp))
        mj.pop("written_at"), mp.pop("written_at")
        assert mp == mj
        for name in os.listdir(dj):
            if name == "manifest.json":
                continue
            assert open(os.path.join(dp, name), "rb").read() == \
                open(os.path.join(dj, name), "rb").read(), name
