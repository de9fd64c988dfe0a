"""The port's hybrid-SSM (reduced hymba-1.5b) and RWKV-6 (reduced
rwkv6-3b) families training on a `DeviceMesh`, in real gloo CPU rank
processes (tests/_mesh_ranks.py, spawned by a subprocess with its own
time limit).

Reduced configs with heads and vocabulary padded to 2 (the reference's
elastic-restart config), B 8 x S 64.  Hymba's mamba heads are 16 of
width 8 carved out of a `d_inner` of 128, which "model" splits; rwkv's
time-mix splits its heads and its channel-mix its ffn over "model".
Both run the shared chunked linear-attention engine on each rank's own
(batch, heads) block.  In one world of 4 ranks, for each family:
  * it trains 6 steps on (2 data x 2 model) with an image every 2 steps;
    a same-mesh resume from step 4 repeats steps 4-5 bit for bit; a
    restore on (4 x 1) and one with no mesh run on, and the mesh run
    agrees with a mesh-free run from the same seed to rtol 5e-3 (the
    reference's cross-topology bound, tests/test_elastic.py); in
    float32 compute the mesh's gradients and their global norm equal
    the mesh-free ones to rtol 1e-4 (summation order only); every
    state leaf is a DTensor placed by `train_state_specs`;
  * the engine alone on (2 x 2) gives the mesh-free output and final
    state bit for bit, and its float32 gradients (rwkv's bonus `u`,
    whole over "data", among them) to summation order;
  * for rwkv, images cross packages: an image the reference writes
    without a mesh restores onto a (2 x 2) port mesh bit for bit, and
    the port's mesh image restores in the reference (digests verified)
    bit-equal to the port's own mesh-free restore.
"""
import types

import numpy as np
import pytest

from repro.configs import ARCHS as JARCHS
from repro.configs import reduced_config as jreduced
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeConfig as JShape
from repro.core.checkpoint import CheckpointManager as JManager
from repro.core.runtime import MANARuntime as JRuntime
from repro_torch.core.checkpoint import CheckpointManager
from repro_torch.core.runtime import MANARuntime
from repro_torch.sharding.rules import ShardingRules, placements
from repro_torch.training.step import train_state_specs

import _mesh_ranks  # tests/ is on the path (conftest.py)

# rtol between mesh factorizations: the reference's own bound
MESH_RTOL = 5e-3
# rtol between the two packages (bf16 compute)
PACKAGE_RTOL = 2e-2
# float32 gradients on a mesh against none: summation order only
F32_RTOL = 1e-4
ARCHS = ("hymba-1.5b", "rwkv6-3b")
# the linear-attention family whose images cross packages
CROSS = "rwkv6-3b"


def _losses(hist):
    return [h["loss"] for h in hist]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The reference's mesh-free rwkv run of 6 steps with an image at
    step 4, then one world of 4 gloo ranks that runs `train_and_restore`
    and `la_parts` for both families."""
    d = tmp_path_factory.mktemp("ssm4")
    cfg = jreduced(JARCHS[CROSS], pad_to=2)
    rc = JRunConfig(model=cfg, shape=JShape(*_mesh_ranks.SHAPE),
                    loss_chunk=32, attn_chunk=16)
    ref = JRuntime(cfg, rc, ckpt_dir=str(d / CROSS / "ref"),
                   ckpt_every_steps=4)
    ref.initialize()
    ref_losses = _losses(ref.run(6))
    ref.close()
    out = _mesh_ranks.world("train_and_restore,la_parts", 4, d, "2x2,4x1",
                            timeout=900, archs=",".join(ARCHS))
    out["dir"], out["ref_cont"] = d, ref_losses[4:6]
    return out


def _train(worlds, arch):
    return worlds[f"train_and_restore@{arch}"]


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_resume_repeats_the_run_bit_for_bit(worlds, arch):
    got = _train(worlds, arch)
    assert got["images"] == [2, 4, 6]
    assert got["2x2"]["start"] == 4
    assert got["2x2"]["losses"] == got["train"][4:6]


@pytest.mark.parametrize("arch", ARCHS)
def test_meshes_and_no_mesh_agree(worlds, arch):
    got = _train(worlds, arch)
    cfg, rc = _mesh_ranks.reduced(arch)
    want = got["train"][4:6]
    assert got["4x1"]["start"] == 4
    np.testing.assert_allclose(got["4x1"]["losses"], want, rtol=MESH_RTOL)
    rt = MANARuntime(cfg, rc, ckpt_dir=str(worlds["dir"] / arch / "mesh"),
                     device="cpu")
    assert rt.restore(4) == 4
    np.testing.assert_allclose(_losses(rt.run(2)), want, rtol=MESH_RTOL)
    rt.close()
    # the same seed without a mesh: the mesh placed the same init
    fresh = MANARuntime(cfg, rc, ckpt_dir=str(worlds["dir"] / f"free-{arch}"),
                        device="cpu")
    fresh.initialize()
    np.testing.assert_allclose(_losses(fresh.run(6)), got["train"],
                               rtol=MESH_RTOL)
    fresh.close()


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_gradients_equal_the_mesh_free_ones_in_float32(worlds, arch):
    """Every leaf's float32 gradient on (2 x 2), and the global norm over
    the shards, equal the mesh-free ones to summation order (about 1e-5
    measured)."""
    got = _train(worlds, arch)["f32_grads"]
    assert got["max_rel"] < F32_RTOL, got["rel"]
    np.testing.assert_allclose(got["norm"][0], got["norm"][1],
                               rtol=F32_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_state_leaves_carry_the_spec_placements(worlds, arch):
    """After training, every leaf of the mesh state is a DTensor placed
    by `train_state_specs` on (2 x 2): hymba's `d_inner` leaves and
    rwkv's `heads` and `ffn` leaves over "model"."""
    cfg, rc = _mesh_ranks.reduced(arch)
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(2, 2))
    specs = _flat(train_state_specs(cfg, rc, ShardingRules(mesh)))
    want = {p: [str(x) for x in placements(s, mesh)]
            for p, s in specs.items()}
    got = _train(worlds, arch)["state_placements"]
    assert got == want
    model = ({"params/blocks/mamba/wx": ["R", "S(2)"],
              "params/blocks/mamba/wo": ["R", "S(1)"]}
             if arch.startswith("hymba") else
             {"params/blocks/tm/wr": ["R", "S(2)"],
              "params/blocks/tm/wB": ["R", "S(2)"],
              "params/blocks/cm/wck": ["R", "S(2)"]})
    for p, pl in model.items():
        assert got[p] == pl, p


@pytest.mark.parametrize("arch", ARCHS)
def test_linear_attention_engine_on_a_mesh(worlds, arch):
    got = worlds[f"la_parts@{arch}"]
    assert got["out_equal"] and got["state_equal"]
    assert got["placements"] == ["S(0)", "S(2)"]
    assert got["state_placements"] == ["S(0)", "S(1)"]
    assert len(got["grad_rel"]) == (5 if arch == CROSS else 4)
    assert max(got["grad_rel"]) < F32_RTOL


def test_reference_image_restores_onto_a_port_mesh(worlds):
    got = _train(worlds, CROSS)["from_reference"]
    assert got["start"] == 4
    state, _ = JManager(str(worlds["dir"] / CROSS / "ref")).restore(4)
    want = {p: np.asarray(a) for p, a in _flat(state).items()}
    assert sorted(got["leaves"]) == sorted(want)
    for p, a in want.items():
        assert got["leaves"][p] == _mesh_ranks._digest(a), p
    assert any("S(" in pl for pl in got["placements"])
    np.testing.assert_allclose(got["losses"], worlds["ref_cont"],
                               rtol=PACKAGE_RTOL)


def test_port_mesh_image_restores_in_the_reference(worlds):
    d = str(worlds["dir"] / CROSS / "mesh")
    theirs, extra = JManager(d, verify=True).restore(4)
    ours, our_extra = CheckpointManager(d, device="cpu").restore(4)
    assert extra == our_extra and extra["data"]["step"] == 4
    ours = {p: t.numpy() for p, t in _flat(ours).items()}
    theirs = {p: np.asarray(a) for p, a in _flat(theirs).items()}
    assert sorted(ours) == sorted(theirs)
    for p, a in theirs.items():
        assert a.dtype == ours[p].dtype and np.array_equal(a, ours[p]), p
