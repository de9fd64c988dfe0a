"""The port's encoder-decoder (reduced whisper-large-v3) and vision
cross-attention (reduced llama-3.2-vision-11b) families training on a
`DeviceMesh`, in real gloo CPU rank processes (tests/_mesh_ranks.py,
spawned by a subprocess with its own time limit).

Reduced configs with heads and vocabulary padded to 2 (the reference's
elastic-restart config), B 8 x S 64.  Whisper runs 2 + 2 layers over 24
frames a sample: the frames are split over "data" with the tokens, each
encoder block is placed by its `constrain` site, and every decoder
block's cross attention reads the encoder's output, whose gradient is
the sum of all of them, each a partial sum over "model" where the K/V
projections split heads.  Vision runs one group (a self block and a
cross block) over 16 patches a sample: its self blocks' leaves carry two
layer dims (both of size 1 here, so they stay whole in the placements).
In one world of 4 ranks, for each family:
  * it trains 6 steps on (2 data x 2 model) with an image every 2 steps;
    a same-mesh resume from step 4 repeats steps 4-5 bit for bit; a
    restore on (4 x 1) and one with no mesh run on, and the mesh run
    agrees with a mesh-free run from the same seed to rtol 5e-3 (the
    reference's cross-topology bound, tests/test_elastic.py);
  * the gradients of every leaf (the encoder's and the cross
    attention's among them) equal the mesh-free ones to rtol 1e-4, in
    float64 compute for both families and in float32 for vision.  In
    float32 reduced whisper's sit at 1.1e-4 on (2 x 2): that is its own
    sensitivity to one rounding (`tools/probe_grad_noise.py`: one
    float32 rounding of each block output moves its mesh-free gradients
    by 1.2e-4, vision's by 2.8e-5, qwen2-0.5b's by 5e-6), where a
    missing partial sum moves them by tens of percent;
  * every state leaf is a DTensor placed by `train_state_specs`;
  * images cross packages: an image the reference writes without a mesh
    restores onto a (2 x 2) port mesh bit for bit, and the port's mesh
    image restores in the reference (digests verified) bit-equal to the
    port's own mesh-free restore.
"""
import types

import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro.configs import ARCHS as JARCHS
from repro.configs import reduced_config as jreduced
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeConfig as JShape
from repro.core.checkpoint import CheckpointManager as JManager
from repro.core.runtime import MANARuntime as JRuntime
from repro.sharding.rules import ShardingRules as JRules
from repro.training.step import train_state_specs as jtrain_state_specs
from repro_torch.core.checkpoint import CheckpointManager
from repro_torch.core.runtime import MANARuntime
from repro_torch.sharding.rules import ShardingRules, placements
from repro_torch.training.step import train_state_specs

import _mesh_ranks  # tests/ is on the path (conftest.py)

# rtol between mesh factorizations: the reference's own bound
MESH_RTOL = 5e-3
# rtol between the two packages (bf16 compute)
PACKAGE_RTOL = 2e-2
# gradients on a mesh against none: summation order only
GRAD_RTOL = 1e-4
ARCHS = ("whisper-large-v3", "llama-3.2-vision-11b")
# leaves of each family that a mesh places over "model", and each
# family's leaves whose gradients must be held (encoder, cross attention)
MODEL_LEAVES = {
    "whisper-large-v3": {"params/enc_blocks/attn/wk": ["R", "S(2)"],
                         "params/blocks/xattn/wv": ["R", "S(2)"],
                         "params/blocks/xattn/wo": ["R", "S(1)"],
                         "opt/m/enc_blocks/mlp/wi": ["S(0)", "S(2)"]},
    "llama-3.2-vision-11b": {"params/self_blocks/attn/wq": ["R", "S(3)"],
                             "params/cross_blocks/xattn/wk": ["R", "S(2)"],
                             "opt/m/self_blocks/mlp/wo": ["S(3)", "S(2)"]}}
HELD = {"whisper-large-v3": ("enc_blocks/", "enc_ln_f", "blocks/xattn/",
                             "blocks/lnx"),
        "llama-3.2-vision-11b": ("self_blocks/", "cross_blocks/xattn/",
                                 "cross_blocks/attn/")}


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
    """The reference's mesh-free run of each family, 6 steps with an
    image at step 4, then one world of 4 gloo ranks that runs
    `train_and_restore` for both."""
    d = tmp_path_factory.mktemp("xattn4")
    ref_cont = {}
    for arch in ARCHS:
        cfg = jreduced(JARCHS[arch], pad_to=2)
        rc = JRunConfig(model=cfg, shape=JShape(*_mesh_ranks.SHAPE),
                        loss_chunk=32, attn_chunk=16)
        ref = JRuntime(cfg, rc, ckpt_dir=str(d / arch / "ref"),
                       ckpt_every_steps=4)
        ref.initialize()
        ref_cont[arch] = _losses(ref.run(6))[4:6]
        ref.close()
    out = _mesh_ranks.world("train_and_restore", 4, d, "2x2,4x1",
                            timeout=900, archs=",".join(ARCHS))
    out["dir"], out["ref_cont"] = d, ref_cont
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


@pytest.mark.parametrize("arch,dtype", [("whisper-large-v3", "float64"),
                                        ("llama-3.2-vision-11b", "float32"),
                                        ("llama-3.2-vision-11b", "float64")])
def test_mesh_gradients_equal_the_mesh_free_ones(worlds, arch, dtype):
    """Every leaf's gradient on (2 x 2), the encoder's and the cross
    attention's included, and the global norm over the shards, equal the
    mesh-free ones to summation order: in float64 compute for both
    families, in float32 for vision (whisper's float32 gradients sit at
    its own one-rounding sensitivity, the module docstring)."""
    got = _train(worlds, arch)["f64_grads" if dtype == "float64"
                               else "f32_grads"]
    held = [p for p in got["rel"] if p.startswith(HELD[arch])]
    assert len(held) >= 8, sorted(got["rel"])
    assert got["max_rel"] < GRAD_RTOL, got["rel"]
    np.testing.assert_allclose(got["norm"][0], got["norm"][1],
                               rtol=GRAD_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_state_leaves_carry_the_spec_placements(worlds, arch):
    """After training, every leaf of the mesh state is a DTensor placed
    by `train_state_specs` on (2 x 2): the encoder's and the cross
    attention's head and ffn leaves over "model", their moments' ZeRO-1
    dim over "data" (a vision self block's layer dims are of size 1, so
    its moments take the first dim that divides), every spec the
    reference's for the same config and mesh."""
    cfg, rc = _mesh_ranks.reduced(arch)
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(2, 2))
    specs = _flat(train_state_specs(cfg, rc, ShardingRules(mesh)))
    jcfg = jreduced(JARCHS[arch], pad_to=2)
    theirs = _flat(jtrain_state_specs(
        jcfg, JRunConfig(model=jcfg, shape=JShape(*_mesh_ranks.SHAPE)),
        JRules(AbstractMesh((2, 2), ("data", "model")))))
    assert {p: tuple(s) for p, s in specs.items()} == {
        p: tuple(s) for p, s in theirs.items()}
    got = _train(worlds, arch)["state_placements"]
    want = {p: [str(x) for x in placements(s, mesh)]
            for p, s in specs.items()}
    assert got == want
    for p, pl in MODEL_LEAVES[arch].items():
        assert got[p] == pl, p


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_image_restores_onto_a_port_mesh(worlds, arch):
    got = _train(worlds, arch)["from_reference"]
    assert got["start"] == 4
    state, _ = JManager(str(worlds["dir"] / arch / "ref")).restore(4)
    want = {p: np.asarray(a) for p, a in _flat(state).items()}
    assert sorted(got["leaves"]) == sorted(want)
    for p, a in want.items():
        assert got["leaves"][p] == _mesh_ranks._digest(a), p
    assert any("S(" in pl for pl in got["placements"])
    np.testing.assert_allclose(got["losses"], worlds["ref_cont"][arch],
                               rtol=PACKAGE_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_mesh_image_restores_in_the_reference(worlds, arch):
    d = str(worlds["dir"] / arch / "mesh")
    theirs, extra = JManager(d, verify=True).restore(4)
    ours, our_extra = CheckpointManager(d, device="cpu").restore(4)
    assert extra == our_extra and extra["data"]["step"] == 4
    ours = {p: t.numpy() for p, t in _flat(ours).items()}
    theirs = {p: np.asarray(a) for p, a in _flat(theirs).items()}
    assert sorted(ours) == sorted(theirs)
    for p, a in theirs.items():
        assert a.dtype == ours[p].dtype and np.array_equal(a, ours[p]), p
