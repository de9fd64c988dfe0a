"""The port's MoE family (reduced Mixtral-8x7B) training on a
`DeviceMesh` in both sharding modes, in real gloo CPU rank processes
(tests/_mesh_ranks.py, spawned by a subprocess with its own time limit).

Reduced Mixtral-8x7B with heads and vocabulary padded to 2 (the
reference's elastic-restart config): 4 experts top-2 split 4 ways, so 16
virtual experts; SWA 32; B 4 x S 512, so each data rank holds whole
512-token dispatch groups.  In one world of 4 ranks, for `moe_mode`
"ep" (experts over "model") and "tp" (each expert's ffn over "model"):
  * it trains 6 steps on (2 data x 2 model) with an image every 2 steps;
    a same-mesh resume from step 4 repeats steps 4-5 (loss and
    `moe_aux`) bit for bit; a restore on (4 x 1) and one with no mesh
    run on, and the mesh run agrees with a mesh-free run from the same
    seed, loss and `moe_aux` to rtol 5e-3 (the reference's
    cross-topology bound, tests/test_elastic.py); in float32 compute the
    mesh's gradients and their global norm equal the mesh-free ones to
    rtol 1e-4 (summation order only); every state leaf is a DTensor
    placed by `train_state_specs`;
  * one forward of the model's loss on (2 x 2) under CommDebugMode
    all-gathers no expert weight (`wi`, `wg`, `wo`): the fault the
    reference's constraint on the per-expert buffers guards against
    (`src/repro/models/moe.py:112-114`);
  * in "ep", images cross packages: an image the reference writes
    without a mesh restores onto a (2 x 2) port mesh bit for bit, and
    the port's mesh image restores in the reference (digests verified)
    bit-equal to the port's own mesh-free restore;
  * sliding-window attention on the mesh equals the mesh-free result
    bit for bit, and the window is kept; the MoE layer at B 4 x S 256
    on (4 x 1), whose groups straddle data ranks, equals its mesh-free
    forward.
"""
import dataclasses
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
MODES = ("ep", "tp")
ARCH = "mixtral-8x7b"


def tag(mode: str) -> str:
    return f"{ARCH}:{mode}"


def _losses(hist, key="loss"):
    return [h[key] for h in hist]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _ref_runtime(d, **kw):
    cfg = jreduced(JARCHS[ARCH], pad_to=2)
    rc = JRunConfig(model=cfg, shape=JShape(*_mesh_ranks.MOE_SHAPE),
                    loss_chunk=32, attn_chunk=16)
    return JRuntime(cfg, rc, ckpt_dir=str(d), **kw)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The reference's mesh-free run of 6 steps with an image at step 4
    (in the "ep" arch's directory), then one world of 4 gloo ranks that
    runs `train_and_restore` and `moe_parts` for both modes."""
    d = tmp_path_factory.mktemp("moe4")
    ref = _ref_runtime(d / f"{ARCH}-ep" / "ref", ckpt_every_steps=4)
    ref.initialize()
    ref_losses = _losses(ref.run(6))
    ref.close()
    out = _mesh_ranks.world("train_and_restore,moe_parts", 4, d,
                            "2x2,4x1", timeout=900,
                            archs=",".join(tag(m) for m in MODES))
    out["dir"], out["ref_cont"] = d, ref_losses[4:6]
    return out


def _train(worlds, mode):
    return worlds[f"train_and_restore@{tag(mode)}"]


def _mesh_dir(worlds, mode):
    return worlds["dir"] / f"{ARCH}-{mode}" / "mesh"


@pytest.mark.parametrize("mode", MODES)
def test_mesh_resume_repeats_the_run_bit_for_bit(worlds, mode):
    got = _train(worlds, mode)
    assert got["images"] == [2, 4, 6]
    assert got["2x2"]["start"] == 4
    assert got["2x2"]["losses"] == got["train"][4:6]
    assert got["2x2"]["aux"] == got["train_aux"][4:6]


@pytest.mark.parametrize("mode", MODES)
def test_meshes_and_no_mesh_agree(worlds, mode):
    got = _train(worlds, mode)
    cfg, rc = _mesh_ranks.reduced(tag(mode))
    assert got["4x1"]["start"] == 4
    for key, want in (("losses", got["train"][4:6]),
                      ("aux", got["train_aux"][4:6])):
        np.testing.assert_allclose(got["4x1"][key], want, rtol=MESH_RTOL)
    rt = MANARuntime(cfg, rc, ckpt_dir=str(_mesh_dir(worlds, mode)),
                     device="cpu")
    assert rt.restore(4) == 4
    hist = rt.run(2)
    rt.close()
    np.testing.assert_allclose(_losses(hist), got["train"][4:6],
                               rtol=MESH_RTOL)
    np.testing.assert_allclose(_losses(hist, "moe_aux"),
                               got["train_aux"][4:6], rtol=MESH_RTOL)
    # the same seed without a mesh: the mesh placed the same init
    fresh = MANARuntime(cfg, rc, ckpt_dir=str(worlds["dir"] / f"free-{mode}"),
                        device="cpu")
    fresh.initialize()
    hist = fresh.run(6)
    fresh.close()
    np.testing.assert_allclose(_losses(hist), got["train"], rtol=MESH_RTOL)
    np.testing.assert_allclose(_losses(hist, "moe_aux"), got["train_aux"],
                               rtol=MESH_RTOL)


@pytest.mark.parametrize("mode", MODES)
def test_mesh_gradients_equal_the_mesh_free_ones_in_float32(worlds, mode):
    """Every leaf's float32 gradient on (2 x 2), and the global norm over
    the shards, equal the mesh-free ones to summation order (about 1e-5
    measured); the expert weights' among them, which a replicated weight
    whose gradient is not summed over the data ranks would miss."""
    got = _train(worlds, mode)["f32_grads"]
    assert got["max_rel"] < F32_RTOL, got["rel"]
    np.testing.assert_allclose(got["norm"][0], got["norm"][1],
                               rtol=F32_RTOL)


@pytest.mark.parametrize("mode", MODES)
def test_state_leaves_carry_the_spec_placements(worlds, mode):
    """After training, every leaf of the mesh state is a DTensor placed
    by `train_state_specs` on (2 x 2): the expert leaves on "expert"
    ("ep") or "expert_ffn" ("tp") over "model", their moments also
    over "data" (ZeRO-1)."""
    cfg, rc = _mesh_ranks.reduced(tag(mode))
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(2, 2))
    specs = _flat(train_state_specs(cfg, rc, ShardingRules(
        mesh, moe_mode=mode)))
    want = {p: [str(x) for x in placements(s, mesh)]
            for p, s in specs.items()}
    got = _train(worlds, mode)["state_placements"]
    assert got == want
    expert = "S(1)" if mode == "ep" else "S(3)"
    assert got["params/blocks/moe/wi"] == ["R", expert]
    assert got["opt/m/blocks/moe/wi"] == ["S(0)", expert]


@pytest.mark.parametrize("mode", MODES)
def test_moe_forward_gathers_no_expert_weight(worlds, mode):
    got = worlds[f"moe_parts@{tag(mode)}"]
    counts = got["comm_counts"]
    assert counts.get("c10d_functional.all_gather_into_tensor", 0) == len(
        got["gathers"])
    # every all-gather is over one dim of the mesh, and none is of an
    # expert weight's shard (over "model" or any other dim)
    assert all(len(g["over"]) == 1 and g["over"][0] for g in got["gathers"])
    shards = {tuple(s) for s in got["shards"]}
    weights = [g for g in got["gathers"]
               if tuple(g["shape"][-3:]) in shards]
    assert weights == [], weights
    # the forward does reduce over the model axis (the combine)
    assert counts.get("c10d_functional.all_reduce", 0) > 0


def test_sliding_window_attention_keeps_its_window_on_a_mesh(worlds):
    got = worlds[f"moe_parts@{tag('ep')}"]["swa"]
    assert got == {"equal": True, "differs_from_causal": True}


def test_moe_groups_straddling_data_ranks(worlds):
    """B 4 x S 256 on (4 x 1): each 512-token group spans two data ranks,
    so the tokens are replicated before grouping; output and `moe_aux`
    equal the mesh-free ones bit for bit (no model split)."""
    got = worlds[f"moe_parts@{tag('ep')}"]["straddle"]
    assert got == {"equal": True, "aux_equal": True}


def test_reference_image_restores_onto_a_port_mesh(worlds):
    got = _train(worlds, "ep")["from_reference"]
    assert got["start"] == 4
    ref = worlds["dir"] / f"{ARCH}-ep" / "ref"
    state, _ = JManager(str(ref)).restore(4)
    want = {p: np.asarray(a) for p, a in _flat(state).items()}
    assert sorted(got["leaves"]) == sorted(want)
    for p, a in want.items():
        assert got["leaves"][p] == _mesh_ranks._digest(a), p
    # the expert leaves really were split over "model"
    assert any("S(1)" in pl for pl in got["placements"])
    np.testing.assert_allclose(got["losses"], worlds["ref_cont"],
                               rtol=PACKAGE_RTOL)


def test_port_mesh_image_restores_in_the_reference(worlds):
    d = str(_mesh_dir(worlds, "ep"))
    theirs, extra = JManager(d, verify=True).restore(4)
    ours, our_extra = CheckpointManager(d, device="cpu").restore(4)
    assert extra == our_extra and extra["data"]["step"] == 4
    ours = {p: t.numpy() for p, t in _flat(ours).items()}
    theirs = {p: np.asarray(a) for p, a in _flat(theirs).items()}
    assert sorted(ours) == sorted(theirs)
    for p, a in theirs.items():
        assert a.dtype == ours[p].dtype and np.array_equal(a, ours[p]), p


def test_reference_config_matches():
    """The reduced config both packages train here: 16 virtual experts,
    whole 512-token groups per data rank on (2 x 2) and (4 x 1)."""
    cfg, rc = _mesh_ranks.reduced(tag("ep"))
    jcfg = jreduced(JARCHS[ARCH], pad_to=2)
    ours, theirs = dataclasses.asdict(cfg), dataclasses.asdict(jcfg)
    assert {k: ours[k] for k in theirs} == theirs
    # the port's fields the reference lacks (granite's `layer_types`
    # stack) hold their defaults
    assert all(ours[f.name] == f.default for f in dataclasses.fields(cfg)
               if f.name not in theirs)
    from repro_torch.models.transformer import moe_split

    assert cfg.moe.num_experts * moe_split(cfg) == 16
    B, S = rc.shape.global_batch, rc.shape.seq_len
    for data in (2, 4):
        assert (B * S // 512) % data == 0
