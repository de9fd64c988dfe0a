"""The port's FSDP training (`RunConfig.fsdp`: params, and so their
gradients, sharded over "data" too, the reference's ZeRO-3) on a
`DeviceMesh`, in real gloo CPU rank processes (tests/_mesh_ranks.py,
spawned by a subprocess with its own time limit).

Two reduced configs, heads and vocabulary padded to 2, on (2 data x 2
model):
  * Mixtral-8x7B at 2 layers ("ep"; B 2 x S 512, one dispatch group a
    data rank): FSDP puts "data" on every stacked
    leaf's layer dim, which DTensor cannot unbind; the model moves that
    split to another dim once a step and gathers each layer at its use;
  * qwen2-0.5b with one KV head at 3 layers: "data" lands on d (3 layers
    do not divide by 2), and the KV head divides no "model" axis, so
    each rank computes only its own query heads against the K/V it
    picks for them.
In one world of 4 ranks each trains 3 steps with an image at step 2,
from the seed a mesh-free run starts from: losses (and `moe_aux`) agree with
the mesh-free run to rtol 5e-3 (the reference's cross-topology bound);
step 0's gradients equal the mesh-free ones to summation order, rtol
1e-4 (every leaf in float32 for Mixtral, both global norms in float32;
the one-KV-head config's leaves in float64 compute, its attention scores
still float32: one float32 rounding of its block outputs moves its
gradients 6.4e-5, `tools/probe_grad_noise.py`, and the mesh's reordering
2.3e-4, with the heads split or, as before this config's split, whole
on every rank); a same-mesh resume from step 2 repeats
step 2 bit for bit; every state leaf is placed by `train_state_specs`
with `fsdp`; the image restores in the reference (digests verified)
bit-equal to the port's own mesh-free restore; and both serve from
their FSDP-placed params as without a mesh (`serve_split`).
"""
import dataclasses
import types

import numpy as np
import pytest

from repro.configs import ARCHS as JARCHS
from repro.configs import reduced_config as jreduced
from repro.core.checkpoint import CheckpointManager as JManager
from repro_torch.core.checkpoint import CheckpointManager
from repro_torch.core.runtime import MANARuntime
from repro_torch.sharding.rules import ShardingRules, placements
from repro_torch.training.step import train_state_specs

import _mesh_ranks  # tests/ is on the path (conftest.py)

MESH_RTOL = 5e-3
# gradients on a mesh against none: summation order only
GRAD_RTOL = 1e-4
ARCHS = ("mixtral-8x7b:ep@b2+fsdp", "qwen2-0.5b@kv1+fsdp")
STEPS = _mesh_ranks.FSDP_STEPS


def _losses(hist, key="loss"):
    return [h[key] for h in hist]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _dir(world, arch):
    return world["dir"] / arch.replace(":", "-") / "mesh"


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One world of 4 gloo ranks running `fsdp_train` for both configs,
    and each config's mesh-free run of the same steps from the same
    seed."""
    d = tmp_path_factory.mktemp("fsdp4")
    out = _mesh_ranks.world("fsdp_train,serve_split", 4, d, "2x2",
                            timeout=600, archs=",".join(ARCHS))
    out["dir"], out["free"] = d, {}
    for arch in ARCHS:
        cfg, rc = _mesh_ranks.reduced(arch)
        rt = MANARuntime(cfg, rc, ckpt_dir=str(d / f"free-{arch[:7]}"),
                         device="cpu")
        rt.initialize()
        hist = rt.run(STEPS)
        rt.close()
        out["free"][arch] = {"loss": _losses(hist),
                             "moe_aux": _losses(hist, "moe_aux")}
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_losses_agree_with_the_mesh_free_run(world, arch):
    got = world[f"fsdp_train@{arch}"]
    free = world["free"][arch]
    np.testing.assert_allclose(got["train"], free["loss"], rtol=MESH_RTOL)
    np.testing.assert_allclose(got["train_aux"], free["moe_aux"],
                               rtol=MESH_RTOL)
    assert all(np.isfinite(got["train"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_gradients_equal_the_mesh_free_ones(world, arch):
    got = world[f"fsdp_train@{arch}"]
    f32 = got["f32_grads"]
    np.testing.assert_allclose(f32["norm"][0], f32["norm"][1],
                               rtol=GRAD_RTOL)
    each = got["f64_grads" if arch in _mesh_ranks.F64_GRADS else "f32_grads"]
    assert each["max_rel"] < GRAD_RTOL, each["rel"]


@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_resume_repeats_the_run_bit_for_bit(world, arch):
    got = world[f"fsdp_train@{arch}"]
    assert got["images"] == [2]
    assert got["resumed"]["start"] == 2
    assert got["resumed"]["losses"] == got["train"][2:]
    assert got["resumed"]["aux"] == got["train_aux"][2:]


@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_state_leaves_carry_the_fsdp_placements(world, arch):
    """Every leaf of the mesh state after training is a DTensor placed by
    `train_state_specs` with `fsdp` on (2 x 2): Mixtral's stacked params
    split on their layer dim over "data", the 3-layer config's on d."""
    cfg, rc = _mesh_ranks.reduced(arch)
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(2, 2))
    specs = _flat(train_state_specs(cfg, rc, ShardingRules(
        mesh, moe_mode=rc.moe_mode)))
    want = {p: [str(x) for x in placements(s, mesh)]
            for p, s in specs.items()}
    got = world[f"fsdp_train@{arch}"]["state_placements"]
    assert got == want
    data_dim = "S(0)" if arch.startswith("mixtral") else "S(1)"
    assert got["params/blocks/attn/wq"] == [data_dim, "S(2)"]
    assert got["params/blocks/ln1"][0] == data_dim


@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_image_restores_in_the_reference(world, arch):
    d = str(_dir(world, arch))
    theirs, extra = JManager(d, verify=True).restore(2)
    ours, our_extra = CheckpointManager(d, device="cpu").restore(2)
    assert extra == our_extra and extra["data"]["step"] == 2
    ours = {p: t.numpy() for p, t in _flat(ours).items()}
    theirs = {p: np.asarray(a) for p, a in _flat(theirs).items()}
    assert sorted(ours) == sorted(theirs)
    for p, a in theirs.items():
        assert a.dtype == ours[p].dtype and np.array_equal(a, ours[p]), p


@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_params_serve_as_without_a_mesh(world, arch):
    """The same configs served in float32 from FSDP-placed params,
    without `kv_time_shard` (the one-KV-head caches stay whole on
    "model" while the query heads split, and the prefill and decode
    attention pick each rank's KV head): prefill and 4 greedy tokens
    equal to the mesh-free run's, logits within 5e-3 of their norm,
    every decode-state leaf placed by `decode_state_specs`."""
    got = world[f"serve_split@{arch}"]
    assert got["tokens_equal"] and got["misplaced"] == []
    assert max(got["rel"]) < MESH_RTOL, got["rel"]


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_config_matches(arch):
    cfg, rc = _mesh_ranks.reduced(arch)
    name, _, variant = arch.split("+")[0].partition("@")
    over = {k: v for k, v in _mesh_ranks.VARIANTS.get(variant, {}).items()
            if k != "batch"}
    jcfg = dataclasses.replace(jreduced(JARCHS[name.split(":")[0]],
                                        pad_to=2), **over)
    ours, theirs = dataclasses.asdict(cfg), dataclasses.asdict(jcfg)
    assert {k: ours[k] for k in theirs} == theirs
    # the port's fields the reference lacks (granite's `layer_types`
    # stack) hold their defaults
    assert all(ours[f.name] == f.default for f in dataclasses.fields(cfg)
               if f.name not in theirs)
    assert rc.fsdp
