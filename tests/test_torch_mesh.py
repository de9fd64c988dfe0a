"""The port's checkpointed training on a `DeviceMesh`, in real gloo CPU
rank processes (tests/_mesh_ranks.py, spawned by a subprocess with its
own time limit; the process group's store takes a port the OS picks).

Reduced qwen2-0.5b with heads and vocabulary padded to 2 (the
reference's elastic-restart config), B 8 x S 64:
  * on 4 ranks it trains 8 steps on (2 data x 2 model) with an image
    every 4 steps; a same-mesh resume from step 4 repeats steps 4-7 bit
    for bit; restores on (4 x 1) and with no mesh run on, and the mesh
    run agrees with a mesh-free run from the same seed, to rtol 5e-3
    (the reference's cross-topology bound, tests/test_elastic.py: the
    summation order of bf16 products changes with the factorization);
    in float32 compute the mesh's gradients and their global norm equal
    the mesh-free ones to rtol 1e-4 (summation order only);
  * images cross packages: an image the reference writes without a mesh
    restores onto a (2 x 2) port mesh bit for bit, and the image written
    from the port's mesh restores in the reference (digests verified)
    bit-equal to the port's own mesh-free restore; the losses run on
    from the reference's image agree with the reference's own to 2e-2
    relative (the bf16 tolerance between the packages,
    tests/test_torch_model.py);
  * the embedding gather of a vocab-sharded table, and its fixed-order
    backward, equal the mesh-free results bit for bit on (1 x 2) and
    (2 x 1);
  * the 8-rank twin of the reference's `slow`
    `test_elastic_restart_across_mesh_shapes`: (4 x 2) -> (2 x 4) -> no
    mesh, `slow` as the reference's is.
"""
import json
import os
import subprocess
import sys

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

import _mesh_ranks  # tests/ is on the path (conftest.py)

HELPER = _mesh_ranks.__file__
ENV = dict(os.environ, PYTHONPATH=_mesh_ranks.SRC)
# rtol between mesh factorizations: the reference's own bound
MESH_RTOL = 5e-3
# rtol between the two packages (bf16 compute)
PACKAGE_RTOL = 2e-2
# float32 gradients on a mesh against none: summation order only
F32_RTOL = 1e-4


def world(scenario: str, n: int, d, arg: str, timeout: int):
    """Rank 0's result of `scenario` in a world of `n` gloo ranks."""
    res = subprocess.run([sys.executable, HELPER, scenario, str(n), str(d),
                          arg], env=ENV, capture_output=True, text=True,
                         timeout=timeout)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def _port_runtime(d, **kw):
    cfg, rc = _mesh_ranks.reduced_qwen()
    return MANARuntime(cfg, rc, ckpt_dir=str(d), device="cpu", **kw)


def _ref_runtime(d, **kw):
    cfg = jreduced(JARCHS["qwen2-0.5b"], pad_to=2)
    rc = JRunConfig(model=cfg, shape=JShape(*_mesh_ranks.SHAPE),
                    loss_chunk=32, attn_chunk=16)
    return JRuntime(cfg, rc, ckpt_dir=str(d), **kw)


def _losses(hist):
    return [h["loss"] for h in hist]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The reference's mesh-free image (4 steps, images at 2 and 4) and
    its continuation from step 4, then one world of 4 gloo ranks: the
    reference's image onto (2 x 2), training on (2 x 2), restores on
    (2 x 2) and (4 x 1)."""
    d = tmp_path_factory.mktemp("mesh4")
    ref = _ref_runtime(d / "ref", ckpt_every_steps=2)
    ref.initialize()
    ref.run(4)
    ref.close()
    cont = _ref_runtime(d / "ref")     # writes no image: no trigger
    assert cont.restore(4) == 4
    ref_cont = _losses(cont.run(2))
    cont.close()
    out = world("train_and_restore", 4, d, "2x2,4x1", timeout=900)
    out["dir"], out["ref_cont"] = d, ref_cont
    return out


def test_mesh_resume_repeats_the_run_bit_for_bit(four_ranks):
    assert four_ranks["images"] == [4, 8]
    assert four_ranks["2x2"]["start"] == 4
    assert four_ranks["2x2"]["losses"] == four_ranks["train"][4:8]


def test_mesh_image_restores_on_other_meshes_and_without_one(four_ranks):
    want = four_ranks["train"][4:8]
    assert four_ranks["4x1"]["start"] == 4
    np.testing.assert_allclose(four_ranks["4x1"]["losses"], want,
                               rtol=MESH_RTOL)
    rt = _port_runtime(four_ranks["dir"] / "mesh")
    assert rt.restore(4) == 4
    np.testing.assert_allclose(_losses(rt.run(4)), want, rtol=MESH_RTOL)
    rt.close()
    # the same seed without a mesh: the mesh placed the same init
    fresh = _port_runtime(four_ranks["dir"] / "nomesh")
    fresh.initialize()
    np.testing.assert_allclose(_losses(fresh.run(8)), four_ranks["train"],
                               rtol=MESH_RTOL)
    fresh.close()


def test_mesh_gradients_equal_the_mesh_free_ones_in_float32(four_ranks):
    """In float32 compute the (2 x 2) mesh's gradients, and their global
    norm over the shards, are the mesh-free ones to summation order
    (about 1e-5 measured).  In bf16 both stacks' reduced-model gradients
    sit 35-78% from their float32 ones, so only the losses are compared
    there."""
    got = four_ranks["f32_grads"]
    assert got["max_rel"] < F32_RTOL
    np.testing.assert_allclose(got["norm"][0], got["norm"][1],
                               rtol=F32_RTOL)


def test_reference_image_restores_onto_a_port_mesh(four_ranks):
    got = four_ranks["from_reference"]
    assert got["start"] == 4
    state, _ = JManager(str(four_ranks["dir"] / "ref")).restore(4)
    want = _flat(state)
    assert sorted(got["leaves"]) == sorted(want)
    for p, a in want.items():
        assert got["leaves"][p] == _mesh_ranks._digest(a), p
    # the leaves really were sharded on the mesh
    assert any("S(" in pl for pl in got["placements"])
    np.testing.assert_allclose(got["losses"], four_ranks["ref_cont"],
                               rtol=PACKAGE_RTOL)


def test_port_mesh_image_restores_in_the_reference(four_ranks):
    d = str(four_ranks["dir"] / "mesh")
    theirs, extra = JManager(d, verify=True).restore(4)
    ours, our_extra = CheckpointManager(d, device="cpu").restore(4)
    assert extra == our_extra and extra["data"]["step"] == 4
    ours = {p: t.numpy() for p, t in _flat_torch(ours).items()}
    theirs = _flat(theirs)
    assert sorted(ours) == sorted(theirs)
    for p, a in theirs.items():
        assert a.dtype == ours[p].dtype and np.array_equal(a, ours[p]), p


def _flat_torch(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat_torch(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


@pytest.fixture(scope="module")
def embed_worlds(tmp_path_factory):
    return world("embed_on_mesh", 2, tmp_path_factory.mktemp("embed"),
                 "1x2,2x1", timeout=300)


@pytest.mark.parametrize("mesh", ["1x2", "2x1"])
def test_embedding_on_a_mesh_is_bit_equal(embed_worlds, mesh):
    got = embed_worlds[mesh]
    assert got["forward_equal"] and got["grad_equal"]
    # the rows are partial sums over the vocabulary's mesh dim, and the
    # table's gradient keeps the table's placements
    assert got["out_placements"] == ["S(0)", "P(sum)"]
    assert got["grad_placements"] == ["R", "S(0)"]


@pytest.mark.slow
def test_elastic_restart_across_mesh_shapes_8_ranks(tmp_path):
    """The reference's `test_elastic_restart_across_mesh_shapes` on 8
    gloo ranks: train on (4 x 2) with an image at step 4, restore on
    (2 x 4) and with no mesh, losses to rtol 5e-3."""
    out = world("train_and_restore", 8, tmp_path, "4x2,2x4", timeout=1800)
    want = out["train"][4:8]
    assert out["4x2"]["losses"] == want
    assert out["2x4"]["start"] == 4
    np.testing.assert_allclose(out["2x4"]["losses"], want, rtol=MESH_RTOL)
    rt = _port_runtime(tmp_path / "mesh")
    assert rt.restore(4) == 4
    np.testing.assert_allclose(_losses(rt.run(4)), want, rtol=MESH_RTOL)
    rt.close()
