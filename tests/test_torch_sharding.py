"""The port's sharding rules and spec trees against the reference's, in
one process with no devices.

The reference's rules run on a `jax.sharding.AbstractMesh`; the port's
run on a real `DeviceMesh` over a `fake` process group of 512 ranks
(`FakeStore`: no communication), each mesh built over the world's first
ranks.  Every spec tree (`train_state_specs`, `batch_specs` for every
shape, `decode_state_specs`) is held leaf by leaf, exactly, against the
reference's for the 10 archs, on meshes (4, 2), (16, 16) and (2, 16, 16),
with each sharding switch (`fsdp`, `zero1` off, `moe_mode="tp"`,
`seq_shard`, `kv_time_shard`).  The reference's own rule checks
(tests/test_sharding.py, `slow` there) run here as fast cases, and the
placements a spec turns into are held to the block each device gets in
JAX, rank by rank.
"""
import contextlib
import json
import math
import os
import subprocess
import sys

import jax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import distribute_tensor
from torch.testing._internal.distributed.fake_pg import FakeStore

import jax.numpy as jnp

from repro.configs import ARCHS as JARCHS
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import SHAPES as JSHAPES
from repro.data.pipeline import make_batch_specs as jmake_batch_specs
from repro.sharding import rules as jrules
from repro.training import step as jstep
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.configs.base import RunConfig
from repro_torch.core.split_state import LowerHalf
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.launch import mesh as port_mesh
from repro_torch.sharding import rules
from repro_torch.sharding.rules import PartitionSpec as P
from repro_torch.training import step

MESHES = {"4x2": ((4, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
SWITCHES = {"default": {}, "fsdp": {"fsdp": True},
            "no_zero1": {"zero1": False}, "moe_tp": {"moe_mode": "tp"},
            "seq_kv_time": {"seq_shard": True, "kv_time_shard": True}}
# spec leaves of each arch's train state (params, m, v, count, step)
TRAIN_STATE_LEAVES = {"whisper-large-v3": 83, "mixtral-8x7b": 41,
                      "phi3.5-moe-42b-a6.6b": 41, "qwen2-0.5b": 44,
                      "stablelm-12b": 38, "qwen2-1.5b": 44,
                      "qwen1.5-0.5b": 44, "hymba-1.5b": 71,
                      "llama-3.2-vision-11b": 80, "rwkv6-3b": 62}
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


@contextlib.contextmanager
def fake_world(size: int = 512, rank: int = 0):
    """A `fake` default process group (no communication) for the
    block."""
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def port_mesh_of(shape, names):
    return DeviceMesh("cpu", torch.arange(math.prod(shape)).reshape(shape),
                      mesh_dim_names=names)


def flat_specs(tree, prefix=""):
    """{path: tuple of entries} of a spec tree of either package."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat_specs(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tuple(tree)}


def both_rules(mesh_name, **switches):
    shape, names = MESHES[mesh_name]
    kw = {k: switches[k] for k in ("moe_mode", "seq_shard", "kv_time_shard")
          if k in switches}
    return (rules.ShardingRules(port_mesh_of(shape, names), **kw),
            jrules.ShardingRules(AbstractMesh(shape, names), **kw))


@pytest.mark.parametrize("switch", sorted(SWITCHES))
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_spec_trees_match_reference_leaf_by_leaf(mesh_name, switch):
    switches = SWITCHES[switch]
    with fake_world():
        ours, ref = both_rules(mesh_name, **switches)
        for arch, cfg in ARCHS.items():
            jcfg = JARCHS[arch]
            rc = RunConfig(model=cfg, shape=SHAPES[0], **switches)
            jrc = JRunConfig(model=jcfg, shape=JSHAPES[0], **switches)
            got = flat_specs(step.train_state_specs(cfg, rc, ours))
            want = flat_specs(jstep.train_state_specs(jcfg, jrc, ref))
            assert got == want, arch
            assert len(got) == TRAIN_STATE_LEAVES[arch]
            for shp, jshp in zip(SHAPES, JSHAPES):
                assert shp.name == jshp.name
                assert (flat_specs(step.batch_specs(cfg, shp, ours))
                        == flat_specs(jstep.batch_specs(jcfg, jshp, ref))), \
                    (arch, shp.name)
                if shp.kind == "decode":
                    assert (flat_specs(step.decode_state_specs(
                        cfg, rc, ours, shp)) == flat_specs(
                        jstep.decode_state_specs(jcfg, jrc, ref, jshp))), \
                        (arch, shp.name)
            # activations: "seq" is the one uneven-exempt name
            for B, S, d in ((256, 4096, cfg.d_model), (1, 4097, 7)):
                act = ("batch", "seq", None)
                assert tuple(ours.spec(act, (B, S, d))) == tuple(
                    ref.spec(act, (B, S, d)))
        assert ours.model_axis_size() == ref.model_axis_size()
        assert rules.batch_axes(ours.mesh) == jrules.batch_axes(
            AbstractMesh(*MESHES[mesh_name]))


# the reference's own checks (tests/test_sharding.py:34-56) on a (4, 2)
# mesh with kv_time_shard, each beside the reference's answer
RULE_CASES = {
    "batch_divides": ("spec", ("batch", None), (8, 5), P("data", None)),
    "batch_uneven": ("spec", ("batch", None), (3, 5), P(None, None)),
    "ffn_divides": ("spec", (None, "ffn"), (3, 6), P(None, "model")),
    "ffn_uneven": ("spec", (None, "ffn"), (3, 7), P(None, None)),
    "first_mapping_wins": ("spec",
                           ("layers", "batch", "cache_time", "kv_heads",
                            None),
                           (2, 8, 64, 2, 16),
                           P(None, "data", "model", None, None)),
    "zero1_first_free_dim": ("zero1", P(None, "model"), (8, 6),
                             P("data", "model")),
    "zero1_no_duplicate": ("zero1", P("data", None), (8, 6),
                           P("data", None)),
    "zero1_skips_uneven": ("zero1", P(None, "model"), (5, 6),
                           P(None, "model")),
}


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_rule_cases_of_the_reference(case):
    kind, arg, shape, want = RULE_CASES[case]
    with fake_world():
        ours, ref = both_rules("4x2", kv_time_shard=True)
        if kind == "spec":
            got, theirs = ours.spec(arg, shape), ref.spec(arg, shape)
        else:
            got = rules.zero1_shard(arg, shape, ours.mesh)
            theirs = jrules.zero1_shard(JP(*arg), shape, ref.mesh)
        assert got == want
        assert tuple(got) == tuple(theirs)


def test_pod_data_split_is_jax_block_order():
    """A dim split over ("pod", "data") becomes two mesh dims that both
    shard it: each rank's DTensor shard is the block JAX gives the device
    at that rank's mesh position (major-to-minor), rank by rank."""
    shape, names = (2, 2, 2), ("pod", "data", "model")
    glob = (8, 4, 8)
    specs = [P(("pod", "data"), "model", None), P(None, ("pod", "data")),
             P("model", None, ("pod", "data"))]
    script = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
mesh = Mesh(np.array(jax.devices()).reshape(2, 2, 2), ("pod", "data", "model"))
out = []
for spec in json.loads(sys.argv[1]):
    spec = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
    idx = NamedSharding(mesh, spec).devices_indices_map((8, 4, 8))
    pos = {d: [int(i) for i in np.argwhere(mesh.devices == d)[0]]
           for d in mesh.devices.flat}
    out.append({json.dumps(pos[d]): [[s.start or 0, s.stop or n]
                for s, n in zip(sl, (8, 4, 8))] for d, sl in idx.items()})
print(json.dumps(out))
"""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", script,
                          json.dumps([list(s) for s in specs])], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    jax_blocks = json.loads(res.stdout.strip().splitlines()[-1])
    x = torch.arange(math.prod(glob)).reshape(glob)
    for rank in range(8):
        with fake_world(8, rank):
            mesh = port_mesh_of(shape, names)
            coord = json.dumps(list(mesh.get_coordinate()))
            for spec, blocks in zip(specs, jax_blocks):
                local = distribute_tensor(
                    x, mesh, rules.placements(spec, mesh),
                    src_data_rank=None).to_local()
                want = x[tuple(slice(a, b) for a, b in blocks[coord])]
                assert torch.equal(local, want), (rank, spec)


def test_placements_and_named_sharding():
    with fake_world():
        mesh = port_mesh_of(*MESHES["2x16x16"])
        r = rules.ShardingRules(mesh)
        ns = r.named(("batch", None, "heads"), (64, 3, 32))
        assert ns.spec == P(("pod", "data"), None, "model")
        assert [str(p) for p in ns.placements] == ["S(0)", "S(0)", "S(2)"]
        assert [str(p) for p in rules.placements(P(), mesh)] == ["R"] * 3
        with pytest.raises(ValueError, match="axis order"):
            rules.placements(P(("data", "pod")), mesh)
        tree = rules.logical_to_physical(
            r, {"a": ("batch", None), "b": {"c": (None, "ffn")}},
            {"a": (2, 3), "b": {"c": (4, 32)}})
        assert tree == {"a": P(None, None), "b": {"c": P(None, "model")}}


def test_make_mesh_needs_a_process_group_of_its_size():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        port_mesh.make_mesh((2, 2), ("data", "model"), device_type="cpu")
    with fake_world(8):
        with pytest.raises(RuntimeError, match="needs 4 ranks"):
            port_mesh.make_mesh((2, 2), ("data", "model"),
                                device_type="cpu")
        if not torch.cuda.is_available():   # no silent host mesh
            with pytest.raises(RuntimeError, match="CUDA"):
                port_mesh.make_mesh((4, 2), ("data", "model"))
        m = port_mesh.make_mesh((4, 2), ("data", "model"), device_type="cpu")
        assert m.mesh_dim_names == ("data", "model")
        assert tuple(m.shape) == (4, 2)
    with fake_world(512):
        m = port_mesh.make_production_mesh(multi_pod=True, device_type="cpu")
        assert tuple(m.shape) == (2, 16, 16)
    assert not dist.is_initialized()


def _shapes_dtypes(tree, prefix=""):
    """{path: (shape, dtype name)} of a tree of meta tensors or of
    `jax.ShapeDtypeStruct`s."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_shapes_dtypes(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: (tuple(tree.shape),
                          str(tree.dtype).replace("torch.", ""))}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_abstract_state_and_batch_specs_match_reference(arch):
    """`abstract_train_state` (meta tensors) and `make_batch_specs` give
    the reference's shapes and dtypes (its `jax.eval_shape` and
    `ShapeDtypeStruct`s) at full size, for every shape."""
    cfg, jcfg = ARCHS[arch], JARCHS[arch]
    rc = RunConfig(model=cfg, shape=SHAPES[0])
    jrc = JRunConfig(model=jcfg, shape=JSHAPES[0])
    got = step.abstract_train_state(cfg, rc)
    assert {x.device.type for x in jax.tree.leaves(
        got, is_leaf=lambda x: isinstance(x, torch.Tensor))} == {"meta"}
    assert _shapes_dtypes(got) == _shapes_dtypes(
        jstep.abstract_train_state(jcfg, jrc))
    for shp, jshp in zip(SHAPES, JSHAPES):
        assert _shapes_dtypes(make_batch_specs(cfg, shp, torch.bfloat16)) \
            == _shapes_dtypes(jmake_batch_specs(jcfg, jshp, jnp.bfloat16))


def test_mesh_lower_half_holds_the_dense_family_only():
    """`LowerHalf.build(mesh=...)` places the dense decoder by its spec
    tree and raises, naming the ROADMAP item, for a family not held on
    a mesh yet."""
    with fake_world():
        mesh = port_mesh_of(*MESHES["4x2"])
        cfg = ARCHS["qwen2-0.5b"]
        lower = LowerHalf.build(cfg, RunConfig(model=cfg, shape=SHAPES[0]),
                                mesh=mesh)
        try:
            assert lower.mesh is mesh and lower.rules.mesh is mesh
            assert lower.state_specs["opt"]["m"]["embed"]["embedding"] \
                == P("model", "data")
        finally:
            lower.comm.close()
        for arch in ("mixtral-8x7b", "hymba-1.5b", "rwkv6-3b",
                     "whisper-large-v3", "llama-3.2-vision-11b"):
            cfg = ARCHS[arch]
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                LowerHalf.build(cfg, RunConfig(model=cfg, shape=SHAPES[0]),
                                mesh=mesh)
