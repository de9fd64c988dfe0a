"""The port's dry-run (`repro_torch.launch.dryrun`), its op analysis
(`repro_torch.launch.hlo_analysis`) and the perf module's roofline
(`repro_torch.launch.perf.analyze_cell`), against the reference's.

The reference counts dot FLOPs in the partitioned HLO of its compiled
step (`repro.launch.hlo_analysis.analyze_hlo`), per device; the port
counts the local ops of one eager step (`OpCounter`).  For reduced
qwen2-0.5b at B 4 x S 128 the two agree:
  * within 0.1% under remat "none" and "dots": the same products, but
    for the reference's pick of each target logit by a one-hot product
    (2 x tokens x vocabulary = 2^18 FLOPs here; the port gathers);
  * within 3% under "full": `torch.utils.checkpoint` recomputes every
    product of a block, 62.9 M FLOPs a layer here, where XLA's
    recompute drops the products whose outputs the backward does not
    read (54.5 M);
  * within 5% under "comm", below the port's own "full" count (the
    saved block outputs are not recomputed);
and the port's "dots" count equals its "none" count: no product runs
twice.  On fake meshes every count is the rank's own: (4 x 1) is
exactly a quarter of the mesh-free count, and (2 x 2) within 5% of the
reference's per-device count, compiled in a subprocess for 4 host
devices.  The production meshes (256 and 512 ranks) run in a
subprocess (`slow`, as the reference's own cell test)."""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import reduced_config as jreduced
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeConfig as JShape
from repro.data.pipeline import make_batch_specs as jbatch_specs
from repro.launch.hlo_analysis import analyze_hlo
from repro.training.step import abstract_train_state as jstate
from repro.training.step import make_train_step as jstep
from repro_torch.configs import ARCHS, SHAPES_BY_NAME, reduced_config
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.hlo_analysis import analyze_step
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.perf import analyze_cell

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
B, S = 4, 128
POLICIES = ("none", "dots", "full", "comm")
# port / reference, per policy (see the module docstring)
BOUND = {"none": 1e-3, "dots": 1e-3, "full": 3e-2, "comm": 5e-2}

_PORT, _REF = {}, {}


def _cfgs(layers: int):
    return (dataclasses.replace(reduced_config(ARCHS["qwen2-0.5b"]),
                                n_layers=layers),
            dataclasses.replace(jreduced(JARCHS["qwen2-0.5b"]),
                                n_layers=layers))


def _port(layers: int, policy: str, mesh_shape=None):
    """The port's per-device dot FLOPs (and the cell) of one train step,
    on a fake (data, model) mesh of `mesh_shape` or without a mesh."""
    key = (layers, policy, mesh_shape)
    if key not in _PORT:
        cfg, _ = _cfgs(layers)
        shape = ShapeConfig("t", S, B, "train")
        rc = RunConfig(model=cfg, shape=shape, remat_policy=policy)
        if mesh_shape is None:
            _PORT[key] = dryrun.dry_run(cfg, shape, rc, None, "cpu")
        else:
            with dryrun.fake_world(mesh_shape[0] * mesh_shape[1]):
                mesh = make_mesh(mesh_shape, ("data", "model"),
                                 device_type="cpu")
                _PORT[key] = dryrun.dry_run(cfg, shape, rc, mesh)
    return _PORT[key]


def _ref(layers: int, policy: str) -> float:
    """The reference's dot FLOPs of its jit-compiled train step on one
    device (`analyze_hlo`)."""
    key = (layers, policy)
    if key not in _REF:
        _, jcfg = _cfgs(layers)
        shape = JShape("t", S, B, "train")
        jrc = JRunConfig(model=jcfg, shape=shape, remat_policy=policy)
        compiled = jax.jit(jstep(jcfg, jrc, None)).lower(
            jstate(jcfg, jrc), jbatch_specs(jcfg, shape, jnp.bfloat16)
        ).compile()
        _REF[key] = analyze_hlo(compiled.as_text())["dot_flops"]
    return _REF[key]


def test_layer_stack_counts_every_layer():
    """The counterpart of the reference's trip-count test: a 12-layer
    stack of tanh(c @ w_l), run eagerly, counts every layer's product."""
    c = torch.randn(8, 16)
    w = torch.randn(12, 16, 16)

    def stack(c, w):
        for layer in w:
            c = torch.tanh(c @ layer)
        return c

    got = analyze_step(stack, c, w)
    assert got["dot_flops"] == 12 * 2 * 8 * 16 * 16
    assert got["collective_count"] == 0
    assert got["fusion_io_bytes"] > 0


def test_peak_bytes_is_the_live_set():
    """peak_bytes against the figure by hand: y and z (N floats each) are
    alive together, then y is released before the sum."""
    n = 1000
    x = torch.randn(n)

    def f(x):
        y = x * 2
        z = y + 1
        del y
        return z.sum()

    assert analyze_step(f, x)["peak_bytes"] == 2 * 4 * n


@pytest.mark.parametrize("layers", [2, 4])
@pytest.mark.parametrize("policy", POLICIES)
def test_dot_flops_match_reference(layers, policy):
    ours = _port(layers, policy)["hlo"]["dot_flops"]
    theirs = _ref(layers, policy)
    print(f"{policy} L{layers}: port {ours}, reference {theirs}, "
          f"ratio {ours / theirs:.5f}")
    assert abs(ours / theirs - 1) < BOUND[policy]


@pytest.mark.parametrize("layers", [2, 4])
def test_dots_recomputes_no_product_and_comm_less_than_full(layers):
    count = {p: _port(layers, p)["hlo"]["dot_flops"] for p in POLICIES}
    assert count["dots"] == count["none"]
    assert count["none"] < count["comm"] < count["full"]


def test_data_mesh_counts_a_quarter_per_device():
    free = _port(2, "full")["hlo"]["dot_flops"]
    assert _port(2, "full", (4, 1))["hlo"]["dot_flops"] * 4 == free


JREF_MESH = r"""
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import ARCHS, reduced_config
from repro.configs.base import RunConfig, ShapeConfig
from repro.data.pipeline import make_batch_specs
from repro.launch.hlo_analysis import analyze_hlo
from repro.sharding.rules import ShardingRules
from repro.training.step import (abstract_train_state, batch_specs,
                                 make_train_step, train_state_specs)

layers, B, S = (int(a) for a in sys.argv[1:4])
cfg = dataclasses.replace(reduced_config(ARCHS["qwen2-0.5b"]),
                          n_layers=layers)
shape = ShapeConfig("t", S, B, "train")
rc = RunConfig(model=cfg, shape=shape)
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
rules = ShardingRules(mesh, moe_mode=rc.moe_mode)
named = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                               is_leaf=lambda x: isinstance(x, P))
state = named(train_state_specs(cfg, rc, rules))
fn = jax.jit(make_train_step(cfg, rc, rules),
             in_shardings=(state, named(batch_specs(cfg, shape, rules))),
             out_shardings=(state, None))
with mesh:
    c = fn.lower(abstract_train_state(cfg, rc),
                 make_batch_specs(cfg, shape, jnp.bfloat16)).compile()
print(json.dumps(analyze_hlo(c.as_text())["dot_flops"]))
"""


def test_model_split_mesh_matches_reference_per_device():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = subprocess.run([sys.executable, "-c", JREF_MESH, "2", str(B),
                          str(S)], env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    theirs = json.loads(out.stdout.strip().splitlines()[-1])
    ours = _port(2, "full", (2, 2))["hlo"]["dot_flops"]
    print(f"(2 x 2) per device: port {ours}, reference {theirs}, "
          f"ratio {ours / theirs:.5f}")
    assert abs(ours / theirs - 1) < 0.05


def test_collectives_only_where_the_mesh_splits():
    one = _port(2, "full", (1, 1))["collectives"]
    assert one["total"] == 0 and one["count"] == 0
    four = _port(2, "full", (2, 2))["collectives"]
    assert four["total"] > 0 and four["count"] > 0
    assert set(four) == set(dryrun.COLLECTIVE_OPS) | {"count", "total"}


# the reference's per-device dot FLOPs and temp bytes of its train step
# (remat "full") on a (data, model) mesh of 4 forced host devices, for
# each cell of a JSON list of {"mesh": [data, model], "cfg": overrides
# of reduced qwen2-0.5b, "fsdp": bool}
JREF_CELLS = r"""
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import ARCHS, reduced_config
from repro.configs.base import RunConfig, ShapeConfig
from repro.data.pipeline import make_batch_specs
from repro.launch.hlo_analysis import analyze_hlo
from repro.sharding.rules import ShardingRules
from repro.training.step import (abstract_train_state, batch_specs,
                                 make_train_step, train_state_specs)

B, S = int(sys.argv[2]), int(sys.argv[3])
out = []
for cell in json.loads(sys.argv[1]):
    data, model = cell["mesh"]
    cfg = dataclasses.replace(reduced_config(ARCHS["qwen2-0.5b"]),
                              **cell["cfg"])
    shape = ShapeConfig("t", S, B, "train")
    rc = RunConfig(model=cfg, shape=shape, fsdp=cell["fsdp"])
    mesh = Mesh(np.array(jax.devices()[:data * model]).reshape(data, model),
                ("data", "model"))
    rules = ShardingRules(mesh, moe_mode=rc.moe_mode)
    named = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                                   is_leaf=lambda x: isinstance(x, P))
    state = named(train_state_specs(cfg, rc, rules))
    fn = jax.jit(make_train_step(cfg, rc, rules),
                 in_shardings=(state, named(batch_specs(cfg, shape, rules))),
                 out_shardings=(state, None))
    with mesh:
        c = fn.lower(abstract_train_state(cfg, rc),
                     make_batch_specs(cfg, shape, jnp.bfloat16)).compile()
    out.append(analyze_hlo(c.as_text())["dot_flops"])
print(json.dumps(out))
"""

# (mesh, reduced qwen2-0.5b overrides, fsdp) of the cells held to the
# reference: FSDP on (2 x 2), its data axis on the layer dim (2 layers)
# and on d (3); the query heads split finer than K: (1 x 4) with H 4 and
# K 2 (each rank one head of one group), and (1 x 2) with H 6 and K 3
# (each rank's 3 heads straddle two groups)
SPLIT_CELLS = {"fsdp_layers": ((2, 2), {"n_layers": 2}, True),
               "fsdp_d": ((2, 2), {"n_layers": 3}, True),
               "heads_k2": ((1, 4), {"n_layers": 2}, False),
               "heads_straddle": ((1, 2), {"n_layers": 2, "n_heads": 6,
                                           "n_kv_heads": 3}, False)}
_SPLIT_REF = {}


def _split_ref(name: str) -> float:
    """The reference's per-device dot FLOPs of a `SPLIT_CELLS` cell, all
    compiled in one subprocess with 4 forced host devices."""
    if not _SPLIT_REF:
        cells = [{"mesh": m, "cfg": c, "fsdp": f}
                 for m, c, f in SPLIT_CELLS.values()]
        env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
        out = subprocess.run([sys.executable, "-c", JREF_CELLS,
                              json.dumps(cells), str(B), str(S)], env=env,
                             capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-3000:]
        got = json.loads(out.stdout.strip().splitlines()[-1])
        _SPLIT_REF.update(zip(SPLIT_CELLS, got))
    return _SPLIT_REF[name]


def _port_cell(mesh_shape, over, fsdp):
    """The port's dry-run of reduced qwen2-0.5b (with `over`), remat
    "full", on a fake (data, model) mesh of `mesh_shape`."""
    key = (mesh_shape, tuple(sorted(over.items())), fsdp)
    if key not in _PORT:
        cfg = dataclasses.replace(reduced_config(ARCHS["qwen2-0.5b"]),
                                  **over)
        shape = ShapeConfig("t", S, B, "train")
        rc = RunConfig(model=cfg, shape=shape, fsdp=fsdp)
        with dryrun.fake_world(mesh_shape[0] * mesh_shape[1]):
            mesh = make_mesh(mesh_shape, ("data", "model"),
                             device_type="cpu")
            _PORT[key] = dryrun.dry_run(cfg, shape, rc, mesh)
    return _PORT[key]


@pytest.mark.parametrize("name", ["fsdp_layers", "fsdp_d", "heads_k2"])
def test_split_mesh_matches_reference_per_device(name):
    """FSDP gathers each layer at its use and the query heads split over
    "model" where K does not divide it: per-device dot FLOPs within 5%
    of the reference's (remat "full": 1.025 without a mesh, as above)."""
    ours = _port_cell(*SPLIT_CELLS[name])["hlo"]["dot_flops"]
    theirs = _split_ref(name)
    print(f"{name} per device: port {ours}, reference {theirs}, "
          f"ratio {ours / theirs:.5f}")
    assert abs(ours / theirs - 1) < 0.05


@pytest.mark.parametrize("layers", [2, 3])
def test_fsdp_holds_less_than_no_fsdp(layers):
    """The FSDP cell's per-device peak (arguments and the step's live
    set) is below the same cell's without FSDP, at the same dot FLOPs
    (its all-gathers: each layer's weights at their use, where ZeRO-1
    gathers the updated params)."""
    mesh, over, _ = SPLIT_CELLS["fsdp_layers" if layers == 2 else "fsdp_d"]
    on, off = (_port_cell(mesh, over, f) for f in (True, False))
    assert on["memory"]["peak_bytes"] < off["memory"]["peak_bytes"]
    assert on["memory"]["argument_bytes"] < off["memory"]["argument_bytes"]
    assert on["hlo"]["dot_flops"] == off["hlo"]["dot_flops"]
    assert on["collectives"]["all-gather"] > 0


def test_straddling_heads_do_only_their_share():
    """(1 x 2) with H 6 and K 3: each rank's 3 query heads straddle two
    KV groups.  The reference's partitioner runs every head's attention
    on both ranks there (its score products are (B, 3, c, 2 x c) per
    device, all 6 heads); the port attends only each rank's own heads,
    so its per-device count is below the reference's and below its own
    count with the heads whole, and one attention call on the mesh
    counts exactly half of the same call without one."""
    mesh, over, fsdp = SPLIT_CELLS["heads_straddle"]
    ours = _port_cell(mesh, over, fsdp)["hlo"]["dot_flops"]
    theirs = _split_ref("heads_straddle")
    print(f"straddling heads per device: port {ours}, reference {theirs}, "
          f"ratio {ours / theirs:.5f}")
    assert ours < theirs

    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models import attention as A

    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(B, S, h, 16, generator=gen).to(torch.bfloat16)
               for h in (6, 3, 3))
    free = analyze_step(A.flash_attention, q, k, v, causal=True, chunk=32)
    with dryrun.fake_world(2):
        m = make_mesh((1, 2), ("data", "model"), device_type="cpu")
        args = (distribute_tensor(q, m, [Replicate(), Shard(2)]),
                *(distribute_tensor(x, m, [Replicate(), Replicate()])
                  for x in (k, v)))
        split = analyze_step(A.flash_attention, *args, causal=True,
                             chunk=32)
    assert split["dot_flops"] * 2 == free["dot_flops"]


JREF_RC = r"""
import json
from repro.configs import ARCHS, SHAPES_BY_NAME
from repro.launch.dryrun import production_rc
print(json.dumps({f"{a}|{s}": production_rc(ARCHS[a], SHAPES_BY_NAME[s])
                  for a in ARCHS for s in SHAPES_BY_NAME}))
"""


def test_production_rc_matches_reference():
    """In a subprocess: importing the reference's dry-run sets its
    process's XLA_FLAGS."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", JREF_RC], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    theirs = json.loads(out.stdout.strip().splitlines()[-1])
    # the reference's archs (granite has none there)
    ours = {f"{a}|{s}": dryrun.production_rc(ARCHS[a], SHAPES_BY_NAME[s])
            for a in JARCHS for s in SHAPES_BY_NAME}
    assert ours == theirs


def test_run_cell_skips_what_the_reference_skips():
    cell = dryrun.run_cell("qwen2-0.5b", "long_500k", False,
                           device_type="cpu")
    assert cell["status"] == "skip" and cell["mesh"] == "16x16"
    assert "524k" in cell["reason"]


def test_analyze_cell_on_a_hand_made_cell():
    cell = {"status": "ok", "arch": "qwen2-0.5b", "shape": "train_4k",
            "mesh": "16x16", "params_active": 1e9,
            "hlo": {"dot_flops": 989e12, "fusion_io_bytes": 6.7e12,
                    "collective_bytes": 0.0, "collective_count": 3},
            "memory": {"peak_bytes": 81e9}}
    out = analyze_cell(cell)
    assert out["compute_s"] == pytest.approx(1.0)
    assert out["memory_s"] == pytest.approx(2.0)
    assert out["dominant"] == "memory"
    assert out["model_flops"] == pytest.approx(6 * 1e9 * 256 * 4096 / 256)
    assert out["roofline_fraction"] == pytest.approx(
        out["model_flops"] / 989e12 / 2.0)
    assert out["fits_hbm"] is False and out["collective_count"] == 3
    assert analyze_cell(dict(cell, status="skip")) is None


CELL = r"""
import json
from repro_torch.launch.dryrun import run_cell
cell = run_cell("qwen1.5-0.5b", "decode_32k", multi_pod=True,
                device_type="cpu")
cell.pop("trace", None)
print(json.dumps(cell))
"""


@pytest.mark.slow
def test_one_cell_on_multipod_mesh():
    """The twin of the reference's `test_one_cell_on_multipod_mesh`: one
    real cell on the 512-rank production mesh, in a subprocess."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", CELL], env=env,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    cell = json.loads(out.stdout.strip().splitlines()[-1])
    assert cell["status"] == "ok", cell
    assert cell["mesh"] == "2x16x16"
    assert cell["hlo"]["dot_flops"] > 0
    assert cell["memory"]["peak_bytes"] is not None
