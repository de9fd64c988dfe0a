"""Serving in bfloat16 on a mesh that splits heads over "model": how far
the prefill logits move from the same params' mesh-free prefill, in the
port (2 gloo CPU ranks, tests/_mesh_ranks.py `prefill_dtypes`) and in
the reference (its jit-compiled prefill on 2 forced host devices, in a
subprocess), each package against itself.

Reduced qwen2-0.5b's serving cell (heads and vocabulary padded to 2,
8 prompts of 112 tokens, `kv_time_shard`) on (1 data x 2 model): every
product that sums over the heads (the output projection, the K/V
projections' input gradients) leaves a partial sum on each rank, and
the reduction adds the two in the compute dtype.  In float32 both
packages move the logits by rounding only (port 7.8e-7, reference
2.9e-6 of their norm); in bfloat16 both move them ~1.7% (port 1.69%,
reference 1.75%): the reference's XLA
program reduces the partial sums in bfloat16 as DTensor does, so the
port keeps its reduction and holds model-split serving meshes in
float32 (tests/test_torch_mesh_serve.py), as the reference holds its
meshes to each other only on losses.
"""
import json
import os
import subprocess
import sys

import pytest

import _mesh_ranks  # tests/ is on the path (conftest.py)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

# the reference's prefill of the same cell (its own init, key 0; the
# prompts from numpy seed 7) on a (data, model) mesh of forced host
# devices against its mesh-free prefill: {dtype: norm-relative
# difference of the last-token logits}
JREF = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import ARCHS, reduced_config
from repro.configs.base import RunConfig, ShapeConfig
from repro.models import transformer as T
from repro.sharding.rules import ShardingRules
from repro.training.step import (batch_specs, make_serve_steps,
                                 train_state_specs)

B, S, data, model = (int(a) for a in sys.argv[1:5])
cfg = reduced_config(ARCHS["qwen2-0.5b"], pad_to=2)
mesh = Mesh(np.array(jax.devices()[:data * model]).reshape(data, model),
            ("data", "model"))
rules = ShardingRules(mesh, kv_time_shard=True)
named = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                               is_leaf=lambda x: isinstance(x, P))
params, _ = T.init_params(cfg, jax.random.PRNGKey(0))
rng = np.random.RandomState(7)
batch = {"tokens": jnp.asarray(rng.randint(0, cfg.vocab_size, (B, S))
                               .astype(np.int32))}
out = {}
for dt in ("float32", "bfloat16"):
    rc = RunConfig(model=cfg, shape=ShapeConfig("serve", S, B, "prefill"),
                   kv_time_shard=True, dtype=dt)
    free = jax.jit(make_serve_steps(cfg, rc, None)[0])(params, batch)[0]
    step = jax.jit(make_serve_steps(cfg, rc, rules)[0], in_shardings=(
        named(train_state_specs(cfg, rc, rules)["params"]),
        named(batch_specs(cfg, rc.shape, rules))))
    with mesh:
        got = step(params, batch)[0]
    a, b = np.asarray(got, np.float64), np.asarray(free, np.float64)
    out[dt] = float(np.linalg.norm(a - b) / np.linalg.norm(b))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def moved(tmp_path_factory):
    """{"port": ..., "reference": ...}, each {dtype: movement} on (1 x 2)."""
    port = _mesh_ranks.world("prefill_dtypes", 2,
                             tmp_path_factory.mktemp("bf16"), "1x2",
                             timeout=300)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    res = subprocess.run([sys.executable, "-c", JREF,
                          str(_mesh_ranks.SERVE_BATCH),
                          str(_mesh_ranks.SERVE_S), "1", "2"], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    ref = json.loads(res.stdout.strip().splitlines()[-1])
    print(f"prefill logits moved by a (1 x 2) mesh: port {port}, "
          f"reference {ref}")
    return {"port": port, "reference": ref}


@pytest.mark.parametrize("package", ["port", "reference"])
def test_float32_moves_by_rounding_only(moved, package):
    assert moved[package]["float32"] < 1e-4


def test_bfloat16_moves_the_port_as_much_as_the_reference(moved):
    """Both packages reduce the head-split partial sums in bfloat16: each
    moves by far more than its float32 rounding, and the port by the
    reference's own amount to within a factor of 2."""
    port, ref = moved["port"]["bfloat16"], moved["reference"]["bfloat16"]
    assert port > 100 * moved["port"]["float32"]
    assert ref > 100 * moved["reference"]["float32"]
    assert 0.5 < port / ref < 2.0
