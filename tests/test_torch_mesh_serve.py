"""The port's serving path on a `DeviceMesh`, every family: prefill,
greedy decode and decode-state images of reduced qwen2-0.5b, Mixtral
(`ep` and `tp`), hymba-1.5b, rwkv6-3b, whisper-large-v3 and
llama-3.2-vision-11b, in one world of 4 gloo CPU rank processes
(tests/_mesh_ranks.py `serve_on_mesh`, spawned by a subprocess with its
own time limit).

`make_serve_steps(cfg, rc, rules)` takes the params placed by
`train_state_specs(...)["params"]`, the prompt batch by `batch_specs`
and each token by ("batch", None), and returns its decode state placed
by `decode_state_specs`, as the reference's `run_cell` places them for
its prefill and decode cells.  Reduced configs with heads and vocabulary
padded to 2, B 8 prompts of 112 tokens (SWA families: two windows, 64),
16 greedy tokens.  Meshes: (2 data x 2 model) with `kv_time_shard`
(the cache's time axis over "model", the reference's production choice
for serving), (2 x 2) without it (KV heads over "model"), (4 x 1); all
three in float32 compute, and (4 x 1) in bfloat16 too.  Where "model"
splits heads, DTensor sums the partial products in the compute dtype:
in bfloat16 that moves reduced qwen2-0.5b's prefill logits by 1.7% of
their norm (float32: 1e-6) and changes greedy tokens, so the mesh runs
are held to the mesh-free ones in float32, and in bfloat16 only where
no dim is split over "model".

  * On every mesh the tokens equal the mesh-free run's and the logits
    agree with it to 5e-3 of their norm at every step (the reference's
    cross-topology rtol, tests/test_elastic.py).
  * After the prefill and after every step each decode-state leaf is a
    DTensor placed by `decode_state_specs`.
  * On the time-sharded (2 x 2) mesh a full image at token 6 and an
    XOR-delta image at token 10: restored onto the same mesh it decodes
    tokens 11-15 again bit for bit; restored without a mesh it equals
    the gathered live state bit for bit; restored onto (4 x 1) it gives
    the same tokens, logits to 5e-3.
  * `attention.write_slot_` into a time-sharded cache equals the plain
    write at every slot and through an SWA ring's wrap (DTensor's own
    slice write there lands in the wrong place and raises nothing).
  * Images cross the packages: the reference's image of its mesh-free
    decode state (dense and whisper, whose cross K/V are time-sharded
    too) restores onto the time-sharded (2 x 2) port mesh with its
    digests verified and continues the reference's decode to the
    float32 tolerance of tests/test_torch_serve.py; every family's mesh
    image restores in the reference, digests verified, bit-equal to the
    port's own mesh-free restore.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import ARCHS as JARCHS
from repro.configs import reduced_config as jreduced
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeConfig as JShape
from repro.core.checkpoint import CheckpointManager as JManager
from repro.models import transformer as jT
from repro.training.step import make_serve_steps as jmake_serve_steps
from repro_torch.convert import state_to_numpy
from repro_torch.core.checkpoint import CheckpointManager
from repro_torch.models import transformer as T
from repro_torch.sharding.rules import ShardingRules
from repro_torch.training.step import decode_state_specs

import _mesh_ranks  # tests/ is on the path (conftest.py)

# rtol between mesh factorizations: the reference's own bound
MESH_RTOL = 5e-3
ARCHS = ("qwen2-0.5b", "mixtral-8x7b:ep", "mixtral-8x7b:tp", "hymba-1.5b",
         "rwkv6-3b", "whisper-large-v3", "llama-3.2-vision-11b")
# the reference's images restored onto a port mesh
CROSS = ("qwen2-0.5b", "whisper-large-v3")
MESHES = tuple(m[0] for m in _mesh_ranks.SERVE_MESHES)
FIRST = MESHES[0]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _sub(d, arch):
    return d / arch.replace(":", "-")


def _reference_image(d, arch):
    """The reference's mesh-free serving of `arch`'s cell from the
    port's params and inputs (float32): prefill and 10 greedy decode
    steps, an image of {"decode": state} at step 10 in `d`/ref, then 5
    more greedy steps, whose input tokens go to `d`/ref_tokens.npy.
    Returns those 5 steps' (B, V) logits."""
    cfg, rc = _mesh_ranks.serve_config(arch)
    params, batch = _mesh_ranks.serve_inputs(cfg, rc)
    jcfg = jreduced(JARCHS[arch], pad_to=2)
    jrc = JRunConfig(model=jcfg, shape=JShape(
        "serve", rc.shape.seq_len, rc.shape.global_batch, "prefill"),
        loss_chunk=32, attn_chunk=16, dtype="float32")
    jprefill, jserve = (jax.jit(f) for f in jmake_serve_steps(jcfg, jrc,
                                                              None))
    jparams = jax.tree.map(jnp.asarray, state_to_numpy(params))
    logits, st = jprefill(jparams, {k: jnp.asarray(v.numpy())
                                    for k, v in batch.items()})
    tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    for _ in range(_mesh_ranks.SNAP_DELTA):
        logits, st = jserve(jparams, st, tok)
        tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    JManager(str(d / "ref")).save(_mesh_ranks.SNAP_DELTA, {"decode": st},
                                  {"decode": jT.decode_state_logical(jcfg)})
    fed, outs = [], []
    for _ in range(5):
        fed.append(np.asarray(tok))
        logits, st = jserve(jparams, st, tok)
        outs.append(np.asarray(logits[:, -1], np.float32))
        tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    np.save(d / "ref_tokens.npy", np.stack(fed))
    return np.stack(outs)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The reference's images (`CROSS`), then one world of 4 gloo ranks
    that runs `slot_write` and `serve_on_mesh` for every arch."""
    d = tmp_path_factory.mktemp("serve4")
    ref = {}
    for arch in CROSS:
        _sub(d, arch).mkdir()
        ref[arch] = _reference_image(_sub(d, arch), arch)
    out = _mesh_ranks.world("slot_write,serve_on_mesh", 4, d, "2x2",
                            timeout=900, archs=",".join(ARCHS))
    out["dir"], out["ref"] = d, ref
    return out


def _serve(world, arch):
    return world[f"serve_on_mesh@{arch}"]


@pytest.mark.parametrize("case", ["full", "ring"])
def test_slot_write_on_a_time_sharded_cache_equals_the_plain_write(world,
                                                                   case):
    got = world["slot_write"][case]
    assert len(got) == (8 if case == "full" else 11)
    assert all(got), got


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_serving_gives_the_mesh_free_tokens(world, arch, mesh):
    got = _serve(world, arch)[mesh]
    assert got["tokens_equal"]
    assert len(got["vs_free"]["rel"]) == _mesh_ranks.SERVE_STEPS + 1
    assert max(got["vs_free"]["rel"]) < MESH_RTOL, got["vs_free"]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_state_is_placed_by_the_specs(world, arch):
    """Every leaf after the prefill, every step and each restore is a
    DTensor placed by `decode_state_specs`; under `kv_time_shard` the
    caches' time axis (and whisper's frames axis of its cross K/V) is
    over "model" and their KV heads are whole."""
    got = _serve(world, arch)
    for mesh in MESHES:
        assert got[mesh]["n_misplaced"] == 0, got[mesh]["misplaced"]
    for mesh in (FIRST, _mesh_ranks.RESTORE_ON):
        assert got[mesh]["restored_misplaced"] == []
    cfg, rc = _mesh_ranks.serve_config(arch)
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(2, 2))
    specs = decode_state_specs(cfg, rc, ShardingRules(
        mesh, kv_time_shard=True), rc.shape)["layers"]
    logical = T.decode_state_logical(cfg)["layers"]
    timed = [k for k, lg in logical.items() if "cache_time" in lg]
    for key in timed:
        lg = logical[key]
        assert specs[key][lg.index("cache_time")] == "model", key
        assert specs[key][lg.index("kv_heads")] is None, key
    assert bool(timed) != bool(cfg.rwkv)


@pytest.mark.parametrize("arch", ARCHS)
def test_same_mesh_restore_continues_bit_for_bit(world, arch):
    got = _serve(world, arch)[FIRST]
    assert got["image_bytes"][0] == got["image_bytes"][1] > 0
    assert len(got["same_mesh"]["rel"]) == 5
    assert got["same_mesh"]["equal"], got["same_mesh"]


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_free_restore_equals_the_gathered_state(world, arch):
    got = _serve(world, arch)[FIRST]["no_mesh_equal"]
    assert "pos" in got and len(got) >= 3
    assert all(got.values()), got


@pytest.mark.parametrize("arch", ARCHS)
def test_restore_onto_another_mesh_continues(world, arch):
    got = _serve(world, arch)[_mesh_ranks.RESTORE_ON]["from_first_image"]
    assert got["tokens_equal"]
    assert len(got["rel"]) == 5 and max(got["rel"]) < MESH_RTOL, got


@pytest.mark.parametrize("arch", CROSS)
def test_reference_image_restores_onto_a_port_mesh(world, arch):
    d = _sub(world["dir"], arch)
    got = _serve(world, arch)[FIRST]["from_reference"]
    assert got["misplaced"] == []
    state, _ = JManager(str(d / "ref")).restore(_mesh_ranks.SNAP_DELTA)
    want = {p: np.asarray(a) for p, a in _flat(state["decode"]).items()}
    assert sorted(got["digests"]) == sorted(want)
    for p, a in want.items():
        assert got["digests"][p] == _mesh_ranks._digest(a), p
    ours = np.load(d / "from_reference.npy")
    theirs = world["ref"][arch]
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, rtol=1e-4,
                               atol=1e-4 * float(np.abs(theirs).max()))


@pytest.mark.parametrize("arch", ARCHS)
def test_port_mesh_image_restores_in_the_reference(world, arch):
    d = str(_sub(world["dir"], arch) / "img")
    step = _mesh_ranks.SNAP_DELTA
    theirs, _ = JManager(d, verify=True).restore(step)
    ours, _ = CheckpointManager(d, device="cpu").restore(step)
    ours = {p: t.numpy() for p, t in _flat(ours).items()}
    theirs = {p: np.asarray(a) for p, a in _flat(theirs).items()}
    assert sorted(ours) == sorted(theirs)
    for p, a in theirs.items():
        assert a.dtype == ours[p].dtype and np.array_equal(a, ours[p]), p
