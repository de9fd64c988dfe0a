"""The port's remat policies (`repro_torch.models.remat`) against the
reference's (`repro.models.transformer._remat`): "full" saves a block's
inputs, "dots" every matrix product's output, "comm" the named block
outputs "attn_out", "mixer_out" and "mlp_out".

For reduced qwen2-0.5b (dense), Mixtral-8x7B (MoE, sliding window
over 64 tokens), hymba-1.5b (hybrid SSM) and rwkv6-3b (which names no
block output): the gradients are the same bits under "full", "dots"
and "comm" (only what is kept and what is recomputed differs), and
under "dots" and "comm" they agree with the reference's under the same
policy at tests/test_torch_model.py's float32 rule (rtol 1e-4, with an
absolute floor of 1e-4 of the tensor's largest magnitude).  Under
"dots" no product runs twice: the port's dot FLOPs equal its "none"
count.  The dry-run's live-set peaks order none >= dots >= comm >=
full.  On a (2 x 2) gloo mesh (4 CPU rank processes,
tests/_mesh_ranks.py) "comm" gives "full"'s bits, and the mesh-free
float32 gradients to rtol 1e-4."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import reduced_config as jreduced
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeConfig as JShape
from repro.models import transformer as jT
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.convert import state_from_numpy
from repro_torch.data.pipeline import SyntheticDataset
from repro_torch.launch.dryrun import dry_run
from repro_torch.launch.hlo_analysis import analyze_step
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves

import _mesh_ranks  # tests/ is on the path (conftest.py)

FAMILIES = ["qwen2-0.5b", "mixtral-8x7b", "hymba-1.5b", "rwkv6-3b"]
S, B = 64, 2
KW = dict(loss_chunk=32, attn_chunk=16, dtype="float32")


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """(jax cfg, port cfg, numpy params from the JAX init, numpy batch)."""
    arch = request.param
    jcfg = jreduced(JARCHS[arch])
    cfg = reduced_config(ARCHS[arch])
    params, _ = jT.init_params(jcfg, jax.random.PRNGKey(5))
    params = jax.tree.map(np.asarray, params)
    batch = SyntheticDataset(cfg, ShapeConfig("t", S, B, "train"),
                             seed=2).get_batch(0)
    return jcfg, cfg, params, batch


def _rc(cfg, policy):
    return RunConfig(model=cfg, shape=ShapeConfig("t", S, B, "train"),
                     remat_policy=policy, **KW)


def _port(family, policy):
    """(loss, gradients) of the port's loss under `policy`."""
    _, cfg, params, batch = family
    tparams = state_from_numpy(params, "cpu")
    leaves = [p.requires_grad_(True) for p in tree_leaves(tparams)]
    loss, _ = T.forward_loss(tparams, cfg, _rc(cfg, policy), None,
                             {k: torch.from_numpy(v) for k, v in
                              batch.items()})
    return loss.detach(), torch.autograd.grad(loss, leaves)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))


def test_full_dots_and_comm_give_the_same_bits(family):
    loss, grads = _port(family, "full")
    for policy in ("dots", "comm"):
        other, theirs = _port(family, policy)
        assert torch.equal(loss, other), policy
        assert all(torch.equal(a, b) for a, b in zip(grads, theirs)), policy


@pytest.mark.parametrize("policy", ["dots", "comm"])
def test_gradients_match_reference_under_the_same_policy(family, policy):
    jcfg, _, params, batch = family
    run = JRunConfig(model=jcfg, shape=JShape("t", S, B, "train"),
                     remat_policy=policy, **KW)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jT.forward_loss(p, jcfg, run, None, jbatch),
        has_aux=True))(jax.tree.map(jnp.asarray, params))
    loss, grads = _port(family, policy)
    _close(loss.numpy(), np.asarray(jloss))
    want = jax.tree.leaves(jgrads)
    assert len(want) == len(grads)
    for g, w in zip(grads, want):
        _close(g.numpy(), np.asarray(w, np.float32))


def _step_flops(family, policy):
    _, cfg, params, batch = family
    tparams = state_from_numpy(params, "cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}

    def step():
        leaves = [p.requires_grad_(True) for p in tree_leaves(tparams)]
        loss, _ = T.forward_loss(tparams, cfg, _rc(cfg, policy), None,
                                 tbatch)
        torch.autograd.grad(loss, leaves)

    return analyze_step(step)["dot_flops"]


def test_dots_recomputes_no_product(family):
    none = _step_flops(family, "none")
    assert _step_flops(family, "dots") == none
    assert _step_flops(family, "full") > none


def test_dry_run_peaks_order_the_policies(family):
    """At B 4 x S 128, where the activations outweigh the update's
    copies of the state (at B 2 x S 64 the update's peak is every
    policy's)."""
    _, cfg, _, _ = family
    shape = ShapeConfig("t", 128, 4, "train")
    peak = {p: dry_run(cfg, shape, RunConfig(
        model=cfg, shape=shape, remat_policy=p, **KW), None, "cpu")[
            "memory"]["peak_bytes"] for p in ("none", "dots", "comm", "full")}
    print(cfg.arch_id, peak)
    assert peak["none"] >= peak["dots"] >= peak["comm"] >= peak["full"]
    assert peak["none"] > peak["full"]


def test_comm_on_a_mesh(tmp_path):
    got = _mesh_ranks.world("remat_on_mesh", 4, tmp_path, "2x2", timeout=600)
    assert got["loss_equal"] and got["grads_equal"], got
    assert got["max_rel"] < 1e-4, got
