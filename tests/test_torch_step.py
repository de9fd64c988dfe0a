"""One train step of the port against the JAX package from the same
state (reduced qwen2-0.5b, Mixtral and hymba, float32 compute): params,
AdamW moments, lr and grad norm agree; step and opt/count are exact
int32.

Tolerance: rtol 1e-4 with an absolute floor of 1e-4 of each leaf's
largest magnitude for params and moments (their gradients agree to
that, see tests/test_torch_model.py; the first AdamW step divides m by
sqrt(v), so a gradient element near zero moves its update by up to
lr * 1e-4 in relative terms), rtol 1e-5 for lr, the loss and the MoE
aux loss, and for the dense grad_norm.  The MoE step's grad_norm is held
to 1e-4, the tolerance its gradients meet: every gradient leaf of the
reduced Mixtral sits about 2e-5 in norm from the reference's (f32
summation order through the SWA blocks and the expert dispatch), and
the norm with them.  One
leaf is exempt: the gradient of the key bias `bk` is zero in exact
arithmetic (it shifts every score of a query by the same amount, which
the softmax cancels), so its AdamW update divides rounding noise by
rounding noise in both stacks; it is held to |bk| <= 3 lr after two
steps instead.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import ARCHS as JARCHS, reduced_config as jreduced
from repro.configs.base import RunConfig as JRunConfig, ShapeConfig as JShape
from repro.optim import adamw as jadamw
from repro.training.step import init_train_state as jinit
from repro.training.step import make_train_step as jmake
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.data.pipeline import SyntheticDataset
from repro_torch.optim import adamw
from repro_torch.training.step import (abstract_params, init_train_state,
                                       make_train_step)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], np.asarray(tree)


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=1e-4,
                               atol=1e-4 * float(np.abs(b).max()) + 1e-12)


def test_train_step_matches_reference():
    _step_parity("qwen2-0.5b", 32, norm_rtol=1e-5)


def test_moe_train_step_matches_reference():
    """Reduced Mixtral: 64 tokens over a window of 32, so the
    sliding-window path, the expert dispatch and the aux loss are in the
    step."""
    _step_parity("mixtral-8x7b", 64, norm_rtol=1e-4)


def test_hybrid_train_step_matches_reference():
    """Reduced hymba: 64 tokens over a window of 32 (the sliding-window
    path) beside the SSM heads, whose (L, 16) constants `A_log`, `D` and
    `dt_bias` get AdamW updates too."""
    _step_parity("hymba-1.5b", 64, norm_rtol=1e-4)


def test_apply_updates_releases_each_gradient():
    """Gradients given as a flat list (as the train step gives them) are
    consumed: every gradient held only there is released by the time the
    update returns.  A gradient tree is left as it was.  Both give the
    same result."""
    import weakref

    gen = torch.Generator().manual_seed(3)
    params = {"a": torch.randn(4, 5, generator=gen),
              "b": {"c": torch.randn(7, generator=gen)}}
    grads = [torch.randn(4, 5, generator=gen), torch.randn(7, generator=gen)]
    kept = {"a": grads[0].clone(), "b": {"c": grads[1].clone()}}
    refs = [weakref.ref(g) for g in grads]
    opt = adamw.init_opt_state(params)
    lr = torch.tensor(1e-2)
    got = adamw.apply_updates(params, grads, opt, lr=lr)
    want = adamw.apply_updates(params, kept, opt, lr=lr)
    assert grads == [None, None]
    assert all(r() is None for r in refs)
    assert set(kept) == {"a", "b"} and set(kept["b"]) == {"c"}
    for a, b in zip(_leaves_t({"p": got[0], "o": got[1]}),
                    _leaves_t({"p": want[0], "o": want[1]})):
        assert a[0] == b[0] and torch.equal(a[1], b[1])


def _step_parity(arch, seq, norm_rtol):
    jcfg = jreduced(JARCHS[arch])
    cfg = reduced_config(ARCHS[arch])
    jrc = JRunConfig(model=jcfg, shape=JShape("s", seq, 2, "train"),
                     loss_chunk=16, attn_chunk=8, dtype="float32")
    rc = RunConfig(model=cfg, shape=ShapeConfig("s", seq, 2, "train"),
                   loss_chunk=16, attn_chunk=8, dtype="float32")
    # a state one step in, so the moments and count are nonzero
    jstate = jinit(jcfg, jrc, jax.random.PRNGKey(0))
    jstep = jax.jit(jmake(jcfg, jrc, None))
    ds = SyntheticDataset(cfg, rc.shape, seed=2)
    jstate, _ = jstep(jstate, {k: jnp.asarray(v)
                               for k, v in ds.get_batch(0).items()})
    start = jax.tree.map(np.asarray, jstate)

    batch = ds.get_batch(1)
    jnew, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state = state_from_numpy(start, "cpu")
    new, m = make_train_step(cfg, rc)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})

    for key in ("loss", "lr", "moe_aux"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=norm_rtol)
    ours = dict(_leaves(state_to_numpy(new)))
    theirs = dict(_leaves(jax.tree.map(np.asarray, jnew)))
    assert sorted(ours) == sorted(theirs)
    for path, want in theirs.items():
        got = ours[path]
        assert got.dtype == want.dtype, path
        if path in ("step", "opt/count"):
            assert got.dtype == np.int32 and got.shape == ()
            assert int(got) == int(want) == 2
        elif path == "params/blocks/attn/bk":
            assert np.abs(got).max() <= 3 * float(jm["lr"])
        else:
            _close(got, want)
    # the step is functional: the input state is left as it was
    for path, want in _leaves(start):
        np.testing.assert_array_equal(dict(_leaves(state_to_numpy(state)))[path],
                                      want)


def test_lr_schedule_matches_reference():
    for s in (0, 1, 99, 100, 101, 5000, 9999, 20000):
        got = float(adamw.lr_schedule(torch.tensor(s, dtype=torch.int32), 3e-4))
        want = float(jadamw.lr_schedule(jnp.asarray(s, jnp.int32), 3e-4))
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_state_layout():
    cfg = reduced_config(ARCHS["qwen2-0.5b"])
    rc = RunConfig(model=cfg, shape=ShapeConfig("s", 32, 2, "train"))
    gen = torch.Generator()
    gen.manual_seed(0)
    state = init_train_state(cfg, rc, gen, "cpu")
    assert state["step"].dtype == torch.int32 and state["step"].dim() == 0
    assert state["opt"]["count"].dtype == torch.int32
    assert sorted(state["opt"]) == ["count", "m", "v"]
    shapes, _ = abstract_params(cfg)
    assert all(t.device.type == "meta" for _, t in _leaves_t(shapes))
    for (p, a), (q, b) in zip(_leaves_t(shapes), _leaves_t(state["params"])):
        assert p == q and a.shape == b.shape and b.dtype == torch.float32


def _leaves_t(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_t(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree
