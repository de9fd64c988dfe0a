"""The port's RWKV-6 blocks against the JAX package:
`repro_torch.models.rwkv` against `repro.models.rwkv` (the init tree,
`rwkv_time_mix` with its gradients, `rwkv_channel_mix` with its
gradients, the single-token steps continuing a chunked pass) and
`repro_torch.models.layers.head_rms_norm` against
`repro.models.layers.head_rms_norm`, unpadded (4 heads of 8) and with a
padded head masked (5 heads of 8 stored as 6, as rwkv6-3b's 40 heads are
stored as 48).  Parameters are the JAX init with its constants (`mu`,
`w0`, `u`, `mu_ck`, `mu_cr`) perturbed so that each one's path is
exercised, carried over by `state_from_numpy`; inputs are made with
numpy from a seed.

Tolerances (as tests/test_torch_linear_attention.py):
  * float32: rtol 1e-4 with an absolute floor of 1e-4 of the tensor's
    largest magnitude (the two stacks sum in other orders; the port
    batches the chunks where the reference scans them);
  * bfloat16 inputs: 2e-2 of the tensor's norm (8 bits of mantissa,
    rounded at other places in the two stacks);
  * a step against the port's own chunked pass over the same tokens
    (float32): the reference test's 2e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jL
from repro.models import rwkv as jrwkv
from repro_torch.convert import state_from_numpy
from repro_torch.models import layers as L
from repro_torch.models import rwkv

D_MODEL, HEAD_DIM, D_FF = 32, 8, 64
# (stored heads, mask): unpadded, and 5 real heads stored as 6
HEADS = {"unpadded": (4, None), "padded": (6, [1, 1, 1, 1, 1, 0])}


def _close(got, want, dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()))
    else:
        err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert err < 2e-2, err


def _j(x, dtype):
    return jnp.asarray(x, dtype=getattr(jnp, dtype))


def _t(x, dtype):
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        getattr(torch, dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _time_mix_params(n_heads, seed=0):
    p, _ = jrwkv.init_rwkv_time_mix(jax.random.PRNGKey(seed), D_MODEL,
                                    n_heads, HEAD_DIM)
    p = jax.tree.map(np.asarray, p)
    rng = np.random.RandomState(seed + 10)
    p["mu"] = rng.uniform(0, 1, p["mu"].shape).astype(np.float32)
    for key in ("w0", "u"):
        p[key] = (p[key] + rng.randn(*p[key].shape) * 0.3).astype(np.float32)
    return p


def _channel_mix_params(seed=0):
    p, _ = jrwkv.init_rwkv_channel_mix(jax.random.PRNGKey(seed), D_MODEL,
                                       D_FF)
    p = jax.tree.map(np.asarray, p)
    rng = np.random.RandomState(seed + 20)
    for key in ("mu_ck", "mu_cr"):
        p[key] = rng.uniform(0, 1, p[key].shape).astype(np.float32)
    return p


def _masks(heads):
    _, mask = HEADS[heads]
    if mask is None:
        return None, None
    m = np.asarray(mask, np.float32)
    return jnp.asarray(m), torch.from_numpy(m)


@pytest.mark.parametrize("stack", [0, 3])
def test_init_tree_matches_reference(stack):
    """Names, shapes, dtypes and logical axes of both blocks; the
    constants' values; `wB` drawn at a tenth of the dense scale."""
    H = 6
    keys = jax.random.split(jax.random.PRNGKey(0), stack or 1)
    gen = torch.Generator().manual_seed(0)
    for jinit, init, args in (
            (jrwkv.init_rwkv_time_mix, rwkv.init_rwkv_time_mix,
             (D_MODEL, H, HEAD_DIM)),
            (jrwkv.init_rwkv_channel_mix, rwkv.init_rwkv_channel_mix,
             (D_MODEL, D_FF))):
        _, jlogical = jinit(keys[0], *args)
        jp = jax.vmap(lambda k: jinit(k, *args)[0])(keys)
        ours, logical = init(gen, *args, device="cpu", stack=stack)
        assert logical == jlogical
        assert sorted(ours) == sorted(jp)
        for key, t in ours.items():
            want = jp[key].shape if stack else jp[key].shape[1:]
            assert tuple(t.shape) == want, key
            assert t.dtype == torch.float32 and jp[key].dtype == jnp.float32
        for key in ("mu", "w0", "u", "mu_ck", "mu_cr"):
            if key in ours:
                np.testing.assert_array_equal(
                    ours[key].numpy(), np.broadcast_to(np.asarray(jp[key])[0],
                                                       ours[key].shape))
        if "wB" in ours:
            ratio = float(ours["wB"].std()) / float(np.asarray(jp["wB"]).std())
            assert 0.8 < ratio < 1.25, ratio
            # fan-in on the reference's axis -2 of (64, H, hd): the heads
            assert abs(float(ours["wB"].std()) * np.sqrt(H) - 0.1) < 0.02
    assert rwkv.DECAY_LORA == jrwkv.DECAY_LORA
    meta, _ = rwkv.init_rwkv_time_mix(None, D_MODEL, H, HEAD_DIM,
                                      device="meta", stack=2)
    assert meta["wB"].device.type == "meta"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_rms_norm_matches_reference(dtype):
    x = np.random.RandomState(3).randn(2, 5, 6, HEAD_DIM).astype(np.float32)
    got = L.head_rms_norm(_t(x, dtype))
    assert got.dtype == getattr(torch, dtype)
    _close(_np(got), _np(jL.head_rms_norm(_j(x, dtype))), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", sorted(HEADS))
def test_time_mix_matches_reference(heads, dtype):
    """Output, final la-state and shift-state, and the gradients of the
    output and the la-state (against fixed random cotangents) with
    respect to the input and every parameter (S 48 with chunk 32: the
    engine takes chunks of 24).  Padded: the masked head's output is
    zero and its parameters get zero gradient in both packages, while
    its la-state is carried as the reference carries it."""
    H, _ = HEADS[heads]
    jmask, tmask = _masks(heads)
    p = _time_mix_params(H)
    rng = np.random.RandomState(5)
    B, S = 2, 48
    x = rng.randn(B, S, D_MODEL).astype(np.float32)
    d_out = rng.randn(B, S, D_MODEL).astype(np.float32)
    d_state = rng.randn(B, H, HEAD_DIM, HEAD_DIM).astype(np.float32)

    def jfn(p, x):
        return jrwkv.rwkv_time_mix(p, x, chunk=32, mask=jmask)

    (jout, jstate, jshift), vjp = jax.vjp(
        jfn, jax.tree.map(jnp.asarray, p), _j(x, dtype))
    jgp, jgx = vjp((_j(d_out, dtype), jnp.asarray(d_state),
                    jnp.zeros_like(jshift)))

    tp = state_from_numpy(p, "cpu")
    keys = sorted(tp)
    leaves = [tp[k].requires_grad_(True) for k in keys]
    tx = _t(x, dtype).requires_grad_(True)
    out, state, shift = rwkv.rwkv_time_mix(dict(zip(keys, leaves)), tx,
                                           chunk=32, mask=tmask)
    assert out.dtype == tx.dtype and shift.dtype == tx.dtype
    assert state.dtype == torch.float32
    assert tuple(state.shape) == (B, H, HEAD_DIM, HEAD_DIM)
    _close(_np(out), _np(jout), dtype)
    _close(_np(state), _np(jstate), dtype)
    np.testing.assert_array_equal(_np(shift), _np(jshift))
    grads = torch.autograd.grad((out, state), leaves + [tx],
                                (_t(d_out, dtype), torch.from_numpy(d_state)))
    for key, g in zip(keys, grads):
        assert g.dtype == torch.float32, key
        _close(_np(g), _np(jgp[key]), dtype)
    _close(_np(grads[-1]), _np(jgx), dtype)
    if tmask is not None:
        assert np.abs(_np(state)[:, -1]).max() > 0
        g = dict(zip(keys, grads))
        assert not _np(g["wo"])[-1].any() and not _np(g["wg"])[:, -1].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_channel_mix_matches_reference(dtype):
    """Output and shift-state, and the gradients of the output with
    respect to the input and every parameter."""
    p = _channel_mix_params()
    rng = np.random.RandomState(6)
    x = rng.randn(2, 24, D_MODEL).astype(np.float32)
    d_out = rng.randn(2, 24, D_MODEL).astype(np.float32)
    (jout, jshift), vjp = jax.vjp(jrwkv.rwkv_channel_mix,
                                  jax.tree.map(jnp.asarray, p), _j(x, dtype))
    jgp, jgx = vjp((_j(d_out, dtype), jnp.zeros_like(jshift)))
    tp = state_from_numpy(p, "cpu")
    keys = sorted(tp)
    leaves = [tp[k].requires_grad_(True) for k in keys]
    tx = _t(x, dtype).requires_grad_(True)
    out, shift = rwkv.rwkv_channel_mix(dict(zip(keys, leaves)), tx)
    assert out.dtype == tx.dtype
    _close(_np(out), _np(jout), dtype)
    np.testing.assert_array_equal(_np(shift), _np(jshift))
    grads = torch.autograd.grad(out, leaves + [tx], _t(d_out, dtype))
    for key, g in zip(keys, grads):
        _close(_np(g), _np(jgp[key]), dtype)
    _close(_np(grads[-1]), _np(jgx), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", sorted(HEADS))
def test_steps_continue_a_chunked_pass(heads, dtype):
    """A chunked pass over 32 tokens, then four single-token steps of the
    time-mix and the channel-mix from its states: each step against the
    reference's step from the reference's states; in float32 also
    against the port's own chunked pass over all 36 tokens.  The given
    states are left as they were."""
    H, _ = HEADS[heads]
    jmask, tmask = _masks(heads)
    tm, cm = _time_mix_params(H, seed=1), _channel_mix_params(seed=1)
    jtm, jcm = (jax.tree.map(jnp.asarray, p) for p in (tm, cm))
    ttm, tcm = state_from_numpy(tm, "cpu"), state_from_numpy(cm, "cpu")
    x = np.random.RandomState(7).randn(2, 36, D_MODEL).astype(np.float32)
    tx, jx = _t(x, dtype), _j(x, dtype)
    _, ts, ta = rwkv.rwkv_time_mix(ttm, tx[:, :32], chunk=8, mask=tmask)
    _, tc = rwkv.rwkv_channel_mix(tcm, tx[:, :32])
    _, js, ja = jrwkv.rwkv_time_mix(jtm, jx[:, :32], chunk=8, mask=jmask)
    _, jc = jrwkv.rwkv_channel_mix(jcm, jx[:, :32])
    full_tm, _, _ = rwkv.rwkv_time_mix(ttm, tx, chunk=8, mask=tmask)
    full_cm, _ = rwkv.rwkv_channel_mix(tcm, tx)
    for i in range(32, 36):
        before = [t.clone() for t in (ts, ta, tc)]
        out, ts2, ta2 = rwkv.rwkv_time_mix_step(ttm, tx[:, i:i + 1], ts, ta,
                                                mask=tmask)
        cout, tc2 = rwkv.rwkv_channel_mix_step(tcm, tx[:, i:i + 1], tc)
        for a, b in zip((ts, ta, tc), before):
            assert torch.equal(a, b)
        ts, ta, tc = ts2, ta2, tc2
        jout, js, ja = jrwkv.rwkv_time_mix_step(jtm, jx[:, i:i + 1], js, ja,
                                                mask=jmask)
        jcout, jc = jrwkv.rwkv_channel_mix_step(jcm, jx[:, i:i + 1], jc)
        assert ts.dtype == torch.float32 and out.dtype == tx.dtype
        _close(_np(out), _np(jout), dtype)
        _close(_np(ts), _np(js), dtype)
        _close(_np(cout), _np(jcout), dtype)
        np.testing.assert_array_equal(_np(ta), _np(ja))
        np.testing.assert_array_equal(_np(tc), _np(jc))
        if dtype == "float32":
            np.testing.assert_allclose(_np(out), _np(full_tm[:, i:i + 1]),
                                       rtol=2e-3, atol=2e-3)
            np.testing.assert_allclose(_np(cout), _np(full_cm[:, i:i + 1]),
                                       rtol=2e-3, atol=2e-3)
