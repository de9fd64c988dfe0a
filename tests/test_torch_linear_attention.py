"""The port's chunked linear-attention engine and Mamba-2-style SSM head
against the JAX package: `repro_torch.models.linear_attention` against
`repro.models.linear_attention` in both modes (mamba, rwkv) at the
reference test's (S, chunk) grid, with gradients of the output and the
final state; the single-token step continuing a chunked prefill; chunk
invariance; and `repro_torch.models.mamba` (init tree, `mamba_apply`
with its gradients, `mamba_decode_step`) against `repro.models.mamba`,
with the JAX init carried over by `state_from_numpy`.  Inputs are made
with numpy from a seed.

Tolerances (as tests/test_torch_model.py):
  * float32: rtol 1e-4 with an absolute floor of 1e-4 of the tensor's
    largest magnitude (the two stacks sum in other orders; the port
    batches the chunks where the reference scans them);
  * bfloat16 inputs: 2e-2 of the tensor's norm (8 bits of mantissa,
    rounded at other places in the two stacks);
  * chunk invariance within the port: the reference test's rtol 5e-3,
    atol 5e-3; a decode step against the chunked pass over the same
    tokens: the reference test's 2e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import linear_attention as jla
from repro.models import mamba as jmam
from repro_torch.convert import state_from_numpy
from repro_torch.models import linear_attention as la
from repro_torch.models import mamba as mam


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


def _inputs(rng, B, S, H, dk, dv, k_scale=0.3, lw_scale=1.0):
    q = rng.randn(B, S, H, dk).astype(np.float32)
    k = (rng.randn(B, S, H, dk) * k_scale).astype(np.float32)
    v = rng.randn(B, S, H, dv).astype(np.float32)
    lw = -np.abs(rng.randn(B, S, H, dk) * lw_scale).astype(np.float32)
    u = np.abs(rng.randn(H, dk)).astype(np.float32)
    return q, k, v, lw, u


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,chunk", [(32, 32), (64, 16), (48, 32), (8, 32)])
@pytest.mark.parametrize("mode", ["mamba", "rwkv"])
def test_chunked_matches_reference(mode, S, chunk, dtype):
    """Output and final state, and the gradients of both (against fixed
    random cotangents) with respect to q, k, v, lw (and u in rwkv)."""
    rng = np.random.RandomState(0)
    B, H, dk, dv = 2, 3, 8, 16
    q, k, v, lw, u = _inputs(rng, B, S, H, dk, dv)
    d_out = rng.randn(B, S, H, dv).astype(np.float32)
    d_state = rng.randn(B, H, dk, dv).astype(np.float32)
    ins = (q, k, v, lw) + ((u,) if mode == "rwkv" else ())

    def jfn(q, k, v, lw, u=None):
        return jla.chunked_linear_attention(q, k, v, lw, mode=mode, u=u,
                                            chunk=chunk)

    (jout, jstate), vjp = jax.vjp(jfn, *(_j(x, dtype) for x in ins))
    jgrads = vjp((_j(d_out, dtype), jnp.asarray(d_state)))

    leaves = [_t(x, dtype).requires_grad_(True) for x in ins]
    out, state = la.chunked_linear_attention(
        *leaves[:4], mode=mode, u=leaves[4] if mode == "rwkv" else None,
        chunk=chunk)
    assert out.dtype == getattr(torch, dtype)
    assert state.dtype == torch.float32
    grads = torch.autograd.grad((out, state), leaves,
                                (_t(d_out, dtype), torch.from_numpy(d_state)))
    _close(_np(out), _np(jout), dtype)
    _close(_np(state), _np(jstate), dtype)
    for name, g, jg in zip("qkvlu", grads, jgrads):
        assert g.dtype == getattr(torch, dtype), name
        _close(_np(g), _np(jg), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["mamba", "rwkv"])
def test_step_matches_reference(mode, dtype):
    """Three single-token steps from a nonzero state."""
    rng = np.random.RandomState(2)
    B, H, dk, dv = 2, 3, 8, 16
    state = rng.randn(B, H, dk, dv).astype(np.float32)
    u = np.abs(rng.randn(H, dk)).astype(np.float32)
    ts, js = torch.from_numpy(state), jnp.asarray(state)
    for _ in range(3):
        q, k, v, lw, _ = _inputs(rng, B, 1, H, dk, dv)
        args = [x[:, 0] for x in (q, k, v, lw)]
        out, ts = la.linear_attention_step(
            *(_t(a, dtype) for a in args), mode=mode,
            u=torch.from_numpy(u) if mode == "rwkv" else None, state=ts)
        jout, js = jla.linear_attention_step(
            *(_j(a, dtype) for a in args), mode=mode,
            u=jnp.asarray(u) if mode == "rwkv" else None, state=js)
        assert out.dtype == getattr(torch, dtype)
        assert ts.dtype == torch.float32
        _close(_np(out), _np(jout), dtype)
        _close(_np(ts), _np(js), dtype)


@pytest.mark.parametrize("mode", ["mamba", "rwkv"])
def test_decode_step_continues_chunked_state(mode):
    """A chunked prefill, then single-token steps, equals one chunked
    pass over all the tokens (the reference test's check, in the port)."""
    rng = np.random.RandomState(1)
    B, S, H, dk, dv, extra = 1, 32, 2, 4, 8, 4
    q, k, v, lw, u = _inputs(rng, B, S + extra, H, dk, dv)
    ut = torch.from_numpy(u) if mode == "rwkv" else None
    t = [torch.from_numpy(a) for a in (q, k, v, lw)]
    full, _ = la.chunked_linear_attention(*t, mode=mode, u=ut, chunk=8)
    _, state = la.chunked_linear_attention(*(a[:, :S] for a in t), mode=mode,
                                           u=ut, chunk=8)
    for i in range(S, S + extra):
        out, state = la.linear_attention_step(*(a[:, i] for a in t),
                                              mode=mode, u=ut, state=state)
        np.testing.assert_allclose(_np(out), _np(full[:, i]), rtol=2e-3,
                                   atol=2e-3)


@pytest.mark.parametrize("B,S,chunk,seed,mode", [
    (1, 16, 8, 0, "mamba"), (2, 24, 16, 1, "rwkv"), (3, 32, 8, 2, "mamba"),
    (2, 64, 32, 3, "rwkv"), (1, 64, 16, 4, "mamba"), (3, 24, 32, 5, "rwkv"),
])
def test_chunking_invariance(B, S, chunk, seed, mode):
    """The output does not depend on the chunk size (a chunk of S is
    capped at SAFE_CHUNK, so both sides chunk at most 32 wide)."""
    rng = np.random.RandomState(seed)
    q, k, v, lw, u = _inputs(rng, B, S, 2, 4, 4, k_scale=0.5, lw_scale=2.0)
    t = [torch.from_numpy(a) for a in (q, k, v, lw)]
    ut = torch.from_numpy(u) if mode == "rwkv" else None
    a, _ = la.chunked_linear_attention(*t, mode=mode, u=ut, chunk=chunk)
    b, _ = la.chunked_linear_attention(*t, mode=mode, u=ut, chunk=S)
    np.testing.assert_allclose(_np(a), _np(b), rtol=5e-3, atol=5e-3)


def test_initial_state_and_mode_checked():
    """state0 enters the first chunk as the reference's scan carry."""
    rng = np.random.RandomState(3)
    q, k, v, lw, _ = _inputs(rng, 2, 16, 2, 4, 8)
    s0 = rng.randn(2, 2, 4, 8).astype(np.float32)
    out, st = la.chunked_linear_attention(
        *(torch.from_numpy(a) for a in (q, k, v, lw)), mode="mamba",
        state0=torch.from_numpy(s0), chunk=4)
    jout, jst = jla.chunked_linear_attention(
        *(jnp.asarray(a) for a in (q, k, v, lw)), mode="mamba",
        state0=jnp.asarray(s0), chunk=4)
    _close(_np(out), _np(jout), "float32")
    _close(_np(st), _np(jst), "float32")
    with pytest.raises(ValueError, match="mode"):
        la.chunked_linear_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), torch.from_numpy(lw),
                                    mode="gla")


# ---------------------------------------------------------------------------
# the Mamba-2-style head
# ---------------------------------------------------------------------------

D_MODEL, SSM_STATE, EXPAND = 32, 8, 2


def _mamba_params(seed=0):
    p, logical = jmam.init_mamba(jax.random.PRNGKey(seed), D_MODEL, SSM_STATE,
                                 EXPAND)
    p = jax.tree.map(np.asarray, p)
    # nonzero conv bias and per-head constants so their paths are exercised
    rng = np.random.RandomState(seed + 10)
    p["conv_b"] = (rng.randn(*p["conv_b"].shape) * 0.1).astype(np.float32)
    for key in ("dt_bias", "A_log", "D"):
        p[key] = (p[key] + rng.randn(*p[key].shape) * 0.3).astype(np.float32)
    return p, logical


@pytest.mark.parametrize("stack", [0, 3])
def test_init_mamba_tree_matches_reference(stack):
    _, jlogical = jmam.init_mamba(jax.random.PRNGKey(0), D_MODEL, SSM_STATE,
                                  EXPAND)
    jp = jax.vmap(lambda key: jmam.init_mamba(key, D_MODEL, SSM_STATE,
                                              EXPAND)[0])(
        jax.random.split(jax.random.PRNGKey(0), stack or 1))
    gen = torch.Generator().manual_seed(0)
    ours, logical = mam.init_mamba(gen, D_MODEL, SSM_STATE, EXPAND,
                                   device="cpu", stack=stack)
    assert logical == jlogical
    assert sorted(ours) == sorted(jp)
    for key, t in ours.items():
        want = jp[key].shape if stack else jp[key].shape[1:]
        assert tuple(t.shape) == want and t.dtype == torch.float32, key
    for key in ("conv_b", "dt_bias", "A_log", "D"):
        np.testing.assert_array_equal(
            ours[key].numpy(), np.broadcast_to(np.asarray(jp[key])[0],
                                               ours[key].shape))
    assert mam.mamba_heads(EXPAND * D_MODEL) == jmam.mamba_heads(
        EXPAND * D_MODEL) == 16
    assert mam.mamba_heads(100) == jmam.mamba_heads(100) == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_apply_matches_reference(dtype):
    """Output, final SSM state, conv tail, and the gradients of the
    output with respect to the input and every parameter (S 48 with
    chunk 32: the engine takes chunks of 24)."""
    p, _ = _mamba_params()
    rng = np.random.RandomState(5)
    x = rng.randn(2, 48, D_MODEL).astype(np.float32)
    d_out = rng.randn(2, 48, D_MODEL).astype(np.float32)

    def jfn(p, x):
        return jmam.mamba_apply(p, x, chunk=32)

    (jout, jstate, jtail), vjp = jax.vjp(
        jfn, jax.tree.map(jnp.asarray, p), _j(x, dtype))
    jgp, jgx = vjp((_j(d_out, dtype), jnp.zeros_like(jstate),
                    jnp.zeros_like(jtail)))

    tp = state_from_numpy(p, "cpu")
    keys = sorted(tp)
    leaves = [tp[key].requires_grad_(True) for key in keys]
    tx = _t(x, dtype).requires_grad_(True)
    out, state, tail = mam.mamba_apply(dict(zip(keys, leaves)), tx, chunk=32)
    assert state.dtype == torch.float32 and tail.dtype == tx.dtype
    assert tuple(state.shape) == (2, 16, SSM_STATE, EXPAND * D_MODEL // 16)
    _close(_np(out), _np(jout), dtype)
    _close(_np(state), _np(jstate), dtype)
    _close(_np(tail), _np(jtail), dtype)
    grads = torch.autograd.grad(out, leaves + [tx], _t(d_out, dtype))
    for key, g in zip(keys, grads):
        _close(_np(g), _np(jgp[key]), dtype)
    _close(_np(grads[-1]), _np(jgx), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_decode_step_matches_reference(dtype):
    """A prefill's SSM state and conv tail, then four decode steps, each
    against the reference; the given states are left as they were."""
    p, _ = _mamba_params(seed=1)
    rng = np.random.RandomState(6)
    x = rng.randn(2, 36, D_MODEL).astype(np.float32)
    jp, tp = jax.tree.map(jnp.asarray, p), state_from_numpy(p, "cpu")
    _, js, jc = jmam.mamba_apply(jp, _j(x[:, :32], dtype))
    _, ts, tc = mam.mamba_apply(tp, _t(x[:, :32], dtype))
    for i in range(32, 36):
        before = (tc.clone(), ts.clone())
        out, tc2, ts2 = mam.mamba_decode_step(tp, _t(x[:, i:i + 1], dtype),
                                              tc, ts)
        assert torch.equal(tc, before[0]) and torch.equal(ts, before[1])
        tc, ts = tc2, ts2
        jout, jc, js = jmam.mamba_decode_step(jp, _j(x[:, i:i + 1], dtype),
                                              jc, js)
        assert ts.dtype == torch.float32 and tc.dtype == getattr(torch, dtype)
        _close(_np(out), _np(jout), dtype)
        _close(_np(ts), _np(js), dtype)
        _close(_np(tc), _np(jc), dtype)
