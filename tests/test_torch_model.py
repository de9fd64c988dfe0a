"""The port's dense model (layers, GQA flash attention, loss, gradients)
against the JAX package at reduced qwen2-0.5b, unpadded and with
`pad_to=16` (padded heads masked).  Both packages get the same inputs
and the same parameters: the JAX init, carried over with
`repro_torch.convert.state_from_numpy`.

Tolerances:
  * float32 compute (`RunConfig(dtype="float32")`): rtol 1e-4, with an
    absolute floor of 1e-4 of the tensor's largest magnitude — the two
    stacks sum in different orders (and the reference's flash attention
    rescales per key block), so elements that are sums of cancelling
    terms agree to the scale of the tensor, not to their own size;
  * bfloat16 compute (the default): 2e-2 of the tensor's norm for
    activations and the loss — bf16 keeps 8 bits of mantissa and the
    stacks round at different places.  Gradients in bf16 are held to the
    reference's own accuracy instead: at this size (random init, nonzero
    QKV biases) either stack's bf16 gradients sit 20-27% in norm from the
    f32 gradients, and so from each other; the port's distance from the
    f32 gradient must stay within 1.25x the reference's, plus 1e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced_config as jreduced
from repro.configs.base import RunConfig as JRunConfig, ShapeConfig as JShape
from repro.models import attention as jattn
from repro.models import layers as jL
from repro.models import transformer as jT
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.data.pipeline import SyntheticDataset
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves

SEQ, BATCH = 32, 2


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _close(got, want, dtype, bf16_tol=2e-2):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()))
    else:
        err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert err < bf16_tol, err


def _j(x, dtype):
    return jnp.asarray(x, dtype=getattr(jnp, dtype))


def _t(x, dtype):
    return torch.from_numpy(np.asarray(x, np.float32)).to(getattr(torch, dtype))


def _jnp(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tnp(x):
    return x.detach().to(torch.float32).numpy()


@pytest.fixture(scope="module", params=[1, 16], ids=["unpadded", "pad16"])
def model(request):
    """(jax cfg, port cfg, numpy params) for reduced qwen2-0.5b."""
    jcfg = jreduced(JARCHS["qwen2-0.5b"], pad_to=request.param)
    cfg = reduced_config(ARCHS["qwen2-0.5b"], pad_to=request.param)
    params, _ = jT.init_params(jcfg, jax.random.PRNGKey(3))
    # nonzero biases so the bias path is exercised
    rng = np.random.RandomState(4)
    params = jax.tree.map(lambda x: np.asarray(x), params)
    for k in ("bq", "bk", "bv"):
        params["blocks"]["attn"][k] = (
            rng.randn(*params["blocks"]["attn"][k].shape) * 0.1
        ).astype(np.float32)
    return jcfg, cfg, params


def test_param_tree_matches_reference(model):
    jcfg, cfg, params = model
    ours, logical = T.init_params(cfg, None, "meta")
    _, jlogical = jT.init_params(jcfg, jax.random.PRNGKey(0))
    flat_j = {p: (a.shape, str(a.dtype)) for p, a in _paths(params)}
    flat_t = {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
              for p, t in _paths(ours)}
    assert flat_t == flat_j
    assert logical == jlogical
    assert cfg.n_heads_padded == jcfg.n_heads_padded


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_match_reference(model, dtype):
    jcfg, cfg, params = model
    rng = np.random.RandomState(5)
    d, hd = cfg.d_model, cfg.head_dim
    x = rng.randn(BATCH, SEQ, d).astype(np.float32)
    scale = (1 + 0.1 * rng.randn(d)).astype(np.float32)
    _close(_tnp(L.rms_norm(_t(x, dtype), torch.from_numpy(scale))),
           _jnp(jL.rms_norm(_j(x, dtype), jnp.asarray(scale))), dtype)

    xr = rng.randn(BATCH, SEQ, 4, hd).astype(np.float32)
    pos = np.arange(SEQ, dtype=np.int32)
    _close(_tnp(L.apply_rope(_t(xr, dtype), torch.from_numpy(pos),
                             cfg.rope_theta)),
           _jnp(jL.apply_rope(_j(xr, dtype), jnp.asarray(pos),
                              jcfg.rope_theta)), dtype)

    mlp = {k: v[0] for k, v in params["blocks"]["mlp"].items()}
    _close(_tnp(L.mlp_apply(state_from_numpy(mlp, "cpu"), _t(x, dtype))),
           _jnp(jL.mlp_apply(jax.tree.map(jnp.asarray, mlp), _j(x, dtype))),
           dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_reference(model, dtype):
    jcfg, cfg, _ = model
    rng = np.random.RandomState(6)
    H, K, hd = cfg.n_heads_padded, cfg.n_kv_heads_padded, cfg.head_dim
    q = rng.randn(BATCH, SEQ, H, hd).astype(np.float32)
    k = rng.randn(BATCH, SEQ, K, hd).astype(np.float32)
    v = rng.randn(BATCH, SEQ, K, hd).astype(np.float32)
    got = attn.flash_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                               causal=True, chunk=8)
    want = jattn.flash_attention(_j(q, dtype), _j(k, dtype), _j(v, dtype),
                                 causal=True, chunk=8)
    _close(_tnp(got), _jnp(want), dtype)
    np.testing.assert_array_equal(_tnp(attn.head_mask(cfg)),
                                  np.asarray(jattn.head_mask(jcfg)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_xent_matches_reference(model, dtype):
    jcfg, cfg, _ = model
    rng = np.random.RandomState(7)
    h = rng.randn(BATCH, SEQ, cfg.d_model).astype(np.float32)
    head = (rng.randn(cfg.d_model, cfg.vocab_padded) * 0.1).astype(np.float32)
    labels = rng.randint(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    mask = (rng.rand(BATCH, SEQ) > 0.2).astype(np.float32)
    tot, cnt = L.chunked_softmax_xent(
        _t(h, dtype), torch.from_numpy(head), torch.from_numpy(labels),
        torch.from_numpy(mask), 8, valid_vocab=cfg.vocab_size)
    jtot, jcnt = jL.chunked_softmax_xent(
        _j(h, dtype), jnp.asarray(head), jnp.asarray(labels),
        jnp.asarray(mask), 8, valid_vocab=jcfg.vocab_size)
    _close(_tnp(tot), _jnp(jtot), dtype)
    assert float(cnt) == float(jcnt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_loss_and_grads_match_reference(model, dtype):
    jcfg, cfg, params = model
    shape = ShapeConfig("t", SEQ, BATCH, "train")
    rc = RunConfig(model=cfg, shape=shape, loss_chunk=16, attn_chunk=8,
                   dtype=dtype)
    jrc = JRunConfig(model=jcfg, shape=JShape("t", SEQ, BATCH, "train"),
                     loss_chunk=16, attn_chunk=8, dtype=dtype)
    batch = SyntheticDataset(cfg, shape, seed=1).get_batch(0)

    jparams = jax.tree.map(jnp.asarray, params)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def jgrad(run):
        return jax.value_and_grad(
            lambda p: jT.forward_loss(p, jcfg, run, None, jbatch),
            has_aux=True)(jparams)

    (jloss, _), jgrads = jgrad(jrc)

    tparams = state_from_numpy(params, "cpu")
    leaves = [p.requires_grad_(True) for p in tree_leaves(tparams)]
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics = T.forward_loss(tparams, cfg, rc, None, tbatch)
    grads = torch.autograd.grad(loss, leaves)

    _close(_tnp(loss), _jnp(jloss), dtype)
    _close(_tnp(metrics["xent"]), _jnp(jloss), dtype)
    jflat = dict(_paths(state_to_numpy_j(jgrads)))
    tflat = [p for p, _ in _paths(tparams)]
    assert sorted(jflat) == tflat
    if dtype == "float32":
        for path, g in zip(tflat, grads):
            _close(_tnp(g), jflat[path], dtype)
    else:
        _, g32 = jgrad(JRunConfig(model=jcfg, shape=jrc.shape, loss_chunk=16,
                                  attn_chunk=8, dtype="float32"))
        exact = dict(_paths(state_to_numpy_j(g32)))
        for path, g in zip(tflat, grads):
            ours = _rel(_tnp(g), exact[path])
            theirs = _rel(jflat[path], exact[path])
            assert ours <= 1.25 * theirs + 1e-2, (path, ours, theirs)
    if cfg.n_heads_padded != cfg.n_heads:
        # padded heads get exactly zero gradient in both packages
        wq = dict(zip(tflat, grads))["blocks/attn/wq"]
        dead = _tnp(attn.head_mask(cfg)) == 0
        assert not _tnp(wq)[:, :, dead].any()


def state_to_numpy_j(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def test_convert_round_trip(model):
    _, _, params = model
    back = state_to_numpy(state_from_numpy(params, "cpu"))
    for (p, a), (q, b) in zip(_paths(params), _paths(back)):
        assert p == q and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
