"""The port's encoder-decoder pieces against the JAX package at reduced
whisper-large-v3: the sinusoidal positions, cross attention over a full
sequence with queries and keys of different lengths (S 64 against Te
24 at `attn_chunk=16`, which the reference blocks in keys of 12),
forward and backward, the encoder, the cross step of a decode block, and
the encoder leaves' gradients through `forward_loss` with and without
remat.  Each runs unpadded and with KV heads padded without grouping
("pad": 5 heads over 5 KV heads stored as 8 over 8, as the full-width
config stores 20 over 20 as 32 over 32).  Both packages get the same
numpy-made inputs and the JAX init, carried over with
`repro_torch.convert.state_from_numpy`.

Tolerances (tests/test_torch_model.py's): float32 rtol 1e-4 with an
absolute floor of 1e-4 of the tensor's largest magnitude; bfloat16 2e-2
of the tensor's norm.  The encoder's gradients through the loss in
float32 agree to 1e-3 of their norm, as that file holds them: the
reference alone moves them by up to 1.8e-4 of their norm when it
changes `attn_chunk`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced_config as jreduced
from repro.configs.base import RunConfig as JRunConfig, ShapeConfig as JShape
from repro.models import layers as jL
from repro.models import transformer as jT
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.convert import state_from_numpy
from repro_torch.data.pipeline import SyntheticDataset
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves, tree_map

ARCH = "whisper-large-v3"
PAD = dict(n_heads=5, n_kv_heads=5, head_dim=8, pad_to=8)
S, B, CHUNK = 64, 2, 16
DTYPES = ["float32", "bfloat16"]


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _close(got, want, dtype):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()))
    else:
        assert _rel(got, want) < 2e-2, _rel(got, want)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x, dtype):
    return torch.from_numpy(np.asarray(x, np.float32)).to(getattr(torch, dtype))


def _j(x, dtype):
    return jnp.asarray(x, dtype=getattr(jnp, dtype))


@pytest.fixture(scope="module", params=[{}, PAD], ids=["unpadded", "pad"])
def model(request):
    """(jax cfg, port cfg, numpy params) of reduced whisper-large-v3."""
    jcfg = jreduced(JARCHS[ARCH], **request.param)
    cfg = reduced_config(ARCHS[ARCH], **request.param)
    assert cfg.enc_dec and cfg.enc_positions == 24 != S
    if request.param:
        assert cfg.padded_heads() == (8, 1) and cfg.n_heads == 5
    params, _ = jT.init_params(jcfg, jax.random.PRNGKey(11))
    return jcfg, cfg, jax.tree.map(np.asarray, params)


def _rcs(jcfg, cfg, dtype, attn_chunk=CHUNK, seq=S, **kw):
    shape = ShapeConfig("t", seq, B, "train")
    rc = RunConfig(model=cfg, shape=shape, loss_chunk=32,
                   attn_chunk=attn_chunk, dtype=dtype, **kw)
    jrc = JRunConfig(model=jcfg, shape=JShape("t", seq, B, "train"),
                     loss_chunk=32, attn_chunk=attn_chunk, dtype=dtype, **kw)
    return jrc, rc


def _layer(params, key, i):
    return jax.tree.map(lambda a: a[i], params[key])


@pytest.mark.parametrize("n_pos,d", [(24, 64), (1500, 1280), (7, 10)])
def test_sinusoidal_positions_match_reference(n_pos, d):
    got = L.sinusoidal_positions(n_pos, d)
    want = np.asarray(jL.sinusoidal_positions(n_pos, d))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    # angles reach n_pos rad: an ulp of the angle is the error's scale
    atol = 4 * np.spacing(np.float32(n_pos))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
    np.testing.assert_array_equal(got.numpy()[0], np.asarray(
        [0.0] * (d // 2) + [1.0] * (d // 2), np.float32))


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_attention_seq_matches_reference(model, dtype):
    """Decoder queries (S 64) against encoder keys (Te 24), forward and
    backward: the output, the cross K/V prefill keeps (padded heads
    included: not zero, masked only after attention), and the gradients
    of the stream, the encoder output and the four weights."""
    jcfg, cfg, params = model
    jrc, rc = _rcs(jcfg, cfg, dtype)
    p = _layer(params, "blocks", 0)["xattn"]
    rng = np.random.RandomState(1)
    h = rng.randn(B, S, cfg.d_model).astype(np.float32)
    enc = rng.randn(B, cfg.enc_positions, cfg.d_model).astype(np.float32)
    up = rng.randn(B, S, cfg.d_model).astype(np.float32)

    def jfn(p, h, enc):
        out, (k, v) = jT._cross_attention_seq(jcfg, jrc, p, h, enc)
        return out, k, v

    (jo, jk, jv), vjp = jax.vjp(jfn, jax.tree.map(jnp.asarray, p),
                                _j(h, dtype), _j(enc, dtype))
    jgp, jgh, jge = vjp((_j(up, dtype), jnp.zeros_like(jk),
                         jnp.zeros_like(jv)))
    tp = {k: v.requires_grad_(True) for k, v in
          state_from_numpy(p, "cpu").items()}
    th = _t(h, dtype).requires_grad_(True)
    te = _t(enc, dtype).requires_grad_(True)
    to, (tk, tv) = T._cross_attention_seq(cfg, rc, tp, th, te)
    assert tk.shape == (B, cfg.enc_positions, cfg.n_kv_heads_padded,
                        cfg.head_dim)
    for got, want in ((to, jo), (tk, jk), (tv, jv)):
        _close(_np(got), _np(want), dtype)
    if cfg.n_kv_heads_padded != cfg.n_kv_heads:
        assert _np(tk)[:, :, cfg.n_kv_heads:].any()
    grads = torch.autograd.grad(to, [th, te, *tp.values()],
                                _t(up, dtype))
    for got, want in zip(grads, [jgh, jge, *(jgp[k] for k in tp)]):
        _close(_np(got), _np(want), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_matches_reference(model, dtype):
    """The encoder over (B, 24, d) frames: frames and positions each cast
    to the compute dtype before they are added, non-causal blocks with
    no cross attention, `enc_ln_f`."""
    jcfg, cfg, params = model
    jrc, rc = _rcs(jcfg, cfg, dtype)
    frames = np.random.RandomState(2).randn(
        B, cfg.enc_positions, cfg.d_model).astype(np.float32)
    want = jT._encode(jax.tree.map(jnp.asarray, params), jcfg, jrc, None,
                      _j(frames, dtype))
    with torch.no_grad():
        got = T._encode(state_from_numpy(params, "cpu"), cfg, rc, None,
                        _t(frames, dtype))
    assert got.dtype == getattr(torch, dtype)
    _close(_np(got), _np(want), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_block_cross_step_matches_reference(model, dtype):
    """One decoder block, one token, against caches holding 9 written
    positions and the cross K/V of 24 frames: the output, and the K/V the
    block writes at position 9; the cross K/V are left as they were."""
    jcfg, cfg, params = model
    jrc, rc = _rcs(jcfg, cfg, dtype)
    p = _layer(params, "blocks", 1)
    rng = np.random.RandomState(3)
    Kp, hd, T_ = cfg.n_kv_heads_padded, cfg.head_dim, 16
    x = rng.randn(B, 1, cfg.d_model).astype(np.float32)
    cache = {"k": rng.randn(B, T_, Kp, hd), "v": rng.randn(B, T_, Kp, hd),
             "xk": rng.randn(B, cfg.enc_positions, Kp, hd),
             "xv": rng.randn(B, cfg.enc_positions, Kp, hd)}
    cache = {k: v.astype(np.float32) for k, v in cache.items()}
    cache["k"][:, 9:] = cache["v"][:, 9:] = 0.0
    jx, jc = jT._decode_mixer_block(
        jcfg, jrc, None, jax.tree.map(jnp.asarray, p), _j(x, dtype),
        {k: _j(v, dtype) for k, v in cache.items()}, jnp.int32(9))
    tc = {k: _t(v, dtype) for k, v in cache.items()}
    xk_before = tc["xk"].clone()
    with torch.no_grad():
        tx = T._decode_mixer_block(cfg, rc, None, state_from_numpy(p, "cpu"),
                                   _t(x, dtype), tc, 9)
    _close(_np(tx), _np(jx), dtype)
    for key in ("k", "v"):
        _close(_np(tc[key]), _np(jc[key]), dtype)
    assert torch.equal(tc["xk"], xk_before)
    # the cross step is live: without the cross K/V the block differs
    with torch.no_grad():
        plain = T._decode_mixer_block(
            cfg, rc, None, state_from_numpy(p, "cpu"), _t(x, dtype),
            {k: _t(cache[k], dtype) for k in ("k", "v")}, 9)
    assert _rel(_np(plain), _np(jx)) > 0.05


def test_encoder_gradients_match_reference_with_and_without_remat(model):
    """Every `enc_blocks` leaf's gradient through `forward_loss` (float32),
    with each block under `torch.utils.checkpoint` (the encoder's output
    an explicit input of every decoder block's) and without: the two are
    equal bit for bit, nonzero in every layer, and within 1e-3 of the
    reference's in norm."""
    jcfg, cfg, params = model
    jrc, _ = _rcs(jcfg, cfg, "float32")
    batch = SyntheticDataset(cfg, ShapeConfig("t", S, B, "train"),
                             seed=3).get_batch(0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    want = jax.grad(lambda p: jT.forward_loss(p, jcfg, jrc, None,
                                              jbatch)[0])(
        jax.tree.map(jnp.asarray, params))["enc_blocks"]
    got = {}
    for remat in ("full", "none"):
        rc = _rcs(jcfg, cfg, "float32", remat_policy=remat)[1]
        tparams = state_from_numpy(params, "cpu")
        leaves = [t.requires_grad_(True) for t in tree_leaves(tparams)]
        loss, _ = T.forward_loss(tparams, cfg, rc, None,
                                 {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
        grads = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
        got[remat] = tree_map(lambda t: grads[id(t)], tparams["enc_blocks"])
    pairs = zip(tree_leaves(got["full"]), tree_leaves(got["none"]),
                jax.tree.leaves(want))
    for g_full, g_none, w in pairs:
        assert torch.equal(g_full, g_none)
        assert g_full.abs().sum(dim=tuple(range(1, g_full.dim()))).all()
        assert _rel(_np(g_full), w) < 1e-3
