"""The port's dense, hybrid-SSM, RWKV-6, encoder-decoder and vision
cross-attention models (layers, GQA flash attention, loss, gradients)
against the JAX package at reduced qwen2-0.5b, reduced hymba-1.5b,
reduced rwkv6-3b, reduced whisper-large-v3 and reduced
llama-3.2-vision-11b, each unpadded and with padded heads masked (qwen2 with
`pad_to=16`; hymba padded as 25 heads over 5 KV heads, stored as 48 over
6, the padding of the full-width config, so a dummy KV group runs; rwkv
as 5 heads stored as 6, padding without grouping as rwkv6-3b's 40 heads
are stored as 48, with `pad_to=2` so that the 256-entry vocabulary
stays unpadded; whisper as 5 heads over 5 KV heads stored as 8 over 8,
KV heads padded without grouping as the full-width config's 20 are
stored as 32, in self and cross attention, encoder and decoder; vision
as 6 heads over 2 KV heads stored as 8 over 2, and also in two groups
of two self blocks and a cross block, "vision-2g").  Both packages get
the same inputs and the same parameters: the JAX init, carried over
with `repro_torch.convert.state_from_numpy`.

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
  * reduced whisper-large-v3 is held to the reference's own accuracy
    where that is coarser than the rules above.  Its encoder gradients
    in float32 move by up to 1.8e-4 of their norm, with elements past
    the float32 rule, when the reference alone changes `attn_chunk` from
    8 to 12 (a sum of cancelling terms through every cross attention);
    there the port's must agree with the reference's to 1e-3 of their
    norm (about 5x that spread).  Unpadded, its bf16
    gradients sit 76-103% (median over leaves, four init seeds) from
    the f32 gradients in the reference (zero would sit at 100%); on a
    leaf where the reference's bf16 gradient is 50% or more from the
    f32 one, the port's must stay within 1.5x the reference's distance.
  * reduced llama-3.2-vision-11b is held to the reference's own accuracy
    too.  Its float32 gradients agree to 1e-3 of their norm (1e-2 for
    two groups): perturbing each of the reference's parameters by one
    rounding (a relative 2^-24) moves its own gradients by up to 6.4e-5
    (one group), 2.4e-5 (padded) and 3.8e-3 (two groups) of their norm,
    where the port sits at 1.1e-4, 2.9e-5 and 3.0e-3.  Its bf16
    gradients sit 35-195% (median over leaves, init seeds 3-5) from the
    f32 ones in the reference, beyond 100% where zero would sit: the
    gradients through its peaked attention are mostly rounding noise, in
    both packages, while each cross block agrees with the reference's to
    bf16 rounding (tests/test_torch_vision.py).  The port's distance
    from the f32 gradient must stay within 2x the reference's, plus
    1e-2: the largest ratio on a leaf was 1.81 over init seeds 0-5 (one
    group) and 1.20 over seeds 3-5 (two groups, padded).
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


# reduced hymba with the full-width config's head padding: 25 heads over
# 5 KV heads pad to 48 over 6 (K_pad > K)
HYMBA_PAD = dict(n_heads=25, n_kv_heads=5, head_dim=8, pad_to=16)
# reduced rwkv6-3b with padded heads and no grouping: 5 heads stored as 6
RWKV_PAD = dict(n_heads=5, n_kv_heads=5, head_dim=8, pad_to=2)
# reduced whisper-large-v3 with KV heads padded and no grouping: 5 over 5
# stored as 8 over 8
WHISPER_PAD = dict(n_heads=5, n_kv_heads=5, head_dim=8, pad_to=8)
# reduced llama-3.2-vision-11b in two groups of two self blocks and one
# cross block, and with padded heads: 6 over 2 KV heads stored as 8 over 2
VISION_2G = dict(n_layers=6, cross_attn_every=3)
VISION_PAD = dict(n_heads=6, n_kv_heads=2, head_dim=8, pad_to=4)


@pytest.fixture(scope="module", params=[
    ("qwen2-0.5b", dict(pad_to=1)), ("qwen2-0.5b", dict(pad_to=16)),
    ("hymba-1.5b", {}), ("hymba-1.5b", HYMBA_PAD),
    ("rwkv6-3b", {}), ("rwkv6-3b", RWKV_PAD),
    ("whisper-large-v3", {}), ("whisper-large-v3", WHISPER_PAD),
    ("llama-3.2-vision-11b", {}), ("llama-3.2-vision-11b", VISION_2G),
    ("llama-3.2-vision-11b", VISION_PAD)],
    ids=["unpadded", "pad16", "hymba", "hymba-pad16", "rwkv", "rwkv-pad",
         "whisper", "whisper-pad", "vision", "vision-2g", "vision-pad"])
def model(request):
    """(jax cfg, port cfg, numpy params) for reduced qwen2-0.5b,
    hymba-1.5b, rwkv6-3b, whisper-large-v3 or llama-3.2-vision-11b."""
    arch, overrides = request.param
    jcfg = jreduced(JARCHS[arch], **overrides)
    cfg = reduced_config(ARCHS[arch], **overrides)
    params, _ = jT.init_params(jcfg, jax.random.PRNGKey(3))
    rng = np.random.RandomState(4)
    params = jax.tree.map(lambda x: np.asarray(x), params)
    # nonzero biases and SSM constants so their paths are exercised
    blocks = params.get("blocks", {})
    for k in ("bq", "bk", "bv"):
        if k in blocks.get("attn", {}):
            blocks["attn"][k] = (rng.randn(*blocks["attn"][k].shape) * 0.1
                                 ).astype(np.float32)
    for k in ("conv_b", "dt_bias", "A_log", "D"):
        if "mamba" in blocks:
            blocks["mamba"][k] = (blocks["mamba"][k] + rng.randn(
                *blocks["mamba"][k].shape) * 0.1).astype(np.float32)
    if "tm" in blocks:
        # per-token mixes, decay offsets and bonuses off their constants
        tm, cm = blocks["tm"], blocks["cm"]
        tm["mu"] = rng.uniform(0, 1, tm["mu"].shape).astype(np.float32)
        for k in ("w0", "u"):
            tm[k] = (tm[k] + rng.randn(*tm[k].shape) * 0.3).astype(np.float32)
        for k in ("mu_ck", "mu_cr"):
            cm[k] = rng.uniform(0, 1, cm[k].shape).astype(np.float32)
    if arch == "hymba-1.5b" and overrides:
        assert (cfg.n_heads_padded, cfg.n_kv_heads_padded) == (48, 6)
    if arch == "rwkv6-3b" and overrides:
        assert (cfg.n_heads_padded, cfg.vocab_padded) == (6, cfg.vocab_size)
    if arch == "whisper-large-v3" and overrides:
        assert cfg.padded_heads() == (8, 1)
    if overrides is VISION_PAD:
        assert (cfg.n_heads_padded, cfg.n_kv_heads_padded) == (8, 2)
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

    blocks = params.get("blocks") or params.get("cross_blocks")
    if "mlp" in blocks:
        mlp = {k: v[0] for k, v in blocks["mlp"].items()}
        _close(_tnp(L.mlp_apply(state_from_numpy(mlp, "cpu"), _t(x, dtype))),
               _jnp(jL.mlp_apply(jax.tree.map(jnp.asarray, mlp),
                                 _j(x, dtype))), dtype)
    xh = xr.reshape(BATCH, SEQ, 2, 2 * hd)
    _close(_tnp(L.head_rms_norm(_t(xh, dtype))),
           _jnp(jL.head_rms_norm(_j(xh, dtype))), dtype)


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
def test_embedding_and_its_backward_match_reference(dtype):
    """Rows of a 16-row table gathered by 256 ids, most of them repeated:
    the gathered rows equal the reference's exactly, and the gradient
    (repeated ids summed in a fixed order, `L.sum_rows_by_id`) agrees
    with the reference's to the file's tolerance (in bfloat16 the
    reference sums in bfloat16, the port in float32)."""
    rng = np.random.RandomState(8)
    table = rng.randn(16, 8).astype(np.float32)
    ids = rng.randint(0, 12, (4, 64)).astype(np.int32)   # rows 12-15 unused
    up = rng.randn(4, 64, 8).astype(np.float32)
    t = torch.from_numpy(table).requires_grad_(True)
    rows = L.embed_apply({"embedding": t}, torch.from_numpy(ids),
                         getattr(torch, dtype))
    rows.backward(_t(up, dtype))
    jrows, vjp = jax.vjp(lambda w: jL.embed_apply(
        {"embedding": w}, jnp.asarray(ids), getattr(jnp, dtype)),
        jnp.asarray(table))
    (jgrad,) = vjp(_j(up, dtype))
    np.testing.assert_array_equal(_tnp(rows), _jnp(jrows))
    assert t.grad.dtype == torch.float32
    _close(_tnp(t.grad), _jnp(jgrad), dtype)
    assert not t.grad[12:].any()


@pytest.mark.parametrize("n_ids,span", [(1, 1), (7, 1), (300, 5),
                                        (1000, 997), (513, 40)])
def test_sum_rows_by_id_equals_index_add(n_ids, span):
    """Integer-valued rows sum exactly in any order, so the fixed-order
    pairwise sum must equal `index_add_` bit for bit; runs of one id up
    to the whole input (span 1) and ids that never repeat."""
    rng = np.random.RandomState(n_ids)
    ids = torch.from_numpy(rng.randint(0, span, n_ids).astype(np.int64))
    rows = torch.from_numpy(rng.randint(-50, 50, (n_ids, 6)).astype(
        np.float32))
    want = torch.zeros(span + 3, 6).index_add_(0, ids, rows)
    got = L.sum_rows_by_id(rows.to(torch.bfloat16), ids, span + 3)
    assert got.dtype == torch.float32
    assert torch.equal(got, want)


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
            if cfg.enc_dec and path.startswith("enc_blocks/"):
                # norm-relative (see the module docstring)
                assert _rel(_tnp(g), jflat[path]) < 1e-3, path
            elif cfg.cross_attn_every:
                # norm-relative (see the module docstring)
                groups = cfg.n_layers // cfg.cross_attn_every
                tol = 1e-2 if groups > 1 else 1e-3
                assert _rel(_tnp(g), jflat[path]) < tol, path
            else:
                _close(_tnp(g), jflat[path], dtype)
    else:
        _, g32 = jgrad(JRunConfig(model=jcfg, shape=jrc.shape, loss_chunk=16,
                                  attn_chunk=8, dtype="float32"))
        exact = dict(_paths(state_to_numpy_j(g32)))
        for path, g in zip(tflat, grads):
            ours = _rel(_tnp(g), exact[path])
            theirs = _rel(jflat[path], exact[path])
            if cfg.enc_dec and theirs >= 0.5:
                # the reference's bf16 gradient is at most twice as close
                # to the f32 one as zero is (see the module docstring)
                assert ours <= 1.5 * theirs, (path, ours, theirs)
            elif cfg.cross_attn_every:
                # (see the module docstring)
                assert ours <= 2 * theirs + 1e-2, (path, ours, theirs)
            else:
                assert ours <= 1.25 * theirs + 1e-2, (path, ours, theirs)
    if cfg.n_heads_padded != cfg.n_heads:
        # padded heads get exactly zero gradient in both packages
        dead = _tnp(attn.head_mask(cfg)) == 0
        named = dict(zip(tflat, grads))
        for path in (["blocks/tm/wr"] if cfg.rwkv else
                     ["blocks/attn/wq", "blocks/xattn/wq",
                      "enc_blocks/attn/wq"] if cfg.enc_dec else
                     ["self_blocks/attn/wq", "cross_blocks/attn/wq",
                      "cross_blocks/xattn/wq"] if cfg.cross_attn_every else
                     ["blocks/attn/wq"]):
            assert not _tnp(named[path])[..., dead, :].any(), path


def state_to_numpy_j(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def test_convert_round_trip(model):
    _, _, params = model
    back = state_to_numpy(state_from_numpy(params, "cpu"))
    for (p, a), (q, b) in zip(_paths(params), _paths(back)):
        assert p == q and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# MoE + sliding-window training path (reduced Mixtral)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_swa_forward_loss_and_grads_match_reference(dtype):
    """Reduced Mixtral (4 experts top-2 in the virtual layout, SWA 32 over
    64 tokens, so the sliding-window path runs): loss including the
    0.01 * moe_aux / L term, the aux itself, and every gradient, at the
    tolerances of this file."""
    jcfg = jreduced(JARCHS["mixtral-8x7b"])
    cfg = reduced_config(ARCHS["mixtral-8x7b"])
    S = 64
    assert cfg.sliding_window < S
    params, _ = jT.init_params(jcfg, jax.random.PRNGKey(5))
    params = jax.tree.map(np.asarray, params)
    ours, logical = T.init_params(cfg, None, "meta")
    _, jlogical = jT.init_params(jcfg, jax.random.PRNGKey(0))
    assert logical == jlogical
    assert {p: tuple(t.shape) for p, t in _paths(ours)} == \
        {p: a.shape for p, a in _paths(params)}
    shape = ShapeConfig("t", S, BATCH, "train")
    kw = dict(loss_chunk=32, attn_chunk=16)
    jshape = JShape("t", S, BATCH, "train")
    batch = SyntheticDataset(cfg, shape, seed=2).get_batch(0)
    jparams = jax.tree.map(jnp.asarray, params)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def jgrad(dt):
        run = JRunConfig(model=jcfg, shape=jshape, dtype=dt, **kw)
        return jax.value_and_grad(
            lambda p: jT.forward_loss(p, jcfg, run, None, jbatch),
            has_aux=True)(jparams)

    (jloss, jm), jgrads = jgrad(dtype)
    tparams = state_from_numpy(params, "cpu")
    leaves = [p.requires_grad_(True) for p in tree_leaves(tparams)]
    rc = RunConfig(model=cfg, shape=shape, dtype=dtype, **kw)
    loss, metrics = T.forward_loss(
        tparams, cfg, rc, None, {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    _close(_tnp(loss), _jnp(jloss), dtype)
    _close(_tnp(metrics["moe_aux"]), _jnp(jm["moe_aux"]), dtype)
    _close(_tnp(metrics["xent"]), _jnp(jm["xent"]), dtype)
    assert float(metrics["moe_aux"].detach()) > 0
    jflat = dict(_paths(state_to_numpy_j(jgrads)))
    tflat = [p for p, _ in _paths(tparams)]
    assert sorted(jflat) == tflat
    if dtype == "float32":
        for path, g in zip(tflat, grads):
            _close(_tnp(g), jflat[path], dtype)
    else:
        exact = dict(_paths(state_to_numpy_j(jgrad("float32")[1])))
        for path, g in zip(tflat, grads):
            ours_err = _rel(_tnp(g), exact[path])
            theirs = _rel(jflat[path], exact[path])
            assert ours_err <= 1.25 * theirs + 1e-2, (path, ours_err, theirs)


# ---------------------------------------------------------------------------
# repairs: bf16 leaves through convert, chunked flash attention
# ---------------------------------------------------------------------------

def test_convert_carries_bf16_both_ways():
    """bf16 leaves cross bit for bit, without ml_dtypes in the port:
    numpy (ml_dtypes) -> tensor, and tensor -> uint16 bit pattern or the
    caller's bfloat16 dtype."""
    rng = np.random.RandomState(8)
    x = jnp.asarray(rng.randn(3, 5, 7) * 100.0, jnp.bfloat16)
    x = x.at[0, 0, :3].set(jnp.asarray([jnp.inf, -0.0, 1e-40], jnp.bfloat16))
    tree = {"layers": {"k": np.asarray(x)}, "pos": np.int32(9)}
    t = state_from_numpy(tree, "cpu")
    assert t["layers"]["k"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        t["layers"]["k"].view(torch.int16).numpy().view(np.uint16),
        np.asarray(x).view(np.uint16))
    back = state_to_numpy(t)
    assert back["layers"]["k"].dtype == np.uint16
    np.testing.assert_array_equal(back["layers"]["k"],
                                  np.asarray(x).view(np.uint16))
    typed = state_to_numpy(t, bfloat16=jnp.bfloat16)
    assert typed["layers"]["k"].dtype.name == "bfloat16"
    np.testing.assert_array_equal(typed["layers"]["k"].view(np.uint16),
                                  np.asarray(x).view(np.uint16))
    assert typed["pos"].dtype == np.int32 and typed["pos"].shape == ()
    # a port tensor -> numpy -> JAX array keeps its bits
    y = torch.randn(4, 6).to(torch.bfloat16)
    j = jnp.asarray(state_to_numpy({"y": y}, bfloat16=jnp.bfloat16)["y"])
    np.testing.assert_array_equal(np.asarray(j).view(np.uint16),
                                  y.view(torch.int16).numpy().view(np.uint16))


def _single_pass_attention(q, k, v):
    """The port's flash attention before it honoured `chunk`: one pass of
    all S queries against all T keys (causal)."""
    B, S, H, hd = q.shape
    K, T_ = k.shape[2], k.shape[1]
    scale = (1.0 / torch.sqrt(torch.tensor(hd, dtype=torch.float32))).to(
        q.dtype)
    qg = (q * scale).reshape(B, S, K, H // K, hd)
    s = torch.einsum("bskgh,btkh->bskgt", qg.float(), k.float())
    keep = torch.arange(S)[:, None] >= torch.arange(T_)[None, :]
    s = s.masked_fill(~keep[None, :, None, None, :], attn.NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True)).to(q.dtype)
    acc = torch.einsum("bskgt,btkh->bskgh", p.float(), v.float())
    o = acc / torch.clamp(p.float().sum(-1), min=1e-30)[..., None]
    return o.to(q.dtype).reshape(B, S, H, hd)


def test_flash_attention_honours_chunk():
    """Blocks of `chunk` queries give the single-pass result to f32
    rounding at S = 4 * chunk, and no tensor of the call is larger than
    one block's scores (B * chunk * H * T), a quarter of the full
    (B, S, H, T) score tensor."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Largest(TorchDispatchMode):
        numel = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor):
                    Largest.numel = max(Largest.numel, t.numel())
            return out

    rng = np.random.RandomState(9)
    B, chunk, H, K, hd = 2, 16, 4, 2, 8
    S = 4 * chunk
    q, k, v = (torch.from_numpy(rng.randn(B, S, n, hd).astype(np.float32))
               for n in (H, K, K))
    with Largest():
        got = attn.flash_attention(q, k, v, causal=True, chunk=chunk)
    np.testing.assert_allclose(got.numpy(),
                               _single_pass_attention(q, k, v).numpy(),
                               rtol=1e-6, atol=1e-6)
    assert Largest.numel == B * chunk * H * S < B * S * H * S


@pytest.mark.parametrize("kind", ["causal", "swa", "cross"])
def test_attention_backward_saves_no_scores(kind):
    """Under autograd a block of queries saves its inputs, its output and
    one log-sum-exp a row (the reference's custom VJP), never a score or
    probability tensor: every saved tensor is smaller than one block's
    scores (B * chunk * H * keys), and the gradients equal those of the
    single pass through plain autograd to f32 rounding."""
    rng = np.random.RandomState(10)
    B, chunk, H, K, hd = 2, 16, 4, 2, 8
    S = 4 * chunk
    T_ = 24 if kind == "cross" else S
    q = torch.from_numpy(rng.randn(B, S, H, hd).astype(np.float32))
    k, v = (torch.from_numpy(rng.randn(B, T_, K, hd).astype(np.float32))
            for _ in range(2))
    up = torch.from_numpy(rng.randn(B, S, H, hd).astype(np.float32))
    ins = [t.requires_grad_(True) for t in (q, k, v)]
    largest = []

    def pack(t):
        largest.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        if kind == "swa":
            out = attn.sliding_window_attention(*ins, window=chunk,
                                                chunk=chunk)
        else:
            out = attn.flash_attention(*ins, causal=kind == "causal",
                                       chunk=chunk)
    grads = torch.autograd.grad(out, ins, up)
    span = 2 * chunk if kind == "swa" else T_     # keys a block sees
    assert max(largest) < B * chunk * H * span
    if kind == "causal":
        want = torch.autograd.grad(_single_pass_attention(*ins), ins, up)
        for g, w in zip(grads, want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                       atol=1e-5)
