"""The port's vision cross-attention family against the JAX package at
reduced llama-3.2-vision-11b, in three cases: "one-group" (the reduced
config: 2 layers with `cross_attn_every` 2, one self block and one cross
block), "two-group" (6 layers with `cross_attn_every` 3: two groups of
two self blocks and one cross block, so both leading layer axes of
`self_blocks`, (G, per-1), exceed 1) and "pad" (6 heads over 2 KV heads
with `pad_to=4`, stored as 8 over 2).  Each checks the init tree against
`jax.eval_shape` of the reference's, the gradients of `forward_loss`
with remat on and off, one cross block forward and backward, prefill
and several teacher-forced decode steps (logits and every decode-state
leaf).  The same cases run through `tests/test_torch_model.py` (layers,
attention, loss, gradients in float32 and bfloat16) and
`tests/test_torch_serve.py` (the port's own decode and image
continuation).  Both packages get the same numpy-made inputs and the JAX
init, carried over with `repro_torch.convert.state_from_numpy`.

The reference decodes a cross layer as pure cross attention (no `ln1`,
no self-attention), while its forward runs the cross block's
self-attention too, so decode does not continue the forward; both
packages are held to that here (`test_decode_departs_from_forward...`).

Tolerances:
  * float32: tests/test_torch_model.py's (rtol 1e-4 with an absolute
    floor of 1e-4 of the tensor's largest magnitude) for one block and
    for the one-group and pad cases' serving outputs; gradients through
    the whole model norm-relative 1e-3, and for the two-group case 1e-2
    for gradients and 2e-3 for serving outputs.  Random-init depth
    amplifies rounding: perturbing each of the reference's float32
    parameters by one rounding (a relative 2^-24) moves its own
    gradients by up to 6.4e-5 (one-group), 2.4e-5 (pad) and 3.8e-3
    (two-group) of their norm and the two-group decode logits by up to
    2.3e-4, where the port sits at 1.1e-4, 2.9e-5, 3.0e-3 and 5.6e-4.
  * bfloat16: one block 2e-2 of the tensor's norm (the file's rule:
    each block agrees with the reference's to bf16 rounding); serving
    outputs through the whole model by the rule of
    tests/test_torch_serve.py for reduced whisper: the port's distance
    from the reference's float32 result within 1.25x the reference's
    own bf16 distance from it, plus 1e-2 (the padded case's bf16 prefill
    logits sit 9% from the f32 ones in the reference, the two-group
    case's 52%).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced_config as jreduced
from repro.configs.base import RunConfig as JRunConfig, ShapeConfig as JShape
from repro.models import transformer as jT
from repro.training.step import make_serve_steps as jmake_serve_steps
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.convert import state_from_numpy
from repro_torch.data.pipeline import SyntheticDataset
from repro_torch.models import transformer as T
from repro_torch.training.step import make_serve_steps
from repro_torch.tree import tree_leaves

ARCH = "llama-3.2-vision-11b"
CASES = {"one-group": {}, "two-group": dict(n_layers=6, cross_attn_every=3),
         "pad": dict(n_heads=6, n_kv_heads=2, head_dim=8, pad_to=4)}
DTYPES = ["float32", "bfloat16"]
S, B, DECODES = 32, 2, 4


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


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _groups(cfg):
    return cfg.n_layers // cfg.cross_attn_every


@pytest.fixture(scope="module", params=list(CASES))
def model(request):
    """(jax cfg, port cfg, numpy params) of reduced llama-3.2-vision-11b."""
    over = CASES[request.param]
    jcfg = jreduced(JARCHS[ARCH], **over)
    cfg = reduced_config(ARCHS[ARCH], **over)
    if request.param == "pad":
        assert (cfg.n_heads_padded, cfg.n_kv_heads_padded) == (8, 2)
    if request.param == "two-group":
        assert (_groups(cfg), cfg.cross_attn_every - 1) == (2, 2)
    params, _ = jT.init_params(jcfg, jax.random.PRNGKey(3))
    return jcfg, cfg, jax.tree.map(np.asarray, params)


def _reference_tree(jcfg):
    """(shapes, logical) of the reference's init, traced only."""
    box = {}

    def init(key):
        params, box["logical"] = jT.init_params(jcfg, key)
        return params

    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    return shapes, box["logical"]


def _assert_same_tree(jcfg, cfg):
    shapes, jlogical = _reference_tree(jcfg)
    ours, logical = T.init_params(cfg, None, "meta")
    assert {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for p, t in _paths(ours)} == \
        {p: (a.shape, str(a.dtype)) for p, a in _paths(shapes)}
    assert logical == jlogical
    return sum(t.numel() for t in tree_leaves(ours))


@pytest.mark.parametrize("case", list(CASES))
def test_init_tree_matches_reference(case):
    """Paths, shapes, dtypes and logical axes: `self_blocks` stacked (G,
    per-1, ...) on ("layers", "layers", ...), `cross_blocks` (G, ...)
    with `lnx` and an `xattn` without QKV bias, no `blocks`."""
    jcfg = jreduced(JARCHS[ARCH], **CASES[case])
    cfg = reduced_config(ARCHS[ARCH], **CASES[case])
    _assert_same_tree(jcfg, cfg)
    shapes, logical = T.init_params(cfg, None, "meta")
    G, per = _groups(cfg), cfg.cross_attn_every
    assert "blocks" not in shapes
    assert shapes["self_blocks"]["attn"]["wq"].shape[:2] == (G, per - 1)
    assert logical["self_blocks"]["attn"]["wq"][:2] == ("layers", "layers")
    assert shapes["cross_blocks"]["xattn"]["wk"].shape[0] == G
    assert "bq" not in shapes["cross_blocks"]["xattn"]


@pytest.mark.parametrize("n_layers,per,stored", [
    (40, 5, 10_110_734_336), (3, 3, 1_746_960_384), (2, 2, 1_528_848_384)])
def test_full_width_tree_matches_reference(n_layers, per, stored):
    """Full-width llama-3.2-vision-11b as served (40 layers: 8 groups of 4
    self blocks and a cross block) and as the training phase of
    `chip_smoke.py` cuts it (one group of 3 layers, or of 2): the same
    tree as the reference's, and the parameters the port stores."""
    over = dict(n_layers=n_layers, cross_attn_every=per)
    jcfg = dataclasses.replace(JARCHS[ARCH], **over)
    cfg = dataclasses.replace(ARCHS[ARCH], **over)
    assert _assert_same_tree(jcfg, cfg) == stored


def test_remat_on_and_off_give_equal_gradients(model):
    """`forward_loss` in float32 with every block under the per-block
    checkpoint (the patches an explicit input of each cross block's) and
    without: equal gradients bit for bit, nonzero in every layer of both
    stacks, and within the module docstring's tolerance of the
    reference's."""
    jcfg, cfg, params = model
    shape = ShapeConfig("t", S, B, "train")
    batch = SyntheticDataset(cfg, shape, seed=1).get_batch(0)
    assert batch["patches"].shape == (B, cfg.vision_tokens, cfg.d_model)
    jrc = JRunConfig(model=jcfg, shape=JShape("t", S, B, "train"),
                     loss_chunk=16, attn_chunk=8, dtype="float32")
    want = jax.grad(lambda p: jT.forward_loss(
        p, jcfg, jrc, None, {k: jnp.asarray(v) for k, v in batch.items()})[0])(
        jax.tree.map(jnp.asarray, params))
    got = {}
    for remat in ("full", "none"):
        rc = RunConfig(model=cfg, shape=shape, loss_chunk=16, attn_chunk=8,
                       dtype="float32", remat_policy=remat)
        tparams = state_from_numpy(params, "cpu")
        leaves = [t.requires_grad_(True) for t in tree_leaves(tparams)]
        loss, _ = T.forward_loss(tparams, cfg, rc, None,
                                 {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
        got[remat] = torch.autograd.grad(loss, leaves)
    tol = 1e-2 if _groups(cfg) > 1 else 1e-3
    paths = [p for p, _ in _paths(params)]
    for path, g_full, g_none, w in zip(paths, got["full"], got["none"],
                                       jax.tree.leaves(want)):
        assert torch.equal(g_full, g_none), path
        if path.startswith(("self_blocks/", "cross_blocks/")):
            lead = 2 if path.startswith("self_blocks/") else 1
            per_layer = g_full.abs().sum(dim=tuple(range(lead, g_full.dim())))
            assert per_layer.all(), path
        assert _rel(_np(g_full), w) < tol, path


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_block_matches_reference(model, dtype):
    """The last group's cross block over a full sequence, forward and
    backward: self-attention, cross attention to the (B, Tv, d) patches,
    the MLP; the output and the gradients of the stream, the patches and
    every weight."""
    jcfg, cfg, params = model
    kw = dict(loss_chunk=16, attn_chunk=8, dtype=dtype)
    jrc = JRunConfig(model=jcfg, shape=JShape("t", S, B, "train"), **kw)
    rc = RunConfig(model=cfg, shape=ShapeConfig("t", S, B, "train"), **kw)
    p = jax.tree.map(lambda a: a[-1], params["cross_blocks"])
    rng = np.random.RandomState(1)
    x = (rng.randn(B, S, cfg.d_model) * 3).astype(np.float32)
    patches = rng.randn(B, cfg.vision_tokens, cfg.d_model).astype(np.float32)
    up = rng.randn(B, S, cfg.d_model).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)

    def jblock(p, x, e):
        return jT._mixer_block_seq(jcfg, jrc, None, p, x, jnp.arange(S), e)[0]

    jo, vjp = jax.vjp(jblock, jax.tree.map(jnp.asarray, p),
                      jnp.asarray(x, jd), jnp.asarray(patches, jd))
    jgp, jgx, jge = vjp(jnp.asarray(up, jd))
    tp = state_from_numpy(p, "cpu")
    leaves = [t.requires_grad_(True) for t in tree_leaves(tp)]
    tx = torch.from_numpy(x).to(td).requires_grad_(True)
    te = torch.from_numpy(patches).to(td).requires_grad_(True)
    to, _, cache = T._mixer_block_seq(cfg, rc, None, tp, tx, torch.arange(S),
                                      te)
    assert sorted(cache) == ["k", "v", "xk", "xv"]
    grads = torch.autograd.grad(to, [tx, te, *leaves],
                                torch.from_numpy(up).to(td))
    _close(_np(to), _np(jo), dtype)
    for got, want in zip(grads, [jgx, jge, *jax.tree.leaves(jgp)]):
        _close(_np(got), _np(want), dtype)


def _prompt(cfg, toks):
    return {"tokens": toks, "patches": np.random.RandomState(7).randn(
        toks.shape[0], cfg.vision_tokens, cfg.d_model).astype(np.float32)}


def _jax_serve(jcfg, jrc, params, batch, toks, P):
    """The reference's prefill of P tokens and DECODES teacher-forced
    decode steps: [(logits, state)]."""
    jprefill, jserve = (jax.jit(f) for f in jmake_serve_steps(jcfg, jrc,
                                                              None))
    jparams = jax.tree.map(jnp.asarray, params)
    out = [jprefill(jparams, {k: jnp.asarray(v) for k, v in batch.items()})]
    for i in range(DECODES):
        out.append(jserve(jparams, out[-1][1],
                          jnp.asarray(toks[:, P + i:P + i + 1])))
    return out


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_and_decode_match_reference(model, dtype):
    """Prefill of 64 tokens and 4 teacher-forced decode steps: the logits,
    `pos`, and every decode-state leaf (`k`/`v` (G, per-1, B, 64+margin, K,
    hd) for the self blocks only, `xk`/`xv` (G, B, Tv, K, hd)) after each,
    with their dtypes."""
    jcfg, cfg, params = model
    P = 64
    kw = dict(loss_chunk=32, attn_chunk=16)
    jrc = JRunConfig(model=jcfg, shape=JShape("s", P, B, "prefill"),
                     dtype=dtype, **kw)
    rc = RunConfig(model=cfg, shape=ShapeConfig("s", P, B, "prefill"),
                   dtype=dtype, **kw)
    toks = np.random.RandomState(1).randint(
        0, cfg.vocab_size, (B, P + DECODES)).astype(np.int32)
    batch = _prompt(cfg, toks[:, :P])
    ref = _jax_serve(jcfg, jrc, params, batch, toks, P)
    if dtype == "bfloat16":
        exact = _jax_serve(jcfg, dataclasses.replace(jrc, dtype="float32"),
                           params, batch, toks, P)

        def close(got, i, leaf):
            want = [o[1]["layers"][leaf] if leaf else o[0]
                    for o in (ref[i], exact[i])]
            ours, theirs = _rel(got, _np(want[1])), _rel(_np(want[0]),
                                                         _np(want[1]))
            assert ours <= 1.25 * theirs + 1e-2, (i, leaf, ours, theirs)
    else:
        def close(got, i, leaf):
            want = _np(ref[i][1]["layers"][leaf] if leaf else ref[i][0])
            if _groups(cfg) > 1:
                assert _rel(got, want) < 2e-3, (i, leaf, _rel(got, want))
            else:
                _close(got, want, dtype)

    prefill, serve = make_serve_steps(cfg, rc)
    tparams = state_from_numpy(params, "cpu")
    tl, ts = prefill(tparams, {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    G, Kp, hd = _groups(cfg), cfg.n_kv_heads_padded, cfg.head_dim
    assert tuple(ts["layers"]["k"].shape) == (
        G, cfg.cross_attn_every - 1, B, P + rc.decode_margin, Kp, hd)
    assert tuple(ts["layers"]["xk"].shape) == (G, B, cfg.vision_tokens, Kp,
                                               hd)
    close(_np(tl), 0, None)
    for i in range(DECODES):
        js = ref[i][1]
        assert int(ts["pos"]) == int(js["pos"]) == P + i
        assert sorted(ts["layers"]) == sorted(js["layers"]) == [
            "k", "v", "xk", "xv"]
        for key, c in ts["layers"].items():
            assert str(c.dtype) == f"torch.{js['layers'][key].dtype}"
            close(_np(c), i, key)
        tl, ts = serve(tparams, ts,
                       torch.from_numpy(toks[:, P + i:P + i + 1]))
        assert tl.shape == (B, 1, cfg.vocab_padded)
        close(_np(tl), i + 1, None)


@pytest.mark.parametrize("case", ["one-group", "two-group"])
def test_decode_departs_from_forward_unless_cross_self_attention_is_zeroed(
        case):
    """Decode after a prefill of 16 tokens against the forward over 17,
    at its last position, float32, in both packages: the reference's
    decode runs a cross layer as pure cross attention and its forward
    runs the cross block's self-attention too, so the two part (by 1.20
    and 1.08 of the logits' norm here, in either package); with the
    cross blocks' `attn/wo` zeroed that self-attention adds nothing, and
    they agree to rounding (4e-7 to 2e-5)."""
    over = CASES[case]
    jcfg = jreduced(JARCHS[ARCH], **over)
    cfg = reduced_config(ARCHS[ARCH], **over)
    params, _ = jT.init_params(jcfg, jax.random.PRNGKey(5))
    params = jax.tree.map(np.asarray, params)
    zeroed = dict(params, cross_blocks=dict(
        params["cross_blocks"], attn=dict(
            params["cross_blocks"]["attn"],
            wo=np.zeros_like(params["cross_blocks"]["attn"]["wo"]))))
    P = 16
    kw = dict(loss_chunk=16, attn_chunk=8, dtype="float32")
    jrc = JRunConfig(model=jcfg, shape=JShape("s", P, B, "prefill"), **kw)
    rc = RunConfig(model=cfg, shape=ShapeConfig("s", P, B, "prefill"), **kw)
    toks = np.random.RandomState(2).randint(
        0, cfg.vocab_size, (B, P + 1)).astype(np.int32)
    short, full = _prompt(cfg, toks[:, :P]), _prompt(cfg, toks)

    def reference(p):
        p = jax.tree.map(jnp.asarray, p)
        jb = lambda b: {k: jnp.asarray(v) for k, v in b.items()}
        _, st = jT.prefill(p, jcfg, jrc, None, jb(short))
        dec, _ = jT.decode_step(p, jcfg, jrc, None, st,
                                jnp.asarray(toks[:, P:]))
        x, _, _ = jT.forward(p, jcfg, jrc, None, jb(full))
        fwd = x[:, -1] @ p["embed"]["head"]
        return _np(dec[:, 0]), _np(fwd)

    def port(p):
        p = state_from_numpy(p, "cpu")
        tb = lambda b: {k: torch.from_numpy(v) for k, v in b.items()}
        with torch.no_grad():
            _, st = T.prefill(p, cfg, rc, None, tb(short))
            dec, _ = T.decode_step(p, cfg, rc, None, st,
                                   torch.from_numpy(toks[:, P:]))
            x, _, _ = T.forward(p, cfg, rc, None, tb(full))
            fwd = T._logits(p, cfg, x[:, -1])
        return _np(dec[:, 0]), _np(fwd)

    assert cfg.vocab_padded == cfg.vocab_size and not cfg.tie_embeddings
    for run in (reference, port):
        assert _rel(*run(params)) > 0.3, run.__name__
        assert _rel(*run(zeroed)) < 1e-4, run.__name__
