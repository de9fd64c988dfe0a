"""The port's serving path against the JAX package: decode and
sliding-window attention, the KV-cache write, the MoE layer, prefill and
teacher-forced decode of reduced qwen2-0.5b (dense, full attention),
reduced Mixtral (MoE + SWA, the ring cache wraps), reduced hymba-1.5b
(hybrid SSM + SWA: the decode state adds an f32 SSM state and a conv
tail; "hymba-pad16" pads 25 heads over 5 KV heads to 48 over 6, as the
full-width config does) and reduced rwkv6-3b (attention-free: the
decode state is an f32 `la` state and two token-shift states, no K/V;
"rwkv-pad" stores 5 heads as 6, padding without grouping as the
full-width config's 40 heads are stored as 48) and reduced
whisper-large-v3 (encoder-decoder: prefill also runs the encoder over
stub frames and keeps each decoder block's cross K/V, `xk`/`xv`, which
decode reads and never writes; "whisper-pad" stores 5 heads over 5 KV
heads as 8 over 8, KV heads padded without grouping as the full-width
config's 20 are stored as 32) and reduced llama-3.2-vision-11b (vision
cross-attention: prefill keeps the self blocks' K/V, (G, per-1, ...),
and the cross blocks' cross K/V over the stub image patches, which
decode reads and never writes; "vision-2g" runs two groups of two self
blocks and a cross block, "vision-pad" stores 6 heads over 2 KV heads
as 8 over 2; their prefill and decode against the reference are in
tests/test_torch_vision.py), the decode-vs-prefill continuation (not
for vision: the reference decodes a cross layer without the
self-attention its forward runs, so decode does not continue the
forward, tests/test_torch_vision.py), the port's own live-image restore
continuation, and the CPU run of the `serve_with_snapshot` example
twin.  Both packages get
the same numpy-made inputs; model parameters are the JAX init carried
over with `repro_torch.convert.state_from_numpy`.

Tolerances:
  * float32: rtol 2e-4 for the attention functions (the reference's own
    tests/test_attention.py holds them to a naive version at that); rtol
    1e-4 with an absolute floor of 1e-4 of the tensor's largest magnitude
    for the MoE layer and the model (the stacks sum in different orders);
  * bfloat16: 2e-2 of the tensor's norm (8 bits of mantissa, rounded at
    other places in the two stacks); for reduced whisper the port's
    distance from the reference's float32 result must stay within 1.25x
    the reference's own bf16 distance from it, plus 1e-2, the rule of
    tests/test_torch_model.py for bf16 gradients: this model's bf16
    prefill logits sit 20-38% from its f32 ones in the reference, and
    move by 1.8-4.1% when the reference alone changes `attn_chunk`
    from 16 to 8, so 2e-2 is within the reference's own noise;
  * decode vs prefill within the port: the reference's own tolerance
    (tests/test_archs_smoke.py, rtol 0.12, atol 0.15 on bf16 logits);
  * the port against itself (restore continuation, functional decode):
    bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced_config as jreduced
from repro.configs.base import RunConfig as JRunConfig, ShapeConfig as JShape
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models import transformer as jT
from repro.training.step import make_serve_steps as jmake_serve_steps
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core.checkpoint import CheckpointManager
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.training.step import make_serve_steps

F32_ATTN = dict(rtol=2e-4, atol=2e-4)


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


def _j(x, dtype):
    return jnp.asarray(x, dtype=getattr(jnp, dtype))


def _t(x, dtype):
    return torch.from_numpy(np.asarray(x, np.float32)).to(getattr(torch, dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# attention: decode, cache write, sliding window
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 8], ids=["full", "ring"])
def test_decode_attention_matches_reference(window, dtype):
    rng = np.random.RandomState(0)
    B, H, K, hd, T_ = 2, 4, 2, 8, 24
    q = rng.randn(B, 1, H, hd).astype(np.float32)
    kc = rng.randn(B, T_, K, hd).astype(np.float32)
    vc = rng.randn(B, T_, K, hd).astype(np.float32)
    for pos in (0, 5, T_ - 1, 3 * T_ + 2 if window else 17):
        cap = kc if not window else kc[:, :window]
        vcap = vc if not window else vc[:, :window]
        got = attn.decode_attention(_t(q, dtype), _t(cap, dtype),
                                    _t(vcap, dtype), pos, window)
        want = jattn.decode_attention(_j(q, dtype), _j(cap, dtype),
                                      _j(vcap, dtype), jnp.int32(pos), window)
        if dtype == "float32":
            np.testing.assert_allclose(_np(got), _np(want), **F32_ATTN)
        else:
            _close(_np(got), _np(want), dtype)


def test_decode_ring_buffer_matches_full_cache():
    """The reference's tests/test_attention.py ring case: SWA ring decode
    equals attention over the last W positions, in both packages."""
    rng = np.random.RandomState(5)
    B, H, K, hd, W = 2, 4, 2, 8, 8
    T_ = 4 * W
    ks = rng.randn(B, T_, K, hd).astype(np.float32)
    vs = rng.randn(B, T_, K, hd).astype(np.float32)
    q = rng.randn(B, 1, H, hd).astype(np.float32)
    pos = T_ - 1
    ring_k = np.zeros((B, W, K, hd), np.float32)
    ring_v = np.zeros((B, W, K, hd), np.float32)
    for p in range(T_ - W, T_):
        ring_k[:, p % W] = ks[:, p]
        ring_v[:, p % W] = vs[:, p]
    got = attn.decode_attention(torch.from_numpy(q), torch.from_numpy(ring_k),
                                torch.from_numpy(ring_v), pos, window=W)
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(ring_k),
                                  jnp.asarray(ring_v), pos, window=W)
    full = attn.decode_attention(torch.from_numpy(q),
                                 torch.from_numpy(ks[:, -W:]),
                                 torch.from_numpy(vs[:, -W:]), W - 1)
    np.testing.assert_allclose(_np(got), _np(want), **F32_ATTN)
    np.testing.assert_allclose(_np(got), _np(full), **F32_ATTN)


@pytest.mark.parametrize("window", [0, 8])
def test_cache_write_matches_reference(window):
    rng = np.random.RandomState(1)
    B, T_, K, hd = 2, 8, 2, 4
    kc = rng.randn(B, T_, K, hd).astype(np.float32)
    vc = rng.randn(B, T_, K, hd).astype(np.float32)
    kn = rng.randn(B, 1, K, hd).astype(np.float32)
    vn = rng.randn(B, 1, K, hd).astype(np.float32)
    for pos in ((3, 7) if not window else (3, 8, 21)):
        tk, tv = torch.from_numpy(kc), torch.from_numpy(vc)
        k2, v2 = attn.cache_write(tk, tv, torch.from_numpy(kn),
                                  torch.from_numpy(vn), pos, window)
        jk, jv = jattn.cache_write(jnp.asarray(kc), jnp.asarray(vc),
                                   jnp.asarray(kn), jnp.asarray(vn),
                                   jnp.int32(pos), window)
        np.testing.assert_array_equal(_np(k2), _np(jk))
        np.testing.assert_array_equal(_np(v2), _np(jv))
        # functional: the given caches are left as they were
        np.testing.assert_array_equal(tk.numpy(), kc)
        np.testing.assert_array_equal(tv.numpy(), vc)
    with pytest.raises(ValueError, match="full"):
        attn.cache_write(torch.from_numpy(kc), torch.from_numpy(vc),
                         torch.from_numpy(kn), torch.from_numpy(vn), T_)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,chunk", [(16, 16), (32, 8), (8, 32)])
def test_sliding_window_attention_matches_reference(window, chunk, dtype):
    rng = np.random.RandomState(2)
    S, H, K, hd = 64, 4, 2, 16
    q = rng.randn(2, S, H, hd).astype(np.float32)
    k = rng.randn(2, S, K, hd).astype(np.float32)
    v = rng.randn(2, S, K, hd).astype(np.float32)
    got = attn.sliding_window_attention(_t(q, dtype), _t(k, dtype),
                                        _t(v, dtype), window=window,
                                        chunk=chunk)
    want = jattn.sliding_window_attention(_j(q, dtype), _j(k, dtype),
                                          _j(v, dtype), window=window,
                                          chunk=chunk)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), **F32_ATTN)
    else:
        _close(_np(got), _np(want), dtype)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _moe_params(E, split, d, ff, seed):
    p, logical = jmoe.init_moe(jax.random.PRNGKey(seed), d, ff, E, split)
    return jax.tree.map(np.asarray, p), logical


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,k,split,cf,group", [
    (8, 2, 2, 1.25, 16),     # reduced Mixtral layout (split 2)
    (16, 2, 1, 1.25, 32),    # reduced phi-3.5-moe layout (split 1)
    (4, 2, 2, 0.25, 32),     # capacity 4 of 32 tokens: drops tokens
], ids=["mixtral", "phi35", "drops"])
def test_moe_apply_matches_reference(E, k, split, cf, group, dtype):
    rng = np.random.RandomState(3)
    B, S, d, ff = 2, 16, 16, 32
    p, _ = _moe_params(E, split, d, ff, seed=E + split)
    x = rng.randn(B, S, d).astype(np.float32)
    kw = dict(num_experts=E, top_k=k, split=split, capacity_factor=cf,
              group_size=group)
    y, aux = moe.moe_apply(state_from_numpy(p, "cpu"), _t(x, dtype), **kw)
    jy, jaux = jmoe.moe_apply(jax.tree.map(jnp.asarray, p), _j(x, dtype),
                              **kw)
    _close(_np(y), _np(jy), dtype)
    _close(_np(aux["moe_aux"]), _np(jaux["moe_aux"]), dtype)
    if cf < 1:
        # tokens over capacity get no expert output: some rows are 0
        dropped = np.all(_np(y) == 0, axis=-1)
        assert dropped.any() and (dropped == np.all(_np(jy) == 0, -1)).all()


def test_moe_matches_dense_reference_without_drops():
    """Generous capacity: the MoE output is the per-token mixture (the
    reference's tests/test_moe.py oracle), through the port's layer."""
    from test_moe import dense_reference

    rng = np.random.RandomState(0)
    for E, k, split in ((4, 2, 1), (8, 2, 2)):
        p, _ = _moe_params(E, split, 16, 32, seed=7)
        x = rng.randn(2, 8, 16).astype(np.float32)
        y, _ = moe.moe_apply(state_from_numpy(p, "cpu"), torch.from_numpy(x),
                             num_experts=E, top_k=k, split=split,
                             capacity_factor=8.0, group_size=16)
        np.testing.assert_allclose(_np(y), dense_reference(p, x, E, k, split),
                                   rtol=2e-3, atol=2e-3)


def test_topk_by_argmax_matches_reference():
    rng = np.random.RandomState(4)
    logits = rng.randn(3, 5, 8).astype(np.float32)
    logits[0, 0, [1, 5]] = 9.0          # a tie: the first index wins
    for k in (1, 2, 3):
        v, i = moe._topk_by_argmax(torch.from_numpy(logits), k)
        jv, ji = jmoe._topk_by_argmax(jnp.asarray(logits), k)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    assert i[0, 0, :2].tolist() == [1, 5]


# ---------------------------------------------------------------------------
# model: prefill and teacher-forced decode
# ---------------------------------------------------------------------------

SEQ, BATCH, DECODES = 64, 2, 4
# arch ids of the cases -> (config, reduced_config overrides)
# ("hymba-full": full attention, so prefill pads only the K/V caches
# with the decode margin, not the SSM state or conv tail; it runs in
# float32, where the pad's effect is held to rounding: in bfloat16 this
# case's decode logits drift from float32 in either package far more
# than the two packages differ, and the file's bfloat16 tolerance sits
# within that rounding noise)
VARIANTS = {"hymba-pad16": ("hymba-1.5b", dict(n_heads=25, n_kv_heads=5,
                                               head_dim=8, pad_to=16)),
            "hymba-full": ("hymba-1.5b", dict(sliding_window=0)),
            "rwkv-pad": ("rwkv6-3b", dict(n_heads=5, n_kv_heads=5,
                                          head_dim=8, pad_to=2)),
            "whisper-pad": ("whisper-large-v3", dict(n_heads=5, n_kv_heads=5,
                                                     head_dim=8, pad_to=8)),
            "vision-2g": ("llama-3.2-vision-11b", dict(n_layers=6,
                                                       cross_attn_every=3)),
            "vision-pad": ("llama-3.2-vision-11b", dict(
                n_heads=6, n_kv_heads=2, head_dim=8, pad_to=4))}


def _model(arch, dtype):
    arch, overrides = VARIANTS.get(arch, (arch, {}))
    jcfg = jreduced(JARCHS[arch], **overrides)
    cfg = reduced_config(ARCHS[arch], **overrides)
    params, _ = jT.init_params(jcfg, jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    kw = dict(loss_chunk=32, attn_chunk=16, dtype=dtype)
    rc = RunConfig(model=cfg, shape=ShapeConfig("s", SEQ, BATCH, "prefill"),
                   **kw)
    jrc = JRunConfig(model=jcfg, shape=JShape("s", SEQ, BATCH, "prefill"),
                     **kw)
    return jcfg, cfg, jrc, rc, params


def _batch(cfg, toks, seed=7):
    """Prefill inputs: the tokens, and for enc-dec models (B, Te, d) f32
    stub frames, for vision models (B, Tv, d) f32 stub patches, from a
    numpy seed (numpy in, numpy out)."""
    batch = {"tokens": toks}
    if cfg.enc_dec:
        batch["frames"] = np.random.RandomState(seed).randn(
            toks.shape[0], cfg.enc_positions, cfg.d_model).astype(np.float32)
    if cfg.cross_attn_every:
        batch["patches"] = np.random.RandomState(seed).randn(
            toks.shape[0], cfg.vision_tokens, cfg.d_model).astype(np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _jax_decode(jcfg, jrc, params, batch, toks):
    """The reference's prefill and teacher-forced decode: [(logits,
    state)] after the prefill and after each of DECODES steps."""
    jprefill, jserve = (jax.jit(f) for f in jmake_serve_steps(jcfg, jrc,
                                                              None))
    jparams = jax.tree.map(jnp.asarray, params)
    out = [jprefill(jparams, {k: jnp.asarray(v) for k, v in batch.items()})]
    for i in range(DECODES):
        tok = jnp.asarray(toks[:, SEQ + i:SEQ + i + 1])
        out.append(jserve(jparams, out[-1][1], tok))
    return out


@pytest.mark.parametrize("arch,dtype", [
    (arch, dtype)
    for arch in ("qwen2-0.5b", "mixtral-8x7b", "hymba-1.5b", "hymba-pad16",
                 "rwkv6-3b", "rwkv-pad", "whisper-large-v3", "whisper-pad")
    for dtype in ("float32", "bfloat16")] + [("hymba-full", "float32")])
def test_prefill_and_decode_match_reference(arch, dtype):
    jcfg, cfg, jrc, rc, params = _model(arch, dtype)
    toks = np.random.RandomState(1).randint(
        0, cfg.vocab_size, (BATCH, SEQ + DECODES)).astype(np.int32)
    batch = _batch(cfg, toks[:, :SEQ])
    prefill, serve = make_serve_steps(cfg, rc)
    tparams = state_from_numpy(params, "cpu")
    ref = _jax_decode(jcfg, jrc, params, batch, toks)
    if cfg.enc_dec and dtype == "bfloat16":
        # the reference's own accuracy (module docstring)
        exact = _jax_decode(jcfg, dataclasses.replace(jrc, dtype="float32"),
                            params, batch, toks)

        def close(got, i, leaf):
            want = [o[1]["layers"][leaf] if leaf else o[0] for o in
                    (ref[i], exact[i])]
            ours, theirs = _rel(got, want[1]), _rel(want[0], want[1])
            assert ours <= 1.25 * theirs + 1e-2, (i, leaf, ours, theirs)
    else:
        def close(got, i, leaf):
            _close(got, _np(ref[i][1]["layers"][leaf] if leaf else ref[i][0]),
                   dtype)

    tl, ts = prefill(tparams, _torch_batch(batch))
    close(_np(tl), 0, None)
    for i in range(DECODES):
        js = ref[i][1]
        assert int(ts["pos"]) == int(js["pos"]) == SEQ + i
        assert ts["pos"].dtype == torch.int32 and ts["pos"].dim() == 0
        assert sorted(ts["layers"]) == sorted(js["layers"])
        for key, c in ts["layers"].items():
            assert str(c.dtype) == f"torch.{js['layers'][key].dtype}"
            close(_np(c), i, key)
        tok = toks[:, SEQ + i:SEQ + i + 1]        # teacher forcing
        tl, ts = serve(tparams, ts, torch.from_numpy(tok))
        assert tl.shape == (BATCH, 1, cfg.vocab_padded)
        close(_np(tl), i + 1, None)
    if cfg.sliding_window:
        # the ring wrapped: positions SEQ.. went to slots 0..DECODES-1
        assert ts["layers"]["k"].shape[2] == cfg.sliding_window < SEQ


def test_decode_state_layout_matches_reference():
    for arch in ("qwen2-0.5b", "mixtral-8x7b", "hymba-1.5b", "hymba-pad16",
                 "rwkv6-3b", "rwkv-pad", "whisper-large-v3", "whisper-pad",
                 "llama-3.2-vision-11b", "vision-2g", "vision-pad"):
        jcfg, cfg, jrc, rc, _ = _model(arch, "bfloat16")
        shape = ShapeConfig("d", 48, 3, "decode")
        ours = T.init_decode_state(cfg, shape, rc, device="cpu")
        theirs = jT.init_decode_state(jcfg, JShape("d", 48, 3, "decode"), jrc)
        assert ours["pos"].shape == () and ours["pos"].dtype == torch.int32
        assert sorted(ours["layers"]) == sorted(theirs["layers"])
        for key, c in ours["layers"].items():
            assert tuple(c.shape) == theirs["layers"][key].shape
            assert str(c.dtype) == f"torch.{theirs['layers'][key].dtype}"
            assert not c.any()
        assert T.decode_state_logical(cfg) == jT.decode_state_logical(jcfg)
        assert T._kv_capacity(cfg, 48) == jT._kv_capacity(jcfg, 48)
        assert T.moe_split(cfg) == jT.moe_split(jcfg)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mixtral-8x7b", "hymba-1.5b",
                                  "hymba-pad16", "rwkv6-3b", "rwkv-pad",
                                  "whisper-large-v3", "whisper-pad"])
def test_decode_matches_prefill_continuation(arch):
    """Decode after a prefill of P tokens agrees with the last position
    of a forward over P + 1 tokens (tests/test_archs_smoke.py's check;
    for Mixtral P is the window, so the decode wraps the ring; for
    whisper both see the same frames)."""
    _, cfg, _, rc, params = _model(arch, "bfloat16")
    tparams = state_from_numpy(params, "cpu")
    P = cfg.sliding_window or 15
    toks = np.random.RandomState(1).randint(
        0, cfg.vocab_size, (2, P + 1)).astype(np.int32)
    prefill, serve = make_serve_steps(cfg, rc)
    _, st = prefill(tparams, _torch_batch(_batch(cfg, toks[:, :P])))
    dec, _ = serve(tparams, st, torch.from_numpy(toks[:, P:]))
    with torch.no_grad():
        x, _, _ = T.forward(tparams, cfg, rc, None,
                            _torch_batch(_batch(cfg, toks)))
        full = T._logits(tparams, cfg, x[:, -1])
    np.testing.assert_allclose(_np(full), _np(dec[:, 0]), rtol=0.12,
                               atol=0.15)


# ---------------------------------------------------------------------------
# live decode-state images in the port
# ---------------------------------------------------------------------------

def test_decode_step_leaves_its_state_unchanged():
    _check_decode_step_leaves_its_state("mixtral-8x7b")


def test_hybrid_decode_step_leaves_its_state_unchanged():
    """The same for hymba: the SSM state and conv tail too."""
    _check_decode_step_leaves_its_state("hymba-1.5b")


@pytest.mark.parametrize("arch", ["rwkv6-3b", "rwkv-pad"])
def test_rwkv_decode_step_leaves_its_state_unchanged(arch):
    """The same for rwkv: the `la` state and both token-shift states."""
    _check_decode_step_leaves_its_state(arch)


@pytest.mark.parametrize("arch", ["whisper-large-v3", "whisper-pad"])
def test_encdec_decode_step_leaves_its_state_unchanged(arch):
    """The same for whisper: the self K/V are copied and written, the
    cross K/V pass into the new state as they were, uncopied."""
    _check_decode_step_leaves_its_state(arch)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "vision-2g"])
def test_vision_decode_step_leaves_its_state_unchanged(arch):
    """The same for vision: the self blocks' K/V are copied and written,
    the cross blocks' cross K/V pass into the new state as they were,
    uncopied."""
    _check_decode_step_leaves_its_state(arch)


def _check_decode_step_leaves_its_state(arch):
    _, cfg, _, rc, params = _model(arch, "bfloat16")
    tparams = state_from_numpy(params, "cpu")
    prefill, serve = make_serve_steps(cfg, rc)
    toks = np.random.RandomState(2).randint(
        0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    _, st = prefill(tparams, _torch_batch(_batch(cfg, toks)))
    before = state_to_numpy(st)
    _, st2 = serve(tparams, st, torch.from_numpy(toks[:, :1]))
    after = state_to_numpy(st)
    assert sorted(after["layers"]) == sorted(
        ("la", "shift_a", "shift_c") if cfg.rwkv else
        ("k", "v", "ssm", "conv") if cfg.ssm_state else
        ("k", "v", "xk", "xv") if cfg.enc_dec or cfg.cross_attn_every else
        ("k", "v"))
    for key in after["layers"]:
        np.testing.assert_array_equal(after["layers"][key],
                                      before["layers"][key])
        if key in ("xk", "xv"):       # read-only: the same tensor
            assert st2["layers"][key] is st["layers"][key]
        else:
            assert not np.array_equal(state_to_numpy(st2)["layers"][key],
                                      before["layers"][key])
            assert (st2["layers"][key].data_ptr()
                    != st["layers"][key].data_ptr())
    assert int(st["pos"]) == SEQ and int(st2["pos"]) == SEQ + 1


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mixtral-8x7b", "hymba-1.5b",
                                  "rwkv6-3b", "rwkv-pad", "whisper-large-v3",
                                  "whisper-pad", "llama-3.2-vision-11b",
                                  "vision-2g"])
def test_snapshot_restore_continuation_is_bitwise(arch, tmp_path):
    """A full image at token 6 and an XOR-delta image at token 10; a fresh
    manager restores 10 through the chain, and tokens 11-15 with their
    logits equal the uninterrupted run's bit for bit (for whisper and
    vision the cross K/V's delta is all zero bytes, restored through the
    chain)."""
    _, cfg, _, rc, params = _model(arch, "bfloat16")
    tparams = state_from_numpy(params, "cpu")
    prefill, serve = make_serve_steps(cfg, rc)
    toks = np.random.RandomState(3).randint(
        0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    logits, st = prefill(tparams, _torch_batch(_batch(cfg, toks)))
    mgr = CheckpointManager(str(tmp_path), delta_keys=("decode",),
                            device="cpu")
    logical = {"decode": T.decode_state_logical(cfg)}
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    outs, gen = [], []
    for i in range(16):
        logits, st = serve(tparams, st, tok)
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        outs.append(logits)
        gen.append(tok)
        if i in (6, 10):
            mgr.save(i, {"decode": st}, logical)
            saved = st
    assert mgr.stats[-1]["bytes"] == mgr.stats[0]["bytes"]
    restored, _ = CheckpointManager(str(tmp_path), device="cpu").restore(10)
    st2 = restored["decode"]
    assert st2["pos"].shape == () and int(st2["pos"]) == SEQ + 11
    for key, c in saved["layers"].items():
        assert torch.equal(st2["layers"][key], c), key
    tok2 = gen[10]
    for i in range(11, 16):
        logits2, st2 = serve(tparams, st2, tok2)
        tok2 = torch.argmax(logits2[:, -1], -1).to(torch.int32)[:, None]
        assert torch.equal(logits2, outs[i]) and torch.equal(tok2, gen[i])


def test_serve_example_runs_on_cpu(tmp_path, capsys):
    from repro_torch.examples import serve_with_snapshot

    assert serve_with_snapshot.main(["--device", "cpu", "--ckpt-dir",
                                     str(tmp_path)]) == 0
    assert "matches original: True" in capsys.readouterr().out
