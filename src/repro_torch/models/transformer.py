"""Model assembly for dense, MoE, hybrid-SSM, attention-free (RWKV-6),
encoder-decoder and vision cross-attention models: init, forward,
forward_loss, and the serving entry points prefill and decode_step.

Port of `repro.models.transformer`, every family (GQA, optional QKV
bias, RoPE, SwiGLU or routed experts, full causal or sliding-window
attention, tied or untied head; hybrid blocks run Mamba-2-style SSM
heads, `repro_torch.models.mamba`, beside attention on the same normed
input and average the two; rwkv blocks are a time-mix and a
channel-mix, `repro_torch.models.rwkv`, with no attention and no K/V
cache; enc-dec models run a non-causal encoder over stub frame
embeddings plus sinusoidal positions, and each decoder block adds cross
attention to the encoder's output between self-attention and the MLP;
vision models run groups of `cross_attn_every - 1` self blocks and one
cross block, which adds cross attention to stub image-patch embeddings,
`batch["patches"]`, given as they are).  A `layer_types` model
(granite-4.0-h, no reference in the JAX package) runs its own stack:
Mamba-2 blocks (`repro_torch.models.mamba2`) and GQA attention blocks
without positions, each followed by the MLP, in the published order,
with the embedding, residual and logit multipliers; it trains and
checkpoints, and its serving entry points raise NotImplementedError.
Parameter names, shapes, dtypes and the logical-axes trees (params and
decode state) are the reference's: blocks are stacked on a leading (L,
...) layer axis (a vision model's self blocks on (G, per-1, ...), its
cross blocks on (G, ...); a `layer_types` model's Mamba-2 and attention
blocks on one axis each, `params/mamba_blocks/...` and
`params/attn_blocks/...`) and heads are stored padded
(`cfg.n_heads_padded`, `cfg.n_kv_heads_padded`), so every flattened
leaf path
(`params/blocks/attn/wq`, `params/blocks/xattn/wk`,
`params/enc_blocks/mlp/wi`, `params/blocks/tm/wr`,
`params/self_blocks/attn/wq`, `params/cross_blocks/lnx`,
`decode/layers/k`, `decode/layers/xk`, `decode/layers/ssm`,
`decode/layers/la`, ...) is the same in both packages and images move
between them.

Decode is functional, as the reference's: `decode_step` returns a new
state and leaves the one it was given as it was (a live image taken
between two steps depends on that).  It copies the stacked caches that
a step writes once per step and writes the new token's K/V into that
copy at a host integer slot, a hybrid block's new SSM state and conv
tail, and an rwkv block's new `la` state and token-shift states, over
its layer's slices of the copy; the cross K/V (`xk`, `xv`), written
once by prefill, pass into the new state uncopied (the reference's
`dict(lcache)`).  `pos` is read to the host once per step.  A vision
model's cross layer decodes as the reference's does, as pure cross
attention: no `ln1`, no self-attention and no self K/V (its forward
runs them; ROADMAP.md section C).

Remat: with `rc.remat_policy` other than "none", each block (encoder
blocks too) runs under `torch.utils.checkpoint` (non-reentrant) with
its inputs as its only arguments: a decoder block's inputs are its
stream and the encoder's output (or the image patches), so the gradient
of all its cross attentions reaches the encoder.  "full" saves only
those inputs; "dots" also every matrix product's output; "comm" the
block outputs "attn_out" (after the attention output projection),
"mixer_out" (a hybrid block's mean of attention and SSM heads) and
"mlp_out" (the MLP's or the experts' combined output), each marked
where it is made (`repro_torch.models.remat`); an rwkv block names
none, so under "comm" it saves only its inputs, as in the reference.
The gradients are the same bits under all three.

On a mesh (`rules` set, leaves DTensors), every family trains.  Each
block's input, an encoder block's too, is placed by its logical axes
("batch", "seq", None) with `constrain` (`repro_torch.sharding.rules`),
the reference's `with_sharding_constraint` sites, as a `redistribute`:
values do not change, only placement (an rwkv block has no other site,
as in the reference; the MoE dispatch has its four,
`repro_torch.models.moe`).  The frames or patches arrive split over the
data axes like the tokens; cross attention places its queries and the
encoder's (or the patches') keys alike on the batch, every rank
attending over all Te keys with its own query heads; the encoder
output's gradient sums every decoder block's, each a DTensor partial
sum over "model" where the K/V projections split heads.  Where the
query heads split over "model" more finely than the K groups, each rank
projects and attends only the KV heads of its own query heads
(`attention.kv_for_query_heads`; a prefill keeps every head's K/V for
its caches and picks them in the attention).  Under FSDP (`rc.fsdp`:
params split over the data axes too) a stack whose layer dim is split
moves that split to another dim once a step, and each block gathers
its own layer's leaves over the data axes at its use, inside its remat,
as the final norms and the head are gathered at theirs
(`sharding.rules.off_lead_dims`, `gather_over_data`); the gradients come
back reduced onto the shards.  These run on each rank's local shards,
each for a reason a real run showed (ROADMAP.md section C): the
embedding (`layers._MeshEmbedGather`), each attention, self or cross
(`attention._on_mesh`), the MoE expert MLP (`moe._experts`) and the
chunked linear-attention engine of the hybrid and rwkv blocks
(`linear_attention._on_local_shards`); every other op propagates its
DTensor sharding.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device, trace
from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import mamba as mam
from repro_torch.models import mamba2
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.remat import checkpoint_kwargs, checkpoint_name
from repro_torch.sharding.rules import (constrain, gather_over_data,
                                       off_lead_dims)
from repro_torch.tree import tree_map


# ==========================================================================
# Init
# ==========================================================================


def moe_split(cfg: ModelConfig, model_axis: int = 16) -> int:
    """Virtual-expert split so E*split % model_axis == 0 (the reference's
    layout, kept so images move between the packages)."""
    if cfg.moe is None:
        return 1
    e = cfg.moe.num_experts
    if e % model_axis == 0:
        return 1
    g = math.gcd(e, model_axis)
    return model_axis // g


def _init_dense_blocks(gen, cfg: ModelConfig, device, n: int,
                       cross: bool):
    """`n` stacked (L, ...) dense, MoE or hybrid blocks, with cross
    attention (`lnx`, `xattn`: no QKV bias) if `cross`: the reference's
    vmapped per-layer init, drawn as one tensor per leaf."""
    params: Dict[str, Any] = {"ln1": L._norm_init((n, cfg.d_model), device),
                              "ln2": L._norm_init((n, cfg.d_model), device)}
    logical: Dict[str, Any] = {"ln1": (None,), "ln2": (None,)}
    params["attn"], logical["attn"] = attn.init_attention(
        gen, cfg.d_model, cfg.n_heads_padded, cfg.n_kv_heads_padded,
        cfg.head_dim, cfg.qkv_bias, device=device, stack=n)
    if cfg.ssm_state:
        params["mamba"], logical["mamba"] = mam.init_mamba(
            gen, cfg.d_model, cfg.ssm_state, cfg.ssm_expand, device=device,
            stack=n)
    if cross:
        params["lnx"] = L._norm_init((n, cfg.d_model), device)
        logical["lnx"] = (None,)
        params["xattn"], logical["xattn"] = attn.init_attention(
            gen, cfg.d_model, cfg.n_heads_padded, cfg.n_kv_heads_padded,
            cfg.head_dim, device=device, stack=n)
    if cfg.moe is not None:
        params["moe"], logical["moe"] = moe_mod.init_moe(
            gen, cfg.d_model, cfg.d_ff, cfg.moe.num_experts, moe_split(cfg),
            device=device, stack=n)
    else:
        params["mlp"], logical["mlp"] = L.init_mlp(
            gen, cfg.d_model, cfg.d_ff, device=device, stack=n)
    logical = _prepend_layers(logical)
    return params, logical


def _init_rwkv_blocks(gen, cfg: ModelConfig, device):
    """Stacked (L, ...) rwkv blocks: the reference's vmapped per-layer
    init, drawn as one tensor per leaf."""
    n = cfg.n_layers
    params: Dict[str, Any] = {"ln1": L._norm_init((n, cfg.d_model), device),
                              "ln2": L._norm_init((n, cfg.d_model), device)}
    logical: Dict[str, Any] = {"ln1": (None,), "ln2": (None,)}
    params["tm"], logical["tm"] = rwkv_mod.init_rwkv_time_mix(
        gen, cfg.d_model, cfg.n_heads_padded, cfg.head_dim, device=device,
        stack=n)
    params["cm"], logical["cm"] = rwkv_mod.init_rwkv_channel_mix(
        gen, cfg.d_model, cfg.d_ff, device=device, stack=n)
    return params, _prepend_layers(logical)


def _init_hybrid_stacks(gen, cfg: ModelConfig, device):
    """The `layer_types` stack's blocks: "mamba_blocks" (Mamba-2 mixer
    and MLP) and "attn_blocks" (GQA attention and MLP), each kind
    stacked on its own leading (L_kind, ...) axis in layer order."""
    params: Dict[str, Any] = {}
    logical: Dict[str, Any] = {}
    for kind, key in (("mamba", "mamba_blocks"), ("attention", "attn_blocks")):
        n = cfg.layer_types.count(kind)
        p: Dict[str, Any] = {"ln1": L._norm_init((n, cfg.d_model), device),
                             "ln2": L._norm_init((n, cfg.d_model), device)}
        lg: Dict[str, Any] = {"ln1": (None,), "ln2": (None,)}
        if kind == "mamba":
            p["mamba"], lg["mamba"] = mamba2.init_mamba2(gen, cfg, device=device,
                                                       stack=n)
        else:
            p["attn"], lg["attn"] = attn.init_attention(
                gen, cfg.d_model, cfg.n_heads_padded, cfg.n_kv_heads_padded,
                cfg.head_dim, cfg.qkv_bias, device=device, stack=n)
        p["mlp"], lg["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff,
                                         device=device, stack=n)
        params[key], logical[key] = p, _prepend_layers(lg)
    return params, logical


def _prepend_layers(logical):
    if isinstance(logical, dict):
        return {k: _prepend_layers(v) for k, v in logical.items()}
    return ("layers",) + logical


def init_params(cfg: ModelConfig, generator, device) -> Tuple[Dict, Dict]:
    """Returns (params, logical_axes) trees.  `generator` None (for the
    meta device) makes shapes only."""
    params: Dict[str, Any] = {}
    logical: Dict[str, Any] = {}
    params["embed"], logical["embed"] = L.init_embed(
        generator, cfg.vocab_padded, cfg.d_model, cfg.tie_embeddings,
        device=device)
    params["ln_f"] = L._norm_init((cfg.d_model,), device)
    logical["ln_f"] = (None,)
    if cfg.rwkv:
        params["blocks"], logical["blocks"] = _init_rwkv_blocks(
            generator, cfg, device)
    elif cfg.layer_types:
        hybrid, lg = _init_hybrid_stacks(generator, cfg, device)
        params.update(hybrid)
        logical.update(lg)
    elif cfg.cross_attn_every:
        # G groups of (per - 1) self blocks + 1 cross block; the layers
        # past G * per are dropped, as in the reference
        per = cfg.cross_attn_every
        G = cfg.n_layers // per
        selfs, lg = _init_dense_blocks(generator, cfg, device, G * (per - 1),
                                       cross=False)
        params["self_blocks"] = tree_map(
            lambda t: t.reshape(G, per - 1, *t.shape[1:]), selfs)
        logical["self_blocks"] = _prepend_layers(lg)
        params["cross_blocks"], logical["cross_blocks"] = _init_dense_blocks(
            generator, cfg, device, G, cross=True)
    else:
        params["blocks"], logical["blocks"] = _init_dense_blocks(
            generator, cfg, device, cfg.n_layers, cross=cfg.enc_dec)
    if cfg.enc_dec:
        params["enc_blocks"], logical["enc_blocks"] = _init_dense_blocks(
            generator, cfg, device, cfg.n_enc_layers, cross=False)
        params["enc_ln_f"] = L._norm_init((cfg.d_model,), device)
        logical["enc_ln_f"] = (None,)
    return params, logical


# ==========================================================================
# Full-sequence block application (train / prefill)
# ==========================================================================


def _self_attention_seq(cfg: ModelConfig, rc: RunConfig, p, h, positions,
                        causal: bool, keep_kv: bool = True):
    """-> (out, (k, v)); without `keep_kv` (training) the K/V of a mesh
    rank are only those its query heads read
    (`attn.kv_for_query_heads`)."""
    if not keep_kv:
        p = attn.kv_for_query_heads(p)
    q, k, v = attn.qkv_proj(p, h, cfg.rope_theta, positions)
    S = h.shape[1]
    if cfg.sliding_window and causal and cfg.sliding_window < S:
        o = attn.sliding_window_attention(
            q, k, v, window=cfg.sliding_window, chunk=rc.attn_chunk)
    else:
        o = attn.flash_attention(q, k, v, causal=causal, chunk=rc.attn_chunk)
    o = o * attn.head_mask(cfg, o.device)[None, None, :, None].to(o.dtype)
    with checkpoint_name("attn_out"):
        return attn.out_proj(p, o), (k, v)


def _to_stream(y, rules):
    """A sub-block's output placed as the residual stream, ("batch",
    "seq", None), before it is added, and its gradient placed the same
    way in the backward.  On a mesh the output projections contract a
    dim split over "model" and leave a partial sum, and so do the
    gradients of the input projections: reduced here, where the
    reference's partitioner reduces them (its sharding constraint
    transposes to one on the cotangent).  Left partial, the stream or
    its gradient would reach the next products partial, and those would
    gather their weights whole over "model" (the dry-run counted 1.2x
    the reference's per-device dot FLOPs on a (2 x 2) mesh)."""
    if rules is None or not hasattr(y, "device_mesh"):
        return y
    return L.hold_placements(y, rules.mesh, rules.named(
        ("batch", "seq", None), y.shape).placements)


def _cross_attention_seq(cfg, rc, p, h, enc_out, keep_kv: bool = True):
    """Decoder queries (B,S) against the encoder's keys (B,Te): no RoPE,
    no bias, non-causal.  Returns (out, (k, v)), k/v (B,Te,K,hd) with
    `keep_kv`, else as `_self_attention_seq`'s."""
    if not keep_kv:
        p = attn.kv_for_query_heads(p)
    dt = h.dtype
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", enc_out, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", enc_out, p["wv"].to(dt))
    o = attn.flash_attention(q, k, v, causal=False, chunk=rc.attn_chunk)
    o = o * attn.head_mask(cfg, o.device)[None, None, :, None].to(o.dtype)
    return attn.out_proj(p, o), (k, v)


def _ffn(cfg, rules, p, h):
    """The block's MLP or routed experts -> (y, aux)."""
    if "moe" in p:
        return moe_mod.moe_apply(
            p["moe"], h, num_experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
            split=moe_split(cfg), capacity_factor=cfg.moe.capacity_factor,
            rules=rules)
    return L.mlp_apply(p["mlp"], h), {}


def _mixer_block_seq(cfg, rc, rules, p, x, positions, enc_out=None,
                     causal=True, keep_kv=True):
    """One dense/MoE/hybrid block over a full sequence; a block with
    `xattn` attends to `enc_out` (B,Te,d) after self-attention.

    Returns (x, aux, cache): cache holds what prefill must keep (with
    `keep_kv`: the K/V of every head)."""
    cache = {}
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    a_out, (k, v) = _self_attention_seq(cfg, rc, p["attn"], h, positions,
                                        causal, keep_kv)
    if cfg.ssm_state:
        m_out, cache["ssm"], cache["conv"] = mam.mamba_apply(
            p["mamba"], h, chunk=rc.la_chunk)
        a_out = a_out + m_out
        with checkpoint_name("mixer_out"):
            a_out = _to_stream(a_out * 0.5, rules)
    else:
        with checkpoint_name("attn_out"):
            a_out = _to_stream(a_out, rules)
    x = x + a_out
    if "xattn" in p and enc_out is not None:
        hx = L.rms_norm(x, p["lnx"], cfg.norm_eps)
        x_out, (cache["xk"], cache["xv"]) = _cross_attention_seq(
            cfg, rc, p["xattn"], hx, enc_out, keep_kv)
        x = x + _to_stream(x_out, rules)
    h2 = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    y, aux = _ffn(cfg, rules, p, h2)
    with checkpoint_name("mlp_out"):
        y = _to_stream(y, rules)
    x = x + y
    # prefill KV cache: SWA keeps the last `window` positions (ring layout)
    if cfg.sliding_window and causal:
        k, v = k[:, -cfg.sliding_window:], v[:, -cfg.sliding_window:]
    cache["k"], cache["v"] = k, v
    return x, aux, cache


def _rwkv_block_seq(cfg, rc, rules, p, x):
    """One rwkv block over a full sequence -> (x, aux, cache): the final
    `la` state and the two token-shift states."""
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    tm_out, la, shift_a = rwkv_mod.rwkv_time_mix(
        p["tm"], h, chunk=rc.la_chunk, mask=attn.head_mask(cfg, x.device))
    x = x + _to_stream(tm_out, rules)
    h2 = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    cm_out, shift_c = rwkv_mod.rwkv_channel_mix(p["cm"], h2)
    return (x + _to_stream(cm_out, rules), {},
            {"la": la, "shift_a": shift_a, "shift_c": shift_c})


def _layer_params(blocks, i: int):
    if isinstance(blocks, dict):
        return {k: _layer_params(v, i) for k, v in blocks.items()}
    return blocks[i]


def _remat(rc, fn, *args):
    """fn(*args), under the per-block checkpoint where autograd records
    and `rc.remat_policy` asks for remat; every tensor the block reads
    is among `args`."""
    if rc.remat_policy == "none" or not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, **checkpoint_kwargs(rc.remat_policy))


def _encode(params, cfg, rc, rules, frames):
    """Encoder over stub frame embeddings (B,Te,d), given in the compute
    dtype: sinusoidal positions cast to it and added, non-causal blocks
    without cross attention, then `enc_ln_f`."""
    Te = frames.shape[1]
    x = frames + L.sinusoidal_positions(Te, cfg.d_model,
                                        frames.device).to(frames.dtype)
    positions = torch.arange(Te, device=frames.device)
    blocks = _unbind_layers(off_lead_dims(params["enc_blocks"]))

    def block(x, p):
        x = constrain(x, rules, ("batch", "seq", None))
        return _mixer_block_seq(cfg, rc, rules, gather_over_data(p), x,
                                positions, None, causal=False,
                                keep_kv=False)[0]

    for i in range(cfg.n_enc_layers):
        x = _remat(rc, block, x, _layer_params(blocks, i))
    return L.rms_norm(x, gather_over_data(params["enc_ln_f"]), cfg.norm_eps)


def _hybrid_block(cfg, rc, kind: str, i: int, p, x, positions, outer):
    """One block of the `layer_types` stack: pre-norm mixer (Mamba-2 or
    GQA attention without positions, q scaled by `attention_multiplier`),
    then pre-norm MLP, each added to the stream times
    `residual_multiplier`.  `i` is the block's layer index, `outer` the
    forward's span (`mamba2.mamba2_apply`'s parent)."""
    rm = cfg.residual_multiplier
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "mamba":
        y = mamba2.mamba2_apply(p["mamba"], h, cfg, layer=i, parent=outer)
    else:
        q, k, v = attn.qkv_proj(p["attn"], h, cfg.rope_theta, positions,
                                rope=cfg.rope)
        o = attn.flash_attention(q, k, v, causal=True, chunk=rc.attn_chunk,
                                 scale=cfg.attention_multiplier or None)
        o = o * attn.head_mask(cfg, o.device)[None, None, :, None].to(o.dtype)
        y = attn.out_proj(p["attn"], o)
    x = x + y * rm
    return x + L.mlp_apply(p["mlp"], L.rms_norm(x, p["ln2"], cfg.norm_eps)) * rm


def _hybrid_forward(params, cfg, rc, x, positions):
    """The `layer_types` stack over the stream x, each block under the
    remat policy, in the published order."""
    stacks = {"mamba": _unbind_layers(params["mamba_blocks"]),
              "attention": _unbind_layers(params["attn_blocks"])}
    seen = {"mamba": 0, "attention": 0}
    outer = trace.current()
    for i, kind in enumerate(cfg.layer_types):
        p = _layer_params(stacks[kind], seen[kind])
        seen[kind] += 1
        x = _remat(rc, lambda x, p, kind=kind, i=i: _hybrid_block(
            cfg, rc, kind, i, p, x, positions, outer), x, p)
    return x


def _no_serving(cfg: ModelConfig, what: str) -> None:
    if cfg.layer_types:
        raise NotImplementedError(
            f"{what} of a `layer_types` model ({cfg.arch_id}): its decode "
            "state (a KV cache beside SSM and conv states) is not built; "
            "it trains and checkpoints only")


def forward(params, cfg: ModelConfig, rc: RunConfig, rules, batch,
            want_cache: bool = False):
    """Full-sequence forward.  batch: tokens (B,S) [+ frames (B,Te,d) |
    patches (B,Tv,d)].

    Returns (hidden (B,S,d), aux-losses, caches | None); caches are
    {"k", "v"} stacked (L, B, T, K, hd), for enc-dec models also the
    cross K/V {"xk", "xv"} (L, B, Te, K, hd), for hybrid blocks {"ssm"}
    (L, B, H, N, hd) f32 and {"conv"} (L, B, 3, d_in); for rwkv blocks
    {"la"} (L, B, H, hd, hd) f32 and {"shift_a", "shift_c"} (L, B, d);
    for vision models the self blocks' {"k", "v"} (G, per-1, B, T, K,
    hd) and the cross blocks' {"xk", "xv"} (G, B, Tv, K, hd)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    dtype = getattr(torch, rc.dtype)
    x = L.embed_apply(params["embed"], tokens, dtype)
    if cfg.embedding_multiplier != 1.0:
        x = x * cfg.embedding_multiplier
    x = constrain(x, rules, ("batch", "seq", None))
    positions = torch.arange(S, device=tokens.device)
    if cfg.layer_types:
        if want_cache or rules is not None:
            raise NotImplementedError(
                "a `layer_types` model runs its forward without caches and "
                "without a mesh")
        x = _hybrid_forward(params, cfg, rc, x, positions)
        return (L.rms_norm(x, params["ln_f"], cfg.norm_eps),
                {"moe_aux": torch.zeros((), dtype=torch.float32,
                                        device=x.device)}, None)
    enc_out = None
    if cfg.enc_dec:
        enc_out = _encode(params, cfg, rc, rules, batch["frames"].to(dtype))
    if cfg.cross_attn_every:
        enc_out = batch["patches"].to(dtype)

    zero = torch.zeros((), dtype=torch.float32, device=x.device)

    def block(x, p, enc_out):
        x = constrain(x, rules, ("batch", "seq", None))
        p = gather_over_data(p)
        if cfg.rwkv:
            x, aux, cache = _rwkv_block_seq(cfg, rc, rules, p, x)
        else:
            x, aux, cache = _mixer_block_seq(cfg, rc, rules, p, x, positions,
                                             enc_out, keep_kv=want_cache)
        return x, aux.get("moe_aux", zero), cache

    moe_aux = zero
    caches, self_caches = [], []
    for p, group_self in _layer_order(params, cfg):
        e = None if group_self else enc_out
        if want_cache:
            x, a, cache = block(x, p, e)
            (self_caches if group_self else caches).append(cache)
        else:
            x, a = _remat(rc, lambda x, p, e: block(x, p, e)[:2], x, p, e)
        if not group_self:      # the reference counts no self block's aux
            moe_aux = moe_aux + a
    x = L.rms_norm(x, gather_over_data(params["ln_f"]), cfg.norm_eps)
    stacked = None
    if want_cache and cfg.cross_attn_every:
        # a cross block's own K/V are not kept, as in the reference
        stacked = {key: t.unflatten(0, (len(caches), -1)) for key, t in
                   _stack(self_caches, ("k", "v")).items()}
        stacked.update(_stack(caches, ("xk", "xv")))
    elif want_cache:
        stacked = _stack(caches, caches[0])
    return x, {"moe_aux": moe_aux}, stacked


def _stack(caches, keys):
    return {key: torch.stack([c[key] for c in caches]) for key in keys}


def _layer_order(params, cfg):
    """The decoder's blocks in the order they run, as (params,
    group_self) pairs.  `group_self` marks a vision group's self block:
    it sees no patches, and its MoE aux is not counted (the reference's
    `self_body`).  Each stacked leaf is unbound once: its backward stacks
    the layer grads in one pass instead of one full-size scatter a
    layer.  Under FSDP a stack whose layer dim is split over the data
    axes first moves that split to another dim (`off_lead_dims`), and
    each block gathers its own layer's leaves at its use
    (`gather_over_data`, inside the block's remat)."""
    if not cfg.cross_attn_every:
        blocks = _unbind_layers(off_lead_dims(params["blocks"]))
        return [(_layer_params(blocks, i), False)
                for i in range(cfg.n_layers)]
    per = cfg.cross_attn_every - 1
    selfs = _unbind_layers(tree_map(lambda t: t.flatten(0, 1), off_lead_dims(
        params["self_blocks"], 2)))
    crosses = _unbind_layers(off_lead_dims(params["cross_blocks"]))
    order = []
    for g in range(cfg.n_layers // cfg.cross_attn_every):
        order += [(_layer_params(selfs, g * per + j), True)
                  for j in range(per)]
        order.append((_layer_params(crosses, g), False))
    return order


def _unbind_layers(tree):
    if isinstance(tree, dict):
        return {k: _unbind_layers(v) for k, v in tree.items()}
    return tree.unbind(0)


def forward_loss(params, cfg, rc, rules, batch):
    """Next-token cross entropy (sequence-chunked; no (B,S,V) tensor),
    plus 0.01 * the mean MoE load-balance loss for MoE configs."""
    x, aux, _ = forward(params, cfg, rc, rules, batch)
    if cfg.logits_scaling != 1.0:
        # logits / s, as (x / s) @ head: the same bits for a power of two
        x = x / cfg.logits_scaling
    head = gather_over_data(L.head_matrix(params["embed"]))
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(batch["labels"].shape, dtype=torch.float32,
                          device=x.device)
    tot, cnt = L.chunked_softmax_xent(x, head, batch["labels"], mask,
                                      rc.loss_chunk,
                                      valid_vocab=cfg.vocab_size)
    loss = tot / torch.clamp(cnt, min=1.0)
    if cfg.moe is not None:
        loss = loss + 0.01 * aux["moe_aux"] / cfg.n_layers
    return loss, {"xent": tot / torch.clamp(cnt, min=1.0),
                  "moe_aux": aux["moe_aux"]}


# ==========================================================================
# Decode state + single-token decode
# ==========================================================================


def _kv_capacity(cfg: ModelConfig, seq_len: int) -> int:
    return min(cfg.sliding_window, seq_len) if cfg.sliding_window else seq_len


def init_decode_state(cfg: ModelConfig, shape: ShapeConfig, rc: RunConfig,
                      device=None):
    """Zero-initialized decode caches for a (arch, shape) cell, layout
    (L, B, T, K, hd), plus for hybrid blocks the SSM state (L, B, H, N,
    d_in/H) f32 and the conv tail (L, B, 3, d_in), for enc-dec models the
    cross K/V (L, B, Te, K, hd); for rwkv blocks no K/V, but the `la`
    state (L, B, H, hd, hd) f32 and the token-shift states (L, B, d); for
    vision models the self blocks' K/V (G, per-1, B, T, K, hd) and the
    cross blocks' cross K/V (G, B, Tv, K, hd), nothing else.  On `device`
    (None -> cuda, or raises).  A `layer_types` model raises
    NotImplementedError."""
    _no_serving(cfg, "init_decode_state")
    device = resolve_device(device)
    Lh, B = cfg.n_layers, shape.global_batch
    dt = getattr(torch, rc.dtype)
    pos = torch.zeros((), dtype=torch.int32, device=device)
    if cfg.rwkv:
        hd = cfg.head_dim
        return {"pos": pos, "layers": {
            "la": torch.zeros((Lh, B, cfg.n_heads_padded, hd, hd),
                              dtype=torch.float32, device=device),
            "shift_a": torch.zeros((Lh, B, cfg.d_model), dtype=dt,
                                   device=device),
            "shift_c": torch.zeros((Lh, B, cfg.d_model), dtype=dt,
                                   device=device)}}
    T = _kv_capacity(cfg, shape.seq_len)
    if cfg.cross_attn_every:
        per = cfg.cross_attn_every
        G, Kp, hd = cfg.n_layers // per, cfg.n_kv_heads_padded, cfg.head_dim
        kv_shape = (G, per - 1, B, T, Kp, hd)
        xkv = (G, B, cfg.vision_tokens, Kp, hd)
        return {"pos": pos, "layers": {
            "k": torch.zeros(kv_shape, dtype=dt, device=device),
            "v": torch.zeros(kv_shape, dtype=dt, device=device),
            "xk": torch.zeros(xkv, dtype=dt, device=device),
            "xv": torch.zeros(xkv, dtype=dt, device=device)}}
    kv_shape = (Lh, B, T, cfg.n_kv_heads_padded, cfg.head_dim)
    layers = {"k": torch.zeros(kv_shape, dtype=dt, device=device),
              "v": torch.zeros(kv_shape, dtype=dt, device=device)}
    if cfg.ssm_state:
        d_in = cfg.ssm_expand * cfg.d_model
        nh = mam.mamba_heads(d_in)
        layers["ssm"] = torch.zeros((Lh, B, nh, cfg.ssm_state, d_in // nh),
                                    dtype=torch.float32, device=device)
        layers["conv"] = torch.zeros((Lh, B, mam.CONV_W - 1, d_in), dtype=dt,
                                     device=device)
    if cfg.enc_dec:
        xkv = (Lh, B, cfg.enc_positions, cfg.n_kv_heads_padded, cfg.head_dim)
        layers["xk"] = torch.zeros(xkv, dtype=dt, device=device)
        layers["xv"] = torch.zeros(xkv, dtype=dt, device=device)
    return {"pos": pos, "layers": layers}


def decode_state_logical(cfg: ModelConfig):
    """Logical axes for the decode state (for the checkpoint manifest)."""
    if cfg.rwkv:
        return {"pos": (), "layers": {
            "la": (None, "batch", "heads", None, None),
            "shift_a": (None, "batch", None),
            "shift_c": (None, "batch", None)}}
    if cfg.cross_attn_every:
        kv6 = (None, None, "batch", "cache_time", "kv_heads", None)
        xkv = (None, "batch", None, "kv_heads", None)
        return {"pos": (), "layers": {"k": kv6, "v": kv6, "xk": xkv,
                                      "xv": xkv}}
    kv = (None, "batch", "cache_time", "kv_heads", None)
    lay = {"k": kv, "v": kv}
    if cfg.ssm_state:
        lay["ssm"] = (None, "batch", "heads", None, None)
        lay["conv"] = (None, "batch", None, "d_inner")
    if cfg.enc_dec:
        lay["xk"] = lay["xv"] = kv
    return {"pos": (), "layers": lay}


def _decode_mixer_block(cfg, rc, rules, p, x, lcache, pos: int):
    """One block, one token.  Writes the token's K/V, and a hybrid
    block's new SSM state and conv tail, into `lcache` (this layer's
    slices of the step's own copy of the caches) in place; an enc-dec
    block's cross step reads its `xk`/`xv` (all Te positions)."""
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                           device=x.device)
    q, k, v = attn.qkv_proj(p["attn"], h, cfg.rope_theta, positions)
    attn.write_slot_(lcache["k"], lcache["v"], k, v, pos, cfg.sliding_window)
    o = attn.decode_attention(q, lcache["k"], lcache["v"], pos,
                              cfg.sliding_window)
    o = o * attn.head_mask(cfg, o.device)[None, None, :, None].to(o.dtype)
    a_out = attn.out_proj(p["attn"], o)
    if cfg.ssm_state:
        m_out, conv, ssm = mam.mamba_decode_step(
            p["mamba"], h, lcache["conv"], lcache["ssm"])
        lcache["conv"].copy_(conv)
        lcache["ssm"].copy_(ssm)
        a_out = (a_out + m_out) * 0.5
    x = x + a_out
    if "xattn" in p and "xk" in lcache:
        x = _decode_cross(cfg, p, x, lcache["xk"], lcache["xv"])
    h2 = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    y, _ = _ffn(cfg, rules, p, h2)
    return x + y


def _decode_cross(cfg, p, x, xk, xv):
    """One token's cross attention to every position of `xk`/`xv` (B, Te,
    K, hd), added to the stream."""
    hx = L.rms_norm(x, p["lnx"], cfg.norm_eps)
    qx = torch.einsum("bsd,dhk->bshk", hx, p["xattn"]["wq"].to(hx.dtype))
    ox = attn.decode_attention(qx, xk, xv, xk.shape[1] - 1)
    ox = ox * attn.head_mask(cfg, ox.device)[None, None, :, None].to(ox.dtype)
    return x + attn.out_proj(p["xattn"], ox)


def _decode_vision_cross_block(cfg, p, x, xk, xv):
    """A vision group's cross layer, one token, as the reference decodes
    it: pure cross attention, then the MLP.  Unlike its forward, it runs
    no `ln1` and no self-attention and keeps no self K/V."""
    x = _decode_cross(cfg, p, x, xk, xv)
    return x + L.mlp_apply(p["mlp"], L.rms_norm(x, p["ln2"], cfg.norm_eps))


def _decode_rwkv_block(cfg, p, x, lcache):
    """One rwkv block, one token.  Writes the new `la` state and the two
    token-shift states into `lcache` (this layer's slices of the step's
    own copy of the caches) in place; `copy_` casts the shift states back
    to their stored dtype."""
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    tm_out, la, shift_a = rwkv_mod.rwkv_time_mix_step(
        p["tm"], h, lcache["la"], lcache["shift_a"],
        mask=attn.head_mask(cfg, x.device))
    x = x + tm_out
    h2 = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    cm_out, shift_c = rwkv_mod.rwkv_channel_mix_step(p["cm"], h2,
                                                     lcache["shift_c"])
    lcache["la"].copy_(la)
    lcache["shift_a"].copy_(shift_a)
    lcache["shift_c"].copy_(shift_c)
    return x + cm_out


def _logits(params, cfg, x):
    head = gather_over_data(L.head_matrix(params["embed"]))
    logits = torch.einsum("...d,dv->...v", x, head.to(x.dtype))
    vmask = L.vocab_logit_mask(head.shape[-1], cfg.vocab_size, x.device)
    if vmask is not None:
        logits = logits + vmask.to(logits.dtype)
    return logits


# decode-state leaves no decode step writes: passed on uncopied
_READ_ONLY = ("xk", "xv")


def decode_step(params, cfg: ModelConfig, rc: RunConfig, rules, state, token):
    """One decode step. token: (B,1) int -> (logits (B,1,V), new state).

    The given state is left as it was: the leaves the step writes are
    copied first, and the cross K/V are shared with the new state.  A
    `layer_types` model raises NotImplementedError."""
    _no_serving(cfg, "decode_step")
    dtype = getattr(torch, rc.dtype)
    x = L.embed_apply(params["embed"], token, dtype)
    pos = int(state["pos"])              # the step's one host copy of pos
    caches = {key: c if key in _READ_ONLY else c.clone()
              for key, c in state["layers"].items()}
    # under FSDP each layer is gathered at its use, as in `forward`
    layer = lambda blocks, i: gather_over_data(_layer_params(blocks, i))
    if cfg.cross_attn_every:
        per = cfg.cross_attn_every - 1
        selfs = off_lead_dims(params["self_blocks"], 2)
        crosses = off_lead_dims(params["cross_blocks"])
        for g in range(cfg.n_layers // cfg.cross_attn_every):
            for j in range(per):
                x = _decode_mixer_block(
                    cfg, rc, rules, layer(selfs, (g, j)), x,
                    {"k": caches["k"][g, j], "v": caches["v"][g, j]}, pos)
            x = _decode_vision_cross_block(
                cfg, layer(crosses, g), x, caches["xk"][g], caches["xv"][g])
    else:
        blocks = off_lead_dims(params["blocks"])
        for i in range(cfg.n_layers):
            p = layer(blocks, i)
            lcache = {key: c[i] for key, c in caches.items()}
            if cfg.rwkv:
                x = _decode_rwkv_block(cfg, p, x, lcache)
            else:
                x = _decode_mixer_block(cfg, rc, rules, p, x, lcache, pos)
    x = L.rms_norm(x, gather_over_data(params["ln_f"]), cfg.norm_eps)
    return _logits(params, cfg, x), {"pos": state["pos"] + 1,
                                     "layers": caches}


# ==========================================================================
# Prefill: full forward that also emits decode caches
# ==========================================================================


def prefill(params, cfg: ModelConfig, rc: RunConfig, rules, batch):
    """Process a full prompt; return (last-token logits (B,V), decode
    state).  A `layer_types` model raises NotImplementedError."""
    _no_serving(cfg, "prefill")
    S = batch["tokens"].shape[1]
    if cfg.sliding_window and S % min(cfg.sliding_window, S):
        raise ValueError(
            "prefill length must be a multiple of the SWA window so ring "
            "slots align (slot = pos % window)")
    x, _, layers = forward(params, cfg, rc, rules, batch, want_cache=True)
    logits = _logits(params, cfg, x[:, -1])
    if not cfg.rwkv and not cfg.sliding_window:
        # full-attention KV caches need headroom for subsequent decodes
        # (the time axis is ndim-3 of (L, B, T, K, hd) and of vision's
        # (G, per-1, B, T, K, hd)); the cross K/V,
        # SSM state, conv tail and rwkv states are fixed-size
        for key in ("k", "v"):
            layers[key] = L.pad_dim(layers[key], rc.decode_margin,
                                    layers[key].ndim - 3, end=True)
    pos = torch.tensor(S, dtype=torch.int32, device=x.device)
    return logits, {"pos": pos, "layers": layers}
