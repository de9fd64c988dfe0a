"""Model assembly, dense decoder branch: init, forward, forward_loss.

Port of `repro.models.transformer` for the dense family (GQA, optional
QKV bias, RoPE, SwiGLU, tied or untied head).  Parameter names, shapes,
dtypes and the logical-axes tree are the reference's: blocks are stacked
on a leading (L, ...) layer axis and heads are stored padded
(`cfg.n_heads_padded`, `cfg.n_kv_heads_padded`), so every flattened
leaf path (`params/blocks/attn/wq`, ...) is the same in both packages
and images move between them.  Other families (MoE, hybrid, rwkv,
enc-dec, vision cross-attention, sliding window) raise
`NotImplementedError`; ROADMAP.md queues them.

Remat: with `rc.remat_policy` other than "none", each block runs under
`torch.utils.checkpoint` (non-reentrant) and saves only its input, the
reference's "full" policy; the port has no per-name save policies, so
"dots" and "comm" act as "full".
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L


def _require_dense(cfg: ModelConfig) -> None:
    other = [name for name, on in (
        ("moe", cfg.moe is not None), ("hybrid ssm", cfg.ssm_state),
        ("rwkv", cfg.rwkv), ("enc-dec", cfg.enc_dec),
        ("vision cross-attention", cfg.cross_attn_every),
        ("sliding-window attention", cfg.sliding_window)) if on]
    if other:
        raise NotImplementedError(
            f"{cfg.arch_id}: {', '.join(other)} is not ported to repro_torch "
            f"yet (ROADMAP.md, section A)")


# ==========================================================================
# Init
# ==========================================================================


def _init_dense_blocks(gen, cfg: ModelConfig, device):
    """Stacked (L, ...) dense blocks: the reference's vmapped per-layer
    init, drawn as one tensor per leaf."""
    n = cfg.n_layers
    params: Dict[str, Any] = {"ln1": L._norm_init((n, cfg.d_model), device),
                              "ln2": L._norm_init((n, cfg.d_model), device)}
    logical: Dict[str, Any] = {"ln1": (None,), "ln2": (None,)}
    params["attn"], logical["attn"] = attn.init_attention(
        gen, cfg.d_model, cfg.n_heads_padded, cfg.n_kv_heads_padded,
        cfg.head_dim, cfg.qkv_bias, device=device, stack=n)
    params["mlp"], logical["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff,
                                               device=device, stack=n)
    logical = _prepend_layers(logical)
    return params, logical


def _prepend_layers(logical):
    if isinstance(logical, dict):
        return {k: _prepend_layers(v) for k, v in logical.items()}
    return ("layers",) + logical


def init_params(cfg: ModelConfig, generator, device) -> Tuple[Dict, Dict]:
    """Returns (params, logical_axes) trees.  `generator` None (for the
    meta device) makes shapes only."""
    _require_dense(cfg)
    params: Dict[str, Any] = {}
    logical: Dict[str, Any] = {}
    params["embed"], logical["embed"] = L.init_embed(
        generator, cfg.vocab_padded, cfg.d_model, cfg.tie_embeddings,
        device=device)
    params["ln_f"] = L._norm_init((cfg.d_model,), device)
    logical["ln_f"] = (None,)
    params["blocks"], logical["blocks"] = _init_dense_blocks(
        generator, cfg, device)
    return params, logical


# ==========================================================================
# Full-sequence block application (train)
# ==========================================================================


def _self_attention_seq(cfg: ModelConfig, rc: RunConfig, p, h, positions,
                        causal: bool):
    q, k, v = attn.qkv_proj(p, h, cfg.rope_theta, positions)
    o = attn.flash_attention(q, k, v, causal=causal, chunk=rc.attn_chunk)
    o = o * attn.head_mask(cfg, o.device)[None, None, :, None].to(o.dtype)
    return attn.out_proj(p, o), (k, v)


def _mixer_block_seq(cfg, rc, rules, p, x, positions, enc_out=None,
                     causal=True):
    """One dense block over a full sequence.  Returns (x, aux, cache)."""
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    a_out, (k, v) = _self_attention_seq(cfg, rc, p["attn"], h, positions,
                                        causal)
    x = x + a_out
    h2 = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    y = L.mlp_apply(p["mlp"], h2)
    x = x + y
    return x, {}, {"k": k, "v": v}


def _layer_params(blocks, i: int):
    if isinstance(blocks, dict):
        return {k: _layer_params(v, i) for k, v in blocks.items()}
    return blocks[i]


def forward(params, cfg: ModelConfig, rc: RunConfig, rules, batch):
    """Full-sequence forward.  batch: tokens (B,S).

    Returns (hidden (B,S,d), aux-losses, None): the reference's prefill
    caches come with serving, which is not ported."""
    _require_dense(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    dtype = getattr(torch, rc.dtype)
    x = L.embed_apply(params["embed"], tokens, dtype)
    positions = torch.arange(S, device=tokens.device)
    # unbind once per stacked leaf: its backward stacks the L layer
    # grads in one pass instead of L full-size scatters
    blocks = _unbind_layers(params["blocks"])

    def block(x, p):
        return _mixer_block_seq(cfg, rc, rules, p, x, positions)[0]

    for i in range(cfg.n_layers):
        p = _layer_params(blocks, i)
        if rc.remat_policy == "none":
            x = block(x, p)
        else:
            x = checkpoint(block, x, p, use_reentrant=False,
                           preserve_rng_state=False)
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    aux = {"moe_aux": torch.zeros((), dtype=torch.float32, device=x.device)}
    return x, aux, None


def _unbind_layers(tree):
    if isinstance(tree, dict):
        return {k: _unbind_layers(v) for k, v in tree.items()}
    return tree.unbind(0)


def forward_loss(params, cfg, rc, rules, batch):
    """Next-token cross entropy (sequence-chunked; no (B,S,V) tensor)."""
    x, aux, _ = forward(params, cfg, rc, rules, batch)
    head = L.head_matrix(params["embed"])
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(batch["labels"].shape, dtype=torch.float32,
                          device=x.device)
    tot, cnt = L.chunked_softmax_xent(x, head, batch["labels"], mask,
                                      rc.loss_chunk,
                                      valid_vocab=cfg.vocab_size)
    loss = tot / torch.clamp(cnt, min=1.0)
    return loss, {"xent": tot / torch.clamp(cnt, min=1.0),
                  "moe_aux": aux["moe_aux"]}
