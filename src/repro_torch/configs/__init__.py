"""Architecture registry: ``--arch <id>`` resolves here."""
from __future__ import annotations

from repro_torch.configs.base import (
    ModelConfig,
    MoEConfig,
    RunConfig,
    ShapeConfig,
    SHAPES,
    SHAPES_BY_NAME,
    TRAIN_4K,
    PREFILL_32K,
    DECODE_32K,
    LONG_500K,
    shape_applicable,
)

from repro_torch.configs.whisper_large_v3 import CONFIG as WHISPER_LARGE_V3
from repro_torch.configs.mixtral_8x7b import CONFIG as MIXTRAL_8X7B
from repro_torch.configs.phi35_moe import CONFIG as PHI35_MOE
from repro_torch.configs.qwen2_0_5b import CONFIG as QWEN2_0_5B
from repro_torch.configs.stablelm_12b import CONFIG as STABLELM_12B
from repro_torch.configs.qwen2_1_5b import CONFIG as QWEN2_1_5B
from repro_torch.configs.qwen1_5_0_5b import CONFIG as QWEN1_5_0_5B
from repro_torch.configs.hymba_1_5b import CONFIG as HYMBA_1_5B
from repro_torch.configs.llama32_vision_11b import CONFIG as LLAMA32_VISION_11B
from repro_torch.configs.rwkv6_3b import CONFIG as RWKV6_3B
from repro_torch.configs.granite_4_0_h_micro import CONFIG as GRANITE_4_0_H_MICRO

ARCHS = {
    c.arch_id: c
    for c in (
        WHISPER_LARGE_V3,
        MIXTRAL_8X7B,
        PHI35_MOE,
        QWEN2_0_5B,
        STABLELM_12B,
        QWEN2_1_5B,
        QWEN1_5_0_5B,
        HYMBA_1_5B,
        LLAMA32_VISION_11B,
        RWKV6_3B,
        GRANITE_4_0_H_MICRO,
    )
}


def get_arch(arch_id: str) -> ModelConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown --arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def reduced_config(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A smoke-test-sized config of the same family (spec: reduced smoke).

    Keeps every structural feature (GQA ratio, MoE top-k, SWA, SSM, enc-dec,
    cross-attn cadence) while shrinking width/depth/vocab so a forward +
    train step runs on one CPU device in seconds.
    """
    import dataclasses

    head_dim = 16
    n_heads = max(2, min(4, cfg.n_heads)) if cfg.n_heads else 0
    # preserve "grouped-ness": kv < q iff the real arch has GQA
    n_kv = n_heads if cfg.n_kv_heads == cfg.n_heads else max(1, n_heads // 2)
    d_model = n_heads * head_dim if n_heads else 64
    small = dict(
        pad_to=1,
        n_layers=2,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=4 * d_model,
        vocab_size=256,
        sliding_window=32 if cfg.sliding_window else 0,
        enc_positions=24 if cfg.enc_dec else cfg.enc_positions,
        n_enc_layers=2 if cfg.enc_dec else 0,
        vision_tokens=16 if cfg.cross_attn_every else cfg.vision_tokens,
        cross_attn_every=2 if cfg.cross_attn_every else 0,
        ssm_state=8 if cfg.ssm_state else 0,
    )
    if cfg.moe is not None:
        small["moe"] = MoEConfig(num_experts=4, top_k=2, capacity_factor=1.5)
    if cfg.layer_types:
        # one published period (9:1 Mamba-2 to attention), 4 SSM heads of
        # 16 channels, state 8, chunk 8
        first = cfg.layer_types.index("attention")
        period = cfg.layer_types[:cfg.layer_types.index("attention", first + 1)
                                 - first]
        small.update(n_layers=len(period), layer_types=period, mamba_heads=4,
                     mamba_head_dim=16, mamba_state=8, mamba_chunk=8)
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
