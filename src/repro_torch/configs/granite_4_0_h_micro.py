"""granite-4.0-h-micro [hybrid]: Mamba-2 + GQA, NoPE, muP multipliers.

40L d_model=2048 in a fixed `layer_types` order (36 Mamba-2, 4 GQA
attention at 5, 15, 25, 35), every layer followed by a SwiGLU MLP of
width 8192; 32H (GQA kv=8) head_dim=64, no positions; Mamba-2 with 64
heads of 64, state 128, 1 group, conv 4 with bias, chunk 256; embedding
x12, attention scale 1/64, residual x0.22, logits / 8; vocab=100352,
tied.  [hf ibm-granite/granite-4.0-h-micro config.json; arXiv:2405.21060]
"""
from repro_torch.configs.base import ModelConfig

_PERIOD = ("mamba",) * 5 + ("attention",) + ("mamba",) * 4

CONFIG = ModelConfig(
    arch_id="granite-4.0-h-micro",
    family="hybrid",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=100352,
    head_dim=64,
    layer_types=_PERIOD * 4,
    mamba_heads=64,
    mamba_head_dim=64,
    mamba_state=128,
    mamba_groups=1,
    mamba_conv=4,
    mamba_chunk=256,
    rope=False,
    embedding_multiplier=12.0,
    attention_multiplier=0.015625,
    residual_multiplier=0.22,
    logits_scaling=8.0,
    norm_eps=1e-5,
    tie_embeddings=True,
    source="hf ibm-granite/granite-4.0-h-micro; arXiv:2405.21060",
)
