"""mixtral-8x7b [moe]: 8 experts top-2, sliding-window attention.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, MoE 8e top-2, SWA 4096.
[arXiv:2401.04088; hf]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    head_dim=128,
    sliding_window=4096,
    rope_theta=1e6,
    moe=MoEConfig(num_experts=8, top_k=2),
    source="arXiv:2401.04088; hf",
)
