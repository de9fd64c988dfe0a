"""rwkv6-3b (Finch) [ssm]: attention-free, data-dependent decay.

32L d_model=2560 (attn-free) d_ff=8960 vocab=65536; 40 heads of 64.
[arXiv:2404.05892; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,       # time-mix heads (head_dim 64); no softmax attention
    n_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    head_dim=64,
    rwkv=True,
    source="arXiv:2404.05892; hf",
)
