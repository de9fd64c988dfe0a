"""hymba-1.5b [hybrid]: parallel attention + mamba heads, SWA.

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
All layers use SWA(1024) for the attention path (the published model mixes
SWA + a few global layers; we use all-SWA so the arch is uniformly
sub-quadratic — noted in DESIGN.md §6).  [arXiv:2411.13676; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    head_dim=64,
    sliding_window=1024,
    rope_theta=10_000.0,
    ssm_state=16,
    ssm_expand=2,
    source="arXiv:2411.13676; hf",
)
