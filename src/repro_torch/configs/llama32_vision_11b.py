"""llama-3.2-vision-11b [vlm]: cross-attn image layers (vision STUB).

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256; every 5th layer
cross-attends to precomputed image-patch embeddings (frontend is a stub
per spec: input_specs() provides the patch-embedding tensor).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    head_dim=128,
    rope_theta=500_000.0,
    cross_attn_every=5,
    vision_tokens=1600,
    source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
)
