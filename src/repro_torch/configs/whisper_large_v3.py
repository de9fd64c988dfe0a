"""whisper-large-v3 [audio]: enc-dec, conv frontend (STUB).

32L d_model=1280 20H (GQA kv=20) d_ff=5120 vocab=51866.
[arXiv:2212.04356; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-large-v3",
    family="audio",
    n_layers=32,            # decoder layers
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    head_dim=64,
    enc_dec=True,
    n_enc_layers=32,
    enc_positions=1500,     # 30s of audio @ 50 Hz post-conv (frontend is a stub)
    rope_theta=0.0,         # sinusoidal absolute positions, no RoPE
    source="arXiv:2212.04356; unverified",
)
