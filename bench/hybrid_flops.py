"""Frozen model FLOPs of a `layer_types` hybrid's training step
(granite-4.0-h: Mamba-2 and GQA attention layers, each with a SwiGLU
MLP), from a configuration's shapes alone, never from what the program
ran; recompute is not counted.

  6 x matmul params x tokens
  + the attention layers' causal pairs: 4 x head_dim FLOPs a pair and
    head forward (scores and values), x 3 for forward and backward
  + the SSD counted as its recurrence: 2 N P for the state update and
    2 N P for the readout, a token, head and Mamba layer, x 3.
"""
from __future__ import annotations

from bench.flops import attention_pairs
from bench.hybrid_state import dims


def matmul_params(cfg: dict) -> int:
    """Parameters that enter a matrix product in a step: each Mamba-2
    mixer's in_proj and out_proj, each attention layer's projections,
    every MLP, and the LM head (the tied embedding counts once, as the
    head).  The conv, norms, dt_bias, A_log and D are no products."""
    z = dims(cfg)
    d, di, f = z["d"], z["di"], z["f"]
    q = cfg["num_attention_heads"] * z["hd"]
    kv = cfg["num_key_value_heads"] * z["hd"]
    mamba = d * (di + z["conv"] + z["nh"]) + di * d
    attn = d * q + 2 * d * kv + q * d
    mlp = 3 * d * f
    return (z["L_mamba"] * (mamba + mlp) + z["L_attn"] * (attn + mlp)
            + d * cfg["vocab_size"])


def train_step_flops(cfg: dict, batch: int, seq: int) -> float:
    z = dims(cfg)
    tokens = batch * seq
    dense = 6 * matmul_params(cfg) * tokens
    attn = (3 * 4 * z["hd"] * cfg["num_attention_heads"]
            * attention_pairs(seq) * batch * z["L_attn"])
    ssd = 3 * 4 * z["N"] * z["P"] * z["nh"] * tokens * z["L_mamba"]
    return float(dense + attn + ssd)
