"""Frozen arithmetic of the benchmark: model FLOPs of a training step
and the bytes each checkpoint kernel must move, from a configuration's
shapes alone (never from what the program ran).

Peaks are one NVIDIA H100 SXM's published dense rates at 700 W.
"""
from __future__ import annotations

import math

PEAK_BF16_FLOPS = 989e12      # dense bf16 tensor-core FLOP/s
PEAK_HBM_BYTES = 3.35e12      # HBM3 bytes/s
QBLOCK = 1024                 # int8 quantization block (elements)


def matmul_params(cfg: dict) -> int:
    """Parameters that enter a matrix product in a training step: the
    attention projections of the real heads, the MLP, and the LM head
    (the tied embedding counts once, as the head).  Embedding lookups,
    norms and biases are no products."""
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    hd = cfg["head_dim"]
    q = cfg["num_attention_heads"] * hd
    kv = cfg["num_key_value_heads"] * hd
    f = cfg["intermediate_size"]
    per = d * q + 2 * d * kv + q * d + 3 * d * f
    return L * per + d * cfg["vocab_size"]


def window(cfg: dict) -> int:
    """The sliding window a configuration runs (0: full causal)."""
    if not cfg.get("use_sliding_window", True):
        return 0
    return cfg.get("sliding_window") or 0


def attention_pairs(seq: int, window: int = 0) -> int:
    """(query, key) pairs a causal attention scores over one sequence:
    query i sees i + 1 keys, or `window` with a sliding window."""
    if not window or window >= seq:
        return seq * (seq + 1) // 2
    return window * (window + 1) // 2 + (seq - window) * window


def train_step_flops(cfg: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step (forward and backward, no
    recompute): 6 x matmul params x tokens, plus the attention scores and
    value products, 4 x head_dim FLOPs a pair and head forward, x 3."""
    tokens = batch * seq
    dense = 6 * matmul_params(cfg) * tokens
    pairs = attention_pairs(seq, window(cfg))
    attn = (3 * 4 * cfg["head_dim"] * cfg["num_attention_heads"] * pairs
            * batch * cfg["num_hidden_layers"])
    return float(dense + attn)


def quantize_bytes(n: int) -> int:
    """Bytes of one `quantize_kernel` call over n f32 values: n x 4 read,
    the int8 codes of whole blocks and one f32 scale a block written."""
    rows = -(-n // QBLOCK)
    return 4 * n + rows * QBLOCK + 4 * rows


def dequantize_bytes(n: int) -> int:
    """Bytes of one `dequantize_kernel` call making n f32 values: n int8
    codes and one f32 scale a block read, n x 4 written."""
    rows = -(-n // QBLOCK)
    return n + 4 * rows + 4 * n


def checksum_bytes(nbytes: int) -> int:
    """Bytes of one digest of a payload chunk: every byte read once, a
    4-byte digest written."""
    return nbytes + 4


def roofline_share(bytes_moved: float, device_s: float) -> float:
    """Percent of the HBM bound: the least time the bytes need at the
    peak rate over the time the kernels took."""
    if device_s <= 0 or bytes_moved <= 0:
        return math.nan
    return 100.0 * (bytes_moved / PEAK_HBM_BYTES) / device_s
