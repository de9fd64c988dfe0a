"""Deterministic sharded synthetic data pipeline with a checkpointable cursor.

MANA-2.0 requirement: the data-iterator position is *upper-half* state.
Batches here are a pure function of (seed, step) via counter-based RNG
(Philox), so the checkpoint stores only {seed, step} and restart resumes
bit-identically — including across elastic restarts where the per-host
shard assignment changes (every host can synthesize any index range).

Modality frontends are STUBS per spec: [audio] supplies precomputed frame
embeddings, [vlm] supplies precomputed patch embeddings; both are modeled
as deterministic random tensors standing in for the real conv/ViT stems.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


class SyntheticDataset:
    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
                 dtype: str = "bfloat16"):
        self.cfg = cfg
        self.shape = shape
        self.seed = seed
        self.dtype = dtype

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.Generator(
            np.random.Philox(key=self.seed, counter=step))

    def get_batch(self, step: int) -> Dict[str, np.ndarray]:
        """Batch for global step `step` (pure function of (seed, step))."""
        cfg, shp = self.cfg, self.shape
        rng = self._rng(step)
        B, S = shp.global_batch, shp.seq_len
        seq = rng.integers(0, cfg.vocab_size, size=(B, S + 1), dtype=np.int64)
        batch = {
            "tokens": seq[:, :-1].astype(np.int32),
            "labels": seq[:, 1:].astype(np.int32),
        }
        if cfg.enc_dec:
            batch["frames"] = rng.standard_normal(
                (B, cfg.enc_positions, cfg.d_model), dtype=np.float32)
        if cfg.cross_attn_every:
            batch["patches"] = rng.standard_normal(
                (B, cfg.vision_tokens, cfg.d_model), dtype=np.float32)
        return batch

    def state_dict(self, step: int) -> Dict:
        return {"seed": self.seed, "step": step}

    @classmethod
    def from_state(cls, cfg, shape, state: Dict) -> "SyntheticDataset":
        return cls(cfg, shape, seed=state["seed"])


def make_batch_specs(cfg: ModelConfig, shape: ShapeConfig, dtype):
    """Meta-tensor stand-ins (shape and dtype, no storage) for every
    model input (dry-run spec); `dtype` is the torch dtype of the
    modality stubs."""
    import torch

    def meta(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")

    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": meta((B, 1), torch.int32)}
    specs = {"tokens": meta((B, S), torch.int32),
             "labels": meta((B, S), torch.int32)}
    if cfg.enc_dec:
        specs["frames"] = meta((B, cfg.enc_positions, cfg.d_model), dtype)
    if cfg.cross_attn_every:
        specs["patches"] = meta((B, cfg.vision_tokens, cfg.d_model), dtype)
    if shape.kind == "prefill":
        specs.pop("labels")
    return specs
