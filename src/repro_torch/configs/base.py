"""Config system: architecture and run-shape descriptions.

Every assigned architecture is a `ModelConfig` (exact public-literature
numbers live in the per-arch modules in this package).  A `ShapeConfig`
is one of the assigned input-shape cells (train_4k / prefill_32k /
decode_32k / long_500k).  `RunConfig` marries the two with a mesh +
runtime options and is what the launcher consumes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    # Capacity factor for the GShard-style dispatch einsum.
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm

    n_layers: int
    d_model: int
    n_heads: int          # query heads (0 for attention-free archs)
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0      # derived if 0

    # --- attention flavour ---
    qkv_bias: bool = False
    sliding_window: int = 0           # 0 => full causal attention
    rope_theta: float = 10_000.0

    # --- MoE ---
    moe: Optional[MoEConfig] = None

    # --- hybrid (hymba): parallel attention + mamba heads ---
    ssm_state: int = 0                # >0 enables the parallel mamba path
    ssm_expand: int = 2               # d_inner = ssm_expand * d_model

    # --- rwkv6 ---
    rwkv: bool = False

    # --- encoder-decoder (whisper) ---
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_positions: int = 1500         # stub audio-frame positions (30s @ 50Hz)

    # --- vision cross-attention (llama-3.2-vision) ---
    cross_attn_every: int = 0         # every Nth layer is a cross-attn layer
    vision_tokens: int = 1600         # stub image-patch positions

    # --- norm / misc ---
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    source: str = ""                  # provenance note

    # --- TP padding (production model axis = 16) ---
    # jit argument shardings must tile evenly, so head/vocab dims that do
    # not divide the model axis are stored PADDED with exact masking
    # (dummy heads contribute zero output and receive zero gradient).
    # The padding waste is visible in the roofline's MODEL_FLOPS/HLO
    # ratio by design.  pad_to=1 disables (reduced smoke configs).
    pad_to: int = 16

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    def padded_heads(self):
        """(K_pad, G_pad): padded kv-head and group counts such that
        H_pad = K_pad * G_pad is a multiple of pad_to, K_pad >= K,
        G_pad >= H/K, minimizing padded compute (prefer K_pad == K so
        KV caches stay unpadded)."""
        if not self.n_heads:
            return 0, 0
        K, H, P = self.n_kv_heads, self.n_heads, self.pad_to
        G = H // K
        best = None
        for kp in range(K, 4 * K + 1):
            for gp in range(G, 4 * G + 1):
                if (kp * gp) % P == 0:
                    key = (kp * gp, kp != K, kp, gp)
                    if best is None or key < best:
                        best = key
        assert best is not None
        return best[2], best[3]

    @property
    def n_kv_heads_padded(self) -> int:
        return self.padded_heads()[0]

    @property
    def n_heads_padded(self) -> int:
        kp, gp = self.padded_heads()
        return kp * gp

    @property
    def vocab_padded(self) -> int:
        return ((self.vocab_size + self.pad_to - 1)
                // self.pad_to) * self.pad_to

    # ---- derived sizes -----------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def subquadratic(self) -> bool:
        """True if serve_step memory/compute is sub-quadratic in context.

        SWA, SSM and RWKV archs qualify; pure full-attention archs do not
        (they skip the long_500k shape; see DESIGN.md §6).
        """
        return self.rwkv or self.ssm_state > 0 or self.sliding_window > 0

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have an autoregressive decoder

    def param_count(self, active_only: bool = False) -> int:
        """Analytic parameter count (embedding + blocks + head).

        `active_only` counts MoE experts at top_k/num_experts weighting —
        used for MODEL_FLOPS = 6 * N_active * D in the roofline.
        """
        d, dff, V = self.d_model, self.d_ff, self.vocab_size
        embed = V * d
        head = 0 if self.tie_embeddings else V * d

        def attn_params() -> int:
            p = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            if self.qkv_bias:
                p += self.q_dim + 2 * self.kv_dim
            return p

        def mlp_params(n_copies: float = 1.0) -> int:
            # gated MLP (SwiGLU-style): 3 matrices
            return int(3 * d * dff * n_copies)

        per_layer = 0
        if self.rwkv:
            # time-mix: r,k,v,g,o (5 d*d) + decay lora (small) ; channel-mix 2*d*dff
            per_layer = 5 * d * d + 2 * d * dff
        else:
            per_layer += attn_params()
            if self.moe is not None:
                n = (self.moe.top_k if active_only else self.moe.num_experts)
                per_layer += mlp_params(n) + d * self.moe.num_experts  # + router
            else:
                per_layer += mlp_params()
            if self.ssm_state > 0:
                d_in = self.ssm_expand * d
                # in_proj (x,z), dt/B/C proj, out_proj, conv
                per_layer += d * 2 * d_in + d_in * (2 * self.ssm_state + 2) + d_in * d + 4 * d_in
        total = embed + head + self.n_layers * per_layer

        if self.enc_dec:
            enc_per = attn_params() + mlp_params()
            cross_per = attn_params()
            total += self.n_enc_layers * enc_per + self.n_layers * cross_per
        if self.cross_attn_every:
            n_cross = self.n_layers // self.cross_attn_every
            total += n_cross * attn_params()
        return int(total)


# ---------------------------------------------------------------------------
# Shape config (the assigned input-shape cells)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

SHAPES: Tuple[ShapeConfig, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether a (arch x shape) cell runs, and if not, why (DESIGN.md §6)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "full-attention arch: O(L^2) at 524k ctx — skipped per spec"
    return True, ""


# ---------------------------------------------------------------------------
# Run config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    # sharding / memory knobs (the §Perf levers)
    remat_policy: str = "full"        # full | dots | none
    scan_layers: bool = True
    loss_chunk: int = 512             # seq-chunked cross entropy
    attn_chunk: int = 512             # kv/q block for chunked attention
    la_chunk: int = 32                # linear-attention (rwkv/mamba) chunk
    moe_mode: str = "ep"              # ep | tp  (expert vs tensor sharding)
    zero1: bool = True                # shard optimizer state over data axis
    fsdp: bool = False                # ZeRO-3: params+grads sharded over data
    seq_shard: bool = False           # SP: activations seq-sharded over model
    kv_time_shard: bool = False       # decode KV cache time-dim over model
    grad_accum: int = 1
    decode_margin: int = 128          # KV-cache headroom after prefill
    # optimizer
    lr: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
