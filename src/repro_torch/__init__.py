"""MANA-2.0 reproduction on PyTorch and CUDA: the checkpointed training
runtime (`repro_torch.core.runtime.MANARuntime`: hybrid-2PC safe points,
the `CheckpointManager` codec stack, bit-identical resume) with the
checkpoint data path's kernels written by hand for Hopper (sm_90a):
checksum block sums, XOR delta, and int8 quantize and dequantize.

The JAX package `repro` is the reference.  This package imports nothing
of it and nothing of JAX; it keeps its own copy of every jax-free module
it needs.  `VERBATIM_COPIES` lists the modules that are such copies,
identical to their `repro` originals after the `repro.` -> `repro_torch.`
prefix swap, with the reference's numbered history tags dropped from
comments (tests/test_torch_hygiene.py holds them to that), and
`VERBATIM_FUNCTIONS` the functions and classes copied into otherwise
rewritten modules.

Entry points run on the card: `device=None` resolves to "cuda" and
raises when CUDA is absent.  Pass `device="cpu"` explicitly to run on
the host (the tests do).  A kernel wrapper decides by its input: a CUDA
tensor launches the kernel (or raises), a CPU tensor takes the plain
PyTorch version.

Importing this package does not import torch; the comm and protocol
layers stay light for socket rank processes.
"""
from __future__ import annotations

VERBATIM_COPIES = (
    "comm/__init__.py",
    "comm/fabric.py",
    "comm/collectives.py",
    "comm/transport/__init__.py",
    "comm/transport/base.py",
    "comm/transport/inproc.py",
    "comm/transport/faults.py",
    "comm/transport/tcp.py",
    "core/coordinator.py",
    "core/virtual.py",
    "core/drain.py",
    "core/two_phase_commit.py",
    "core/control.py",
    "core/snapshot_writer.py",
    "configs/__init__.py",
    "configs/base.py",
    "configs/hymba_1_5b.py",
    "configs/llama32_vision_11b.py",
    "configs/mixtral_8x7b.py",
    "configs/phi35_moe.py",
    "configs/qwen1_5_0_5b.py",
    "configs/qwen2_0_5b.py",
    "configs/qwen2_1_5b.py",
    "configs/rwkv6_3b.py",
    "configs/stablelm_12b.py",
    "configs/whisper_large_v3.py",
)

# (module path, name) pairs copied verbatim into rewritten modules
VERBATIM_FUNCTIONS = (
    ("kernels/checksum/ref.py", "_block_sums_np"),
    ("kernels/checksum/ref.py", "checksum_np"),
    ("kernels/delta/ref.py", "delta_np"),
    ("kernels/delta/ref.py", "apply_np"),
    ("kernels/quantize/ref.py", "quantize_np"),
    ("kernels/quantize/ref.py", "dequantize_np"),
    ("data/pipeline.py", "SyntheticDataset"),
    ("core/checkpoint.py", "_flatten"),
    ("core/checkpoint.py", "_rebuild"),
)


def resolve_device(device=None):
    """`None` -> "cuda" (raises when CUDA is absent); anything else is
    taken as the caller's explicit choice."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the host")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is absent")
    return device
