"""MANA-2.0 reproduction on PyTorch and CUDA: the checkpointed training
runtime (`repro_torch.core.runtime.MANARuntime`: hybrid-2PC safe points,
the `CheckpointManager` codec stack, bit-identical resume) and the
serving path (`repro_torch.training.step.make_serve_steps`: prefill and
functional decode steps whose state a live image can hold), for every
model family of the reference (dense, MoE, hybrid-SSM and RWKV-6
decoders, encoder-decoder and vision cross-attention models; and, for
training only, granite-4.0-h's Mamba-2 + GQA stack), with the
checkpoint data path's kernels written by hand for Hopper (sm_90a):
checksum block sums, XOR delta, and int8 quantize and dequantize.

The JAX package `repro` is the reference.  This package imports nothing
of it and nothing of JAX; it keeps its own copy of every jax-free module
it needs.  `VERBATIM_COPIES` lists the modules that are such copies,
identical to their `repro` originals after the `repro.` -> `repro_torch.`
prefix swap, with the reference's numbered history tags dropped from
comments (tests/test_torch_hygiene.py holds them to that), and
`VERBATIM_FUNCTIONS` the functions and classes copied into otherwise
rewritten modules.  `configs/base.py` and `configs/__init__.py` add to
the reference's the `layer_types` stack's fields and granite-4.0-h-micro,
an architecture the JAX package does not have; their other classes,
constants and functions are listed there.

Mesh training: the dense decoder, MoE, hybrid-SSM and RWKV-6 families
train on a `torch.distributed.device_mesh.DeviceMesh` (`MANARuntime(mesh=...)`,
meshes from `repro_torch.launch.mesh`), its state placed as DTensors by
the reference's sharding rules and spec trees
(`repro_torch.sharding.rules`, `repro_torch.training.step`); images
written from a mesh hold full tensors and restore on any mesh or none.

Entry points run on the card: `device=None` resolves to "cuda" and
raises when CUDA is absent.  Pass `device="cpu"` explicitly to run on
the host (the tests do).  A kernel wrapper decides by its input: a CUDA
tensor launches the kernel (or raises), a CPU tensor takes the plain
PyTorch version.

Multi-rank worlds: `repro_torch.comm.transport.harness` runs one rank
function per rank over the `inproc` (threads) or `socket` (spawned
processes) transport, checkpoints the world by the hybrid 2PC, and
supervises it through rank kills and changes of world size; rank state
may live on the card (`SnapshotCodec` and `IncrementalSnapshotter`
encode tensors through the XOR and quantize kernels).  The public
restore and store surface is the reference's: `restore_world(image,
plan)` with `RestorePlan` and `WorldMismatchError`, and `open_store` for
the durable `EpochStore` (`EpochFallbackWarning` when a corrupt epoch
is skipped).

Importing this package does not import torch; the comm and protocol
layers stay light for socket rank processes.
"""
from __future__ import annotations

from repro_torch.core.codec import WorldMismatchError
from repro_torch.core.image_store import (EpochFallbackWarning, EpochStore,
                                          ImageStore, LocalDirStore,
                                          StoreFaults, open_store)
from repro_torch.core.restore import (RestorePlan, RestoredWorld,
                                      parse_restore_spec, restore_world)

__all__ = ["EpochFallbackWarning", "EpochStore", "ImageStore",
           "LocalDirStore", "RestorePlan", "RestoredWorld", "StoreFaults",
           "WorldMismatchError", "open_store", "parse_restore_spec",
           "resolve_device", "restore_world"]

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
    "core/restore.py",
    "core/image_store.py",
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

# (module path, name) pairs copied verbatim into rewritten modules (a
# function, a class or a module-level constant)
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
    ("core/split_state.py", "UpperHalf"),
    ("core/split_state.py", "leaf_shard_dim"),
    ("core/split_state.py", "gather_leaf"),
    ("core/split_state.py", "scatter_leaf"),
    ("core/split_state.py", "reshard_state"),
    ("sharding/rules.py", "zero1_pick_dim"),
    ("comm/transport/harness.py", "WorldContext"),
    ("comm/transport/harness.py", "WorldResult"),
    ("comm/transport/harness.py", "row_width"),
    ("comm/transport/harness.py", "WorldError"),
    ("comm/transport/harness.py", "restore_agent_from_blob"),
    ("comm/transport/harness.py", "_run_inproc"),
    ("comm/transport/harness.py", "_socket_child"),
    ("comm/transport/harness.py", "SupervisedRun"),
    ("comm/transport/harness.py", "_image_restorable"),
    ("comm/transport/harness.py", "run_world_supervised"),
    ("launch/dryrun.py", "COLLECTIVE_OPS"),
    ("launch/dryrun.py", "production_rc"),
    ("configs/__init__.py", "get_arch"),
    ("configs/base.py", "MoEConfig"),
    ("configs/base.py", "ShapeConfig"),
    ("configs/base.py", "TRAIN_4K"),
    ("configs/base.py", "PREFILL_32K"),
    ("configs/base.py", "DECODE_32K"),
    ("configs/base.py", "LONG_500K"),
    ("configs/base.py", "SHAPES_BY_NAME"),
    ("configs/base.py", "shape_applicable"),
    ("configs/base.py", "RunConfig"),
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
