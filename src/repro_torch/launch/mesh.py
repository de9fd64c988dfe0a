"""Production mesh construction on `torch.distributed`, port of
`repro.launch.mesh`.

Functions, not module-level constants: importing this module touches no
process group.  Each helper builds a `DeviceMesh` with `init_device_mesh`
over the default process group, which the caller initialises first
(`torch.distributed.init_process_group` with its address, world size and
rank) and whose size must be the mesh's.  The device type is "cuda"
unless the caller passes `device_type="cpu"` (the gloo tests do).
"""
from __future__ import annotations

import math
from typing import Sequence


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16x16 = 256 devices/pod (single pod), or 2 pods = 512 devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device_type: str = "cuda"):
    """Elastic-restart target meshes (any factorization of the world)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {shape} mesh needs an initialized default process group of "
            f"{math.prod(shape)} ranks: call "
            f"torch.distributed.init_process_group first")
    if dist.get_world_size() != math.prod(shape):
        raise RuntimeError(
            f"a {shape} mesh needs {math.prod(shape)} ranks; the default "
            f"process group has {dist.get_world_size()}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a cuda mesh needs CUDA, which is absent; pass "
                           "device_type='cpu' for a host mesh")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)
