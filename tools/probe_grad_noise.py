#!/usr/bin/env python3
"""How far does one float32 rounding move a reduced model's gradients?

    PYTHONPATH=src python3 tools/probe_grad_noise.py [ARCH ...]

CPU only, one process, no mesh.  For each reduced arch (default: the
families with attention blocks, as `tests/_mesh_ranks.py` builds them,
heads and vocabulary padded to 2, B 8 x S 64, float32 compute; rwkv6-3b
has no such block, and MoE expert outputs are left as they are), it
computes the gradients of step 0's loss twice from the same params and
batch: as they are, and with every attention and MLP block output, and
the gradient flowing back into it, multiplied by 1 + 2^-24 * n (n
standard normal, drawn from a seeded generator), about one float32
rounding of each element.  It
prints the largest relative difference (norm) over the leaves and the
leaves it is largest at.

A mesh that splits heads or the ffn over "model" sums those outputs,
and their gradients, in another order than one device does: this is the
size of difference such a reordering can make, against which the
gradient checks of `tests/test_torch_mesh*.py` are read.
"""
from __future__ import annotations

import dataclasses
import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "tests"))
sys.path.insert(0, os.path.join(HERE, "..", "src"))

import _mesh_ranks  # noqa: E402
from repro_torch.core.checkpoint import _flatten  # noqa: E402
from repro_torch.data.pipeline import SyntheticDataset  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.training.step import init_train_state  # noqa: E402
from repro_torch.tree import tree_leaves, tree_unflatten  # noqa: E402

ARCHS = ("qwen2-0.5b", "mixtral-8x7b", "hymba-1.5b", "whisper-large-v3",
         "llama-3.2-vision-11b")


class _Rounding(torch.autograd.Function):
    """x * (1 + 2^-24 n) forward, and the same on the gradient."""
    gen = torch.Generator().manual_seed(5)

    @staticmethod
    def _noise(x):
        return x * (1 + 2.0 ** -24 * torch.randn(
            x.shape, generator=_Rounding.gen, dtype=x.dtype))

    @staticmethod
    def forward(ctx, x):
        return _Rounding._noise(x)

    @staticmethod
    def backward(ctx, g):
        return _Rounding._noise(g)


def _grads(cfg, rc, params, batch):
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, _ = T.forward_loss(tree_unflatten(params, leaves), cfg, rc, None,
                             batch)
    return list(torch.autograd.grad(loss, leaves))


def probe(arch: str):
    cfg, rc = _mesh_ranks.reduced(arch)
    rc = dataclasses.replace(rc, dtype="float32")
    params = init_train_state(cfg, rc, torch.Generator().manual_seed(0),
                              "cpu")["params"]
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticDataset(cfg, rc.shape).get_batch(0).items()}
    plain = _grads(cfg, rc, params, batch)
    out_proj, mlp_apply = A.out_proj, L.mlp_apply
    A.out_proj = lambda p, o: _Rounding.apply(out_proj(p, o))
    L.mlp_apply = lambda p, h: _Rounding.apply(mlp_apply(p, h))
    try:
        noisy = _grads(cfg, rc, params, batch)
    finally:
        A.out_proj, L.mlp_apply = out_proj, mlp_apply
    rel = {p: float((a - b).norm() / b.norm().clamp_min(1e-30))
           for p, a, b in zip(_flatten(params), noisy, plain)}
    return sorted(rel.items(), key=lambda kv: -kv[1])


def main(argv) -> int:
    torch.set_num_threads(1)
    for arch in argv or ARCHS:
        top = probe(arch)
        print(f"{arch}: max {top[0][1]:.3e} at "
              + ", ".join(f"{p} {r:.3e}" for p, r in top[:3]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
