"""AdamW with global-norm clipping and warmup-cosine schedule, plain
tensor code (port of `repro.optim.adamw`; not `torch.optim.AdamW`).

The state layout is the reference's: {"m", "v", "count"} with `m`, `v`
trees mirroring params (f32) and `count` an int32 0-d tensor.  The
update is functional: `apply_updates` returns new tensors and never
writes into params, moments or count, so a snapshot that the checkpoint
writer took at a safe point keeps that step's bytes while training runs
on.
"""
from __future__ import annotations

import math

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def init_opt_state(params):
    zeros = lambda p: torch.zeros_like(p)
    count_device = tree_leaves(params)[0].device
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "count": torch.zeros((), dtype=torch.int32, device=count_device),
    }


def lr_schedule(step, base_lr: float, warmup: int = 100,
                total: int = 10_000, min_frac: float = 0.1):
    step_f = step.to(torch.float32)
    warm = (step_f + 1.0) / max(1.0, warmup)
    prog = torch.clamp((step_f - warmup) / max(1.0, total - warmup), 0, 1)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return base_lr * torch.minimum(warm, cos)


def global_norm(tree):
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(l.to(torch.float32)))
                          for l in leaves))


@torch.no_grad()
def apply_updates(params, grads, opt_state, *, lr, beta1=0.9, beta2=0.95,
                  eps=1e-8, weight_decay=0.1, grad_clip=1.0):
    count = opt_state["count"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    c1 = 1.0 - beta1 ** count.to(torch.float32)
    c2 = 1.0 - beta2 ** count.to(torch.float32)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m = beta1 * m + (1 - beta1) * g
        v = beta2 * v + (1 - beta2) * torch.square(g)
        mh = m / c1
        vh = v / c2
        step = mh / (torch.sqrt(vh) + eps) + weight_decay * p.to(torch.float32)
        return (p - lr * step).to(p.dtype), m, v

    flat_p = tree_leaves(params)
    out = [upd(p, g, m, v) for p, g, m, v in zip(
        flat_p, tree_leaves(grads), tree_leaves(opt_state["m"]),
        tree_leaves(opt_state["v"]))]
    new_p = tree_unflatten(params, [o[0] for o in out])
    new_m = tree_unflatten(params, [o[1] for o in out])
    new_v = tree_unflatten(params, [o[2] for o in out])
    return new_p, {"m": new_m, "v": new_v, "count": count}, gnorm
