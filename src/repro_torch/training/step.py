"""train_step factory plus state assembly (port of
`repro.training.step`, dense training path).

The returned step function is a (state, batch) -> (state, metrics)
transition over plain trees of tensors, so the MANA runtime interposes
at step boundaries (the hybrid-2PC safe point) without touching model
code.  PyTorch runs eagerly: there is no jit, and no mesh.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves, tree_unflatten


def init_train_state(cfg: ModelConfig, rc: RunConfig, generator,
                     device) -> Dict:
    """Upper-half training state: params + moments + step counter."""
    params, _ = T.init_params(cfg, generator, device)
    return {"params": params, "opt": adamw.init_opt_state(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def abstract_params(cfg: ModelConfig) -> Tuple[Any, Any]:
    """(meta-tensor tree, logical-axes tree) — no allocation."""
    return T.init_params(cfg, None, "meta")


def make_train_step(cfg: ModelConfig, rc: RunConfig, rules=None):
    assert rc.grad_accum == 1, "grad accumulation wired via microbatch loop"

    def train_step(state, batch):
        params, opt, step = state["params"], state["opt"], state["step"]
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        with torch.enable_grad():
            loss, metrics = T.forward_loss(tree_unflatten(params, leaves),
                                           cfg, rc, rules, batch)
            grads = torch.autograd.grad(loss, leaves)
        lr = adamw.lr_schedule(step, rc.lr)
        new_params, new_opt, gnorm = adamw.apply_updates(
            params, tree_unflatten(params, grads), opt, lr=lr,
            beta1=rc.beta1, beta2=rc.beta2, weight_decay=rc.weight_decay,
            grad_clip=rc.grad_clip)
        out_metrics = {"loss": loss.detach(), "grad_norm": gnorm, "lr": lr,
                       **{k: v.detach() for k, v in metrics.items()}}
        return ({"params": new_params, "opt": new_opt, "step": step + 1},
                out_metrics)

    return train_step
