"""train_step and serve_step factories plus state shape/sharding
assembly (port of `repro.training.step`).

The returned step functions are transitions over plain trees of
tensors ((state, batch) -> (state, metrics) for training, (params,
decode state, token) -> (logits, decode state) for serving), so the
MANA runtime interposes at step boundaries (the hybrid-2PC safe point)
and a decode state is upper-half state an image can hold as it is.
PyTorch runs eagerly: there is no jit.  On a mesh (`rules` set) the
state's leaves are DTensors placed by `train_state_specs`, and the
train step runs with plain tensors made inside the model taken as
replicated.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.sharding.rules import PartitionSpec as P
from repro_torch.sharding.rules import ShardingRules, zero1_shard
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def init_train_state(cfg: ModelConfig, rc: RunConfig, generator,
                     device) -> Dict:
    """Upper-half training state: params + moments + step counter."""
    params, _ = T.init_params(cfg, generator, device)
    return {"params": params, "opt": adamw.init_opt_state(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def abstract_params(cfg: ModelConfig) -> Tuple[Any, Any]:
    """(meta-tensor tree, logical-axes tree) — no allocation."""
    return T.init_params(cfg, None, "meta")


def abstract_train_state(cfg: ModelConfig, rc: RunConfig) -> Dict:
    """The train state's tree on the meta device: shapes and dtypes, no
    allocation."""
    return init_train_state(cfg, rc, None, "meta")


def train_state_specs(cfg: ModelConfig, rc: RunConfig, rules: ShardingRules):
    """PartitionSpecs for the full train state (ZeRO-1 moments included)."""
    shapes, logical = abstract_params(cfg)
    p_specs = tree_map(lambda s, lg: rules.spec(lg, s.shape), shapes,
                       logical)
    if rc.fsdp:
        # ZeRO-3: params (and hence grads) also sharded over the data
        # axis; each use gathers them and the grads come back reduced
        # onto the shards
        p_specs = tree_map(lambda s, sp: zero1_shard(sp, s.shape, rules.mesh),
                           shapes, p_specs)
    if rc.zero1:
        mv_specs = tree_map(lambda s, sp: zero1_shard(sp, s.shape,
                                                      rules.mesh),
                            shapes, p_specs)
    else:
        mv_specs = p_specs
    return {"params": p_specs,
            "opt": {"m": mv_specs, "v": mv_specs, "count": P()},
            "step": P()}


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, rules: ShardingRules):
    """Shape-aware: batch dims that do not divide the DP axes (e.g. the
    long_500k single sequence) are replicated."""
    B = shape.global_batch
    if shape.kind == "decode":
        return {"tokens": rules.spec(("batch", None), (B, 1))}
    S = shape.seq_len
    specs = {"tokens": rules.spec(("batch", None), (B, S)),
             "labels": rules.spec(("batch", None), (B, S))}
    if cfg.enc_dec:
        specs["frames"] = rules.spec(("batch", None, None),
                                     (B, cfg.enc_positions, cfg.d_model))
    if cfg.cross_attn_every:
        specs["patches"] = rules.spec(("batch", None, None),
                                      (B, cfg.vision_tokens, cfg.d_model))
    if shape.kind == "prefill":
        specs.pop("labels")
    return specs


def decode_state_specs(cfg: ModelConfig, rc: RunConfig, rules: ShardingRules,
                       shape: ShapeConfig):
    """PartitionSpecs of the decode state (`T.init_decode_state` on the
    meta device) by its logical axes."""
    lg = T.decode_state_logical(cfg)
    shapes = T.init_decode_state(cfg, shape, rc, "meta")
    return tree_map(lambda s, l: rules.spec(l, s.shape), shapes, lg)


def make_train_step(cfg: ModelConfig, rc: RunConfig, rules=None):
    assert rc.grad_accum == 1, "grad accumulation wired via microbatch loop"

    def train_step(state, batch):
        params, opt, step = state["params"], state["opt"], state["step"]
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        with torch.enable_grad():
            loss, metrics = T.forward_loss(tree_unflatten(params, leaves),
                                           cfg, rc, rules, batch)
            # held only by this list, which the update consumes entry by
            # entry (the gradients' memory is released as it goes)
            grads = list(torch.autograd.grad(loss, leaves))
        lr = adamw.lr_schedule(step, rc.lr)
        new_params, new_opt, gnorm = adamw.apply_updates(
            params, grads, opt, lr=lr,
            beta1=rc.beta1, beta2=rc.beta2, weight_decay=rc.weight_decay,
            grad_clip=rc.grad_clip)
        out_metrics = {"loss": loss.detach(), "grad_norm": gnorm, "lr": lr,
                       **{k: v.detach() for k, v in metrics.items()}}
        return ({"params": new_params, "opt": new_opt, "step": step + 1},
                out_metrics)

    if rules is None:
        return train_step

    def mesh_train_step(state, batch):
        # the model and the optimizer make plain tensors (positions,
        # masks, accumulators): on a mesh they are replicated
        from torch.distributed.tensor.experimental import implicit_replication

        with implicit_replication():
            return train_step(state, batch)

    return mesh_train_step


def make_serve_steps(cfg: ModelConfig, rc: RunConfig, rules=None):
    """(prefill_step(params, batch) -> (logits, state),
    serve_step(params, state, token) -> (logits, state)), both without
    autograd."""

    @torch.no_grad()
    def prefill_step(params, batch):
        return T.prefill(params, cfg, rc, rules, batch)

    @torch.no_grad()
    def serve_step(params, state, token):
        return T.decode_step(params, cfg, rc, rules, state, token)

    return prefill_step, serve_step
