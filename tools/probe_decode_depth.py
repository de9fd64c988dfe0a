#!/usr/bin/env python3
"""How deep can a decode-vs-forward check of llama-3.2-vision-11b go at
full width before float32 rounding alone parts the two?

    python3 tools/probe_decode_depth.py

Needs one GPU.  With the params and prompts of `chip_smoke.py`'s
serve_vision phase (full width and depth, the phase's generator and
seed; 8 prompts of 2048 tokens, each with 1600 patches), the model is
cut, as that phase's check cuts it, to the first `k` self blocks of the
first group and its cross block, whose self-attention output projection
`cross_blocks/attn/wo` is zeroed (a vision decode runs the cross layer
without that self-attention, as the reference does).  For k = 1, 2 and
4 (4 is the whole first group) and each prompt, in float32 with TF32
off, it prints:

  * decode after a prefill of 2047 tokens against the forward over 2048
    at their last position, norm-relative over the vocabulary;
  * how far the forward's own logits there move when each parameter of
    the cut is multiplied by 1 +- 2^-24 (one float32 rounding, signs
    drawn from a seeded generator): the network's sensitivity to
    rounding, against which the first number is read.

Each line carries the card's name and power limit.
"""
from __future__ import annotations

import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

DEPTHS = (1, 2, 4)
PROMPTS, SEQ = 8, 2048


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map

    card = cs.card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = ARCHS["llama-3.2-vision-11b"]
    rc = RunConfig(model=cfg, shape=ShapeConfig("serve_h100", SEQ, PROMPTS,
                                                "prefill"))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params, _ = T.init_params(cfg, gen, dev)
    inputs = cs._serve_inputs(cfg, SEQ, PROMPTS, gen)
    P = SEQ - 1
    for k in DEPTHS:
        cross = tree_map(lambda t: t[:1], params["cross_blocks"])
        cross["attn"] = dict(cross["attn"],
                             wo=torch.zeros_like(cross["attn"]["wo"]))
        cut_params = dict(params, cross_blocks=cross, self_blocks=tree_map(
            lambda t: t[:1, :k], params["self_blocks"]))
        cut = dataclasses.replace(cfg, n_layers=k + 1, cross_attn_every=k + 1)
        f32 = dataclasses.replace(rc, model=cut, dtype="float32",
                                  remat_policy="none")
        signs = torch.Generator(device=dev)
        signs.manual_seed(1)

        def perturb(t):
            s = torch.randint(0, 2, t.shape, generator=signs, device=dev)
            return t * (1 + (2 * s - 1).float() * 2.0 ** -24)

        perturbed = dict(cut_params, **tree_map(perturb, {
            key: cut_params[key] for key in ("self_blocks", "cross_blocks")}))

        def logits(p, row):
            toks = inputs["tokens"][row:row + 1]
            extra = {"patches": inputs["patches"][row:row + 1]}
            with torch.no_grad():
                _, st = T.prefill(p, cut, f32, None,
                                  {"tokens": toks[:, :P], **extra})
                dec, _ = T.decode_step(p, cut, f32, None, st,
                                       toks[:, P:P + 1])
                x, _, _ = T.forward(p, cut, f32, None,
                                    {"tokens": toks, **extra})
                return dec[0, 0], T._logits(p, cut, x[0, P])

        for row in range(PROMPTS):
            dec, fwd = logits(cut_params, row)
            _, moved = logits(perturbed, row)
            print(f"{k} self block(s) + cross block, prompt {row}: decode vs "
                  f"forward {_rel(dec, fwd):.3e}; forward moved by one "
                  f"rounding of the params {_rel(moved, fwd):.3e} [{card}]",
                  flush=True)
        del cut_params, perturbed
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
