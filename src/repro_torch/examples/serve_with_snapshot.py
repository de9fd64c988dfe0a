"""Serving example: batched prefill + greedy decode with a live image of
the decode state mid-generation, then a restore whose continuation must
match — the inference analogue of MANA's transparent checkpoint (the
decode state, position and KV caches, is pure upper-half state).
PyTorch twin of the JAX package's `examples/serve_with_snapshot.py`.

    PYTHONPATH=src python -m repro_torch.examples.serve_with_snapshot
    PYTHONPATH=src python -m repro_torch.examples.serve_with_snapshot --device cpu

Runs on the card unless `--device` says otherwise; exits 1 if the
continuation after the restore differs.
"""
from __future__ import annotations

import argparse
import shutil
import sys
import tempfile

import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.core.checkpoint import CheckpointManager
from repro_torch.models.transformer import decode_state_logical, init_params
from repro_torch.training.step import make_serve_steps

BATCH, PROMPT, NEW_TOKENS, SNAP_AT = 4, 64, 12, 5


def _greedy(logits):
    return torch.argmax(logits, dim=-1).to(torch.int32)[:, None]


def run(device, ckpt_dir: str) -> bool:
    cfg = reduced_config(ARCHS["mixtral-8x7b"])  # MoE + SWA serving
    shape = ShapeConfig("serve", seq_len=PROMPT, global_batch=BATCH,
                        kind="prefill")
    rc = RunConfig(model=cfg, shape=shape, loss_chunk=32, attn_chunk=16)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params, _ = init_params(cfg, gen, device)
    prefill_step, serve_step = make_serve_steps(cfg, rc)

    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=gen, device=device, dtype=torch.int32)
    logits, state = prefill_step(params, {"tokens": prompts})
    print(f"prefilled batch of {BATCH} x {PROMPT} tokens; "
          f"pos={int(state['pos'])}")

    mgr = CheckpointManager(ckpt_dir, device=device)
    generated = []
    tok = _greedy(logits)
    for i in range(NEW_TOKENS):
        logits, state = serve_step(params, state, tok)
        tok = _greedy(logits[:, -1])
        generated.append(tok)
        if i == SNAP_AT:
            # live image mid-generation (no drain needed: the decode
            # state is upper-half by construction)
            mgr.save(i, {"decode": state},
                     {"decode": decode_state_logical(cfg)})
            print(f"snapshotted decode state at token {i} "
                  f"({mgr.stats[-1]['bytes']} bytes)")

    # restart generation from the image and check the continuation
    restored, _ = CheckpointManager(ckpt_dir, device=device).restore(SNAP_AT)
    state2 = restored["decode"]
    tok2 = generated[SNAP_AT]
    regen = []
    for _ in range(SNAP_AT + 1, NEW_TOKENS):
        logits2, state2 = serve_step(params, state2, tok2)
        tok2 = _greedy(logits2[:, -1])
        regen.append(tok2)
    match = all(torch.equal(a, b)
                for a, b in zip(generated[SNAP_AT + 1:], regen))
    print("continuation after restore matches original:", match)
    return match


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="image directory (default: a fresh temporary one, "
                         "removed afterwards)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    d = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_serving_")
    try:
        return 0 if run(device, d) else 1
    finally:
        if args.ckpt_dir is None:
            shutil.rmtree(d, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
