"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``

PyTorch twin of `repro.launch.train`: runs the MANARuntime loop
(hybrid-2PC checkpointing, async writes, preemption signal handling) on
one device, the card unless `--device` says otherwise.  The flags,
defaults and output are the reference's, plus `--device`; there is no
`--use-pallas`, the device picks the kernels.  The reference's default
shape `train_4k` (B 256 x S 4096) does not fit one card: pass `--batch`
and `--seq`, e.g. ``--arch qwen2-0.5b --batch 8 --seq 1024``.
"""
from __future__ import annotations

import argparse
import json

from repro_torch import resolve_device
from repro_torch.configs import ARCHS, SHAPES_BY_NAME, reduced_config
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.core.runtime import MANARuntime


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpts")
    ap.add_argument("--ckpt-every-steps", type=int, default=50)
    ap.add_argument("--ckpt-every-secs", type=float, default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-size config (CPU-friendly)")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--mode", default="hybrid",
                    choices=["hybrid", "mana1", "nobarrier"])
    ap.add_argument("--transport", default="inproc",
                    help="fabric backend for the protocol plane "
                         "(see repro_torch.comm.transport registry)")
    ap.add_argument("--quantize-moments", action="store_true")
    ap.add_argument("--delta-params", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; exits without one)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))

    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = reduced_config(cfg)
    shape = SHAPES_BY_NAME.get(args.shape)
    if shape is None or args.batch or args.seq:
        shape = ShapeConfig("custom", args.seq or 512, args.batch or 4,
                            "train")
    rc = RunConfig(model=cfg, shape=shape,
                   loss_chunk=min(512, shape.seq_len),
                   attn_chunk=min(128, shape.seq_len))

    rt = MANARuntime(cfg, rc, ckpt_dir=args.ckpt_dir, mode=args.mode,
                     ckpt_every_steps=args.ckpt_every_steps,
                     ckpt_every_secs=args.ckpt_every_secs,
                     quantize_moments=args.quantize_moments,
                     delta_params=args.delta_params, seed=args.seed,
                     install_signal_handler=True,
                     transport=args.transport, device=device)
    if args.resume and rt.ckpt.latest_step() is not None:
        start = rt.restore()
        print(f"resumed from step {start}")
    else:
        rt.initialize()
        print("initialized fresh")
    hist = rt.run(args.steps)
    for h in hist[-3:]:
        print(json.dumps(h))
    print(f"checkpoints taken: {rt.checkpoints_taken}; "
          f"dir: {sorted(rt.ckpt.steps())}")
    rt.close()


if __name__ == "__main__":
    main()
