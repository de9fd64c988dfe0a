"""Quickstart: train a small model under MANA transparent checkpointing.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

PyTorch twin of the JAX package's `examples/quickstart.py`: trains a
reduced qwen2 for 20 steps with a checkpoint every 8 steps, then
restarts from the latest image and continues — the MANA-2.0 contract
in ~30 lines.  Runs on the card unless `--device` says otherwise;
`--ckpt-dir` moves the images from /tmp/repro_torch_quickstart.
"""
import argparse

from repro_torch import resolve_device
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.core.runtime import MANARuntime

CKPT = "/tmp/repro_torch_quickstart"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; exits without one)")
    ap.add_argument("--ckpt-dir", default=CKPT)
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))

    cfg = reduced_config(ARCHS["qwen2-0.5b"])
    shape = ShapeConfig("quickstart", seq_len=128, global_batch=4,
                        kind="train")
    rc = RunConfig(model=cfg, shape=shape, loss_chunk=64, attn_chunk=32)

    rt = MANARuntime(cfg, rc, ckpt_dir=args.ckpt_dir, ckpt_every_steps=8,
                     device=device)
    rt.initialize()
    rt.run(20, on_metrics=lambda s, m: print(
        f"step {s:3d}  loss {m['loss']:.4f}  lr {m['lr']:.2e}"))
    print(f"checkpoints on disk: {rt.ckpt.steps()}")

    print("\n-- simulating a crash; restarting from the last image --")
    rt2 = MANARuntime(cfg, rc, ckpt_dir=args.ckpt_dir, device=device)
    start = rt2.restore()
    print(f"restored at step {start}")
    rt2.run(5, on_metrics=lambda s, m: print(
        f"step {s:3d}  loss {m['loss']:.4f}  (resumed)"))


if __name__ == "__main__":
    main()
