"""End-to-end example: train a ~100M-param model for a few hundred steps
under the full MANA runtime, with a mid-run preemption notice
(SIGUSR1-style) that checkpoints at the next safe point, a crash, and an
elastic-style restart — then verify the loss stream matches an
uninterrupted reference run.

    PYTHONPATH=src python -m repro_torch.examples.train_with_preemption [--steps 200]
    PYTHONPATH=src python -m repro_torch.examples.train_with_preemption --device cpu

PyTorch twin of the JAX package's `examples/train_with_preemption.py`
(~100M params: qwen2-0.5b geometry at 12 layers / d_model 512 / vocab
16k).  Runs on the card unless `--device` says otherwise; `--ckpt-dir`
moves the images from /tmp/repro_torch_preempt(_ref).
"""
import argparse
import dataclasses

from repro_torch import resolve_device
from repro_torch.configs import ARCHS
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.core.runtime import MANARuntime

CKPT = "/tmp/repro_torch_preempt"


def make_cfg():
    base = ARCHS["qwen2-0.5b"]
    return dataclasses.replace(
        base, n_layers=12, d_model=512, n_heads=8, n_kv_heads=2,
        head_dim=64, d_ff=1408, vocab_size=16384, pad_to=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; exits without one)")
    ap.add_argument("--ckpt-dir", default=CKPT)
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    ckpt = args.ckpt_dir

    cfg = make_cfg()
    print(f"model: {cfg.param_count() / 1e6:.1f}M params")
    shape = ShapeConfig("e2e", seq_len=256, global_batch=4, kind="train")
    rc = RunConfig(model=cfg, shape=shape, loss_chunk=128, attn_chunk=64)

    preempt_at = args.steps // 2

    # reference: uninterrupted
    ref = MANARuntime(cfg, rc, ckpt_dir=ckpt + "_ref", device=device)
    ref.initialize()
    ref_hist = ref.run(args.steps)
    print(f"reference run done: final loss {ref_hist[-1]['loss']:.4f}")

    # interrupted: preemption notice mid-run -> checkpoint -> crash -> resume
    rt = MANARuntime(cfg, rc, ckpt_dir=ckpt, device=device)
    rt.initialize()

    def on_metrics(step, m):
        if step == preempt_at:
            print(f"!! preemption notice at step {step} "
                  f"(checkpoint lands at the next safe point)")
            rt.request_checkpoint()

    rt.run(preempt_at + 1, on_metrics=on_metrics)
    assert rt.checkpoints_taken == 1
    print(f"checkpointed at step {rt.ckpt.latest_step()}; crashing now")
    del rt

    rt2 = MANARuntime(cfg, rc, ckpt_dir=ckpt, device=device)
    start = rt2.restore()
    print(f"restarted from step {start}")
    cont = rt2.run(args.steps - start)

    a = [round(h["loss"], 6) for h in ref_hist[start:]]
    b = [round(h["loss"], 6) for h in cont]
    assert a == b, "interrupted run diverged from uninterrupted reference!"
    print(f"PASS: {len(b)} post-restart steps bit-identical to reference "
          f"(final loss {b[-1]:.4f})")


if __name__ == "__main__":
    main()
