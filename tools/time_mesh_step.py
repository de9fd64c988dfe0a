#!/usr/bin/env python3
"""Host seconds of the port's training step on one GPU, without a mesh
and on a (1 x 1) ("data", "model") NCCL mesh, at `chip_smoke.py`'s
training cell (full-width qwen2-0.5b, B=8, S=1024, bf16 compute), with
no images.

    python3 tools/time_mesh_step.py [--src DIR] [--after-smoke]

It runs `STEPS` steps through `MANARuntime` without a mesh, then as
many on the mesh, from the same seed, and prints each step's
host seconds (a step ends when its metrics reach the host) and the
median of the steps after the first, beside the card's name and power
limit, the live threads and the objects the garbage collector tracks.
`--src` imports `repro_torch` from another tree's `src` (a commit
unpacked with `git archive`), so two commits are timed by the same
script in one call.  `--after-smoke` times them in a fresh process,
then runs all of `chip_smoke.py` in this process, then times them
again: the mesh step early in a process and after every smoke phase.
"""
from __future__ import annotations

import argparse
import gc
import os
import shutil
import statistics
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 6


def time_steps(tag: str, card: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.core.runtime import MANARuntime
    from repro_torch.launch.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ARCHS["qwen2-0.5b"]
    rc = RunConfig(model=cfg, shape=ShapeConfig("smoke_h100", 1024, 8, "train"))
    dist.init_process_group(
        "nccl", store=dist.HashStore(), rank=0, world_size=1,
        device_id=torch.device("cuda", torch.cuda.current_device()))
    mesh = make_mesh((1, 1), ("data", "model"))
    try:
        for where, m in (("no mesh", None), ("mesh (1 x 1)", mesh)):
            d = tempfile.mkdtemp(prefix="time_mesh_step_")
            rt = MANARuntime(cfg, rc, ckpt_dir=d, mesh=m, device="cuda")
            rt.initialize()
            torch.cuda.synchronize()
            stamps = [time.monotonic()]
            rt.run(STEPS, on_metrics=lambda s, _: stamps.append(
                time.monotonic()))
            step_s = [b - a for a, b in zip(stamps, stamps[1:])]
            losses = [h["loss"] for h in rt.history]
            rt.close()
            del rt
            shutil.rmtree(d, ignore_errors=True)
            torch.cuda.empty_cache()
            print(f"{tag}, {where}: step_s "
                  f"{[round(x, 4) for x in step_s]}, median after the "
                  f"first {statistics.median(step_s[1:]):.4f} s; losses "
                  f"{losses}; threads {threading.active_count()}, gc "
                  f"objects {len(gc.get_objects())} [{card}]", flush=True)
    finally:
        dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="the tree's src directory to import repro_torch from")
    ap.add_argument("--after-smoke", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_mesh_step: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(0, ROOT)
    import chip_smoke

    card = chip_smoke.card_line()
    import repro_torch

    print(f"repro_torch from {os.path.dirname(repro_torch.__file__)} "
          f"[{card}]", flush=True)
    time_steps("fresh", card)
    if args.after_smoke:
        if chip_smoke.main() != 0:
            return 1
        time_steps("after the smoke", card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
