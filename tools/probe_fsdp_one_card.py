#!/usr/bin/env python3
"""FSDP training on the card's (1 x 1) NCCL mesh against the same run
without a mesh, for the package under a given source directory.

    python3 tools/probe_fsdp_one_card.py [SRC]

SRC defaults to this checkout's `src`; give a parent commit's, unpacked
under `build/` with `git archive`, to see what it does.  qwen2-0.5b at
full width cut to 2 layers, B 8 x S 1024, 2 steps with `fsdp` (on one
device `zero1_shard` puts the data axis of size 1 on dim 0 of every
stacked leaf): prints one line, "PROBE <src>: ..." with the losses
beside the mesh-free run's, or the exception the mesh run raised, and
the card's name and power limit.  Needs one CUDA card.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv) -> int:
    src = os.path.abspath(argv[0] if argv else os.path.join(ROOT, "src"))
    sys.path.insert(0, src)
    import torch
    import torch.distributed as dist

    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.core.runtime import MANARuntime
    from repro_torch.launch.mesh import make_mesh

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(ARCHS["qwen2-0.5b"], n_layers=2)
    rc = RunConfig(model=cfg, shape=ShapeConfig("probe", 1024, 8, "train"),
                   fsdp=True)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        free = MANARuntime(cfg, rc, ckpt_dir=tempfile.mkdtemp(),
                           device="cuda")
        free.initialize()
        want = [h["loss"] for h in free.run(2)]
        free.close()
        try:
            rt = MANARuntime(cfg, rc, ckpt_dir=tempfile.mkdtemp(),
                             mesh=make_mesh((1, 1), ("data", "model")),
                             device="cuda")
            rt.initialize()
            got = [h["loss"] for h in rt.run(2)]
            rt.close()
            said = (f"fsdp losses {got}, mesh-free {want}, "
                    f"{'bit-equal' if got == want else 'NOT bit-equal'}")
        except Exception as e:  # noqa: BLE001 — the finding is the error
            said = f"fsdp raised {type(e).__name__}: {str(e)[:600]}"
    finally:
        dist.destroy_process_group()
    print(f"PROBE {src}: {said} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
