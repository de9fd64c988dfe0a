#!/usr/bin/env python3
"""The dry-run over every (arch x shape) cell of one production mesh, a
few cells at a time, each `python -m repro_torch.launch.dryrun` in a
process of its own.

    PYTHONPATH=src python3 tools/sweep_dryrun.py --mesh single|pod \\
        --out DIR [--jobs 6] [--rc JSON] [--cells ARCH:SHAPE,...] \\
        [--device cuda|cpu]

Each cell writes DIR/ARCH__SHAPE.json (the dry-run's record) and
DIR/ARCH__SHAPE.log; `--rc` is passed on to every cell (e.g.
'{"fsdp": false}').  At the end one line per cell (status, per-device
dot FLOPs, peak bytes, all-gather and total collective bytes, host
seconds, or the error) and the counts "SWEEP ok=.. skip=.. error=..".
Run the full-size sweeps on the card's host (fake CUDA tensors; the
card itself does nothing), not in a shared sandbox.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import ARCHS, SHAPES_BY_NAME

    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", choices=["single", "pod"], default="single")
    ap.add_argument("--out", required=True)
    ap.add_argument("--jobs", type=int, default=6)
    ap.add_argument("--rc", default=None)
    ap.add_argument("--cells", default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    cells = ([tuple(c.split(":")) for c in args.cells.split(",")]
             if args.cells else
             [(a, s) for a in ARCHS for s in SHAPES_BY_NAME])
    os.makedirs(args.out, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    todo, running, took = list(cells), {}, {}
    t_all = time.monotonic()
    while todo or running:
        while todo and len(running) < args.jobs:
            arch, shape = todo.pop(0)
            stem = os.path.join(args.out, f"{arch}__{shape}")
            if os.path.exists(stem + ".json"):   # the dry-run appends
                os.remove(stem + ".json")
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", args.mesh,
                   "--out", stem + ".json", "--device", args.device]
            if args.rc:
                cmd += ["--rc", args.rc]
            log = open(stem + ".log", "w")
            running[(arch, shape)] = (subprocess.Popen(
                cmd, env=env, stdout=log, stderr=subprocess.STDOUT), log,
                time.monotonic())
        time.sleep(1)
        for cell, (proc, log, t0) in list(running.items()):
            if proc.poll() is not None:
                log.close()
                took[cell] = time.monotonic() - t0
                del running[cell]
    counts = {"ok": 0, "skip": 0, "error": 0}
    for arch, shape in cells:
        path = os.path.join(args.out, f"{arch}__{shape}.json")
        if not os.path.exists(path):
            rec = {"status": "error", "error": "no record (see the log)"}
        else:
            with open(path) as f:
                (rec,) = json.load(f)
        counts[rec["status"]] += 1
        line = f"{arch} x {shape}: {rec['status']}"
        if rec["status"] == "ok":
            coll = rec["collectives"]
            line += (f", dot_flops {rec['hlo']['dot_flops']:.4e}, peak "
                     f"{rec['memory']['peak_bytes']}, all-gather "
                     f"{coll['all-gather']}, collectives {coll['total']} in "
                     f"{coll['count']}, rc {rec.get('rc')}")
        else:
            line += f": {rec.get('error', rec.get('reason'))}"[:300]
        print(f"{line} ({took[(arch, shape)]:.1f} s)", flush=True)
    print(f"SWEEP mesh {args.mesh} rc {args.rc}: ok={counts['ok']} "
          f"skip={counts['skip']} error={counts['error']} in "
          f"{time.monotonic() - t_all:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
