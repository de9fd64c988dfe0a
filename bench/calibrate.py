"""Readings that a cell's limits (`limits/<cell>.json`) are set from, all
in one process on the card, at the cell's own sizes:

  program   the program's first three steps (driven as set-up drives
            them) against the f32 reference, then the state held after
            the third and the program's next two steps against the f32
            reference resumed from it: one reading a seed;
  control   the reference computed in fp8 in the program's place, the
            step below the configuration's bf16, over both stages;
  half      the reference with half of each batch left out, the mean
            taken over the rest (a fault a training step can have).

    python3 bench/calibrate.py --workload <cell> --seeds 12 \
        --control-seeds 3 --first-seed <n> [--out <file.jsonl>]

Each reading is one JSON line: loss_gap, grad_gap, change_gap,
resume_loss_gap, resume_grad_gap and the leaves that gave them.  The
benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(got, ref, got_r, ref_r) -> dict:
    """The compared numbers, with what they are made of: each step's
    loss and each leaf's norms on both sides."""
    from bench import training as T

    return dict(T.gaps(got, ref), **T.resume_gaps(got_r, ref_r),
                losses=got["losses"], ref_losses=ref["losses"],
                resume_losses=got_r["losses"],
                ref_resume_losses=ref_r["losses"], grad=got["grad"],
                ref_grad=ref["grad"], change=got["change"],
                ref_change=ref["change"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2 ** 31 + 11)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch

    from bench import harness
    from bench import training as T

    man = harness.manifest(ROOT)
    cell = harness.find_cell(man, args.workload)
    pieces = harness.resolve(man, cell)
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for i in range(max(args.seeds, args.control_seeds)):
        seed = args.first_seed + 7919 * i
        with tempfile.TemporaryDirectory(prefix="bench-cal-") as d:
            run = harness.Run(cell, pieces, seed, 0.0, False,
                              torch.device("cuda"), d)
            t = time.perf_counter()
            rt = T.build_runtime(run, os.path.join(d, "images"))
            T.first_steps(run, rt)
            hold = T.Hold(run, 0.0)
            hold.reserve(rt)
            hold.take(rt, T.SEED_STEPS - 1)
            rt.run(T.RESUME_STEPS, on_metrics=lambda s, m: hold.after(rt, m))
            rt.state = None
            rt.close()
            del rt
            torch.cuda.empty_cache()
            t_prog = time.perf_counter() - t
            ref = T.reference_first_steps(run)
            ref_r = T.reference_resume(run, hold.host, T.RESUME_STEPS)
            t_ref = time.perf_counter() - t - t_prog
            base = {"workload": args.workload, "seed": seed,
                    "card": torch.cuda.get_device_name(0)}
            if i < args.seeds:
                emit(dict(base, kind="program", seconds=[t_prog, t_ref],
                          **readings(run.state["program"], ref,
                                     hold.program(), ref_r)))
            if i < args.control_seeds:
                for kind, kw in (("control", {"precision": "fp8"}),
                                 ("half", {"half": True})):
                    other = T.reference_first_steps(run, **kw)
                    other_r = T.reference_resume(run, hold.host,
                                                 T.RESUME_STEPS, **kw)
                    emit(dict(base, kind=kind,
                              **readings(other, ref, other_r, ref_r)))
            del ref, ref_r, hold
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
