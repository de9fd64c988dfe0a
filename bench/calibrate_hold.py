"""Readings that a training cell's limits are set from, at the cell's
own hold point, all in one process on the card at the cell's sizes:

  program   the program's first three steps against the f32 reference;
            then the program trained on to step `--hold-step` (the step
            after which the cell's window holds its state), the state
            held, and the program's next step against the f32 reference
            resumed from it;
  control   the reference computed in fp8 in the program's place, over
            both stages;
  half      the reference with half of each batch left out, the mean
            taken over the rest (of a single row, the later half of its
            positions).

    python3 bench/calibrate_hold.py --workload <cell> --hold-step <n> \\
        --seeds 3 --control-seeds 3 --first-seed <n> [--out <file.jsonl>]

The cell's driver makes the program and its state (its `setup`) and,
where it has them, its reference (`reference_first_steps`,
`reference_resume`), else `bench.training`'s.  Each reading is one JSON
line, as `bench/calibrate.py` writes (which holds after set-up's third
step).  The benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--hold-step", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2 ** 31 + 11)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch

    from bench import harness
    from bench import training as T
    from bench.calibrate import readings

    man = harness.manifest(ROOT)
    cell = harness.find_cell(man, args.workload)
    pieces = harness.resolve(man, cell)
    D = harness.load_module(pieces["driver"], "bench_driver_calibrate")
    first = getattr(D, "reference_first_steps", T.reference_first_steps)
    resume = getattr(D, "reference_resume", T.reference_resume)
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
            D.setup(run)
            rt, hold = run.state.pop("rt"), run.state.pop("hold")
            rt.run(args.hold_step + 1 - T.SEED_STEPS)
            hold.take(rt, args.hold_step)
            rt.run(T.RESUME_STEPS, on_metrics=lambda s, m: hold.after(rt, m))
            rt.state = None
            rt.close()
            del rt
            torch.cuda.empty_cache()
            t_prog = time.perf_counter() - t
            ref = first(run)
            ref_r = resume(run, hold.host, T.RESUME_STEPS)
            t_ref = time.perf_counter() - t - t_prog
            base = {"workload": args.workload, "seed": seed,
                    "hold_step": args.hold_step,
                    "card": torch.cuda.get_device_name(0)}
            if i < args.seeds:
                emit(dict(base, kind="program", seconds=[t_prog, t_ref],
                          **readings(run.state["program"], ref,
                                     hold.program(), ref_r)))
            if i < args.control_seeds:
                for kind, kw in (("control", {"precision": "fp8"}),
                                 ("half", {"half": True})):
                    other = first(run, **kw)
                    other_r = resume(run, hold.host, T.RESUME_STEPS, **kw)
                    emit(dict(base, kind=kind,
                              **readings(other, ref, other_r, ref_r)))
            del ref, ref_r, hold
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
