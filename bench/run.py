"""Run one cell of the port's benchmark on this machine's card.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Set-up (imports, kernel load, the state
made on the card from the seed, the first three steps) is timed as
`setup_s`; the window then runs for `--seconds`; after it the outputs
are compared with the plain reference.  The last line of standard
output is the result as one JSON object; the numbers compared, each
with its limit, are the last lines of standard error.  Exits non-zero,
printing no result, without a CUDA card (or fewer than the cell asks
for), or where JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # build and kernel caches at fixed paths inside the checkout
    cache = os.path.join(ROOT, "build", "bench-cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(cache, sub)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch

    from bench import harness

    man = harness.manifest(ROOT)
    cell = harness.find_cell(man, args.workload)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    line = harness.execute(man, args.workload, args.seed, args.seconds,
                           bool(args.trace), t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded modules of JAX or the JAX package: {bad}",
              file=sys.stderr)
        return 4
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
