#!/usr/bin/env python3
"""Designs of the XOR delta kernel timed against each other and against
`torch.bitwise_xor`, call by call in turns, on one GPU.

    python3 tools/time_xor_designs.py [NAME=SOURCE ...]

Builds, with `nvcc` and the port's flags (`_build.NVCC_FLAGS`, sm_90a),
into `build/xor_designs/`: the shipped kernel
(`src/repro_torch/kernels/delta/csrc/delta.cu`) and the two persistent
designs first proposed for it, the TMA ring and the register path of
`tools/xor_designs.cu`, each with and without its cache hints.  Each
NAME=SOURCE adds a source with `xor_launch`'s C entry point (a parent
commit's `delta.cu`, unpacked elsewhere).

Every design is first held bit for bit against `torch.bitwise_xor` at
`chip_smoke.py`'s edge cases and on every input below.  Then each of 3
rounds times all designs and the library call in turns, 120 calls each,
at `chip_smoke.py`'s sizes (`xor_sizes`: the embedding pair, the world
shards in rotation, the 14 leaves of qwen2-0.5b); the order rotates from
round to round.  Prints median, quartiles, range, verdict against the
library call and the share of the bound (3 * bytes / 3.35 TB/s) for
each, then the medians of every round, with the card's name and power
limit.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

DESIGNS = [("shipped", "src/repro_torch/kernels/delta/csrc/delta.cu", []),
           ("ring", "tools/xor_designs.cu", ["-DXOR_DESIGN=1"]),
           ("ring-nohint", "tools/xor_designs.cu",
            ["-DXOR_DESIGN=1", "-DXOR_HINTS=0"]),
           ("register", "tools/xor_designs.cu", ["-DXOR_DESIGN=2"]),
           ("register-nohint", "tools/xor_designs.cu",
            ["-DXOR_DESIGN=2", "-DXOR_HINTS=0"])]
ROUNDS, REPS = 3, 120
BUILD = os.path.join(ROOT, "build", "xor_designs")


def build(designs):
    """nvcc for every design at once; returns {name: xor_launch}."""
    from repro_torch.kernels import _build

    os.makedirs(BUILD, exist_ok=True)
    procs = {}
    for name, src, flags in designs:
        so = os.path.join(BUILD, f"{name}.so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", so,
             os.path.join(ROOT, src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for design {name}:\n{text}")
        fn = ctypes.CDLL(so).xor_launch
        fn.argtypes = _build.SIGNATURES["delta"]["xor_launch"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_xor_designs: needs a CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import (CROSS_NUMEL, bound_ms, card_line, interleaved_ms,
                            spread, verdict, xor_edge_cases, xor_pass,
                            xor_sizes, xor_triples, xor_turns)
    from repro_torch.kernels.delta import ops as dops

    card = card_line()
    print(card, flush=True)
    designs = DESIGNS + [(n, s, []) for n, _, s in
                         (a.partition("=") for a in sys.argv[1:])]
    fns = build(designs)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    a = torch.randn((151936, 896), generator=gen, device=dev)
    b = a.clone()
    b.view(-1)[::7] += 1.0
    sizes, w = xor_sizes(gen, dev, a, b)
    sizes = {what: [xor_triples(g) for g in groups]
             for what, groups in sizes.items()}
    edges = [(x, y, torch.empty_like(x) if o is None else o)
             for x, y, o in xor_edge_cases(w[:CROSS_NUMEL], dops.tile())]
    checks = edges + [t for groups in sizes.values() for g in groups
                      for t in g]
    for name, fn in fns.items():
        for x, y, o in checks:
            o.fill_(0)
            xor_pass(fn, [(x, y, o)])()
            if not torch.equal(o, torch.bitwise_xor(x, y)):
                raise AssertionError(f"design {name} != torch.bitwise_xor "
                                     f"at {x.numel()} bytes")
    print(f"every design bit-exact at {len(edges)} edge cases and "
          f"{len(checks) - len(edges)} inputs", flush=True)

    names = list(fns) + ["torch.bitwise_xor"]
    medians = {what: {n: [] for n in names} for what in sizes}
    for r in range(ROUNDS):
        order = names[r % len(names):] + names[:r % len(names)]
        for what, groups in sizes.items():
            runs = xor_turns([fns.get(n) for n in order], groups)
            times = dict(zip(order, interleaved_ms(runs, reps=REPS)))
            bound = bound_ms(sum(3 * t[0].numel() for t in groups[0]))
            lib_t = times["torch.bitwise_xor"]
            print(f"round {r} {what}: bound {bound:.4f} ms [{card}]",
                  flush=True)
            for n in names:
                t = times[n]
                medians[what][n].append(t[len(t) // 2])
                tail = "" if n == names[-1] else f"; {verdict(t, lib_t)}"
                print(f"  {n}: {spread(t)}; {bound / t[len(t) // 2]:.1%} of "
                      f"bound{tail}", flush=True)
    print(f"medians of the {ROUNDS} rounds (ms) [{card}]:")
    for what, by in medians.items():
        print(f"  {what}: " + "; ".join(
            f"{n} {' / '.join(f'{m:.4f}' for m in ms)}"
            for n, ms in by.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
