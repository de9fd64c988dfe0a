#!/usr/bin/env python3
"""The CPU training CLI under load: does a resume still repeat the
uninterrupted run, and how close do the side-by-side runs of
tests/test_torch_entrypoints.py come to its 300 s `communicate` limit?

    python3 tools/stress_cli_resume.py trios [--n 6] [--busy 4] [--arch rwkv6-3b]
    python3 tools/stress_cli_resume.py wave [--busy 0] [--torch-busy 0]

`trios` runs N fresh (4 steps) / uninterrupted (6 steps) pairs side by
side, then each `--resume` (2 steps), beside `--busy` busy-loop
processes, and prints whether each resume's losses equal its
uninterrupted run's steps 4-5.  `wave` starts the 13 processes of the
test fixture's first wave at once, beside `--busy` busy loops and
`--torch-busy` torch matmul loops (each on torch's default thread
count), and prints each process's seconds.  Both run on the CPU from
the checkout's `src/`, in a temporary directory.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, SRC)

from repro_torch.configs import ARCHS  # noqa: E402

ENV = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
FLAGS = ["--reduced", "--batch", "2", "--seq", "64", "--ckpt-every-steps",
         "2", "--delta-params"]
TORCH_LOOP = ("import torch\na = torch.randn(512, 512)\n"
              "while True:\n    a = torch.tanh(a @ a)\n")


def port(arch, *more):
    return [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
            *FLAGS, "--device", "cpu", *more]


def start(argv, d=None):
    if d is not None:
        argv = [*argv, "--ckpt-dir", d]
    return subprocess.Popen(argv, env=ENV, stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True)


def losses(out: str, steps=(4, 5)):
    rows = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    return [r["loss"] for r in rows if r["step"] in steps]


def loads(busy: int, torch_busy: int):
    return ([subprocess.Popen(["sh", "-c", "while :; do :; done"])
             for _ in range(busy)]
            + [subprocess.Popen([sys.executable, "-c", TORCH_LOOP])
               for _ in range(torch_busy)])


def trios(args, root: str) -> None:
    runs = []
    for i in range(args.n):
        d = os.path.join(root, f"t{i}")
        runs.append((d, start(port(args.arch, "--steps", "4"), d + "a"),
                     start(port(args.arch, "--steps", "6"), d + "b")))
    six = [(d, b.communicate()[0], a.communicate()) for d, a, b in runs]
    resumed = [(start(port(args.arch, "--steps", "2", "--resume"), d + "a"),
                out) for d, out, _ in six]
    for i, (proc, out) in enumerate(resumed):
        got, want = losses(proc.communicate()[0]), losses(out)
        print(json.dumps({"trio": i, "equal": got == want, "resumed": got,
                          "uninterrupted": want}))


def wave(args, root: str) -> None:
    quick = [sys.executable, "-m", "repro_torch.examples.quickstart",
             "--device", "cpu", "--ckpt-dir", os.path.join(root, "q")]
    ref = [sys.executable, "-m", "repro.launch.train", "--arch",
           "qwen2-0.5b", *FLAGS, "--steps", "6"]
    cmds = {"fresh": port("qwen2-0.5b", "--steps", "4"),
            "port6": port("qwen2-0.5b", "--steps", "6"), "ref6": ref,
            "socket_int8": port("qwen2-0.5b", "--steps", "4", "--transport",
                                "socket", "--quantize-moments"),
            "quickstart": quick}
    for arch, name in (("hymba-1.5b", "hybrid"), ("rwkv6-3b", "rwkv"),
                       ("whisper-large-v3", "whisper"),
                       ("llama-3.2-vision-11b", "vision")):
        cmds[f"{name}_fresh"] = port(arch, "--steps", "4")
        cmds[f"{name}6"] = port(arch, "--steps", "6")
    t0 = time.monotonic()
    procs = {k: start(v, None if k == "quickstart"
                      else os.path.join(root, k)) for k, v in cmds.items()}
    done = {}
    while len(done) < len(procs):
        for k, p in procs.items():
            if k not in done and p.poll() is not None:
                done[k] = [round(time.monotonic() - t0, 1), p.returncode]
        time.sleep(0.2)
    print(json.dumps({"busy": args.busy, "torch_busy": args.torch_busy,
                      "seconds_and_rc": done}))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=["trios", "wave"])
    ap.add_argument("--n", type=int, default=6)
    ap.add_argument("--arch", default="rwkv6-3b", choices=sorted(ARCHS))
    ap.add_argument("--busy", type=int, default=0)
    ap.add_argument("--torch-busy", type=int, default=0)
    args = ap.parse_args()
    load = loads(args.busy, args.torch_busy)
    try:
        with tempfile.TemporaryDirectory() as root:
            (trios if args.what == "trios" else wave)(args, root)
    finally:
        for p in load:
            p.kill()
            p.wait()
    return 0


if __name__ == "__main__":
    sys.exit(main())
