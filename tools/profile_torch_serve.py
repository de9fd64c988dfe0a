#!/usr/bin/env python3
"""Where the time goes in the port's serving path (prefill and greedy
decode), on one GPU, at the two serving configurations of
`chip_smoke.py`: full-width qwen2-0.5b (B=8 prompts of 2048) and
full-width Mixtral-8x7B cut to 4 of 32 layers (B=4 prompts of 8192),
bf16 compute, deterministic algorithms off as the smoke runs them.

    python3 tools/profile_torch_serve.py

Prints, for each configuration and each with the card's name and power
limit:
  * prefill seconds and decode seconds per token by host clock around
    synchronised calls (the prefill once warm, 8 decode steps after 2
    warm-up steps);
  * from `torch.profiler`, for one prefill and for 3 decode steps: the
    wall time, the summed CUDA kernel time, the device's busy share
    (kernel time over wall), kernel launches per call, and the top
    kernels by device time.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def _profile(fn, n: int, card: str, label: str, top: int = 10):
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.end - e.time_range.start
            tot, k = kernels.get(e.name, (0.0, 0))
            kernels[e.name] = (tot + us, k + 1)
    busy = sum(t for t, _ in kernels.values()) / 1e6
    launches = sum(k for _, k in kernels.values())
    print(f"{label}: profiled {n} call(s): wall {wall / n:.4f} s/call, "
          f"device kernel time {busy / n:.4f} s/call, busy share "
          f"{busy / wall:.4f}, {launches / n:.0f} kernels/call [{card}]")
    for name, (us, k) in sorted(kernels.items(),
                                key=lambda kv: -kv[1][0])[:top]:
        print(f"  {us / 1e3 / n:10.3f} ms/call  x{k // n:<5d} {name[:90]}")
    sys.stdout.flush()


def run(name, cfg, rc, batch: int, card: str):
    import torch

    from repro_torch.models.transformer import init_params
    from repro_torch.training.step import make_serve_steps

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params, _ = init_params(cfg, gen, dev)
    prefill_step, serve_step = make_serve_steps(cfg, rc)
    prompts = torch.randint(0, cfg.vocab_size, (batch, rc.shape.seq_len),
                            generator=gen, device=dev, dtype=torch.int32)
    batch_in = {"tokens": prompts}
    prefill_step(params, batch_in)                      # warm
    torch.cuda.synchronize()
    t0 = time.monotonic()
    logits, state = prefill_step(params, batch_in)
    torch.cuda.synchronize()
    print(f"{name}: prefill_s {time.monotonic() - t0:.4f} [{card}]")
    _profile(lambda: prefill_step(params, batch_in), 1, card,
             f"{name} prefill")

    box = {"state": state,
           "tok": torch.argmax(logits, -1).to(torch.int32)[:, None]}

    def step():
        out, box["state"] = serve_step(params, box["state"], box["tok"])
        box["tok"] = torch.argmax(out[:, -1], -1).to(torch.int32)[:, None]

    for _ in range(2):
        step()
    times = []
    for _ in range(8):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        step()
        torch.cuda.synchronize()
        times.append(time.monotonic() - t0)
    print(f"{name}: decode_s per token {[round(t, 4) for t in times]} "
          f"[{card}]")
    _profile(step, 3, card, f"{name} decode")
    del params, state, box, logits
    torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_serve: needs a CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import card_line
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import RunConfig, ShapeConfig

    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dense = ARCHS["qwen2-0.5b"]
    run("serve_dense", dense,
        RunConfig(model=dense, shape=ShapeConfig("s", 2048, 8, "prefill")),
        8, card)
    moe = dataclasses.replace(ARCHS["mixtral-8x7b"], n_layers=4)
    run("serve_moe", moe,
        RunConfig(model=moe, shape=ShapeConfig("s", 8192, 4, "prefill")),
        4, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
