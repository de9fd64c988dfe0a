#!/usr/bin/env python3
"""Where the time goes in the port's training step and image write, on
one GPU, at the configuration of `chip_smoke.py` (full-width qwen2-0.5b,
B=8, S=1024, bf16 compute).

    python3 tools/profile_torch_step.py

Prints, each with the card's name and power limit:
  * the step split into forward (loss), backward and optimizer, by host
    clock around synchronised sections, over 3 steps after 2 warm-up,
    with deterministic algorithms on as `chip_smoke.py` runs them, then
    again with `torch.utils.deterministic.fill_uninitialized_memory` off
    (deterministic mode otherwise fills every fresh allocation with NaN);
  * the top CUDA kernels of one step by device time, and the device's
    busy share of that step, from `torch.profiler`;
  * an image write split into digest kernels (on the card), the
    device-to-host copy of every state leaf, and the file write of those
    bytes, against `CheckpointManager.save` of the same state.
"""
from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_step: needs a CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import card_line
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.core.checkpoint import CHUNK_BYTES, CheckpointManager
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.kernels import _build, as_bytes
    from repro_torch.kernels.checksum.ops import checksum
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.training.step import init_train_state
    from repro_torch.tree import tree_leaves, tree_unflatten

    card = card_line()
    print(card, flush=True)
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ARCHS["qwen2-0.5b"]
    rc = RunConfig(model=cfg, shape=ShapeConfig("smoke_h100", 1024, 8, "train"))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = init_train_state(cfg, rc, gen, dev)
    ds = SyntheticDataset(cfg, rc.shape, seed=0)

    def step(i, split):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in ds.get_batch(i).items()}
        params = state["params"]
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        torch.cuda.synchronize()
        t0 = time.monotonic()
        loss, _ = T.forward_loss(tree_unflatten(params, leaves), cfg, rc,
                                 None, batch)
        torch.cuda.synchronize()
        t1 = time.monotonic()
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        t2 = time.monotonic()
        lr = adamw.lr_schedule(state["step"], rc.lr)
        p, o, _ = adamw.apply_updates(params, tree_unflatten(params, grads),
                                      state["opt"], lr=lr)
        torch.cuda.synchronize()
        t3 = time.monotonic()
        state.update(params=p, opt=o, step=state["step"] + 1)
        split.append((t1 - t0, t2 - t1, t3 - t2))

    _build.build_all()
    warm = []
    for i in range(2):
        step(i, warm)
    for fill in (True, False):
        torch.utils.deterministic.fill_uninitialized_memory = fill
        split = []
        for i in range(2, 5):
            step(i, split)
        tag = f"fill_uninitialized_memory={fill}"
        for name, k in (("forward", 0), ("backward", 1), ("optimizer", 2)):
            print(f"{name}_s {[round(s[k], 4) for s in split]} {tag} "
                  f"[{card}]")
        print(f"step_s {[round(sum(s), 4) for s in split]} {tag} [{card}]",
              flush=True)
    torch.utils.deterministic.fill_uninitialized_memory = True

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        step(5, [])
        wall = time.monotonic() - t0
    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.end - e.time_range.start
            tot, n = kernels.get(e.name, (0.0, 0))
            kernels[e.name] = (tot + us, n + 1)
    busy = sum(t for t, _ in kernels.values()) / 1e6
    print(f"profiled step: wall {wall:.4f} s, device kernel time {busy:.4f} s, "
          f"busy share {busy / wall:.4f} [{card}]")
    for name, (us, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"  {us / 1e3:10.3f} ms  x{n:<5d} {name[:90]}")

    # image write split, on this state
    leaves = tree_leaves(state)
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    chunks = [as_bytes(t)[o:o + CHUNK_BYTES] for t in leaves
              for o in range(0, max(t.numel() * t.element_size(), 1),
                             CHUNK_BYTES)]
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    for c in chunks:
        checksum(c)
    b.record()
    b.synchronize()
    digest_ms = a.elapsed_time(b)
    t0 = time.monotonic()
    host = [c.cpu().numpy() for c in chunks]
    d2h = time.monotonic() - t0
    d = tempfile.mkdtemp(prefix="profile_write_")
    t0 = time.monotonic()
    for i, h in enumerate(host):
        with open(os.path.join(d, str(i)), "wb") as f:
            f.write(h)
    disk = time.monotonic() - t0
    del host
    mgr = CheckpointManager(os.path.join(d, "mgr"), device=dev)
    t0 = time.monotonic()
    stats = mgr.save(1, state)
    save = time.monotonic() - t0
    shutil.rmtree(d, ignore_errors=True)
    print(f"image of {nbytes} bytes in {len(chunks)} chunks: digest kernels "
          f"{digest_ms / 1e3:.4f} s (one host sync per chunk), "
          f"device-to-host {d2h:.4f} s ({nbytes / d2h / 1e9:.2f} GB/s), file "
          f"write {disk:.4f} s ({nbytes / disk / 1e9:.2f} GB/s); "
          f"CheckpointManager.save {save:.4f} s (write_s "
          f"{stats['write_s']}) [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
