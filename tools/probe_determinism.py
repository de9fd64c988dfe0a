#!/usr/bin/env python3
"""Is the port's training step bit-reproducible on the card without the
caller's deterministic switch, and what does that switch cost?

    python3 tools/probe_determinism.py

Needs one GPU.  Everything runs with `torch.use_deterministic_algorithms`
off and `CUBLAS_WORKSPACE_CONFIG` unset, as a user of the port runs it,
unless an arm below says otherwise.  Prints, each with the card's name
and power limit:

  1. repeat: from one state, the train step runs twice, and the two
     results (loss, grad norm, and a digest of every leaf of the new
     params and moments) are compared bit for bit.  Once with the
     embedding as shipped (`_EmbedGather`, whose backward sums repeated
     ids in a fixed order) and once with a plain `index_select` gather
     (its backward an `index_add_`, which adds repeated ids with
     atomics on CUDA).  Full-width qwen2-0.5b at B 8 x S 1024 (as
     `chip_smoke.py` phase 2), and Mixtral-8x7B at full width cut to 1
     layer at B 2 and B 1 x S 8192 (B 1 as the train_moe phase of
     `chip_smoke.py`), with each step's peak device memory;
  2. MoE memory: the peak of one such Mixtral step while a snapshot copy
     of the whole state is held, as while `save_async` writes an image,
     at B 2 and B 1;
  3. cost: the qwen2-0.5b step (B 8 x S 1024) in its own process per
     arm, arms in turns (off, on, on without fill, and back): the switch
     off; `torch.use_deterministic_algorithms(True)` with
     CUBLAS_WORKSPACE_CONFIG=:4096:8; the same with
     `torch.utils.deterministic.fill_uninitialized_memory = False`.
     Host clock around synchronised steps, 6 after 2 warm-up steps.

Parts 1 and 2 run in this process, which drops CUBLAS_WORKSPACE_CONFIG
from its environment before CUDA starts, whatever the caller set.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

ARMS = {"off": {}, "on": {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"},
        "on-nofill": {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}}


def embed_index_select(p, tokens, dtype):
    """The embedding as it was: a gather from the cast table, whose
    backward is `index_add_`."""
    import torch

    table = p["embedding"].to(dtype)
    rows = torch.index_select(table, 0, tokens.reshape(-1).to(torch.int64))
    return rows.reshape(*tokens.shape, table.shape[-1])


def _configs():
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import RunConfig, ShapeConfig

    dense = ARCHS["qwen2-0.5b"]
    moe = dataclasses.replace(ARCHS["mixtral-8x7b"], n_layers=1)
    return {
        "qwen2-0.5b B8xS1024": (dense, RunConfig(
            model=dense, shape=ShapeConfig("probe", 1024, 8, "train"))),
        "mixtral-8x7b 1L B2xS8192": (moe, RunConfig(
            model=moe, shape=ShapeConfig("probe", 8192, 2, "train"),
            attn_chunk=128)),
        "mixtral-8x7b 1L B1xS8192": (moe, RunConfig(
            model=moe, shape=ShapeConfig("probe", 8192, 1, "train"),
            attn_chunk=128)),
    }


def _batch(cfg, rc, step, dev):
    import torch

    from repro_torch.data.pipeline import SyntheticDataset

    b = SyntheticDataset(cfg, rc.shape, seed=0).get_batch(step)
    return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


def _digests(tree):
    from repro_torch.kernels import as_bytes
    from repro_torch.kernels.checksum.ops import checksum
    from repro_torch.tree import tree_leaves

    return [checksum(as_bytes(t.contiguous())) for t in tree_leaves(tree)]


def repeat(card: str) -> None:
    import torch

    from repro_torch.core.checkpoint import _snapshot
    from repro_torch.models import layers as L
    from repro_torch.training.step import init_train_state, make_train_step

    dev = torch.device("cuda")
    shipped = L.embed_apply
    for name, (cfg, rc) in _configs().items():
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        state = init_train_state(cfg, rc, gen, dev)
        batch = _batch(cfg, rc, 0, dev)
        step = make_train_step(cfg, rc)
        for variant, fn in (("shipped", shipped),
                            ("index_select", embed_index_select)):
            L.embed_apply = fn
            runs, peaks, secs = [], [], []
            try:
                for _ in range(2):
                    torch.cuda.reset_peak_memory_stats()
                    torch.cuda.synchronize()
                    t0 = time.monotonic()
                    new, m = step(state, batch)
                    torch.cuda.synchronize()
                    secs.append(time.monotonic() - t0)
                    runs.append((m["loss"].item(), m["grad_norm"].item(),
                                 _digests(new)))
                    peaks.append(torch.cuda.max_memory_allocated())
                    del new, m
            finally:
                L.embed_apply = shipped
            (l1, g1, d1), (l2, g2, d2) = runs
            differ = sum(a != b for a, b in zip(d1, d2))
            same = l1 == l2 and g1 == g2 and not differ
            print(f"repeat {name} embedding={variant}: "
                  f"{'bit-identical' if same else 'DIFFERS'} (loss {l1!r} / "
                  f"{l2!r}, grad_norm {g1!r} / {g2!r}, {differ} of {len(d1)} "
                  f"leaves differ); step_s {[round(s, 4) for s in secs]}; "
                  f"peak {max(peaks)} bytes [{card}]", flush=True)
        del state, step, batch
        torch.cuda.empty_cache()

    # a step while a snapshot of the state is held, as during an image write
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cfgs = _configs()
    moe_cfg = cfgs["mixtral-8x7b 1L B2xS8192"][0]
    state = init_train_state(moe_cfg, cfgs["mixtral-8x7b 1L B2xS8192"][1],
                             gen, dev)
    snap = _snapshot(state, dev)
    for name in ("mixtral-8x7b 1L B2xS8192", "mixtral-8x7b 1L B1xS8192"):
        cfg, rc = cfgs[name]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            new, m = make_train_step(cfg, rc)(state, _batch(cfg, rc, 0, dev))
            torch.cuda.synchronize()
            print(f"snapshot held, {name}: step peak "
                  f"{torch.cuda.max_memory_allocated()} bytes [{card}]",
                  flush=True)
            del new, m
        except torch.cuda.OutOfMemoryError as e:
            print(f"snapshot held, {name}: out of memory at peak "
                  f"{torch.cuda.max_memory_allocated()} bytes ({e}) "
                  f"[{card}]", flush=True)
    del snap, state
    torch.cuda.empty_cache()


def arm(name: str) -> None:
    """One arm of part 3, in this process: prints one JSON line."""
    import torch

    from repro_torch.training.step import init_train_state, make_train_step

    if name != "off":
        torch.use_deterministic_algorithms(True)
    if name == "on-nofill":
        torch.utils.deterministic.fill_uninitialized_memory = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, rc = _configs()["qwen2-0.5b B8xS1024"]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = init_train_state(cfg, rc, gen, dev)
    step = make_train_step(cfg, rc)
    secs = []
    for i in range(8):
        batch = _batch(cfg, rc, i, dev)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        secs.append(time.monotonic() - t0)
    print(json.dumps({"arm": name, "step_s": secs[2:],
                      "loss": [m["loss"].item()]}), flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--arm":
        arm(sys.argv[2])
        return 0
    os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
    import torch

    if not torch.cuda.is_available():
        print("probe_determinism: needs a CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import card_line

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"deterministic algorithms "
          f"{torch.are_deterministic_algorithms_enabled()}, "
          f"CUBLAS_WORKSPACE_CONFIG "
          f"{os.environ.get('CUBLAS_WORKSPACE_CONFIG')!r}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    repeat(card)

    env = {k: v for k, v in os.environ.items()
           if k != "CUBLAS_WORKSPACE_CONFIG"}
    order = ["off", "on", "on-nofill", "on-nofill", "on", "off"]
    times = {a: [] for a in ARMS}
    for a in order:
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--arm", a], env={**env, **ARMS[a]},
                             capture_output=True, text=True, check=True)
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        times[a] += rec["step_s"]
        print(f"arm {a}: step_s {[round(s, 4) for s in rec['step_s']]} "
              f"[{card}]", flush=True)
    for a, ts in times.items():
        ts = sorted(ts)
        print(f"cost {a}: median step {ts[len(ts) // 2]:.4f} s over "
              f"{len(ts)} steps (range {ts[0]:.4f}-{ts[-1]:.4f}) [{card}]")
    med = {a: sorted(ts)[len(ts) // 2] for a, ts in times.items()}
    print(f"cost: on / off {med['on'] / med['off']:.4f}, on-nofill / off "
          f"{med['on-nofill'] / med['off']:.4f} [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
