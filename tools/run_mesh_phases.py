#!/usr/bin/env python3
"""`chip_smoke.py`'s mesh phases alone, on one GPU: a short call that
compiles and checks them before the whole smoke.

    python3 tools/run_mesh_phases.py [dense] [whisper] [vision]
        [serve_dense] [serve_moe] [serve_hybrid] [serve_rwkv]
        [serve_whisper] [serve_vision] [remat] [dryrun]

It builds the kernels, then runs each phase named (whisper and vision by
default) at the smoke's cells, on the smoke's (1 x 1) NCCL mesh.
dense: `chip_smoke.phase_train_mesh_family` for qwen2-0.5b at the
training cell (4 steps beside a mesh-free twin, an image at step 2, the
int8 image).  whisper and vision: the same for
whisper-large-v3 at full width cut to `MESH_LAYERS` in both stacks (3
steps beside a mesh-free twin, an image at step 2, the int8 image), and
llama-3.2-vision-11b at train_vision's cell (4 steps, one full image at
step 2).  The smoke holds vision to train_vision's losses; here, where
train_vision does not run, it runs its own mesh-free twin of the same 4
steps.  serve_*: `chip_smoke.phase_serve_mesh` at the smoke's serve
mesh cells, with `kv_time_shard`; serve_dense, serve_moe, serve_hybrid
and serve_rwkv first run their mesh-free `phase_serve`, whose logits and
tokens the mesh run is held to, as in the smoke; serve_hybrid and
serve_rwkv (hymba-1.5b and rwkv6-3b at `MESH_LAYERS`), serve_whisper
(whisper-large-v3 at `MESH_LAYERS` + `MESH_LAYERS`) and serve_vision
(one group of `VISION_LAYERS`) run their own twins.  remat and dryrun:
`chip_smoke.phase_remat` and `chip_smoke.phase_dryrun` (no mesh of
their own: the dry-run's processes start first and run beside the
phases).  Each phase prints
the smoke's report lines, its wall seconds, its peak device memory and
the kernels' launches, beside the card's name and power limit; the last
line is "run_mesh_phases: OK".
"""
from __future__ import annotations

import dataclasses
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv) -> int:
    import torch

    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as smoke
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.kernels import _build
    from repro_torch.kernels.checksum import ops as cops
    from repro_torch.kernels.delta import ops as dops
    from repro_torch.kernels.quantize import ops as qops

    card = smoke.card_line()
    smoke.log(card, f"torch {torch.__version__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke.log(f"kernels built in {_build.build_all():.2f} s")

    def shape(name):
        return ShapeConfig(name, smoke.TRAIN_4K_SEQ, smoke.TRAIN_4K_BATCH,
                           "train")

    whisper = dataclasses.replace(
        ARCHS["whisper-large-v3"], n_layers=smoke.MESH_LAYERS,
        n_enc_layers=smoke.MESH_LAYERS)
    vision = dataclasses.replace(
        ARCHS["llama-3.2-vision-11b"], n_layers=smoke.VISION_LAYERS,
        cross_attn_every=smoke.VISION_LAYERS)
    # the serve cells of `chip_smoke.main`: (cfg, rc, batch, mesh-free
    # phase first?)
    def serve(name, S):
        return ShapeConfig(name, S, 8, "prefill")

    moe = dataclasses.replace(ARCHS["mixtral-8x7b"], n_layers=4)
    hybrid = dataclasses.replace(ARCHS["hymba-1.5b"],
                                 n_layers=smoke.MESH_LAYERS)
    rwkv = dataclasses.replace(ARCHS["rwkv6-3b"], n_layers=smoke.MESH_LAYERS)
    served = {
        "serve_dense": (ARCHS["qwen2-0.5b"], RunConfig(
            model=ARCHS["qwen2-0.5b"], shape=serve("serve_h100", 2048)), 8,
            True),
        "serve_moe": (moe, RunConfig(model=moe, shape=ShapeConfig(
            "serve_h100", 8192, 4, "prefill")), 4, True),
        "serve_hybrid": (hybrid, RunConfig(
            model=hybrid, shape=serve("serve_h100", 2048)), 8, False),
        "serve_rwkv": (rwkv, RunConfig(
            model=rwkv, shape=serve("serve_h100", 2048)), 8, False),
        "serve_whisper": (whisper, RunConfig(model=whisper, shape=serve(
            "serve_h100", smoke.WHISPER_PROMPT)), 8, False),
        "serve_vision": (vision, RunConfig(model=vision, shape=serve(
            "serve_h100", 2048)), 8, False)}
    dense = ARCHS["qwen2-0.5b"]
    dense_rc = RunConfig(model=dense,
                         shape=ShapeConfig("smoke_h100", 1024, 8, "train"))
    cells = {
        "dense": (dense, dense_rc, 4, True),
        "whisper": (whisper, RunConfig(model=whisper,
                                       shape=shape("train_whisper_h100"),
                                       attn_chunk=128), 3, True),
        "vision": (vision, RunConfig(model=vision,
                                     shape=shape("train_vision_h100"),
                                     attn_chunk=128), 4, False)}
    counters = ((cops, "launches"), (dops, "launches"), (qops, "launches"),
                (qops, "dequantize_launches"))
    root = tempfile.mkdtemp(prefix="run_mesh_phases_")
    argv = argv or ["whisper", "vision"]
    jobs = {}
    if {"remat", "dryrun"} & set(argv):
        jobs = smoke.start_dry_runs(os.path.join(ROOT, "src"), root, dense,
                                    dense_rc)
    try:
        for name in argv:
            if name in ("remat", "dryrun"):
                t0 = time.monotonic()
                report: dict = {}
                torch.cuda.reset_peak_memory_stats()
                if name == "remat":
                    smoke.phase_remat(dense, dense_rc, report, jobs)
                    smoke.report_remat(report, card)
                else:
                    smoke.phase_dryrun(report, jobs)
                smoke.log(f"{name}: {time.monotonic() - t0:.1f} s, peak "
                          f"{torch.cuda.max_memory_allocated()} bytes")
                continue
            if name in served:
                cfg, rc, batch, held = served[name]
                label = name.replace("serve_", "serve_mesh_")
                free = {} if held else None
                if held:
                    smoke.phase_serve(cfg, rc, batch, root, free)
            else:
                cfg, rc, steps, int8 = cells[name]
                label = f"train_mesh_{name}"
            for mod, attr in counters:
                setattr(mod, attr, 0)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            report: dict = {}
            t0 = time.monotonic()
            if name in served:
                want = smoke._served(free) if held else None
                smoke.phase_serve_mesh(cfg, rc, batch, root, report, label,
                                       want=want)
                torch.cuda.synchronize()
                smoke.report_serve_mesh(
                    label, cfg, rc, batch, report, free,
                    torch.cuda.max_memory_allocated(),
                    time.monotonic() - t0, card)
            else:
                smoke.phase_train_mesh_family(cfg, rc, root, report, label,
                                              steps, (2,), int8=int8)
                torch.cuda.synchronize()
                smoke.report_train_mesh_family(
                    label, cfg, rc, report,
                    torch.cuda.max_memory_allocated(),
                    time.monotonic() - t0, card)
            smoke.log(f"{label}: launches checksum, XOR, quantize, "
                      f"dequantize {[getattr(m, a) for m, a in counters]}")
    finally:
        for proc, _, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if smoke._MESH:
            import torch.distributed as dist

            smoke._MESH.clear()
            dist.destroy_process_group()
    smoke.log("run_mesh_phases: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
