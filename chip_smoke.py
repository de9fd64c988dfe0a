#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, `nvcc` (sm_90a) and the checkout's `src/`; it
imports nothing of JAX or of the JAX package `repro`.  It sets no
determinism switch: `torch.use_deterministic_algorithms` stays off and
CUBLAS_WORKSPACE_CONFIG is left as the caller has it, so every phase
checks the bit-identity contract as a user of the port gets it.  Phases,
each fatal on failure:

  0. setup: card name and power limit, TF32 off for matmul and cuDNN (a
     numerics choice, not a determinism switch: the reference computes
     with f32 params and f32 matmuls), build of the kernels from
     `src/repro_torch/kernels/*/csrc`;
  1. each kernel (checksum, XOR delta, int8 quantize, int8 dequantize)
     against its plain PyTorch version on the card, bit for bit, at the
     main path's shapes and at edge lengths; device times of kernel,
     plain version and, where one PyTorch call computes the same
     function (`torch.bitwise_xor`, `torch.mul`), that call, beside the
     bound bytes / 3.35 TB/s; XOR and `torch.bitwise_xor` also timed
     call by call in turns (120 each: median, quartiles, range, and a
     verdict) at (a) the (151936, 896) f32 embedding pair, (b) the world
     shards, distinct ones in rotation as the world phases XOR them, and
     (c) a pass over all 14 parameter leaves of qwen2-0.5b; XOR, quantize
     and dequantize also bit for bit against their plain versions at a
     full-width Mixtral-8x7B expert leaf, (16, 4096, 7168) f32
     (1,879,048,192 bytes), at hymba-1.5b's largest leaf, (32, 1600,
     5504) f32 (1,127,219,200 bytes), at hymba's smallest, (32, 16) f32
     (one padded 1024-value quantize row), and at rwkv6-3b's full-depth
     largest leaf, (32, 2560, 8960) f32 (2,936,012,800 bytes, past 2^31:
     where a 32-bit byte count or offset would show), with their times
     there; checksum of each of these leaves equal to its plain version's
     (and at 2 KiB, the smallest leaf's tail, short of one 8 KiB block);
  2. main path: full-width qwen2-0.5b through `MANARuntime` on cuda,
     6 steps with an image every 2 (XOR-delta params), then a fresh
     runtime restores step 4 (chain 4 -> 2) and its 2 steps must repeat
     the first run's losses exactly;
  3. main path with int8 moments: one image, restored on the card
     (dequantize kernel); params and step bit-identical, moments within
     scale/2, every chunk's manifest digest equal to the numpy
     `checksum_np` of its file;
  train_mesh, train_mesh_moe, train_mesh_hybrid, train_mesh_rwkv,
     train_mesh_whisper, train_mesh_vision (run last, after the train
     phases): the main path on a `DeviceMesh`
     through `MANARuntime(mesh=...)` on a (1 x 1) ("data", "model") mesh
     over an NCCL world of 1 made in this process (`HashStore`; made by
     the first mesh phase, shared by the others and destroyed after the
     last), every state leaf a DTensor (`phase_train_mesh_family`): the
     run's images are restored without a mesh (the last, equal to the
     mesh state) and onto the mesh (the first, whose resumed steps must
     repeat the run bit for bit); the losses (and MoE's `moe_aux`) are
     held to the same config's mesh-free steps from the same seed
     (bit-equal, or else the reference's cross-topology rtol 5e-3 with
     the largest relative difference printed); with an int8 image, the
     resumed state is written with int8 moments and XOR-delta params on
     the first image and restored onto the mesh (params and step
     bit-identical, moments within scale/2).  train_mesh: full-width
     qwen2-0.5b, 4 steps with XOR-delta images at 2 and 4 (the step-4
     chain restored without a mesh), held to phase 2's losses, with the
     int8 image.  train_mesh_moe: train_moe's config (Mixtral-8x7B at
     full width, 1 layer, B 1 x S 8192, 16 dispatch groups of 512
     tokens, `moe_mode="ep"`), 4 steps with one full image at step 2,
     held to train_moe's steps 0-3.  train_mesh_hybrid,
     train_mesh_rwkv and train_mesh_whisper: hymba-1.5b, rwkv6-3b and
     whisper-large-v3 at full width cut to 2 layers (`MESH_LAYERS`;
     whisper in both stacks, 1500 frames a sample), B 4 x S 4096: 3 steps
     without a mesh, then 3 on the mesh from the same seed with an image
     at step 2, and the int8 image.  train_mesh_vision: train_vision's
     config (llama-3.2-vision-11b at full width, one group of 3 layers,
     1600 patches a sample), 4 steps with one full image at step 2, held
     to train_vision's steps 0-3;
  serve_mesh_dense, serve_mesh_moe, serve_mesh_hybrid, serve_mesh_rwkv,
     serve_mesh_whisper, serve_mesh_vision (last, after the train mesh
     phases, on the same NCCL group): the serving path on the (1 x 1)
     mesh with `kv_time_shard` (the cache's time dim over "model", as the
     reference's serving cells shard it; over one device the slot write
     still takes its local-shard path), through `make_serve_steps(cfg,
     rc, rules)` (`phase_serve_mesh`): params re-initialised from the
     serve phase's seed and placed by `train_state_specs(...)["params"]`,
     the prompts by `batch_specs`, each token by ("batch", None), every
     param and decode-state leaf a DTensor placed by its spec (the
     decode state by `decode_state_specs`, after the prefill and every
     step).  Prefill and 16 greedy tokens: tokens equal to the mesh-free
     run's, logits bit-equal (or else within 5e-3 of their norm, the
     largest difference printed); the XOR-delta image at token 10 (on a
     full one at 6) restored onto the mesh decodes the next tokens again
     bit for bit, and restored without a mesh equals the gathered
     state.  serve_mesh_dense and _moe serve their serve_* cells uncut
     and are held to those phases' logits and tokens, kept on the host;
     serve_mesh_hybrid and _rwkv serve serve_hybrid's and serve_rwkv's
     cells cut to `MESH_LAYERS` layers, serve_mesh_whisper and
     serve_mesh_vision serve serve_whisper's and serve_vision's cut to
     `MESH_LAYERS` + `MESH_LAYERS` layers and to train_vision's one
     group of 3, each beside a mesh-free twin at that depth;
  remat (after the train phases, before the mesh phases): the remat
     policies of `repro_torch.models.remat` on the training cell
     (qwen2-0.5b at full width and depth, B 8 x S 1024, bf16 compute):
     from one state, `REMAT_STEPS` train steps under each of "full",
     "none", "dots" and "comm"; the loss, the grad norm and every
     updated parameter under "dots" and "comm" must be "full"'s bits
     ("none"'s largest difference from them printed); each policy's
     step peak (`max_memory_allocated` above what was allocated before
     the step) and median step time beside the dry-run's predictions
     for the same cell (the step's live-set peak and its dot FLOPs, from
     `dry_run` on fake CUDA tensors in a process started with the
     smoke); both the measured and the predicted peaks must order none
     >= dots >= comm >= full, with none > full;
  dryrun (last): the dry-run's two cells, each `python -m
     repro_torch.launch.dryrun` in a process started with the smoke that
     runs on the host beside the phases (a `fake` process group of 512
     or 256 ranks, fake CUDA tensors): qwen1.5-0.5b x decode_32k on
     2x16x16 (the reference test's cell) and qwen2-0.5b x train_4k on
     16x16; each must come back "ok" with dot FLOPs above 0 and a peak,
     and the training cell with collective bytes above 0; each cell's
     line is printed with how long after its start the job was seen
     done;
  4. report: step times, image bytes, write/restore seconds, peak device
     memory, and one JSON line of the kernels with their launches on the
     main path.  The counts are set to 0 just before each main-path
     phase (2, 3, the serve phases, the world phases, cli, quickstart,
     preempt, the train phases and the mesh phases) and read just after
     it, adding the
     counts that a world phase's spawned socket ranks report from their
     own processes; each phase must launch the kernels of its path (2,
     cli: checksum, XOR; 3: checksum, quantize, dequantize; train_mesh,
     train_mesh_hybrid, train_mesh_rwkv, train_mesh_whisper: all four;
     train_mesh_moe, train_mesh_vision: checksum; serving, on a mesh
     too: checksum, XOR; world_pipeline and world_cross: XOR; quickstart,
     preempt: checksum; train_moe, train_hybrid, train_rwkv,
     train_whisper, train_vision: all four; remat, dryrun: none), and
     `launches` is their sum.  The peak device memory is reset before each phase and printed
     per phase, with each phase's wall time.
  serve_dense, serve_moe, serve_hybrid, serve_rwkv, serve_whisper,
     serve_vision: the serving path (`make_serve_steps`) with live
     decode-state images.
     qwen2-0.5b at full width and depth, 8 prompts of 2048 tokens;
     Mixtral-8x7B at full width cut to 4 of 32 layers, 4 prompts of 8192
     tokens (twice the SWA window: prefill takes the SWA path and the
     first decode wraps the ring); hymba-1.5b at full width and depth (25 heads over 5 KV heads,
     stored padded as 48 over 6; SSM heads beside SWA 1024), 8 prompts of
     2048 tokens (twice the window), uncut: its decode state adds an f32
     SSM state and a bf16 conv tail to the K/V ring (459,997,184 bytes in
     all); rwkv6-3b at full width and depth (32 layers, 40 time-mix heads
     stored padded as 48, no attention), 8 prompts of 2048 tokens, uncut:
     its decode state is an f32 `la` state and two bf16 token-shift
     states (203,948,032 bytes), whatever the prompt's length;
     whisper-large-v3 at full width and depth (32 encoder and 32 decoder
     layers, 20 heads over 20 KV heads stored padded as 32 over 32), 8
     requests of (1500, 1280) f32 frames drawn on the card and a 432-token
     prompt (with 16 decoded tokens, the decoder's 448-token context): its
     decode state adds the cross K/V `xk`/`xv`, (32, 8, 1500, 32, 64)
     bf16, 1,572,864,000 bytes each, written by prefill and never by a
     decode step (4,320,133,124 bytes in all); llama-3.2-vision-11b at
     full width and depth (40 layers: 8 groups of 4 self blocks and a
     cross block; 32 heads over 8 KV heads, unpadded; 10,110,734,336
     params stored, 40.4 GB in f32), 8 prompts of 2048 tokens, each with
     (1600, 4096) f32 stub patches drawn on the card: its decode state is
     the self blocks' K/V, (8, 4, 8, 2176, 8, 128) bf16 (2,281,701,376
     bytes for both), and the cross blocks' `xk`/`xv`, (8, 8, 1600, 8,
     128) bf16 (419,430,400 bytes for both), written by prefill and never
     by a decode step (2,701,131,780 bytes in all).  Each: prefill, 16
     greedy decode steps, an image of the decode state at token 6 (full)
     and at token 10 (XOR delta on 6); a fresh manager restores token 10
     through the chain onto the card (every leaf equal to the live
     state's), and tokens 11-15 decoded from it
     must equal the first run's tokens and logits bit for bit.  Decode
     after a shorter prefill must agree with a full forward over the
     same tokens (f32, the first 2 layers, and for whisper the first 2
     encoder layers over the same frames; for vision the first self
     block and the first cross block over the same patches, with the
     cut copy's `cross_blocks/attn/wo` zeroed, because decode runs a
     cross layer as pure cross attention and the forward does not: see
     `_check_decode_against_forward`; norm-relative 1e-3).
  world_pipeline, world_cross, world_elastic: multi-rank worlds with the
     rank state on the card, driven through the `multirank_simulation`
     twin (`src/repro_torch/examples/multirank_simulation.py`): 64 inproc
     ranks with 16 MiB f32 shards (1 GiB) checkpointed by the async
     incremental pipeline (a full image, then an XOR delta) and restored
     onto the card bit for bit; 4 ranks of 64 MiB written over socket
     (spawned ranks) and restored over inproc, and the reverse, each
     restored world committing another image; the elastic chaos twin
     (x of 2^27 float64 on 64 ranks, kill 3 -> 61, kill 1, grow back to
     64, then the final image restored into 4 socket ranks), every slice
     bit for bit arange + step.  Each prints its ranks, bytes on the
     card, image bytes, commit stall, write, restore and phase seconds,
     and peak device memory.
  cli, quickstart, preempt: the port's entry points, each run in this
     process through its `main(argv)` (so the counters see its launches),
     with its output echoed.  cli: `repro_torch.launch.train` on
     full-width qwen2-0.5b, B 8 x S 1024, an image every 2 steps with
     XOR-delta params: 4 steps fresh, then `--resume` with 2 more, then 6
     uninterrupted steps in another directory; the resumed steps' losses
     must equal the uninterrupted run's steps 4-5 exactly.  quickstart:
     the quickstart twin on the card (a restore at step 16 and 5 resumed
     steps).  preempt: the preemption twin at its default 200 steps,
     which asserts its restarted losses equal the uninterrupted run's and
     prints PASS.  Step times by host clock.
  train_moe, train_hybrid, train_rwkv, train_whisper, train_vision:
     full-width training through `MANARuntime`.
     train_moe: Mixtral-8x7B at full width cut to 1 of 32 layers (1.71 B
     params, 8 experts top-2, SWA 4096), B 1 x S 8192 (twice the window:
     the SWA path; B 2 does not fit beside an image's snapshot, see
     `MOE_BATCH`), through `MANARuntime` on the card: 6 steps with
     images requested at steps 2 and 4 (XOR-delta params; 4 is a delta
     on 2); a fresh runtime restores step 4 through the chain and its 2
     steps must repeat steps 4-5's losses and `moe_aux` bit for bit; then
     a runtime with int8 moments writes one image at step 2, checked as
     phase 3 checks qwen2-0.5b's.  Free disk under the phase's directory
     is checked before the images (it fails with the numbers), and each
     image directory is deleted when its check is done.  train_hybrid:
     the same run for hymba-1.5b at full width cut to 8 of 32 layers
     (526,542,784 params stored; heads padded to 48 over 6), B 4 x S 4096
     (see `TRAIN_4K_BATCH`; four times hymba's SWA window, so the
     sliding-window path); its losses must repeat bit for bit.
     train_rwkv: the same run for rwkv6-3b at full width cut to 4 of 32
     layers (704,107,008 params stored, heads padded 40 -> 48), B 4 x S
     4096 as train_hybrid.  train_whisper: the same run for
     whisper-large-v3 at full width cut to 8 of 32 layers in both stacks
     (699,077,120 params stored), B 4 x S 4096 decoder tokens, 1500
     frames a sample.  These three depths are cut to keep the whole smoke
     inside its time limit (see `HYBRID_LAYERS`).  train_vision: the same
     run for llama-3.2-vision-11b at full width cut to one group of 3
     layers, 2 self blocks and a cross block (1,746,960,384 params
     stored; a full group of 5 would need 78.6 GB before any activation,
     see `VISION_LAYERS`), B 4 x S 4096, 1600 patches a sample.  Each
     prints step seconds, image bytes,
     write and restore seconds, the peak device memory of its first two
     steps (before any image holds a snapshot copy of the state) and of
     the whole phase.

The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
MIB = 1 << 20


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0]


def device_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of `fn` over `reps` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def interleaved_ms(fns, reps: int = 120, warmup: int = 5):
    """Device times of single calls, the functions taking turns call by
    call (A, B, A, B, ...) so that both see the same clocks and card
    state: per function, the sorted list of `reps` times in ms.  Every
    20 turns start behind a kernel that spins on the card for about 10
    ms while the host queues them, so that the calls run back to back
    and no gap of the host's launching falls between a call's events."""
    import torch

    for _ in range(warmup):
        for fn in fns:
            fn()
    ev = [[(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
          for _ in fns]
    torch.cuda.synchronize()
    for i in range(reps):
        if i % 20 == 0:
            torch.cuda._sleep(20_000_000)   # cycles: ~10 ms at 1.98 GHz
        for fn, pairs in zip(fns, ev):
            pairs[i][0].record()
            fn()
            pairs[i][1].record()
    torch.cuda.synchronize()
    return [sorted(a.elapsed_time(b) for a, b in pairs) for pairs in ev]


def spread(times) -> str:
    """Median and spread of a sorted list of times: quartiles, range."""
    q = lambda f: times[min(len(times) - 1, int(f * len(times)))]
    return (f"median {q(0.5):.4f} ms (quartiles {q(0.25):.4f}-{q(0.75):.4f}, "
            f"range {times[0]:.4f}-{times[-1]:.4f}, n={len(times)})")


def verdict(k_t, l_t) -> str:
    """Kernel against library call from two sorted lists of times: a
    difference of medians counts only beyond the larger quartile spread."""
    q = lambda t, f: t[min(len(t) - 1, int(f * len(t)))]
    iqr = max(q(k_t, 0.75) - q(k_t, 0.25), q(l_t, 0.75) - q(l_t, 0.25))
    d = q(k_t, 0.5) - q(l_t, 0.5)
    if d > iqr:
        return "kernel slower by more than the spread"
    if -d > iqr:
        return "kernel faster by more than the spread"
    return "level within the spread"


def xor_leaf_pairs(gen, dev):
    """Every parameter leaf of full-width qwen2-0.5b (14 f32 leaves, about
    2.0 GB) on the card, each with a copy that differs in every 7th
    value: one delta image's worth of XOR work."""
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.models.transformer import init_params
    from repro_torch.tree import tree_leaves

    shapes, _ = init_params(ARCHS["qwen2-0.5b"], None, "meta")
    pairs = []
    for leaf in tree_leaves(shapes):
        x = torch.randn(leaf.shape, generator=gen, device=dev)
        y = x.clone()
        y.view(-1)[::7] += 1.0
        pairs.append((x, y))
    return pairs


def xor_edge_cases(buf, tile: int):
    """(a, b, out) byte views cut from the bytes of a tensor of 32 MiB or
    more at the XOR kernel's edges (`tile`: the bytes of each input one
    CTA takes): one tile, a tile + 16 and + 1 bytes, many waves of CTAs,
    the longest tail, three views sharing a 3-byte misalignment (the
    peeled head), and views misaligned by 1 and 2 bytes (the byte loop).
    `out` is None where `xor_bytes` allocates it; the shared
    misalignment needs an output view of its own."""
    import torch

    from repro_torch.kernels import as_bytes

    r = as_bytes(buf)
    n = r.numel() // 2

    def cut(off_a, off_b, m, off_out=None):
        out = None
        if off_out is not None:
            out = torch.empty(m + 16, dtype=torch.uint8, device=r.device)
            out = out[off_out:off_out + m]
        return r[off_a:off_a + m], r[n + off_b:n + off_b + m], out

    return [cut(0, 0, tile), cut(0, 0, tile + 16), cut(0, 0, tile + 1),
            cut(0, 0, n - 64), cut(0, 0, 3 * tile + 16 * 5 + 15),
            cut(3, 3, 5 * tile + 7, off_out=3), cut(1, 2, 2 * tile + 5)]


def xor_sizes(gen, dev, a, b):
    """The main path's sizes at which XOR is timed, each a list of groups
    of (x, y) pairs; one call XORs one group, and calls rotate through
    the groups.  (a) the embedding pair (a, b); (b) the world shards as
    the world phases XOR them, distinct ranks' shards: 8 of 16 MiB and 4
    of 64 MiB of f32 (384 and 768 MiB of inputs and outputs a rotation,
    far beyond the 50 MB L2, so no call finds its bytes there), cut from
    1 GiB and a copy that differs in every 97th value; (c) one pass over
    every parameter leaf of qwen2-0.5b.  Returns the sizes and the 1 GiB
    shard buffer."""
    import torch

    w = torch.randn((4 * CROSS_NUMEL,), generator=gen, device=dev)
    w2 = w.clone()
    w2[::97] += 1.0
    cut = lambda n, k: [[(w[i * n:(i + 1) * n], w2[i * n:(i + 1) * n])]
                        for i in range(k)]
    leaves = xor_leaf_pairs(gen, dev)
    return {"(a) (151936, 896) f32 pair": [[(a, b)]],
            f"(b) world shard ({WORLD_NUMEL},) f32, 8 in rotation":
                cut(WORLD_NUMEL, 8),
            f"(b) cross shard ({CROSS_NUMEL},) f32, 4 in rotation":
                cut(CROSS_NUMEL, 4),
            f"(c) qwen2-0.5b params, {len(leaves)} leaves": [leaves]}, w


def xor_triples(pairs):
    """(a, b, out) flat byte views for `xor_pass`."""
    import torch

    from repro_torch.kernels import as_bytes

    return [(as_bytes(x), as_bytes(y), torch.empty_like(as_bytes(x)))
            for x, y in pairs]


def xor_pass(launch, triples):
    """One pass over (a, b, out) byte triples: `launch` is a C entry
    point with `xor_launch`'s signature, None takes `torch.bitwise_xor`."""
    import torch

    from repro_torch.kernels import _build

    if launch is None:
        def run():
            for x, y, o in triples:
                torch.bitwise_xor(x, y, out=o)
        return run

    def run():
        s = torch.cuda.current_stream().cuda_stream
        for x, y, o in triples:
            _build.check(launch(x.data_ptr(), y.data_ptr(), o.data_ptr(),
                                x.numel(), s), "xor")
    return run


def xor_turns(launches, groups):
    """For each of `launches` (as in `xor_pass`), a callable that XORs the
    next group of (a, b, out) triples of a rotation that all of them
    share, so that calls taking turns never repeat a group back to back."""
    passes = [[xor_pass(launch, g) for g in groups] for launch in launches]
    turn = itertools.count()
    return [lambda p=p: p[next(turn) % len(p)]() for p in passes]


# ---------------------------------------------------------------------------
# phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------

def phase_kernels(card: str):
    import numpy as np
    import torch

    from repro_torch.kernels import _build, as_bytes
    from repro_torch.kernels.checksum import ops as cops, ref as cref
    from repro_torch.kernels.delta import ops as dops, ref as dref
    from repro_torch.kernels.quantize import ops as qops, ref as qref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    stream = lambda: _build.stream_ptr(torch.empty(0, device=dev))
    rows = []

    # -- checksum ---------------------------------------------------------
    buf = torch.randint(0, 256, (64 * MIB + 5 + 16,), dtype=torch.uint8,
                        device=dev, generator=gen)
    err = 0
    # 2048: a (32, 16) f32 leaf of hymba's, a tail short of one block
    cases = [(0, n) for n in (1, 3, 2048, 8191, 8192, 64 * MIB,
                              64 * MIB + 5)]
    cases += [(3, 64 * MIB), (13, 8191 * 3)]      # not 16-byte aligned
    for off, n in cases:
        k = cops.checksum(buf, off, n)
        p = cref.checksum_torch(buf, off, n)
        if k != p:
            raise AssertionError(f"checksum kernel {k} != plain {p} at "
                                 f"offset {off}, {n} bytes")
        err = max(err, abs(k - p))
    host = buf[:3 * MIB + 7].cpu().numpy()
    if cops.checksum(buf, 0, host.size) != cref.checksum_np(host):
        raise AssertionError("checksum kernel != numpy twin")
    chunk = buf[:64 * MIB]
    lib = _build.library("checksum")
    n_blocks = chunk.numel() // (4 * cref.BLOCK)
    sums = torch.empty((n_blocks, 2), dtype=torch.int32, device=dev)
    out = torch.empty((1,), dtype=torch.int32, device=dev)
    k_ms = device_ms(lambda: _build.check(lib.checksum_launch(
        chunk.data_ptr(), chunk.numel(), sums.data_ptr(), out.data_ptr(),
        stream()), "checksum"))
    p_ms = device_ms(lambda: cref.checksum_torch(chunk), reps=5, warmup=1)
    rows.append(dict(
        name="checksum", route="cuda",
        source="src/repro_torch/kernels/checksum/csrc/checksum.cu",
        replaces="src/repro/kernels/checksum/checksum.py:27",
        max_abs_err=err, ms=k_ms, plain_ms=p_ms,
        bound_ms=bound_ms(chunk.numel()), bound_by="bytes", library_ms=None,
        shape="64 MiB chunk (CHUNK_BYTES)"))
    log(f"kernel checksum: bit-exact at {len(cases)} ranges + numpy twin; "
        f"64 MiB kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
        f"bound_ms={bound_ms(chunk.numel()):.4f} [{card}]")
    del buf, sums, out

    # -- XOR delta --------------------------------------------------------
    a = torch.randn((151936, 896), generator=gen, device=dev)
    b = a.clone()
    b.view(-1)[::7] += 1.0
    sizes, w = xor_sizes(gen, dev, a, b)
    err = 0
    pairs = [p for groups in sizes.values() for g in groups for p in g]
    ragged = torch.randint(0, 256, (2 * 1_000_003 + 1,), dtype=torch.uint8,
                           device=dev, generator=gen)
    pairs.append((ragged[:1_000_003], ragged[1_000_003:2_000_006]))
    pairs.append((ragged[1:1_000_004], ragged[1_000_004:]))   # unaligned
    for x, y in pairs:
        k = dops.xor_bytes(x, y)
        p = dref.xor_torch(as_bytes(x), as_bytes(y))
        if not torch.equal(k, p):
            raise AssertionError(f"xor kernel != plain at {x.numel()} elems "
                                 f"of {x.dtype}")
        err = max(err, int((k.int() - p.int()).abs().max()))
    lib = _build.library("delta")
    edges = xor_edge_cases(w[:CROSS_NUMEL], dops.tile())
    for x, y, o in edges:
        if o is None:
            o = dops.xor_bytes(x, y)
        else:
            _build.check(lib.xor_launch(x.data_ptr(), y.data_ptr(),
                                        o.data_ptr(), x.numel(), stream()),
                         "xor")
        if not torch.equal(o, dref.xor_torch(x, y)):
            raise AssertionError(f"xor kernel != plain at the edge of "
                                 f"{x.numel()} bytes")
    hx, hy = a[:3].cpu().numpy(), b[:3].cpu().numpy()
    if not np.array_equal(dops.xor_bytes(a[:3], b[:3]).cpu().numpy(),
                          dref.delta_np(hx, hy)):
        raise AssertionError("xor kernel != numpy twin")
    ra, rb = as_bytes(a), as_bytes(b)
    o = torch.empty_like(ra)
    k_ms = device_ms(lambda: _build.check(lib.xor_launch(
        ra.data_ptr(), rb.data_ptr(), o.data_ptr(), ra.numel(), stream()),
        "xor"))
    p_ms = device_ms(lambda: dref.xor_torch(ra, rb))
    l_ms = device_ms(lambda: torch.bitwise_xor(ra, rb, out=o))
    nb = 3 * ra.numel()
    # kernel and library call taking turns, call by call, at the three
    # sizes of the main path (`xor_sizes`)
    for what, groups in sizes.items():
        groups = [xor_triples(g) for g in groups]
        k_t, l_t = interleaved_ms(xor_turns([lib.xor_launch, None], groups))
        log(f"xor interleaved with torch.bitwise_xor at {what}: kernel "
            f"{spread(k_t)}; library {spread(l_t)}; bound "
            f"{bound_ms(sum(3 * t[0].numel() for t in groups[0])):.4f} ms; "
            f"{verdict(k_t, l_t)} [{card}]")
        del groups
    rows.append(dict(
        name="xor_delta", route="cuda",
        source="src/repro_torch/kernels/delta/csrc/delta.cu",
        replaces="src/repro/kernels/delta/delta.py:21",
        max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms(nb),
        bound_by="bytes", library_ms=l_ms,
        shape="(151936, 896) f32 pair (embedding leaf)"))
    log(f"kernel xor_delta: bit-exact on (151936, 896) f32, 8 world "
        f"shards ({WORLD_NUMEL},) and 4 ({CROSS_NUMEL},) f32, the "
        f"{len(list(sizes.values())[-1][0])} leaves of qwen2-0.5b, ragged, "
        f"unaligned and "
        f"{len(edges)} edge cases + numpy twin; kernel_ms={k_ms:.4f} "
        f"plain_ms={p_ms:.4f} library_ms={l_ms:.4f} "
        f"bound_ms={bound_ms(nb):.4f} [{card}]")
    del a, b, ra, rb, o, ragged, pairs, sizes, w, edges

    # -- int8 quantize ----------------------------------------------------
    x = torch.randn((24, 896, 4864), generator=gen, device=dev) * 1e-3
    err = 0.0
    for t in (x, x.view(-1)[:1_000_003], x.view(-1)[5:5 + 4 * 1024 + 77]):
        q1, s1, p1 = qops.quantize(t)
        q2, s2, p2 = qref.quantize_torch(t.reshape(-1).contiguous())
        if p1 != p2 or not torch.equal(q1, q2) or not torch.equal(s1, s2):
            raise AssertionError(f"quantize kernel != plain at {t.numel()}")
        err = max(err, float((q1.int() - q2.int()).abs().max()),
                  float((s1 - s2).abs().max()))
    small = x.view(-1)[:5000]
    qk, sk, pk = qops.quantize(small)
    qn, sn, pn = qref.quantize_np(small.cpu().numpy())
    if (pk != pn or not np.array_equal(qk.cpu().numpy(), qn)
            or not np.array_equal(sk.cpu().numpy(), sn)):
        raise AssertionError("quantize kernel != numpy twin")
    flat = x.view(-1)
    n_rows = flat.numel() // qref.QBLOCK
    qo = torch.empty((n_rows, qref.QBLOCK), dtype=torch.int8, device=dev)
    so = torch.empty((n_rows, 1), dtype=torch.float32, device=dev)
    lib = _build.library("quantize")
    k_ms = device_ms(lambda: _build.check(lib.quantize_launch(
        flat.data_ptr(), flat.numel(), qo.data_ptr(), so.data_ptr(),
        stream()), "quantize"))
    p_ms = device_ms(lambda: qref.quantize_torch(flat), reps=5, warmup=1)
    nb = 4 * flat.numel() + flat.numel() + 4 * n_rows
    rows.append(dict(
        name="quantize_int8", route="cuda",
        source="src/repro_torch/kernels/quantize/csrc/quantize.cu",
        replaces="src/repro/kernels/quantize/quantize.py:41",
        max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms(nb),
        bound_by="bytes", library_ms=None,
        shape="(24, 896, 4864) f32 (opt/m mlp leaf)"))
    log(f"kernel quantize_int8: bit-exact on (24, 896, 4864) f32 and two "
        f"ragged lengths + numpy twin; kernel_ms={k_ms:.4f} "
        f"plain_ms={p_ms:.4f} bound_ms={bound_ms(nb):.4f} [{card}]")

    # -- int8 dequantize --------------------------------------------------
    err = 0.0
    for t in (x, x.view(-1)[:1_000_003], x.view(-1)[5:5 + 4 * 1024 + 77]):
        q1, s1, p1 = qref.quantize_torch(t.reshape(-1).contiguous())
        k = qops.dequantize(q1, s1, p1, t.shape)
        p = qref.dequantize_torch(q1.view(-1), s1.view(-1),
                                  t.numel()).reshape(t.shape)
        if not torch.equal(k, p):
            raise AssertionError(f"dequantize kernel != plain at {t.numel()}")
        err = max(err, float((k - p).abs().max()))
    dk = qops.dequantize(qk, sk, pk, small.shape)
    if not np.array_equal(dk.cpu().numpy(), qref.dequantize_np(
            qn, sn, pn, small.shape, np.float32)):
        raise AssertionError("dequantize kernel != numpy twin")
    n = flat.numel()
    xo = torch.empty(n, dtype=torch.float32, device=dev)
    k_ms = device_ms(lambda: _build.check(lib.dequantize_launch(
        qo.data_ptr(), so.data_ptr(), n, xo.data_ptr(), stream()),
        "dequantize"))
    p_ms = device_ms(lambda: qref.dequantize_torch(qo.view(-1), so.view(-1),
                                                   n))
    # one library call computes the same function here (no pad): int8
    # times f32 promotes to f32
    lo = torch.empty((n_rows, qref.QBLOCK), dtype=torch.float32, device=dev)
    l_ms = device_ms(lambda: torch.mul(qo, so, out=lo))
    if not torch.equal(lo.view(-1), xo):
        raise AssertionError("torch.mul yardstick != dequantize kernel")
    nb = flat.numel() + 4 * flat.numel() + 4 * n_rows
    rows.append(dict(
        name="dequantize_int8", route="cuda",
        source="src/repro_torch/kernels/quantize/csrc/quantize.cu",
        replaces="src/repro/kernels/quantize/quantize.py:57",
        max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms(nb),
        bound_by="bytes", library_ms=l_ms,
        shape="(102144, 1024) int8 + (102144, 1) f32 (opt/m mlp leaf)"))
    log(f"kernel dequantize_int8: bit-exact on (24, 896, 4864) f32 and two "
        f"ragged lengths + numpy twin; kernel_ms={k_ms:.4f} "
        f"plain_ms={p_ms:.4f} library_ms={l_ms:.4f} "
        f"bound_ms={bound_ms(nb):.4f} [{card}]")
    del x, qo, so, xo, lo
    torch.cuda.empty_cache()
    check_leaf(card, gen, EXPERT_LEAF, "expert leaf")
    check_leaf(card, gen, HYMBA_LEAF, "hymba leaf")
    check_leaf(card, gen, HYMBA_TINY_LEAF, "hymba tiny leaf")
    check_leaf(card, gen, RWKV_LEAF, "rwkv leaf")
    return rows


# one expert leaf of full-width Mixtral-8x7B as the port stores it (8
# experts x 2 virtual, d_model 4096, d_ff 14336 / 2): 1,879,048,192 bytes
EXPERT_LEAF = (16, 4096, 7168)
# hymba-1.5b's largest leaf (the MLP's, 32 layers x d_model 1600 x d_ff
# 5504): 1,127,219,200 bytes; and its smallest, the per-head SSM
# constants `A_log`, `D`, `dt_bias` (32 layers x 16 heads: 2 KiB)
HYMBA_LEAF, HYMBA_TINY_LEAF = (32, 1600, 5504), (32, 16)
# rwkv6-3b's largest leaf at full depth, the channel mix's `wck` (32
# layers x d_model 2560 x d_ff 8960; `wcv` is its transpose):
# 2,936,012,800 bytes, the first tensor past 2^31 bytes
RWKV_LEAF = (32, 2560, 8960)


def check_leaf(card: str, gen, shape, what: str):
    """Checksum, XOR, quantize and dequantize bit for bit against their
    plain versions at one leaf of `shape` f32, before a phase that relies
    on them there: `EXPERT_LEAF` (train_moe's params and moments),
    `HYMBA_LEAF` (hymba-1.5b's at full depth), `HYMBA_TINY_LEAF` (512
    values: quantize pads them to one 1024-value row) and `RWKV_LEAF`
    (rwkv6-3b's at full depth, past 2^31 bytes, where train_rwkv's cut
    depth stops short of it); each kernel's device time there beside its
    bound."""
    import torch

    from repro_torch.kernels import _build, as_bytes
    from repro_torch.kernels.checksum import ops as cops, ref as cref
    from repro_torch.kernels.delta import ops as dops, ref as dref
    from repro_torch.kernels.quantize import ops as qops, ref as qref

    dev = torch.device("cuda")
    stream = _build.stream_ptr(torch.empty(0, device=dev))
    x = torch.randn(shape, generator=gen, device=dev) * 1e-3
    n = x.numel()
    k, p = cops.checksum(x), cref.checksum_torch(as_bytes(x))
    if k != p:
        raise AssertionError(f"checksum kernel {k} != plain {p} at {shape} "
                             f"f32")
    torch.cuda.empty_cache()
    lib = _build.library("checksum")
    sums = torch.empty((-(-4 * n // (4 * cref.BLOCK)), 2), dtype=torch.int32,
                       device=dev)
    out = torch.empty((1,), dtype=torch.int32, device=dev)
    sum_ms = device_ms(lambda: _build.check(lib.checksum_launch(
        x.data_ptr(), 4 * n, sums.data_ptr(), out.data_ptr(), stream),
        "checksum"), reps=5, warmup=1)
    del sums, out
    y = x.clone()
    y.view(-1)[::7] += 1e-3
    ra, rb = as_bytes(x), as_bytes(y)
    if not torch.equal(dops.xor_bytes(x, y), dref.xor_torch(ra, rb)):
        raise AssertionError(f"xor kernel != plain at {shape} f32")
    lib = _build.library("delta")
    o = torch.empty_like(ra)
    xor_ms = device_ms(lambda: _build.check(lib.xor_launch(
        ra.data_ptr(), rb.data_ptr(), o.data_ptr(), ra.numel(), stream),
        "xor"), reps=5, warmup=1)
    del y, rb, o
    torch.cuda.empty_cache()
    q, sc, pad = qops.quantize(x)
    q2, s2, pad2 = qref.quantize_torch(x.reshape(-1))
    if pad != pad2 or not torch.equal(q, q2) or not torch.equal(sc, s2):
        raise AssertionError(f"quantize kernel != plain at {shape} f32")
    del q2, s2
    torch.cuda.empty_cache()
    rows = -(-n // qref.QBLOCK)
    lib = _build.library("quantize")
    qo = torch.empty_like(q)
    so = torch.empty_like(sc)
    q_ms = device_ms(lambda: _build.check(lib.quantize_launch(
        x.data_ptr(), n, qo.data_ptr(), so.data_ptr(), stream), "quantize"),
        reps=5, warmup=1)
    k = qops.dequantize(q, sc, pad, shape)
    if not torch.equal(k, qref.dequantize_torch(q.view(-1), sc.view(-1),
                                                n).reshape(shape)):
        raise AssertionError(f"dequantize kernel != plain at {shape}")
    dq_ms = device_ms(lambda: _build.check(lib.dequantize_launch(
        q.data_ptr(), sc.data_ptr(), n, k.data_ptr(), stream), "dequantize"),
        reps=5, warmup=1)
    quant_bytes = 4 * n + n + 4 * rows
    log(f"{what} {shape} f32 ({4 * n} bytes): checksum, xor, quantize and "
        f"dequantize bit-exact against their plain versions; kernel_ms "
        f"checksum {sum_ms:.4f} (bound {bound_ms(4 * n):.4f}), xor "
        f"{xor_ms:.4f} (bound {bound_ms(3 * 4 * n):.4f}), quantize "
        f"{q_ms:.4f}, dequantize {dq_ms:.4f} (bound "
        f"{bound_ms(quant_bytes):.4f} each) [{card}]")
    del x, ra, q, sc, k, qo, so
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 2-3: the main path
# ---------------------------------------------------------------------------

def _timed_run(rt, n: int, on_metrics=None):
    """rt.run(n) with the host time of each step (a step ends when its
    metrics reach the host, i.e. after a device synchronise)."""
    stamps = [time.monotonic()]

    def stamp(s, m):
        stamps.append(time.monotonic())
        if on_metrics is not None:
            on_metrics(s, m)

    hist = rt.run(n, on_metrics=stamp)
    return hist, [b - a for a, b in zip(stamps, stamps[1:])]


def _check_delta_bases(rt, want: dict, label: str) -> None:
    """Each image step -> the base step of its params (None: full)."""
    if rt.ckpt.steps() != sorted(want):
        raise AssertionError(f"{label}: images at {rt.ckpt.steps()}, want "
                             f"{sorted(want)}")
    for s, base in want.items():
        with open(os.path.join(rt.ckpt.step_dir(s), "manifest.json")) as f:
            arrays = json.load(f)["arrays"]
        bases = {e.get("base_step") for p, e in arrays.items()
                 if p.startswith("params/")}
        if bases != {base}:
            raise AssertionError(f"{label}: image {s}: params delta bases "
                                 f"{bases}, want {base}")


def phase_resume(cfg, rc, root: str, report: dict):
    import torch

    from repro_torch.core.runtime import MANARuntime

    d = os.path.join(root, "resume")
    rt = MANARuntime(cfg, rc, ckpt_dir=d, ckpt_every_steps=2,
                     delta_params=True, device="cuda")
    t0 = time.monotonic()
    rt.initialize()
    torch.cuda.synchronize()
    report["init_s"] = time.monotonic() - t0
    hist, step_s = _timed_run(rt, 6)
    report["step_s"] = step_s
    report["resume_writes"] = list(rt.ckpt.stats)
    _check_delta_bases(rt, {2: None, 4: 2, 6: 4}, "phase 2")
    losses = [h["loss"] for h in hist]
    report["resume_losses"] = losses
    log(f"phase 2: 6 steps, losses {losses}, images {rt.ckpt.steps()}")
    rt.close()
    del rt
    torch.cuda.empty_cache()

    rt2 = MANARuntime(cfg, rc, ckpt_dir=d, delta_params=True, device="cuda")
    t0 = time.monotonic()
    start = rt2.restore(4)
    torch.cuda.synchronize()
    report["restore_chain_s"] = time.monotonic() - t0
    if start != 4:
        raise AssertionError(f"restored at step {start}, want 4")
    hist2, step2_s = _timed_run(rt2, 2)
    report["resumed_step_s"] = step2_s
    resumed = [h["loss"] for h in hist2]
    if resumed != losses[4:6]:
        raise AssertionError(f"resume not bit-identical: {resumed} != "
                             f"{losses[4:6]}")
    log(f"phase 2: restore of step 4 (chain 4->2) in "
        f"{report['restore_chain_s']:.3f} s; resumed losses {resumed} equal "
        f"steps 4-5 bit for bit")
    rt2.close()
    del rt2
    shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()


def _check_int8_restore(got, live) -> float:
    """An int8-moment image's restore `got` against the state `live` it
    was written from: params and step bit-identical, moments within
    scale/2.  Returns the worst |error| / scale where the scale is a
    normal f32."""
    import torch

    from repro_torch.kernels.quantize import ref as qref
    from repro_torch.tree import tree_leaves

    if not torch.equal(got["step"], live["step"]):
        raise AssertionError("restored step differs")
    for a, b in zip(tree_leaves(got["params"]), tree_leaves(live["params"])):
        if not torch.equal(a, b):
            raise AssertionError("restored params are not bit-identical")
    worst = 0.0
    for key in ("m", "v"):
        for a, b in zip(tree_leaves(got["opt"][key]),
                        tree_leaves(live["opt"][key])):
            flat = b.reshape(-1)
            pad = (-flat.numel()) % qref.QBLOCK
            amax = torch.nn.functional.pad(flat.abs(), (0, pad)).view(
                -1, qref.QBLOCK).amax(-1)
            scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                                torch.ones_like(amax))
            per = scale.repeat_interleave(qref.QBLOCK)[:flat.numel()]
            # |q*scale - x| <= scale/2 in exact arithmetic; f32 rounds
            # x/scale and q*scale by half an ulp each (q <= 127), which
            # adds at most 2 * 127 * 2^-24 * scale < 2^-15 * scale, and a
            # subnormal scale carries an absolute rounding error of up to
            # 2^-150 that q multiplies: < 2^-142
            excess = ((a.reshape(-1) - flat).abs()
                      - per * (0.5 + 2.0 ** -15) - 2.0 ** -142).max().item()
            if excess > 0:
                raise AssertionError(f"moment {key} off by more than "
                                     f"scale/2 ({excess})")
            normal = per >= torch.finfo(torch.float32).tiny
            ratio = ((a.reshape(-1) - flat).abs() / per)[normal]
            if ratio.numel():   # a leaf may have only subnormal scales
                worst = max(worst, float(ratio.max()))
    return worst


def phase_int8(cfg, rc, root: str, report: dict, label: str = "phase 3"):
    """A runtime with int8 moments writes one image at step 2; restored
    on the card, params and step are bit-identical, moments within
    scale/2, and every chunk's digest equals `checksum_np` of its file."""
    import numpy as np
    import torch

    from repro_torch.core.runtime import MANARuntime
    from repro_torch.kernels.checksum.ref import checksum_np

    d = os.path.join(root, f"int8_{cfg.arch_id}")
    rt = MANARuntime(cfg, rc, ckpt_dir=d, ckpt_every_steps=2,
                     quantize_moments=True, device="cuda")
    rt.initialize()
    rt.run(2)
    if rt.ckpt.steps() != [2]:
        raise AssertionError(f"images at {rt.ckpt.steps()}, want [2]")
    report["int8_write"] = rt.ckpt.stats[-1]
    live = rt.state
    t0 = time.monotonic()
    got, _ = rt.ckpt.restore(2)
    torch.cuda.synchronize()
    report["restore_int8_s"] = time.monotonic() - t0
    worst = _check_int8_restore(got, live)
    with open(os.path.join(rt.ckpt.step_dir(2), "manifest.json")) as f:
        man = json.load(f)
    n_files = 0
    for entry in man["arrays"].values():
        for fm in entry["files"]:
            data = np.fromfile(os.path.join(rt.ckpt.step_dir(2), fm["file"]),
                               dtype=np.uint8)
            if checksum_np(data) != fm["checksum"]:
                raise AssertionError(f"{fm['file']}: card digest "
                                     f"{fm['checksum']} != checksum_np")
            n_files += 1
    log(f"{label}: int8-moment image restored in "
        f"{report['restore_int8_s']:.3f} s; params/step bit-identical, "
        f"moments within scale/2 (worst {worst:.4f} scale where the scale is "
        f"a normal f32); {n_files} "
        f"chunk digests equal checksum_np")
    rt.close()
    del rt, live, got
    shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()



def _gathered(tree):
    """The tree with every DTensor leaf gathered to its full tensor."""
    from repro_torch.tree import tree_map

    return tree_map(lambda x: x.full_tensor() if hasattr(x, "full_tensor")
                    else x, tree)


_MESH: list = []


def nccl_mesh():
    """The (1 x 1) ("data", "model") mesh of the mesh phases, over an NCCL
    world of 1 made in this process (`HashStore`) at the first call and
    shared by every later one; `main` destroys the group after the last
    mesh phase."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    if not _MESH:
        dist.init_process_group(
            "nccl", store=dist.HashStore(), rank=0, world_size=1,
            device_id=torch.device("cuda", torch.cuda.current_device()))
        _MESH.append(make_mesh((1, 1), ("data", "model")))
    return _MESH[0]


def _equal_to_mesh_state(flat, state, what: str) -> None:
    """`flat` (full tensors) equal to the mesh `state`'s gathered leaves,
    gathered one leaf at a time (a gathered copy of the whole state would
    not fit beside Mixtral's)."""
    import torch

    from repro_torch.tree import tree_leaves

    for a, b in zip(tree_leaves(flat), tree_leaves(state)):
        if not torch.equal(a, b.full_tensor()):
            raise AssertionError(f"{what} differs from the mesh state")


def phase_train_mesh_family(cfg, rc, root: str, report: dict, label: str,
                            steps: int, images, want=None,
                            int8: bool = False):
    """A family on the (1 x 1) mesh of `nccl_mesh`, every state leaf a
    DTensor: `steps` steps with an image at each step of `images` (a
    full one, then XOR-delta params on the one before); the last image,
    restored without a mesh right after it is written, must equal the
    mesh state; then a runtime on the mesh restores the first image and
    must repeat the steps after it (loss, and `moe_aux` for MoE) bit for
    bit.  The losses are held to `want`, the same config's mesh-free
    steps from the same seed (bit-equal, or else within the reference's
    cross-topology rtol 5e-3, the largest relative difference printed);
    with `want` None a mesh-free runtime runs the same steps first.
    With `int8` the resumed state is then written at `steps` with int8
    moments and XOR-delta params on the first image (the later images,
    checked, are dropped first), and restored onto the mesh: params and
    step bit-identical, moments within scale/2 (quantize, XOR and
    dequantize on the gathered leaves)."""
    import math

    import torch

    from repro_torch.core.checkpoint import CheckpointManager
    from repro_torch.core.runtime import MANARuntime
    from repro_torch.tree import tree_leaves

    every = images[0]
    assert list(images) == list(range(every, images[-1] + 1, every))
    keys = ("loss", "moe_aux") if cfg.moe is not None else ("loss",)
    d = os.path.join(root, label)
    os.makedirs(d)
    _need_disk(d, (len(images) + int8) * 12 * _stored_params(cfg)
               + (1 << 30), f"{len(images) + int8} full-size images", label)
    if want is None:
        rt = MANARuntime(cfg, rc, ckpt_dir=os.path.join(d, "free"),
                         device="cuda")
        rt.initialize()
        hist, report["nomesh_step_s"] = _timed_run(rt, steps)
        want = [tuple(h[k] for k in keys) for h in hist]
        rt.close()
        del rt
        torch.cuda.empty_cache()
    mesh = nccl_mesh()
    rt = MANARuntime(cfg, rc, ckpt_dir=d, mesh=mesh, ckpt_every_steps=every,
                     delta_params=True, device="cuda")
    rt.initialize()
    kinds = {type(x).__name__ for x in tree_leaves(rt.state)}
    if kinds != {"DTensor"}:
        raise AssertionError(f"{label}: mesh state leaves are {kinds}")
    _, report["step_s"] = _timed_run(rt, images[-1])
    rt.ckpt_every_steps = None
    # the last image, restored without a mesh, against the state it was
    # written from (the run is at that step)
    t0 = time.monotonic()
    flat, _ = CheckpointManager(d, device="cuda").restore(images[-1])
    torch.cuda.synchronize()
    report["restore_nomesh_s"] = time.monotonic() - t0
    _equal_to_mesh_state(flat, rt.state, f"{label}: the step-{images[-1]} "
                         f"image restored without a mesh")
    del flat
    hist, more_s = _timed_run(rt, steps - images[-1])
    report["step_s"] += more_s
    report["writes"] = list(rt.ckpt.stats)
    _check_delta_bases(rt, dict(zip(images, [None] + list(images[:-1]))),
                       label)
    got = [tuple(h[k] for k in keys) for h in hist]
    if not all(math.isfinite(v) for t in got for v in t):
        raise AssertionError(f"{label}: losses not finite: {got}")
    report["vs_nomesh"] = max(abs(a - b) / abs(b) for g, w in zip(got, want)
                              for a, b in zip(g, w))
    if got != want and report["vs_nomesh"] > 5e-3:
        raise AssertionError(f"{label}: mesh {keys} {got} vs the mesh-free "
                             f"{want}: beyond rtol 5e-3")
    rt.close()
    del rt
    torch.cuda.empty_cache()

    rt = MANARuntime(cfg, rc, ckpt_dir=d, mesh=mesh, delta_params=True,
                     device="cuda")
    t0 = time.monotonic()
    if rt.restore(every) != every:
        raise AssertionError(f"{label}: mesh restore missed step {every}")
    torch.cuda.synchronize()
    report["restore_s"] = time.monotonic() - t0
    hist2, report["resumed_step_s"] = _timed_run(rt, steps - every)
    resumed = [tuple(h[k] for k in keys) for h in hist2]
    if resumed != got[every:]:
        raise AssertionError(f"{label}: mesh resume not bit-identical: "
                             f"{resumed} != {got[every:]}")
    line = (f"{label}: (1 x 1) NCCL mesh, every leaf a DTensor; {keys} "
            f"{got}; against the mesh-free run "
            f"{'bit-equal' if got == want else 'NOT bit-equal'}, largest "
            f"relative difference {report['vs_nomesh']:.3e}; the "
            f"step-{images[-1]} image restored without a mesh equal to the "
            f"mesh state; resumed from step {every} {resumed}, bit for "
            f"bit")
    if int8:
        for s in images[1:]:
            shutil.rmtree(rt.ckpt.step_dir(s))
        state, specs = rt.state, rt.lower.state_specs
        mgr = CheckpointManager(d, quantize_keys=("opt/m", "opt/v"),
                                delta_keys=("params",), device="cuda")
        report["int8_write"] = mgr.save(steps, state)
        _check_delta_bases(rt, {every: None, steps: every}, label)
        t0 = time.monotonic()
        back, _ = mgr.restore(steps, mesh=mesh, specs=specs)
        torch.cuda.synchronize()
        report["restore_int8_s"] = time.monotonic() - t0
        report["int8_worst"] = _check_int8_restore(_gathered(back),
                                                   _gathered(state))
        line += (f"; an int8-moment image (XOR-delta params on step "
                 f"{every}) restored onto the mesh, params/step "
                 f"bit-identical, moments within scale/2 (worst "
                 f"{report['int8_worst']:.4f})")
        del back, state
    log(line)
    rt.close()
    del rt
    shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()


def report_train_mesh_family(label: str, cfg, rc, r: dict, peak: int,
                             wall: float, card: str):
    mode = f", moe_mode {rc.moe_mode}" if cfg.moe is not None else ""
    log(f"{label} ((1 x 1) NCCL mesh): {cfg.arch_id} at full width, "
        f"{_depth(cfg)} ({_stored_params(cfg)} params stored{mode}), "
        f"B={rc.shape.global_batch} S={rc.shape.seq_len}; step_s "
        f"{[round(x, 4) for x in r['step_s']]} (the first "
        f"{r['step_s'][0]:.4f}), resumed "
        f"{[round(x, 4) for x in r['resumed_step_s']]}"
        + (f", mesh-free {[round(x, 4) for x in r['nomesh_step_s']]}"
           if "nomesh_step_s" in r else "")
        + f" [{card}]")
    for w in r["writes"] + ([r["int8_write"]] if "int8_write" in r else []):
        log(f"{label}: image step {w['step']}: {w['bytes']} bytes, "
            f"snapshot_s {w['snapshot_s']}, write_s {w['write_s']} [{card}]")
    log(f"{label}: restore_s onto the mesh {r['restore_s']:.4f}, without a "
        f"mesh {r['restore_nomesh_s']:.4f}"
        + (f", int8 onto the mesh {r['restore_int8_s']:.4f}"
           if "restore_int8_s" in r else "")
        + f"; against the mesh-free run, largest relative difference "
        f"{r['vs_nomesh']:.3e}; phase {wall:.2f} s; max_memory_allocated "
        f"{peak} bytes ({peak / 2**30:.2f} GiB) [{card}]")


# ---------------------------------------------------------------------------
# serving phases: prefill, decode, live decode-state images
# ---------------------------------------------------------------------------

SERVE_STEPS, SNAP_FULL, SNAP_DELTA = 16, 6, 10


def _greedy(logits):
    import torch

    return torch.argmax(logits, dim=-1).to(torch.int32)[:, None]


def _rel(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _check_decode_against_forward(params, cfg, rc, inputs, report):
    """Prefill + one decode step against a full forward over the same
    tokens, on the full-width params cut to their first 2 layers (and,
    for enc-dec, 2 encoder layers, with the first request's frames given
    to both; for vision, the first self block and the first cross block,
    with the first request's patches given to both), in float32, for
    the first prompt.  (At full depth the random-init network amplifies
    rounding: decode and forward of qwen2-0.5b part far beyond rounding
    even in float32, while their first layers agree to it.  Vision's
    whole first group of 5 layers is already past that point at full
    width: one rounding of each parameter moves its forward's logits by
    several percent for some prompts, `tools/probe_decode_depth.py`.)

    For vision the cut copy's cross block has its self-attention output
    projection, `cross_blocks/attn/wo`, replaced by zeros.  Decode runs a
    cross layer as pure cross attention (no `ln1`, no self-attention, as
    the reference's `decode_step` does), while the forward runs the
    cross block's self-attention too, so without the zeros the two part
    by design, in the reference as here (about the logits' own norm at
    the reduced config); with them that self-attention adds nothing and
    every other path of both is held.

    The prefill takes P tokens: P = S - 1, or the SWA window, so that the
    decode wraps a ring of capacity P.  The forward runs over P + 1
    tokens, or, with MoE, over P + 512 so that both fill whole groups of
    512: then the decoded token is the first of its group and no
    capacity limit drops it in either path (the decode's group of one
    token drops nothing).  Limit: norm-relative 1e-3 over the vocabulary's
    columns; the padding columns (-1e9 from the vocabulary mask, which
    would swamp the norm) must be equal on their own."""
    import torch

    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map

    first = lambda t: t[:1]
    extra_in = {}
    depth = 2
    if cfg.cross_attn_every:      # one group of one self block + the cross
        cross = tree_map(first, params["cross_blocks"])
        cross["attn"] = dict(cross["attn"],
                             wo=torch.zeros_like(cross["attn"]["wo"]))
        cut_params = dict(params, cross_blocks=cross, self_blocks=tree_map(
            lambda t: t[:1, :1], params["self_blocks"]))
        cut = dataclasses.replace(cfg, n_layers=depth, cross_attn_every=depth)
        extra_in["patches"] = inputs["patches"][:1]
    else:
        cut_params = dict(params, blocks=tree_map(lambda t: t[:depth],
                                                  params["blocks"]))
        cut = dataclasses.replace(cfg, n_layers=depth)
    if cfg.enc_dec:
        cut = dataclasses.replace(cut, n_enc_layers=depth)
        cut_params["enc_blocks"] = tree_map(lambda t: t[:depth],
                                            params["enc_blocks"])
        extra_in["frames"] = inputs["frames"][:1]
    f32 = dataclasses.replace(rc, model=cut, dtype="float32",
                              remat_policy="none")
    prompts = inputs["tokens"]
    P = cfg.sliding_window or prompts.shape[1] - 1
    extra = 512 if cfg.moe is not None else 1
    toks = prompts[:1, :P + extra]
    if toks.shape[1] != P + extra or (cfg.moe is not None and P % 512):
        raise AssertionError(f"check needs {P + extra} tokens, P % 512 == 0")
    with torch.no_grad():
        _, st = T.prefill(cut_params, cut, f32, None,
                          {"tokens": toks[:, :P], **extra_in})
        dec, _ = T.decode_step(cut_params, cut, f32, None, st,
                               toks[:, P:P + 1])
        x, _, _ = T.forward(cut_params, cut, f32, None,
                            {"tokens": toks, **extra_in})
        full = T._logits(cut_params, cut, x[:, P])
    V = cfg.vocab_size
    err = _rel(dec[:, 0, :V], full[..., :V])
    report["decode_vs_forward"] = (err, P)
    if not (err < 1e-3 and torch.isfinite(dec).all()):
        raise AssertionError(f"decode after a prefill of {P} disagrees with "
                             f"the forward: {err}")
    if not torch.equal(dec[:, 0, V:], full[..., V:]):
        raise AssertionError(f"decode's {dec.shape[-1] - V} vocabulary "
                             f"padding columns differ from the forward's")


def _serve_inputs(cfg, S: int, batch: int, gen) -> dict:
    """`batch` prompts of S tokens drawn on the card, and for enc-dec
    models (batch, Te, d) f32 stub frames, for vision models (batch, Tv,
    d) f32 stub patches, from the same generator."""
    import torch

    dev = torch.device("cuda")
    inputs = {"tokens": torch.randint(0, cfg.vocab_size, (batch, S),
                                      generator=gen, device=dev,
                                      dtype=torch.int32)}
    if cfg.enc_dec:
        inputs["frames"] = torch.randn((batch, cfg.enc_positions,
                                        cfg.d_model), generator=gen,
                                       device=dev)
    if cfg.cross_attn_every:
        inputs["patches"] = torch.randn((batch, cfg.vision_tokens,
                                         cfg.d_model), generator=gen,
                                        device=dev)
    return inputs


def phase_serve(cfg, rc, batch: int, root: str, report: dict):
    import numpy as np
    import torch

    from repro_torch.core.checkpoint import CheckpointManager
    from repro_torch.models.transformer import (decode_state_logical,
                                                init_params)
    from repro_torch.training.step import make_serve_steps

    dev = torch.device("cuda")
    S = rc.shape.seq_len
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.monotonic()
    params, _ = init_params(cfg, gen, dev)
    torch.cuda.synchronize()
    report["init_s"] = time.monotonic() - t0
    prefill_step, serve_step = make_serve_steps(cfg, rc)
    inputs = _serve_inputs(cfg, S, batch, gen)

    t0 = time.monotonic()
    logits, state = prefill_step(params, inputs)
    torch.cuda.synchronize()
    report["prefill_s"] = time.monotonic() - t0
    Kp, hd = cfg.n_kv_heads_padded, cfg.head_dim
    T_cap = min(cfg.sliding_window, S) if cfg.sliding_window else (
        S + rc.decode_margin)
    if cfg.rwkv:      # the la state: fixed-size, whatever the prompt
        shapes = {"la": (cfg.n_layers, batch, cfg.n_heads_padded, hd, hd)}
    elif cfg.cross_attn_every:   # the self blocks' K/V, (G, per-1, ...),
        G = cfg.n_layers // cfg.cross_attn_every    # and the cross K/V
        shapes = {"k": (G, cfg.cross_attn_every - 1, batch, T_cap, Kp, hd),
                  "xk": (G, batch, cfg.vision_tokens, Kp, hd)}
    else:
        shapes = {"k": (cfg.n_layers, batch, T_cap, Kp, hd)}
    if cfg.enc_dec:   # the cross K/V: every frame, whatever the prompt
        shapes["xk"] = (cfg.n_layers, batch, cfg.enc_positions, Kp, hd)
    got = {key: tuple(state["layers"][key].shape) for key in shapes}
    if (tuple(logits.shape) != (batch, cfg.vocab_padded)
            or not torch.isfinite(logits).all()
            or int(state["pos"]) != S or got != shapes):
        raise AssertionError(f"prefill: logits {tuple(logits.shape)}, pos "
                             f"{int(state['pos'])}, caches {got} != "
                             f"{shapes}")

    d = os.path.join(root, "serve")
    mgr = CheckpointManager(d, delta_keys=("decode",), device=dev)
    logical = {"decode": decode_state_logical(cfg)}
    tok = _greedy(logits)
    # held on the host for the serve mesh phase: the prefill's logits
    # and token, then each step's
    report["host_logits"], report["host_tokens"] = [logits.cpu()], [tok.cpu()]
    toks, outs, step_s, saved = [], [], [], {}
    for i in range(SERVE_STEPS):
        t0 = time.monotonic()
        logits, state = serve_step(params, state, tok)
        tok = _greedy(logits[:, -1])
        torch.cuda.synchronize()
        step_s.append(time.monotonic() - t0)
        toks.append(tok)
        outs.append(logits)
        if i in (SNAP_FULL, SNAP_DELTA):
            mgr.save(i, {"decode": state}, logical)
            saved[i] = state
    report["decode_step_s"] = step_s
    report["writes"] = list(mgr.stats)
    report["host_logits"] += [o.cpu() for o in outs]
    report["host_tokens"] += [t.cpu() for t in toks]
    if not all(torch.isfinite(o).all() for o in outs):
        raise AssertionError("decode logits are not finite")
    with open(os.path.join(mgr.step_dir(SNAP_DELTA), "manifest.json")) as f:
        arrays = json.load(f)["arrays"]
    bases = {p: e.get("base_step") for p, e in arrays.items()}
    if set(bases.values()) != {SNAP_FULL}:
        raise AssertionError(f"image {SNAP_DELTA}: delta bases {bases}")

    mgr2 = CheckpointManager(d, delta_keys=("decode",), device=dev)
    t0 = time.monotonic()
    restored, _ = mgr2.restore(SNAP_DELTA)
    torch.cuda.synchronize()
    report["restore_s"] = time.monotonic() - t0
    state2 = restored["decode"]
    live = saved[SNAP_DELTA]
    if sorted(state2["layers"]) != sorted(live["layers"]):
        raise AssertionError(f"restored decode leaves "
                             f"{sorted(state2['layers'])} != "
                             f"{sorted(live['layers'])}")
    report["state_bytes"] = {key: c.numel() * c.element_size()
                             for key, c in live["layers"].items()}
    for key, a, b in [("pos", state2["pos"], live["pos"])] + [
            (key, state2["layers"][key], c)
            for key, c in live["layers"].items()]:
        if a.device != b.device or not torch.equal(a, b):
            raise AssertionError(f"restored decode/{key} != the live state "
                                 f"at token {SNAP_DELTA}")
    tok2 = toks[SNAP_DELTA]
    for i in range(SNAP_DELTA + 1, SERVE_STEPS):
        logits2, state2 = serve_step(params, state2, tok2)
        tok2 = _greedy(logits2[:, -1])
        if not (torch.equal(logits2, outs[i]) and torch.equal(tok2, toks[i])):
            raise AssertionError(f"continuation after the restore differs "
                                 f"at token {i}")
    report["tokens"] = [t[:, 0].tolist() for t in toks]
    report["distinct_tokens"] = int(np.unique(
        torch.cat(toks).cpu().numpy()).size)
    del saved, live, state, state2, restored, outs
    _check_decode_against_forward(params, cfg, rc, inputs, report)
    del params, inputs
    shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()


def report_serve(name: str, cfg, rc, batch: int, r: dict, card: str):
    steps = r["decode_step_s"]
    med = sorted(steps)[len(steps) // 2] * 1e3
    log(f"{name}: {cfg.arch_id} {cfg.n_layers} L, d {cfg.d_model}, "
        f"{cfg.n_heads_padded}/{cfg.n_kv_heads_padded} heads of "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}"
        + (f", MoE {cfg.moe.num_experts}e top-{cfg.moe.top_k}"
           if cfg.moe else "")
        + (f", SSM state {cfg.ssm_state} x d_inner "
           f"{cfg.ssm_expand * cfg.d_model}" if cfg.ssm_state else "")
        + (f", SWA {cfg.sliding_window}" if cfg.sliding_window else "")
        + (", attention-free (RWKV-6 time-mix)" if cfg.rwkv else "")
        + (f", enc-dec: {cfg.n_enc_layers} encoder layers over "
           f"{cfg.enc_positions} frames, cross attention in every decoder "
           f"layer" if cfg.enc_dec else "")
        + (f", vision: {cfg.n_layers // cfg.cross_attn_every} groups of "
           f"{cfg.cross_attn_every - 1} self blocks and a cross block over "
           f"{cfg.vision_tokens} patches" if cfg.cross_attn_every else "")
        + f"; B={batch} prompts of {rc.shape.seq_len}, bf16 compute, f32 "
        f"params; {SERVE_STEPS} greedy tokens")
    log(f"{name}: init_s {r['init_s']:.4f}, prefill_s {r['prefill_s']:.4f}, "
        f"decode ms/token median {med:.3f} (all: "
        f"{[round(s * 1e3, 3) for s in steps]}) [{card}]")
    for w in r["writes"]:
        log(f"{name}: decode-state image token {w['step']}: {w['bytes']} "
            f"bytes, snapshot_s {w['snapshot_s']}, write_s {w['write_s']} "
            f"[{card}]")
    err, P = r["decode_vs_forward"]
    log(f"{name}: restore of token {SNAP_DELTA} (chain {SNAP_DELTA} -> "
        f"{SNAP_FULL}) {r['restore_s']:.4f} s; tokens {SNAP_DELTA + 1}-"
        f"{SERVE_STEPS - 1} and their logits equal the first run bit for "
        f"bit; {r['distinct_tokens']} distinct tokens generated; decode "
        f"after a prefill of {P} vs forward (f32, "
        + ("first self block and cross block, cross_blocks/attn/wo zeroed"
           if cfg.cross_attn_every else "first 2 layers")
        + f") norm-relative {err:.3e} [{card}]")
    log(f"{name}: decode state by leaf {r['state_bytes']} bytes, "
        f"{sum(r['state_bytes'].values())} in all; max_memory_allocated "
        f"{r['peak']} bytes ({r['peak'] / 2**30:.2f} GiB) [{card}]")


def _serve_loop(prefill_step, serve_step, params, inputs, place_tok=None,
                on_token=None):
    """Prefill and `SERVE_STEPS` greedy decode steps: (the prefill's (B,
    V) logits then each step's (B, 1, V), gathered and on the host; the
    prefill's greedy token then each step's, (B, 1) on the card; the
    prefill's and each step's seconds).  `place_tok` places a token for
    the step; `on_token(i, state)` runs after step i."""
    import torch

    full = lambda x: x.full_tensor() if hasattr(x, "full_tensor") else x
    t0 = time.monotonic()
    logits, state = prefill_step(params, inputs)
    logits = full(logits)
    torch.cuda.synchronize()
    prefill_s = time.monotonic() - t0
    outs, toks, step_s = [logits.cpu()], [_greedy(logits)], []
    for i in range(SERVE_STEPS):
        t0 = time.monotonic()
        tok = toks[-1] if place_tok is None else place_tok(toks[-1])
        logits, state = serve_step(params, state, tok)
        logits = full(logits)
        toks.append(_greedy(logits[:, -1]))
        torch.cuda.synchronize()
        step_s.append(time.monotonic() - t0)
        outs.append(logits.cpu())
        if on_token is not None:
            on_token(i, state)
    return outs, toks, prefill_s, step_s


def _not_placed(tree, specs, mesh):
    """The leaves of `tree` that are not DTensors placed by `specs`."""
    from repro_torch.core.checkpoint import _flatten
    from repro_torch.sharding.rules import placements

    spec = _flatten(specs)
    return [p for p, x in _flatten(tree).items()
            if not hasattr(x, "placements") or tuple(x.placements)
            != placements(spec[p], mesh, x.shape)]


def _place_(tree, specs, mesh) -> None:
    """Each leaf of the dict tree replaced, in place, by its DTensor
    placed by `specs` (a leaf's memory can go as soon as it is placed)."""
    from repro_torch.sharding.rules import place

    for k, v in tree.items():
        if isinstance(v, dict):
            _place_(v, specs[k], mesh)
        else:
            tree[k] = place(v, specs[k], mesh)


def phase_serve_mesh(cfg, rc, batch: int, root: str, report: dict,
                     label: str, want=None):
    """The serving path on the (1 x 1) mesh of `nccl_mesh` with
    `kv_time_shard` (the cache's time axis over "model", as the
    reference's serving cells shard it): `make_serve_steps(cfg, rc,
    rules)` with params re-initialised from `phase_serve`'s seed and
    placed by `train_state_specs(...)["params"]`, the prompts by
    `batch_specs`, each token by ("batch", None); every param and
    decode-state leaf a DTensor placed by its spec (the decode state by
    `decode_state_specs`, after the prefill and each step).  Prefill and
    `SERVE_STEPS` greedy tokens are held to `want`, the mesh-free run's
    (host logits, host tokens) from the same seed (`phase_serve`'s
    `host_logits`/`host_tokens`), or, with `want` None, to a mesh-free
    twin run first here: tokens equal; logits bit-equal, or else within
    5e-3 of their norm at every step, the largest printed.  Images at
    tokens `SNAP_FULL` (full) and `SNAP_DELTA` (XOR delta): the delta
    restored onto the mesh decodes the next tokens again bit for bit,
    and restored without a mesh equals the gathered live state."""
    import torch

    from repro_torch.core.checkpoint import CheckpointManager
    from repro_torch.models.transformer import (decode_state_logical,
                                                init_params)
    from repro_torch.sharding.rules import ShardingRules, place
    from repro_torch.training.step import (batch_specs, decode_state_specs,
                                           make_serve_steps,
                                           train_state_specs)

    dev = torch.device("cuda")
    rc = dataclasses.replace(rc, kv_time_shard=True)
    S = rc.shape.seq_len
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params, _ = init_params(cfg, gen, dev)
    inputs = _serve_inputs(cfg, S, batch, gen)
    if want is None:
        outs, toks, report["twin_prefill_s"], report["twin_step_s"] = (
            _serve_loop(*make_serve_steps(cfg, rc), params, inputs))
        want = (outs, [t.cpu() for t in toks])
        del outs, toks
    mesh = nccl_mesh()
    rules = ShardingRules(mesh, moe_mode=rc.moe_mode, kv_time_shard=True)
    p_specs = train_state_specs(cfg, rc, rules)["params"]
    t0 = time.monotonic()
    _place_(params, p_specs, mesh)
    torch.cuda.synchronize()
    report["place_s"] = time.monotonic() - t0
    b_specs = batch_specs(cfg, rc.shape, rules)
    inputs = {k: place(v, b_specs[k], mesh) for k, v in inputs.items()}
    specs = decode_state_specs(cfg, rc, rules, rc.shape)
    bad = _not_placed(params, p_specs, mesh)
    if bad:
        raise AssertionError(f"{label}: params not placed by their specs: "
                             f"{bad[:5]}")
    prefill_step, serve_step = make_serve_steps(cfg, rc, rules)
    tok_spec = rules.spec(("batch", None), (batch, 1))
    place_tok = lambda t: place(t, tok_spec, mesh)

    def placed(state, when):
        bad = _not_placed(state, specs, mesh)
        if bad:
            raise AssertionError(f"{label}: decode state {when} not placed "
                                 f"by decode_state_specs: {bad[:5]}")

    d = os.path.join(root, label)
    mgr = CheckpointManager(d, delta_keys=("decode",), device=dev)
    logical = {"decode": decode_state_logical(cfg)}
    live = {}

    def on_token(i, state):
        placed(state, f"after step {i}")
        if i in (SNAP_FULL, SNAP_DELTA):
            mgr.save(i, {"decode": state}, logical)
            live[i] = state

    def prefill_placed(params, inputs):
        logits, state = prefill_step(params, inputs)
        placed(state, "after the prefill")
        return logits, state

    outs, toks, report["prefill_s"], report["decode_step_s"] = _serve_loop(
        prefill_placed, serve_step, params, inputs, place_tok, on_token)
    report["writes"] = list(mgr.stats)
    host_toks = [t.cpu() for t in toks]
    if not all(torch.equal(a, b) for a, b in zip(host_toks, want[1])):
        raise AssertionError(f"{label}: tokens differ from the mesh-free "
                             f"run's")
    rel = [_rel(a, b) for a, b in zip(outs, want[0])]
    report["vs_nomesh"] = (all(torch.equal(a, b)
                               for a, b in zip(outs, want[0])), max(rel))
    if not report["vs_nomesh"][0] and max(rel) > 5e-3:
        raise AssertionError(f"{label}: logits against the mesh-free run "
                             f"{rel}: beyond 5e-3")

    t0 = time.monotonic()
    back, _ = CheckpointManager(d, device=dev).restore(
        SNAP_DELTA, mesh=mesh, specs={"decode": specs})
    torch.cuda.synchronize()
    report["restore_s"] = time.monotonic() - t0
    state = back["decode"]
    placed(state, "restored onto the mesh")
    fed, made = toks[SNAP_DELTA + 1:SERVE_STEPS], outs[SNAP_DELTA + 2:]
    for i, (tok, out) in enumerate(zip(fed, made)):
        logits, state = serve_step(params, state, place_tok(tok))
        if not torch.equal(logits.full_tensor().cpu(), out):
            raise AssertionError(f"{label}: continuation after the restore "
                                 f"onto the mesh differs at token "
                                 f"{SNAP_DELTA + 2 + i}")
    del back, state
    t0 = time.monotonic()
    flat, _ = CheckpointManager(d, device=dev).restore(SNAP_DELTA)
    torch.cuda.synchronize()
    report["restore_nomesh_s"] = time.monotonic() - t0
    _equal_to_mesh_state(flat, {"decode": live[SNAP_DELTA]},
                         f"{label}: the token-{SNAP_DELTA} image restored "
                         f"without a mesh")
    report["state_bytes"] = sum(x.numel() * x.element_size()
                                for x in flat["decode"]["layers"].values())
    log(f"{label}: (1 x 1) NCCL mesh, kv_time_shard, every param and "
        f"decode-state leaf a DTensor placed by its spec; {len(toks)} "
        f"tokens equal the mesh-free run's, logits "
        f"{'bit-equal' if report['vs_nomesh'][0] else 'NOT bit-equal'} "
        f"(largest norm-relative difference {report['vs_nomesh'][1]:.3e}); "
        f"the token-{SNAP_DELTA} XOR-delta image restored onto the mesh "
        f"continues bit for bit, restored without a mesh equals the "
        f"gathered state")
    del flat, live, params, inputs, outs
    shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()


def _served(r: dict):
    """(host logits, host tokens) of a serve phase's report, taken out of
    it."""
    return r.pop("host_logits"), r.pop("host_tokens")


def report_serve_mesh(label: str, cfg, rc, batch: int, r: dict, free: dict,
                      peak: int, wall: float, card: str):
    """`free`: the mesh-free serve phase's report (None: the twin's)."""
    med = lambda xs: sorted(xs)[len(xs) // 2] * 1e3
    if free is None:
        f_prefill, f_steps = r["twin_prefill_s"], r["twin_step_s"]
    else:
        f_prefill, f_steps = free["prefill_s"], free["decode_step_s"]
    log(f"{label} ((1 x 1) NCCL mesh, kv_time_shard): {cfg.arch_id} at "
        f"full width, {_depth(cfg)}, B={batch} prompts of "
        f"{rc.shape.seq_len}; params placed in {r['place_s']:.4f} s; "
        f"prefill_s {r['prefill_s']:.4f} (mesh-free {f_prefill:.4f}), "
        f"decode ms/token median {med(r['decode_step_s']):.3f} (mesh-free "
        f"{med(f_steps):.3f}; all: "
        f"{[round(x * 1e3, 3) for x in r['decode_step_s']]}) [{card}]")
    for w in r["writes"]:
        log(f"{label}: decode-state image token {w['step']}: {w['bytes']} "
            f"bytes, snapshot_s {w['snapshot_s']}, write_s {w['write_s']} "
            f"[{card}]")
    log(f"{label}: restore_s onto the mesh {r['restore_s']:.4f}, without a "
        f"mesh {r['restore_nomesh_s']:.4f}; decode state "
        f"{r['state_bytes']} bytes; against the mesh-free run "
        f"{'bit-equal' if r['vs_nomesh'][0] else 'largest norm-relative difference %.3e' % r['vs_nomesh'][1]}"
        f"; phase {wall:.2f} s; max_memory_allocated {peak} bytes "
        f"({peak / 2**30:.2f} GiB) [{card}]")


# ---------------------------------------------------------------------------
# world phases: multi-rank worlds with their rank state on the card
# ---------------------------------------------------------------------------

WORLD_RANKS, WORLD_NUMEL = 64, 4 << 20       # 16 MiB of f32 a rank: 1 GiB
CROSS_RANKS, CROSS_NUMEL = 4, 16 << 20       # 64 MiB of f32 a rank
ELASTIC_RANKS, ELASTIC_KILLS, ELASTIC_G = 64, 3, 1 << 27   # 1 GiB float64


def _add_launches(total: dict, more) -> None:
    for k, v in (more or {}).items():
        if k != "peak":
            total[k] = total.get(k, 0) + v


def phase_world_pipeline(root: str, report: dict):
    """64 inproc ranks, a 16 MiB f32 shard each made on the card from its
    own seed; 9 steps changing 1% of each shard with row allreduces, an
    async incremental checkpoint every 3 (full, then XOR delta); every
    rank of the committed image restored onto the card, bit for bit its
    shard at the cut."""
    import torch

    from repro_torch.examples import multirank_simulation as twin

    image, m = twin.run_pipeline(WORLD_RANKS, "inproc", WORLD_NUMEL,
                                 torch.device("cuda"), seed=1, tmpdir=root)
    if not m["delta_epochs"]:
        raise AssertionError("world_pipeline committed no delta epoch")
    _check_card_blobs(image, WORLD_NUMEL, 1, torch.device("cuda"))
    report.update(m)


def _check_card_blobs(image, numel: int, seed: int, dev):
    """Rank 0's newest blob (an XOR delta) and its base, encoded from
    the card, are byte for byte `SnapshotCodec.encode` of the same
    values as CPU tensors, whose bytes the CPU tests tie to the
    reference's: the restore alone cannot catch a delta kernel that is
    wrong in a way that undoes itself."""
    from repro_torch.core.codec import (BASE_EPOCH_KEY, SnapshotCodec,
                                        snap_meta)
    from repro_torch.examples import multirank_simulation as twin

    codec = SnapshotCodec()
    ranks, chains = image["ranks"], image.get("chains", {})
    blob = ranks.get(0, ranks.get("0"))
    meta = snap_meta(blob)
    if meta["encoding"] != "delta":
        raise AssertionError("world_pipeline: rank 0's newest blob is full")
    base_epoch = int(meta[BASE_EPOCH_KEY])
    chain = {int(e): b for e, b in chains.get(0, chains.get("0", {})).items()}
    base_blob = chain[base_epoch]

    def values(b):
        extra = codec.decode_extra(b)
        return extra, twin.pipeline_expected(seed, 0, numel, extra["step"],
                                             dev).cpu()

    base_extra, base = values(base_blob)
    extra, cur = values(blob)
    if codec.encode(base_epoch, {"shard": base}, extra=base_extra) \
            != bytes(base_blob):
        raise AssertionError("world_pipeline: full blob from the card != "
                             "the CPU encode of the same values")
    if codec.encode(int(meta["epoch"]), {"shard": cur},
                    base=(base_epoch, {"shard": base}),
                    extra=extra) != bytes(blob):
        raise AssertionError("world_pipeline: delta blob from the card != "
                             "the CPU encode of the same values")
    log(f"world_pipeline: rank 0's full blob (epoch {base_epoch}) and delta "
        f"blob (epoch {meta['epoch']}) equal the CPU encode byte for byte")


def phase_world_cross(root: str, report: dict):
    """The same job at 4 ranks with 64 MiB shards: written over socket
    (spawned ranks, each its own CUDA context) and restored over inproc
    through `image_to_bytes`, then the reverse; each restored world
    checks every shard on the card, runs on and commits another image,
    which the launcher restores and checks too.  Returns the launches
    made in the socket ranks' own processes."""
    import torch

    from repro_torch.core.codec import image_to_bytes
    from repro_torch.examples import multirank_simulation as twin

    dev = torch.device("cuda")
    extra: dict = {}
    for a, b in (("socket", "inproc"), ("inproc", "socket")):
        image, m1 = twin.run_pipeline(CROSS_RANKS, a, CROSS_NUMEL, dev,
                                      seed=2, tmpdir=root)
        if not m1["delta_epochs"]:
            raise AssertionError(f"world_cross over {a}: no delta epoch")
        t0 = time.monotonic()
        blob = image_to_bytes(image)
        _, m2 = twin.run_pipeline(CROSS_RANKS, b, CROSS_NUMEL, dev, seed=2,
                                  image=blob, steps=twin.PIPE_EVERY + 1,
                                  tmpdir=root)
        m2["cross_s"] = time.monotonic() - t0
        report[f"{a}->{b}"] = (m1, m2)
        for m in (m1, m2):
            _add_launches(extra, m["rank_process"])
    return extra


def phase_world_elastic(root: str, report: dict):
    """The elastic chaos twin on the card: 64 inproc ranks hold x of 2^27
    float64 (1 GiB); 3 ranks are killed and the job resumes at 61, one
    more is killed and it grows back to 64; the final committed image is
    restored into a 4-rank socket world (64 -> 4), every slice
    bit-identical to the logical arange + step.  Returns the launches
    made in the socket ranks' own processes."""
    from repro_torch.examples import multirank_simulation as twin

    args = twin.parse_args([
        "--elastic", "--ranks", str(ELASTIC_RANKS), "--kills",
        str(ELASTIC_KILLS), "--elastic-numel", str(ELASTIC_G),
        "--reshard-to", "4@socket", "--async-ckpt", "--device", "cuda"])
    transport, specs = twin.restore_specs(args)
    m = twin.elastic_main(args, transport, specs)
    report.update(m)
    extra: dict = {}
    _add_launches(extra, m["reshard"]["rank_process"])
    return extra


def report_worlds(r: dict, peaks: dict, wall: dict, card: str):
    p = r["world_pipeline"]
    log(f"world_pipeline: {p['ranks']} inproc ranks, {p['card_bytes']} bytes "
        f"of f32 shards on the card; image {p['image_bytes']} bytes (delta "
        f"epochs {p['delta_epochs']}); commit stall {p['stall_s']:.4f} s, "
        f"write {p['write_s']:.4f} s (max over ranks), restore of all ranks "
        f"onto the card {p['restore_s']:.4f} s; phase {wall['world_pipeline']:.2f} s; "
        f"peak {peaks['world_pipeline']} bytes [{card}]")
    for k, (m1, m2) in r["world_cross"].items():
        a, b = k.split("->")
        log(f"world_cross {k}: {m1['ranks']} ranks, {m1['card_bytes']} bytes "
            f"on the card; over {a}: image {m1['image_bytes']} bytes (delta "
            f"epochs {m1['delta_epochs']}), stall {m1['stall_s']:.4f} s, "
            f"write {m1['write_s']:.4f} s, restore {m1['restore_s']:.4f} s, "
            f"world {m1['world_s']:.2f} s; restored over {b}: per-rank "
            f"restore {m2['rank_restore_s']:.4f} s, second image "
            f"{m2['image_bytes']} bytes, stall {m2['stall_s']:.4f} s, write "
            f"{m2['write_s']:.4f} s, world {m2['world_s']:.2f} s [{card}]")
        for m, t in ((m1, a), (m2, b)):
            if m["rank_process"]:
                log(f"world_cross {k}: socket rank processes ({t}): "
                    f"launches {m['rank_process']} [{card}]")
    e = r["world_elastic"]
    rs = e["reshard"]
    log(f"world_elastic: {e['ranks']} inproc ranks, x of {e['G']} float64 "
        f"({e['card_bytes']} bytes on the card); {e['ranks']} -> "
        f"{e['ranks'] - ELASTIC_KILLS} -> {e['ranks']} in {e['attempts']} "
        f"attempts, resume steps {e['resume_steps']}, recovery "
        f"{e['recovery_s']} s; final attempt: commit stall "
        f"{e['stall_s']:.4f} s, write {e['write_s']:.4f} s, per-rank slice "
        f"restore {e['rank_restore_s']:.4f} s; chaos run {e['chaos_s']:.2f} s "
        f"[{card}]")
    log(f"world_elastic: final image {rs['image_bytes']} bytes, "
        f"{rs['n_from']} -> {rs['n_to']} {rs['transport']} ranks, per-rank "
        f"slice restore {rs['rank_restore_s']:.4f} s, world "
        f"{rs['world_s']:.2f} s (socket rank peak "
        f"{rs['rank_process']['peak']} bytes); phase "
        f"{wall['world_elastic']:.2f} s; launcher peak "
        f"{peaks['world_elastic']} bytes [{card}]")


# ---------------------------------------------------------------------------
# entry-point phases: the CLI and the two example twins, in this process
# ---------------------------------------------------------------------------

def _echoed(main, argv):
    """`main(argv)` with its standard output captured and echoed line by
    line (also when it raises); returns the lines."""
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            main(argv)
    finally:
        for line in buf.getvalue().splitlines():
            log(f"  | {line}")
    return buf.getvalue().splitlines()


@contextlib.contextmanager
def _step_clock():
    """Yields a list to which, while open, every `MANARuntime.run`
    appends the host time of each of its steps and the image writes of
    its manager (the entry points build their runtimes themselves)."""
    from repro_torch.core.runtime import MANARuntime

    run = MANARuntime.run
    record = []

    def timed(self, n, on_metrics=None, stop_flag=None):
        stamps = [time.monotonic()]

        def stamp(s, m):
            stamps.append(time.monotonic())
            if on_metrics is not None:
                on_metrics(s, m)

        try:
            return run(self, n, stamp, stop_flag)
        finally:
            record.append({"step_s": [b - a for a, b in
                                      zip(stamps, stamps[1:])],
                           "writes": list(self.ckpt.stats)})

    MANARuntime.run = timed
    try:
        yield record
    finally:
        MANARuntime.run = run


CLI_FLAGS = ["--arch", "qwen2-0.5b", "--batch", "8", "--seq", "1024",
             "--ckpt-every-steps", "2", "--delta-params", "--device", "cuda"]


def phase_cli(root: str, report: dict):
    """`repro_torch.launch.train` at full width: 4 steps fresh, then
    `--resume` for 2, then 6 uninterrupted in another directory; the
    resumed steps' JSON losses equal the uninterrupted steps 4-5."""
    from repro_torch.launch import train

    a, b = os.path.join(root, "cli"), os.path.join(root, "cli_ref")
    out = {}
    for tag, d, more in (("fresh", a, ["--steps", "4"]),
                         ("resume", a, ["--steps", "2", "--resume"]),
                         ("uninterrupted", b, ["--steps", "6"])):
        t0 = time.monotonic()
        with _step_clock() as rec:
            out[tag] = _echoed(train.main,
                               CLI_FLAGS + more + ["--ckpt-dir", d])
        report[tag] = {"s": time.monotonic() - t0, **rec[0]}
    hist = {t: [json.loads(x) for x in lines if x.startswith("{")]
            for t, lines in out.items()}
    if out["resume"][0] != "resumed from step 4":
        raise AssertionError(f"cli: --resume printed {out['resume'][0]!r}")
    resumed = [h["loss"] for h in hist["resume"]]
    want = [h["loss"] for h in hist["uninterrupted"] if h["step"] in (4, 5)]
    if [h["step"] for h in hist["resume"]] != [4, 5] or resumed != want:
        raise AssertionError(f"cli: resumed losses {resumed} != the "
                             f"uninterrupted run's steps 4-5 {want}")
    report["resumed"] = resumed
    log(f"cli: resumed losses {resumed} equal the uninterrupted run's steps "
        f"4-5 bit for bit")
    shutil.rmtree(a, ignore_errors=True)
    shutil.rmtree(b, ignore_errors=True)


def phase_quickstart(root: str, report: dict):
    """The quickstart twin on the card: 20 steps with an image every 8,
    a restore of step 16 and 5 resumed steps."""
    import math

    from repro_torch.examples import quickstart

    d = os.path.join(root, "quickstart")
    t0 = time.monotonic()
    with _step_clock() as rec:
        lines = _echoed(quickstart.main, ["--device", "cuda", "--ckpt-dir", d])
    report.update(s=time.monotonic() - t0, runs=rec)
    resumed = [x for x in lines if x.endswith("(resumed)")]
    losses = [float(x.split()[3]) for x in lines if x.startswith("step")]
    if ("restored at step 16" not in lines or len(resumed) != 5
            or not all(math.isfinite(v) for v in losses)):
        raise AssertionError("quickstart: no restore at step 16 with 5 "
                             "resumed finite steps")
    shutil.rmtree(d, ignore_errors=True)


def phase_preempt(root: str, report: dict):
    """The preemption twin on the card at its default 200 steps: it
    asserts its restarted losses equal the uninterrupted run's and
    prints PASS."""
    from repro_torch.examples import train_with_preemption as twin

    d = os.path.join(root, "preempt")
    t0 = time.monotonic()
    with _step_clock() as rec:
        lines = _echoed(twin.main, ["--device", "cuda", "--ckpt-dir", d])
    report.update(s=time.monotonic() - t0, runs=rec)
    if not any(x.startswith("PASS: ") for x in lines):
        raise AssertionError("preempt: the twin printed no PASS line")
    shutil.rmtree(d, ignore_errors=True)
    shutil.rmtree(d + "_ref", ignore_errors=True)


# ---------------------------------------------------------------------------
# train_moe, train_hybrid: full-width training with checkpoint images
# ---------------------------------------------------------------------------

# B 1: at B 2 one step of this config peaks at 66.9 GB on its own and
# runs out of the card's memory while an image's snapshot (a device copy
# of params and moments, 20.6 GB) is held; at B 1 it peaks at 74.9 GB
# (tools/probe_determinism.py on an H100 80GB HBM3, 700 W, with an
# optimizer update that held every gradient to its end; the phase, with
# the update freeing them as it goes, peaks at 73.1 GB).  S 8192 is
# twice the SWA window, so training takes the sliding-window path.
MOE_BATCH, MOE_SEQ = 1, 8192
# the training phases but train_moe: the reference's train_4k sequence
# length, cut in batch from train_4k's 256.  hymba-1.5b at full depth and
# B 4 peaks at 73.7 GB with an image's snapshot (a device copy of params
# and moments, 21.6 GB) held, 51.4 GB before it (an H100 80GB HBM3, 700
# W): the optimizer update, not the batch, sets the peak
TRAIN_4K_BATCH, TRAIN_4K_SEQ = 4, 4096
# The depth of the training phases of hymba-1.5b, rwkv6-3b and
# whisper-large-v3 (both stacks), each at full width.  Each is a
# fraction of the depth that fits one card (hymba 32 of 32 layers, rwkv
# 16 of 32, whisper 24 + 24 of 32 + 32, each ~1.8 B params stored and
# 71-74 GB at its peak with an image in flight) so that the whole smoke,
# with its vision and mesh phases, stays well inside its time limit:
# each phase's time is mostly its images' writes and restores, which
# shrink with the depth.  At 16 and 12 + 12 layers hymba's and whisper's
# took 85.2 and 93.2 s of a 1149.6 s smoke on a slow host (an H100 80GB
# HBM3 at 700 W, whose host ran the other phases 14% slower than the
# fastest seen), past the smoke's 1,120 s budget.  rwkv's 8 layers went
# to 4 to pay for the six serve mesh phases (train_rwkv took 86.2 s at
# 8 layers on the 1098.9 s run's host).
HYBRID_LAYERS, RWKV_LAYERS, WHISPER_LAYERS = 8, 4, 8
# the depth of hymba-1.5b, rwkv6-3b and whisper-large-v3 (both stacks)
# on the (1 x 1) mesh, at full width, for the smoke's time: each phase
# also runs a mesh-free twin, and at 2 layers (images of 2.5, 6.2 and
# 3.3 GB) each takes 16-30 s on an H100 80GB HBM3 at 700 W; serving
# whisper on the mesh takes the same cut, beside its own twin
MESH_LAYERS = 2
# llama-3.2-vision-11b at full width cut to one group of 3 layers, 2 self
# blocks and 1 cross block (`n_layers = cross_attn_every = 3`;
# 1,746,960,384 params stored, whisper's and hymba's size; the untied
# 128,256-row embedding and head are 1.05 B of them): one full group of
# the config's 5 layers (2,183,184,384 params) needs 36 bytes a param
# with the update and an image in flight, 78.6 GB before any activation
VISION_LAYERS = 3
# serve_whisper's prompt: with SERVE_STEPS decoded tokens it ends at the
# decoder's 448-token context
WHISPER_PROMPT = 432


def _stored_params(cfg) -> int:
    """Parameters as the port stores them (heads and vocab padded), which
    `param_count` leaves out."""
    from repro_torch.models.transformer import init_params
    from repro_torch.tree import tree_leaves

    return sum(t.numel() for t in tree_leaves(init_params(cfg, None,
                                                          "meta")[0]))


def _need_disk(path: str, nbytes: int, what: str, label: str) -> None:
    free = shutil.disk_usage(path).free
    if free < nbytes:
        raise AssertionError(f"{label}: {what} needs {nbytes} bytes on "
                             f"disk, {free} free under {path}")


def phase_train_wide(cfg, rc, root: str, report: dict, label: str):
    """6 steps with images requested at steps 2 and 4 (XOR-delta params;
    4 a delta on 2), a fresh runtime restoring 4 through the chain whose
    2 steps repeat steps 4-5 (loss, and `moe_aux` for MoE) bit for bit;
    then an int8-moment image checked as phase 3 does.  Records the peak
    device memory of the first two steps, before any image holds a
    snapshot copy of the state."""
    import math

    import torch

    from repro_torch.core.runtime import MANARuntime

    keys = ("loss", "moe_aux") if cfg.moe is not None else ("loss",)
    state_bytes = 12 * _stored_params(cfg)        # params, m, v in f32
    d = os.path.join(root, label)
    os.makedirs(d)
    _need_disk(d, 2 * state_bytes + (1 << 30), "two full-size images", label)
    rt = MANARuntime(cfg, rc, ckpt_dir=d, delta_params=True, device="cuda")
    t0 = time.monotonic()
    rt.initialize()
    torch.cuda.synchronize()
    report["init_s"] = time.monotonic() - t0

    def request(step, m):
        if step == 1:
            report["peak_before_images"] = torch.cuda.max_memory_allocated()
        if step in (1, 3):
            rt.request_checkpoint()

    hist, report["step_s"] = _timed_run(rt, 6, request)
    report["writes"] = list(rt.ckpt.stats)
    _check_delta_bases(rt, {2: None, 4: 2}, label)
    first = [tuple(h[k] for k in keys) for h in hist]
    report["losses"] = first
    if not all(math.isfinite(v) for pair in first for v in pair):
        raise AssertionError(f"{label}: losses not finite: {first}")
    log(f"{label}: 6 steps, {keys} {first}, images {rt.ckpt.steps()}")
    rt.close()
    del rt
    torch.cuda.empty_cache()

    rt2 = MANARuntime(cfg, rc, ckpt_dir=d, delta_params=True, device="cuda")
    t0 = time.monotonic()
    start = rt2.restore(4)
    torch.cuda.synchronize()
    report["restore_chain_s"] = time.monotonic() - t0
    if start != 4:
        raise AssertionError(f"{label}: restored at step {start}, want 4")
    hist2, report["resumed_step_s"] = _timed_run(rt2, 2)
    resumed = [tuple(h[k] for k in keys) for h in hist2]
    if resumed != first[4:6]:
        raise AssertionError(f"{label}: resume not bit-identical: "
                             f"{resumed} != {first[4:6]}")
    log(f"{label}: restore of step 4 (chain 4->2) in "
        f"{report['restore_chain_s']:.3f} s; resumed {keys} "
        f"{resumed} equal steps 4-5 bit for bit")
    rt2.close()
    del rt2
    shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()

    _need_disk(root, state_bytes // 2 + (1 << 30), "an int8-moment image",
               label)
    phase_int8(cfg, rc, root, report, label=label)


def _depth(cfg) -> str:
    """How deep `cfg` is against its arch's full config."""
    from repro_torch.configs import ARCHS

    full = ARCHS[cfg.arch_id]
    depth = (f"full depth, {cfg.n_layers} layers"
             if cfg.n_layers == full.n_layers else
             f"cut to {cfg.n_layers} of {full.n_layers} layers")
    if cfg.enc_dec:
        depth += (f" (decoder) and {cfg.n_enc_layers} of "
                  f"{full.n_enc_layers} (encoder)")
    if cfg.cross_attn_every:
        depth += (f" ({cfg.n_layers // cfg.cross_attn_every} group(s) of "
                  f"{cfg.cross_attn_every - 1} self blocks and a cross block "
                  f"over {cfg.vision_tokens} patches a sample)")
    return depth


def report_train_wide(label: str, cfg, rc, r: dict, peak: int, wall: float,
                      card: str):
    log(f"{label}: {cfg.arch_id} at full width, {_depth(cfg)} "
        f"({_stored_params(cfg)} params stored; d {cfg.d_model}, "
        f"{cfg.n_heads_padded}/{cfg.n_kv_heads_padded} padded heads, d_ff "
        f"{cfg.d_ff}"
        + (f", {cfg.moe.num_experts} experts top-{cfg.moe.top_k}"
           if cfg.moe else "")
        + (f", SSM state {cfg.ssm_state} x d_inner "
           f"{cfg.ssm_expand * cfg.d_model}" if cfg.ssm_state else "")
        + (f", SWA {cfg.sliding_window}" if cfg.sliding_window else "")
        + (", attention-free (RWKV-6 time-mix)" if cfg.rwkv else "")
        + (f", enc-dec: {cfg.n_enc_layers} encoder layers over "
           f"{cfg.enc_positions} frames" if cfg.enc_dec else "")
        + f"), B={rc.shape.global_batch} "
        f"S={rc.shape.seq_len}, bf16 compute, f32 params")
    log(f"{label}: init_s {r['init_s']:.4f}; step_s "
        f"{[round(x, 4) for x in r['step_s']]}; resumed "
        f"{[round(x, 4) for x in r['resumed_step_s']]} [{card}]")
    for w in r["writes"] + [r["int8_write"]]:
        log(f"{label}: image step {w['step']}: {w['bytes']} bytes, "
            f"snapshot_s {w['snapshot_s']}, write_s {w['write_s']} [{card}]")
    before = r["peak_before_images"]
    log(f"{label}: restore_s chain 4->2 {r['restore_chain_s']:.4f}, int8 "
        f"image {r['restore_int8_s']:.4f}; phase {wall:.2f} s; "
        f"max_memory_allocated {peak} bytes ({peak / 2**30:.2f} GiB), of "
        f"the first two steps before any image {before} bytes "
        f"({before / 2**30:.2f} GiB) [{card}]")


def report_entry_points(r: dict, peaks: dict, wall: dict, card: str):
    for tag, run in r["cli"].items():
        if isinstance(run, dict):
            log(f"cli {tag}: {run['s']:.2f} s, step_s "
                f"{[round(x, 4) for x in run['step_s']]}, images "
                f"{[(w['step'], w['bytes'], w['write_s']) for w in run['writes']]}"
                f" (step, bytes, write_s) [{card}]")
    for name in ("quickstart", "preempt"):
        runs = r[name]["runs"]
        steps = sorted(x for run in runs for x in run["step_s"][1:])
        log(f"{name}: {r[name]['s']:.2f} s, {len(runs)} runs, "
            f"{sum(len(run['step_s']) for run in runs)} steps, median step "
            f"{steps[len(steps) // 2]:.4f} s (range {steps[0]:.4f}-"
            f"{steps[-1]:.4f}, first step of each run left out) [{card}]")
    for name in ("cli", "quickstart", "preempt"):
        log(f"{name}: phase {wall[name]:.2f} s, max_memory_allocated "
            f"{peaks[name]} bytes ({peaks[name] / 2**30:.2f} GiB) [{card}]")


# ---------------------------------------------------------------------------
# remat and dryrun
# ---------------------------------------------------------------------------

# run "full" first: the other policies are held to its bits
REMAT_POLICIES = ("full", "none", "dots", "comm")
REMAT_STEPS = 3
# the dry-run's cells, each `python -m repro_torch.launch.dryrun` in a
# process of its own: the reference test's decode cell on 2x16x16, and
# the training cell on 16x16
DRYRUN_CELLS = {"decode": ("qwen1.5-0.5b", "decode_32k", "pod"),
                "train": ("qwen2-0.5b", "train_4k", "single")}
# the dry-run's prediction of the remat phase's cell under each policy,
# on fake CUDA tensors, in a process of its own
PREDICT_REMAT = r"""
import json, sys, time
from repro_torch.configs import ARCHS
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.launch.dryrun import dry_run

arch, seq, batch = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
cfg = ARCHS[arch]
shape = ShapeConfig("smoke_h100", seq, batch, "train")
out = {}
for policy in sys.argv[4].split(","):
    t0 = time.monotonic()
    cell = dry_run(cfg, shape, RunConfig(model=cfg, shape=shape,
                                         remat_policy=policy), None, "cuda")
    out[policy] = dict(cell["memory"], dot_flops=cell["hlo"]["dot_flops"],
                       s=time.monotonic() - t0)
print(json.dumps(out), flush=True)
"""


def start_dry_runs(src: str, root: str, cfg, rc) -> dict:
    """Start the dry-run's processes (they run on the host, beside the
    card's phases): one per cell of `DRYRUN_CELLS`, and the remat
    phase's predictions for (cfg, rc.shape).  {name: (process, output
    path, start time)}; each writes its standard output and errors to
    the output path."""
    env = dict(os.environ, PYTHONPATH=src)
    argv = {name: [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", mesh,
                   "--out", os.path.join(root, f"dryrun_{name}.json")]
            for name, (arch, shape, mesh) in DRYRUN_CELLS.items()}
    argv["predict"] = [sys.executable, "-c", PREDICT_REMAT, cfg.arch_id,
                       str(rc.shape.seq_len), str(rc.shape.global_batch),
                       ",".join(REMAT_POLICIES)]
    jobs = {}
    for name, cmd in argv.items():
        path = os.path.join(root, f"dryrun_{name}.log")
        with open(path, "w") as f:
            jobs[name] = (subprocess.Popen(cmd, env=env, stdout=f,
                                           stderr=subprocess.STDOUT),
                          path, time.monotonic())
    return jobs


def _finished(jobs: dict, name: str, timeout: float = 900) -> str:
    """The output of dry-run job `name` after it exits (raises unless it
    exits 0); logs how long after its start it was seen done."""
    proc, path, t0 = jobs[name]
    ran = proc.poll() is None
    code = proc.wait(timeout=timeout)
    with open(path) as f:
        text = f.read()
    log(f"dry-run job {name}: exit {code}, "
        f"{'ended' if ran else 'had ended by'} {time.monotonic() - t0:.1f} s "
        f"after its start")
    if code != 0:
        raise AssertionError(f"dry-run job {name} failed:\n{text[-3000:]}")
    return text


def phase_remat(cfg, rc, report: dict, jobs: dict):
    """The remat policies (`repro_torch.models.remat`) on the training
    cell: from one state, one train step under each of
    `REMAT_POLICIES`, `REMAT_STEPS` times; loss, grad norm and every
    updated parameter under "dots" and "comm" must be "full"'s bits
    ("none"'s largest difference from them is printed).  Each step's
    peak (`max_memory_allocated` above what was allocated before it) and
    the median step time, beside the dry-run's predictions for the same
    cell (`dry_run` on fake CUDA tensors: the step's live-set peak and
    its dot FLOPs); the measured and the predicted peaks must both order
    none >= dots >= comm >= full, with none > full."""
    import torch

    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.training.step import init_train_state, make_train_step
    from repro_torch.tree import tree_leaves

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = init_train_state(cfg, rc, gen, dev)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticDataset(
        cfg, rc.shape, seed=0).get_batch(0).items()}
    full = None
    for policy in REMAT_POLICIES:
        step = make_train_step(cfg, dataclasses.replace(
            rc, remat_policy=policy))
        times, peaks = [], []
        for i in range(REMAT_STEPS):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.monotonic()
            new, metrics = step(state, batch)
            torch.cuda.synchronize()
            times.append(time.monotonic() - t0)
            peaks.append(torch.cuda.max_memory_allocated() - before)
            if i == 0:
                got = ([metrics["loss"], metrics["grad_norm"]]
                       + tree_leaves(new["params"]))
            del new, metrics
        if full is None:
            full = got
        elif policy == "none":
            report["none_max_diff"] = max(float((a - b).abs().max())
                                          for a, b in zip(got, full))
        elif not all(torch.equal(a, b) for a, b in zip(got, full)):
            raise AssertionError(f"remat: {policy} is not full's bits")
        del got
        report[policy] = {"step_s": sorted(times), "peak": max(peaks)}
    del full, state
    predicted = json.loads(_finished(jobs, "predict").splitlines()[-1])
    for policy in REMAT_POLICIES:
        report[policy]["predicted"] = predicted[policy]
    order = ("none", "dots", "comm", "full")
    for what, peak in (("measured", lambda p: report[p]["peak"]),
                       ("predicted", lambda p: predicted[p]["temp_bytes"])):
        got = [peak(p) for p in order]
        if not (got == sorted(got, reverse=True) and got[0] > got[-1]):
            raise AssertionError(f"remat: {what} step peaks {got} do not "
                                 f"order none >= dots >= comm >= full")


def report_remat(report: dict, card: str) -> None:
    none_flops = report["none"]["predicted"]["dot_flops"]
    for policy in REMAT_POLICIES:
        r, p = report[policy], report[policy]["predicted"]
        log(f"remat {policy}: step peak {r['peak']} bytes, predicted "
            f"{p['temp_bytes']} (measured / predicted "
            f"{r['peak'] / p['temp_bytes']:.4f}); predicted peak_bytes "
            f"{p['peak_bytes']} with the state and batch "
            f"({p['argument_bytes']}); median step "
            f"{r['step_s'][len(r['step_s']) // 2]:.4f} s of "
            f"{[round(t, 4) for t in r['step_s']]}; predicted dot FLOPs "
            f"{p['dot_flops']} ({p['dot_flops'] / none_flops:.4f} x none's;"
            f" the prediction took {p['s']:.1f} s) [{card}]")
    log(f"remat: full, dots and comm bit-equal (loss, grad norm, every "
        f"updated param); none's largest difference from them "
        f"{report['none_max_diff']:.3e} [{card}]")


def phase_dryrun(report: dict, jobs: dict):
    """The dry-run's two cells (`DRYRUN_CELLS`), started with the smoke:
    each must come back "ok" with dot FLOPs and a peak, and the training
    cell with collective bytes."""
    for name in DRYRUN_CELLS:
        text = _finished(jobs, name)
        proc, path, _ = jobs[name]
        with open(path.replace(".log", ".json")) as f:
            (cell,) = json.load(f)
        cell.pop("trace", None)
        log(f"dry-run {name}: {json.dumps(cell)}")
        if cell["status"] != "ok" or not cell["hlo"]["dot_flops"] > 0 \
                or cell["memory"]["peak_bytes"] is None \
                or (name == "train" and not cell["collectives"]["total"] > 0):
            raise AssertionError(f"dry-run {name}: {cell}\n{text[-3000:]}")
        report[name] = cell


def main() -> int:
    import torch

    t_start = time.monotonic()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on "
              "a GPU", file=sys.stderr)
        return 2
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)

    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.kernels import _build
    from repro_torch.kernels.checksum import ops as cops
    from repro_torch.kernels.delta import ops as dops
    from repro_torch.kernels.quantize import ops as qops

    # phase 0: setup
    card = card_line()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"deterministic algorithms "
        f"{'on' if torch.are_deterministic_algorithms_enabled() else 'off'}, "
        f"CUBLAS_WORKSPACE_CONFIG "
        f"{os.environ.get('CUBLAS_WORKSPACE_CONFIG')!r}; allow_tf32 False "
        f"for matmul and cuDNN")
    build_s = _build.build_all()
    log(f"kernels built in {build_s:.2f} s (nvcc sm_90a, one per source, "
        f"in parallel)")
    for name, text in _build.build_log.items():
        for line in text.splitlines():
            if "Used" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    # phase 1
    rows = phase_kernels(card)

    # phases 2-3 and the serving phases: the main path, each phase
    # counted from zero, each with its own peak memory
    cfg = ARCHS["qwen2-0.5b"]
    rc = RunConfig(model=cfg, shape=ShapeConfig("smoke_h100", 1024, 8, "train"))
    dense_rc = RunConfig(model=cfg,
                         shape=ShapeConfig("serve_h100", 2048, 8, "prefill"))
    # Mixtral-8x7B at full width, cut in depth only (32 -> 4 layers)
    moe_cfg = dataclasses.replace(ARCHS["mixtral-8x7b"], n_layers=4)
    moe_rc = RunConfig(model=moe_cfg,
                       shape=ShapeConfig("serve_h100", 8192, 4, "prefill"))
    # Mixtral-8x7B at full width, cut in depth only (32 -> 1 layer: 1.71 B
    # params take 16 bytes each with grads and AdamW moments, and an image
    # in flight holds a device copy of params and moments besides)
    train_moe_cfg = dataclasses.replace(ARCHS["mixtral-8x7b"], n_layers=1)
    train_moe_rc = RunConfig(model=train_moe_cfg, shape=ShapeConfig(
        "train_moe_h100", MOE_SEQ, MOE_BATCH, "train"), attn_chunk=128)
    # hymba-1.5b at full width and depth, serving as serve_dense does,
    # training cut in depth (`HYBRID_LAYERS`) and batch (`TRAIN_4K_BATCH`)
    hybrid_cfg = ARCHS["hymba-1.5b"]
    hybrid_rc = RunConfig(model=hybrid_cfg,
                          shape=ShapeConfig("serve_h100", 2048, 8, "prefill"))
    train_hybrid_cfg = dataclasses.replace(hybrid_cfg, n_layers=HYBRID_LAYERS)
    train_hybrid_rc = RunConfig(model=train_hybrid_cfg, shape=ShapeConfig(
        "train_hybrid_h100", TRAIN_4K_SEQ, TRAIN_4K_BATCH, "train"),
        attn_chunk=128)
    # rwkv6-3b: serving at full width and depth, training cut in depth
    # (`RWKV_LAYERS`) and batch (`TRAIN_4K_BATCH`)
    rwkv_cfg = ARCHS["rwkv6-3b"]
    rwkv_rc = RunConfig(model=rwkv_cfg,
                        shape=ShapeConfig("serve_h100", 2048, 8, "prefill"))
    train_rwkv_cfg = dataclasses.replace(rwkv_cfg, n_layers=RWKV_LAYERS)
    train_rwkv_rc = RunConfig(model=train_rwkv_cfg, shape=ShapeConfig(
        "train_rwkv_h100", TRAIN_4K_SEQ, TRAIN_4K_BATCH, "train"))
    # whisper-large-v3: serving at full width and depth (8 requests of
    # 1500 frames and a `WHISPER_PROMPT` prompt), training cut in depth
    # (`WHISPER_LAYERS`, both stacks) and batch (`TRAIN_4K_BATCH` x
    # `TRAIN_4K_SEQ` decoder tokens, 1500 frames a sample)
    whisper_cfg = ARCHS["whisper-large-v3"]
    whisper_rc = RunConfig(model=whisper_cfg, shape=ShapeConfig(
        "serve_h100", WHISPER_PROMPT, 8, "prefill"))
    train_whisper_cfg = dataclasses.replace(
        whisper_cfg, n_layers=WHISPER_LAYERS, n_enc_layers=WHISPER_LAYERS)
    train_whisper_rc = RunConfig(model=train_whisper_cfg, shape=ShapeConfig(
        "train_whisper_h100", TRAIN_4K_SEQ, TRAIN_4K_BATCH, "train"),
        attn_chunk=128)
    # llama-3.2-vision-11b: serving at full width and depth (8 prompts of
    # 2048 tokens, each with 1600 patches), training cut in depth
    # (`VISION_LAYERS`) and batch (`TRAIN_4K_BATCH` x `TRAIN_4K_SEQ`, 1600
    # patches a sample)
    vision_cfg = ARCHS["llama-3.2-vision-11b"]
    vision_rc = RunConfig(model=vision_cfg,
                          shape=ShapeConfig("serve_h100", 2048, 8, "prefill"))
    train_vision_cfg = dataclasses.replace(
        vision_cfg, n_layers=VISION_LAYERS, cross_attn_every=VISION_LAYERS)
    train_vision_rc = RunConfig(model=train_vision_cfg, shape=ShapeConfig(
        "train_vision_h100", TRAIN_4K_SEQ, TRAIN_4K_BATCH, "train"),
        attn_chunk=128)
    # hymba-1.5b and rwkv6-3b on the (1 x 1) mesh: full width, cut to
    # `MESH_LAYERS`, B 4 x S 4096 as their train phases
    mesh_hybrid_cfg = dataclasses.replace(hybrid_cfg, n_layers=MESH_LAYERS)
    mesh_hybrid_rc = dataclasses.replace(train_hybrid_rc, model=mesh_hybrid_cfg)
    mesh_rwkv_cfg = dataclasses.replace(rwkv_cfg, n_layers=MESH_LAYERS)
    mesh_rwkv_rc = dataclasses.replace(train_rwkv_rc, model=mesh_rwkv_cfg)
    # whisper-large-v3 on the (1 x 1) mesh: full width, both stacks cut to
    # `MESH_LAYERS`, train_whisper's batch and 1500 frames a sample
    mesh_whisper_cfg = dataclasses.replace(
        whisper_cfg, n_layers=MESH_LAYERS, n_enc_layers=MESH_LAYERS)
    mesh_whisper_rc = dataclasses.replace(train_whisper_rc,
                                          model=mesh_whisper_cfg)
    # serving on the (1 x 1) mesh: serve_whisper's and serve_vision's
    # cells cut to `MESH_LAYERS` (both stacks) and to train_vision's one
    # group of `VISION_LAYERS`, each beside a mesh-free twin at that
    # depth; the other families serve their serve_* cells uncut
    mesh_serve_whisper_rc = dataclasses.replace(whisper_rc,
                                                model=mesh_whisper_cfg)
    mesh_serve_vision_rc = dataclasses.replace(vision_rc,
                                               model=train_vision_cfg)
    # hymba-1.5b and rwkv6-3b serve on the mesh cut to `MESH_LAYERS`,
    # beside their own twins, for the smoke's time (at 32 layers they
    # took 17.7 and 12.8 s, held to serve_hybrid's and serve_rwkv's
    # logits)
    mesh_serve_hybrid_rc = dataclasses.replace(hybrid_rc,
                                               model=mesh_hybrid_cfg)
    mesh_serve_rwkv_rc = dataclasses.replace(rwkv_rc, model=mesh_rwkv_cfg)
    root = tempfile.mkdtemp(prefix="chip_smoke_")
    # the dry-run's processes run on the host beside the phases below;
    # the remat and dryrun phases collect them
    jobs = start_dry_runs(src, root, cfg, rc)
    report: dict = {"serve_dense": {}, "serve_moe": {}, "serve_hybrid": {},
                    "serve_rwkv": {}, "serve_whisper": {}, "serve_vision": {},
                    "world_pipeline": {}, "world_cross": {},
                    "world_elastic": {}, "cli": {}, "quickstart": {},
                    "preempt": {}, "train_moe": {}, "train_hybrid": {},
                    "train_rwkv": {}, "train_whisper": {},
                    "train_vision": {}, "train_mesh": {},
                    "train_mesh_moe": {},
                    "train_mesh_hybrid": {}, "train_mesh_rwkv": {},
                    "train_mesh_whisper": {}, "train_mesh_vision": {},
                    "serve_mesh_dense": {}, "serve_mesh_moe": {},
                    "serve_mesh_hybrid": {}, "serve_mesh_rwkv": {},
                    "serve_mesh_whisper": {}, "serve_mesh_vision": {},
                    "remat": {}, "dryrun": {}}
    counters = {"checksum": (cops, "launches"), "xor_delta": (dops, "launches"),
                "quantize_int8": (qops, "launches"),
                "dequantize_int8": (qops, "dequantize_launches")}
    paths = {
        "resume": (lambda: phase_resume(cfg, rc, root, report),
                   ("checksum", "xor_delta")),
        "int8": (lambda: phase_int8(cfg, rc, root, report),
                 ("checksum", "quantize_int8", "dequantize_int8")),
        "serve_dense": (lambda: phase_serve(cfg, dense_rc, 8, root,
                                            report["serve_dense"]),
                        ("checksum", "xor_delta")),
        "serve_moe": (lambda: phase_serve(moe_cfg, moe_rc, 4, root,
                                          report["serve_moe"]),
                      ("checksum", "xor_delta")),
        "serve_hybrid": (lambda: phase_serve(hybrid_cfg, hybrid_rc, 8, root,
                                             report["serve_hybrid"]),
                         ("checksum", "xor_delta")),
        "serve_rwkv": (lambda: phase_serve(rwkv_cfg, rwkv_rc, 8, root,
                                           report["serve_rwkv"]),
                       ("checksum", "xor_delta")),
        "serve_whisper": (lambda: phase_serve(
            whisper_cfg, whisper_rc, 8, root, report["serve_whisper"]),
            ("checksum", "xor_delta")),
        "serve_vision": (lambda: phase_serve(
            vision_cfg, vision_rc, 8, root, report["serve_vision"]),
            ("checksum", "xor_delta")),
        "world_pipeline": (lambda: phase_world_pipeline(
            root, report["world_pipeline"]), ("xor_delta",)),
        "world_cross": (lambda: phase_world_cross(
            root, report["world_cross"]), ("xor_delta",)),
        "world_elastic": (lambda: phase_world_elastic(
            root, report["world_elastic"]), ()),
        # the entry points install a SIGUSR1 handler (put back on close):
        # after the worlds, whose socket ranks are spawned from here
        "cli": (lambda: phase_cli(root, report["cli"]),
                ("checksum", "xor_delta")),
        "quickstart": (lambda: phase_quickstart(root, report["quickstart"]),
                       ("checksum",)),
        "preempt": (lambda: phase_preempt(root, report["preempt"]),
                    ("checksum",)),
        "train_moe": (lambda: phase_train_wide(
            train_moe_cfg, train_moe_rc, root, report["train_moe"],
            "train_moe"),
            ("checksum", "xor_delta", "quantize_int8", "dequantize_int8")),
        "train_hybrid": (lambda: phase_train_wide(
            train_hybrid_cfg, train_hybrid_rc, root, report["train_hybrid"],
            "train_hybrid"),
            ("checksum", "xor_delta", "quantize_int8", "dequantize_int8")),
        "train_rwkv": (lambda: phase_train_wide(
            train_rwkv_cfg, train_rwkv_rc, root, report["train_rwkv"],
            "train_rwkv"),
            ("checksum", "xor_delta", "quantize_int8", "dequantize_int8")),
        "train_whisper": (lambda: phase_train_wide(
            train_whisper_cfg, train_whisper_rc, root,
            report["train_whisper"], "train_whisper"),
            ("checksum", "xor_delta", "quantize_int8", "dequantize_int8")),
        "train_vision": (lambda: phase_train_wide(
            train_vision_cfg, train_vision_rc, root, report["train_vision"],
            "train_vision"),
            ("checksum", "xor_delta", "quantize_int8", "dequantize_int8")),
        # the remat policies on the training cell, beside the dry-run's
        # predictions (started with the smoke)
        "remat": (lambda: phase_remat(cfg, rc, report["remat"], jobs), ()),
        # the mesh phases last, on one NCCL group (`nccl_mesh`): after
        # phase 2 and train_moe, whose mesh-free losses they are held to
        "train_mesh": (lambda: phase_train_mesh_family(
            cfg, rc, root, report["train_mesh"], "train_mesh", 4, (2, 4),
            want=[(x,) for x in report["resume_losses"][:4]], int8=True),
            ("checksum", "xor_delta", "quantize_int8", "dequantize_int8")),
        # one full image: its 20.6 GB writes and reads are most of the
        # phase, and train_moe runs XOR, quantize and dequantize on the
        # same leaves without a mesh
        "train_mesh_moe": (lambda: phase_train_mesh_family(
            train_moe_cfg, train_moe_rc, root, report["train_mesh_moe"],
            "train_mesh_moe", 4, (2,),
            want=report["train_moe"]["losses"][:4]), ("checksum",)),
        "train_mesh_hybrid": (lambda: phase_train_mesh_family(
            mesh_hybrid_cfg, mesh_hybrid_rc, root,
            report["train_mesh_hybrid"], "train_mesh_hybrid", 3, (2,),
            int8=True),
            ("checksum", "xor_delta", "quantize_int8", "dequantize_int8")),
        "train_mesh_rwkv": (lambda: phase_train_mesh_family(
            mesh_rwkv_cfg, mesh_rwkv_rc, root, report["train_mesh_rwkv"],
            "train_mesh_rwkv", 3, (2,), int8=True),
            ("checksum", "xor_delta", "quantize_int8", "dequantize_int8")),
        "train_mesh_whisper": (lambda: phase_train_mesh_family(
            mesh_whisper_cfg, mesh_whisper_rc, root,
            report["train_mesh_whisper"], "train_mesh_whisper", 3, (2,),
            int8=True),
            ("checksum", "xor_delta", "quantize_int8", "dequantize_int8")),
        # as train_mesh_moe: one full ~21 GB image, and train_vision runs
        # XOR, quantize and dequantize on the same leaves without a mesh
        "train_mesh_vision": (lambda: phase_train_mesh_family(
            train_vision_cfg, train_vision_rc, root,
            report["train_mesh_vision"], "train_mesh_vision", 4, (2,),
            want=report["train_vision"]["losses"][:4]), ("checksum",)),
        # serving on the mesh, last: dense, MoE, hybrid and rwkv held to
        # their serve_* phases' logits and tokens (kept on the host),
        # whisper and vision to their own twins; checksum and XOR on the
        # gathered decode state
        "serve_mesh_dense": (lambda: phase_serve_mesh(
            cfg, dense_rc, 8, root, report["serve_mesh_dense"],
            "serve_mesh_dense", want=_served(report["serve_dense"])),
            ("checksum", "xor_delta")),
        "serve_mesh_moe": (lambda: phase_serve_mesh(
            moe_cfg, moe_rc, 4, root, report["serve_mesh_moe"],
            "serve_mesh_moe", want=_served(report["serve_moe"])),
            ("checksum", "xor_delta")),
        "serve_mesh_hybrid": (lambda: phase_serve_mesh(
            mesh_hybrid_cfg, mesh_serve_hybrid_rc, 8, root,
            report["serve_mesh_hybrid"], "serve_mesh_hybrid"),
            ("checksum", "xor_delta")),
        "serve_mesh_rwkv": (lambda: phase_serve_mesh(
            mesh_rwkv_cfg, mesh_serve_rwkv_rc, 8, root,
            report["serve_mesh_rwkv"], "serve_mesh_rwkv"),
            ("checksum", "xor_delta")),
        "serve_mesh_whisper": (lambda: phase_serve_mesh(
            mesh_whisper_cfg, mesh_serve_whisper_rc, 8, root,
            report["serve_mesh_whisper"], "serve_mesh_whisper"),
            ("checksum", "xor_delta")),
        "serve_mesh_vision": (lambda: phase_serve_mesh(
            train_vision_cfg, mesh_serve_vision_rc, 8, root,
            report["serve_mesh_vision"], "serve_mesh_vision"),
            ("checksum", "xor_delta")),
        # the dry-run's two cells, started with the smoke
        "dryrun": (lambda: phase_dryrun(report["dryrun"], jobs), ()),
    }
    by_phase, peaks, wall = {}, {}, {}
    try:
        for phase, (drive, _) in paths.items():
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            for mod, attr in counters.values():
                setattr(mod, attr, 0)
            t0 = time.monotonic()
            # a world phase returns the launches of its socket ranks'
            # processes, which this process's counters cannot see
            elsewhere = drive() or {}
            torch.cuda.synchronize()
            wall[phase] = time.monotonic() - t0
            by_phase[phase] = {n: getattr(mod, attr) + elsewhere.get(n, 0)
                               for n, (mod, attr) in counters.items()}
            peaks[phase] = torch.cuda.max_memory_allocated()
            log(f"phase {phase} done in {wall[phase]:.1f} s, peak "
                f"{peaks[phase]} bytes, launches {by_phase[phase]}"
                + (f" (of them in socket rank processes: {elsewhere})"
                   if elsewhere else ""))
    finally:
        for proc, _, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        # the mesh phases' NCCL group, made by the first of them
        if _MESH:
            import torch.distributed as dist

            _MESH.clear()
            dist.destroy_process_group()
    shutil.rmtree(root, ignore_errors=True)
    for name in ("serve_dense", "serve_moe", "serve_hybrid", "serve_rwkv",
                 "serve_whisper", "serve_vision"):
        report[name]["peak"] = peaks[name]

    # phase 4: report
    steps = report["step_s"]
    log(f"config qwen2-0.5b full width: {cfg.n_layers} L, d {cfg.d_model}, "
        f"{cfg.n_heads_padded}/{cfg.n_kv_heads_padded} padded heads, vocab "
        f"{cfg.vocab_size}; shape B=8 S=1024 bf16 compute, f32 params")
    log(f"step_s (host clock, synchronised) first run: "
        f"{[round(s, 4) for s in steps]}; resumed: "
        f"{[round(s, 4) for s in report['resumed_step_s']]} [{card}]")
    for w in report["resume_writes"] + [report["int8_write"]]:
        log(f"image step {w['step']}: {w['bytes']} bytes, snapshot_s "
            f"{w['snapshot_s']}, write_s {w['write_s']} [{card}]")
    log(f"restore_s: chain 4->2 {report['restore_chain_s']:.4f}, int8 image "
        f"{report['restore_int8_s']:.4f}; init_s {report['init_s']:.4f} "
        f"[{card}]")
    log(f"max_memory_allocated resume {peaks['resume']} bytes "
        f"({peaks['resume'] / 2**30:.2f} GiB), int8 {peaks['int8']} bytes "
        f"({peaks['int8'] / 2**30:.2f} GiB) [{card}]")
    for name, c, r in (("train_mesh", cfg, rc),
                       ("train_mesh_moe", train_moe_cfg, train_moe_rc),
                       ("train_mesh_hybrid", mesh_hybrid_cfg, mesh_hybrid_rc),
                       ("train_mesh_rwkv", mesh_rwkv_cfg, mesh_rwkv_rc),
                       ("train_mesh_whisper", mesh_whisper_cfg,
                        mesh_whisper_rc),
                       ("train_mesh_vision", train_vision_cfg,
                        train_vision_rc)):
        report_train_mesh_family(name, c, r, report[name], peaks[name],
                                 wall[name], card)
    for name, c, r, b, free in (
            ("serve_mesh_dense", cfg, dense_rc, 8, "serve_dense"),
            ("serve_mesh_moe", moe_cfg, moe_rc, 4, "serve_moe"),
            ("serve_mesh_hybrid", mesh_hybrid_cfg, mesh_serve_hybrid_rc, 8,
             None),
            ("serve_mesh_rwkv", mesh_rwkv_cfg, mesh_serve_rwkv_rc, 8, None),
            ("serve_mesh_whisper", mesh_whisper_cfg, mesh_serve_whisper_rc,
             8, None),
            ("serve_mesh_vision", train_vision_cfg, mesh_serve_vision_rc, 8,
             None)):
        report_serve_mesh(name, c, r, b, report[name],
                          report[free] if free else None, peaks[name],
                          wall[name], card)
    report_serve("serve_dense", cfg, dense_rc, 8, report["serve_dense"], card)
    report_serve("serve_moe", moe_cfg, moe_rc, 4, report["serve_moe"], card)
    report_serve("serve_hybrid", hybrid_cfg, hybrid_rc, 8,
                 report["serve_hybrid"], card)
    report_serve("serve_rwkv", rwkv_cfg, rwkv_rc, 8, report["serve_rwkv"],
                 card)
    report_serve("serve_whisper", whisper_cfg, whisper_rc, 8,
                 report["serve_whisper"], card)
    report_serve("serve_vision", vision_cfg, vision_rc, 8,
                 report["serve_vision"], card)
    report_worlds(report, peaks, wall, card)
    report_entry_points(report, peaks, wall, card)
    report_remat(report["remat"], card)
    for name, c, r in (("train_moe", train_moe_cfg, train_moe_rc),
                       ("train_hybrid", train_hybrid_cfg, train_hybrid_rc),
                       ("train_rwkv", train_rwkv_cfg, train_rwkv_rc),
                       ("train_whisper", train_whisper_cfg,
                        train_whisper_rc),
                       ("train_vision", train_vision_cfg, train_vision_rc)):
        report_train_wide(name, c, r, report[name], peaks[name], wall[name],
                          card)
    log(f"main-path launches, each phase from 0: {by_phase}")
    for r in rows:
        r["launches_by_phase"] = {p: c[r["name"]] for p, c in by_phase.items()}
        r["launches"] = sum(r["launches_by_phase"].values())
    keys = ["name", "route", "source", "replaces", "launches",
            "launches_by_phase", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "shape"]
    log(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    missing = [(p, n) for p, (_, names) in paths.items() for n in names
               if by_phase[p][n] <= 0]
    missing += [(None, r["name"]) for r in rows if r["launches"] <= 0]
    if missing:
        raise AssertionError(f"main path never launched (phase, kernel): "
                             f"{missing}")
    log(f"chip_smoke: {time.monotonic() - t_start:.1f} s in all, the "
        f"kernels' build included [{card}]")
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
