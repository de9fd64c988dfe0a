#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, `nvcc` (sm_90a) and the checkout's `src/`; it
imports nothing of JAX or of the JAX package `repro`.  Phases, each
fatal on failure:

  0. setup: card name and power limit, deterministic algorithms, TF32
     off, build of the kernels from `src/repro_torch/kernels/*/csrc`;
  1. each kernel (checksum, XOR delta, int8 quantize, int8 dequantize)
     against its plain PyTorch version on the card, bit for bit, at the
     main path's shapes and at edge lengths; device times of kernel,
     plain version and, where one PyTorch call computes the same
     function (`torch.bitwise_xor`, `torch.mul`), that call, beside the
     bound bytes / 3.35 TB/s; XOR and `torch.bitwise_xor` also timed
     call by call in turns (120 each: median, quartiles, range);
  2. main path: full-width qwen2-0.5b through `MANARuntime` on cuda,
     6 steps with an image every 2 (XOR-delta params), then a fresh
     runtime restores step 4 (chain 4 -> 2) and its 2 steps must repeat
     the first run's losses exactly;
  3. main path with int8 moments: one image, restored on the card
     (dequantize kernel); params and step bit-identical, moments within
     scale/2, every chunk's manifest digest equal to the numpy
     `checksum_np` of its file;
  4. report: step times, image bytes, write/restore seconds, peak device
     memory, and one JSON line of the kernels with their launches on the
     main path.  The counts are set to 0 just before each main-path
     phase (2, 3, serve_dense, serve_moe and the world phases) and read
     just after it, adding the counts that a world phase's spawned
     socket ranks report from their own processes; each phase must
     launch the kernels of its path (2: checksum, XOR; 3: checksum,
     quantize, dequantize; serving: checksum, XOR; world_pipeline and
     world_cross: XOR), and `launches` is their sum.  The peak device memory is reset before
     each phase and printed per phase.
  serve_dense, serve_moe: the serving path (`make_serve_steps`) with live
     decode-state images.  qwen2-0.5b at full width and depth, 8 prompts
     of 2048 tokens; Mixtral-8x7B at full width cut to 4 of 32 layers, 4
     prompts of 8192 tokens (twice the SWA window: prefill takes the SWA
     path and the first decode wraps the ring).  Each: prefill, 16
     greedy decode steps, an image of the decode state at token 6 (full)
     and at token 10 (XOR delta on 6); a fresh manager restores token 10
     through the chain onto the card, and tokens 11-15 decoded from it
     must equal the first run's tokens and logits bit for bit.  Decode
     after a shorter prefill must agree with a full forward over the
     same tokens (f32, the first 2 layers, norm-relative 1e-3).
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

The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

# cuBLAS picks a deterministic reduction only with a fixed workspace;
# this must be set before CUDA initialises
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

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
    state: per function, the sorted list of `reps` times in ms."""
    import torch

    for _ in range(warmup):
        for fn in fns:
            fn()
    ev = [[(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
          for _ in fns]
    torch.cuda.synchronize()
    for i in range(reps):
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
    cases = [(0, n) for n in (1, 3, 8191, 8192, 64 * MIB, 64 * MIB + 5)]
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
    err = 0
    pairs = [(a, b)]
    ragged = torch.randint(0, 256, (2 * 1_000_003 + 1,), dtype=torch.uint8,
                           device=dev, generator=gen)
    pairs.append((ragged[:1_000_003], ragged[1_000_003:2_000_006]))
    pairs.append((ragged[1:1_000_004], ragged[1_000_004:]))   # unaligned
    # the world phases' shards: 16 MiB and 64 MiB of f32 a rank
    w = torch.randn((CROSS_NUMEL,), generator=gen, device=dev)
    w2 = w.clone()
    w2[::97] += 1.0
    pairs += [(w[:WORLD_NUMEL], w2[:WORLD_NUMEL]), (w, w2)]
    for x, y in pairs:
        k = dops.xor_bytes(x, y)
        p = dref.xor_torch(as_bytes(x), as_bytes(y))
        if not torch.equal(k, p):
            raise AssertionError(f"xor kernel != plain at {x.numel()} elems")
        err = max(err, int((k.int() - p.int()).abs().max()))
    hx, hy = a[:3].cpu().numpy(), b[:3].cpu().numpy()
    if not np.array_equal(dops.xor_bytes(a[:3], b[:3]).cpu().numpy(),
                          dref.delta_np(hx, hy)):
        raise AssertionError("xor kernel != numpy twin")
    ra, rb = as_bytes(a), as_bytes(b)
    o = torch.empty_like(ra)
    lib = _build.library("delta")
    k_ms = device_ms(lambda: _build.check(lib.xor_launch(
        ra.data_ptr(), rb.data_ptr(), o.data_ptr(), ra.numel(), stream()),
        "xor"))
    p_ms = device_ms(lambda: dref.xor_torch(ra, rb))
    l_ms = device_ms(lambda: torch.bitwise_xor(ra, rb, out=o))
    nb = 3 * ra.numel()
    # kernel and library call taking turns, call by call
    k_t, l_t = interleaved_ms([
        lambda: _build.check(lib.xor_launch(
            ra.data_ptr(), rb.data_ptr(), o.data_ptr(), ra.numel(),
            stream()), "xor"),
        lambda: torch.bitwise_xor(ra, rb, out=o)])
    med = lambda t: t[len(t) // 2]
    iqr = max(k_t[3 * len(k_t) // 4] - k_t[len(k_t) // 4],
              l_t[3 * len(l_t) // 4] - l_t[len(l_t) // 4])
    verdict = ("kernel slower by more than the spread"
               if med(k_t) - med(l_t) > iqr else "level within the spread")
    log(f"xor interleaved with torch.bitwise_xor: kernel {spread(k_t)}; "
        f"library {spread(l_t)}; {verdict} [{card}]")
    rows.append(dict(
        name="xor_delta", route="cuda",
        source="src/repro_torch/kernels/delta/csrc/delta.cu",
        replaces="src/repro/kernels/delta/delta.py:21",
        max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms(nb),
        bound_by="bytes", library_ms=l_ms,
        shape="(151936, 896) f32 pair (embedding leaf)"))
    log(f"kernel xor_delta: bit-exact on (151936, 896) f32, the world "
        f"shards ({WORLD_NUMEL},) and ({CROSS_NUMEL},) f32, ragged and "
        f"unaligned bytes + numpy twin; kernel_ms={k_ms:.4f} "
        f"plain_ms={p_ms:.4f} library_ms={l_ms:.4f} "
        f"bound_ms={bound_ms(nb):.4f} [{card}]")
    del a, b, ra, rb, o, ragged, pairs, w, w2

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
    return rows


# ---------------------------------------------------------------------------
# phases 2-3: the main path
# ---------------------------------------------------------------------------

def _timed_run(rt, n: int):
    """rt.run(n) with the host time of each step (a step ends when its
    metrics reach the host, i.e. after a device synchronise)."""
    stamps = [time.monotonic()]
    hist = rt.run(n, on_metrics=lambda s, m: stamps.append(time.monotonic()))
    return hist, [b - a for a, b in zip(stamps, stamps[1:])]


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
    if rt.ckpt.steps() != [2, 4, 6]:
        raise AssertionError(f"images at {rt.ckpt.steps()}, want [2, 4, 6]")
    for s, want in ((2, None), (4, 2), (6, 4)):
        with open(os.path.join(rt.ckpt.step_dir(s), "manifest.json")) as f:
            arrays = json.load(f)["arrays"]
        bases = {e.get("base_step") for p, e in arrays.items()
                 if p.startswith("params/")}
        if bases != {want}:
            raise AssertionError(f"image {s}: params delta bases {bases}")
    losses = [h["loss"] for h in hist]
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


def phase_int8(cfg, rc, root: str, report: dict):
    import numpy as np
    import torch

    from repro_torch.core.runtime import MANARuntime
    from repro_torch.kernels.checksum.ref import checksum_np
    from repro_torch.kernels.quantize import ref as qref
    from repro_torch.tree import tree_leaves

    d = os.path.join(root, "int8")
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
    log(f"phase 3: int8-moment image restored in "
        f"{report['restore_int8_s']:.3f} s; params/step bit-identical, "
        f"moments within scale/2 (worst {worst:.4f} scale where the scale is "
        f"a normal f32); {n_files} "
        f"chunk digests equal checksum_np")
    rt.close()
    del rt, live, got
    shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()



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


def _check_decode_against_forward(params, cfg, rc, prompts, report):
    """Prefill + one decode step against a full forward over the same
    tokens, on the full-width params cut to their first 2 layers, in
    float32, for the first prompt.  (At full depth the random-init
    network amplifies rounding: decode and forward of qwen2-0.5b part far
    beyond rounding even in float32, while their first layers agree to
    it.)

    The prefill takes P tokens: P = S - 1, or the SWA window, so that the
    decode wraps a ring of capacity P.  The forward runs over P + 1
    tokens, or, with MoE, over P + 512 so that both fill whole groups of
    512: then the decoded token is the first of its group and no
    capacity limit drops it in either path (the decode's group of one
    token drops nothing).  Limit: norm-relative 1e-3."""
    import torch

    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map

    depth = 2
    cut = dataclasses.replace(cfg, n_layers=depth)
    cut_params = dict(params, blocks=tree_map(lambda t: t[:depth],
                                              params["blocks"]))
    f32 = dataclasses.replace(rc, model=cut, dtype="float32",
                              remat_policy="none")
    P = cfg.sliding_window or prompts.shape[1] - 1
    extra = 512 if cfg.moe is not None else 1
    toks = prompts[:1, :P + extra]
    if toks.shape[1] != P + extra or (cfg.moe is not None and P % 512):
        raise AssertionError(f"check needs {P + extra} tokens, P % 512 == 0")
    with torch.no_grad():
        _, st = T.prefill(cut_params, cut, f32, None, {"tokens": toks[:, :P]})
        dec, _ = T.decode_step(cut_params, cut, f32, None, st,
                               toks[:, P:P + 1])
        x, _, _ = T.forward(cut_params, cut, f32, None, {"tokens": toks})
        full = T._logits(cut_params, cut, x[:, P])
    err = _rel(dec[:, 0], full)
    report["decode_vs_forward"] = (err, P)
    if not (err < 1e-3 and torch.isfinite(dec).all()):
        raise AssertionError(f"decode after a prefill of {P} disagrees with "
                             f"the forward: {err}")


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
    prompts = torch.randint(0, cfg.vocab_size, (batch, S), generator=gen,
                            device=dev, dtype=torch.int32)

    t0 = time.monotonic()
    logits, state = prefill_step(params, {"tokens": prompts})
    torch.cuda.synchronize()
    report["prefill_s"] = time.monotonic() - t0
    T_cap = min(cfg.sliding_window, S) if cfg.sliding_window else (
        S + rc.decode_margin)
    want = (cfg.n_layers, batch, T_cap, cfg.n_kv_heads_padded, cfg.head_dim)
    if (tuple(logits.shape) != (batch, cfg.vocab_padded)
            or not torch.isfinite(logits).all()
            or int(state["pos"]) != S
            or tuple(state["layers"]["k"].shape) != want):
        raise AssertionError(f"prefill: logits {tuple(logits.shape)}, pos "
                             f"{int(state['pos'])}, cache "
                             f"{tuple(state['layers']['k'].shape)} != {want}")

    d = os.path.join(root, "serve")
    mgr = CheckpointManager(d, delta_keys=("decode",), device=dev)
    logical = {"decode": decode_state_logical(cfg)}
    tok = _greedy(logits)
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
    for key, a, b in (("pos", state2["pos"], live["pos"]),
                      ("k", state2["layers"]["k"], live["layers"]["k"]),
                      ("v", state2["layers"]["v"], live["layers"]["v"])):
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
    _check_decode_against_forward(params, cfg, rc, prompts, report)
    del params, prompts
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
        + (f", SWA {cfg.sliding_window}" if cfg.sliding_window else "")
        + f"; B={batch} prompts of {rc.shape.seq_len}, bf16 compute, f32 "
        f"params; {SERVE_STEPS} greedy tokens")
    log(f"{name}: init_s {r['init_s']:.4f}, prefill_s {r['prefill_s']:.4f}, "
        f"decode ms/token median {med:.3f} (all: "
        f"{[round(s * 1e3, 3) for s in steps]}) [{card}]")
    for w in r["writes"]:
        log(f"{name}: decode-state image token {w['step']}: {w['bytes']} "
            f"bytes, snapshot_s {w['snapshot_s']}, write_s {w['write_s']} "
            f"[{card}]")
    log(f"{name}: restore of token {SNAP_DELTA} (chain {SNAP_DELTA} -> "
        f"{SNAP_FULL}) {r['restore_s']:.4f} s; tokens {SNAP_DELTA + 1}-"
        f"{SERVE_STEPS - 1} and their logits equal the first run bit for "
        f"bit; {r['distinct_tokens']} distinct tokens generated; decode "
        f"after a prefill of {r['decode_vs_forward'][1]} vs forward (f32, "
        f"first 2 layers) norm-relative {r['decode_vs_forward'][0]:.3e} "
        f"[{card}]")
    log(f"{name}: max_memory_allocated {r['peak']} bytes "
        f"({r['peak'] / 2**30:.2f} GiB) [{card}]")


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


def main() -> int:
    import torch

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
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"deterministic algorithms on, allow_tf32 False for matmul and cuDNN")
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
    root = tempfile.mkdtemp(prefix="chip_smoke_")
    report: dict = {"serve_dense": {}, "serve_moe": {}, "world_pipeline": {},
                    "world_cross": {}, "world_elastic": {}}
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
        "world_pipeline": (lambda: phase_world_pipeline(
            root, report["world_pipeline"]), ("xor_delta",)),
        "world_cross": (lambda: phase_world_cross(
            root, report["world_cross"]), ("xor_delta",)),
        "world_elastic": (lambda: phase_world_elastic(
            root, report["world_elastic"]), ()),
    }
    by_phase, peaks, wall = {}, {}, {}
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
    shutil.rmtree(root, ignore_errors=True)
    report["serve_dense"]["peak"] = peaks["serve_dense"]
    report["serve_moe"]["peak"] = peaks["serve_moe"]

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
    report_serve("serve_dense", cfg, dense_rc, 8, report["serve_dense"], card)
    report_serve("serve_moe", moe_cfg, moe_rc, 4, report["serve_moe"], card)
    report_worlds(report, peaks, wall, card)
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
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
