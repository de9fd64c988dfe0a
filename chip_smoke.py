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
     bound bytes / 3.35 TB/s;
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
     main path.  The counts are set to 0 just before phase 2 and again
     just before phase 3 and read just after each; each phase must
     launch the kernels of its path (2: checksum, XOR; 3: checksum,
     quantize, dequantize), and `launches` is their sum.

The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

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
    rows.append(dict(
        name="xor_delta", route="cuda",
        source="src/repro_torch/kernels/delta/csrc/delta.cu",
        replaces="src/repro/kernels/delta/delta.py:21",
        max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms(nb),
        bound_by="bytes", library_ms=l_ms,
        shape="(151936, 896) f32 pair (embedding leaf)"))
    log(f"kernel xor_delta: bit-exact on (151936, 896) f32, ragged and "
        f"unaligned bytes + numpy twin; kernel_ms={k_ms:.4f} "
        f"plain_ms={p_ms:.4f} library_ms={l_ms:.4f} "
        f"bound_ms={bound_ms(nb):.4f} [{card}]")
    del a, b, ra, rb, o, ragged, pairs

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

    # phases 2-3: the main path, each phase counted from zero
    cfg = ARCHS["qwen2-0.5b"]
    rc = RunConfig(model=cfg, shape=ShapeConfig("smoke_h100", 1024, 8, "train"))
    root = tempfile.mkdtemp(prefix="chip_smoke_")
    report: dict = {}
    counters = {"checksum": (cops, "launches"), "xor_delta": (dops, "launches"),
                "quantize_int8": (qops, "launches"),
                "dequantize_int8": (qops, "dequantize_launches")}
    paths = {"resume": (phase_resume, ("checksum", "xor_delta")),
             "int8": (phase_int8, ("checksum", "quantize_int8",
                                   "dequantize_int8"))}
    by_phase = {}
    torch.cuda.reset_peak_memory_stats()
    for phase, (drive, _) in paths.items():
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        drive(cfg, rc, root, report)
        by_phase[phase] = {n: getattr(mod, attr)
                           for n, (mod, attr) in counters.items()}
    shutil.rmtree(root, ignore_errors=True)

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
    log(f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes "
        f"({torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)")
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
