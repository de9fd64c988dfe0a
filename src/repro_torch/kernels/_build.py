"""Build and load the hand-written Hopper kernels.

Each `csrc/*.cu` source under a kernel package is compiled by `nvcc`
into its own shared library with a plain C interface and loaded with
`ctypes` (no PyTorch headers, so a build takes seconds).  All sources
build in parallel, one `nvcc` each, at first use; the libraries go to
`build/kernels/` at the root of the checkout (listed in `.gitignore`),
named by a hash of source and flags so an edited source rebuilds.

Every C entry point takes its pointers and the CUDA stream as
`void*`, launches on that stream, does not synchronise, and returns
`cudaGetLastError()`; `check` raises on a nonzero code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCES = {
    "attention": os.path.join(_PKG, "attention", "csrc", "attention.cu"),
    "checksum": os.path.join(_PKG, "checksum", "csrc", "checksum.cu"),
    "delta": os.path.join(_PKG, "delta", "csrc", "delta.cu"),
    "quantize": os.path.join(_PKG, "quantize", "csrc", "quantize.cu"),
}
BUILD_DIR = os.path.normpath(os.path.join(_PKG, "..", "..", "..", "build",
                                          "kernels"))
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# C signatures: name -> (argtypes); every entry returns int: the launches
# a cudaError_t, `xor_tile` the bytes of each input one CTA takes; the
# attention launches take their dims and strides as int64 arrays
_P, _I64 = ctypes.c_void_p, ctypes.c_longlong
_I64S = ctypes.POINTER(ctypes.c_longlong)
SIGNATURES = {
    "attention": {"attention_fwd_launch": [_P] * 5 + [_I64S, _I64S, _P],
                  "attention_bwd_launch": [_P] * 10 + [_I64S, _I64S, _P]},
    "checksum": {"checksum_launch": [_P, _I64, _P, _P, _P]},
    "delta": {"xor_launch": [_P, _P, _P, _I64, _P], "xor_tile": []},
    "quantize": {"quantize_launch": [_P, _I64, _P, _P, _P],
                 "dequantize_launch": [_P, _P, _I64, _P, _P]},
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}   # ptxas register / spill report per kernel


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _target(name: str) -> str:
    with open(SOURCES[name], "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:12]}.so")


def build_all() -> float:
    """Compile every kernel library that is not built yet (one `nvcc`
    per source, all started together) and load them.  Returns the
    wall seconds spent."""
    t0 = time.monotonic()
    with _lock:
        todo = [n for n in SOURCES if n not in _libs]
        procs = {}
        os.makedirs(BUILD_DIR, exist_ok=True)
        for name in todo:
            out = _target(name)
            if os.path.exists(out):
                continue
            tmp = f"{out}.{os.getpid()}.tmp"
            procs[name] = (subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCES[name]],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp, out)
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            build_log[name] = log
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n{log}")
            os.replace(tmp, out)
        for name in todo:
            lib = ctypes.CDLL(_target(name))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
    return time.monotonic() - t0


def library(name: str) -> ctypes.CDLL:
    if name not in _libs:
        build_all()
    return _libs[name]


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {code}")


def stream_ptr(t) -> ctypes.c_void_p:
    """The current PyTorch CUDA stream of `t`'s device, as a `void*`."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
