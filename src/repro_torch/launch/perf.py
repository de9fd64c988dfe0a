"""Perf iteration: run one dry-run cell under RunConfig
overrides, print the roofline terms, append the cell to a JSON log.
Port of `repro.launch.perf`.

  PYTHONPATH=src python -m repro_torch.launch.perf --arch hymba-1.5b \\
      --shape train_4k --label h3_remat_dots --rc '{"remat_policy":"dots"}'

The reference takes its roofline from the JAX package's benchmarks,
whose rates are a TPU's.  `analyze_cell` here gives the same keys
against one H100 SXM's published peaks (NVIDIA's data sheet: dense
bf16 tensor-core rate, HBM3 bandwidth and capacity, NVLink bandwidth
each way).  The terms are a model from the dry-run's per-device
counts, not a measurement.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional

# NVIDIA H100 80GB HBM3, 700.00 W (`nvidia-smi`'s name and power limit
# of the card these peaks are for): H100 SXM data sheet figures
PEAK = 989e12            # FLOP/s, dense bf16 on the tensor cores
HBM_BW = 3.35e12         # B/s, HBM3
LINK_BW = 450e9          # B/s, NVLink 4, each way
HBM_CAP = 80e9           # bytes of device memory


def analyze_cell(cell: Dict) -> Optional[Dict]:
    """The three roofline terms of an "ok" dry-run cell, per device, with
    the model FLOPs (6 N D for training, 2 N D for serving; N the active
    params, D the tokens of the shape, per device)."""
    if cell.get("status") != "ok":
        return None
    from repro_torch.configs import SHAPES_BY_NAME

    chips = 512 if cell["mesh"] == "2x16x16" else 256
    hlo = cell["hlo"]
    compute_s = hlo["dot_flops"] / PEAK
    memory_s = hlo["fusion_io_bytes"] / HBM_BW
    collective_s = hlo["collective_bytes"] / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    shape = SHAPES_BY_NAME[cell["shape"]]
    mult = 6 if shape.kind == "train" else 2
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    model_flops = mult * cell["params_active"] * tokens / chips
    useful_s = model_flops / PEAK
    bound_s = max(terms.values())
    return {
        "arch": cell["arch"], "shape": cell["shape"], "mesh": cell["mesh"],
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": collective_s, "dominant": dominant,
        "model_flops": model_flops,
        "hlo_flops": hlo["dot_flops"],
        "flops_ratio": model_flops / max(hlo["dot_flops"], 1e-9),
        "roofline_fraction": useful_s / max(bound_s, 1e-12),
        "peak_bytes": cell["memory"]["peak_bytes"],
        "fits_hbm": (cell["memory"]["peak_bytes"] or 0) <= HBM_CAP,
        "collective_count": hlo.get("collective_count", 0),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--label", required=True)
    ap.add_argument("--rc", default="{}")
    ap.add_argument("--pod", action="store_true")
    ap.add_argument("--log", default="perf_log.json")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="device type of the fake mesh")
    args = ap.parse_args()

    from repro_torch.launch.dryrun import run_cell

    cell = run_cell(args.arch, args.shape, args.pod, json.loads(args.rc),
                    device_type=args.device)
    cell["label"] = args.label
    cell["rc_overrides"] = json.loads(args.rc)
    if cell["status"] == "ok":
        out = analyze_cell(cell)
        print(json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                          for k, v in out.items()}, indent=1))
    else:
        print(json.dumps({k: v for k, v in cell.items() if k != "trace"}))
    log = []
    if os.path.exists(args.log):
        with open(args.log) as f:
            log = json.load(f)
    log.append(cell)
    with open(args.log, "w") as f:
        json.dump(log, f, indent=1)


if __name__ == "__main__":
    main()
