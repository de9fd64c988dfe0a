"""Multi-pod dry-run: run one step of every (architecture x input shape)
on the production meshes without their devices, and extract the
roofline terms.  Port of `repro.launch.dryrun`.

This is the proof that the distribution config is coherent: a sharding
mismatch, an unsupported collective or an op with no sharding rule
fails the cell.

The reference lowers and compiles each cell for 256 or 512 forced host
devices.  Eager PyTorch has no compile step, so the port runs the step
itself, once, as rank 0 of a `fake` process group of 256 or 512 ranks
(no communication happens), on fake tensors (shapes and dtypes, no
storage; `FakeTensorMode`) placed on the mesh as DTensors by the same
spec trees as the reference's `in_shardings`, and counts what the rank
runs (`repro_torch.launch.hlo_analysis.OpCounter`): dot FLOPs, the
HBM-traffic proxy, collective bytes, the live-set peak.  Every count is
per device.  A decode cell's position is a real 0-d tensor at
`DECODE_POS`, the one `init_decode_state` holds, since decode reads it
to the host; decode attention's cost does not depend on it.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
      --shape train_4k --mesh single [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun.json

Output (per cell): the memory summary (local bytes of the arguments and
outputs, the live-set peak), the op counts (`hlo`, `cost`) and the
per-collective byte totals, under the reference's keys.  The meshes are
made on "cuda" (fake CUDA tensors) unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

from repro_torch.configs.base import ModelConfig, ShapeConfig

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")

# the decode cells' position: `init_decode_state`'s own
DECODE_POS = 0


def collective_bytes(hlo: Dict[str, Any]) -> Dict[str, int]:
    """The reference's per-collective dict ({kind: bytes}, "count",
    "total") from `OpCounter`'s counts: bytes of the local operands,
    so per-device wire bytes."""
    out = {op: int(hlo["collectives"].get(op, 0)) for op in COLLECTIVE_OPS}
    out["count"] = int(hlo["collective_count"])
    out["total"] = sum(out[op] for op in COLLECTIVE_OPS)
    return out


def input_specs(cfg, shape, rc, rules, mesh):
    """Meta-tensor stand-ins (shape and dtype, no storage) and their
    `NamedSharding`s for every model input."""
    import torch

    from repro_torch.data.pipeline import make_batch_specs
    from repro_torch.sharding.rules import NamedSharding
    from repro_torch.training.step import batch_specs

    specs = make_batch_specs(cfg, shape, getattr(torch, rc.dtype))
    sh = batch_specs(cfg, shape, rules)
    return specs, {k: NamedSharding(mesh, sh[k], tuple(specs[k].shape))
                   for k in specs}


def _serving_dtype(params_abs, rc):
    """Inference serves bf16 weights (production choice; the f32 masters
    live with the trainer).  Forward casts per-use, so only the argument
    dtype changes."""
    import torch

    from repro_torch.tree import tree_map

    dt = getattr(torch, rc.dtype)
    return tree_map(lambda s: s.to(dt) if s.is_floating_point() else s,
                    params_abs)


def production_rc(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Per-cell production defaults (the §Perf-validated choices):
    inference shapes shard the KV cache over time and serve bf16 weights;
    big trains shard f32 masters over data (FSDP/ZeRO-3)."""
    over: Dict[str, Any] = {}
    if shape.kind in ("decode", "prefill"):
        over["kv_time_shard"] = True
    if shape.kind == "train" and cfg.param_count() * 4 / 16 > 2e9:
        over["fsdp"] = True
    if (cfg.sliding_window and cfg.sliding_window < shape.seq_len
            and shape.kind == "train"):
        # SWA span traffic ∝ window+chunk (§Perf A4): small chunks win in
        # training (scores dominate, fwd+bwd); prefill is forward-only
        # and re-reads the KV span per q-block, so large chunks win there
        over["attn_chunk"] = 128
    return over


@contextlib.contextmanager
def fake_world(size: int):
    """This process as rank 0 of a `fake` default process group of
    `size` ranks (collectives do nothing), destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry-run makes its own default process group; "
                           "this process already has one")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local_bytes(tree) -> int:
    """Bytes of the distinct local storages under `tree` (a DTensor
    counts its shard)."""
    import torch
    from torch.utils._pytree import tree_leaves

    seen = {}
    for t in tree_leaves(tree):
        if not isinstance(t, torch.Tensor):
            continue
        t = t.to_local() if hasattr(t, "device_mesh") else t
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def dry_run(cfg, shape, rc, mesh=None, device: str = "cuda"
            ) -> Dict[str, Any]:
    """One step of (cfg, shape, rc) counted on fake tensors: on `mesh`
    (its leaves placed as the reference's `run_cell` places them) or,
    with no mesh, on one `device`.  Returns the cell's analysis keys."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.data.pipeline import make_batch_specs
    from repro_torch.launch.hlo_analysis import OpCounter
    from repro_torch.models.transformer import init_decode_state
    from repro_torch.sharding.rules import ShardingRules, place
    from repro_torch.training.step import (abstract_params,
                                           abstract_train_state,
                                           decode_state_specs,
                                           make_serve_steps, make_train_step,
                                           train_state_specs)
    from repro_torch.tree import tree_map

    t0 = time.monotonic()
    rules = None
    if mesh is not None:
        rules = ShardingRules(mesh, moe_mode=rc.moe_mode,
                              seq_shard=rc.seq_shard,
                              kv_time_shard=rc.kv_time_shard)
        device = mesh.device_type
    fake = FakeTensorMode(allow_non_fake_inputs=True)

    def make(meta, specs):
        with fake:
            tree = tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                                  device=device), meta)
        if rules is None:
            return tree
        return tree_map(lambda x, sp: place(x, sp, mesh), tree, specs)

    def specs(fn, *a):
        return fn(*a) if rules is not None else None

    if rules is None:
        batch = make(make_batch_specs(cfg, shape, getattr(torch, rc.dtype)),
                     None)
    else:
        metas, named = input_specs(cfg, shape, rc, rules, mesh)
        batch = make(metas, {k: n.spec for k, n in named.items()})
    if shape.kind == "train":
        args = (make(abstract_train_state(cfg, rc),
                     specs(train_state_specs, cfg, rc, rules)), batch)
        step = make_train_step(cfg, rc, rules)
    else:
        p_specs = specs(train_state_specs, cfg, rc, rules)
        params = make(_serving_dtype(abstract_params(cfg)[0], rc),
                      p_specs and p_specs["params"])
        prefill_step, serve_step = make_serve_steps(cfg, rc, rules)
        if shape.kind == "prefill":
            args, step = (params, batch), prefill_step
        else:
            d_specs = specs(decode_state_specs, cfg, rc, rules, shape)
            meta = init_decode_state(cfg, shape, rc, "meta")
            layers = make(meta["layers"], d_specs and d_specs["layers"])
            pos = torch.tensor(DECODE_POS, dtype=torch.int32, device=device)
            if rules is not None:
                pos = place(pos, d_specs["pos"], mesh)
            args = ({"pos": pos, "layers": layers}, batch["tokens"])
            args, step = (params,) + args, serve_step
    t_build = time.monotonic() - t0
    with OpCounter() as counter:
        out = step(*args)
    t_run = time.monotonic() - t0 - t_build
    hlo = counter.summary()
    arg_bytes = _local_bytes(args)
    return {
        "hlo": {k: v for k, v in hlo.items() if k != "transcendentals"},
        "status": "ok",
        "lower_s": round(t_build, 2),
        "compile_s": round(t_run, 2),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": _local_bytes(out),
            "temp_bytes": counter.peak,
            # the arguments stay alive through the step (no donation),
            # and everything it makes is counted from its creation to
            # its release
            "peak_bytes": arg_bytes + counter.peak,
        },
        "cost": {"flops": hlo["dot_flops"],
                 "bytes_accessed": hlo["fusion_io_bytes"],
                 "transcendentals": hlo["transcendentals"]},
        "collectives": collective_bytes(hlo),
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             rc_overrides: Optional[Dict] = None, *,
             device_type: str = "cuda") -> Dict[str, Any]:
    """Run and count one (arch x shape x mesh) cell; return analysis."""
    from repro_torch.configs import ARCHS, SHAPES_BY_NAME, shape_applicable
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch.mesh import make_production_mesh

    cfg = ARCHS[arch]
    shape = SHAPES_BY_NAME[shape_name]
    ok, why = shape_applicable(cfg, shape)
    cell = {"arch": arch, "shape": shape_name,
            "mesh": "2x16x16" if multi_pod else "16x16"}
    if not ok:
        cell.update(status="skip", reason=why)
        return cell
    over = production_rc(cfg, shape)
    over.update(rc_overrides or {})
    cell["rc"] = dict(over)
    rc = RunConfig(model=cfg, shape=shape, **over)
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod,
                                    device_type=device_type)
        cell.update(dry_run(cfg, shape, rc, mesh))
    cell.update(params=cfg.param_count(),
                params_active=cfg.param_count(active_only=True))
    return cell


def main() -> None:
    from repro_torch.configs import ARCHS, SHAPES_BY_NAME

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "pod", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--rc", default=None,
                    help="JSON RunConfig overrides (perf experiments)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="device type of the fake meshes")
    args = ap.parse_args()
    rc_over = json.loads(args.rc) if args.rc else None

    pods = [False, True] if args.mesh == "both" else [args.mesh == "pod"]
    if args.all:
        cells = [(arch, shape, mp) for arch in ARCHS
                 for shape in SHAPES_BY_NAME for mp in pods]
    else:
        cells = [(args.arch, args.shape, mp) for mp in pods]

    results = []
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
        done = {(r["arch"], r["shape"], r["mesh"]) for r in results}
        cells = [c for c in cells
                 if (c[0], c[1], "2x16x16" if c[2] else "16x16") not in done]

    for arch, shape, mp in cells:
        label = f"{arch} x {shape} x {'2x16x16' if mp else '16x16'}"
        print(f"=== {label}", flush=True)
        try:
            cell = run_cell(arch, shape, mp, rc_over,
                            device_type=args.device)
        except Exception as e:  # noqa: BLE001 — record, keep sweeping
            cell = {"arch": arch, "shape": shape,
                    "mesh": "2x16x16" if mp else "16x16",
                    "status": "error", "error": f"{type(e).__name__}: {e}",
                    "trace": traceback.format_exc()[-2000:]}
        print(json.dumps({k: v for k, v in cell.items() if k != "trace"}),
              flush=True)
        results.append(cell)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
    n_ok = sum(1 for r in results if r["status"] == "ok")
    n_skip = sum(1 for r in results if r["status"] == "skip")
    n_err = sum(1 for r in results if r["status"] == "error")
    print(f"DONE ok={n_ok} skip={n_skip} error={n_err}", flush=True)


if __name__ == "__main__":
    main()
