"""Gloo CPU worlds for tests/test_torch_mesh*.py: the port's mesh path
in real rank processes.

    python tests/_mesh_ranks.py SCENARIO N_RANKS DIR [MESHES [ARCH]]

starts N_RANKS spawned processes joined by a gloo process group (its
store on a port the OS picks), runs SCENARIO in each on the meshes
MESHES ("2x2,4x1") for the reduced ARCH (`reduced`; default
qwen2-0.5b), and prints rank 0's result as the last line of standard
output, one JSON object.  It imports nothing of JAX: the tests compare
against the reference themselves.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))

SHAPE = ("smoke", 64, 8, "train")
# reduced MoE runs whole 512-token dispatch groups on each data rank
MOE_SHAPE = ("smoke", 512, 4, "train")


def shape_of(arch: str):
    """The (name, S, B, kind) train shape of a reduced `arch`."""
    return MOE_SHAPE if arch.startswith("mixtral") else SHAPE


def reduced(arch: str = "qwen2-0.5b"):
    """(cfg, rc) of reduced `arch` with heads and vocabulary padded to 2,
    the reference's elastic-restart config.  `arch` may end in ":ep" or
    ":tp", the MoE sharding mode (default "ep")."""
    from repro_torch.configs import ARCHS, reduced_config
    from repro_torch.configs.base import RunConfig, ShapeConfig

    name, _, mode = arch.partition(":")
    cfg = reduced_config(ARCHS[name], pad_to=2)
    rc = RunConfig(model=cfg, shape=ShapeConfig(*shape_of(name)),
                   loss_chunk=32, attn_chunk=16, moe_mode=mode or "ep")
    return cfg, rc


def reduced_qwen():
    return reduced("qwen2-0.5b")


def world(scenario: str, n: int, d, meshes: str, timeout: int,
          archs: str = ""):
    """Rank 0's result of `scenario` in a world of `n` gloo ranks, run
    by this file in a subprocess with its own time limit."""
    import subprocess

    argv = [sys.executable, os.path.abspath(__file__), scenario, str(n),
            str(d), meshes] + ([archs] if archs else [])
    res = subprocess.run(argv, env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=timeout)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def _mesh(shape):
    from repro_torch.launch.mesh import make_mesh

    return make_mesh(shape, ("data", "model"), device_type="cpu")


def _runtime(d, mesh, arch="qwen2-0.5b", **kw):
    from repro_torch.core.runtime import MANARuntime

    cfg, rc = reduced(arch)
    return MANARuntime(cfg, rc, ckpt_dir=d, mesh=mesh, device="cpu", **kw)


def _losses(hist):
    return [h["loss"] for h in hist]


def _full_state(state):
    """{path: numpy array} of a state whose leaves may be DTensors."""
    from repro_torch.core.checkpoint import _flatten

    out = {}
    for p, x in _flatten(state).items():
        if hasattr(x, "full_tensor"):
            x = x.full_tensor()
        out[p] = x.detach().numpy()
    return out


def _shapes(arg: str):
    """"2x2,4x1" -> [(2, 2), (4, 1)]."""
    return [tuple(int(n) for n in a.split("x")) for a in arg.split(",")]


# (steps, image cadence) of the training run: qwen2-0.5b runs 8 steps
# with images at 4 and 8; the other families 6 with images at 2, 4, 6
PLAN = {"qwen2-0.5b": (8, 4)}

# archs whose gradient check also runs in float64 compute: the reduced
# encoder-decoder and vision models amplify one rounding of a block's
# output far more than the other families (tests/test_torch_mesh_xattn.py)
F64_GRADS = ("whisper-large-v3", "llama-3.2-vision-11b")


def train_and_restore(rank: int, d: str, arg: str, arch="qwen2-0.5b"):
    """On the meshes of `arg` ("2x2,4x1"): first, if `d`/ref holds an
    image written without a mesh, restore it onto the first mesh and run
    2 steps (the gathered state's sha256 per leaf, and the losses).  Then
    compare step 0's float32 gradients on the first mesh with the
    mesh-free ones (`_grads`; for `F64_GRADS` in float64 too), train on
    the first mesh in `d`/mesh (`PLAN`: 8 steps with an image every 4,
    or 6 with an image every 2; XOR-delta params), and on each mesh in
    turn restore step 4 and run to the end: the first restore is a
    same-mesh resume.  Losses are
    lists; "*_aux" the MoE load-balance losses beside them; "step_s" the
    host seconds of each training step (the first pays DTensor's
    sharding propagation)."""
    shapes = _shapes(arg)
    steps, every = PLAN.get(arch, (6, 2))
    out = {}
    ref = os.path.join(d, "ref")
    if os.path.isdir(ref):
        rt = _runtime(ref, _mesh(shapes[0]), arch)
        start = rt.restore()
        out["from_reference"] = {
            "start": start,
            "leaves": {p: _digest(a)
                       for p, a in _full_state(rt.state).items()},
            "placements": sorted({" ".join(map(str, x.placements))
                                  for x in _dtensor_leaves(rt.state)}),
            "losses": _losses(rt.run(2))}
        rt.close()
    d = os.path.join(d, "mesh")
    rt = _runtime(d, _mesh(shapes[0]), arch, ckpt_every_steps=every,
                  delta_params=True)
    rt.initialize()
    out["f32_grads"] = _grads(rt, arch)
    if arch in F64_GRADS:
        out["f64_grads"] = _grads(rt, arch, "float64")
    stamps = [time.monotonic()]
    hist = rt.run(steps, on_metrics=lambda *_: stamps.append(time.monotonic()))
    out["step_s"] = [b - a for a, b in zip(stamps, stamps[1:])]
    out["train"], out["train_aux"] = _losses(hist), _aux(hist)
    out["images"] = rt.ckpt.steps()
    out["state_placements"] = _placements(rt.state)
    rt.close()
    for shape in shapes:
        rt = _runtime(d, _mesh(shape), arch, delta_params=True)
        start = rt.restore(4)
        hist = rt.run(steps - 4)
        out["x".join(map(str, shape))] = {"start": start,
                                          "losses": _losses(hist),
                                          "aux": _aux(hist)}
        rt.close()
    return out


def _placements(state):
    """{leaf path: its DTensor placements as strings}; a leaf that is
    not a DTensor maps to None."""
    from repro_torch.core.checkpoint import _flatten

    return {p: ([str(q) for q in x.placements]
                if hasattr(x, "placements") else None)
            for p, x in _flatten(state).items()}


def _aux(hist):
    return [h["moe_aux"] for h in hist]


def _grads(rt, arch="qwen2-0.5b", dtype="float32"):
    """The gradients of step 0's loss in `dtype` compute on the
    runtime's mesh against those of the same params without a mesh:
    {"max_rel": the largest relative difference (norm) over the leaves,
    "norm": [global norm on the mesh, without]} (`adamw.global_norm`,
    over sharded gradients on the mesh)."""
    import dataclasses

    import torch
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

    cfg, rc = reduced(arch)
    rc = dataclasses.replace(rc, dtype=dtype)
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticDataset(cfg, rc.shape).get_batch(0).items()}

    def grads(params, batch, rules):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        loss, _ = T.forward_loss(tree_unflatten(params, leaves), cfg, rc,
                                 rules, batch)
        return list(torch.autograd.grad(loss, leaves))

    with implicit_replication():
        on_mesh = grads(rt.state["params"], rt._split_batch(batch),
                        rt.lower.rules)
        mesh_norm = float(adamw.global_norm(
            tree_unflatten(rt.state["params"], on_mesh)).full_tensor())
    full = tree_map(lambda x: x.full_tensor(), rt.state["params"])
    plain = grads(full, batch, None)
    # a leaf that no token reaches (an expert given no tokens) has zero
    # gradients on both sides
    rel = [float((a.full_tensor() - b).norm() / b.norm().clamp_min(1e-30))
           for a, b in zip(on_mesh, plain)]
    return {"max_rel": max(rel), "rel": dict(zip(_paths(full), rel)),
            "norm": [mesh_norm,
                     float(adamw.global_norm(tree_unflatten(full, plain)))]}


def _paths(tree):
    from repro_torch.core.checkpoint import _flatten

    return list(_flatten(tree))


def _dtensor_leaves(state):
    from repro_torch.core.checkpoint import _flatten

    return [x for x in _flatten(state).values() if hasattr(x, "placements")]


def _digest(a: np.ndarray) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def embed_on_mesh(rank: int, d: str, arg: str):
    """The embedding gather of a vocab-sharded table and its backward on
    each mesh of `arg`, against the mesh-free `embed_apply` on the same
    inputs: forward rows and table gradient equal bit for bit."""
    return {"x".join(map(str, shape)): _embed_on(_mesh(shape))
            for shape in _shapes(arg)}


def _embed_on(mesh):
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models import layers as L

    gen = torch.Generator().manual_seed(0)
    V, dm, B, S = 16, 8, 4, 32
    table = torch.randn(V, dm, generator=gen)
    # few ids, many repeats: the fixed-order sum has long runs
    tokens = torch.randint(0, V, (B, S), generator=gen, dtype=torch.int32)
    grad = torch.randn(B, S, dm, generator=gen).to(torch.bfloat16)

    want_t = table.clone().requires_grad_(True)
    want = L.embed_apply({"embedding": want_t}, tokens, torch.bfloat16)
    (want_g,) = torch.autograd.grad(want, want_t, grad)

    tab = distribute_tensor(table, mesh, [Replicate(), Shard(0)]
                            ).requires_grad_(True)
    tok = distribute_tensor(tokens, mesh, [Shard(0), Replicate()])
    out = L.embed_apply({"embedding": tab}, tok, torch.bfloat16)
    placed = out.redistribute(mesh, [Shard(0), Replicate()])
    g = distribute_tensor(grad, mesh, [Shard(0), Replicate()])
    (got_g,) = torch.autograd.grad(placed, tab, g)
    return {"forward_equal": bool(torch.equal(placed.full_tensor(), want)),
            "grad_equal": bool(torch.equal(got_g.full_tensor(), want_g)),
            "grad_placements": [str(p) for p in got_g.placements],
            "out_placements": [str(p) for p in out.placements]}


def moe_parts(rank: int, d: str, arg: str, arch: str):
    """MoE on the first mesh of `arg`, in `arch`'s mode: one forward of
    the model's loss under CommDebugMode,
    with the input shape, dtype and mesh dim of every all-gather it
    makes (`gathers`) beside each expert weight's local shard shape;
    the sliding-window attention of the reduced config on the mesh
    against the mesh-free one (bit-equal, and unlike full causal
    attention: the window is kept); and, on a (4 x 1) mesh, the MoE
    layer at B 4 x S 256, whose 512-token groups straddle data ranks,
    against its mesh-free forward."""
    import torch
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.core.checkpoint import _flatten
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.models import transformer as T

    cfg, rc = reduced(arch)
    mesh = _mesh(_shapes(arg)[0])
    rt = _runtime(os.path.join(d, "parts"), mesh, arch)
    rt.initialize()
    flat = _flatten(rt.state)
    out = {}
    # each expert weight's local shard, one layer's
    out["shards"] = sorted({tuple(flat[f"params/blocks/moe/{w}"]
                                  .to_local().shape[1:])
                            for w in ("wi", "wg", "wo")})
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticDataset(cfg, rc.shape).get_batch(0).items()}
    comm = gathers(mesh)
    with torch.no_grad(), implicit_replication(), comm:
        T.forward_loss(rt.state["params"], cfg, rc, rt.lower.rules,
                       rt._split_batch(batch))
    out["gathers"] = comm.gathers
    out["comm_counts"] = {str(k): v for k, v in
                          comm.get_comm_counts().items()}
    rt.close()
    out["swa"] = _swa_on(mesh, cfg.sliding_window)
    out["straddle"] = _moe_straddle(_mesh((4, 1)), cfg, rc)
    return out


def gathers(mesh):
    """A CommDebugMode that also keeps, for each all-gather, its local
    input's shape and dtype and the dim of `mesh` whose ranks it gathers
    over (by the group's ranks: DTensor may run an op on an equal mesh
    made earlier, whose groups have other names)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode

    class Gathers(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.dims = {tuple(dist.get_process_group_ranks(
                mesh.get_group(n))): n for n in mesh.mesh_dim_names}
            self.gathers = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if ("all_gather" in str(func) and args
                    and not isinstance(args[0], DTensor)):
                over = [self.dims.get(tuple(dist.get_process_group_ranks(
                    _resolve_process_group(a)))) for a in args
                    if isinstance(a, str)]
                self.gathers.append({"shape": list(args[0].shape),
                                     "dtype": str(args[0].dtype),
                                     "over": over})
            return super().__torch_dispatch__(func, types, args, kwargs)

    return Gathers()


def _swa_on(mesh, window: int):
    import torch
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.models import attention as A

    gen = torch.Generator().manual_seed(1)
    B, S, H, K, hd = 4, 4 * window, 4, 2, 16
    q, k, v = (torch.randn(B, S, h, hd, generator=gen).to(torch.bfloat16)
               for h in (H, K, K))
    want = A.sliding_window_attention(q, k, v, window=window, chunk=16)
    full = A.flash_attention(q, k, v, causal=True, chunk=16)
    pl = [Shard(0), Shard(2)]
    got = A.sliding_window_attention(
        *(distribute_tensor(x, mesh, pl) for x in (q, k, v)),
        window=window, chunk=16)
    return {"equal": bool(torch.equal(got.full_tensor(), want)),
            "differs_from_causal": not bool(torch.equal(want, full))}


def _moe_straddle(mesh, cfg, rc):
    import torch
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    from repro_torch.sharding.rules import ShardingRules, placements

    rules = ShardingRules(mesh, moe_mode=rc.moe_mode)
    gen = torch.Generator().manual_seed(2)
    p, lg = M.init_moe(gen, cfg.d_model, cfg.d_ff, cfg.moe.num_experts,
                       T.moe_split(cfg), device="cpu")
    x = torch.randn(4, 256, cfg.d_model, generator=gen).to(torch.bfloat16)
    kw = dict(num_experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
              split=T.moe_split(cfg),
              capacity_factor=cfg.moe.capacity_factor)
    want, aux = M.moe_apply(p, x, **kw)
    on = {k: distribute_tensor(t, mesh, placements(rules.spec(lg[k],
                                                              t.shape),
                                                   mesh))
          for k, t in p.items()}
    xd = distribute_tensor(x, mesh, placements(
        rules.spec(("batch", None, None), x.shape), mesh))
    with torch.no_grad(), implicit_replication():
        got, got_aux = M.moe_apply(on, xd, rules=rules, **kw)
    return {"equal": bool(torch.equal(got.full_tensor(), want)),
            "aux_equal": bool(torch.equal(got_aux["moe_aux"].full_tensor(),
                                          aux["moe_aux"]))}


def la_parts(rank: int, d: str, arg: str, arch: str):
    """The chunked linear-attention engine in `arch`'s mode ("rwkv" for
    rwkv6-3b, else "mamba") on the first mesh of `arg`, batch over
    "data" and heads over "model", against the mesh-free engine on the
    same inputs: output and final state bit-equal; the float32 gradients
    of q, k, v, the log decay and (rwkv) the bonus `u`, largest relative
    difference (norm)."""
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models.linear_attention import chunked_linear_attention

    mode = "rwkv" if arch.startswith("rwkv") else "mamba"
    mesh = _mesh(_shapes(arg)[0])
    gen = torch.Generator().manual_seed(3)
    B, S, H, dk = 4, 64, 4, 16
    q, k, v = (torch.randn(B, S, H, dk, generator=gen) for _ in range(3))
    lw = -torch.rand(B, S, H, dk, generator=gen)
    u = torch.randn(H, dk, generator=gen) if mode == "rwkv" else None
    plain = [t.clone().requires_grad_(True) for t in (q, k, v, lw)]
    pu = u.clone().requires_grad_(True) if u is not None else None
    want, want_state = chunked_linear_attention(*plain, mode=mode, u=pu,
                                                chunk=16)
    pl = [Shard(0), Shard(2)]
    on = [distribute_tensor(t, mesh, pl).requires_grad_(True)
          for t in (q, k, v, lw)]
    du = (distribute_tensor(u, mesh, [Replicate(), Shard(0)])
          .requires_grad_(True) if u is not None else None)
    got, got_state = chunked_linear_attention(*on, mode=mode, u=du,
                                              chunk=16)
    g = torch.randn(B, S, H, dk, generator=gen)
    want_g = torch.autograd.grad(want, plain + ([pu] if pu is not None
                                                else []), g)
    got_g = torch.autograd.grad(got, on + ([du] if du is not None else []),
                                distribute_tensor(g, mesh, pl))
    rel = [float((a.full_tensor() - b).norm() / b.norm())
           for a, b in zip(got_g, want_g)]
    return {"out_equal": bool(torch.equal(got.full_tensor(), want)),
            "state_equal": bool(torch.equal(got_state.full_tensor(),
                                            want_state)),
            "placements": [str(p) for p in got.placements],
            "state_placements": [str(p) for p in got_state.placements],
            "grad_rel": rel}


SCENARIOS = {"train_and_restore": train_and_restore,
             "embed_on_mesh": embed_on_mesh,
             "moe_parts": moe_parts,
             "la_parts": la_parts}


def _run(rank: int, d: str, scenarios: str, arg: str, archs: str):
    """`scenarios` ("a" or "a,b") each on `arg`'s meshes; with `archs`
    ("mixtral-8x7b:ep,...") each runs for each arch in `d`/<arch, ":"
    as "-"> and the result is {"scenario@arch": result}."""
    if not archs:
        return SCENARIOS[scenarios](rank, d, arg)
    out = {}
    for arch in archs.split(","):
        sub = os.path.join(d, arch.replace(":", "-"))
        os.makedirs(sub, exist_ok=True)
        for name in scenarios.split(","):
            out[f"{name}@{arch}"] = SCENARIOS[name](rank, sub, arg, arch)
    return out


def _rank(rank: int, world: int, port: int, scenario: str, d: str,
          arg: str, archs: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    store = dist.TCPStore("localhost", port, world, is_master=False)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        out = _run(rank, d, scenario, arg, archs)
        if rank == 0:
            with open(os.path.join(d, f"{scenario}.json"), "w") as f:
                json.dump(out, f)
    finally:
        dist.destroy_process_group()


def main(argv) -> int:
    import torch.distributed as dist
    import torch.multiprocessing as mp

    scenario, world, d = argv[0], int(argv[1]), argv[2]
    arg = argv[3] if len(argv) > 3 else ""
    archs = argv[4] if len(argv) > 4 else ""
    store = dist.TCPStore("localhost", 0, world + 1, is_master=True,
                          wait_for_workers=False)
    mp.spawn(_rank, args=(world, store.port, scenario, d, arg, archs),
             nprocs=world)
    with open(os.path.join(d, f"{scenario}.json")) as f:
        print(f.read().strip())
    return 0


if __name__ == "__main__":
    sys.path.insert(0, SRC)
    sys.exit(main(sys.argv[1:]))
