"""Gloo CPU worlds for tests/test_torch_mesh.py: the port's mesh path in
real rank processes.

    python tests/_mesh_ranks.py SCENARIO N_RANKS DIR

starts N_RANKS spawned processes joined by a gloo process group (its
store on a port the OS picks), runs SCENARIO in each, and prints rank
0's result as the last line of standard output, one JSON object.  It
imports nothing of JAX: the test compares against the reference itself.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))

SHAPE = ("smoke", 64, 8, "train")


def reduced_qwen():
    """Reduced qwen2-0.5b with heads and vocabulary padded to 2, the
    reference's elastic-restart config."""
    from repro_torch.configs import ARCHS, reduced_config
    from repro_torch.configs.base import RunConfig, ShapeConfig

    cfg = reduced_config(ARCHS["qwen2-0.5b"], pad_to=2)
    rc = RunConfig(model=cfg, shape=ShapeConfig(*SHAPE), loss_chunk=32,
                   attn_chunk=16)
    return cfg, rc


def _mesh(shape):
    from repro_torch.launch.mesh import make_mesh

    return make_mesh(shape, ("data", "model"), device_type="cpu")


def _runtime(d, mesh, **kw):
    from repro_torch.core.runtime import MANARuntime

    cfg, rc = reduced_qwen()
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


def train_and_restore(rank: int, d: str, arg: str):
    """On the meshes of `arg` ("2x2,4x1"): first, if `d`/ref holds an
    image written without a mesh, restore it onto the first mesh and run
    2 steps (the gathered state's sha256 per leaf, and the losses).  Then
    compare step 0's float32 gradients on the first mesh with the
    mesh-free ones (`_f32_grads`), train 8 steps on the first mesh in
    `d`/mesh, an image every 4 steps with XOR-delta params, and on each mesh in turn restore step 4 and
    run 4 steps: the first restore is a same-mesh resume."""
    shapes = _shapes(arg)
    out = {}
    ref = os.path.join(d, "ref")
    if os.path.isdir(ref):
        rt = _runtime(ref, _mesh(shapes[0]))
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
    rt = _runtime(d, _mesh(shapes[0]), ckpt_every_steps=4,
                  delta_params=True)
    rt.initialize()
    out["f32_grads"] = _f32_grads(rt)
    out["train"] = _losses(rt.run(8))
    out["images"] = rt.ckpt.steps()
    rt.close()
    for shape in shapes:
        rt = _runtime(d, _mesh(shape), delta_params=True)
        start = rt.restore(4)
        out["x".join(map(str, shape))] = {"start": start,
                                          "losses": _losses(rt.run(4))}
        rt.close()
    return out


def _f32_grads(rt):
    """The gradients of step 0's loss in float32 compute on the
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

    cfg, rc = reduced_qwen()
    rc = dataclasses.replace(rc, dtype="float32")
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
    rel = [float((a.full_tensor() - b).norm() / b.norm())
           for a, b in zip(on_mesh, plain)]
    return {"max_rel": max(rel),
            "norm": [mesh_norm,
                     float(adamw.global_norm(tree_unflatten(full, plain)))]}


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


SCENARIOS = {"train_and_restore": train_and_restore,
             "embed_on_mesh": embed_on_mesh}


def _rank(rank: int, world: int, port: int, scenario: str, d: str,
          arg: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    store = dist.TCPStore("localhost", port, world, is_master=False)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        out = SCENARIOS[scenario](rank, d, arg)
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
    store = dist.TCPStore("localhost", 0, world + 1, is_master=True,
                          wait_for_workers=False)
    mp.spawn(_rank, args=(world, store.port, scenario, d, arg),
             nprocs=world)
    with open(os.path.join(d, f"{scenario}.json")) as f:
        print(f.read().strip())
    return 0


if __name__ == "__main__":
    sys.path.insert(0, SRC)
    sys.exit(main(sys.argv[1:]))
