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

import dataclasses
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


# the serving cell of a reduced arch: SERVE_BATCH prompts, SERVE_STEPS
# greedy tokens, decode-state images at tokens SNAP_FULL and SNAP_DELTA.
# A full-attention prompt of SERVE_S tokens leaves caches of SERVE_S +
# decode_margin (128) = 240 slots, so the decode's positions 112-127
# cross the time shards' boundary at 120 on a "model" axis of 2; an SWA
# prompt is two windows (the prefill takes the SWA path, the ring wraps)
SERVE_BATCH, SERVE_S, SERVE_STEPS, SNAP_FULL, SNAP_DELTA = 8, 112, 16, 6, 10
# (name, mesh shape, kv_time_shard, compute dtype) of the serving
# meshes, in the order they run: the first writes the decode-state
# images, RESTORE_ON restores one.  Float32 compute, but for a last run
# in bfloat16 on (4 x 1): where "model" splits heads, DTensor sums the
# partial products of each head-summing einsum in the compute dtype,
# and in bfloat16 those roundings move reduced qwen2-0.5b's prefill
# logits by 1.7% of their norm (float32: 1e-6), enough to change greedy
# tokens; the reference reduces in its compute dtype too, and holds
# meshes to each other only on losses
SERVE_MESHES = (("2x2_time", (2, 2), True, "float32"),
                ("2x2_heads", (2, 2), False, "float32"),
                ("4x1", (4, 1), True, "float32"),
                ("4x1_bf16", (4, 1), True, "bfloat16"))
RESTORE_ON = "4x1"
# of a run's tokens and logits (the prefill's first): those a restored
# image at token SNAP_DELTA is fed, and those it must make
FED = slice(SNAP_DELTA + 1, SERVE_STEPS)
MADE = slice(SNAP_DELTA + 2, SERVE_STEPS + 1)


def serve_config(arch: str, dtype: str = "float32"):
    """(cfg, rc) of `arch`'s serving cell (`reduced`, `SERVE_BATCH`
    prompts, compute in `dtype`; `kv_time_shard` on, the reference's
    production choice for serving)."""
    from repro_torch.configs.base import ShapeConfig

    cfg, rc = reduced(arch)
    S = 2 * cfg.sliding_window if cfg.sliding_window else SERVE_S
    return cfg, dataclasses.replace(
        rc, shape=ShapeConfig("serve", S, SERVE_BATCH, "prefill"),
        kv_time_shard=True, dtype=dtype)


def serve_inputs(cfg, rc):
    """(params from torch seed 0, the prefill batch: tokens, and stub
    frames or patches, from numpy seed 7), both plain CPU tensors."""
    import torch

    from repro_torch.models import transformer as T

    gen = torch.Generator().manual_seed(0)
    params, _ = T.init_params(cfg, gen, "cpu")
    rng = np.random.RandomState(7)
    B, S = rc.shape.global_batch, rc.shape.seq_len
    batch = {"tokens": rng.randint(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}
    if cfg.enc_dec:
        batch["frames"] = rng.randn(B, cfg.enc_positions,
                                    cfg.d_model).astype(np.float32)
    if cfg.cross_attn_every:
        batch["patches"] = rng.randn(B, cfg.vision_tokens,
                                     cfg.d_model).astype(np.float32)
    return params, {k: torch.from_numpy(v) for k, v in batch.items()}


def _full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _greedy_tok(logits):
    """(B, 1) int32 argmax of gathered (B, V) logits."""
    import torch

    return torch.argmax(logits, dim=-1).to(torch.int32)[:, None]


class _Server:
    """`make_serve_steps` of a cell on `mesh` (None: without one), with
    the params, batch and tokens placed as the reference's `run_cell`
    places them."""

    def __init__(self, cfg, rc, params, mesh=None):
        from repro_torch.sharding.rules import ShardingRules
        from repro_torch.training.step import (decode_state_specs,
                                               make_serve_steps,
                                               train_state_specs)
        from repro_torch.tree import tree_map

        self.cfg, self.rc, self.mesh = cfg, rc, mesh
        self.rules = None if mesh is None else ShardingRules(
            mesh, moe_mode=rc.moe_mode, kv_time_shard=rc.kv_time_shard)
        self.prefill, self.serve = make_serve_steps(cfg, rc, self.rules)
        self.params, self.specs = params, None
        if mesh is not None:
            self.specs = decode_state_specs(cfg, rc, self.rules, rc.shape)
            self.params = tree_map(
                self._place, params,
                train_state_specs(cfg, rc, self.rules)["params"])

    def _place(self, x, spec):
        from repro_torch.sharding.rules import place

        return x if self.mesh is None else place(x, spec, self.mesh)

    def start(self, batch):
        """Prefill: (gathered (B, V) logits, decode state)."""
        from repro_torch.training.step import batch_specs

        if self.mesh is not None:
            specs = batch_specs(self.cfg, self.rc.shape, self.rules)
            batch = {k: self._place(v, specs[k]) for k, v in batch.items()}
        logits, state = self.prefill(self.params, batch)
        return _full(logits), state

    def step(self, state, tok):
        """One decode step of the (B, 1) plain token: (gathered (B, V)
        logits, new state)."""
        if self.mesh is not None:
            tok = self._place(tok, self.rules.spec(("batch", None),
                                                   tuple(tok.shape)))
        logits, state = self.serve(self.params, state, tok)
        return _full(logits)[:, -1], state

    def misplaced(self, state):
        """The decode-state leaves that are not DTensors placed by
        `decode_state_specs`, as "path: got != want"."""
        from repro_torch.core.checkpoint import _flatten
        from repro_torch.sharding.rules import placements

        specs = _flatten(self.specs)
        bad = []
        for p, x in _flatten(state).items():
            want = [str(q) for q in placements(specs[p], self.mesh,
                                               x.shape)]
            got = ([str(q) for q in x.placements]
                   if hasattr(x, "placements") else None)
            if got != want:
                bad.append(f"{p}: {got} != {want}")
        return bad


def _rel(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _vs(logits, want):
    """Each step's norm-relative difference of gathered logits from
    `want`'s, and whether all are bit-equal."""
    import torch

    return {"rel": [_rel(a, b) for a, b in zip(logits, want)],
            "equal": all(torch.equal(a, b) for a, b in zip(logits, want))}


def _state_digests(state):
    """{leaf path: sha256 of its gathered bytes} of a decode state."""
    import hashlib

    import torch

    from repro_torch.core.checkpoint import _flatten

    return {p: hashlib.sha256(_full(x).reshape(-1).view(torch.uint8)
                              .numpy().tobytes()).hexdigest()
            for p, x in _flatten(state).items()}


def _continue(server, state, toks):
    """Decode `toks` (a list of (B, 1) tokens, teacher forced) from
    `state`: the gathered logits of each step."""
    out = []
    for tok in toks:
        logits, state = server.step(state, tok)
        out.append(logits)
    return out


def serve_on_mesh(rank: int, d: str, arg: str, arch: str):
    """`arch`'s serving cell (`serve_config`) without a mesh, then on
    each of `SERVE_MESHES` (params, batch and tokens placed as the
    reference's `run_cell` places them): prefill and `SERVE_STEPS`
    greedy tokens, with each mesh's tokens, its gathered logits against
    the mesh-free run's in its dtype (norm-relative, each step), and the
    decode-state leaves not placed by `decode_state_specs` after the
    prefill or any step.  The first mesh writes an image of {"decode":
    state} at token `SNAP_FULL` (full) and `SNAP_DELTA` (XOR delta) in
    `d`/img: restored onto that mesh it decodes tokens 11-15 again,
    restored without a mesh it is held to the gathered live state, and
    restored onto `RESTORE_ON` it decodes them there.  If `d`/ref holds
    the reference's image of its mesh-free decode state at token
    `SNAP_DELTA`, and `d`/ref_tokens.npy the tokens it fed next, that
    image is restored onto the first mesh (digests verified) and fed
    them; rank 0 saves the gathered logits to `d`/from_reference.npy."""
    import torch

    from repro_torch.core.checkpoint import CheckpointManager
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map

    logical = {"decode": T.decode_state_logical(reduced(arch)[0])}
    img = os.path.join(d, "img")
    inputs = {dt: serve_inputs(*serve_config(arch, dt))
              for dt in ("float32", "bfloat16")}

    def run(server, check=lambda st: None, on_token=lambda i, st: None):
        logits, state = server.start(inputs[server.rc.dtype][1])
        outs, toks = [logits], [_greedy_tok(logits)]
        check(state)
        for i in range(SERVE_STEPS):
            logits, state = server.step(state, toks[-1])
            outs.append(logits)
            toks.append(_greedy_tok(logits))
            check(state)
            on_token(i, state)
        return outs, toks

    def restore(server, directory):
        st, _ = CheckpointManager(directory, device="cpu").restore(
            SNAP_DELTA, mesh=server.mesh, specs={"decode": server.specs})
        return st["decode"]

    free = {}
    for dt, (params, _) in inputs.items():
        cfg, rc = serve_config(arch, dt)
        free[dt] = run(_Server(cfg, rc, params))
    out, first = {}, None
    mgr = CheckpointManager(img, delta_keys=("decode",), device="cpu")
    for name, shape, time_shard, dt in SERVE_MESHES:
        cfg, rc = serve_config(arch, dt)
        server = _Server(cfg, dataclasses.replace(
            rc, kv_time_shard=time_shard), inputs[dt][0], _mesh(shape))
        bad, live = [], {}

        def on_token(i, state):
            if first is None and i in (SNAP_FULL, SNAP_DELTA):
                mgr.save(i, {"decode": state}, logical)
                live[i] = tree_map(_full, state)

        outs, toks = run(server, lambda st: bad.extend(server.misplaced(st)),
                         on_token)
        res = out[name] = {
            "tokens_equal": all(torch.equal(a, b)
                                for a, b in zip(toks, free[dt][1])),
            "vs_free": _vs(outs, free[dt][0]), "misplaced": bad[:20],
            "n_misplaced": len(bad)}
        if first is None:
            first = (outs, toks)
            res["image_bytes"] = [w["bytes"] for w in mgr.stats]
            st = restore(server, img)
            res["restored_misplaced"] = server.misplaced(st)
            res["same_mesh"] = _vs(_continue(server, st, toks[FED]),
                                   outs[MADE])
            plain = CheckpointManager(img, device="cpu").restore(
                SNAP_DELTA)[0]["decode"]
            want = live[SNAP_DELTA]
            res["no_mesh_equal"] = {"pos": bool(torch.equal(
                plain["pos"], want["pos"]))} | {
                k: bool(torch.equal(plain["layers"][k], c))
                for k, c in want["layers"].items()}
            if os.path.isdir(os.path.join(d, "ref")):
                st = restore(server, os.path.join(d, "ref"))
                res["from_reference"] = {
                    "misplaced": server.misplaced(st),
                    "digests": _state_digests(st)}
                fed = [torch.from_numpy(t) for t in
                       np.load(os.path.join(d, "ref_tokens.npy"))]
                got = torch.stack(_continue(server, st, fed))
                if rank == 0:
                    np.save(os.path.join(d, "from_reference.npy"),
                            got.numpy())
        if name == RESTORE_ON:
            st = restore(server, img)
            got = _continue(server, st, first[1][FED])
            res["restored_misplaced"] = server.misplaced(st)
            res["from_first_image"] = _vs(got, first[0][MADE])
            res["from_first_image"]["tokens_equal"] = all(
                torch.equal(_greedy_tok(a), b)
                for a, b in zip(got, first[1][MADE]))
    return out


def slot_write(rank: int, d: str, arg: str):
    """`attention.write_slot_` into a layer of a (L, B, T, K, hd) cache
    placed as `kv_time_shard` places it on a (2 x 2) mesh (batch over
    "data", time over "model"), the new K/V placed as the projections
    leave them (batch over "data", heads over "model"), against the plain
    write on the same inputs: for every slot 0..T-1 of a full cache, and
    for an SWA ring of capacity T whose positions T..2T+2 wrap past T
    (slot pos mod T, crossing the shards' boundary)."""
    import torch
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.models import attention as A

    mesh = _mesh((2, 2))
    gen = torch.Generator().manual_seed(4)
    L, B, T, K, hd = 2, 4, 8, 2, 4
    base = torch.randn(L, B, T, K, hd, generator=gen).to(torch.bfloat16)
    out = {}
    for window, positions in ((0, range(T)), (T, range(T, 2 * T + 3))):
        equal = []
        for pos in positions:
            new = [torch.randn(B, 1, K, hd, generator=gen).to(torch.bfloat16)
                   for _ in range(2)]
            want = [base.clone(), base.clone()]
            A.write_slot_(want[0][1], want[1][1], *new, pos, window)
            got = [distribute_tensor(base, mesh, [Shard(1), Shard(2)])
                   for _ in range(2)]
            A.write_slot_(got[0][1], got[1][1], *(
                distribute_tensor(x, mesh, [Shard(0), Shard(2)])
                for x in new), pos, window)
            equal.append(all(torch.equal(g.full_tensor(), w)
                             for g, w in zip(got, want)))
        out["ring" if window else "full"] = equal
    return out


def remat_on_mesh(rank: int, d: str, arg: str):
    """Step 0's float32 loss and gradients of reduced qwen2-0.5b on the
    first mesh of `arg` under remat "full" and "comm", and without a
    mesh under "comm": {"loss_equal", "grads_equal": "comm" against
    "full" on the mesh, bit for bit; "max_rel": the largest relative
    difference (norm) of a mesh gradient under "comm" from the mesh-free
    one}."""
    import torch
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

    cfg, rc = reduced()
    rt = _runtime(os.path.join(d, "remat"), _mesh(_shapes(arg)[0]))
    rt.initialize()
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticDataset(cfg, rc.shape).get_batch(0).items()}

    def run(params, batch, rules, policy):
        run_rc = dataclasses.replace(rc, dtype="float32",
                                     remat_policy=policy)
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        with implicit_replication():
            loss, _ = T.forward_loss(tree_unflatten(params, leaves), cfg,
                                     run_rc, rules, batch)
            grads = torch.autograd.grad(loss, leaves)
        return loss.full_tensor(), [g.full_tensor() for g in grads]

    on_mesh = {p: run(rt.state["params"], rt._split_batch(batch),
                      rt.lower.rules, p) for p in ("full", "comm")}
    full = tree_map(lambda x: x.full_tensor(), rt.state["params"])
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(full)]
    loss, _ = T.forward_loss(tree_unflatten(full, leaves), cfg,
                             dataclasses.replace(rc, dtype="float32",
                                                 remat_policy="comm"),
                             None, batch)
    plain = torch.autograd.grad(loss, leaves)
    rt.close()
    (l_full, g_full), (l_comm, g_comm) = on_mesh["full"], on_mesh["comm"]
    return {"loss_equal": bool(torch.equal(l_full, l_comm)),
            "grads_equal": all(torch.equal(a, b)
                               for a, b in zip(g_full, g_comm)),
            "max_rel": max(float((a - b).norm() / b.norm().clamp_min(1e-30))
                           for a, b in zip(g_comm, plain))}


SCENARIOS = {"train_and_restore": train_and_restore,
             "embed_on_mesh": embed_on_mesh,
             "moe_parts": moe_parts,
             "la_parts": la_parts,
             "serve_on_mesh": serve_on_mesh,
             "slot_write": slot_write,
             "remat_on_mesh": remat_on_mesh}
# scenarios that take no arch: run once, before the arch loop
ARCH_FREE = ("slot_write",)


def _run(rank: int, d: str, scenarios: str, arg: str, archs: str):
    """`scenarios` ("a" or "a,b") each on `arg`'s meshes; with `archs`
    ("mixtral-8x7b:ep,...") each runs for each arch in `d`/<arch, ":"
    as "-"> and the result is {"scenario@arch": result}, but one of
    `ARCH_FREE` runs once first, in `d`, as {"scenario": result}."""
    if not archs:
        return SCENARIOS[scenarios](rank, d, arg)
    names = scenarios.split(",")
    out = {name: SCENARIOS[name](rank, d, arg) for name in names
           if name in ARCH_FREE}
    for arch in archs.split(","):
        sub = os.path.join(d, arch.replace(":", "-"))
        os.makedirs(sub, exist_ok=True)
        for name in names:
            if name not in ARCH_FREE:
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
