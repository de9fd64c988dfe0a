"""Plain PyTorch reference of the `layer_types` hybrids the benchmark's
configurations run (granite-4.0-h-micro), written from HF's
`GraniteMoeHybrid` and the Mamba-2 paper (arXiv:2405.21060): the
embedding times `embedding_multiplier`; the layers in `layer_types`
order, each a pre-norm mixer, Mamba-2 or GQA attention, and a pre-norm
SwiGLU MLP, each branch added times `residual_multiplier`; RMSNorm; the
tied head's logits divided by `logits_scaling`; next-token cross
entropy.

  attention  q, k, v projections with no bias and no positions
             (`position_embedding_type` "nope"), scores times
             `attention_multiplier`, causal softmax, output projection;
  Mamba-2    in_proj to [z, xBC, dt]; a causal depthwise conv with bias
             over xBC, SiLU; x, B, C; dt = softplus(dt + dt_bias),
             A = -exp(A_log); the SSD in the paper's minimal chunked form
             (`ssd_minimal_discrete`, §7, at chunk `mamba_chunk_size`)
             on (x dt, A dt, B, C), plus D x; the gated RMSNorm
             rmsnorm(y * silu(z)) * norm; out_proj.

Departures from HF: the weights come from the benchmark's seeded state
(`bench.hybrid_state`), in its layout (stacked blocks, query heads in a
(K, G) grid, padded where `pad_to` asks, masked); the gated norm's
weight multiplies the f32 value (HF casts to the input dtype first, the
same in f32); no routed experts (the micro model has none); dt is not
clamped (HF's default `time_step_limit` (0, inf) clamps nothing).

It computes in float32 with TF32 off, or as the control in fp8
(`precision="fp8"`, `bench.reference.model.Ops`: every matrix product's
operands in e4m3, its output's gradient in e5m2; the SSD and the conv
stay f32, as a float8 recipe keeps them).  Each layer, each block of
queries and each chunk of the loss runs under `torch.utils.checkpoint`,
so that a step at S 32768 fits on the card after the program's state is
freed.  It imports nothing of the program.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.hybrid_state import dims
from bench.reference.model import Ops, adamw_step, head_mask, no_tf32, rms_norm
from bench.state import nest, padded_heads


def segsum(x):
    """(..., T) -> (..., T, T): [i, j] = x[j+1] + ... + x[i] below the
    diagonal, 0 on it, -inf above (the paper's stable segment sum)."""
    T = x.size(-1)
    x = x[..., None].expand(*x.shape, T)
    below = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device),
                       diagonal=-1)
    x = x.masked_fill(~below, 0)
    seg = torch.cumsum(x, dim=-2)
    keep = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device))
    return seg.masked_fill(~keep, float("-inf"))


def ssd(X, A, B, C, block_len: int):
    """The paper's `ssd_minimal_discrete`: X (b, s, h, p), A (b, s, h),
    B and C (b, s, h, n), s a multiple of `block_len` -> Y (b, s, h, p)."""
    b, s, h, p = X.shape
    c, l = s // block_len, block_len
    X, B, C = (t.reshape(b, c, l, h, -1) for t in (X, B, C))
    A = A.reshape(b, c, l, h).permute(0, 3, 1, 2)        # b h c l
    A_cumsum = torch.cumsum(A, dim=-1)
    L = torch.exp(segsum(A))                              # b h c l l
    Y_diag = torch.einsum("bhcls,bcshp->bclhp",
                          torch.einsum("bclhn,bcshn->bhcls", C, B) * L, X)
    decay_states = torch.exp(A_cumsum[..., -1:] - A_cumsum)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", B, decay_states, X)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    decay_chunk = torch.exp(segsum(F.pad(A_cumsum[..., -1], (1, 0))))
    states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)[:, :-1]
    Y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", C, states,
                         torch.exp(A_cumsum))
    return (Y_diag + Y_off).reshape(b, s, h, p)


def mamba(cfg, ops: Ops, p, h):
    z_ = dims(cfg)
    b, s, _ = h.shape
    di, nh, P, G, N = z_["di"], z_["nh"], z_["P"], z_["G"], z_["N"]
    zxd = ops.ein("bsd,de->bse", h, p["in_proj"])
    z, xBC, dt = zxd.split([di, z_["conv"], nh], dim=-1)
    W = p["conv_w"].shape[0]
    pad = F.pad(xBC, (0, 0, W - 1, 0))
    conv = sum(pad[:, k:k + s] * p["conv_w"][k] for k in range(W))
    xBC = F.silu(conv + p["conv_b"])
    x, B, C = xBC.split([di, G * N, G * N], dim=-1)
    x = x.reshape(b, s, nh, P)
    heads = lambda t: t.reshape(b, s, G, 1, N).expand(b, s, G, nh // G, N) \
        .reshape(b, s, nh, N)
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y = ssd(x * dt[..., None], A * dt, heads(B), heads(C),
            cfg["mamba_chunk_size"])
    y = (y + x * p["D"][:, None]).reshape(b, s, di) * F.silu(z)
    y = rms_norm(y, p["norm"], cfg["rms_norm_eps"])
    return ops.ein("bse,ed->bsd", y, p["out_proj"])


def attention(cfg, ops: Ops, p, h, q_block: int = 256):
    """Causal GQA attention of h (B,S,d), no positions."""
    B, S, _ = h.shape
    kp, gp = padded_heads(cfg)
    hd = dims(cfg)["hd"]
    q = ops.ein("bsd,dhk->bshk", h, p["wq"]).reshape(B, S, kp, gp, hd)
    q = q * cfg["attention_multiplier"]
    k = ops.ein("bsd,dhk->bshk", h, p["wk"])
    v = ops.ein("bsd,dhk->bshk", h, p["wv"])

    def block(q, k, v, lo):
        s = ops.ein("bckgd,btkd->bkgct", q, k)
        qi = lo + torch.arange(q.shape[1], device=q.device)[:, None]
        kj = torch.arange(k.shape[1], device=q.device)[None, :]
        s = s.masked_fill(qi < kj, float("-inf"))
        return ops.ein("bkgct,btkd->bckgd", torch.softmax(s, dim=-1), v)

    outs = []
    for lo in range(0, S, q_block):
        hi = min(S, lo + q_block)
        outs.append(checkpoint(block, q[:, lo:hi], k[:, :hi], v[:, :hi], lo,
                               use_reentrant=False))
    o = torch.cat(outs, dim=1) * head_mask(cfg, h.device)[None, None, :, :,
                                                           None]
    return ops.ein("bskgd,kgdo->bso", o, p["wo"].reshape(kp, gp, hd, -1))


def mlp(ops: Ops, p, h):
    g = F.silu(ops.ein("bsd,df->bsf", h, p["wg"]))
    return ops.ein("bsf,fd->bsd", g * ops.ein("bsd,df->bsf", h, p["wi"]),
                   p["wo"])


def layer(cfg, ops: Ops, kind: str, p, x):
    eps, rm = cfg["rms_norm_eps"], cfg["residual_multiplier"]
    h = rms_norm(x, p["ln1"], eps)
    y = (mamba(cfg, ops, p["mamba"], h) if kind == "mamba"
         else attention(cfg, ops, p["attn"], h))
    x = x + y * rm
    return x + mlp(ops, p["mlp"], rms_norm(x, p["ln2"], eps)) * rm


def _layer_params(blocks, i):
    if isinstance(blocks, dict):
        return {k: _layer_params(v, i) for k, v in blocks.items()}
    return blocks[i]


def loss_fn(cfg, ops: Ops, params, tokens, labels, half: bool = False,
            chunk: int = 512):
    """Mean next-token cross entropy over the real vocabulary; `half` as
    `bench.reference.model.loss_fn`'s (half the rows, or of one row the
    later half of its positions, left out)."""
    B, S = tokens.shape
    n = S
    if half and B > 1:
        tokens, labels, B = tokens[:B // 2], labels[:B // 2], B // 2
    elif half:
        n = S // 2
    x = params["embed"]["embedding"][tokens.long()] * cfg[
        "embedding_multiplier"]
    seen = {"mamba": 0, "attention": 0}
    for kind in cfg["layer_types"]:
        blocks = params["mamba_blocks" if kind == "mamba" else "attn_blocks"]
        p = _layer_params(blocks, seen[kind])
        seen[kind] += 1
        x = checkpoint(lambda x, p, kind=kind: layer(cfg, ops, kind, p, x), x,
                       p, use_reentrant=False)
    x = rms_norm(x, params["ln_f"], cfg["rms_norm_eps"])
    head = params["embed"]["embedding"].t()
    V = cfg["vocab_size"]

    def chunk_loss(xc, lc, head):
        logits = ops.ein("bcd,dv->bcv", xc, head)[..., :V] / cfg[
            "logits_scaling"]
        return (torch.logsumexp(logits, -1)
                - logits.gather(-1, lc.long()[..., None])[..., 0]).sum()

    tot = x.new_zeros(())
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        tot = tot + checkpoint(chunk_loss, x[:, lo:hi], labels[:, lo:hi],
                               head, use_reentrant=False)
    return tot / (B * n)


def _adamw(run: Dict, p, grads, m, v, count: int, step: int):
    """`adamw_step`, leaf by leaf: the global norm's clipping factor taken
    first, as `adamw_step` takes it, and each leaf's gradient scaled by it
    before the step (which then clips nothing: the same products), so
    that each leaf's old params and moments go as its new ones are made
    and the state is never held twice (2 x 20 GB at the timed size).
    Updates `p`, `m` and `v` in place and empties `grads`; returns the
    clipped gradients."""
    gnorm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
    scale = min(run["grad_clip"] / max(float(gnorm), 1e-12), 1.0)
    free = dict(run, grad_clip=float("inf"))
    clipped = {}
    for k in list(p):
        g = {k: grads.pop(k) * scale}
        out = adamw_step(free, {k: p[k]}, g, {k: m[k]}, {k: v[k]}, count,
                         step)
        p[k], m[k], v[k], clipped[k] = (t[k] for t in out)
    return clipped


def train(cfg, params: Dict[str, torch.Tensor], batches: List[Dict],
          *, first_step: int = 0, m=None, v=None, count: int = 0,
          precision: str = "f32", half: bool = False) -> Dict:
    """As `bench.reference.model.train`, for the hybrid: len(batches)
    steps from flat f32 `params` and optional moments.  Returns the
    losses, the first step's clipped gradients, and the final params,
    moments and count."""
    no_tf32()
    ops = Ops(precision)
    run = cfg["run"]
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    p = {k: t.detach().to(torch.float32) for k, t in params.items()}
    m = {k: torch.zeros_like(t) for k, t in p.items()} if m is None else dict(m)
    v = {k: torch.zeros_like(t) for k, t in p.items()} if v is None else dict(v)
    losses, first_grads = [], None
    for i, batch in enumerate(batches):
        leaves = {k: t.detach().requires_grad_(True) for k, t in p.items()}
        loss = loss_fn(cfg, ops, nest(leaves), batch["tokens"],
                       batch["labels"], half=half, chunk=run["loss_chunk"])
        grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                     list(leaves.values()))))
        losses.append(float(loss.detach()))
        del leaves, loss
        with torch.no_grad():
            clipped = _adamw(run, p, grads, m, v, count, first_step + i)
        count += 1
        if first_grads is None:
            first_grads = clipped
        del clipped
    return {"losses": losses, "first_grads": first_grads, "params": p,
            "m": m, "v": v, "count": count}
