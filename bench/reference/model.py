"""Plain PyTorch reference of the decoders the benchmark's
configurations run, written from the published architectures: a
pre-norm decoder with RMSNorm, GQA attention with rotary positions
(optional q/k/v bias, optional sliding window), a SwiGLU MLP, a tied or
untied head and next-token cross entropy.

It computes in float32 with TF32 off (`precision="f32"`), or, as the
control, in fp8 as a float8 training recipe does (`precision="fp8"`,
the step below the configurations' bf16): every matrix product's
operands rounded to e4m3 and the gradient that reaches its output to
e5m2, each with one scale per tensor.  It reads the benchmark's state
layout (padded heads and vocabulary) and works every product out again
itself.  Each layer, each block of queries and each chunk of the
loss runs under `torch.utils.checkpoint`, so that a step at the timed
sizes fits on the card after the program's state is freed.

It imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.flops import window
from bench.state import nest, padded_heads

E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def _fp8(x, dtype, top):
    s = x.abs().amax().clamp(min=1e-30) / top
    return (x / s).to(dtype).to(torch.float32) * s


class _RoundGrad(torch.autograd.Function):
    """Identity forward; the incoming gradient rounded to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, E5M2_MAX)


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Ops:
    """The products of one precision."""

    def __init__(self, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.precision = precision

    def r(self, x):
        """An operand of a product: as it is in f32; in fp8 rounded to
        e4m3 under a per-tensor scale, its gradient passed straight
        through."""
        if self.precision == "f32":
            return x
        q = _fp8(x.detach(), torch.float8_e4m3fn, E4M3_MAX)
        return x + (q - x.detach())

    def ein(self, eq, a, b):
        y = torch.einsum(eq, self.r(a), self.r(b))
        return y if self.precision == "f32" else _RoundGrad.apply(y)


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x, pos, theta):
    """Rotary positions on the two halves of each head: x (B,S,N,hd)."""
    half = x.shape[-1] // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half)
    ang = pos.to(torch.float32)[:, None] * freqs
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def head_mask(cfg, device):
    """(K_pad, G_pad) 1 for a real head, 0 for a padding head."""
    kp, gp = padded_heads(cfg)
    K = cfg["num_key_value_heads"]
    G = cfg["num_attention_heads"] // K
    return ((torch.arange(kp, device=device)[:, None] < K)
            & (torch.arange(gp, device=device)[None, :] < G)).float()


def attention(cfg, ops: Ops, p, h, q_block: int = 1024):
    """Causal (or sliding-window) GQA self attention of h (B,S,d)."""
    B, S, _ = h.shape
    kp, gp = padded_heads(cfg)
    hd = cfg["head_dim"]
    pos = torch.arange(S, device=h.device)
    q = ops.ein("bsd,dhk->bshk", h, p["wq"])
    k = ops.ein("bsd,dhk->bshk", h, p["wk"])
    v = ops.ein("bsd,dhk->bshk", h, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    theta = cfg["rope_theta"]
    q = rope(q, pos, theta).reshape(B, S, kp, gp, hd) / math.sqrt(hd)
    k, v = rope(k, pos, theta), v
    W = window(cfg) or S

    def block(q, k, v, lo, t0):
        # queries lo.. against keys t0..: (B,c,K,G,hd) x (B,t,K,hd)
        s = ops.ein("bckgd,btkd->bkgct", q, k)
        qi = lo + torch.arange(q.shape[1], device=q.device)[:, None]
        kj = t0 + torch.arange(k.shape[1], device=q.device)[None, :]
        keep = (qi - kj >= 0) & (qi - kj < W)
        s = s.masked_fill(~keep, float("-inf"))
        return ops.ein("bkgct,btkd->bckgd", torch.softmax(s, dim=-1), v)

    outs = []
    for lo in range(0, S, q_block):
        hi = min(S, lo + q_block)
        t0 = max(0, lo - W + 1)
        outs.append(checkpoint(block, q[:, lo:hi], k[:, t0:hi], v[:, t0:hi],
                               lo, t0, use_reentrant=False))
    o = torch.cat(outs, dim=1) * head_mask(cfg, h.device)[None, None, :, :,
                                                           None]
    return ops.ein("bskgd,kgdo->bso", o,
                   p["wo"].reshape(kp, gp, hd, -1))


def mlp(ops: Ops, p, h):
    g = F.silu(ops.ein("bsd,df->bsf", h, p["wg"]))
    return ops.ein("bsf,fd->bsd", g * ops.ein("bsd,df->bsf", h, p["wi"]),
                   p["wo"])


def layer(cfg, ops: Ops, p, x):
    eps = cfg["rms_norm_eps"]
    x = x + attention(cfg, ops, p["attn"], rms_norm(x, p["ln1"], eps))
    return x + mlp(ops, p["mlp"], rms_norm(x, p["ln2"], eps))


def _layer_params(blocks, i):
    if isinstance(blocks, dict):
        return {k: _layer_params(v, i) for k, v in blocks.items()}
    return blocks[i]


def loss_fn(cfg, ops: Ops, params, tokens, labels, half: bool = False,
            chunk: int = 512):
    """Mean next-token cross entropy over the real vocabulary.  `half`
    leaves half of the batch out, the mean taken over the rest (a
    fault a training step can have): half the rows, or of a single row
    the later half of its positions."""
    B, S = tokens.shape
    n = S
    if half and B > 1:
        tokens, labels, B = tokens[:B // 2], labels[:B // 2], B // 2
    elif half:
        n = S // 2
    x = params["embed"]["embedding"][tokens.long()]
    for i in range(cfg["num_hidden_layers"]):
        x = checkpoint(lambda x, p: layer(cfg, ops, p, x), x,
                       _layer_params(params["blocks"], i), use_reentrant=False)
    x = rms_norm(x, params["ln_f"], cfg["rms_norm_eps"])
    head = params["embed"].get("head")
    if head is None:
        head = params["embed"]["embedding"].t()
    V = cfg["vocab_size"]

    def chunk_loss(xc, lc, head):
        logits = ops.ein("bcd,dv->bcv", xc, head)[..., :V]
        return (torch.logsumexp(logits, -1)
                - logits.gather(-1, lc.long()[..., None])[..., 0]).sum()

    tot = x.new_zeros(())
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        tot = tot + checkpoint(chunk_loss, x[:, lo:hi], labels[:, lo:hi],
                               head, use_reentrant=False)
    return tot / (B * n)


def lr_at(run: Dict, step: int) -> float:
    """Linear warm-up to `lr` over `warmup` steps, then cosine down to
    `min_lr_frac` of it at `total_steps`."""
    warm = (step + 1.0) / max(1.0, run["warmup"])
    prog = min(max((step - run["warmup"])
                   / max(1.0, run["total_steps"] - run["warmup"]), 0.0), 1.0)
    cos = run["min_lr_frac"] + (1 - run["min_lr_frac"]) * 0.5 * (
        1 + math.cos(math.pi * prog))
    return run["lr"] * min(warm, cos)


def adamw_step(run: Dict, params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor], m, v, count: int, step: int):
    """AdamW with global-norm clipping and decoupled weight decay on
    every leaf; flat dicts in and out.  Returns (params, m, v, the
    clipped gradients)."""
    gnorm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
    scale = min(run["grad_clip"] / max(float(gnorm), 1e-12), 1.0)
    count += 1
    b1, b2 = run["beta1"], run["beta2"]
    c1, c2 = 1 - b1 ** count, 1 - b2 ** count
    lr = lr_at(run, step)
    out_p, out_m, out_v, clipped = {}, {}, {}, {}
    for k, p in params.items():
        g = grads[k] * scale
        clipped[k] = g
        out_m[k] = b1 * m[k] + (1 - b1) * g
        out_v[k] = b2 * v[k] + (1 - b2) * g * g
        upd = (out_m[k] / c1) / (torch.sqrt(out_v[k] / c2) + run["eps"])
        out_p[k] = p - lr * (upd + run["weight_decay"] * p)
    return out_p, out_m, out_v, clipped


def train(cfg, params: Dict[str, torch.Tensor], batches: List[Dict],
          *, first_step: int = 0, m=None, v=None, count: int = 0,
          precision: str = "f32", half: bool = False) -> Dict:
    """Follow len(batches) training steps from flat f32 `params` (paths
    without the "params/" prefix) and optional moments.  Returns the
    losses, the first step's clipped gradients, and the final params,
    moments and count."""
    no_tf32()
    ops = Ops(precision)
    run = cfg["run"]
    p = {k: t.detach().to(torch.float32) for k, t in params.items()}
    m = {k: torch.zeros_like(t) for k, t in p.items()} if m is None else m
    v = {k: torch.zeros_like(t) for k, t in p.items()} if v is None else v
    losses, first_grads = [], None
    for i, batch in enumerate(batches):
        leaves = {k: t.detach().requires_grad_(True) for k, t in p.items()}
        loss = loss_fn(cfg, ops, nest(leaves), batch["tokens"],
                       batch["labels"], half=half,
                       chunk=run["loss_chunk"])
        grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                     list(leaves.values()))))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            p, m, v, clipped = adamw_step(run, p, grads, m, v, count,
                                          first_step + i)
        count += 1
        if first_grads is None:
            first_grads = clipped
        del grads, leaves
    return {"losses": losses, "first_grads": first_grads, "params": p,
            "m": m, "v": v, "count": count}
