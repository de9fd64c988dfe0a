"""Mamba-2 mixer of the granite-4.0-h hybrids (HF `GraniteMoeHybrid`'s
Mamba layer, arXiv:2405.21060), over a full sequence.

One `in_proj` (d -> d_inner + conv_dim + H, no bias) splits into the
gate z, the conv input xBC and the step sizes dt; a causal depthwise
conv of width `mamba_conv` with bias runs over xBC (conv_dim = d_inner +
2 G N channels), then SiLU, and splits into x (H heads of P), B and C
(G groups of N); dt = softplus(dt + dt_bias), A = -exp(A_log); the SSD
(`linear_attention.chunked_ssd`, f32, no clamp of dt A) gives y, plus
the skip D x; then the gated norm rmsnorm(y * silu(z)) * norm over
d_inner (f32), and `out_proj` (d_inner -> d, no bias).  Products run in
the compute dtype; dt, the decays, the SSD and the gated norm in f32.

Spans (`repro_torch.trace`, recorded only under a profiler): the mixer
is "mixer.mamba" and its SSD core "mixer.mamba.ssd", both with their
device interval, each forward (its recompute under remat too); their
backward are "mixer.mamba.backward" and "mixer.mamba.ssd.backward",
opened when the gradient reaches the region's output and closed when
its inputs' gradients are made (`_backward_span`), children of the
forward span.  All carry `layer`, `seq` and `chunk`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import trace
from repro_torch.models.layers import _dense_init
from repro_torch.models.mamba import causal_conv
from repro_torch.models.linear_attention import chunked_ssd


def init_mamba2(gen, cfg, *, device, stack: int = 0):
    """Stacked (stack, ...) mixers: products N(0, 1/fan_in), the conv's
    over its width; conv bias 0; A_log = log(1..H), dt_bias 1, D 1 and
    the norm 1 (HF's init)."""
    d, di, nh = cfg.d_model, cfg.mamba_inner, cfg.mamba_heads
    cd = cfg.mamba_conv_dim
    lead = (stack,) if stack else ()
    dense = lambda shape, **kw: _dense_init(gen, shape, device=device,
                                            stack=stack, **kw)

    def full(n, value):
        t = torch.empty((*lead, n), dtype=torch.float32, device=device)
        return t if gen is None else t.fill_(value)

    a_log = full(nh, 0.0)
    if gen is not None:
        a_log.copy_(torch.log(torch.arange(1, nh + 1, dtype=torch.float32,
                                           device=device)))
    params = {
        "in_proj": dense((d, di + cd + nh)),
        "conv_w": dense((cfg.mamba_conv, cd), in_axis=0),
        "conv_b": full(cd, 0.0),
        "dt_bias": full(nh, 1.0),
        "A_log": a_log,
        "D": full(nh, 1.0),
        "norm": full(di, 1.0),
        "out_proj": dense((di, d)),
    }
    logical = {
        "in_proj": (None, None),
        "conv_w": (None, None),
        "conv_b": (None,),
        "dt_bias": (None,),
        "A_log": (None,),
        "D": (None,),
        "norm": ("d_inner",),
        "out_proj": ("d_inner", None),
    }
    return params, logical


class _Marker(torch.autograd.Function):
    """Identity on its tensors; its backward, which runs once every
    gradient of its outputs is made, calls `hook`."""

    @staticmethod
    def forward(ctx, hook, *xs):
        ctx.hook = hook
        return xs if len(xs) > 1 else xs[0]

    @staticmethod
    def backward(ctx, *grads):
        ctx.hook()
        return (None, *grads)


class _backward_span:
    """A span over the backward of a region: `output(y)` marks where the
    gradient enters (the span opens), `inputs(*xs)` where it leaves (it
    closes).  Only while recording and where autograd records; the
    span's parent is the forward span that made the region."""

    def __init__(self, name: str, parent, **attrs):
        self.on = trace.current() is not None and torch.is_grad_enabled()
        self.name, self.parent, self.attrs, self.ctx = name, parent, attrs, None

    def _open(self):
        self.ctx = trace.span(self.name, device=True, parent=self.parent,
                              **self.attrs)
        self.ctx.__enter__()

    def _close(self):
        if self.ctx is not None:
            self.ctx.__exit__(None, None, None)
            self.ctx = None

    def inputs(self, *xs):
        if not self.on or not any(x.requires_grad for x in xs):
            return xs
        out = _Marker.apply(self._close, *xs)
        return out if len(xs) > 1 else (out,)

    def output(self, y):
        if not self.on or not y.requires_grad:
            return y
        return _Marker.apply(self._open, y)


def _ssd(p, x, dt, Bm, Cm, chunk: int, attrs):
    with trace.span("mixer.mamba.ssd", device=True, **attrs) as sp:
        bw = _backward_span("mixer.mamba.ssd.backward", sp, **attrs)
        x, dt, Bm, Cm = bw.inputs(x, dt, Bm, Cm)
        A = -torch.exp(p["A_log"])
        y, _ = chunked_ssd(x, dt, A, Bm, Cm, chunk=chunk)
        return bw.output(y)


def mamba2_apply(p, h, cfg, *, layer: int = 0, parent=None):
    """h: (B,S,d) normed input in the compute dtype -> (B,S,d).  `parent`
    is the span of the forward that runs the mixer (its recompute under
    remat runs on autograd's thread, where no span is open)."""
    S = h.shape[1]
    attrs = {"layer": layer, "seq": S, "chunk": cfg.mamba_chunk}
    with trace.span("mixer.mamba", device=True, parent=parent,
                    **attrs) as sp:
        bw = _backward_span("mixer.mamba.backward", sp, **attrs)
        (h,) = bw.inputs(h)
        dtype = h.dtype
        B_, _, _ = h.shape
        di, nh, P = cfg.mamba_inner, cfg.mamba_heads, cfg.mamba_head_dim
        G, N = cfg.mamba_groups, cfg.mamba_state
        zxd = torch.einsum("bsd,de->bse", h, p["in_proj"].to(dtype))
        z, xBC, dt = zxd.split([di, cfg.mamba_conv_dim, nh], dim=-1)
        xBC = F.silu(causal_conv(xBC, p["conv_w"].to(dtype),
                                 p["conv_b"].to(dtype)))
        x, Bm, Cm = xBC.split([di, G * N, G * N], dim=-1)
        x = x.reshape(B_, S, nh, P)
        dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])
        y = _ssd(p, x, dt, Bm.reshape(B_, S, G, N), Cm.reshape(B_, S, G, N),
                 cfg.mamba_chunk, attrs)
        y = y + x.to(torch.float32) * p["D"][:, None]
        y = y.reshape(B_, S, di) * F.silu(z.to(torch.float32))
        y = y * torch.rsqrt(y.pow(2).mean(-1, keepdim=True) + cfg.norm_eps)
        y = (y * p["norm"]).to(dtype)
        out = torch.einsum("bse,ed->bsd", y, p["out_proj"].to(dtype))
        return bw.output(out)

