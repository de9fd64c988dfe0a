"""The initial training state of a `layer_types` hybrid (granite-4.0-h),
made from `--seed` by the benchmark's own code, in the layout the port
stores it: Mamba-2 blocks stacked on one leading axis
(`params/mamba_blocks/...`), attention blocks on another
(`params/attn_blocks/...`), each with its pre-norms and its MLP; the
embedding (tied head) and the final norm.  `bench.state.check_layout`
holds it against the program's shapes at set-up; the token batches are
`bench.state.TokenBatches`.

Products are N(0, 1/fan_in), the conv's over its width.  The SSM
leaves take Mamba-2's published init (mamba_ssm, arXiv:2405.21060):
A_log = log U[1, 16], dt_bias = softplus^-1(dt) with dt log-uniform in
[1e-3, 1e-1], D = 1; the conv bias 0, every norm 1.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from bench.state import nest, padded_heads, vocab_padded

DT_MIN, DT_MAX = 1e-3, 1e-1
A_MIN, A_MAX = 1.0, 16.0


def dims(cfg: dict) -> dict:
    """The hybrid's sizes from a configuration file's keys."""
    nh, P = cfg["mamba_n_heads"], cfg["mamba_d_head"]
    G, N = cfg["mamba_n_groups"], cfg["mamba_d_state"]
    return {"d": cfg["hidden_size"], "di": nh * P, "nh": nh, "P": P, "G": G,
            "N": N, "conv": nh * P + 2 * G * N, "W": cfg["mamba_d_conv"],
            "f": cfg["shared_intermediate_size"],
            "hd": cfg["hidden_size"] // cfg["num_attention_heads"],
            "L_mamba": cfg["layer_types"].count("mamba"),
            "L_attn": cfg["layer_types"].count("attention")}


def param_layout(cfg: dict) -> Dict[str, Tuple[Tuple[int, ...], object]]:
    """path -> (shape, init): a fan-in (N(0, 1/fan_in)), "ones", "zeros",
    "A_log" or "dt_bias"."""
    z = dims(cfg)
    d, f, hd = z["d"], z["f"], z["hd"]
    kp, gp = padded_heads(cfg)
    out = {"params/embed/embedding": ((vocab_padded(cfg), d), d),
           "params/ln_f": ((d,), "ones")}
    Lm, La = z["L_mamba"], z["L_attn"]
    m = "params/mamba_blocks/"
    out.update({
        m + "mamba/in_proj": ((Lm, d, z["di"] + z["conv"] + z["nh"]), d),
        m + "mamba/conv_w": ((Lm, z["W"], z["conv"]), z["W"]),
        m + "mamba/conv_b": ((Lm, z["conv"]), "zeros"),
        m + "mamba/dt_bias": ((Lm, z["nh"]), "dt_bias"),
        m + "mamba/A_log": ((Lm, z["nh"]), "A_log"),
        m + "mamba/D": ((Lm, z["nh"]), "ones"),
        m + "mamba/norm": ((Lm, z["di"]), "ones"),
        m + "mamba/out_proj": ((Lm, z["di"], d), z["di"])})
    a = "params/attn_blocks/"
    out.update({
        a + "attn/wq": ((La, d, kp * gp, hd), d),
        a + "attn/wk": ((La, d, kp, hd), d),
        a + "attn/wv": ((La, d, kp, hd), d),
        a + "attn/wo": ((La, kp * gp, hd, d),
                        cfg["num_attention_heads"] * hd)})
    for pre, n in ((m, Lm), (a, La)):
        out.update({pre + "ln1": ((n, d), "ones"), pre + "ln2": ((n, d), "ones"),
                    pre + "mlp/wi": ((n, d, f), d), pre + "mlp/wg": ((n, d, f), d),
                    pre + "mlp/wo": ((n, f, d), f)})
    return dict(sorted(out.items()))


def make_params(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Flat f32 params from the seed: one normal draw on `device` for the
    fan-in leaves, cut and scaled, then one uniform draw for the SSM
    leaves."""
    layout = param_layout(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    rand = [(p, s, fi) for p, (s, fi) in layout.items()
            if not isinstance(fi, str)]
    buf = torch.randn(sum(math.prod(s) for _, s, _ in rand), generator=gen,
                      dtype=torch.float32, device=device)
    out, o = {}, 0
    for p, s, fi in rand:
        n = math.prod(s)
        out[p] = buf[o:o + n].view(s).mul_(1.0 / math.sqrt(fi))
        o += n
    for p, (s, fi) in layout.items():
        if fi == "ones":
            out[p] = torch.ones(s, dtype=torch.float32, device=device)
        elif fi == "zeros":
            out[p] = torch.zeros(s, dtype=torch.float32, device=device)
        elif fi == "A_log":
            u = torch.rand(s, generator=gen, dtype=torch.float32, device=device)
            out[p] = torch.log(A_MIN + (A_MAX - A_MIN) * u)
        elif fi == "dt_bias":
            u = torch.rand(s, generator=gen, dtype=torch.float32, device=device)
            dt = torch.exp(math.log(DT_MIN)
                           + (math.log(DT_MAX) - math.log(DT_MIN)) * u)
            out[p] = dt + torch.log(-torch.expm1(-dt))    # softplus^-1
    return dict(sorted(out.items()))


def make_train_state(cfg: dict, seed: int, device) -> Dict:
    """The whole initial training state, nested as the port holds it:
    params from the seed, zero AdamW moments (each a view of one zero
    buffer), zero counters."""
    params = make_params(cfg, seed, device)
    total = sum(p.numel() for p in params.values())
    moments = {}
    for name in ("m", "v"):
        buf = torch.zeros(total, dtype=torch.float32, device=device)
        o, leaves = 0, {}
        for path, p in params.items():
            leaves[path[len("params/"):]] = buf[o:o + p.numel()].view(p.shape)
            o += p.numel()
        moments[name] = nest(leaves)
    zero = lambda: torch.zeros((), dtype=torch.int32, device=device)
    return {"params": nest({k[len("params/"):]: v for k, v in params.items()}),
            "opt": {"m": moments["m"], "v": moments["v"], "count": zero()},
            "step": zero()}
