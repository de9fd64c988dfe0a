"""The benchmark's inputs, made from `--seed` by its own code: the
initial training state in the layout the port stores it, and the token
batches of every step.  The program and the plain reference get the
same: the program through `MANARuntime.state` and `.dataset`, the
reference by calling these functions again with the same seed.

The layout (leaf paths and shapes) is the image format's, which the port
keeps equal to the JAX package's: blocks stacked on a leading layer
axis, query heads padded to a multiple of `pad_to` in a (K_pad, G_pad)
grid whose dummy heads are masked, the vocabulary padded likewise.
`check_layout` holds it against the program's own shapes at set-up.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch


def padded_heads(cfg: dict) -> Tuple[int, int]:
    """(K_pad, G_pad): the fewest padded heads K_pad * G_pad, a multiple
    of pad_to, with K_pad >= K and G_pad >= H / K, K_pad == K preferred."""
    K = cfg["num_key_value_heads"]
    G = cfg["num_attention_heads"] // K
    P = cfg["run"]["pad_to"]
    best = None
    for kp in range(K, 4 * K + 1):
        for gp in range(G, 4 * G + 1):
            if (kp * gp) % P == 0:
                key = (kp * gp, kp != K, kp, gp)
                best = key if best is None or key < best else best
    return best[2], best[3]


def vocab_padded(cfg: dict) -> int:
    P = cfg["run"]["pad_to"]
    return -(-cfg["vocab_size"] // P) * P


def param_layout(cfg: dict) -> Dict[str, Tuple[Tuple[int, ...], object]]:
    """path -> (shape, init): init is a fan-in (values N(0, 1/fan_in)),
    "ones" or "zeros"."""
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    hd, f = cfg["head_dim"], cfg["intermediate_size"]
    kp, gp = padded_heads(cfg)
    hp = kp * gp
    q_real = cfg["num_attention_heads"] * hd
    V = vocab_padded(cfg)
    out = {"params/embed/embedding": ((V, d), d),
           "params/ln_f": ((d,), "ones"),
           "params/blocks/ln1": ((L, d), "ones"),
           "params/blocks/ln2": ((L, d), "ones"),
           "params/blocks/attn/wq": ((L, d, hp, hd), d),
           "params/blocks/attn/wk": ((L, d, kp, hd), d),
           "params/blocks/attn/wv": ((L, d, kp, hd), d),
           "params/blocks/attn/wo": ((L, hp, hd, d), q_real)}
    if not cfg["tie_word_embeddings"]:
        out["params/embed/head"] = ((d, V), d)
    if cfg.get("qkv_bias"):
        out["params/blocks/attn/bq"] = ((L, hp, hd), "zeros")
        out["params/blocks/attn/bk"] = ((L, kp, hd), "zeros")
        out["params/blocks/attn/bv"] = ((L, kp, hd), "zeros")
    out["params/blocks/mlp/wi"] = ((L, d, f), d)
    out["params/blocks/mlp/wg"] = ((L, d, f), d)
    out["params/blocks/mlp/wo"] = ((L, f, d), f)
    return dict(sorted(out.items()))


def nest(flat: Dict[str, object]) -> Dict:
    """'a/b/c' paths -> nested dicts."""
    root: Dict = {}
    for path, val in flat.items():
        node = root
        *head, last = path.split("/")
        for p in head:
            node = node.setdefault(p, {})
        node[last] = val
    return root


def flat(tree, prefix: str = "") -> Dict[str, object]:
    """Nested dicts -> 'a/b/c' paths, keys sorted."""
    if not isinstance(tree, dict):
        return {prefix[:-1]: tree}
    out: Dict[str, object] = {}
    for k in sorted(tree):
        out.update(flat(tree[k], f"{prefix}{k}/"))
    return out


def make_params(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Flat f32 params from the seed: one normal draw on `device` for
    every random leaf, cut into the leaves and scaled by 1/sqrt(fan_in)."""
    layout = param_layout(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    rand = [(p, s, fi) for p, (s, fi) in layout.items()
            if not isinstance(fi, str)]
    total = sum(math.prod(s) for _, s, _ in rand)
    buf = torch.randn(total, generator=gen, dtype=torch.float32,
                      device=device)
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
    return {"params": nest({k[len("params/"):]: v for k, v in params.items()}),
            "opt": {"m": moments["m"], "v": moments["v"],
                    "count": torch.zeros((), dtype=torch.int32,
                                         device=device)},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def check_layout(state: Dict, program_state: Dict) -> None:
    """Raise unless the benchmark's state has the program's leaf paths,
    shapes and dtypes (`program_state`: the program's abstract train
    state, e.g. on the meta device)."""
    mine = {k: (tuple(v.shape), v.dtype) for k, v in flat(state).items()}
    theirs = {k: (tuple(v.shape), v.dtype)
              for k, v in flat(program_state).items()}
    if mine != theirs:
        diff = sorted(set(mine.items()) ^ set(theirs.items()))
        raise ValueError(f"state layout differs from the program's: {diff}")


class TokenBatches:
    """Token batches of one training job: step `s` is a pure function of
    (seed, s), B rows of S + 1 tokens drawn uniformly from the real
    vocabulary, split into inputs and next-token labels.  The runtime
    reads it as its dataset (`get_batch`, and `state_dict` for the
    image's data cursor)."""

    def __init__(self, vocab: int, batch: int, seq: int, seed: int):
        self.vocab, self.batch, self.seq, self.seed = vocab, batch, seq, seed

    def get_batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng([self.seed % (1 << 63), step, 0x62656E63])
        seq = rng.integers(0, self.vocab, size=(self.batch, self.seq + 1),
                           dtype=np.int64)
        return {"tokens": seq[:, :-1].astype(np.int32),
                "labels": seq[:, 1:].astype(np.int32)}

    def state_dict(self, step: int) -> Dict:
        return {"seed": self.seed, "step": step}
