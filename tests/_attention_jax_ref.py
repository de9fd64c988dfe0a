"""The JAX package's flash attention (`repro.models.attention`) on fixed
bf16 inputs, kept as a file so that a test on a CUDA card, where the JAX
package does not run, can hold the port's attention kernels against it.

`CASES` are the shapes; `inputs(name)` makes a case's bf16 q, k, v and
the output's gradient from `np.random.RandomState` (whose stream numpy
keeps fixed), so only the reference's answers are stored: the output
and the gradients of q, k and v from `jax.vjp`, each as the bits of its
bf16 values (uint16), in `tests/data/attention_jax_bf16.npz`.
Regenerate the file, on the CPU, with

    PYTHONPATH=src python tests/_attention_jax_ref.py
"""
import os

import numpy as np
import torch

PATH = os.path.join(os.path.dirname(__file__), "data", "attention_jax_bf16.npz")
NAMES = ("o", "dq", "dk", "dv")

# name: (B, S, T, H, K, hd, causal).  Lengths that are no multiple of
# the kernels' 64-key tile; S != T without a causal mask; G = H / K of
# 8 (qwen2-0.5b's), 4, 2 and 1; head dims 16, 64, 128 and 160.
CASES = {
    "g8": (1, 72, 72, 16, 2, 64, True),
    "ragged": (1, 100, 100, 4, 2, 64, True),
    "cross": (1, 40, 150, 4, 2, 64, False),
    "g1": (1, 96, 96, 4, 4, 64, True),
    "hd128": (1, 100, 100, 4, 1, 128, True),
    "hd128_cross": (1, 33, 97, 2, 2, 128, False),
    "hd160": (1, 97, 97, 2, 1, 160, True),
    "hd160_cross": (1, 70, 129, 2, 1, 160, False),
    "hd16": (2, 70, 70, 4, 2, 16, True),
}


def inputs(name: str):
    """(q, k, v, dout) of case `name`: bf16 CPU tensors, q and dout
    (B, S, H, hd), k and v (B, T, K, hd)."""
    B, S, T, H, K, hd, _ = CASES[name]
    rng = np.random.RandomState(list(CASES).index(name))
    r = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32)).to(
        torch.bfloat16)
    return r(B, S, H, hd), r(B, T, K, hd), r(B, T, K, hd), r(B, S, H, hd)


def bits(t) -> np.ndarray:
    """The bits of a bf16 torch tensor, as uint16."""
    return t.detach().cpu().contiguous().view(torch.int16).numpy().view(
        np.uint16)


def values(u: np.ndarray):
    """A bf16 torch tensor from its bits (`bits`)."""
    return torch.from_numpy(u.view(np.int16).copy()).view(torch.bfloat16)


def jax_reference(name: str) -> dict:
    """{o, dq, dk, dv}: the JAX package's flash attention of case
    `name` (its default chunk of 128 keys) and its `jax.vjp`, as bits."""
    import jax
    import jax.numpy as jnp

    from repro.models import attention as jattn

    causal = CASES[name][-1]
    j = lambda t: jnp.asarray(bits(t)).view(jnp.bfloat16)
    q, k, v, dout = (j(t) for t in inputs(name))
    o, vjp = jax.vjp(lambda q, k, v: jattn.flash_attention(
        q, k, v, causal=causal), q, k, v)
    out = dict(zip(NAMES, (o, *vjp(dout))))
    return {n: np.asarray(x.view(jnp.uint16)) for n, x in out.items()}


def load() -> dict:
    """{case: {o, dq, dk, dv}} from the file, as bf16 torch tensors."""
    with np.load(PATH) as f:
        return {c: {n: values(f[f"{c}.{n}"]) for n in NAMES} for c in CASES}


if __name__ == "__main__":
    os.makedirs(os.path.dirname(PATH), exist_ok=True)
    np.savez_compressed(PATH, **{f"{c}.{n}": x for c in CASES
                                 for n, x in jax_reference(c).items()})
    print(f"wrote {PATH} ({os.path.getsize(PATH)} bytes)")
