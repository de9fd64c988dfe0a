"""The port's checksum, XOR delta and int8 quantize and dequantize (plain
PyTorch versions on CPU tensors, and the numpy twins the port copies) against
the JAX package's Pallas kernels in interpret mode and its numpy twins.

Tolerance: none, with one exception.  Digests, XOR bytes, int8 codes and
f32 scales are compared bit for bit with the numpy twins — the image
format depends on it — and so are dequantized values (one f32 multiply,
exact in both packages).  The Pallas quantize kernel's scales are compared
to within one ulp: XLA compiles its `amax / 127.0` as a multiply by the
f32 reciprocal, which differs from IEEE division in the last bit for
some inputs (its own tests/test_kernels.py compares them at rtol 1e-6).
The port divides as `quantize_np` does.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # minimal env: deterministic fallback sampler
    from _hypothesis_fallback import given, settings, st

from repro.kernels.checksum import ops as jcops
from repro.kernels.checksum import ref as jcref
from repro.kernels.delta import ops as jdops
from repro.kernels.delta import ref as jdref
from repro.kernels.quantize import ops as jqops
from repro.kernels.quantize import ref as jqref
from repro_torch.kernels.checksum import ops as cops
from repro_torch.kernels.checksum import ref as cref
from repro_torch.kernels.delta import ops as dops
from repro_torch.kernels.delta import ref as dref
from repro_torch.kernels.quantize import ops as qops
from repro_torch.kernels.quantize import ref as qref

SHAPES = [(8,), (127,), (33, 65), (4, 8, 16), (2048,), (3, 2048)]
DTYPES = [np.float32, np.float16, np.int32, np.uint8]


def _data(shape, dtype, seed):
    rng = np.random.RandomState(seed)
    if np.issubdtype(dtype, np.floating):
        return rng.randn(*shape).astype(dtype)
    return rng.randint(0, 100, shape).astype(dtype)


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    """CPU tensors take the plain versions: no kernel launch is counted."""
    counts = lambda: (cops.launches, dops.launches, qops.launches,
                      qops.dequantize_launches)
    before = counts()
    yield
    assert counts() == before == (0, 0, 0, 0)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_checksum_matches_reference(shape, dtype):
    x = _data(shape, dtype, hash((shape, str(dtype))) % 2**31)
    pallas = int(jcops.checksum(jnp.asarray(x), use_kernel=True))
    assert (cops.checksum(torch.from_numpy(x)) == cref.checksum_np(x)
            == jcref.checksum_np(x) == pallas)


@pytest.mark.parametrize("offset,nbytes", [(0, 0), (1, 9), (3, 8192),
                                           (5, 8191), (16, 20000), (7, None)])
def test_checksum_byte_range(offset, nbytes):
    raw = np.random.RandomState(offset).randint(0, 256, 30000).astype(np.uint8)
    end = raw.size if nbytes is None else offset + nbytes
    want = jcref.checksum_np(raw[offset:end])
    assert cops.checksum(torch.from_numpy(raw), offset, nbytes) == want


def test_checksum_zero_dim_tensor():
    x = np.asarray(7, np.int32)
    assert cops.checksum(torch.tensor(7, dtype=torch.int32)) == \
        jcref.checksum_np(x)


@settings(max_examples=25, deadline=None)
@given(st.integers(1, 20000), st.integers(0, 2**31 - 1))
def test_checksum_property_any_length(n, seed):
    """Plain torch version equals the reference twin at any length and is
    single-bit sensitive."""
    rng = np.random.RandomState(seed % 2**31)
    x = rng.randint(0, 256, n).astype(np.uint8)
    a = cops.checksum(torch.from_numpy(x))
    assert a == jcref.checksum_np(x)
    y = x.copy()
    y[rng.randint(n)] ^= 1
    assert cops.checksum(torch.from_numpy(y)) != a


def test_checksum_wraps_with_all_ones_words():
    """All-0xFF words: every block sum and every fold term wraps mod 2^32
    (the int64 arithmetic of the plain version must mask each one)."""
    x = np.full(300 * 8192 + 5, 0xFF, np.uint8)
    assert cops.checksum(torch.from_numpy(x)) == jcref.checksum_np(x)


@pytest.mark.parametrize("shape", [(1024,), (5000,), (16, 1024), (7, 333)])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_quantize_matches_reference(shape, dtype):
    x = (np.random.RandomState(0).randn(*shape) * 10).astype(dtype)
    q, s, pad = qops.quantize(torch.from_numpy(x))
    qj, sj = jqops.quantize(jnp.asarray(x), use_kernel=True)
    qn, sn, padn = jqref.quantize_np(x)
    assert pad == padn == (-x.size) % qref.QBLOCK
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(q.numpy(), qn)
    np.testing.assert_array_max_ulp(s.numpy(), np.asarray(sj).reshape(-1, 1),
                                    maxulp=1)
    np.testing.assert_array_equal(s.numpy(), sn)
    assert q.dtype == torch.int8 and s.dtype == torch.float32


def test_quantize_zero_block_and_ties():
    """amax == 0 gives scale 1; exact .5 quotients round half to even."""
    x = np.zeros(3 * 1024, np.float32)
    x[1024:2048] = np.arange(1024) * (127.0 / 1023.0)
    x[2048] = 127.0
    x[2049:2060] = np.arange(11) + 0.5
    q, s, pad = qops.quantize(torch.from_numpy(x))
    qn, sn, _ = jqref.quantize_np(x)
    np.testing.assert_array_equal(q.numpy(), qn)
    np.testing.assert_array_equal(s.numpy(), sn)
    assert s[0, 0] == 1.0


@pytest.mark.parametrize("shape", [(1024,), (5000,), (16, 1024), (7, 333),
                                   (0,)])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_dequantize_matches_reference(shape, dtype):
    """Only the array's own values come back, in its dtype."""
    x = (np.random.RandomState(1).randn(*shape) * 10).astype(dtype)
    qn, sn, pad = jqref.quantize_np(x)
    got = qops.dequantize(torch.from_numpy(qn), torch.from_numpy(sn), pad,
                          shape, getattr(torch, np.dtype(dtype).name))
    want = jqref.dequantize_np(qn, sn, pad, shape, dtype)
    assert tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)
    if qn.shape[0]:
        pallas = np.asarray(jqops.dequantize(jnp.asarray(qn), jnp.asarray(sn),
                                             use_kernel=True))
        np.testing.assert_array_equal(
            got.numpy(), pallas.ravel()[:x.size].reshape(shape).astype(dtype))
    # flat codes and scales, as a restore reads them, give the same
    flat = qops.dequantize(torch.from_numpy(qn).view(torch.uint8).view(-1)
                           .view(torch.int8), torch.from_numpy(sn.ravel()),
                           pad, shape, getattr(torch, np.dtype(dtype).name))
    assert torch.equal(flat, got)


def test_dequantize_rejects_mismatched_sizes():
    q = torch.zeros((2, qref.QBLOCK), dtype=torch.int8)
    s = torch.ones((2, 1))
    with pytest.raises(ValueError):
        qops.dequantize(q, s, 0, (3 * qref.QBLOCK,))
    with pytest.raises(ValueError):
        qops.dequantize(q, torch.ones((3, 1)), 0, (2 * qref.QBLOCK,))
    with pytest.raises(TypeError):
        qops.dequantize(q.to(torch.uint8), s, 0, (2 * qref.QBLOCK,))


@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.int32])
def test_delta_matches_reference(dtype):
    rng = np.random.RandomState(2)
    prev = (rng.randn(3, 2048) * 5).astype(dtype)
    cur = prev.copy()
    cur[1, ::7] += np.asarray(1, dtype)
    d = dops.xor_bytes(torch.from_numpy(cur), torch.from_numpy(prev))
    assert d.dtype == torch.uint8 and d.numel() == cur.nbytes
    words = np.asarray(jdops.delta(jnp.asarray(cur), jnp.asarray(prev),
                                   use_kernel=True))
    pallas = np.frombuffer(words.astype("<u4").tobytes()[:cur.nbytes],
                           np.uint8)
    np.testing.assert_array_equal(d.numpy(), pallas)
    np.testing.assert_array_equal(d.numpy(), jdref.delta_np(cur, prev))
    # the same XOR applies the delta
    back = dops.xor_bytes(torch.from_numpy(prev), d)
    np.testing.assert_array_equal(back.numpy().view(dtype).reshape(cur.shape),
                                  cur)
    assert not dops.xor_bytes(torch.from_numpy(prev),
                              torch.from_numpy(prev)).any()


@pytest.mark.parametrize("n", [1, 15, 16, 17, 4099])
def test_delta_ragged_lengths(n):
    rng = np.random.RandomState(n)
    a = rng.randint(0, 256, n).astype(np.uint8)
    b = rng.randint(0, 256, n).astype(np.uint8)
    np.testing.assert_array_equal(
        dops.xor_bytes(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        jdref.delta_np(a, b))


def test_numpy_copies_match_reference_twins():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 777).astype(np.float32)
    y = rng.randn(2, 777).astype(np.float32)
    assert cref.checksum_np(x) == jcref.checksum_np(x)
    np.testing.assert_array_equal(dref.delta_np(x, y), jdref.delta_np(x, y))
    d = dref.delta_np(x, y)
    np.testing.assert_array_equal(dref.apply_np(y, d, x.shape, x.dtype), x)
    qa, sa, pa = qref.quantize_np(x)
    qb, sb, pb = jqref.quantize_np(x)
    np.testing.assert_array_equal(qa, qb)
    np.testing.assert_array_equal(sa, sb)
    np.testing.assert_array_equal(
        qref.dequantize_np(qa, sa, pa, x.shape, x.dtype),
        jqref.dequantize_np(qb, sb, pb, x.shape, x.dtype))


def test_wrappers_refuse_other_devices():
    """No silent fallback: a tensor that is neither on the CPU (plain
    version) nor on CUDA (kernel) is refused."""
    t = torch.empty(64, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        cops.checksum(t)
    with pytest.raises(ValueError):
        dops.xor_bytes(t, t)
    with pytest.raises(ValueError):
        qops.quantize(torch.empty(64, device="meta"))
    with pytest.raises(ValueError):
        qops.dequantize(torch.empty(1024, dtype=torch.int8, device="meta"),
                        torch.empty(1, device="meta"), 0, (1024,))
