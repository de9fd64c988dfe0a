"""The port's kernels and runtime on a CUDA card: each kernel bit for bit
against its plain PyTorch version, launch counting, and a bit-identical
resume through MANARuntime.  Marked `cuda`; without a card every test
skips.  Run on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: none (kernels and resume are compared bit for bit).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, reduced_config
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.kernels.checksum import ops as cops
from repro_torch.kernels.checksum import ref as cref
from repro_torch.kernels.delta import ops as dops
from repro_torch.kernels.delta import ref as dref
from repro_torch.kernels.quantize import ops as qops
from repro_torch.kernels.quantize import ref as qref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("offset,nbytes", [(0, 1), (0, 8192), (3, 8191),
                                           (0, 3 * 8192 + 5), (16, 100000)])
def test_checksum_kernel(dev, offset, nbytes):
    raw = np.random.RandomState(nbytes).randint(0, 256, offset + nbytes)
    t = torch.from_numpy(raw.astype(np.uint8)).to(dev)
    before = cops.launches
    got = cops.checksum(t, offset, nbytes)
    assert cops.launches == before + 1
    assert got == cref.checksum_torch(t, offset, nbytes)
    assert got == cref.checksum_np(raw.astype(np.uint8)[offset:])


@pytest.mark.parametrize("n", [1, 16, 17, 4099, 1 << 20])
def test_xor_kernel(dev, n):
    g = torch.Generator(device=dev)
    g.manual_seed(n)
    a = torch.randint(0, 256, (n + 1,), dtype=torch.uint8, device=dev,
                      generator=g)
    b = torch.randint(0, 256, (n + 1,), dtype=torch.uint8, device=dev,
                      generator=g)
    for x, y in ((a[:n], b[:n]), (a[1:], b[:n])):      # aligned, unaligned
        assert torch.equal(dops.xor_bytes(x, y), dref.xor_torch(x, y))


@pytest.mark.parametrize("n", [1000, 1024, 5000, 3 * 1024 * 1024 + 7])
def test_quantize_kernel(dev, n):
    g = torch.Generator(device=dev)
    g.manual_seed(n)
    x = torch.randn(n, generator=g, device=dev) * 1e-3
    q, s, pad = qops.quantize(x)
    q2, s2, pad2 = qref.quantize_torch(x)
    assert pad == pad2 and torch.equal(q, q2) and torch.equal(s, s2)
    qn, sn, _ = qref.quantize_np(x.cpu().numpy())
    np.testing.assert_array_equal(q.cpu().numpy(), qn)
    np.testing.assert_array_equal(s.cpu().numpy(), sn)


@pytest.mark.parametrize("n", [1000, 1024, 5000, 3 * 1024 * 1024 + 7])
def test_dequantize_kernel(dev, n):
    g = torch.Generator(device=dev)
    g.manual_seed(n)
    q, s, pad = qref.quantize_torch(torch.randn(n, generator=g, device=dev))
    before = qops.dequantize_launches
    x = qops.dequantize(q, s, pad, (n,))
    assert qops.dequantize_launches == before + 1
    assert torch.equal(x, qref.dequantize_torch(q.view(-1), s.view(-1), n))
    np.testing.assert_array_equal(x.cpu().numpy(), qref.dequantize_np(
        q.cpu().numpy(), s.cpu().numpy(), pad, (n,), np.float32))
    # unaligned codes and output take the scalar path
    q1 = torch.empty(q.numel() + 1, dtype=torch.int8, device=dev)[1:]
    q1.copy_(q.view(-1))
    assert torch.equal(qops.dequantize(q1, s, pad, (n,)), x)


def test_runtime_resume_on_card(dev, tmp_path):
    """Delta params + int8 moments launch all four kernels on the main
    path (writes and a restore); with delta params alone the resume is
    bit-identical."""
    from repro_torch.core.runtime import MANARuntime

    cfg = reduced_config(ARCHS["qwen2-0.5b"])
    rc = RunConfig(model=cfg, shape=ShapeConfig("s", 64, 2, "train"),
                   loss_chunk=32, attn_chunk=16)
    counts = lambda: (cops.launches, dops.launches, qops.launches,
                      qops.dequantize_launches)
    before = counts()
    rt = MANARuntime(cfg, rc, ckpt_dir=str(tmp_path / "int8"),
                     ckpt_every_steps=2, delta_params=True,
                     quantize_moments=True)
    rt.initialize()
    rt.run(4)
    assert rt.ckpt.restore(4)[0]["params"]["ln_f"].device.type == "cuda"
    assert all(c > c0 for c, c0 in zip(counts(), before))

    torch.use_deterministic_algorithms(True)
    try:
        rt = MANARuntime(cfg, rc, ckpt_dir=str(tmp_path / "delta"),
                         ckpt_every_steps=2, delta_params=True)
        rt.initialize()
        hist = rt.run(4)
        rt2 = MANARuntime(cfg, rc, ckpt_dir=str(tmp_path / "delta"),
                          delta_params=True)
        assert rt2.restore(2) == 2
        assert [h["loss"] for h in rt2.run(2)] == \
            [h["loss"] for h in hist][2:4]
    finally:
        torch.use_deterministic_algorithms(False)
