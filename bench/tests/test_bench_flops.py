"""The frozen FLOP and byte arithmetic against counts made by hand."""
import os

import pytest

from bench import flops, harness

CONF = os.path.join(harness.ROOT, "bench", "configs")
QWEN = harness.load_json(os.path.join(CONF, "qwen2-0.5b.json"))


def test_qwen2_matmul_params():
    # per layer: q 896x896, k and v 896x128 each, o 896x896, SwiGLU
    # 3 x 896x4864; 24 layers; the tied head 896 x 151936 once
    per = 802_816 + 2 * 114_688 + 802_816 + 13_074_432
    assert flops.matmul_params(QWEN) == 24 * per + 136_134_656 == 493_961_216


def test_qwen2_step_flops():
    dense = 6 * 493_961_216 * 8 * 1024
    pairs = 1024 * 1025 // 2              # causal: query i sees i + 1 keys
    attn = 3 * 4 * 64 * 14 * pairs * 8 * 24
    assert dense == 24_279_181_688_832 and attn == 1_083_388_723_200
    assert flops.train_step_flops(QWEN, 8, 1024) == dense + attn


def test_qwen2_step_flops_at_4096():
    # queries 0..4095 see i + 1 keys: 4096 x 4097 / 2 pairs a sequence
    dense = 6 * 493_961_216 * 12 * 4096
    attn = 3 * 4 * 64 * 14 * 8_390_656 * 12 * 24
    assert flops.window(QWEN) == 0
    assert flops.attention_pairs(4096, 0) == 8_390_656
    assert flops.train_step_flops(QWEN, 12, 4096) == dense + attn


@pytest.mark.parametrize("seq,window,pairs", [(8192, 4096, 8_390_656 + 16_777_216),
                                              (10, 3, 6 + 7 * 3)])
def test_sliding_window_pairs(seq, window, pairs):
    # queries 0..w-1 see i + 1 keys, the later ones w each
    assert flops.attention_pairs(seq, window) == pairs


@pytest.mark.parametrize("seq", [1, 7, 4096])
def test_full_window_equals_causal(seq):
    assert flops.attention_pairs(seq, 0) == flops.attention_pairs(seq, seq) \
        == seq * (seq + 1) // 2


def test_kernel_bytes():
    assert flops.quantize_bytes(1000) == 4000 + 1024 + 4
    assert flops.quantize_bytes(2048) == 8192 + 2048 + 8
    assert flops.dequantize_bytes(1000) == 1000 + 4 + 4000
    assert flops.checksum_bytes(64 << 20) == (64 << 20) + 4
    assert flops.roofline_share(3.35e12, 1.0) == pytest.approx(100.0)
    assert flops.roofline_share(1e9, 0.0) != flops.roofline_share(1e9, 0.0)


def test_kernel_names_from_trace():
    assert harness.kernel_name("void (anonymous namespace)::quantize_kernel("
                               "float const*, long long, bool, signed char*, "
                               "float*)") == "quantize_kernel"
    assert harness.kernel_name("(anonymous namespace)::fold_kernel(unsigned "
                               "int const*, long long, unsigned int*)") \
        == "fold_kernel"
    assert harness.kernel_name("void at::native::vectorized_elementwise_"
                               "kernel<4, at::native::exp_kernel_cuda(at::"
                               "TensorIteratorBase&)>(int)") \
        == "vectorized_elementwise_kernel"
    assert harness.kernel_name("dequantize_kernel") == "dequantize_kernel"


def test_trace_reduction_union_and_gaps():
    ns = 10 ** 9
    events = [("a", 0, ns), ("b", ns // 2, ns), ("c", 3 * ns, ns),
              ("d", 10 * ns, ns)]
    r = harness.reduce_trace(events, 0, 5 * ns)
    assert r["busy_s"] == pytest.approx(2.5)
    assert r["by_name"] == {"a": 1.0, "b": 1.0, "c": 1.0}
    assert r["gaps"] == [(int(1.5 * ns), 3 * ns), (4 * ns, 5 * ns)]
    spans = [("step", 0, 2 * ns), ("restore", 2 * ns, 5 * ns)]
    assert harness.name_gaps(spans, r["gaps"]) == [["restore", 1.5],
                                                   ["restore", 1.0]]


def test_a_split_metric_reads_as_its_quantity(monkeypatch):
    """`train_tokens_per_s.ckpt` is `train_tokens_per_s` of its cell;
    `mfu.ckpt` reads through `metrics/mfu.py`."""
    man = harness.manifest()
    cell = harness.find_cell(man, "qwen2-0.5b.train-ckpt")
    pieces = harness.resolve(man, cell)
    driver = harness.load_module(pieces["driver"], "d_split")
    run = harness.Run(cell, pieces, 1, 40.0, False, "cpu", "/nonexistent")
    run.tokens, run.window_s, run.setup_s, run.steps = 8192 * 60, 40.0, 20.0, 60
    run.attempted, run.failed = 60, 0
    line = harness.result_line(run, man, {}, driver)
    assert line["metrics"]["train_tokens_per_s.ckpt"]["value"] == 8192 * 1.5
    assert line["metrics"]["setup_s"]["value"] == 20.0
    run.trace_on = True
    run.trace = {"busy_s": 30.0, "window_s": 40.0, "by_name": {}, "gaps": []}
    line = harness.result_line(run, man, {}, driver)
    t = pieces["traffic"]
    step = flops.train_step_flops(QWEN, t["batch"], t["seq"])
    assert line["metrics"]["mfu.ckpt"]["value"] == pytest.approx(
        100 * 60 * step / (40.0 * flops.PEAK_BF16_FLOPS))
    assert line["metrics"]["device_idle_share.ckpt"]["value"] == 25.0
    assert "quantize_roofline" not in line["metrics"]   # nothing to read
