"""`dequantize_kernel`'s share of its HBM bound at restore: every int8
array of the image decoded once a restore in the window
(`flops.dequantize_bytes`), at 3.35 TB/s, over its device time."""
from bench.flops import dequantize_bytes, roofline_share
from bench.harness import kernel_seconds


def read(run):
    t = kernel_seconds(run, "dequantize_kernel")
    vals, n = (run.counters.get("image_int8_values"),
               run.counters.get("restores"))
    if not t or not vals or not n:
        return None
    return roofline_share(n * sum(dequantize_bytes(x) for x in vals), t)
