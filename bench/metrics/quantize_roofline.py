"""`quantize_kernel`'s share of its HBM bound over the window's image:
the bytes its launches had to move (`flops.quantize_bytes` of each
int8 array of the image) at 3.35 TB/s, over its device time."""
from bench.flops import quantize_bytes, roofline_share
from bench.harness import kernel_seconds


def read(run):
    t = kernel_seconds(run, "quantize_kernel")
    n = run.counters.get("image_int8_values")
    if not t or not n or "image_bytes" not in run.counters:
        return None
    return roofline_share(sum(quantize_bytes(x) for x in n), t)
