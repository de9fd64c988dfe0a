"""The checksum kernels' share of their HBM bound at restore verify:
every chunk of the image digested once a restore in the window, at
3.35 TB/s, over their device time."""
from bench.flops import checksum_bytes, roofline_share
from bench.harness import kernel_seconds


def read(run):
    t = kernel_seconds(run, "block_sums_kernel", "fold_kernel")
    chunks, n = run.counters.get("image_chunks"), run.counters.get("restores")
    if not t or not chunks or not n:
        return None
    return roofline_share(n * sum(checksum_bytes(c) for c in chunks), t)
