"""The checksum kernels' (block sums and fold) share of their HBM
bound over the window's image: every payload chunk's bytes digested at
write (`flops.checksum_bytes`) at 3.35 TB/s, over their device time."""
from bench.flops import checksum_bytes, roofline_share
from bench.harness import kernel_seconds


def read(run):
    t = kernel_seconds(run, "block_sums_kernel", "fold_kernel")
    chunks = run.counters.get("image_chunks")
    if not t or not chunks or "image_bytes" not in run.counters:
        return None
    return roofline_share(sum(checksum_bytes(n) for n in chunks), t)
