"""Model FLOPs of the window's steps of a `layer_types` hybrid
(`hybrid_flops.train_step_flops` from the configuration's shapes;
recompute not counted) over the window's seconds at one H100's dense
bf16 peak, in percent."""
from bench.flops import PEAK_BF16_FLOPS
from bench.hybrid_flops import train_step_flops


def read(run):
    if not run.steps:
        return None
    t = run.traffic
    flops = run.steps * train_step_flops(run.config, t["batch"], t["seq"])
    return 100.0 * flops / (run.window_s * PEAK_BF16_FLOPS)
