"""The median over the window's steps of the device seconds of the
program's Mamba-2 mixers a step: the spans "mixer.mamba" (each forward,
its recompute under remat too) and "mixer.mamba.backward"."""
from bench.step_trace import median_step_device_s


def read(run):
    return median_step_device_s(run, "mixer.mamba", "mixer.mamba.backward")
