"""The median over the window's steps of the device seconds of the
mixers' SSD core a step: the spans "mixer.mamba.ssd" (forward and
recompute) and "mixer.mamba.ssd.backward"."""
from bench.step_trace import median_step_device_s


def read(run):
    return median_step_device_s(run, "mixer.mamba.ssd",
                                "mixer.mamba.ssd.backward")
