"""The median over the window's steps of the device seconds of the
program's span "step.backward" (the gradients, recompute included)."""
from bench.program_trace import median_device_s


def read(run):
    return median_device_s(run, "step.backward")
