"""Host seconds of the window's image's writer spans "image.encode"
(the codec of each leaf)."""
from bench.program_trace import image_host_s


def read(run):
    return image_host_s(run, "image.encode")
