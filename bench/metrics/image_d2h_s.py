"""Host seconds of the window's image's writer spans "image.d2h"
(each chunk's copy to the host)."""
from bench.program_trace import image_host_s


def read(run):
    return image_host_s(run, "image.d2h")
