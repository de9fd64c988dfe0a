"""Host seconds of the window's image's writer spans "image.digest"
(each chunk's digest, read back)."""
from bench.program_trace import image_host_s


def read(run):
    return image_host_s(run, "image.digest")
