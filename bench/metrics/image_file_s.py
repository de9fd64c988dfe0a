"""Host seconds of the window's image's writer spans "image.file" (each
chunk's file write) and "image.commit" (the manifest and the atomic
rename)."""
from bench.program_trace import image_host_s


def read(run):
    return image_host_s(run, "image.file", "image.commit")
