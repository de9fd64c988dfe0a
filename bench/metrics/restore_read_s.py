"""The mean over the window's recoveries of the host seconds of the
program's spans "restore.read" (each chunk's file read) inside each
"restore"."""
from bench.program_trace import restore_host_s


def read(run):
    return restore_host_s(run, "restore.read")
