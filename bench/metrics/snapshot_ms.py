"""The device ms of the program's span "safe_point.snapshot" that took
the window's image: its device copies of the whole state
(`CheckpointManager.stats["snapshot_s"]` times only their launch)."""
from bench.program_trace import device_s, spans, window_image


def read(run):
    write = window_image(run)
    if write is None:
        return None
    snap = next((s for s in spans(run) if s["id"] == write["parent"]), None)
    t = device_s(snap) if snap is not None else None
    return None if t is None else 1e3 * t
