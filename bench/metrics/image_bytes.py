"""The program's own counter `CheckpointManager.stats[-1]["bytes"]`:
bytes the window's image put on storage."""


def read(run):
    b = run.counters.get("image_bytes")
    return None if b is None else float(b)
