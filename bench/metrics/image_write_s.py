"""The program's own counter `CheckpointManager.stats[-1]["write_s"]`:
seconds the writer thread took for the window's image."""


def read(run):
    return run.counters.get("image_write_s")
