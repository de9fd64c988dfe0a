"""The program's own counter `RankAgent.last_commit_stall_s` at the
safe point that took the window's image, in milliseconds."""


def read(run):
    s = run.counters.get("commit_stall_s")
    return None if s is None else 1000.0 * s
