"""How long the image writer's synchronising calls waited behind work
queued before them: the sum over the window's image's "image.digest"
and "image.d2h" spans of max(0, device start - host start), seconds."""
from bench.program_trace import descendants, spans, window_image


def read(run):
    write = window_image(run)
    if write is None:
        return None
    waits = [max(0, s["dev_start_ns"] - s["start_ns"])
             for s in descendants(spans(run), write)
             if s["name"] in ("image.digest", "image.d2h")
             and s["dev_start_ns"] is not None]
    return sum(waits) / 1e9 if waits else None
