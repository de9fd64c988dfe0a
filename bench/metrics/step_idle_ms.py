"""The mean over the window's steps of the device's idle ms inside the
program's span "step", less its "step.callback" spans (the caller's own
functions).  Also logs the window's device idle seconds by the
innermost program span open (`program_trace.idle_by_span`)."""
from bench.program_trace import idle_by_span, step_idle_ms


def read(run):
    table = idle_by_span(run)
    if table:
        run.log("device idle s by program span: " + ", ".join(
            f"{name} {s:.6f}" for name, s in table.items()))
    return step_idle_ms(run)
