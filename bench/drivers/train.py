"""Driver of a closed-loop training job: the configuration's model
trained through `MANARuntime.run` for the whole window, its safe point
passed every step.  Traffic parameters: `batch`, `seq`,
`quantize_moments` (the image codec stack), `hold_at` (the share of the
window after which the first safe point's state is held for the
reference to resume from) and `image`: where true, that safe point also
takes one image (from `on_metrics`), written by the manager's writer
thread while training goes on; the window ends when `run` returns, the
image committed.

End-to-end: `train_tokens_per_s`, the tokens of every step completed in
the window over the window."""
from __future__ import annotations

import os
import time

import torch

from bench import training as T


def setup(run) -> None:
    run.state["dir"] = os.path.join(run.workdir, "images")
    rt = T.build_runtime(run, run.state["dir"])
    T.first_steps(run, rt)
    if run.traffic.get("image"):
        T.warm_kernels(run)
    hold = T.Hold(run, run.traffic["hold_at"])
    hold.reserve(rt)
    run.state.update(rt=rt, hold=hold)


def window(run) -> None:
    rt, hold = run.state["rt"], run.state["hold"]
    image = bool(run.traffic.get("image"))
    taken = run.state["taken"] = {}
    t0 = time.perf_counter()

    def on_step(step, metrics):
        if hold.due(time.perf_counter() - t0):
            run.span_start("hold")
            hold.take(rt, step)
            run.span_end()
            if image:
                rt.request_checkpoint()
                taken["count"] = rt.checkpoints_taken
        else:
            hold.after(rt, metrics)

    clock = T.StepClock(run, t0 + run.seconds, on_step, hold.waiting)
    clock.last = t0

    def stop_flag():
        if ("count" in taken and "stall_s" not in taken
                and rt.checkpoints_taken > taken["count"]):
            taken["stall_s"] = rt.agent.last_commit_stall_s
        return clock.flag()

    rt.run(10 ** 9, on_metrics=clock.on_metrics, stop_flag=stop_flag)
    if run.device.type == "cuda":
        torch.cuda.synchronize()
    run.window_s = time.perf_counter() - t0
    clock.close()
    run.attempted, run.failed = run.steps, 0
    run.log(f"window: {run.steps} steps, intervals s "
            f"{[round(t, 3) for t in run.step_intervals]}")
    if "stall_s" in taken:
        run.counters["commit_stall_s"] = taken["stall_s"]
    if image and rt.ckpt.stats:
        st = rt.ckpt.stats[-1]
        run.log(f"image step {st['step']}: snapshot_s {st['snapshot_s']}, "
                f"write_s {st['write_s']}, bytes {st['bytes']}, commit "
                f"stall_s {taken.get('stall_s')}")
        run.counters.update(image_write_s=st["write_s"],
                            image_bytes=st["bytes"],
                            snapshot_s=st["snapshot_s"])
        T.count_image(run, rt.ckpt.step_dir(st["step"]))


def end_to_end(run) -> dict:
    return {"train_tokens_per_s": run.tokens / run.window_s}


def check(run) -> None:
    rt, hold = run.state.pop("rt"), run.state.pop("hold")
    if run.traffic.get("image"):
        steps = rt.ckpt.steps()
        if not steps or hold.step is None:
            run.check("image_missing", 1, 0)
        else:
            arrays = T.check_image(run, rt.ckpt.step_dir(steps[-1]),
                                   hold.host)
            del arrays
    rt.state = None
    rt.close()
    del rt
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    T.check_resume(run, hold)
    del hold
    T.check_first_steps(run)
