"""Driver of a job killed and restarted in place, over and over.

Set-up trains the first three steps and takes one image at the third
step's safe point, written before `run` returns.  The window then
repeats one cycle until it ends: close the runtime; build a fresh one
on the same directory (`MANARuntime(...)`, a new lower half); restore
the newest image onto the card (read, upload, digest verify, int8
decode); give it the job's batches again; train `steps_per_cycle` steps.
A recovery is the build and the restore, up to the restored state on
the card.  The image is read from the page cache, as after a process
restarted on its node.  Traffic parameters: `batch`, `seq`,
`quantize_moments`, `steps_per_cycle`.

End-to-end: `recover_s`, the mean over every recovery of the window.
Each restored state is fingerprinted on the card (`verify`) and, after
the window, held against the plain reader's decode of the image."""
from __future__ import annotations

import os
import statistics
import time

import torch

from bench import state as S
from bench import training as T
from bench.reference import image as ref_image


def setup(run) -> None:
    run.state["dir"] = os.path.join(run.workdir, "images")
    rt = T.build_runtime(run, run.state["dir"])
    T.first_steps(run, rt, image_at_end=True)
    run.state["rt"] = rt
    # the image's step, kept in host memory for the image check
    run.state["held"] = {k: v.to("cpu") for k, v in S.flat(rt.state).items()}
    run.state["image"] = rt.ckpt.step_dir(rt.ckpt.latest_step())
    T.count_image(run, run.state["image"])


def window(run) -> None:
    rt = run.state.pop("rt")
    t0 = time.perf_counter()
    deadline = t0 + run.seconds
    cycles = run.state["cycles"] = []
    prints = run.state["prints"] = []
    failed = 0
    while time.perf_counter() < deadline:
        run.span_start("runtime_build")
        rt.state = None
        rt.close()
        rt = None
        t_r = time.perf_counter()
        rt = T.build_runtime(run, run.state["dir"])
        run.span_end()
        run.span_start("restore")
        try:
            rt.restore()
        except Exception as e:      # a restore that fails is a failed request
            run.log(f"restore failed: {type(e).__name__}: {e}")
            failed += 1
            run.span_end()
            break
        rt.dataset = T.batches(run)
        if run.device.type == "cuda":
            torch.cuda.synchronize()
        run.recoveries.append(time.perf_counter() - t_r)
        run.span_end()
        run.span_start("verify")
        prints.append(ref_image.fingerprints(S.flat(rt.state)))
        run.span_end()
        losses = []
        clock = T.StepClock(run, deadline,
                            lambda step, m: losses.append(m["loss"]))
        rt.run(run.traffic["steps_per_cycle"], on_metrics=clock.on_metrics,
               stop_flag=clock.flag)
        clock.close()
        cycles.append(losses)
    if run.device.type == "cuda":
        torch.cuda.synchronize()
    run.window_s = time.perf_counter() - t0
    run.attempted = run.steps + len(run.recoveries) + failed
    run.failed = failed
    run.counters["restores"] = len(run.recoveries)
    took = {}
    for name, a, b in run.spans:
        took.setdefault(name, []).append(round((b - a) / 1e9, 4))
    run.log(f"recoveries: build s {took.get('runtime_build')}, restore s "
            f"{took.get('restore')}, verify s {took.get('verify')}")
    run.state["rt"] = rt


def end_to_end(run) -> dict:
    if not run.recoveries:
        return {}
    return {"recover_s": statistics.fmean(run.recoveries)}


def check(run) -> None:
    rt = run.state.pop("rt")
    rt.state = None
    rt.close()
    del rt
    held = run.state.pop("held")
    arrays = T.check_image(run, run.state["image"], held)
    del held
    run.check("restores_failed", run.failed, 0)
    # every restore bit for bit the plain reader's decode of the image
    want = ref_image.fingerprints(arrays)
    bad = [ref_image.differing(p, want) for p in run.state.pop("prints")]
    if any(bad):
        run.log(f"restored leaves unlike the image: "
                f"{next(b for b in bad if b)[:8]}")
    run.check("restores_differ", sum(1 for b in bad if b), 0)
    run.check("restores_none", 0 if bad else 1, 0)
    # the steps after each restore against the reference resumed from the
    # image as the plain reader decodes it
    n = max((len(c) for c in run.state["cycles"]), default=0)
    gap = float("nan")
    if n:
        ref = T.reference_resume(run, arrays, n)
        gap = max(T.loss_gap(c, ref["losses"][:len(c)])
                  for c in run.state["cycles"] if c)
        run.log(f"after restore: reference losses {ref['losses']}, first "
                f"cycle {run.state['cycles'][0]}")
        del ref
    del arrays
    run.check("restore_loss_gap", gap, run.limits["restore_loss_gap"])
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    T.check_first_steps(run)
