"""What the training drivers share: the program's runtime built from a
configuration file, the first three steps that set-up drives and the
reference follows, the state held at one safe point of the window, the
window's callbacks, and the comparisons of the program's steps, its
image and its restores with the plain reference.

The numbers compared (each beside its limit in `limits/<cell>.json`):
  loss_gap    the largest |program - reference| / reference of the
              first three steps' losses;
  grad_gap    the median leaf's gap between the program's and the
              reference's norm of the first clipped gradient (the
              program's worked out from its first moment after one step,
              m / (1 - beta1)), over the reference's norm of that leaf or
              of the median leaf, whichever is larger.  The worst leaf's
              gap (`grad_gap_worst`, printed, not compared) is the v
              projection's bias in most seeds, a 3,072-value leaf whose
              gradient, a sum over every position, swings tenfold from
              seed to seed;
  change_gap  the same of each leaf's change after three steps, over
              the leaves whose reference gradient is at least a
              thousandth of the median leaf's (the others, a key's bias
              under softmax, move by round-off alone under AdamW);
  resume_grad_gap, resume_change_gap
              the window's steps: the program's whole state is held at
              one safe point of the window (copied to host memory), and
              the reference resumes from it; the next step's gradient
              norms (the program's from its moments,
              (m' - beta1 m) / (1 - beta1)) and its change of each leaf
              (which the step's learning rate and bias corrections set)
              are compared as above.  Its loss gap is printed and not
              compared: the fp8 control and the half-batch fault read it
              at most 6.5 times the program's, too near for a limit.  The reference so follows the program from the
              program's own state: the first three steps check the start
              from the seed, and the held state is the one that the
              image (where there is one) is checked against bit for bit.
"""
from __future__ import annotations

import dataclasses
import os
import statistics
import time
from typing import Dict, List

import torch

from bench import state as S
from bench.flops import window
from bench.reference import image as ref_image
from bench.reference import model as ref_model

SEED_STEPS = 3      # set-up's steps, which the reference follows
RESUME_STEPS = 1    # the window's steps after the held state, likewise


# ---------------------------------------------------------------------------
# the program, as a user's job builds it
# ---------------------------------------------------------------------------

def program_config(config: dict, traffic: dict):
    """The port's (ModelConfig, RunConfig) holding the file's numbers."""
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import RunConfig, ShapeConfig

    r = config["run"]
    cfg = dataclasses.replace(
        ARCHS[r["arch"]], n_layers=config["num_hidden_layers"],
        d_model=config["hidden_size"], n_heads=config["num_attention_heads"],
        n_kv_heads=config["num_key_value_heads"],
        head_dim=config["head_dim"], d_ff=config["intermediate_size"],
        vocab_size=config["vocab_size"], qkv_bias=config["qkv_bias"],
        sliding_window=window(config), rope_theta=config["rope_theta"],
        tie_embeddings=config["tie_word_embeddings"],
        norm_eps=config["rms_norm_eps"], pad_to=r["pad_to"])
    rc = RunConfig(
        model=cfg, shape=ShapeConfig(traffic["name"], traffic["seq"],
                                     traffic["batch"], "train"),
        remat_policy=r["remat_policy"], loss_chunk=r["loss_chunk"],
        attn_chunk=r["attn_chunk"], dtype=r["dtype"], param_dtype=r["param_dtype"], lr=r["lr"],
        weight_decay=r["weight_decay"], beta1=r["beta1"], beta2=r["beta2"],
        grad_clip=r["grad_clip"])
    return cfg, rc


def build_runtime(run, ckpt_dir: str):
    from repro_torch.core.runtime import MANARuntime

    cfg, rc = program_config(run.config, run.traffic)
    return MANARuntime(cfg, rc, ckpt_dir=ckpt_dir,
                       quantize_moments=run.traffic.get("quantize_moments",
                                                        False),
                       device=run.device)


def warm_kernels(run) -> None:
    """Load the kernel libraries that an image write launches (on a
    checkout's first run, build them: seconds of nvcc) with one small
    call each, so that no build falls in the window."""
    if run.device.type != "cuda":
        return
    from repro_torch.kernels.checksum.ops import checksum
    from repro_torch.kernels.quantize.ops import dequantize, quantize

    x = torch.ones(4096, device=run.device)
    q, s, pad = quantize(x)
    checksum(q)
    dequantize(q, s, pad, x.shape)
    torch.cuda.synchronize()


def batches(run) -> S.TokenBatches:
    t = run.traffic
    return S.TokenBatches(run.config["vocab_size"], t["batch"], t["seq"],
                          run.seed)


def leaf_norms(tree, scale: float = 1.0) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.float())) * scale
            for k, v in S.flat(tree).items()}


def first_steps(run, rt, image_at_end: bool = False) -> None:
    """Give the runtime the benchmark's state and batches and drive its
    first three steps through `run` (the window's own call and feed);
    keep what the reference is compared with.  With `image_at_end` the
    third step's safe point takes an image, written before `run` returns."""
    from repro_torch.training.step import abstract_train_state

    cfg, rc = program_config(run.config, run.traffic)
    t0 = time.perf_counter()
    rt.state = S.make_train_state(run.config, run.seed, run.device)
    S.check_layout(rt.state, abstract_train_state(cfg, rc))
    t1 = time.perf_counter()
    rt.dataset = batches(run)
    b1 = run.config["run"]["beta1"]
    got = run.state.setdefault("program", {"losses": []})

    def on_metrics(step, metrics):
        got["losses"].append(metrics["loss"])
        if len(got["losses"]) == 1:
            got["grad"] = leaf_norms(rt.state["opt"]["m"], 1.0 / (1.0 - b1))
        if image_at_end and len(got["losses"]) == SEED_STEPS:
            rt.request_checkpoint()

    rt.run(SEED_STEPS, on_metrics=on_metrics)
    t2 = time.perf_counter()
    p0 = S.make_params(run.config, run.seed, run.device)
    now = S.flat(rt.state["params"])
    got["change"] = {k: float(torch.linalg.vector_norm(now[k] - p0["params/" + k]))
                     for k in now}
    del p0, now
    run.log(f"set-up: state made {t1 - t0:.3f} s, first {SEED_STEPS} steps"
            f"{' and the image' if image_at_end else ''} {t2 - t1:.3f} s, "
            f"change norms {time.perf_counter() - t2:.3f} s")


# ---------------------------------------------------------------------------
# the window
# ---------------------------------------------------------------------------

class Hold:
    """The program's whole state at one safe point of the window, for the
    reference to resume from, and what the program did after it.

    `reserve` sets host memory aside for the state at set-up (pinned on a
    card).  `take`, called from `on_metrics`, copies the state into it
    and waits for the copy (about 0.25 s for 6 GB on an H100's PCIe), so
    that no copy of the harness's overlaps the safe point or the image
    write that follow; `after`, called for the next step, keeps its loss,
    the norms of its clipped gradient from the moments and those of each
    leaf's change.  The state's leaves are referenced until then only:
    the step after the held one reads them anyway, so holding adds
    nothing to the device's peak."""

    def __init__(self, run, share: float):
        self.run, self.share = run, share
        self.host: Dict[str, torch.Tensor] = {}
        self.step = None        # the step index whose state is held
        self.losses: List[float] = []
        self.grad = self.change = None
        self._refs = None

    def reserve(self, rt) -> None:
        flat = S.flat(rt.state)
        cuda = self.run.device.type == "cuda"
        total = sum(v.numel() * v.element_size() for v in flat.values())
        buf = torch.empty(total, dtype=torch.uint8, pin_memory=cuda)
        o = 0
        for k, v in flat.items():
            n = v.numel() * v.element_size()
            self.host[k] = buf[o:o + n].view(v.dtype).view(v.shape)
            o += n

    def due(self, elapsed: float) -> bool:
        return self.step is None and elapsed >= self.share * self.run.seconds

    def take(self, rt, step: int) -> None:
        flat = S.flat(rt.state)
        for k, v in flat.items():
            self.host[k].copy_(v, non_blocking=True)
        if self.run.device.type == "cuda":
            torch.cuda.current_stream(self.run.device).synchronize()
        self._refs, self.step = flat, step

    def after(self, rt, metrics) -> None:
        if self.step is None or len(self.losses) >= RESUME_STEPS:
            return
        self.losses.append(metrics["loss"])
        b1 = self.run.config["run"]["beta1"]
        m, p = S.flat(rt.state["opt"]["m"]), S.flat(rt.state["params"])
        norm = torch.linalg.vector_norm
        self.grad = {k: norm(m[k] - b1 * self._refs["opt/m/" + k]) / (1 - b1)
                     for k in m}
        self.change = {k: norm(p[k] - self._refs["params/" + k]) for k in p}
        self._refs = None

    def waiting(self) -> bool:
        """True until the held state's later steps have all run."""
        return self.step is None or len(self.losses) < RESUME_STEPS

    def program(self) -> Dict:
        return {"losses": self.losses,
                "grad": {k: float(g) for k, g in (self.grad or {}).items()},
                "change": {k: float(c) for k, c in (self.change or {}).items()}}


class StepClock:
    """on_metrics and stop_flag for `MANARuntime.run` in the window: each
    step's interval (between two safe points), its tokens, and the host
    spans "step" (batch to metrics), "safe_point" (metrics to the next
    step) and "image_wait" (the last stop to `run`'s return).  The run
    stops at the first safe point past the deadline at which
    `keep_going()` is false."""

    def __init__(self, run, deadline: float, on_step=None, keep_going=None):
        self.run, self.deadline, self.on_step = run, deadline, on_step
        self.keep_going = keep_going or (lambda: False)
        self.tokens = run.traffic["batch"] * run.traffic["seq"]
        self.last = time.perf_counter()

    def flag(self) -> bool:
        self.run.span_end()
        if time.perf_counter() >= self.deadline and not self.keep_going():
            self.run.span_start("image_wait")
            return True
        self.run.span_start("step")
        return False

    def on_metrics(self, step, metrics) -> None:
        now = time.perf_counter()
        self.run.span_end()
        self.run.step_intervals.append(now - self.last)
        self.last = now
        self.run.steps += 1
        self.run.tokens += self.tokens
        if self.on_step is not None:
            self.on_step(step, metrics)
        self.run.span_start("safe_point")

    def close(self) -> None:
        self.run.span_end()


# ---------------------------------------------------------------------------
# the comparisons
# ---------------------------------------------------------------------------

def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep=None):
    """Each leaf's |prog - ref| over max(ref, median ref); a leaf missing
    on the program's side reads NaN."""
    med = statistics.median(ref.values())
    return {k: abs(prog.get(k, float("nan")) - r) / max(r, med)
            for k, r in ref.items() if keep is None or k in keep}


def worst(gaps: Dict[str, float]):
    """(largest gap, its leaf); a NaN is the worst."""
    out = (0.0, "")
    for k, g in gaps.items():
        if not g <= out[0]:
            out = (g, k)
    return out


def moved(ref_grad: Dict[str, float]) -> set:
    med = statistics.median(ref_grad.values())
    return {k for k, g in ref_grad.items() if g >= 1e-3 * med}


def loss_gap(prog: List[float], ref: List[float]) -> float:
    gaps = [abs(a - b) / abs(b) for a, b in zip(prog, ref)]
    return max(gaps) if len(prog) == len(ref) and gaps else float("nan")


def device_batches(run, steps) -> List[Dict[str, torch.Tensor]]:
    data = batches(run)
    return [{k: torch.from_numpy(v).to(run.device)
             for k, v in data.get_batch(s).items()} for s in steps]


def reference_first_steps(run, precision: str = "f32",
                          half: bool = False) -> Dict:
    """The reference's first three steps from the seed's params: losses,
    per-leaf norms of the first clipped gradient and of the change."""
    p0 = {k[len("params/"):]: v for k, v in
          S.make_params(run.config, run.seed, run.device).items()}
    ref = ref_model.train(run.config, p0, device_batches(run, range(SEED_STEPS)),
                          precision=precision, half=half)
    out = {"losses": ref["losses"],
           "grad": {k: float(torch.linalg.vector_norm(g))
                    for k, g in ref["first_grads"].items()},
           "change": {k: float(torch.linalg.vector_norm(ref["params"][k]
                                                        - p0[k]))
                      for k in p0}}
    del ref, p0
    return out


def gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The three numbers of the first steps (see the module's doc), with
    the worst leaves."""
    grad = leaf_gaps(prog["grad"], ref["grad"])
    g_worst, g_leaf = worst(grad)
    c, c_leaf = worst(leaf_gaps(prog["change"], ref["change"],
                                moved(ref["grad"])))
    med = (float("nan") if any(g != g for g in grad.values())
           else statistics.median(grad.values()))
    return {"loss_gap": loss_gap(prog["losses"], ref["losses"]),
            "grad_gap": med,
            "change_gap": c, "grad_gap_worst": g_worst, "grad_leaf": g_leaf,
            "change_leaf": c_leaf}


def check_first_steps(run) -> None:
    prog = run.state["program"]
    g = gaps(prog, reference_first_steps(run))
    run.log(f"first steps: losses {prog['losses']}; worst grad leaf "
            f"{g['grad_leaf']} {g['grad_gap_worst']!r}, worst change leaf "
            f"{g['change_leaf']}")
    for name in ("loss_gap", "grad_gap", "change_gap"):
        run.check(name, g[name], run.limits[name])


def on_device(run, flat: Dict[str, torch.Tensor]):
    """A held (host) state's params, moments, count and step on the card,
    as the reference takes them."""
    d = {k: v.to(run.device) for k, v in flat.items()}
    pre = "params/"
    params = {k[len(pre):]: v for k, v in d.items() if k.startswith(pre)}
    return {"params": params, "m": {k: d["opt/m/" + k] for k in params},
            "v": {k: d["opt/v/" + k] for k in params},
            "count": int(d["opt/count"]), "step": int(d["step"])}


def reference_resume(run, flat: Dict[str, torch.Tensor], steps: int,
                     precision: str = "f32", half: bool = False) -> Dict:
    """The reference resumed from a state (flat paths, any device) for
    `steps` steps: losses, per-leaf norms of the first clipped gradient
    and of each leaf's change over the steps."""
    st = on_device(run, flat)
    ref = ref_model.train(run.config, st["params"],
                          device_batches(run, range(st["step"],
                                                    st["step"] + steps)),
                          first_step=st["step"], m=st["m"], v=st["v"],
                          count=st["count"], precision=precision, half=half)
    norm = torch.linalg.vector_norm
    out = {"losses": ref["losses"],
           "grad": {k: float(norm(g)) for k, g in ref["first_grads"].items()},
           "change": {k: float(norm(ref["params"][k] - p))
                      for k, p in st["params"].items()}}
    del ref, st
    return out


def resume_gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers of the step after the held state, named resume_*."""
    return {"resume_" + k: v for k, v in gaps(prog, ref).items()}


def check_resume(run, hold: Hold) -> None:
    """The window's steps after the held state against the reference
    resumed from it."""
    prog = hold.program()
    if hold.step is None or len(prog["losses"]) < RESUME_STEPS:
        run.check("resume_missing", 1, 0)
        return
    g = resume_gaps(prog, reference_resume(run, hold.host, RESUME_STEPS))
    run.log(f"resume from the state after step {hold.step}: losses "
            f"{prog['losses']}, gap {g['resume_loss_gap']!r} (not compared: "
            f"neither the control nor a fault reads far enough above it); "
            f"worst grad leaf {g['resume_grad_leaf']} "
            f"{g['resume_grad_gap_worst']!r}, worst change leaf "
            f"{g['resume_change_leaf']}")
    for name in ("resume_grad_gap", "resume_change_gap"):
        run.check(name, g[name], run.limits[name])


def check_image(run, step_dir: str, held: Dict[str, torch.Tensor]) -> Dict:
    """The committed image read by the plain reader: every chunk's digest
    against the manifest, every raw leaf bit for bit against the state
    it was taken from (`held`, on any device), every int8 leaf within
    half its block's scale.  Returns the decoded arrays."""
    arrays, coded, extra, report = ref_image.read_image(step_dir, run.device)
    run.log(f"image {step_dir}: {report['chunks']} chunks, "
            f"{report['bytes']} bytes, data {extra.get('data')}")
    run.check("image_digests_bad", len(report["bad_digests"]), 0)
    differ = sorted(set(arrays) ^ set(held))
    err = float("nan")
    for k in sorted(set(arrays) & set(held)):
        h = held[k].to(run.device)
        if k in coded:
            e = ref_image.quantization_error(h, coded[k])
            err = e if not err >= e else err
        elif not torch.equal(arrays[k], h):
            differ.append(k)
        del h
    if differ:
        run.log(f"image leaves that differ: {differ[:8]}")
    run.check("image_raw_differ", len(differ), 0)
    run.check("image_int8_err", err, run.limits["image_int8_err"])
    return arrays


def count_image(run, step_dir: str) -> None:
    """The image's chunk sizes and its int8 arrays' lengths, from its
    manifest: what the write and restore kernels had to move."""
    import json
    import math

    with open(os.path.join(step_dir, "manifest.json")) as f:
        man = json.load(f)
    run.counters["image_chunks"] = [fm["nbytes"] for e in man["arrays"].values()
                                    for fm in e["files"]]
    run.counters["image_int8_values"] = [
        math.prod(e["shape"]) for e in man["arrays"].values()
        if e["encoding"] == "int8_block"]
