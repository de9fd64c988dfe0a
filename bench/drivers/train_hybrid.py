"""Driver of a closed-loop training job of a `layer_types` hybrid
(granite-4.0-h): as `train`, with the hybrid's own program
configuration, seeded state (`bench.hybrid_state`) and plain reference
(`bench.reference.hybrid`).  The window, the held state, the image and
the comparisons are `bench.training`'s.  Traffic parameters: `batch`,
`seq`, `quantize_moments`, `hold_at` and `image`, as `train`'s.

End-to-end: `train_tokens_per_s`, the tokens of every step completed in
the window over the window."""
from __future__ import annotations

import dataclasses
import os
import time

import torch

from bench import hybrid_state as HS
from bench import state as S
from bench import training as T
from bench.drivers.train import end_to_end, window  # noqa: F401
from bench.reference import hybrid as ref_hybrid


def program_config(config: dict, traffic: dict):
    """The port's (ModelConfig, RunConfig) holding the file's numbers."""
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import RunConfig, ShapeConfig

    r = config["run"]
    z = HS.dims(config)
    cfg = dataclasses.replace(
        ARCHS[r["arch"]], n_layers=config["num_hidden_layers"],
        layer_types=tuple(config["layer_types"]), d_model=z["d"],
        n_heads=config["num_attention_heads"],
        n_kv_heads=config["num_key_value_heads"], head_dim=z["hd"],
        d_ff=z["f"], vocab_size=config["vocab_size"],
        qkv_bias=config["attention_bias"], mamba_heads=z["nh"],
        mamba_head_dim=z["P"], mamba_state=z["N"], mamba_groups=z["G"],
        mamba_conv=z["W"], mamba_chunk=r["ssd_chunk"],
        rope=config["position_embedding_type"] != "nope",
        rope_theta=config["rope_theta"],
        embedding_multiplier=config["embedding_multiplier"],
        attention_multiplier=config["attention_multiplier"],
        residual_multiplier=config["residual_multiplier"],
        logits_scaling=config["logits_scaling"],
        tie_embeddings=config["tie_word_embeddings"],
        norm_eps=config["rms_norm_eps"], pad_to=r["pad_to"])
    rc = RunConfig(
        model=cfg, shape=ShapeConfig(traffic["name"], traffic["seq"],
                                     traffic["batch"], "train"),
        remat_policy=r["remat_policy"], loss_chunk=r["loss_chunk"],
        attn_chunk=r["attn_chunk"], dtype=r["dtype"],
        param_dtype=r["param_dtype"], lr=r["lr"],
        weight_decay=r["weight_decay"], beta1=r["beta1"], beta2=r["beta2"],
        grad_clip=r["grad_clip"])
    return cfg, rc


def first_steps(run, rt) -> None:
    """`bench.training.first_steps` for the hybrid's state: the first
    three steps through `rt.run`, keeping what the reference is compared
    with."""
    from repro_torch.training.step import abstract_train_state

    cfg, rc = program_config(run.config, run.traffic)
    t0 = time.perf_counter()
    rt.state = HS.make_train_state(run.config, run.seed, run.device)
    S.check_layout(rt.state, abstract_train_state(cfg, rc))
    t1 = time.perf_counter()
    rt.dataset = T.batches(run)
    b1 = run.config["run"]["beta1"]
    got = run.state.setdefault("program", {"losses": []})

    def on_metrics(step, metrics):
        got["losses"].append(metrics["loss"])
        if len(got["losses"]) == 1:
            got["grad"] = T.leaf_norms(rt.state["opt"]["m"], 1.0 / (1.0 - b1))

    rt.run(T.SEED_STEPS, on_metrics=on_metrics)
    t2 = time.perf_counter()
    p0 = HS.make_params(run.config, run.seed, run.device)
    now = S.flat(rt.state["params"])
    got["change"] = {k: float(torch.linalg.vector_norm(now[k] - p0["params/" + k]))
                     for k in now}
    del p0, now
    run.log(f"set-up: state made {t1 - t0:.3f} s, first {T.SEED_STEPS} "
            f"steps {t2 - t1:.3f} s, change norms {time.perf_counter() - t2:.3f} s")


def reference_first_steps(run, precision: str = "f32",
                          half: bool = False) -> dict:
    """The reference's first three steps from the seed's params."""
    p0 = {k[len("params/"):]: v for k, v in
          HS.make_params(run.config, run.seed, run.device).items()}
    ref = ref_hybrid.train(run.config, p0,
                           T.device_batches(run, range(T.SEED_STEPS)),
                           precision=precision, half=half)
    norm = torch.linalg.vector_norm
    out = {"losses": ref["losses"],
           "grad": {k: float(norm(g)) for k, g in ref["first_grads"].items()},
           "change": {k: float(norm(ref["params"][k] - p0[k])) for k in p0}}
    del ref, p0
    return out


def reference_resume(run, flat, steps: int, precision: str = "f32",
                     half: bool = False) -> dict:
    """The reference resumed from a held state for `steps` steps."""
    st = T.on_device(run, flat)
    ref = ref_hybrid.train(run.config, st["params"],
                           T.device_batches(run, range(st["step"],
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


def setup(run) -> None:
    from repro_torch.core.runtime import MANARuntime

    cfg, rc = program_config(run.config, run.traffic)
    run.state["dir"] = os.path.join(run.workdir, "images")
    rt = MANARuntime(cfg, rc, ckpt_dir=run.state["dir"],
                     quantize_moments=run.traffic.get("quantize_moments",
                                                      False),
                     device=run.device)
    first_steps(run, rt)
    if run.traffic.get("image"):
        T.warm_kernels(run)
    hold = T.Hold(run, run.traffic["hold_at"])
    hold.reserve(rt)
    run.state.update(rt=rt, hold=hold)


def check(run) -> None:
    rt, hold = run.state.pop("rt"), run.state.pop("hold")
    if run.traffic.get("image"):
        steps = rt.ckpt.steps()
        if not steps or hold.step is None:
            run.check("image_missing", 1, 0)
        else:
            T.check_image(run, rt.ckpt.step_dir(steps[-1]), hold.host)
    rt.state = None
    rt.close()
    del rt
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    prog = hold.program()
    if hold.step is None or len(prog["losses"]) < T.RESUME_STEPS:
        run.check("resume_missing", 1, 0)
    else:
        g = T.resume_gaps(prog, reference_resume(run, hold.host,
                                                 T.RESUME_STEPS))
        run.log(f"resume from the state after step {hold.step}: losses "
                f"{prog['losses']}, gap {g['resume_loss_gap']!r} (not "
                f"compared); worst grad leaf {g['resume_grad_leaf']} "
                f"{g['resume_grad_gap_worst']!r}, worst change leaf "
                f"{g['resume_change_leaf']}")
        for name in ("resume_grad_gap", "resume_change_gap"):
            run.check(name, g[name], run.limits[name])
    del hold
    prog = run.state["program"]
    g = T.gaps(prog, reference_first_steps(run))
    run.log(f"first steps: losses {prog['losses']}; worst grad leaf "
            f"{g['grad_leaf']} {g['grad_gap_worst']!r}, worst change leaf "
            f"{g['change_leaf']}")
    for name in ("loss_gap", "grad_gap", "change_gap"):
        run.check(name, g[name], run.limits[name])
