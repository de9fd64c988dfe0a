"""MANARuntime: the paper's technique as a first-class training feature,
port of `repro.core.runtime` on PyTorch.

Ties together: hybrid-2PC coordinator + rank agent (interposition),
drain, async checkpoint images on the card, restart, preemption signals.

The training loop only ever sees (state, batch) -> state functions; all
checkpoint machinery interposes at the step boundary — the analogue of
MANA wrapping MPI calls, transparent to the "application" (the model
code).

Checkpoint triggers (any may fire):
  * every N steps            (chained-allocation use case, §I)
  * every T wall-clock secs  (operational checkpointing)
  * SIGUSR1                  (preemption notice)
  * explicit request_checkpoint()
"""
from __future__ import annotations

import signal
import time
import weakref
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch import resolve_device, trace
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.checkpoint import CheckpointManager
from repro_torch.core.control import make_control_plane
from repro_torch.core.split_state import LowerHalf
from repro_torch.core.two_phase_commit import RankAgent
from repro_torch.data.pipeline import SyntheticDataset
from repro_torch.sharding.rules import placements
from repro_torch.training.step import abstract_params, init_train_state
from repro_torch.tree import tree_map


def _local(x):
    """A replicated DTensor's local tensor; any other tensor as it is."""
    return x.to_local() if hasattr(x, "to_local") else x


def _full(x):
    """A DTensor's full value (a collective of its mesh); any other
    tensor as it is."""
    return x.full_tensor() if hasattr(x, "full_tensor") else x


class MANARuntime:
    """Checkpointed training runtime: the paper's machinery fronting a
    PyTorch training job on one device.

    The training loop (`run`) only sees (state, batch) -> state
    functions; the 2PC agent interposes at step boundaries (safe
    points), the `CheckpointManager` writes digest-verified images on
    the card (with the codec stack: int8 moments via
    `quantize_moments`, XOR-delta params via `delta_params`), and
    `restore` maps an image back in — over any transport.

    Construction wires a single-rank world with a WIRE coordinator (the
    same protocol a thousand-rank socket job uses):

    >>> import tempfile
    >>> from repro_torch.configs import ARCHS, reduced_config
    >>> from repro_torch.configs.base import RunConfig, ShapeConfig
    >>> cfg = reduced_config(ARCHS["qwen2-0.5b"])
    >>> rc = RunConfig(model=cfg, shape=ShapeConfig("doc", 64, 2, "train"))
    >>> rt = MANARuntime(cfg, rc, ckpt_dir=tempfile.mkdtemp(),
    ...                  ckpt_every_steps=2, device="cpu")
    >>> rt.ckpt.steps()          # fresh directory: nothing committed yet
    []
    >>> rt.close()

    Keywords are the reference's plus `device` (None: "cuda", raising
    when CUDA is absent), less `use_pallas`: the device selects the
    kernels.  `mesh` (a `DeviceMesh` on `device`'s type, e.g. from
    `repro_torch.launch.mesh.make_mesh`; every rank of it runs this
    runtime in step) places the state's leaves as DTensors by the spec
    tree and splits each batch over the data axes; the dense decoder,
    MoE, hybrid-SSM and RWKV-6 families train on a mesh.  With
    `async_ckpt=True` the agent runs the asynchronous 2PC split on the
    thread writer.  The runtime sets no process-wide switch: a resume
    repeats the uninterrupted run bit for bit on the card without
    `torch.use_deterministic_algorithms` (the embedding backward, the
    model's one op that added with atomics, sums in a fixed order).
    """

    def __init__(self, cfg: ModelConfig, rc: RunConfig, *, ckpt_dir: str,
                 mesh=None, mode: str = "hybrid",
                 ckpt_every_steps: Optional[int] = None,
                 ckpt_every_secs: Optional[float] = None,
                 keep: int = 3, quantize_moments: bool = False,
                 delta_params: bool = False, seed: int = 0,
                 install_signal_handler: bool = False,
                 transport: str = "inproc", fault_plan=None,
                 async_ckpt: bool = False, device=None):
        self.device = resolve_device(device)
        self.cfg, self.rc = cfg, rc
        self.seed = seed
        # lower half: rebuilt at restart — including the comm world, so
        # a checkpoint taken over one transport restores over another
        self.lower = LowerHalf.build(cfg, rc, mesh, transport=transport,
                                     fault_plan=fault_plan)
        _, self.logical = abstract_params(cfg)
        self.dataset = SyntheticDataset(cfg, rc.shape, seed=seed)
        self.ckpt = CheckpointManager(
            ckpt_dir, keep=keep,
            quantize_keys=("opt/m", "opt/v") if quantize_moments else (),
            delta_keys=("params",) if delta_params else (),
            device=self.device)
        # protocol plane (1 real rank; protocol is rank-agnostic).  The
        # coordinator is an ENDPOINT on the fabric, not a shared object:
        # the runtime talks to it through the same wire protocol a
        # thousand-rank socket job would use (repro_torch.core.control).
        self.fabric = self.lower.comm
        self.coord_server, clients = make_control_plane(self.fabric)
        self.coord = clients[0]
        self.agent = RankAgent(0, self.fabric.endpoints[0], self.coord,
                               [0], mode=mode, transport=transport,
                               async_commit=async_ckpt)
        # server thread + sockets die with the runtime even if close()
        # is never called (tests churn through many runtimes)
        self._finalizer = weakref.finalize(
            self, MANARuntime._teardown, self.coord_server, self.fabric)
        self.ckpt_every_steps = ckpt_every_steps
        self.ckpt_every_secs = ckpt_every_secs
        self._last_ckpt_time = time.monotonic()
        self.state: Any = None
        self.history: List[Dict] = []
        self.checkpoints_taken = 0
        # the handler only sets a flag: requesting a checkpoint is now a
        # WIRE call (send + blocking reply on this rank's endpoint), and
        # a signal landing while the main thread holds that endpoint's
        # lock would self-deadlock if the handler called it directly
        self._preempted = False
        # the handler it replaced, put back by close() (None: not installed)
        self._prev_sigusr1 = None
        if install_signal_handler:
            prev = signal.signal(signal.SIGUSR1,
                                 lambda *_: setattr(self, "_preempted", True))
            self._prev_sigusr1 = signal.SIG_DFL if prev is None else prev

    # ---- lifecycle -----------------------------------------------------------
    def initialize(self) -> None:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed)
        self.state = init_train_state(self.cfg, self.rc, gen, self.device)
        if self.lower.mesh is not None:
            from torch.distributed.tensor import distribute_tensor

            mesh = self.lower.mesh
            self.state = tree_map(
                lambda x, sp: distribute_tensor(
                    x, mesh, placements(sp, mesh, x.shape)),
                self.state, self.lower.state_specs)

    def restore(self, step: Optional[int] = None) -> int:
        """Elastic restart: map the upper half back in onto THIS lower
        half (which may have a different mesh shape, or none, or run a
        different transport than the writer's)."""
        with trace.when_profiled():
            state, extra = self.ckpt.restore(
                step, mesh=self.lower.mesh, specs=self.lower.state_specs)
        self.state = state
        meta = extra.get("run_meta", {})
        if meta.get("arch") and meta["arch"] != self.cfg.arch_id:
            raise ValueError(
                f"checkpoint is for arch {meta['arch']}, not {self.cfg.arch_id}")
        self.dataset = SyntheticDataset.from_state(
            self.cfg, self.rc.shape, extra["data"])
        return int(extra["data"]["step"])

    def request_checkpoint(self) -> None:
        self.coord.request_checkpoint()

    @staticmethod
    def _teardown(server, fabric) -> None:
        # GC-safe: signal the serve loop without joining (it exits
        # within its recv timeout) and release backend resources
        server.stop(timeout=0)
        fabric.close()

    def close(self) -> None:
        """Tear down the lower half's physical comm resources (sockets,
        server thread), which also happens when the runtime is
        garbage-collected, and put back the SIGUSR1 handler that
        `install_signal_handler` replaced."""
        if self._prev_sigusr1 is not None:
            signal.signal(signal.SIGUSR1, self._prev_sigusr1)
            self._prev_sigusr1 = None
        self._finalizer()

    # ---- snapshot (phase-2 payload) --------------------------------------------
    def _snapshot(self) -> None:
        with trace.span("safe_point.snapshot", device=True) as sp:
            step = int(_local(self.state["step"]))
            sp.set(step=step)
            extra = {
                "data": self.dataset.state_dict(step),
                "agent": self.agent.serialize(),
                "run_meta": {"arch": self.cfg.arch_id,
                             "shape": self.rc.shape.name,
                             "seed": self.seed},
            }
            self.ckpt.save_async(step, self.state, self.logical, extra)
        self.checkpoints_taken += 1

    # ---- the loop -----------------------------------------------------------------
    def _split_batch(self, batch):
        """Every rank made the whole batch (a pure function of (seed,
        step)); each keeps its slice of the leading dim over the mesh's
        data axes, as the shape-aware batch spec places it (a batch the
        data axes do not divide is replicated)."""
        from torch.distributed.tensor import distribute_tensor

        mesh, rules = self.lower.mesh, self.lower.rules
        return {k: distribute_tensor(
            v, mesh, rules.named(("batch",) + (None,) * (v.ndim - 1),
                                 v.shape).placements,
            src_data_rank=None) for k, v in batch.items()}

    def _maybe_trigger(self, step: int) -> None:
        if self._preempted:  # SIGUSR1 landed since the last boundary
            self._preempted = False
            self.request_checkpoint()
        elif (self.ckpt_every_steps and step > 0
                and step % self.ckpt_every_steps == 0):
            self.request_checkpoint()
        elif (self.ckpt_every_secs is not None
              and time.monotonic() - self._last_ckpt_time
              >= self.ckpt_every_secs):
            self.request_checkpoint()

    def run(self, num_steps: int,
            on_metrics: Optional[Callable[[int, Dict], None]] = None,
            stop_flag: Optional[Callable[[], bool]] = None) -> List[Dict]:
        """Train up to `num_steps` steps, passing the safe point after
        each; `on_metrics(step, metrics)` after each step, `stop_flag()`
        before each.  Spans (`repro_torch.trace`): one "step" a
        iteration, holding "step.batch" (the step index read back, the
        batch made and uploaded), the train step's own, "step.metrics"
        (the metrics read back), "step.callback" (each call of the
        caller's functions) and "safe_point"."""
        assert self.state is not None, "initialize() or restore() first"
        with trace.when_profiled():
            for _ in range(num_steps):
                with trace.span("step") as sp:
                    if not self._iteration(sp, on_metrics, stop_flag):
                        break
            self.agent.drain_writer()  # async mode: writer acks owed first
            self.ckpt.wait()
        return self.history

    def _iteration(self, sp, on_metrics, stop_flag) -> bool:
        """One step of `run` and its safe point; False where `stop_flag`
        ended the run first."""
        with trace.span("step.batch"):
            step = int(_local(self.state["step"]))
            sp.set(step=step)
        if stop_flag is not None:
            with trace.span("step.callback"):
                if stop_flag():
                    return False
        with trace.span("step.batch"):
            batch = self.dataset.get_batch(step)
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in batch.items()}
            if self.lower.mesh is not None:
                batch = self._split_batch(batch)
        self.state, metrics = self.lower.train_step(self.state, batch)
        with trace.span("step.metrics"):
            metrics = {k: float(_full(v)) for k, v in metrics.items()}
        metrics["step"] = step
        self.history.append(metrics)
        if on_metrics is not None:
            with trace.span("step.callback"):
                on_metrics(step, metrics)
        # MANA safe point: step boundary (outside any dispatch)
        with trace.span("safe_point"):
            self._maybe_trigger(step + 1)
            if self.agent.safe_point(self._snapshot):
                self._last_ckpt_time = time.monotonic()
        return True
