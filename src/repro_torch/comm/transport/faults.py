"""Deterministic, seeded fault injection for the transport layer.

MANA-2.0's reliability story (and the companion NERSC production paper,
arXiv:2103.08546) is about *surviving* failures: ranks die, messages
arrive late, and the checkpoint-restart machinery must turn that into
bounded lost work instead of a hang.  This module is the fault MODEL:
a `FaultPlan` is installed on a transport world (any backend) and acts
at the backend-agnostic `Endpoint.send` boundary, so the same plan
produces the same faults whether ranks are threads (`inproc`) or OS
processes over TCP (`socket`).

What can be injected:

  * kill   — `RankKilled` raised inside a rank, either at its Nth
             application send (`after_sends`) or at a step boundary
             (`at_step`, via the app calling `plan.on_step`), optionally
             gated on a checkpoint being pending (`when_pending=True` —
             the mid-phase-1 kill).
  * drop   — a message is accounted (byte counters advance: it "left
             the NIC") but never delivered.  The §III-B drain detects
             the deficit and the checkpoint aborts instead of hanging.
  * delay  — delivery of a message is deferred by a seeded duration.
             Per-sender FIFO is preserved (a delayed message blocks the
             sender's later traffic behind it, like a slow in-order
             link), so every fabric-contract guarantee — and the
             virtual-time occupancy model — is delay-invariant.
  * dup    — the message is delivered twice.  The fabric does NOT
             deduplicate; duplication is visible to the app (used to
             prove the injector acts at the wire, not above it).
  * HELLO delay — socket backend only: a rank joins the rendezvous
             switch late, exercising the pre-join queue-flush path.

Determinism: every per-message decision is a pure function of
(seed, rule index, sender rank, sender's app-send sequence number), so
a failing chaos seed reproduces exactly on either backend regardless of
thread/process scheduling — provided the application's own send
sequence is deterministic (the chaos suite's jobs are).

Control-plane traffic (tags at or below `CTRL_BASE`) is NEVER
fault-injected and does not advance the send sequence: coordinator
retries and intent pushes are timing-dependent, and counting them
would destroy cross-run determinism.  Control-plane *failure* is
modeled at the right layer instead — rank death (EOF at the switch,
missed heartbeats; see `repro_torch.core.control`).
"""
from __future__ import annotations

import random
import threading
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional


class RankKilled(RuntimeError):
    """Raised inside a rank when its FaultPlan kill point fires.

    The world harness treats it as a crash, not an application error:
    the socket backend hard-exits the rank process (no goodbye, no
    result — the switch sees a raw EOF), and the inproc harness reports
    the thread's death to the coordinator server, so both backends
    exercise the same detection path a real node failure would.
    """

    def __init__(self, rank: int, where: str):
        super().__init__(f"rank {rank} killed by fault injection ({where})")
        self.rank = rank
        self.where = where


@dataclass
class SendDecision:
    """Outcome of consulting the plan for one application send."""
    action: str = "deliver"        # "deliver" | "drop" | "dup" | "delay"
    delay_s: float = 0.0


_DELIVER = SendDecision()


@dataclass
class _MessageRule:
    kind: str                      # "drop" | "dup" | "delay"
    src: Optional[int]
    dst: Optional[int]
    tag: Optional[int]
    prob: float
    max_delay_s: float = 0.0

    def matches(self, src: int, dst: int, tag: int) -> bool:
        return ((self.src is None or self.src == src)
                and (self.dst is None or self.dst == dst)
                and (self.tag is None or self.tag == tag))


@dataclass
class _KillRule:
    rank: int
    after_sends: Optional[int] = None
    at_step: Optional[int] = None
    when_pending: bool = False
    fired: bool = False


@dataclass
class _StraggleRule:
    rank: int
    at_step: int
    seconds: float
    when_pending: bool = False
    fired: bool = False


class FaultPlan:
    """A deterministic schedule of injected faults for one world attempt.

    Build one per run attempt (the supervisor builds a fresh plan per
    restart), install it via `create_world(..., fault_plan=...)` or
    `run_world(..., faults=...)`, and drive step-indexed faults by
    calling `on_step` at step boundaries (the world harness exposes the
    plan as `ctx.faults`).

    Rules compose fluently and every per-message decision is a pure
    function of (seed, rule, sender, app-send index):

    >>> plan = FaultPlan(seed=7).kill(3, at_step=5).drop(src=0, dst=1)
    >>> plan.decide(0, 1, tag=0, send_idx=0).action   # rule matches
    'drop'
    >>> plan.decide(2, 3, tag=0, send_idx=0).action   # no rule for 2->3
    'deliver'
    """

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._rules: List[_MessageRule] = []
        self._kills: Dict[int, List[_KillRule]] = {}
        self._straggles: Dict[int, List[_StraggleRule]] = {}
        self._hello_delays: Dict[int, float] = {}
        self._lock = threading.Lock()

    # ---- construction -------------------------------------------------------
    def kill(self, rank: int, *, after_sends: Optional[int] = None,
             at_step: Optional[int] = None,
             when_pending: bool = False) -> "FaultPlan":
        """Kill `rank` at its `after_sends`-th application send, or at
        the first `on_step(rank, step>=at_step)` call (gated on a
        pending checkpoint if `when_pending` — the mid-phase-1 kill:
        a rank that has OBSERVED intent but not yet parked dies, so the
        in-flight phase 1 can never close and must be aborted)."""
        assert (after_sends is None) != (at_step is None), \
            "exactly one of after_sends / at_step"
        self._kills.setdefault(rank, []).append(
            _KillRule(rank, after_sends, at_step, when_pending))
        return self

    def straggle(self, rank: int, *, at_step: int, seconds: float,
                 when_pending: bool = False) -> "FaultPlan":
        """One-shot straggler: `on_step` sleeps `seconds` once the rank
        reaches `at_step` (gated on a pending checkpoint).  Used by the
        chaos harness to hold phase 1 open deterministically."""
        self._straggles.setdefault(rank, []).append(
            _StraggleRule(rank, at_step, seconds, when_pending))
        return self

    def drop(self, *, src: Optional[int] = None, dst: Optional[int] = None,
             tag: Optional[int] = None, prob: float = 1.0) -> "FaultPlan":
        self._rules.append(_MessageRule("drop", src, dst, tag, prob))
        return self

    def duplicate(self, *, src: Optional[int] = None,
                  dst: Optional[int] = None, tag: Optional[int] = None,
                  prob: float = 1.0) -> "FaultPlan":
        self._rules.append(_MessageRule("dup", src, dst, tag, prob))
        return self

    def delay(self, *, src: Optional[int] = None, dst: Optional[int] = None,
              tag: Optional[int] = None, prob: float = 1.0,
              max_delay_s: float = 0.005) -> "FaultPlan":
        self._rules.append(
            _MessageRule("delay", src, dst, tag, prob, max_delay_s))
        return self

    def delay_hello(self, rank: int, seconds: float) -> "FaultPlan":
        """Socket backend: delay `rank`'s rendezvous HELLO — the
        slow-joiner scenario (pre-join frames queue at the switch and
        must flush in per-(src, tag) FIFO order at the late join)."""
        self._hello_delays[rank] = seconds
        return self

    # ---- runtime hooks ------------------------------------------------------
    def hello_delay(self, rank: int) -> float:
        return self._hello_delays.get(rank, 0.0)

    def _rng(self, rule_idx: int, src: int, send_idx: int,
             salt: str = "") -> random.Random:
        key = f"{self.seed}:{rule_idx}:{src}:{send_idx}:{salt}".encode()
        return random.Random(zlib.crc32(key))

    def check_kill_send(self, rank: int, send_idx: int) -> None:
        """Called by `Endpoint.send` for application sends; `send_idx`
        is the sender's 0-based app-send sequence number."""
        for rule in self._kills.get(rank, ()):
            if (not rule.fired and rule.after_sends is not None
                    and send_idx + 1 >= rule.after_sends):
                rule.fired = True
                raise RankKilled(rank, f"send #{rule.after_sends}")

    def on_step(self, rank: int, step: int, ckpt_pending: bool = False) -> None:
        """Call at every step boundary (the chaos worker does).  May
        sleep (straggle rules) and may raise `RankKilled`."""
        import time as _time
        for rule in self._straggles.get(rank, ()):
            if (not rule.fired and step >= rule.at_step
                    and (ckpt_pending or not rule.when_pending)):
                rule.fired = True
                _time.sleep(rule.seconds)
        for rule in self._kills.get(rank, ()):
            if (not rule.fired and rule.at_step is not None
                    and step >= rule.at_step
                    and (ckpt_pending or not rule.when_pending)):
                rule.fired = True
                where = f"step {step}" + (" (mid-phase-1)"
                                          if rule.when_pending else "")
                raise RankKilled(rank, where)

    def decide(self, src: int, dst: int, tag: int,
               send_idx: int) -> SendDecision:
        """Per-message decision: first matching rule whose seeded draw
        fires wins.  Pure in (seed, rules, src, send_idx) — identical
        on every backend and every run."""
        for i, rule in enumerate(self._rules):
            if not rule.matches(src, dst, tag):
                continue
            if rule.prob < 1.0 and self._rng(i, src, send_idx).random() >= rule.prob:
                continue
            if rule.kind == "delay":
                d = self._rng(i, src, send_idx, "delay").uniform(
                    0.0, rule.max_delay_s)
                return SendDecision("delay", d)
            return SendDecision(rule.kind)
        return _DELIVER
