"""Transport registry: pluggable fabric backends.

A backend registers a *world factory* under a name; `create_world`
instantiates an in-process world object exposing

    .endpoints        list of the n rank Endpoints
    .coord_endpoint() the coordinator's endpoint (rank n)
    .n_ranks / .msg_cost_s / .close()

Registered backends:
  "inproc" — threaded reference backend (`InprocTransport`; the
             original `Fabric`).
  "socket" — loopback-TCP backend.  `create_world("socket", ...)` hosts
             every rank's `SocketTransport` client in this process
             (real wire path, one process); TRUE one-process-per-rank
             execution is the world harness's job
             (`repro_torch.comm.transport.harness.run_world`).

A future backend (shared memory, UCX, a second host) only needs to
move `Message` frames and register here — the matching semantics,
drain protocol, coordinator wire protocol and conformance suite
(tests/test_transport_conformance.py) come for free.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

from repro_torch.comm.transport.base import (  # noqa: F401
    CTRL_BASE, TAG_CTRL, TAG_INTENT, TAG_RESULT,
    Endpoint, Message, Transport, TransportClosed, is_ctrl_tag,
)
from repro_torch.comm.transport.faults import (  # noqa: F401
    FaultPlan, RankKilled,
)
from repro_torch.comm.transport.inproc import InprocTransport
from repro_torch.comm.transport.tcp import (  # noqa: F401
    FabricSwitch, LoopbackSocketWorld, SocketTransport,
)

_REGISTRY: Dict[str, Callable[..., Transport]] = {}


def register_transport(name: str, world_factory: Callable[..., Transport]) -> None:
    _REGISTRY[name] = world_factory


def available_transports() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def create_world(name: str, n_ranks: int, msg_cost_us: float = 0.0,
                 fault_plan=None) -> Transport:
    """Instantiate a transport world by registry name.  `fault_plan`
    (a `repro_torch.comm.transport.faults.FaultPlan`) installs deterministic
    fault injection on the world's endpoints."""
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown transport {name!r}; "
                         f"registered: {available_transports()}") from None
    return factory(n_ranks, msg_cost_us=msg_cost_us, fault_plan=fault_plan)


register_transport("inproc", InprocTransport)
register_transport("socket", LoopbackSocketWorld)
