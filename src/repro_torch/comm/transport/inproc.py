"""In-process threaded transport — the reference backend.

Every rank is a thread in one process; `route` is a direct enqueue
under the destination endpoint's condition variable.  This is the
original `Fabric` (PR-1's indexed in-memory fabric) re-expressed as a
`Transport` backend with zero behavior change: all matching, counter,
drain and occupancy semantics live in the shared `Endpoint`
(`repro_torch.comm.transport.base`), and this class only moves the message.

`repro_torch.comm.fabric.Fabric` remains the public alias, so pre-transport
code (tests, benchmarks, workloads) runs unchanged.
"""
from __future__ import annotations

import threading
from typing import List

from repro_torch.comm.transport.base import Endpoint, Message, Transport


class InprocTransport(Transport):
    """Shared state for all ranks of one simulated job (one process)."""

    name = "inproc"

    def __init__(self, n_ranks: int, msg_cost_us: float = 0.0,
                 fault_plan=None):
        super().__init__(n_ranks, msg_cost_us, fault_plan=fault_plan)
        self.endpoints: List[Endpoint] = [Endpoint(self, r)
                                          for r in range(n_ranks)]
        self._coord_ep = None
        self._coord_lock = threading.Lock()

    def coord_endpoint(self) -> Endpoint:
        """The coordinator's endpoint (rank `n_ranks`), created lazily —
        most fabric-level tests never need a control plane."""
        with self._coord_lock:
            if self._coord_ep is None:
                self._coord_ep = Endpoint(self, self.coord_rank)
            return self._coord_ep

    def _ep(self, rank: int) -> Endpoint:
        if rank == self.coord_rank:
            return self.coord_endpoint()
        return self.endpoints[rank]

    def route(self, msg: Message) -> None:
        self._ep(msg.dst).enqueue(msg)

    # back-compat: pre-transport code called fabric.deliver(msg)
    deliver = route

    def close(self) -> None:
        for ep in self.endpoints:
            ep.stop_faults()

    @property
    def _stores(self):
        """Back-compat view for introspection tests (store internals)."""
        return [ep._store for ep in self.endpoints]
