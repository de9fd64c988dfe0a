"""Back-compat facade for the pre-transport fabric API.

The fabric was refactored into a pluggable transport layer
(`repro_torch.comm.transport`): matching/counter/drain/occupancy semantics
live in the backend-agnostic `Endpoint` (`transport.base`), and the
original in-process threaded fabric is now the "inproc" backend
(`transport.inproc.InprocTransport`) — reference semantics, zero
behavior change.  `Fabric` remains the canonical name for an inproc
world, so existing tests, benchmarks and workloads run unchanged.
"""
from repro_torch.comm.transport.base import (  # noqa: F401
    CTRL_BASE, TAG_CTRL, TAG_INTENT, TAG_RESULT,
    Endpoint, Message, is_ctrl_tag,
    _CompletedSend, _DrainBuffer, _IndexedStore, _IrecvRequest,
)
from repro_torch.comm.transport.inproc import InprocTransport as Fabric  # noqa: F401
