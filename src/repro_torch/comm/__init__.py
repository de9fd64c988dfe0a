from repro_torch.comm.fabric import Fabric, Endpoint, Message  # noqa: F401
from repro_torch.comm.transport import (  # noqa: F401
    available_transports, create_world, register_transport,
)
