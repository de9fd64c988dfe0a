"""Split-process state model (paper §II-A), port of
`repro.core.split_state` for one device.

Upper half — checkpointed, host-serializable, *never* references
physical resources: params / optimizer moments / step counter, the
data-pipeline cursor, and the virtual-object tables, drain buffers and
per-comm collective counts (`RankAgent.serialize()`).

Lower half — NEVER checkpointed, rebuilt from scratch at restart: the
train step and the message fabric (a transport WORLD picked by name from
the registry, so a checkpoint written over one backend restores over
another).  PyTorch runs eagerly, so there is no compiled executable, and
the mesh branch (`mesh` not None) and the transport-era reshard helpers
are not ported (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from repro_torch.configs.base import ModelConfig, RunConfig


@dataclasses.dataclass
class LowerHalf:
    mesh: Optional[Any]
    rules: Optional[Any]
    train_step: Callable
    state_specs: Optional[Any]
    # the comm substrate (a transport world from the registry); like the
    # mesh, it is physical state — never serialized, rebuilt at restart
    comm: Optional[Any] = None
    transport: str = "inproc"

    @classmethod
    def build(cls, cfg: ModelConfig, rc: RunConfig, mesh=None,
              transport: str = "inproc", n_ranks: int = 1,
              fault_plan=None) -> "LowerHalf":
        from repro_torch.comm.transport import create_world
        from repro_torch.training.step import make_train_step

        if mesh is not None:
            raise NotImplementedError(
                "mesh-sharded lower halves are not ported to repro_torch "
                "(ROADMAP.md)")
        # fault_plan: deterministic chaos injection on the rebuilt
        # lower half's fabric — physical state, never checkpointed
        comm = create_world(transport, n_ranks, fault_plan=fault_plan)
        return cls(None, None, make_train_step(cfg, rc, None), None, comm,
                   transport)
