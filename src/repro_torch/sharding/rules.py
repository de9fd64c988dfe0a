"""The logical-axis vocabulary that the elastic reshard
(`repro_torch.core.split_state.reshard_state`) shares with mesh
shardings: which logical names are split across the rank world, and the
ZeRO-1 dim choice.  Port of the jax-free part of
`repro.sharding.rules`; `ShardingRules` and the mesh helpers are not
ported yet (ROADMAP.md).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

# logical names sharded across the DATA-parallel direction.  In the
# transport era the rank world IS the (1-D) data axis, so these are the
# names the elastic reshard (`split_state.reshard_state`) splits/merges
# across world sizes; everything else is replicated unless claimed by
# the ZeRO-1 rule below.
WORLD_LOGICAL_AXES: Tuple[str, ...] = ("batch",)


def zero1_pick_dim(entries: Sequence, shape: Sequence[int], dsize: int,
                   *, allow_uneven: bool = False) -> Optional[int]:
    """The ZeRO-1 dim choice, factored out so `zero1_shard` (mesh
    shardings; even tiling required by jit) and the transport-era
    elastic reshard (numpy `array_split`; uneven allowed) cannot
    disagree: the first currently-unsharded dim eligible for the data
    shard, or None to fall back to replication/param spec."""
    for i, (e, dim) in enumerate(zip(entries, shape)):
        if e is None and (allow_uneven or dim % dsize == 0):
            return i
    return None
