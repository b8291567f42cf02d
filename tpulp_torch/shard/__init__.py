"""Multi-device column-partitioned solving over a ``torch.distributed``
mesh: the explicit drivers of tpulp's path B (rank-1, rank-K blocked and
bounded-variable). GSPMD's path A (``shard_state``, ``run_simplex_gspmd``,
``batch_state_sharding``, ``run_simplex_batch_gspmd``) has no counterpart
yet (ROADMAP queue A)."""

from .sharded import (
    ShardedState,
    from_sharded_state,
    make_mesh,
    run_simplex_sharded,
    to_sharded_state,
)
from .sharded_blocked import run_simplex_sharded_blocked
from .sharded_bounded import (
    ShardedBoundedState,
    from_sharded_bounded_state,
    run_simplex_sharded_bounded,
    to_sharded_bounded_state,
)

__all__ = [
    "ShardedState",
    "make_mesh",
    "to_sharded_state",
    "from_sharded_state",
    "run_simplex_sharded",
    "run_simplex_sharded_blocked",
    "ShardedBoundedState",
    "to_sharded_bounded_state",
    "from_sharded_bounded_state",
    "run_simplex_sharded_bounded",
]
