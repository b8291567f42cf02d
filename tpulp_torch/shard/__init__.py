"""Multi-device solving over a ``torch.distributed`` mesh: the explicit
column-sharded drivers of tpulp's path B (rank-1, rank-K blocked and
bounded-variable), and path A's names (``shard_state``,
``run_simplex_gspmd``, ``batch_state_sharding``,
``run_simplex_batch_gspmd``) over the lane-sharded drivers of
``sharded_batch``, which split a batch's lanes over a ``batch`` axis and
each lane's columns over a ``cols`` axis."""

from .sharded import (
    ShardedState,
    batch_state_sharding,
    from_sharded_state,
    make_mesh,
    run_simplex_batch_gspmd,
    run_simplex_gspmd,
    run_simplex_sharded,
    shard_state,
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
    "shard_state",
    "run_simplex_gspmd",
    "batch_state_sharding",
    "run_simplex_batch_gspmd",
    "to_sharded_state",
    "from_sharded_state",
    "run_simplex_sharded",
    "run_simplex_sharded_blocked",
    "ShardedBoundedState",
    "to_sharded_bounded_state",
    "from_sharded_bounded_state",
    "run_simplex_sharded_bounded",
]
