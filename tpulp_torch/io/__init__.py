"""I/O of the port: solver-state and branch-and-bound checkpoints."""

from .checkpoint import (load_bnb_frontier, load_state, save_bnb_frontier,
                         save_state)

__all__ = [
    "save_state",
    "load_state",
    "save_bnb_frontier",
    "load_bnb_frontier",
]
