"""I/O of the port: solver-state and branch-and-bound checkpoints, and the
string-grid tableau format."""

from .checkpoint import (load_bnb_frontier, load_state, save_bnb_frontier,
                         save_state)
from .grid import format_grid, parse_grid

__all__ = [
    "save_state",
    "load_state",
    "save_bnb_frontier",
    "load_bnb_frontier",
    "parse_grid",
    "format_grid",
]
