"""I/O of the port: tableau rendering, the string-grid tableau format,
MPS files, and solver-state and branch-and-bound checkpoints."""

from .checkpoint import (load_bnb_frontier, load_state, save_bnb_frontier,
                         save_state)
from .grid import format_grid, parse_grid
from .mps import read_mps, read_mps_string, write_mps, write_mps_string
from .render import render_csv, render_grid, render_latex, render_text

__all__ = [
    "render_grid",
    "render_text",
    "render_latex",
    "render_csv",
    "read_mps",
    "read_mps_string",
    "write_mps",
    "write_mps_string",
    "save_state",
    "load_state",
    "save_bnb_frontier",
    "load_bnb_frontier",
    "parse_grid",
    "format_grid",
]
