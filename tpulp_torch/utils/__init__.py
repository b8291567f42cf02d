"""Utilities: the debug driver with invariant checks and a trace."""

from .debug import (
    DebugReport,
    InvariantViolation,
    IterationRecord,
    run_simplex_debug,
)

__all__ = [
    "run_simplex_debug",
    "DebugReport",
    "IterationRecord",
    "InvariantViolation",
]
