"""Core state: tableau tensors, solver options and status codes."""

from .precision import full_precision
from .state import (
    RULE_BLAND,
    RULE_DANTZIG,
    RULE_DEVEX,
    RULE_MAX_INCREASE,
    TIE_FIRST,
    TIE_MAXPIV,
    SimplexState,
    SolverOptions,
    Status,
    eta_scaled_options,
    from_numpy_state,
    make_state,
    to_numpy_state,
)

__all__ = [
    "SimplexState",
    "SolverOptions",
    "Status",
    "make_state",
    "from_numpy_state",
    "to_numpy_state",
    "eta_scaled_options",
    "full_precision",
    "RULE_DANTZIG",
    "RULE_BLAND",
    "RULE_MAX_INCREASE",
    "RULE_DEVEX",
    "TIE_FIRST",
    "TIE_MAXPIV",
]
