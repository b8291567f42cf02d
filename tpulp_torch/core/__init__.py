"""Core state: tableau tensors, solver options, status codes and form
predicates."""

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
    canonical_dtype,
    eta_scaled_options,
    from_numpy_state,
    make_state,
    to_numpy_state,
)
from .predicates import (
    is_canonical,
    is_degenerate,
    is_infeasible_form,
    is_optimal,
    is_unbounded,
)

__all__ = [
    "SimplexState",
    "SolverOptions",
    "Status",
    "make_state",
    "canonical_dtype",
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
    "is_canonical",
    "is_degenerate",
    "is_infeasible_form",
    "is_optimal",
    "is_unbounded",
]
