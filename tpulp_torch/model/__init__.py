"""Modeling layer: linear expressions, constraints, variables, programs.

Capability parity with the reference's ``lpsol.linprog`` module plus the
pieces it promised but never implemented (LinProg container and the
standard-form lowering) — see SURVEY.md §2.3-2.6.
"""

from .expr import LinExpr, VARNAME_RE, as_fraction
from .con import LinCon, COMPARATORS
from .var import LinVar
from .prog import LinProg, Objective, MIN, MAX
from .lower import StandardForm, lower_to_standard_form, LoweringError
from .presolve import PresolveResult, presolve, solve_with_presolve

__all__ = [
    "PresolveResult",
    "presolve",
    "solve_with_presolve",
    "LinExpr",
    "LinCon",
    "LinVar",
    "LinProg",
    "Objective",
    "MIN",
    "MAX",
    "StandardForm",
    "lower_to_standard_form",
    "LoweringError",
    "VARNAME_RE",
    "COMPARATORS",
    "as_fraction",
]
