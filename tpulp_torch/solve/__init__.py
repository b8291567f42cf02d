"""Device solver of the port: drivers, the kernel engine and ``solve_lp``."""

from .api import (Solution, solve_lp, solve_standard_form,
                  solve_standard_form_host, state_from_standard_form)
from .blocked import run_simplex_blocked
from .blocked_kernel import run_simplex_blocked_kernel
from .devex import run_simplex_devex
from .driver import (extract_solution, find_pivot_all, pivot_update,
                     run_simplex, simplex_step)
from .dual import (dual_simplex_step, run_dual_simplex,
                   warm_state_from_basis)
from .refine import (basis_duals, exact_basis_certificate,
                     float_basis_certificate, refine_basis_solution)
from .refresh import refresh_tableau, run_simplex_refreshed

__all__ = [
    "Solution",
    "solve_lp",
    "solve_standard_form",
    "solve_standard_form_host",
    "state_from_standard_form",
    "run_simplex",
    "simplex_step",
    "pivot_update",
    "find_pivot_all",
    "extract_solution",
    "dual_simplex_step",
    "run_dual_simplex",
    "warm_state_from_basis",
    "run_simplex_devex",
    "run_simplex_blocked",
    "run_simplex_blocked_kernel",
    "run_simplex_refreshed",
    "refresh_tableau",
    "refine_basis_solution",
    "basis_duals",
    "exact_basis_certificate",
    "float_basis_certificate",
]
