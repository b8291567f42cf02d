"""Device solver of the port: drivers, the kernel engine, ``solve_lp`` and
the exact layer on top of it (certificates, ranging, IIS)."""

from .api import (Solution, solve_lp, solve_standard_form,
                  solve_standard_form_host, state_from_standard_form)
from .blocked import run_simplex_blocked, run_simplex_blocked_batch
from .blocked_kernel import run_simplex_blocked_kernel
from .bounded import (BoundedState, extract_bounded_solution,
                      make_bounded_state, run_simplex_bounded,
                      run_simplex_bounded_batch)
from .devex import run_simplex_devex
from .driver import (extract_solution, find_pivot_all, pivot_update,
                     run_simplex, simplex_step)
from .dual import (dual_simplex_step, run_dual_simplex,
                   warm_state_from_basis)
from .farkas import (farkas_certificate, ray_certificate, verify_farkas,
                     verify_ray)
from .iis import find_iis
from .ranging import RangingReport, original_ranging, standard_form_ranging
from .refine import (basis_duals, exact_basis_certificate, exact_basis_solve,
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
    "run_simplex_blocked_batch",
    "run_simplex_blocked_kernel",
    "BoundedState",
    "make_bounded_state",
    "run_simplex_bounded",
    "run_simplex_bounded_batch",
    "extract_bounded_solution",
    "run_simplex_refreshed",
    "refresh_tableau",
    "refine_basis_solution",
    "exact_basis_solve",
    "basis_duals",
    "exact_basis_certificate",
    "float_basis_certificate",
    "find_iis",
    "farkas_certificate",
    "ray_certificate",
    "verify_farkas",
    "verify_ray",
    "RangingReport",
    "original_ranging",
    "standard_form_ranging",
]
