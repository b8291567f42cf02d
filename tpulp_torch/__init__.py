"""tpulp_torch — the PyTorch / CUDA port of tpulp for one NVIDIA H100.

A second package beside the JAX package ``tpulp``, which stays the
reference. It imports torch, and nothing of jax or of tpulp. Its modeling
layer (``tpulp_torch.model``: ``LinProg``, ``LinExpr``, lowering to
``StandardForm``), exact host simplex and corpus are copies of tpulp's
pure-Python modules, with the same code; a tpulp program crosses over
through the JSON schema (``model.serialize``). ``solve_lp(prog,
device="cuda")`` solves one LP on the card: the rank-1, rank-K blocked,
and kernel engines, the last running two CUDA kernels built for sm_90a at
first use (a third fuses the pivots' multiply-adds); with
``warm_start=`` it re-solves from a prior basis (the dual simplex for an
RHS change). ``solve_lp_batch`` solves a batch of LPs in one wave of
lanes, and ``solve_milp`` solves a mixed-integer program by
branch-and-bound over such waves.
"""

from .model import (LinCon, LinExpr, LinProg, LinVar, StandardForm,
                    lower_to_standard_form)

from .batch import solve_lp_batch
from .core import SimplexState, SolverOptions, Status, make_state
from .milp import BnbStats, solve_milp
from .solve import (Solution, run_dual_simplex, run_simplex,
                    run_simplex_blocked, run_simplex_blocked_kernel,
                    run_simplex_devex, run_simplex_refreshed, solve_lp,
                    solve_standard_form, warm_state_from_basis)

__all__ = [
    "LinProg",
    "LinExpr",
    "LinCon",
    "LinVar",
    "StandardForm",
    "lower_to_standard_form",
    "solve_lp",
    "solve_lp_batch",
    "solve_milp",
    "BnbStats",
    "solve_standard_form",
    "Solution",
    "make_state",
    "SimplexState",
    "SolverOptions",
    "Status",
    "run_simplex",
    "run_simplex_devex",
    "run_simplex_blocked",
    "run_simplex_blocked_kernel",
    "run_simplex_refreshed",
    "run_dual_simplex",
    "warm_state_from_basis",
]
