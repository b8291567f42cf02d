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
RHS change), with ``simple_bounds=True`` it enforces finite upper bounds
in the ratio test of the bounded-variable simplex instead of tableau rows,
and ``certificates=True`` / ``ranging=True`` add exact Farkas or ray
proofs and sensitivity ranges; ``find_iis`` names the constraints of an
infeasible model that conflict. ``solve_lp_batch`` solves a batch of LPs
in one wave of lanes (rank-1, rank-K blocked or bounded), and
``solve_milp`` solves a mixed-integer program by branch-and-bound over
such waves. ``python -m tpulp_torch`` is the command line. With
``mesh=`` (``tpulp_torch.shard.make_mesh()`` over a ``torch.distributed``
group, ``tpulp_torch.comm.init_distributed``) ``solve_lp`` column-shards
one LP over the group's processes, one device each, and
``solve_lp_batch`` / ``solve_milp`` split their lanes over a ``batch``
axis and each lane's columns over a ``cols`` axis of a ``DeviceMesh``.
"""

from .model import (MAX, MIN, LinCon, LinExpr, LinProg, LinVar,
                    StandardForm, lower_to_standard_form)
from .simplex import Simplex, SolveStatus
from .tableau import Tableau

from .batch import solve_lp_batch
from .core import SimplexState, SolverOptions, Status, make_state
from .milp import BnbStats, solve_milp
from .solve import (BoundedState, RangingReport, Solution,
                    farkas_certificate, find_iis, ray_certificate,
                    run_dual_simplex, run_simplex, run_simplex_blocked,
                    run_simplex_blocked_batch, run_simplex_blocked_kernel,
                    run_simplex_bounded, run_simplex_bounded_batch,
                    run_simplex_devex, run_simplex_refreshed, solve_lp,
                    solve_standard_form, verify_farkas, verify_ray,
                    warm_state_from_basis)
from .io.mps import read_mps, write_mps

__all__ = [
    "Tableau",
    "Simplex",
    "SolveStatus",
    "MIN",
    "MAX",
    "read_mps",
    "write_mps",
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
    "BoundedState",
    "run_simplex_bounded",
    "run_simplex_bounded_batch",
    "run_simplex_blocked_batch",
    "find_iis",
    "farkas_certificate",
    "ray_certificate",
    "verify_farkas",
    "verify_ray",
    "RangingReport",
]
