"""Tableau form predicates as torch reductions, on the state's device.

The counterpart of ``tpulp.core.predicates``: the reference's predicates
(tableau.py:466-521) as tolerance-aware reductions over the tableau, used
by the debug driver (``utils/debug.py``) and the tests. Each takes a
``SimplexState`` and returns a 0-d bool tensor.
"""

from __future__ import annotations

import torch

from .state import SimplexState

__all__ = [
    "is_optimal",
    "is_unbounded",
    "is_infeasible_form",
    "is_degenerate",
    "is_canonical",
]


def is_optimal(state: SimplexState, tol: float = 1e-9) -> torch.Tensor:
    """All active reduced costs nonnegative (within tol)."""
    c = state.T[0, :-1]
    return (torch.where(state.col_active, c, 0.0) >= -tol).all()


def is_unbounded(state: SimplexState, tol: float = 1e-9) -> torch.Tensor:
    """Some active improving column has no positive entry."""
    c = state.T[0, :-1]
    improving = state.col_active & (c < -tol)
    col_has_pos = (state.T[2:, :-1] > tol).any(dim=0)
    return (improving & ~col_has_pos).any()


def is_infeasible_form(state: SimplexState,
                       tol: float = 1e-9) -> torch.Tensor:
    """Some row with b > 0 has no positive coefficient (the reference's
    ``isInfeasible``, tableau.py:510-514)."""
    A = state.T[2:, :-1]
    b = state.T[2:, -1]
    row_has_pos = (torch.where(state.col_active[None, :], A, 0.0)
                   > tol).any(dim=1)
    return ((b > tol) & ~row_has_pos).any()


def is_degenerate(state: SimplexState, tol: float = 1e-9) -> torch.Tensor:
    """Some basic variable sits at (approximately) zero."""
    return (state.T[2:, -1].abs() <= tol).any()


def is_canonical(state: SimplexState, tol: float = 1e-7) -> torch.Tensor:
    """b >= 0 and the basis columns form an identity with ~zero reduced
    costs; the basis names the candidate columns, so the check is
    O(m^2) (the reference scans the whole tableau, tableau.py:466-496)."""
    m = state.m
    basis = state.basis.long()
    b_ok = (state.T[2:, -1] >= -tol).all()
    bas_cols = state.T[2:, basis]            # (m, m): the basic columns
    eye = torch.eye(m, dtype=state.T.dtype, device=state.T.device)
    unit_ok = ((bas_cols - eye).abs() <= tol).all()
    cost_ok = (state.T[0, :-1][basis].abs() <= tol).all()
    return b_ok & unit_ok & cost_ok
