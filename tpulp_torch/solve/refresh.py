"""Periodic tableau refactorization: the precision ladder's refreshed rung.

The counterpart of ``tpulp.solve.refresh``. The device runs its engine in
segments of ``segment`` pivots; between segments the host rebuilds the
whole tableau over the current basis from the original data (one
``m x m`` solve in float64) and snaps basic columns to exact units. A
terminal verdict is accepted only once it re-derives from freshly
factorized data with no further pivots. The ratio test breaks ties by the
largest pivot element (``TIE_MAXPIV``) to bound element growth.

``refresh_tableau`` is numpy code carried over unchanged: it cannot be
imported from tpulp, whose ``tpulp/solve/__init__.py`` imports jax.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.precision import full_precision
from ..core.state import (SimplexState, SolverOptions, Status, TIE_MAXPIV,
                          make_state)

__all__ = ["refresh_tableau", "run_simplex_refreshed", "stabilized_options"]


def stabilized_options(opts: SolverOptions) -> SolverOptions:
    """``opts`` with the growth-bounding ratio tie-break enabled."""
    return dataclasses.replace(opts, tie_break=TIE_MAXPIV)


def refresh_tableau(
    T0: np.ndarray,
    basis: np.ndarray,
    art0: np.ndarray,
    feas_tol: float = 1e-6,
) -> Optional[np.ndarray]:
    """Rebuild the canonical tableau over ``basis`` from original data.

    ``T0`` is the INITIAL (m+2, n+1) tableau from ``make_state`` — row 0
    the raw objective ``[c | 0]``, rows 2+ the raw ``[A_full | b]`` (slack
    and artificial columns included). Returns the refreshed tableau
    (float64): rows 2+ are ``B^-1 [A | b]`` with basic columns snapped to
    exact units, row 0 the reduced costs ``c - c_B B^-1 A`` (corner
    ``-z2``), row 1 the phase-1 reduced costs over the original artificial
    cost vector ``art0`` (corner ``-z1``).

    Small negative basic values (|.| <= ``feas_tol`` * scale) are drift and
    are clamped to 0; a larger violation means the float walk genuinely
    lost primal feasibility — returns ``None`` (as does a singular basis).
    ``feas_tol=None`` clamps ANY negative basic value (Harris-style bound
    shifting): the right mode for f32 engines, whose deep phase-1 walks
    transiently carry ~1e-3..3e-1 violations while still making real
    progress (measured on the 1024x2048 family). The perturbation cannot
    accumulate — every refresh re-derives from the ORIGINAL data, and
    terminal verdicts/certificates are anchored there too.
    """
    m = T0.shape[0] - 2
    T0 = np.asarray(T0, dtype=np.float64)
    basis = np.asarray(basis)
    Ab = T0[2:, :]
    B = Ab[:, basis]
    try:
        X = np.linalg.solve(B, Ab)
    except np.linalg.LinAlgError:
        return None
    if not np.all(np.isfinite(X)):
        return None
    rows = np.arange(m)
    X[:, basis] = 0.0
    X[rows, basis[rows]] = 1.0
    bcol = X[:, -1]
    if feas_tol is not None:
        scale = 1.0 + float(np.max(np.abs(T0[2:, -1]), initial=0.0))
        bad = bcol < -feas_tol * scale
        if np.any(bad):
            return None
    np.clip(bcol, 0.0, None, out=bcol)
    c = T0[0, :]
    c1 = np.concatenate([np.where(np.asarray(art0), 1.0, 0.0), [0.0]])
    row0 = c - c[basis] @ X
    row1 = c1 - c1[basis] @ X
    row0[basis] = 0.0
    row1[basis] = 0.0
    Tn = np.empty_like(T0)
    Tn[0] = row0
    Tn[1] = row1
    Tn[2:] = X
    return Tn


def _resume_state(base: SimplexState, T_np: np.ndarray) -> SimplexState:
    dev, dt = base.T.device, base.T.dtype
    return base._replace(
        T=torch.tensor(T_np, dtype=dt, device=dev),
        status=torch.tensor(Status.RUNNING, dtype=torch.int32, device=dev),
        stuck=torch.tensor(0, dtype=torch.int32, device=dev),
        last_z=torch.tensor(float("inf"), dtype=dt, device=dev),
    )


def _numeric(out: SimplexState) -> SimplexState:
    return out._replace(status=torch.tensor(
        Status.NUMERIC, dtype=torch.int32, device=out.status.device))


@full_precision()
def run_simplex_refreshed(
    c,
    A,
    b,
    basis_hint,
    opts: Optional[SolverOptions] = None,
    dtype=torch.float64,
    segment: int = 512,
    engine: str = "rank1",
    block: int = 64,
    device="cuda",
) -> SimplexState:
    """Two-phase simplex with periodic refactorization (see module doc).

    ``engine``: 'rank1', 'blocked' or 'kernel' for the per-segment driver.
    Terminates with a verdict re-derived from freshly refactorized data (or
    iteration_limit / a numerical_error the refresh could not repair). The
    returned ``niter`` counts pivots across all segments.

    Under the kernel engine the TIE_MAXPIV tie-break is not applied: the
    inner-block kernel breaks ratio ties by first index, as tpulp's does."""
    from .blocked import run_simplex_blocked
    from .blocked_kernel import run_simplex_blocked_kernel
    from .driver import run_simplex

    state = make_state(c, A, b, basis_hint, dtype=dtype, device=device)
    dtype = state.T.dtype
    if opts is None:
        opts = SolverOptions.for_dtype(dtype)
    opts = stabilized_options(opts)
    T0 = state.T.cpu().numpy().astype(np.float64)
    art0 = state.art_cols.cpu().numpy().copy()
    budget = opts.max_iters
    segment = max(1, min(segment, budget))
    # f32 engines clamp every negative basic value (their deep walks
    # transiently violate feasibility while still progressing); f64 keeps
    # the tight gate
    clamp_tol = None if dtype == torch.float32 \
        else max(opts.feas_tol, 1e-7)

    def run_seg(s, target):
        # niter is absolute across resumes, so segment targets are too
        seg_opts = dataclasses.replace(opts, max_iters=target)
        if engine == "blocked":
            return run_simplex_blocked(s, seg_opts, block=block)
        if engine == "kernel":
            return run_simplex_blocked_kernel(s, seg_opts,
                                              block=max(block, 128))
        return run_simplex(s, seg_opts)

    total = 0
    last_claim = None  # (status, total_pivots) at the previous verdict
    verdict_refreshes = 0
    while True:
        out = run_seg(state, min(total + segment, budget))
        total = int(out.niter)
        st = int(out.status)
        if st == Status.ITERATION_LIMIT and total < budget:
            # segment cap, not the real budget: refresh and continue
            Tn = refresh_tableau(T0, out.basis.cpu().numpy(), art0,
                                 feas_tol=clamp_tol)
            if Tn is None:
                return _numeric(out)
            state = _resume_state(out, Tn)
            continue
        if st == Status.ITERATION_LIMIT:
            return out
        # terminal claim: accept only a verdict that re-derives from fresh
        # data with no further pivots
        claim = (st, total)
        if last_claim == claim or verdict_refreshes >= 8:
            return out
        verdict_refreshes += 1
        Tn = refresh_tableau(T0, out.basis.cpu().numpy(), art0,
                             feas_tol=clamp_tol)
        if Tn is None:
            # unrepairable basis: NUMERIC, so the ladder escalates
            return _numeric(out)
        last_claim = claim
        state = _resume_state(out, Tn)
