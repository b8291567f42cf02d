"""Rank-1 driver with devex pricing, on torch tensors.

The counterpart of ``tpulp.solve.devex``: argmax ``c_j^2 / gamma_j`` over
improving columns with reference-framework weights (reset past 1e8 and at
the phase change), a periodic exposed-ray scan and a half-period Dantzig
probe every ``RAY_SCAN_EVERY`` pivots. The step is the same branchless
transition as ``driver.simplex_step``, carrying the weights beside the
state. ``solve_lp`` picks it for equality-heavy shapes on the rank-1
engine. On CUDA tensors the walk runs on ``kernels.rank1_cluster`` (one
launch a walk) where a thread-block cluster holds the frame, else on
``kernels.rank1_grid`` (one launch a walk on the whole card; the route
rule of ``solve/driver.py``); on CPU tensors in the plain loop.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.state import SimplexState, SolverOptions, Status
from ..kernels.launch import on_cpu
# the devex frame's reset (past 1e8) and the exposed-ray scan / Dantzig
# probe cadence (64 pivots), shared with the kernels
from ..kernels.rank1 import RAY_SCAN_EVERY, RESET_ABOVE
from .driver import (finish, first_true, pivot_update, put, ratio_rows,
                     run_chunked, solo_walk, status_select, take)

__all__ = ["DevexState", "make_devex_state", "devex_simplex_step",
           "run_simplex_devex"]


class DevexState(NamedTuple):
    s: SimplexState
    gamma: torch.Tensor   # (n,) devex weights, >= 1


def make_devex_state(state: SimplexState) -> DevexState:
    return DevexState(s=state, gamma=torch.ones(
        (state.n,), dtype=state.T.dtype, device=state.T.device))


def devex_simplex_step(ds: DevexState, opts: SolverOptions,
                       stall_limit: int, max_iters: int | None = None
                       ) -> DevexState:
    """One branchless transition with devex pricing."""
    state = ds.s
    T = state.T
    n = state.n
    inf = float("inf")
    running = state.status == Status.RUNNING
    if max_iters is not None:
        running = running & (state.niter < max_iters)
    basis_l = state.basis.long()

    # ---- cleanup scan (as in driver.simplex_step) -------------------------
    art_basic = state.art_cols[basis_l]
    in_phase2 = state.phase == 2
    cleanup = art_basic.any() & in_phase2
    r_d = torch.argmax(art_basic.to(torch.int32))
    row_d = take(T, r_d + 2, 0)[:-1]
    elig = state.col_active & ~state.art_cols & (row_d.abs() > opts.piv_tol)
    has_elig = elig.any()
    j_d = first_true(elig, n - 1)
    retire = cleanup & ~has_elig & running
    art_cols = torch.where(
        retire, put(state.art_cols, take(basis_l, r_d), False),
        state.art_cols)

    # ---- devex pricing ----------------------------------------------------
    crow = torch.where(state.phase == 1, T[1, :-1], T[0, :-1])
    c_eff = torch.where(state.col_active, crow, inf)
    improving = c_eff < -opts.opt_tol
    has_improving = improving.any()
    use_bland = state.bland
    score = torch.where(improving, (crow * crow) / ds.gamma, -inf)
    j_devex = torch.argmax(score)
    j_bland = first_true(improving, n - 1)
    j_price = torch.where(use_bland, j_bland, j_devex)

    # ---- phase bookkeeping ------------------------------------------------
    z1 = -T[1, -1]
    phase1_done = (state.phase == 1) & ~has_improving & running
    became_infeasible = phase1_done & (z1 > opts.infeas_tol)
    to_phase2 = phase1_done & ~became_infeasible
    pricing_pivot = has_improving & ~cleanup & ~phase1_done

    # ---- periodic ray safeguard: an exposed-ray scan at offset 0 and a
    # Dantzig probe at the half period, both in phase 2 with no basic
    # artificial (the scan runs every step and is masked by its tick) -----
    tick = state.niter % RAY_SCAN_EVERY
    scan_tick = (tick == 0) & in_phase2 & ~cleanup & running & has_improving
    ray_exposed = scan_tick & (
        improving & ~(T[2:, :-1] > opts.piv_tol).any(dim=0)).any()
    probe_tick = (tick == RAY_SCAN_EVERY // 2) & in_phase2 & ~cleanup
    j_dantzig = torch.argmin(c_eff)
    j_price = torch.where(use_bland, j_price,
                          torch.where(probe_tick, j_dantzig, j_price))

    # ---- ratio test (first-index ties; Bland's rule under Bland) ---------
    j = torch.where(cleanup, j_d, j_price)
    col = take(T, j, 1)[2:]
    has_ratio, r_price = ratio_rows(col, T[2:, -1], state.basis,
                                    opts.piv_tol, use_bland)
    became_unbounded = (pricing_pivot & ~has_ratio & in_phase2) \
        | (ray_exposed & running)
    became_failed1 = pricing_pivot & ~has_ratio & ~in_phase2

    # ---- the one pivot ----------------------------------------------------
    do_cleanup = cleanup & has_elig & running
    do_pricing = pricing_pivot & has_ratio & running
    do_pivot = do_cleanup | do_pricing
    r = torch.where(do_cleanup, r_d, r_price)
    leaving = take(basis_l, r)
    piv = take(take(T, r + 2, 0), j)
    r_eff = torch.where(do_pivot, r + 2, 2)
    j_eff = torch.where(do_pivot, j, basis_l[0])
    Tn = pivot_update(T, r_eff, j_eff)
    basis = torch.where(do_pivot, put(state.basis, r, j), state.basis)

    # ---- devex weight update over the post-pivot row r -------------------
    gamma_q = take(ds.gamma, j)
    alpha = take(Tn, r + 2, 0)[:-1]
    cand = (alpha * alpha) * gamma_q
    gamma = torch.where(do_pricing, torch.maximum(ds.gamma, cand), ds.gamma)
    safe_piv = torch.where(do_pivot, piv, 1.0)
    leave_val = torch.clamp_min(gamma_q / (safe_piv * safe_piv), 1.0)
    gamma = torch.where(do_pricing, put(gamma, leaving, leave_val), gamma)
    reset = (gamma.max() > RESET_ABOVE) | to_phase2
    gamma = torch.where(reset, torch.ones_like(gamma), gamma)

    # ---- stall / Bland switch ---------------------------------------------
    z = torch.where(state.phase == 1, -Tn[1, -1], -Tn[0, -1])
    improved = (state.last_z - z) > opts.degen_tol
    stuck = torch.where(do_pricing,
                        torch.where(improved, 0, state.stuck + 1),
                        state.stuck).to(torch.int32)
    last_z = torch.where(do_pricing, z, state.last_z)
    bland = state.bland | (stuck >= stall_limit)

    phase = torch.where(to_phase2, 2, state.phase).to(torch.int32)
    col_active = torch.where(to_phase2, state.col_active & ~art_cols,
                             state.col_active)
    stuck = torch.where(to_phase2, 0, stuck).to(torch.int32)
    last_z = torch.where(to_phase2, inf, last_z)

    finished_opt = in_phase2 & ~has_improving & ~cleanup
    finite_ok = (
        torch.isfinite(z)
        & torch.isfinite(Tn[2:, -1].abs().sum())
        & torch.isfinite(torch.where(state.col_active, crow.abs(), 0.0).sum())
    )
    new_status = status_select(finite_ok,
                               became_infeasible | became_failed1,
                               became_unbounded, finished_opt)
    status = torch.where(running, new_status, state.status)

    return DevexState(
        s=SimplexState(
            T=Tn,
            basis=basis,
            col_active=col_active,
            art_cols=art_cols,
            phase=phase,
            status=status,
            niter=state.niter + do_pivot.to(torch.int32),
            stuck=stuck,
            bland=bland,
            last_z=last_z,
        ),
        gamma=gamma,
    )


def run_simplex_devex(state: SimplexState,
                      opts: SolverOptions | None = None) -> SimplexState:
    """Run the devex-priced rank-1 driver; returns the terminal state (the
    weights are internal). The plain loop on CPU tensors; on CUDA tensors
    ``rank1_cluster`` or ``rank1_grid`` (the route rule of
    ``solve/driver.py``)."""
    if opts is None:
        opts = SolverOptions.for_dtype(state.T.dtype)
    stall_limit = opts.resolved_stall_limit(state.m, state.n)
    if not on_cpu(*state):
        return finish(solo_walk("devex", state, opts, stall_limit))
    out = run_chunked(
        lambda c: devex_simplex_step(c, opts, stall_limit, opts.max_iters),
        make_devex_state(state), lambda c: c.s, opts.max_iters)
    return finish(out.s)
