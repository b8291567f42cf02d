"""Bounded-variable simplex on torch tensors: finite upper bounds without
tableau rows.

The counterpart of ``tpulp.solve.bounded``. A nonbasic variable at its
upper bound has its column negated and its span folded into the RHS (the
flip ``T[:, -1] -= u_j T[:, j]; T[:, j] *= -1``, on every row), so pricing
stays uniform and the ratio test has three kinds of candidate: a basic
variable hits 0 (a pivot), a basic variable hits its own upper bound (a
pivot, then the leaving column flips), or the entering variable crosses its
whole span with nothing blocking (a flip alone, a rank-0 step). Each
``bounded_simplex_step`` makes exactly one (possibly no-op) ``pivot_update``
and one (possibly no-op) column flip, as tensor selects, so the step is
branchless and ``torch.func.vmap`` batches it. Phase-1 artificials carry
infinite spans, so the two-phase layout of ``core/state.py`` is unchanged.

``run_simplex_bounded`` runs the walk on CUDA tensors on the kernel that
``bounded_route`` chooses: ``kernels.bounded_grid.bounded_grid`` (the
whole walk in one cooperative launch, the tableau's column slabs in the
SMs' shared memory, or past it their first rows there and the rest
streamed through device memory, past 6,284 rows at f64 and 10,800 at f32
(with n = 2m) the per-row vectors in device memory too, and past slabs of
3,098 columns at f64 and 6,032 at f32 (n past 408,936 and 796,224 on 132
SMs) every row of a slab streamed, the wide plan); on CPU tensors it
runs this step in the chunked Python loop of ``solve/driver.py``
(``run_simplex_bounded_reference``; one host read of the status per
chunk). ``run_simplex_bounded_batch`` runs every lane of a
batched state to its exit through ``lanes.bounded_lanes``: on CUDA
tensors one ``lane_bounded`` launch (a block a lane, the whole walk in the
launch), on CPU tensors this step vmapped over the lanes in the chunked
loop (``lanes.bounded_lanes_reference``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.state import RULE_DEVEX, SimplexState, SolverOptions, Status
from ..kernels.bounded import BIG_I, DEVEX_RESET_ABOVE
from ..kernels.bounded_grid import (GRID_SMS, bounded_grid,
                                    bounded_grid_occupancy, bounded_grid_plan)
from ..kernels.fma import fused_fma
from ..kernels.launch import on_cpu, sm_count
from .driver import (finish, first_true, pivot_update, put, run_chunked,
                     status_select, take)
from .lanes import bounded_lanes

__all__ = ["BoundedState", "make_bounded_state", "bounded_simplex_step",
           "run_simplex_bounded", "run_simplex_bounded_reference",
           "bounded_route",
           "run_simplex_bounded_batch", "extract_bounded_solution",
           "BIG_I", "DEVEX_RESET_ABOVE"]


class BoundedState(NamedTuple):
    """SimplexState plus the bound machinery; ``gamma`` holds the devex
    weights when the step prices with ``RULE_DEVEX`` and is ``None``
    otherwise."""

    s: SimplexState
    upper: torch.Tensor     # (n,) finite span or +inf
    at_upper: torch.Tensor  # (n,) bool: nonbasic at upper (complemented)
    gamma: torch.Tensor | None = None  # (n,) devex weights, >= 1


def make_bounded_state(state: SimplexState, upper) -> BoundedState:
    """Wrap an initial state with per-column spans (None -> +inf)."""
    n = state.n
    u = np.full((n,), np.inf)
    for j, v in enumerate(upper or []):
        if v is not None:
            u[j] = float(v)
    dev = state.T.device
    return BoundedState(
        s=state,
        upper=torch.tensor(u, device=dev).to(state.T.dtype),
        at_upper=torch.zeros((n,), dtype=torch.bool, device=dev),
    )


def bounded_simplex_step(bs: BoundedState, opts: SolverOptions,
                         stall_limit: int, max_iters: int | None = None
                         ) -> BoundedState:
    """One branchless transition (see the module doc). With ``max_iters``
    the step is a no-op once ``niter`` reaches it."""
    state = bs.s
    T = state.T
    n = state.n
    inf = float("inf")
    running = state.status == Status.RUNNING
    if max_iters is not None:
        running = running & (state.niter < max_iters)
    basis_l = state.basis.long()

    # ---- cleanup scan: basic artificials still in the basis (phase 2) ----
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

    # ---- pricing (uniform thanks to the complement representation) -------
    crow = torch.where(state.phase == 1, T[1, :-1], T[0, :-1])
    c_eff = torch.where(state.col_active, crow, inf)
    improving = c_eff < -opts.opt_tol
    has_improving = improving.any()
    use_bland = state.bland
    if opts.rule == RULE_DEVEX:
        # c^2 / gamma over improving columns: the reduced costs are already
        # sign-uniform, at-upper columns being negated
        score = torch.where(improving, (crow * crow) / bs.gamma, -inf)
        j_best = torch.argmax(score)
    else:
        j_best = torch.argmin(c_eff)
    j_bland = first_true(improving, n - 1)
    j_price = torch.where(use_bland, j_bland, j_best)

    # ---- phase bookkeeping ------------------------------------------------
    z1 = -T[1, -1]
    phase1_done = (state.phase == 1) & ~has_improving & running
    became_infeasible = phase1_done & (z1 > opts.infeas_tol)
    to_phase2 = phase1_done & ~became_infeasible
    pricing_pivot = has_improving & ~cleanup & ~phase1_done

    # ---- three-way ratio test ---------------------------------------------
    j = torch.where(cleanup, j_d, j_price)
    col = take(T, j, 1)[2:]
    b = T[2:, -1]
    u_basic = bs.upper[basis_l]
    # (a) a basic variable hits its lower bound 0
    pos = col > opts.piv_tol
    t_lo = torch.where(pos, b / torch.where(pos, col, 1.0), inf)
    t_lo_min = t_lo.min()
    # (b) a basic variable hits its own upper bound (entry < 0, finite span)
    neg = (col < -opts.piv_tol) & torch.isfinite(u_basic)
    t_up = torch.where(neg, (u_basic - b) / torch.where(neg, -col, 1.0), inf)
    t_up_min = t_up.min()
    # (c) the entering variable crosses its whole span
    t_flip = take(bs.upper, j)

    t_star = torch.minimum(torch.minimum(t_lo_min, t_up_min), t_flip)
    has_ratio = torch.isfinite(t_star)
    # on exact ties: a lower hit, then an upper hit, then the flip
    kind_lo = t_lo_min <= t_star
    kind_up = ~kind_lo & (t_up_min <= t_star)
    kind_flip = ~kind_lo & ~kind_up

    # the leaving row among the winning kind's ties (first index / Bland)
    tie_lo = t_lo <= t_star
    tie_up = neg & (t_up <= t_star)
    tie = torch.where(kind_lo, tie_lo, tie_up)
    r_first = torch.argmax(tie.to(torch.int32))
    r_bland = torch.argmin(torch.where(tie, state.basis, BIG_I))
    r_price = torch.where(use_bland, r_bland, r_first)

    became_unbounded = pricing_pivot & ~has_ratio & in_phase2
    became_failed1 = pricing_pivot & ~has_ratio & ~in_phase2

    # ---- one (possibly no-op) pivot; the entering flip is a rank-0 step,
    # redirected to the exact no-op pivot (row 2, basis[0]) ----------------
    do_cleanup = cleanup & has_elig & running
    do_price = pricing_pivot & has_ratio & running
    do_pivot = do_cleanup | (do_price & ~kind_flip)
    do_flip_enter = do_price & kind_flip
    r = torch.where(do_cleanup, r_d, r_price)
    leaving = take(basis_l, r)
    r_eff = torch.where(do_pivot, r + 2, 2)
    j_eff = torch.where(do_pivot, j, basis_l[0])
    Tn = pivot_update(T, r_eff, j_eff)
    basis = torch.where(do_pivot, put(state.basis, r, j), state.basis)

    # ---- devex weights move on basis changes only: an entering flip
    # leaves the basis, so the frame, alone; the flip after an upper hit
    # only negates a column, and the weights are sign-invariant -------------
    if opts.rule == RULE_DEVEX:
        gamma_q = take(bs.gamma, j)
        piv = take(take(T, r + 2, 0), j)
        safe_piv = torch.where(do_pivot, piv, 1.0)
        alpha = take(Tn, r + 2, 0)[:-1]        # post-pivot row r (pre-flip)
        cand = (alpha * alpha) * gamma_q
        upd = do_price & ~kind_flip & running
        gamma = torch.where(upd, torch.maximum(bs.gamma, cand), bs.gamma)
        leave_val = torch.clamp_min(gamma_q / (safe_piv * safe_piv), 1.0)
        gamma = torch.where(upd, put(gamma, leaving, leave_val), gamma)
        gamma = torch.where(gamma.max() > DEVEX_RESET_ABOVE,
                            torch.ones_like(gamma), gamma)
        gamma = torch.where(to_phase2, torch.ones_like(gamma), gamma)
    else:
        gamma = bs.gamma

    # ---- one (possibly no-op) column flip: the leaving column after an
    # upper hit, the entering column after a crossing, else u = 0 ----------
    do_flip = (do_price & kind_up & ~cleanup) | do_flip_enter
    fcol = torch.where(do_flip_enter, j, leaving)
    uf = torch.where(do_flip, take(bs.upper, fcol), 0.0)
    colv = take(Tn, fcol, 1)
    # T[:, -1] - uf * T[:, fcol] with one rounding, as XLA contracts it
    rhs = fused_fma(Tn[:, -1], colv, uf, -1.0)
    ncols = Tn.shape[1]
    ids = torch.arange(ncols, device=Tn.device)
    Tn = torch.where((ids == ncols - 1)[None, :], rhs[:, None], Tn)
    is_f = (ids == fcol)[None, :] & do_flip
    Tn = torch.where(is_f, -Tn, Tn)
    at_upper = torch.where(
        do_flip, put(bs.at_upper, fcol, ~take(bs.at_upper, fcol)),
        bs.at_upper)

    # ---- stall / Bland switch ---------------------------------------------
    act = do_pivot | do_flip_enter
    z = torch.where(state.phase == 1, -Tn[1, -1], -Tn[0, -1])
    improved = (state.last_z - z) > opts.degen_tol
    stuck = torch.where(do_price & act,
                        torch.where(improved, 0, state.stuck + 1),
                        state.stuck).to(torch.int32)
    last_z = torch.where(do_price & act, z, state.last_z)
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

    return BoundedState(
        s=SimplexState(
            T=Tn,
            basis=basis,
            col_active=col_active,
            art_cols=art_cols,
            phase=phase,
            status=status,
            niter=state.niter + act.to(torch.int32),
            stuck=stuck,
            bland=bland,
            last_z=last_z,
        ),
        upper=bs.upper,
        at_upper=at_upper,
        gamma=gamma,
    )


def _with_gamma(bs: BoundedState, opts: SolverOptions) -> BoundedState:
    """Devex pricing starts every weight at 1."""
    if opts.rule == RULE_DEVEX and bs.gamma is None:
        return bs._replace(gamma=torch.ones_like(bs.upper))
    return bs


def _finish(bs: BoundedState) -> BoundedState:
    return bs._replace(s=finish(bs.s))


def _tensors(bs: BoundedState) -> list:
    return [x for x in (*bs.s, bs.upper, bs.at_upper, bs.gamma)
            if x is not None]


def run_simplex_bounded_reference(bs: BoundedState,
                                  opts: SolverOptions | None = None
                                  ) -> BoundedState:
    """The plain walk: ``bounded_simplex_step`` in ``run_chunked``'s
    chunks, to termination or to ``opts.max_iters``."""
    if opts is None:
        opts = SolverOptions.for_dtype(bs.s.T.dtype)
    stall_limit = opts.resolved_stall_limit(bs.s.m, bs.s.n)
    out = run_chunked(
        lambda c: bounded_simplex_step(c, opts, stall_limit, opts.max_iters),
        _with_gamma(bs, opts), lambda c: c.s, opts.max_iters)
    return _finish(out)


def bounded_route(M: int, N: int, dtype, sms: int = GRID_SMS,
                  device: torch.device | None = None,
                  devex: bool = True) -> str:
    """The kernel that runs a solo bounded walk of an (M, N) tableau of
    ``dtype`` on a card of ``sms`` SMs: "bounded_grid", on the plan that
    ``bounded_grid_plan`` picks (resident, streamed, with the per-row
    vectors in device memory, or wide), for every f32 and f64 frame. With
    ``device`` (a CUDA device) the grid's occupancy there is asked (for
    devex's instantiation or Dantzig's), and a grid that the card cannot
    hold raises RuntimeError: nothing else runs the walk on the card.
    Raises the plan's refusals: a type other than f32 and f64, a frame out
    of range (ValueError)."""
    plan = bounded_grid_plan(M, N, dtype, sms)
    if device is not None and torch.device(device).type == "cuda" and \
            bounded_grid_occupancy(M, N, dtype, devex, device) < 1:
        raise RuntimeError(f"bounded_grid: the card holds no block of "
                           f"{plan.smem} bytes of shared memory an SM "
                           f"({M} x {N} {dtype})")
    return "bounded_grid"


def run_simplex_bounded(bs: BoundedState, opts: SolverOptions | None = None
                        ) -> BoundedState:
    """Run the bounded-variable driver to termination or to
    ``opts.max_iters`` (single problem); ``RULE_DEVEX`` prices with devex
    weights. On CUDA tensors the walk runs on ``bounded_route``'s kernel,
    ``bounded_grid`` (one launch a walk; a strided tableau is handed to it
    contiguous; a grid the card cannot hold, a build or a launch failure
    raises); on CPU tensors in the plain loop."""
    if opts is None:
        opts = SolverOptions.for_dtype(bs.s.T.dtype)
    bs = _with_gamma(bs, opts)
    if on_cpu(*_tensors(bs)):
        return run_simplex_bounded_reference(bs, opts)
    stall_limit = opts.resolved_stall_limit(bs.s.m, bs.s.n)
    T = bs.s.T.contiguous()
    bs = bs._replace(s=bs.s._replace(T=T))
    M, N = T.shape
    bounded_route(M, N, T.dtype, sm_count(T.device), T.device,
                  opts.rule == RULE_DEVEX)
    return _finish(bounded_grid(bs, opts, stall_limit, opts.max_iters))


def run_simplex_bounded_batch(bs: BoundedState,
                              opts: SolverOptions | None = None
                              ) -> BoundedState:
    """Every lane of a batched BoundedState (a wave of box LPs with no
    bound rows in any lane's tableau) to its exit or to ``opts.max_iters``:
    the lane kernel on CUDA tensors, the plain vmapped loop on CPU tensors
    (``lanes.bounded_lanes``)."""
    if opts is None:
        opts = SolverOptions.for_dtype(bs.s.T.dtype)
    m = bs.s.T.shape[1] - 2
    n = bs.s.T.shape[2] - 1
    stall_limit = opts.resolved_stall_limit(m, n)
    bs = _with_gamma(bs, opts)
    bs = bs._replace(s=bs.s._replace(T=bs.s.T.contiguous()))
    return _finish(bounded_lanes(bs, opts, stall_limit, opts.max_iters))


def extract_bounded_solution(bs: BoundedState):
    """(x, z) in true variable space: basic rows carry their representation
    value, nonbasic at-upper columns sit at their span, and a flagged
    column maps back through ``u - x_rep`` (basic or not)."""
    state = bs.s
    x_rep = torch.zeros((state.n,), dtype=state.T.dtype,
                        device=state.T.device)
    x_rep = x_rep.index_put((state.basis.long(),), state.T[2:, -1])
    x_true = torch.where(bs.at_upper, bs.upper - x_rep, x_rep)
    return x_true, state.objective()
