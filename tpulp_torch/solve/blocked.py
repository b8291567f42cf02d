"""Rank-K blocked simplex driver on torch tensors.

The counterpart of ``tpulp.solve.blocked``: ``run_simplex_blocked`` for
one problem, ``run_simplex_blocked_batch`` for a batch of lanes (the same
pivot under ``torch.func.vmap``). K consecutive pivots leave the tableau alone
and append eta pairs instead: ``U[t] = (e_r - u) / piv`` and ``V[t]`` = the
current pivot row, so that the tableau after t pivots is ``T0 + U^T V``.
The objective rows and the RHS column are kept up to date as vectors, the
entering column is ``T0[:, j] + V[:, j]^T U`` and the pivot row
``T0[r] + U[:, r]^T V``. One rank-K flush ``T += U^T V`` per block is then
the only full pass over the tableau. The per-pivot decision logic is the
rank-1 driver's. The kernel engine (``tpulp_torch.solve.blocked_kernel``)
walks the same pivots with two differences, both tpulp's: its ray scan has
no gate on basic artificials, and it breaks ratio ties by first index
whatever ``SolverOptions.tie_break`` says (ROADMAP C (a), (b)).

``run_simplex_blocked`` runs the walk on CUDA tensors on the hand-written
kernels, on the route of ``blocked_route``: where a thread-block cluster
holds the block's eta factors (``kernels.blocked_cluster``'s plan, and the
card holds such a cluster), ``blocked_cluster``: the K slots of a block in
one cluster launch; else, where the grid's plan holds them
(``kernels.blocked_grid``'s, and the card holds its grid at once),
``blocked_grid``: the K slots in one cooperative launch on the whole card;
else ``kernels.blocked.blocked_steps``: six stream-ordered launches a pivot
slot. Each keeps a walk record on the card, flushes it with B1 and one ray
launch a block, and reads it once a block. On CPU tensors it runs the
eager loop below (``run_simplex_blocked_reference``: ``_blocked_pivot`` K
times, a matrix-product flush and the ray scan, one host read a block).

``run_simplex_blocked_batch`` runs every lane's walk on CUDA tensors on the
same route: ``kernels.blocked_cluster.blocked_cluster_batch`` (one cluster
launch a block for every lane, one B1 launch and one ray launch over the
lanes, one host read of every lane's (status, niter) a block); past the
cluster's plan, each lane's solo walk on the route's kernel
(``blocked_grid``, else ``blocked_steps``) in turn (a lane frozen by the
batch is a stopped solo walk, so the walks are the same). On CPU tensors
it runs the eager vmapped loop (``run_simplex_blocked_batch_reference``).
The sharded driver runs the eager pivot on either device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.precision import full_precision
from ..core.state import (RULE_BLAND, RULE_DEVEX, TIE_MAXPIV, SimplexState,
                          SolverOptions, Status, eta_scaled_options)
from ..kernels.blocked import RESET_ABOVE, blocked_steps
from ..kernels.blocked_cluster import (blocked_cluster,
                                       blocked_cluster_batch,
                                       blocked_cluster_occupancy,
                                       blocked_cluster_plan)
from ..kernels.blocked_grid import (blocked_grid, blocked_grid_occupancy,
                                    blocked_grid_plan)
from ..kernels.fma import fused_fma
from ..kernels.launch import on_cpu, sm_count
from .driver import finish, first_true, put, ratio_rows, status_select, take

__all__ = ["run_simplex_blocked", "run_simplex_blocked_reference",
           "run_simplex_blocked_batch", "run_simplex_blocked_batch_reference",
           "blocked_route"]


class _BlockCarry(NamedTuple):
    s: SimplexState        # s.T is the block-start tableau T0
    U: torch.Tensor        # (K, m+2) eta vectors (zero beyond t)
    V: torch.Tensor        # (K, n+1) pivot rows (zero beyond t)
    t: torch.Tensor        # () int32: etas accumulated this block
    row0: torch.Tensor     # (n+1,) current phase-2 objective row
    row1: torch.Tensor     # (n+1,) current phase-1 objective row
    bvec: torch.Tensor     # (m+2,) current RHS column
    gamma: torch.Tensor    # (n,) devex weights (ones unless RULE_DEVEX)


def _blocked_pivot(carry: _BlockCarry, opts: SolverOptions,
                   stall_limit: int, max_iters: int) -> _BlockCarry:
    s = carry.s
    dtype = s.T.dtype
    n = s.n
    inf = float("inf")
    running = s.status == Status.RUNNING
    in_phase2 = s.phase == 2
    basis_l = s.basis.long()

    # ---- cleanup scan: basic artificials left from phase 1 ---------------
    art_basic = s.art_cols[basis_l]
    cleanup = art_basic.any() & in_phase2 & running
    r_d = torch.argmax(art_basic.to(torch.int32))
    row_d = torch.where(
        cleanup,
        take(s.T, r_d + 2, 0) + take(carry.U, r_d + 2, 1) @ carry.V,
        0.0)
    elig = s.col_active & ~s.art_cols & (row_d[:-1].abs() > opts.piv_tol)
    has_elig = elig.any()
    j_d = first_true(elig, n - 1)
    retire = cleanup & ~has_elig
    art_cols = torch.where(
        retire, put(s.art_cols, take(basis_l, r_d), False), s.art_cols)

    # ---- pricing on the maintained objective rows ------------------------
    crow = torch.where(s.phase == 1, carry.row1[:-1], carry.row0[:-1])
    c_eff = torch.where(s.col_active, crow, inf)
    improving = c_eff < -opts.opt_tol
    has_improving = improving.any()
    use_bland = s.bland | (opts.rule == RULE_BLAND)
    if opts.rule == RULE_DEVEX:
        score = torch.where(improving, (crow * crow) / carry.gamma, -inf)
        j_best = torch.argmax(score)
    else:
        j_best = torch.argmin(c_eff)
    j_bland = first_true(improving, n - 1)
    j_price = torch.where(use_bland, j_bland, j_best)

    # ---- phase bookkeeping ------------------------------------------------
    z1 = -carry.row1[-1]
    phase1_done = (s.phase == 1) & ~has_improving & running
    became_infeasible = phase1_done & (z1 > opts.infeas_tol)
    to_phase2 = phase1_done & ~became_infeasible
    pricing_pivot = has_improving & ~cleanup & (s.phase != 0) & running

    # ---- entering column + ratio test -------------------------------------
    j = torch.where(cleanup, j_d, j_price)
    colj = take(s.T, j, 1) + take(carry.V, j, 1) @ carry.U
    has_ratio, r_price = ratio_rows(colj[2:], carry.bvec[2:], s.basis,
                                    opts.piv_tol, use_bland,
                                    opts.tie_break == TIE_MAXPIV)
    became_unbounded = pricing_pivot & ~has_ratio & in_phase2
    became_failed1 = pricing_pivot & ~has_ratio & ~in_phase2

    # ---- the one (possibly zero) eta pivot --------------------------------
    do_cleanup = cleanup & has_elig
    do_pricing = pricing_pivot & has_ratio
    act = (do_cleanup | do_pricing) & (s.niter < max_iters)
    actf = act.to(dtype)
    r = torch.where(do_cleanup, r_d, r_price)
    rg = r + 2
    piv = take(colj, rg)
    safe_piv = torch.where(act, piv, 1.0)
    onehot = (torch.arange(s.T.shape[0], device=s.T.device) == rg).to(dtype)
    w = (onehot - colj) / safe_piv
    w = w * actf
    vrow = torch.where(
        do_cleanup, row_d,
        take(s.T, rg, 0) + take(carry.U, rg, 1) @ carry.V) * actf
    U = carry.U.index_copy(0, carry.t.reshape(1).long(), w[None, :])
    V = carry.V.index_copy(0, carry.t.reshape(1).long(), vrow[None, :])

    # ---- maintain running vectors ----------------------------------------
    # fused multiply-adds, as XLA emits them for tpulp
    row0 = fused_fma(carry.row0, w[0], vrow)
    row1 = fused_fma(carry.row1, w[1], vrow)
    bvec = fused_fma(carry.bvec, w, vrow[-1])

    leaving = take(basis_l, r)
    basis = torch.where(act, put(s.basis, r, j), s.basis)

    # ---- devex weight update (post-pivot row r = vrow / piv) -------------
    if opts.rule == RULE_DEVEX:
        gamma_q = take(carry.gamma, j)
        alpha = vrow[:-1] / safe_piv
        cand = (alpha * alpha) * gamma_q
        upd = do_pricing & act
        gamma = torch.where(upd, torch.maximum(carry.gamma, cand),
                            carry.gamma)
        leave_val = torch.clamp_min(gamma_q / (safe_piv * safe_piv), 1.0)
        gamma = torch.where(upd, put(gamma, leaving, leave_val), gamma)
        gamma = torch.where(gamma.max() > RESET_ABOVE, torch.ones_like(gamma),
                            gamma)
    else:
        gamma = carry.gamma

    # ---- stall / Bland switch against the current objective --------------
    z = torch.where(s.phase == 1, -row1[-1], -row0[-1])
    improved = (s.last_z - z) > opts.degen_tol
    stuck = torch.where(do_pricing & act,
                        torch.where(improved, 0, s.stuck + 1),
                        s.stuck).to(torch.int32)
    last_z = torch.where(do_pricing & act, z, s.last_z)
    bland = s.bland | (stuck >= stall_limit)

    # ---- phase transition + termination ------------------------------------
    phase = torch.where(to_phase2, 2, s.phase).to(torch.int32)
    col_active = torch.where(to_phase2, s.col_active & ~art_cols,
                             s.col_active)
    stuck = torch.where(to_phase2, 0, stuck).to(torch.int32)
    last_z = torch.where(to_phase2, inf, last_z)
    if opts.rule == RULE_DEVEX:
        gamma = torch.where(to_phase2, torch.ones_like(gamma), gamma)

    finished_opt = in_phase2 & ~has_improving & ~cleanup & running
    finite_ok = (
        torch.isfinite(z)
        & torch.isfinite(bvec[2:].abs().sum())
        & torch.isfinite(torch.where(s.col_active, crow.abs(), 0.0).sum())
    )
    new_status = status_select(finite_ok,
                               became_infeasible | became_failed1,
                               became_unbounded, finished_opt)
    status = torch.where(running, new_status, s.status)

    s = SimplexState(
        T=s.T,
        basis=basis,
        col_active=col_active,
        art_cols=art_cols,
        phase=phase,
        status=status,
        niter=s.niter + act.to(torch.int32),
        stuck=stuck,
        bland=bland,
        last_z=last_z,
    )
    return _BlockCarry(s=s, U=U, V=V, t=carry.t + act.to(torch.int32),
                       row0=row0, row1=row1, bvec=bvec, gamma=gamma)


def _fresh_carry(s: SimplexState, K: int, gamma=None) -> _BlockCarry:
    M, N = s.T.shape
    kw = dict(dtype=s.T.dtype, device=s.T.device)
    return _BlockCarry(
        s=s,
        U=torch.zeros((K, M), **kw),
        V=torch.zeros((K, N), **kw),
        t=torch.zeros((), dtype=torch.int32, device=s.T.device),
        row0=s.T[0, :].clone(),
        row1=s.T[1, :].clone(),
        bvec=s.T[:, -1].clone(),
        gamma=torch.ones((N - 1,), **kw) if gamma is None else gamma,
    )


def blocked_route(M: int, N: int, K: int, dtype,
                  device: torch.device) -> str:
    """The kernel that runs a solo blocked walk in blocks of ``K`` on an (M,
    N) tableau of ``dtype`` on the CUDA ``device``: "blocked_cluster" where
    its plan fits (K, the cluster's size and shared memory) and the card
    holds one such cluster (``cudaOccupancyMaxActiveClusters`` >= 1), else
    "blocked_grid" where the grid's plan fits the card's SMs and the card
    holds the whole grid at once (its occupancy times the SMs), else
    "blocked_step"."""
    try:
        blocked_cluster_plan(M, N, K, dtype)
    except ValueError:  # factors past 16 blocks' shared memory, a K past it
        pass
    else:
        if blocked_cluster_occupancy(M, N, K, dtype, device) >= 1:
            return "blocked_cluster"
    sms = sm_count(device)
    try:
        plan = blocked_grid_plan(M, N, K, dtype, sms)
    except ValueError:  # slabs past a block's shared memory
        return "blocked_step"
    if blocked_grid_occupancy(M, N, K, dtype, device) * sms < plan.blocks:
        return "blocked_step"
    return "blocked_grid"


def _solo_walk(route: str):
    """The solo walk of ``route``."""
    return {"blocked_cluster": blocked_cluster, "blocked_grid": blocked_grid,
            "blocked_step": blocked_steps}[route]


@full_precision()
def run_simplex_blocked(state: SimplexState,
                        opts: SolverOptions | None = None,
                        block: int = 64) -> SimplexState:
    """Run the rank-K blocked driver to termination or to
    ``opts.max_iters`` (single problem), in blocks of ``block`` pivots with
    one host read of the status a block: on the kernel of ``blocked_route``
    for CUDA tensors (a strided tableau is handed to it contiguous; a build
    or launch failure raises), as the eager loop for CPU tensors."""
    if opts is None:
        opts = SolverOptions.for_dtype(state.T.dtype)
    opts = eta_scaled_options(opts, state.T.dtype)
    if on_cpu(*state):
        return run_simplex_blocked_reference(state, opts, block)
    stall_limit = opts.resolved_stall_limit(state.m, state.n)
    state = state._replace(T=state.T.contiguous())
    M, N = state.T.shape
    run = _solo_walk(blocked_route(M, N, block, state.T.dtype,
                                   state.T.device))
    out, _ = run(state, opts, stall_limit, opts.max_iters, block)
    return finish(out)


@full_precision()
def run_simplex_blocked_reference(state: SimplexState,
                                  opts: SolverOptions | None = None,
                                  block: int = 64) -> SimplexState:
    """The eager rank-K blocked driver on any device: ``block`` eager
    pivots, the flush ``T + U^T V`` as a matrix product and the ray scan,
    with one host read of the status a block. ``run_simplex_blocked``'s
    CPU path."""
    if opts is None:
        opts = SolverOptions.for_dtype(state.T.dtype)
    opts = eta_scaled_options(opts, state.T.dtype)
    stall_limit = opts.resolved_stall_limit(state.m, state.n)
    max_iters = opts.max_iters
    carry = _fresh_carry(state, block)
    while True:
        s = carry.s
        status, niter = torch.stack([s.status, s.niter]).tolist()
        if status != Status.RUNNING or niter >= max_iters:
            break
        for _ in range(block):
            carry = _blocked_pivot(carry, opts, stall_limit, max_iters)
        # devex weights persist across the flush
        carry = _fresh_carry(_flush(carry, opts), block, carry.gamma)
    return finish(carry.s)


def _flush(carry: _BlockCarry, opts: SolverOptions) -> SimplexState:
    """The block's end: one rank-K flush ``T += U^T V``, then the per-block
    ray scan on the flushed tableau: an improving active phase-2 column
    with no entry above piv_tol certifies unboundedness, once no
    artificial is basic."""
    T = carry.s.T + carry.U.T @ carry.V
    s = carry.s._replace(T=T)
    improving = s.col_active & (T[0, :-1] < -opts.opt_tol)
    blocked_col = (T[2:, :-1] > opts.piv_tol).any(dim=0)
    ray = ((improving & ~blocked_col).any()
           & ~s.art_cols[s.basis.long()].any()
           & (s.phase == 2) & (s.status == Status.RUNNING))
    return s._replace(status=torch.where(ray, Status.UNBOUNDED,
                                         s.status).to(torch.int32))


def _ray_scan(T: torch.Tensor, s: SimplexState, opts: SolverOptions):
    """The per-block ray scan of every lane of a flushed batch: an improving
    active phase-2 column with no entry above piv_tol, no artificial
    basic, the lane still running."""
    improving = s.col_active & (T[:, 0, :-1] < -opts.opt_tol)
    blocked_col = (T[:, 2:, :-1] > opts.piv_tol).any(dim=1)
    return ((improving & ~blocked_col).any(dim=1)
            & ~torch.gather(s.art_cols, 1, s.basis.long()).any(dim=1)
            & (s.phase == 2) & (s.status == Status.RUNNING))


@full_precision()
def run_simplex_blocked_batch(batched: SimplexState,
                              opts: SolverOptions | None = None,
                              block: int = 64) -> SimplexState:
    """The rank-K blocked driver over every lane of a batched state, in
    blocks of ``block`` pivots with one host read of every lane's status a
    block; a lane that was not running within the budget at the start of a
    block keeps its whole state through the block, as in tpulp's vmapped
    ``while_loop``. On CUDA tensors every lane's walk runs on the kernel of
    ``blocked_route`` (``blocked_cluster_batch``, else each lane on
    ``blocked_grid`` or ``blocked_steps`` in turn; a build or launch failure
    raises), on CPU tensors as the eager vmapped loop."""
    if opts is None:
        opts = SolverOptions.for_dtype(batched.T.dtype)
    opts = eta_scaled_options(opts, batched.T.dtype)
    if on_cpu(*batched):
        return run_simplex_blocked_batch_reference(batched, opts, block)
    B, M, N = batched.T.shape
    stall_limit = opts.resolved_stall_limit(M - 2, N - 1)
    batched = batched._replace(T=batched.T.contiguous())
    route = blocked_route(M, N, block, batched.T.dtype, batched.T.device)
    if route == "blocked_cluster":
        out, _ = blocked_cluster_batch(batched, opts, stall_limit,
                                       opts.max_iters, block)
    else:
        run = _solo_walk(route)
        lanes = [run(SimplexState(*(x[k] for x in batched)), opts,
                     stall_limit, opts.max_iters, block)[0]
                 for k in range(B)]
        out = SimplexState(*(torch.stack(xs) for xs in zip(*lanes)))
    return finish(out)


@full_precision()
def run_simplex_blocked_batch_reference(batched: SimplexState,
                                        opts: SolverOptions | None = None,
                                        block: int = 64) -> SimplexState:
    """The eager rank-K blocked driver over every lane of a batched state
    on any device: ``block`` vmapped eta pivots, one batched flush ``T +
    U^T V``, the ray scan per lane, and one host read of "any lane running"
    per block; a lane that was not running within the budget at the start
    of a block keeps its whole state through the block, as in tpulp's
    vmapped ``while_loop``. ``run_simplex_blocked_batch``'s CPU path."""
    if opts is None:
        opts = SolverOptions.for_dtype(batched.T.dtype)
    opts = eta_scaled_options(opts, batched.T.dtype)
    m = batched.T.shape[1] - 2
    n = batched.T.shape[2] - 1
    stall_limit = opts.resolved_stall_limit(m, n)
    max_iters = opts.max_iters
    pivot = torch.func.vmap(
        lambda c: _blocked_pivot(c, opts, stall_limit, max_iters))
    carry = _fresh_batch(batched, block, torch.ones(
        (batched.T.shape[0], n), dtype=batched.T.dtype,
        device=batched.T.device))
    while True:
        s0, gamma0 = carry.s, carry.gamma
        live = (s0.status == Status.RUNNING) & (s0.niter < max_iters)
        if not bool(live.any()):
            break
        for _ in range(block):
            carry = pivot(carry)
        # one batched rank-K flush: T += U^T V on every lane
        T = carry.s.T + carry.U.transpose(1, 2) @ carry.V
        s = carry.s._replace(T=T)
        s = s._replace(status=torch.where(_ray_scan(T, s, opts),
                                          Status.UNBOUNDED,
                                          s.status).to(torch.int32))
        # lanes that were not running at the block start keep their state
        s = SimplexState(*(torch.where(_lanes(live, new), new, old)
                           for new, old in zip(s, s0)))
        carry = _fresh_batch(s, block, torch.where(live[:, None],
                                                   carry.gamma, gamma0))
    return finish(carry.s)


def _lanes(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-lane mask shaped to broadcast against ``like``."""
    return mask.reshape((-1,) + (1,) * (like.dim() - 1))


def _fresh_batch(s: SimplexState, K: int, gamma) -> _BlockCarry:
    """``_fresh_carry`` of every lane of a batched state."""
    B, M, N = s.T.shape
    kw = dict(dtype=s.T.dtype, device=s.T.device)
    return _BlockCarry(
        s=s,
        U=torch.zeros((B, K, M), **kw),
        V=torch.zeros((B, K, N), **kw),
        t=torch.zeros((B,), dtype=torch.int32, device=s.T.device),
        row0=s.T[:, 0, :].clone(),
        row1=s.T[:, 1, :].clone(),
        bvec=s.T[:, :, -1].clone(),
        gamma=gamma,
    )
