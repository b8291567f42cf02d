"""Dual simplex, warm frames and the batched branch-and-bound waves.

The counterpart of ``tpulp.solve.dual``. A branch-and-bound child differs
from its parent only in ``b``, so the parent's optimal basis stays dual
feasible and the dual simplex re-optimizes it in a few pivots.
``dual_simplex_step`` is the same branchless transition as tpulp's: the
leaving row is the most negative ``b_r`` (the first negative row once the
stall limit switched to Bland), the entering column the smallest
``c_j / -T[r, j]`` over ``T[r, j] < -piv_tol`` with first-index ties; no
eligible column proves the row infeasible.

tpulp vmaps ``lax.while_loop``s over lanes. Here ``solve.lanes`` runs
them: on the card one lane kernel per loop (``kernels.lanes``, one block
per lane, each lane stepped to its own exit in one launch with no host
read), on the CPU the single-state steps vmapped over the lane axis. The
warm waves run two loops that share one ``niter`` budget: the dual
simplex, then a primal clean-up (OPTIMAL lanes are reopened as RUNNING,
and lanes still RUNNING at the end become ITERATION_LIMIT), so a wave's
loops are two launches on the card.

Three scatters of tpulp drop out-of-range indices (``mode="drop"``); torch
has no such mode. The state pool therefore carries one sink row at index
``cap`` (``new_pool``): a write to slot ``cap`` lands there and the sink
is never read. The child-lane scatters of ``run_expand_generation`` write
into a buffer one longer than the batch and drop the last entry. The pool
is written in place: every gather from it is an advanced-index copy,
ordered on the device stream before any later write.

Every entry runs inside ``full_precision``: the priced objective row of a
frame and the integrality check's recover product are matrix products that
TF32 would round.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.precision import full_precision
from ..core.state import SimplexState, SolverOptions, Status
from ..kernels.fma import fused_fma
from ..kernels.launch import on_cpu
from .driver import (finish, first_true, pivot_update, put, run_chunked,
                     solo_walk, take)
from .lanes import dual_lanes, primal_lanes

__all__ = [
    "dual_simplex_step",
    "run_dual_simplex",
    "warm_state_from_basis",
    "run_warm_batch",
    "run_warm_carry_batch",
    "run_warm_wave",
    "run_expand_generation",
    "pool_write",
    "pack_wave_summary",
    "new_pool",
]


def dual_simplex_step(state: SimplexState, opts: SolverOptions,
                      stall_limit: int, max_iters: int | None = None
                      ) -> SimplexState:
    """One dual-simplex transition (see ``tpulp.solve.dual``). With
    ``max_iters`` the step is a no-op once ``niter`` reaches it."""
    T = state.T
    inf = float("inf")
    running = state.status == Status.RUNNING
    if max_iters is not None:
        running = running & (state.niter < max_iters)

    b = T[2:, -1]
    m = b.shape[0]
    neg = b < -opts.feas_tol
    feasible = ~neg.any()

    # ---- leaving row: most-negative b; first-negative after stall ----------
    r = torch.where(state.bland, first_true(neg, m - 1), torch.argmin(b))

    # ---- entering column: dual ratio test on the leaving row ---------------
    row = take(T, r + 2, 0)[:-1]
    crow = T[0, :-1]
    elig = state.col_active & (row < -opts.piv_tol)
    has_elig = elig.any()
    ratios = torch.where(elig, crow / torch.where(elig, -row, 1.0), inf)
    tie = elig & (ratios <= ratios.min())
    # the first index of the tie mask (argmax of a bool is refused on CUDA)
    j = torch.argmax(tie.to(torch.int32))

    became_optimal = running & feasible
    do_pivot = running & ~feasible & has_elig
    became_infeasible = running & ~feasible & ~has_elig

    # ---- the one pivot (no-op redirected to an exact unit pivot) -----------
    r_eff = torch.where(do_pivot, r + 2, 2)
    j_eff = torch.where(do_pivot, j, state.basis[0].long())
    Tn = pivot_update(T, r_eff, j_eff)
    basis = torch.where(do_pivot, put(state.basis, r, j), state.basis)

    # ---- stall detection: the dual objective does not decrease ------------
    z = -Tn[0, -1]
    improved = (z - state.last_z) > opts.degen_tol
    stuck = torch.where(do_pivot,
                        torch.where(improved, 0, state.stuck + 1),
                        state.stuck).to(torch.int32)
    last_z = torch.where(do_pivot, z, state.last_z)
    bland = state.bland | (stuck >= stall_limit)

    finite_ok = (
        torch.isfinite(z)
        & torch.isfinite(Tn[2:, -1].abs().sum())
        & torch.isfinite(torch.where(state.col_active, crow.abs(), 0.0).sum())
    )
    new_status = torch.where(
        ~finite_ok, Status.NUMERIC,
        torch.where(became_infeasible, Status.INFEASIBLE,
                    torch.where(became_optimal, Status.OPTIMAL,
                                Status.RUNNING))).to(torch.int32)
    status = torch.where(running, new_status, state.status)

    return SimplexState(
        T=Tn,
        basis=basis,
        col_active=state.col_active,
        art_cols=state.art_cols,
        phase=state.phase,
        status=status,
        niter=state.niter + do_pivot.to(torch.int32),
        stuck=stuck,
        bland=bland,
        last_z=last_z,
    )


@full_precision()
def run_dual_simplex(state: SimplexState, opts: SolverOptions | None = None
                     ) -> SimplexState:
    """Run the dual simplex on one problem to termination or the budget:
    the plain loop on CPU tensors; on CUDA tensors ``lane_dual`` at B = 1,
    ``rank1_cluster``'s or ``rank1_grid``'s dual walk (the route rule of
    ``solve/driver.py``)."""
    if opts is None:
        opts = SolverOptions.for_dtype(state.T.dtype)
    stall_limit = opts.resolved_stall_limit(state.m, state.n)
    if not on_cpu(*state):
        return finish(solo_walk("dual", state, opts, stall_limit))
    out = run_chunked(
        lambda s: dual_simplex_step(s, opts, stall_limit, opts.max_iters),
        state, lambda s: s, opts.max_iters)
    return finish(out)


def _dual_then_primal(st: SimplexState, opts: SolverOptions,
                      stall_limit: int, max_iters: int) -> SimplexState:
    """The warm waves' two loops over lanes: the dual simplex, then the
    primal clean-up (f32 drift can leave slightly negative reduced costs;
    the primal step ends at once on a lane that is already optimal)."""
    st = dual_lanes(st, opts, stall_limit, max_iters)
    st = st._replace(status=torch.where(
        st.status == Status.OPTIMAL, Status.RUNNING, st.status))
    return finish(primal_lanes(st, opts, stall_limit, max_iters))


def _lanes(T, basis, col_active, art_cols, status=None) -> SimplexState:
    """Fresh phase-2 states of B lanes from their frames; the masks are one
    row broadcast to every lane."""
    B = T.shape[0]
    dev = T.device

    def full(v, dt):
        return torch.full((B,), v, dtype=dt, device=dev)

    return SimplexState(
        T=T,
        basis=basis.to(torch.int32),
        col_active=col_active.expand(B, -1),
        art_cols=art_cols.expand(B, -1),
        phase=full(2, torch.int32),
        status=full(Status.RUNNING, torch.int32) if status is None
        else status,
        niter=full(0, torch.int32),
        stuck=full(0, torch.int32),
        bland=full(False, torch.bool),
        last_z=full(-float("inf"), T.dtype),
    )


def _ints(x, device) -> torch.Tensor:
    """A host or device integer vector as a long tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.long)
    return torch.as_tensor(np.asarray(x, np.int64), device=device)


def _rhs_rewrite(T: torch.Tensor, cols: torch.Tensor, coef: torch.Tensor
                 ) -> torch.Tensor:
    """``T[k, :, -1] += coef[k] * T[k, :, cols[k]]`` on every lane, in place
    on the gathered frames: row i's b moves by ``coef`` through its slack
    or surplus column, whose current column is ``+-B^-1 e_i``."""
    lanes = torch.arange(T.shape[0], device=T.device)
    colv = T[lanes, :, cols]                              # (B, m + 2)
    # one fused multiply-add per element, as XLA emits it for tpulp
    T[:, :, -1] = fused_fma(T[:, :, -1], coef[:, None], colv)
    return T


def _frames(A_aug, c_full, basis_mat, b_mat) -> torch.Tensor:
    """(B, m+2, n+1) tableau frames of the bases ``basis_mat`` (B, m) for
    the right-hand sides ``b_mat`` (B, m): ``B^-1 [A | b]`` with the
    objective row priced over the basis, basic columns snapped to exact
    unit vectors and their reduced costs to 0. A singular basis gives a
    NaN frame (the caller's finiteness checks take it from there)."""
    m, n = A_aug.shape
    B = basis_mat.shape[0]
    dtype, dev = A_aug.dtype, A_aug.device
    bl = basis_mat.long()
    Bmat = A_aug[:, bl].permute(1, 0, 2)                  # (B, m, m)
    aug = torch.cat([A_aug.expand(B, m, n), b_mat[:, :, None]], dim=2)
    rows, info = torch.linalg.solve_ex(Bmat, aug)         # B^-1 [A | b]
    rows = torch.where((info != 0)[:, None, None], float("nan"), rows)
    cb = c_full[bl]                                       # (B, m)
    red = (torch.cat([c_full, torch.zeros(1, dtype=dtype, device=dev)])
           - (cb[:, None, :] @ rows)[:, 0])               # (B, n + 1)
    is_basic = torch.zeros((B, n), dtype=torch.bool, device=dev)
    is_basic.scatter_(1, bl, True)
    unit = torch.zeros((B, m, n), dtype=dtype, device=dev)
    unit.scatter_(2, bl[:, :, None], 1.0)
    rows[:, :, :n] = torch.where(is_basic[:, None, :], unit, rows[:, :, :n])
    red.scatter_(1, bl, 0.0)
    T = torch.zeros((B, m + 2, n + 1), dtype=dtype, device=dev)
    T[:, 0] = red
    T[:, 2:] = rows
    return T


@full_precision()
def warm_state_from_basis(A_aug, c_full, col_active, art_cols, basis, b
                          ) -> SimplexState:
    """The phase-2 state of ``basis`` for RHS ``b`` (one problem):
    ``A_aug`` is the root's (m, n) constraint block including the
    artificial unit columns, ``c_full`` its (n,) costs."""
    dev = A_aug.device
    basis = _ints(basis, dev)
    b = torch.as_tensor(b, dtype=A_aug.dtype, device=dev)
    T = _frames(A_aug, c_full, basis[None], b[None])
    lanes = _lanes(T, basis[None], col_active, art_cols)
    return SimplexState(*(x[0] for x in lanes))


@full_precision()
def run_warm_batch(A_aug, c_full, col_active, art_cols, basis_mat, b_mat,
                   opts: SolverOptions | None = None) -> SimplexState:
    """Solve a wave of b-rewritten nodes warm-started from per-lane bases:
    the shared root frame (``A_aug`` with its artificial columns, ``c_full``,
    masks), ``basis_mat`` (B, m) and ``b_mat`` (B, m). Returns the terminal
    batched state: OPTIMAL / INFEASIBLE / ITERATION_LIMIT / NUMERIC."""
    if opts is None:
        opts = SolverOptions.for_dtype(A_aug.dtype)
    m, n = A_aug.shape
    dev = A_aug.device
    basis_mat = _ints(basis_mat, dev)
    b_mat = torch.as_tensor(b_mat, dtype=A_aug.dtype, device=dev)
    st = _lanes(_frames(A_aug, c_full, basis_mat, b_mat), basis_mat,
                col_active, art_cols)
    return _dual_then_primal(st, opts, opts.resolved_stall_limit(m, n),
                             opts.max_iters)


def new_pool(cap: int, shape, m: int, dtype, device):
    """A state pool of ``cap`` slots of (m+2, n+1) frames and (m,) bases,
    plus the sink row at index ``cap`` that takes dropped writes."""
    return (torch.zeros((cap + 1,) + tuple(shape), dtype=dtype,
                        device=device),
            torch.zeros((cap + 1, m), dtype=torch.int32, device=device))


def pool_write(pool_T, pool_basis, slots, T_wave, basis_wave, lanes):
    """Write lanes ``lanes`` of a wave's terminal state into pool slots
    ``slots`` (both fixed width), in place. A slot at or past the pool's
    capacity goes to the sink row: the host pads unused positions with
    ``cap``. Returns the pool."""
    cap = pool_T.shape[0] - 1
    dev = pool_T.device
    s = _ints(slots, dev).clamp(0, cap)
    lane = _ints(lanes, dev)
    pool_T.index_copy_(0, s, T_wave.index_select(0, lane))
    pool_basis.index_copy_(
        0, s, basis_wave.index_select(0, lane).to(torch.int32))
    return pool_T, pool_basis


def _wave_summaries(out: SimplexState, R, const) -> torch.Tensor:
    """Everything the B&B host loop reads of a wave, in ONE array of the
    tableau dtype, (B, m+6+n_int): [corner, maxdist, branch value, status,
    niter, argmax-fractional, basis..., int-var values...]. The integer
    fields are exact in f32 (all below 2^24). The integrality check is the
    recover ``R @ x + const`` per lane, reduced to the largest distance to
    an integer, the most fractional variable and its value."""
    T = out.T
    B = T.shape[0]
    dtype = T.dtype
    # R spans the batched columns: frames of a column shard (the mesh
    # waves) are narrower than x, whose entries come from the basis
    x = torch.zeros((B, R.shape[1]), dtype=dtype, device=T.device)
    x.scatter_(1, out.basis.long(), T[:, 2:, -1])
    vals = x @ R.T + const                                # (B, n_int)
    dist = (vals - torch.round(vals)).abs()
    am = torch.argmax(dist, dim=1, keepdim=True)
    return torch.cat(
        [T[:, 0, -1:], dist.gather(1, am), vals.gather(1, am),
         out.status[:, None].to(dtype), out.niter[:, None].to(dtype),
         am.to(dtype), out.basis.to(dtype), vals], dim=1)


@full_precision()
def pack_wave_summary(out: SimplexState, R, const) -> torch.Tensor:
    """The summary of a wave that ran elsewhere (the cold waves)."""
    return _wave_summaries(out, R, const)


@full_precision()
def run_warm_carry_batch(pool_T, pool_basis, col_active, art_cols, idx,
                         cols, deltas, opts: SolverOptions | None = None
                         ) -> SimplexState:
    """Solve a wave of children from their parents' terminal frames: lane k
    gathers pool slot ``idx[k]``, moves b through column ``cols[k]`` by
    ``deltas[k]`` (the surplus sign folded in by the caller), then runs the
    dual simplex and the primal clean-up."""
    if opts is None:
        opts = SolverOptions.for_dtype(pool_T.dtype)
    m = pool_T.shape[1] - 2
    n = pool_T.shape[2] - 1
    dev = pool_T.device
    idx = _ints(idx, dev)
    deltas = torch.as_tensor(deltas, dtype=pool_T.dtype, device=dev)
    T = _rhs_rewrite(pool_T[idx], _ints(cols, dev), deltas)
    st = _lanes(T, pool_basis[idx], col_active, art_cols)
    return _dual_then_primal(st, opts, opts.resolved_stall_limit(m, n),
                             opts.max_iters)


@full_precision()
def run_warm_wave(pool_T, pool_basis, col_active, art_cols, prev_T,
                  prev_basis, ipack, R, const, max_iters: int,
                  opts: SolverOptions | None = None):
    """The whole warm wave: the previous wave's deferred pool writes, the
    gather of each child's parent frame, the sparse RHS rewrite, the dual
    simplex, the primal clean-up and the summary. ``ipack`` (B, 5) int32 is
    [parent slot, rewrite column, deferred-write slot, deferred-write lane,
    rhs delta], one upload per wave. Returns ``(pool_T, pool_basis,
    out_state, summary)``."""
    if opts is None:
        opts = SolverOptions.for_dtype(pool_T.dtype)
    m = pool_T.shape[1] - 2
    n = pool_T.shape[2] - 1
    ip = _ints(ipack, pool_T.device)
    # the deferred writes first, so that same-wave children see their
    # parents
    pool_write(pool_T, pool_basis, ip[:, 2], prev_T, prev_basis, ip[:, 3])
    idx = ip[:, 0]
    T = _rhs_rewrite(pool_T[idx], ip[:, 1], ip[:, 4].to(pool_T.dtype))
    st = _lanes(T, pool_basis[idx], col_active, art_cols)
    out = _dual_then_primal(st, opts, opts.resolved_stall_limit(m, n),
                            max_iters)
    return pool_T, pool_basis, out, _wave_summaries(out, R, const)


def expand_plan(summ_prev, active, lbmat, ubmat, le_col, le_sign, ge_col,
                ge_sign, corner_cut, int_tol):
    """The host-free bookkeeping of one device generation, on every lane
    of the batch: which solved lanes expand (active, optimal, fractional
    past ``int_tol``, corner strictly above ``corner_cut``), each child
    lane's parent, side, RHS rewrite column and coefficient, and the
    children's bounds. Returns ``(pp, col, coef, status, parent_of, is_up,
    valid, lb_next, ub_next, e32)``."""
    B = summ_prev.shape[0]
    dev = summ_prev.device
    corner = summ_prev[:, 0]
    maxdist = summ_prev[:, 1]
    bval = summ_prev[:, 2]
    statuses = summ_prev[:, 3].to(torch.int32)
    am = summ_prev[:, 5].long()
    # corner = -z_rel, so the cut is an upper bound: expand strictly above
    expand = (active & (statuses == Status.OPTIMAL)
              & (maxdist > int_tol) & (corner > corner_cut))
    e32 = expand.to(torch.int32)
    base = 2 * (torch.cumsum(e32, 0) - e32)
    lane_ids = torch.arange(B, dtype=torch.int32, device=dev)
    # child lanes past B land in entry B of the one-longer buffers
    scat = torch.where(expand, base, B).long()
    parent_of = torch.full((B + 1,), -1, dtype=torch.int32, device=dev)
    parent_of[scat.clamp(max=B)] = lane_ids
    parent_of[(scat + 1).clamp(max=B)] = lane_ids
    is_up = torch.zeros((B + 1,), dtype=torch.int32, device=dev)
    is_up[(scat + 1).clamp(max=B)] = 1
    parent_of, is_up = parent_of[:B], is_up[:B]

    valid = parent_of >= 0
    pp = parent_of.clamp(min=0).long()
    v = am[pp]
    f = torch.floor(bval[pp])
    lb_p = lbmat[pp]
    ub_p = ubmat[pp]
    upb = is_up > 0
    lbv = lb_p.gather(1, v[:, None])[:, 0]
    ubv = ub_p.gather(1, v[:, None])[:, 0]
    delta_b = torch.where(upb, (f + 1) - lbv, f - ubv)
    col = torch.where(upb, ge_col[v], le_col[v]).long()
    sgn = torch.where(upb, ge_sign[v], le_sign[v])
    coef = torch.where(valid, sgn * delta_b, 0.0)
    lb_next = torch.where(upb[:, None],
                          lb_p.scatter(1, v[:, None], (f + 1)[:, None]),
                          lb_p)
    ub_next = torch.where(upb[:, None], ub_p,
                          ub_p.scatter(1, v[:, None], f[:, None]))
    status = torch.where(valid, Status.RUNNING,
                         Status.INFEASIBLE).to(torch.int32)
    return (pp, col, coef, status, parent_of, is_up, valid, lb_next,
            ub_next, e32)


def genealogy_summary(out: SimplexState, R, const, parent_of, is_up
                      ) -> torch.Tensor:
    """A generation's summary with its two genealogy columns (parent lane,
    is_up)."""
    dtype = out.T.dtype
    return torch.cat([_wave_summaries(out, R, const),
                      parent_of[:, None].to(dtype),
                      is_up[:, None].to(dtype)], dim=1)


@full_precision()
def run_expand_generation(prev_T, prev_basis, summ_prev, active, lbmat,
                          ubmat, col_active, art_cols, le_col, le_sign,
                          ge_col, ge_sign, corner_cut, int_tol,
                          max_iters: int, R, const,
                          opts: SolverOptions | None = None):
    """One branch-and-bound generation on the device: every lane of a
    solved wave that is active, optimal, fractional (maxdist > int_tol) and
    whose corner lies strictly above ``corner_cut`` gets its down and up
    child at lanes ``2 * cumsum_excl(expand)`` and ``+1`` (a floor/ceil
    split of its most fractional variable, applied as the sparse b
    rewrite); children past the batch width are dropped, and the host
    re-queues them cold. The children are re-optimized. Returns
    ``(out_state, summary_aug, next_active, lbmat, ubmat, expand_mask)``;
    the summary gains two genealogy columns (parent lane, is_up)."""
    if opts is None:
        opts = SolverOptions.for_dtype(prev_T.dtype)
    _, M, N = prev_T.shape
    (pp, col, coef, status, parent_of, is_up, valid, lb_next, ub_next,
     e32) = expand_plan(summ_prev, active, lbmat, ubmat, le_col, le_sign,
                        ge_col, ge_sign, corner_cut, int_tol)
    T = _rhs_rewrite(prev_T[pp], col, coef)
    st = _lanes(T, prev_basis[pp], col_active, art_cols, status=status)
    out = _dual_then_primal(st, opts, opts.resolved_stall_limit(M - 2, N - 1),
                            max_iters)
    summary = genealogy_summary(out, R, const, parent_of, is_up)
    return out, summary, valid, lb_next, ub_next, e32
