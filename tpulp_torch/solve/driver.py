"""Rank-1 two-phase simplex driver on torch tensors.

The counterpart of ``tpulp.solve.driver``. One ``simplex_step`` is the same
branchless transition: pricing, ratio test, one unconditional rank-1 pivot
(redirected to an exact no-op when nothing should move), the Bland switch,
the phase change and the status, all as tensor selects, so a step never
waits for the host. torch has no ``lax.while_loop``: ``run_simplex`` runs
the step in a Python loop and reads the status on the host once per chunk
of steps. The step freezes itself once ``niter`` reaches the budget, so a
chunk cannot run past it and the pivot count equals tpulp's.

That loop is the CPU path. On CUDA tensors the solo walks run on
hand-written kernels, with no host read inside a chunk, by one rule
(``solo_route``, for an (M, N) = (m + 2, n + 1) tableau), for the walks
of ``run_simplex`` (Dantzig, Bland, the greatest increase, ``RULE_DEVEX``
priced as Dantzig; first-index or largest-pivot ties),
``devex.run_simplex_devex`` and ``dual.run_dual_simplex``:

1. the primal or dual walk of a frame resident in one block
   (``lane_plan(M, N, dtype).resident``, the dual walk's
   ``lane_dual_plan``): ``lane_primal`` / ``lane_dual``
   at B = 1 (the whole walk in one launch, ``kernels.lanes``; they take no
   devex weights);
2. otherwise, a frame that a thread-block cluster of at most 8 blocks
   holds (``cluster_plan`` fits): ``rank1_cluster`` (the whole walk in one
   launch of one cluster, the frame in the blocks' shared memory,
   ``kernels.rank1_cluster``);
3. otherwise ``rank1_grid`` (the whole walk in one persistent cooperative
   launch on the whole card, ``kernels.rank1_grid``, on
   ``rank1_grid_plan``'s plan: a column slab of the frame in each SM's
   shared memory, the rows past it streamed through device memory, the
   per-row vectors in device memory past the replicated ones, every row
   streamed past a slab's first three), where the card holds at least one
   block of the plan an SM (``rank1_grid_occupancy``).

Each gets the plain loop's ``stall_limit`` and ``opts.max_iters``, so
``finish`` and the absolute ``niter`` budgets of ``refresh.py`` hold, and
a contiguous tableau. There is no fallback: a plan, build or launch
failure raises, and so does a grid plan that the card cannot hold.
"""

from __future__ import annotations

import torch

from ..core.state import (RULE_BLAND, RULE_MAX_INCREASE, TIE_MAXPIV,
                          SimplexState, SolverOptions, Status)
from ..kernels.bounded_grid import GRID_SMS
from ..kernels.fma import fused_fma
from ..kernels.lanes import (lane_dual, lane_dual_plan, lane_plan,
                             lane_primal)
from ..kernels.launch import on_cpu, sm_count
from ..kernels.rank1_cluster import cluster_plan, rank1_cluster
from ..kernels.rank1_grid import (rank1_grid, rank1_grid_occupancy,
                                  rank1_grid_plan)

__all__ = [
    "simplex_step",
    "run_simplex",
    "extract_solution",
    "pivot_update",
    "find_pivot_all",
    "solo_route",
    "solo_walk",
    "one_lane",
]

BIG_I = 2 ** 30
# the longest chunk of steps between two host reads of the status
CHUNK = 32


def take(x: torch.Tensor, i: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``x`` indexed at the 0-d index tensor ``i`` along ``dim``, without a
    host round trip."""
    return torch.index_select(x, dim, i.reshape(1).long()).squeeze(dim)


def put(x: torch.Tensor, i: torch.Tensor, v) -> torch.Tensor:
    """A copy of the 1-d ``x`` with entry ``i`` set to ``v``."""
    if isinstance(v, torch.Tensor):
        v = v.to(x.dtype).reshape(1)
    else:
        # a fill on the device: a Python scalar moved as a tensor would be a
        # blocking host-to-device copy in every step
        v = torch.full((1,), v, dtype=x.dtype, device=x.device)
    return x.index_put((i.reshape(1).long(),), v)


def first_true(mask: torch.Tensor, default: int) -> torch.Tensor:
    """Smallest index where ``mask`` holds, else ``default``."""
    ids = torch.arange(mask.shape[0], device=mask.device)
    return torch.where(mask, ids, default).min()


def pivot_update(T: torch.Tensor, r_glob: torch.Tensor,
                 j: torch.Tensor) -> torch.Tensor:
    """Gauss-Jordan rank-1 pivot on global row ``r_glob``, column ``j``:
    ``T - T[:, j] (x) (T[r] / piv)``, the pivot row normalised, column
    ``j`` snapped to the exact unit vector."""
    nrows, ncols = T.shape
    row = take(T, r_glob, 0)
    piv = take(row, j)
    prow = row * (1.0 / piv)
    colv = take(T, j, 1)
    is_r = (torch.arange(nrows, device=T.device) == r_glob)[:, None]
    is_j = (torch.arange(ncols, device=T.device) == j)[None, :]
    # one fused multiply-add per element, as XLA emits it for tpulp
    Tn = fused_fma(T, colv[:, None], prow[None, :], -1.0)
    Tn = torch.where(is_r, prow[None, :], Tn)
    return torch.where(is_j, is_r.to(T.dtype), Tn)


def status_select(finite_ok, infeasible, unbounded, optimal):
    """The new status code from the step's verdict flags, in tpulp's
    order of precedence."""
    return torch.where(
        ~finite_ok, Status.NUMERIC,
        torch.where(infeasible, Status.INFEASIBLE,
                    torch.where(unbounded, Status.UNBOUNDED,
                                torch.where(optimal, Status.OPTIMAL,
                                            Status.RUNNING)))
    ).to(torch.int32)


def ratio_rows(col, b, basis, piv_tol: float, use_bland,
               max_piv: bool = False):
    """Ratio test over one entering column: (has_ratio, row), with the
    first-index (``max_piv``: largest-pivot) tie rule and Bland's smallest
    basic index among ties."""
    inf = float("inf")
    pos = col > piv_tol
    has_ratio = pos.any()
    ratios = torch.where(pos, b / torch.where(pos, col, 1.0), inf)
    tie = ratios <= ratios.min()
    if max_piv:
        r_first = torch.argmax(torch.where(tie, col, -inf))
    else:
        r_first = torch.argmax(tie.to(torch.int32))
    r_bland = torch.argmin(torch.where(tie, basis, BIG_I))
    return has_ratio, torch.where(use_bland, r_bland, r_first)


def simplex_step(state: SimplexState, opts: SolverOptions,
                 stall_limit: int, max_iters: int | None = None
                 ) -> SimplexState:
    """One branchless transition of the state machine (see
    ``tpulp.solve.driver.simplex_step`` for the contract). With
    ``max_iters`` the step is a no-op once ``niter`` reaches it."""
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

    # ---- pricing ----------------------------------------------------------
    crow = torch.where(state.phase == 1, T[1, :-1], T[0, :-1])
    c_eff = torch.where(state.col_active, crow, inf)
    improving = c_eff < -opts.opt_tol
    has_improving = improving.any()
    use_bland = state.bland | (opts.rule == RULE_BLAND)
    j_bland = first_true(improving, n - 1)
    if opts.rule == RULE_MAX_INCREASE:
        # greatest improvement: every column's min ratio in one pass; an
        # improving column with no positive entry gets +inf and is taken
        Ablock = T[2:, :-1]
        posA = Ablock > opts.piv_tol
        ratA = torch.where(
            posA, T[2:, -1:] / torch.where(posA, Ablock, 1.0), inf)
        ratio_j = ratA.min(dim=0).values
        dec = torch.where(
            improving,
            torch.where(ratio_j < inf, -c_eff * ratio_j, inf), -inf)
        j_other = torch.argmax(dec)
    else:
        j_other = torch.argmin(c_eff)
    j_price = torch.where(use_bland, j_bland, j_other)

    # ---- phase bookkeeping ------------------------------------------------
    z1 = -T[1, -1]
    phase1_done = (state.phase == 1) & ~has_improving & running
    became_infeasible = phase1_done & (z1 > opts.infeas_tol)
    to_phase2 = phase1_done & ~became_infeasible
    pricing_pivot = has_improving & ~cleanup & ~phase1_done

    # ---- entering column + ratio test -------------------------------------
    j = torch.where(cleanup, j_d, j_price)
    col = take(T, j, 1)[2:]
    has_ratio, r_price = ratio_rows(col, T[2:, -1], state.basis,
                                    opts.piv_tol, use_bland,
                                    opts.tie_break == TIE_MAXPIV)
    became_unbounded = pricing_pivot & ~has_ratio & in_phase2
    became_failed1 = pricing_pivot & ~has_ratio & ~in_phase2

    # ---- the one pivot (exact no-op on (row 2, basis[0]) when idle) ------
    do_cleanup = cleanup & has_elig & running
    do_pricing = pricing_pivot & has_ratio & running
    do_pivot = do_cleanup | do_pricing
    r = torch.where(do_cleanup, r_d, r_price)
    r_eff = torch.where(do_pivot, r + 2, 2)
    j_eff = torch.where(do_pivot, j, basis_l[0])
    Tn = pivot_update(T, r_eff, j_eff)
    basis = torch.where(do_pivot, put(state.basis, r, j), state.basis)

    # ---- stall / Bland switch against the CURRENT objective --------------
    z = torch.where(state.phase == 1, -Tn[1, -1], -Tn[0, -1])
    improved = (state.last_z - z) > opts.degen_tol
    stuck = torch.where(do_pricing,
                        torch.where(improved, 0, state.stuck + 1),
                        state.stuck).to(torch.int32)
    last_z = torch.where(do_pricing, z, state.last_z)
    bland = state.bland | (stuck >= stall_limit)

    # ---- phase transition + termination ------------------------------------
    phase = torch.where(to_phase2, 2, state.phase).to(torch.int32)
    col_active = torch.where(to_phase2, state.col_active & ~art_cols,
                             state.col_active)
    stuck = torch.where(to_phase2, 0, stuck).to(torch.int32)
    last_z = torch.where(to_phase2, inf, last_z)

    finished_opt = in_phase2 & ~has_improving & ~cleanup
    # a NaN pricing row reads as "nothing improves": report NUMERIC instead
    finite_ok = (
        torch.isfinite(z)
        & torch.isfinite(Tn[2:, -1].abs().sum())
        & torch.isfinite(torch.where(state.col_active, crow.abs(), 0.0).sum())
    )
    new_status = status_select(finite_ok,
                               became_infeasible | became_failed1,
                               became_unbounded, finished_opt)
    status = torch.where(running, new_status, state.status)

    return SimplexState(
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
    )


def run_chunked(step, carry, get_state, max_iters: int):
    """Apply ``step`` in chunks until no lane of the state is RUNNING below
    ``max_iters`` pivots: one host read per chunk, whether the state is one
    problem or a batch with a leading lane axis (the steps freeze finished
    lanes themselves). Chunks grow 1, 2, 4, ... up to ``CHUNK`` steps, so a
    warm re-solve of a few pivots does not run a whole chunk of no-op
    steps."""
    chunk = 1
    while True:
        s = get_state(carry)
        live = (s.status == Status.RUNNING) & (s.niter < max_iters)
        if not bool(live.any()):
            break
        for _ in range(chunk):
            carry = step(carry)
        chunk = min(2 * chunk, CHUNK)
    return carry


def finish(s: SimplexState) -> SimplexState:
    """Map a still-RUNNING exit to ITERATION_LIMIT (per lane on a batch)."""
    return s._replace(status=torch.where(
        s.status == Status.RUNNING, Status.ITERATION_LIMIT, s.status))


def solo_route(walk: str, M: int, N: int, dtype, sms: int = GRID_SMS,
               device: torch.device | None = None) -> str:
    """The kernel that runs a solo ``walk`` ("primal", "devex" or "dual")
    of an (M, N) tableau of ``dtype`` on a card of ``sms`` SMs:
    "lane_primal", "lane_dual", "rank1_cluster" or "rank1_grid" (the
    module's rule). With ``device`` (a CUDA device) the grid's occupancy
    there is asked, and a grid plan that the card cannot hold raises
    RuntimeError; the plan's refusals (a type other than f32 and f64, a
    frame out of range) raise ValueError."""
    if walk not in ("primal", "devex", "dual"):
        raise ValueError(f"unknown walk {walk!r}")
    if walk != "devex" and _resident(M, N, dtype, walk):
        return "lane_primal" if walk == "primal" else "lane_dual"
    if _fits_cluster(M, N, dtype):
        return "rank1_cluster"
    plan = rank1_grid_plan(M, N, dtype, sms)
    if device is not None and rank1_grid_occupancy(
            M, N, dtype, walk, device) < 1:
        raise RuntimeError(f"rank1_grid: the card holds no block of "
                           f"{plan.smem} bytes of shared memory an SM "
                           f"({M} x {N} {dtype}, {walk})")
    return "rank1_grid"


def _resident(M: int, N: int, dtype, walk: str = "primal") -> bool:
    try:
        plan = lane_dual_plan if walk == "dual" else lane_plan
        return plan(M, N, dtype).resident
    except ValueError:  # a frame past the lane kernels' shared memory
        return False


def _fits_cluster(M: int, N: int, dtype) -> bool:
    try:
        cluster_plan(M, N, dtype)
    except ValueError:  # a frame past 8 blocks' shared memory
        return False
    return True


def one_lane(loop, state: SimplexState, opts: SolverOptions,
             stall_limit: int, max_iters: int) -> SimplexState:
    """``loop`` (a lanes loop: ``lane_primal``, ``lane_dual`` or their
    plain versions in ``solve.lanes``) on ``state`` as a batch of one
    lane."""
    lanes = SimplexState(*(x.contiguous().unsqueeze(0) for x in state))
    return SimplexState(*(x[0] for x in loop(lanes, opts, stall_limit,
                                             max_iters)))


def solo_walk(walk: str, state: SimplexState, opts: SolverOptions,
              stall_limit: int) -> SimplexState:
    """The solo ``walk`` of ``state`` (on one CUDA device) on the kernel of
    ``solo_route``, to its exit or to ``opts.max_iters`` (a RUNNING exit at
    the budget stays RUNNING)."""
    T = state.T.contiguous()
    state = state._replace(T=T)
    route = solo_route(walk, *T.shape, T.dtype, sm_count(T.device),
                       T.device)
    runs = {"rank1_cluster": rank1_cluster, "rank1_grid": rank1_grid}
    if route in runs:
        gamma = torch.ones((state.n,), dtype=T.dtype, device=T.device) \
            if walk == "devex" else None
        return runs[route](state, opts, stall_limit, opts.max_iters, gamma,
                           dual=walk == "dual")[0]
    loop = lane_primal if route == "lane_primal" else lane_dual
    return one_lane(loop, state, opts, stall_limit, opts.max_iters)


def run_simplex(state: SimplexState, opts: SolverOptions | None = None
                ) -> SimplexState:
    """Run the rank-1 driver to termination or to ``opts.max_iters``: the
    plain loop on CPU tensors, the route's kernel on CUDA tensors."""
    if opts is None:
        opts = SolverOptions.for_dtype(state.T.dtype)
    stall_limit = opts.resolved_stall_limit(state.m, state.n)
    if not on_cpu(*state):
        return finish(solo_walk("primal", state, opts, stall_limit))
    out = run_chunked(
        lambda s: simplex_step(s, opts, stall_limit, opts.max_iters),
        state, lambda s: s, opts.max_iters)
    return finish(out)


def find_pivot_all(state: SimplexState, opts: SolverOptions | None = None
                   ) -> torch.Tensor:
    """(m, n) bool mask of every feasibility-preserving pivot: entry (i, j)
    holds iff row i is in column j's min-ratio tie set; inactive columns
    are all False."""
    if opts is None:
        opts = SolverOptions.for_dtype(state.T.dtype)
    T = state.T
    inf = float("inf")
    Ablock = T[2:, :-1]
    pos = Ablock > opts.piv_tol
    rat = torch.where(pos, T[2:, -1:] / torch.where(pos, Ablock, 1.0), inf)
    min_ratio = rat.min(dim=0).values
    mask = pos & (rat <= min_ratio[None, :]) & (min_ratio[None, :] < inf)
    return mask & state.col_active[None, :]


def extract_solution(state: SimplexState):
    """(x, z): primal column values (the RHS scattered through the basis)
    and the phase-2 objective (minimisation)."""
    x = torch.zeros((state.n,), dtype=state.T.dtype, device=state.T.device)
    x = x.index_put((state.basis.long(),), state.T[2:, -1])
    return x, state.objective()
