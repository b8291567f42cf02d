"""``rank1_grid``: the solo rank-1, devex and dual walks of a frame that no
thread-block cluster holds, in one persistent cooperative launch on the
whole card (``csrc/rank1_grid.cu``), its launch plan and its plain version.

``kernels.rank1`` runs a step as four or five stream-ordered launches (the
whole tableau through device memory twice a step, one host enqueue a
step); ``kernels.rank1_cluster`` runs the whole walk in one launch only
where a cluster of at most 8 blocks holds the frame. Here the whole walk
runs in one launch for the frames past that: G blocks (at most one an SM)
each own the structural columns ``[g W, min(n, (g + 1) W))`` of all M
rows, price them (the dual walk: the entering candidates on the leaving
row, which every block picks alike from its copy of the RHS), and
combine their candidates in slab order after a grid barrier; the owner of
the entering column publishes it and the ratio test's verdict before a
second barrier; every block then updates its slab and its copy of the RHS
in place. Where the slabs fit the SMs' shared memory, all M rows of a slab
live there (a resident plan); past that its first R rows do, and rows [R,
M) are streamed each step through device memory, tile by tile, through a
ring of tiles in shared memory (a streamed plan). The plan is
``kernels.bounded_grid``'s rule (``plan_grid``) over this kernel's
shared-memory layout: ``rank1_grid_plan`` refuses (``GridPlanTooLarge``) a
frame whose replicated vectors, first three rows and ring do not fit a
block, and ``solve.driver.solo_route`` then takes ``rank1_steps``.

``rank1_grid`` takes a state on one CUDA device and raises on anything
else (CPU tensors, mixed devices, a strided tableau, a type other than f32
and f64, weights of the wrong length, weights on the dual walk, a frame
past the plan, a grid the card cannot hold at once). It allocates the
output state and never writes the caller's tensors.

``rank1_grid_reference`` is the same walk in plain torch on G slabs: the
plain stages of ``kernels.rank1`` composed step by step (which give
``simplex_step``, ``devex_simplex_step`` and ``dual_simplex_step`` bit for
bit), with the finiteness sums in the kernel's order: the pricing row's
(the dual walk's objective row's) |c| over the active columns as the grid
takes it (``grid_sum``), the post-step |b| as one block takes it
(``block_sum``). The split of a slab's rows between shared and device
memory changes no entry's arithmetic, so the one plain version holds both
plans. Nothing on the solver's path calls it: ``solve.driver`` runs the
plain loops on CPU tensors and the kernels on CUDA tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.state import SimplexState, SolverOptions
from .bounded import _live
from .bounded_grid import (GRID_SMS, GRID_THREADS, GridPlan,
                           GridPlanTooLarge, _align, grid_slabs, plan_grid)
from .launch import (LAUNCHES, check, lib_for, raise_on, sm_count,
                     stream_of, suffix)
from .rank1 import (CROW_OK, PHASE, RAY_SCAN_EVERY, RESET_ABOVE, WALKS,
                    _check, make_record, rank1_finish_reference,
                    rank1_price_reference, rank1_ratio_reference,
                    rank1_scan_reference, rank1_update_reference,
                    record_state)
from .sums import block_sum, grid_sum

__all__ = ["rank1_grid_plan", "rank1_grid_occupancy", "rank1_grid",
           "rank1_grid_reference", "RANK1_GRID_STAGES", "GridPlanTooLarge"]

# the stages that ``stage_cycles`` splits a walk into (csrc/rank1_grid.cu's
# Stage; block 0's clock): the load; a step's column pass, price, barrier
# A, the combine, the ratio test and its publication where block 0 owns the
# entering column, barrier B, barrier C, the fetch of the verdict and the
# entering column with the pivot row, the update of the resident rows and
# the RHS, the streamed rows' update (0 on a resident plan), the finish;
# the store; then "owner": the ratio test and its publication on the clock
# of the block that owns the entering column, whichever it is
RANK1_GRID_STAGES = ("load", "scan", "price", "barrier_a", "combine",
                     "ratio", "barrier_b", "barrier_c", "fetch", "update",
                     "stream", "finish", "store", "owner")
# ints_out: phase, status, niter, stuck
_NOUT = 4
_NARGS, _NINTS, _NTOLS = 24, 17, 6
_ARGS = ctypes.c_longlong * _NARGS
_INTS = ctypes.c_int * _NINTS
_TOLS = ctypes.c_double * _NTOLS
_INT_MAX = 2 ** 31 - 1


def _smem(M: int, N: int, W: int, es: int, rows: int | None = None,
          stages: int = 0, tile: int = 0) -> int:
    """csrc/rank1_grid.cu's smem_bytes: the slab's ``rows`` resident rows
    (all M by default), the ring (``stages`` tiles of ``tile`` bytes), the
    RHS and the pivot's column, the pivot row's and the weights' segments,
    the basis, the segment's active mask, the artificial mask and the
    ring's mbarriers."""
    m, n = M - 2, N - 1
    R = M if rows is None else rows
    return (_align(R * W * es) + stages * tile + 2 * _align(M * es)
            + 2 * _align(W * es) + _align(4 * m) + _align(W) + _align(n)
            + _align(8 * stages))


@functools.lru_cache(maxsize=256)
def rank1_grid_plan(M: int, N: int, dtype, sms: int = GRID_SMS,
                    blocks: int | None = None,
                    rows: int | None = None) -> GridPlan:
    """The launch plan of a walk on an (M, N) = (m + 2, n + 1) frame on a
    card of ``sms`` SMs (``kernels.bounded_grid.bounded_grid_plan``'s rule
    over this kernel's layout): W = max(ceil(n / sms), ceil(4096 / M))
    columns a block and G = ceil(n / W) blocks (``blocks`` forces another
    grid, ``grid_slabs(n, blocks)``); resident where a block's whole slab
    fits ``GRID_SMEM_LIMIT``, else streamed: R rows resident beside the
    ring, rows [R, M) in a ``scratch`` buffer of tiles (``rows`` forces R,
    3 to M). 1538 x 3073 at f64 on 132 SMs: 128 blocks of 24 columns, R
    824 (18.9 MB streamed); at f32 resident.

    Raises ``GridPlanTooLarge`` where even rows 0-2 with the ring do not
    fit (or a forced R does not); ValueError for another type, a frame
    outside 2^24, a grid or an R out of range."""
    return plan_grid(M, N, dtype, sms, blocks, rows, _smem, "rank1_grid")


def _plan_ints(plan: GridPlan, M: int, N: int, dtype, walk: str):
    es = 4 if dtype == torch.float32 else 8
    return _INTS(M, N, 0, 0, 0, 0, WALKS.index(walk), plan.blocks,
                 plan.width, plan.threads, plan.smem, plan.mail, plan.rows,
                 plan.stages, plan.tile_rows,
                 _align(plan.tile_rows * plan.width * es), RAY_SCAN_EVERY)


@functools.lru_cache(maxsize=64)
def _occupancy(index: int, plan: GridPlan, M: int, N: int, dtype,
               walk: str) -> int:
    lib = lib_for(torch.device("cuda", index))
    out = ctypes.c_int(0)
    fn = getattr(lib, f"tpulp_rank1_grid_occupancy_{suffix(dtype)}")
    raise_on(lib, fn(_plan_ints(plan, M, N, dtype, walk), ctypes.byref(out)),
             "rank1_grid occupancy")
    return out.value


def rank1_grid_occupancy(M: int, N: int, dtype, walk: str = "primal",
                         device: torch.device | None = None) -> int:
    """``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` of the walk's
    launch on an (M, N) frame (the plan on ``device``'s SMs): the blocks an
    SM holds at once (asked once a plan, walk and device)."""
    if walk not in WALKS:
        raise ValueError(f"unknown walk {walk!r}")
    device = torch.device("cuda", 0) if device is None else device
    plan = rank1_grid_plan(M, N, dtype, sm_count(device))
    return _occupancy(device.index or 0, plan, M, N, dtype, walk)


def rank1_grid(state: SimplexState, opts: SolverOptions, stall_limit: int,
               max_iters: int, gamma: torch.Tensor | None = None,
               dual: bool = False, blocks: int | None = None,
               rows: int | None = None,
               stage_cycles: torch.Tensor | None = None):
    """The walk of ``state`` (one problem on one CUDA device) to its exit or
    to ``max_iters`` in one cooperative launch: ``simplex_step``'s, with
    devex weights ``gamma`` ``devex_simplex_step``'s, with ``dual``
    ``dual_simplex_step``'s; a RUNNING exit at the budget stays RUNNING.
    ``blocks`` forces another grid and ``rows`` another split of the slabs'
    rows (``rank1_grid_plan``'s by default; a streamed plan allocates its
    scratch buffer here). ``stage_cycles``, an int64 tensor of
    ``len(RANK1_GRID_STAGES)`` on the card, accumulates block 0's SM cycles
    by stage (a measurement; the kernel walks the same). Returns (state,
    weights); the caller's tensors are never written."""
    _check(state, gamma, dual)
    T = state.T
    M, N = T.shape
    m, n = M - 2, N - 1
    dtype, dev = T.dtype, T.device
    if stage_cycles is not None:
        check(stage_cycles, "stage_cycles", torch.int64,
              (len(RANK1_GRID_STAGES),))
        if stage_cycles.device != dev:
            raise ValueError(f"stage_cycles: expected a tensor on {dev}")
    walk = "dual" if dual else "primal" if gamma is None else "devex"
    plan = rank1_grid_plan(M, N, dtype, sm_count(dev), blocks=blocks,
                           rows=rows)
    # one allocation for the int32 fields and one for the bool ones: each
    # allocation is host time on a warm re-solve's path
    ints = torch.empty((_NOUT + m,), dtype=torch.int32, device=dev)
    bools = torch.empty((1 + 2 * n,), dtype=torch.bool, device=dev)
    out = SimplexState(
        T=torch.empty((M, N), dtype=dtype, device=dev), basis=ints[_NOUT:],
        col_active=bools[1:1 + n], art_cols=bools[1 + n:],
        phase=ints[0], status=ints[1], niter=ints[2], stuck=ints[3],
        bland=bools[0], last_z=torch.empty((), dtype=dtype, device=dev))
    g_in = None if gamma is None else gamma.contiguous()
    g_out = None if gamma is None else torch.empty_like(g_in)
    mail = torch.empty((plan.mail,), dtype=torch.uint8, device=dev)
    cols = torch.empty((2 * M,), dtype=dtype, device=dev)
    bar = torch.zeros((1,), dtype=torch.int32, device=dev)
    scratch = torch.empty((plan.scratch,), dtype=torch.uint8, device=dev) \
        if plan.scratch else None
    ins = [x.contiguous() for x in state]
    ptrs = (ins[0], out.T, ins[1], out.basis, ins[2], out.col_active, ins[3],
            out.art_cols, g_in, g_out, *ins[4:], ints, out.bland, out.last_z,
            mail, cols, bar, stage_cycles, scratch)
    args = _ARGS(*(0 if x is None else x.data_ptr() for x in ptrs))
    iargs = _plan_ints(plan, M, N, dtype, walk)
    iargs[2] = min(int(stall_limit), _INT_MAX)
    iargs[3] = min(int(max_iters), _INT_MAX)
    iargs[4] = int(opts.rule)
    iargs[5] = int(opts.tie_break)
    tols = _TOLS(opts.opt_tol, opts.piv_tol, opts.degen_tol,
                 opts.infeas_tol, opts.feas_tol, RESET_ABOVE)
    lib = lib_for(dev)
    fn = getattr(lib, f"tpulp_rank1_grid_{suffix(dtype)}")
    err = fn(args, iargs, tols, stream_of(dev))
    if err:
        raise_on(lib, err, "rank1_grid")
    LAUNCHES["rank1_grid"] += 1
    return out, g_out


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def _crow_ok(rec, W: int, G: int) -> bool:
    """The finiteness of the pre-step pricing row's |c| sum over the active
    columns (the dual walk's objective row), in the grid's order."""
    T = rec.T
    phase1 = rec.walk != "dual" and int(rec.ints[PHASE]) == 1
    crow = T[1, :-1] if phase1 else T[0, :-1]
    vals = torch.where(rec.col_active, crow.abs(), 0.0)
    return bool(torch.isfinite(grid_sum(vals, W, G)))


def rank1_grid_reference(state: SimplexState, opts: SolverOptions,
                         stall_limit: int, max_iters: int,
                         gamma: torch.Tensor | None = None,
                         dual: bool = False, blocks: int = 1):
    """``rank1_grid``'s walk in plain torch on ``blocks`` slabs
    (``grid_slabs``; any count >= 1): the plain stages step by step, the
    finiteness sums in the kernel's order. Returns (state, weights); the
    caller's tensors are never written."""
    W, G = grid_slabs(state.T.shape[1] - 1, blocks)
    rec = make_record(state, opts, gamma, dual)
    while _live(rec.ints.tolist(), max_iters):
        rank1_scan_reference(rec, opts, max_iters)
        rank1_price_reference(rec, opts, max_iters)
        # finiteness checks only: the walk does not depend on G
        rec.ints[CROW_OK] = int(_crow_ok(rec, W, G))
        rank1_ratio_reference(rec, opts, max_iters)
        rank1_update_reference(rec, max_iters)
        rhs_ok = bool(torch.isfinite(block_sum(rec.T[2:, -1].abs(),
                                               GRID_THREADS)))
        rank1_finish_reference(rec, opts, stall_limit, max_iters,
                               rhs_ok=rhs_ok)
    return record_state(rec), rec.gamma
