"""``rank1_grid``: the solo rank-1, devex and dual walks of a frame that no
thread-block cluster holds, in one persistent cooperative launch on the
whole card (``csrc/rank1_grid.cu``), its launch plan and its plain version.

``kernels.rank1_cluster`` runs the whole walk in one launch only where a
cluster of at most 8 blocks holds the frame. Here the whole walk runs in
one launch for every frame past that which the card's memory holds: G
blocks (at most one an SM) each own the structural columns ``[g W, min(n,
(g + 1) W))`` of all M rows, price them (the dual walk: the entering
candidates on the leaving row), and combine their candidates in slab order
after a grid barrier; the entering column's verdict is published before a
second barrier; every block then updates its slab in place. Where the
slabs fit the SMs' shared memory, all M rows of a slab live there (a
resident plan); past that its first R rows do, and rows [R, M) are
streamed each step through device memory, tile by tile, through a ring of
tiles in shared memory (a streamed plan). On both every block keeps its
own copy of the RHS, the pivot column and the basis, and the owner of the
entering column runs the ratio test. Where those copies leave rows 0-2 and
the ring no room, they live in device memory instead (the device-vector
plan, ``vectors == "device"``): two copies of the RHS and the basis, a
step reading one and each block writing its share of the rows into the
other, the ratio test and the dual walk's pick of the leaving row split
over the blocks by rows. Where even a slab's rows 0-2 and the ring do not
fit a block, no row of a slab lives in shared memory (the wide plan,
``vectors == "wide"``): every row streams from device memory in chunks of
``GRID_WIDE_CHUNK`` columns, the per-row vectors as on the device-vector
plan. The plan is ``kernels.bounded_grid``'s rule (``plan_grid``) over
this kernel's shared-memory layouts (the device-vector and wide plans'
are ``bounded_grid``'s own); ``rank1_grid_plan`` refuses only a forced
plan past its edge (``GridPlanTooLarge``).

``rank1_grid`` takes a state on one CUDA device and raises on anything
else (CPU tensors, mixed devices, a strided tableau, a type other than f32
and f64, weights of the wrong length, weights on the dual walk, a forced
plan past its edge, a grid the card cannot hold at once). It allocates the
output state and never writes the caller's tensors.

``rank1_grid_reference`` is the same walk in plain torch on G slabs: the
plain stages of ``kernels.rank1`` composed step by step (which give
``simplex_step``, ``devex_simplex_step`` and ``dual_simplex_step`` bit for
bit), with the finiteness sums in the kernel's order: the pricing row's
(the dual walk's objective row's) |c| over the active columns as the grid
takes it (``grid_sum``), the post-step |b| as one block takes it
(``block_sum``) on the resident and streamed plans, as the grid takes it
over slabs of ceil(m / G) rows on the device-vector and wide plans
(``vectors=``). The split of a slab's rows between shared and device
memory changes no entry's arithmetic, so the one plain version holds every
plan. Nothing on the solver's path calls it: ``solve.driver`` runs the
plain loops on CPU tensors and the kernels on CUDA tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.state import SimplexState, SolverOptions
from .bounded import _live
from .bounded_grid import (GRID_SMS, GRID_THREADS, GridPlan,
                           GridPlanTooLarge, _align, _smem_device,
                           grid_slabs, plan_grid)
from .launch import (LAUNCHES, check, lib_for, raise_on, sm_count,
                     stream_of, suffix)
from .rank1 import (CROW_OK, PHASE, RAY_SCAN_EVERY, RESET_ABOVE, WALKS,
                    _check, make_record, rank1_finish_reference,
                    rank1_price_reference, rank1_ratio_reference,
                    rank1_scan_reference, rank1_update_reference,
                    record_state)
from .sums import block_sum, grid_sum

__all__ = ["rank1_grid_plan", "rank1_grid_occupancy", "rank1_grid",
           "rank1_grid_reference", "rank1_grid_stages", "RANK1_GRID_STAGES",
           "RANK1_GRID_DEVICE_STAGES", "RANK1_GRID_WIDE_STAGES",
           "GridPlanTooLarge"]

# the stages that ``stage_cycles`` splits a walk into on the resident and
# streamed plans (csrc/rank1_grid.cu's Stage; block 0's clock): the load; a
# step's column pass, price, barrier A, the combine, the ratio test and its
# publication where block 0 owns the entering column, barrier B, barrier
# C, the fetch of the verdict and the entering column with the pivot row,
# the update of the resident rows and the RHS, the streamed rows' update
# (0 on a resident plan), the finish, barrier D (0: the device-vector and
# wide plans only); the store; then "owner": the ratio test and its
# publication on the clock of the block that owns the entering column,
# whichever it is
RANK1_GRID_STAGES = ("load", "scan", "price", "barrier_a", "combine",
                     "ratio", "barrier_b", "barrier_c", "fetch", "update",
                     "stream", "finish", "barrier_d", "store", "owner")
# the same counters on the device-vector plan, whose spans differ, under
# names of their own: "combine_ties" the combine, the combine of the
# blocks' ratio picks and the pass over the block's rows for the ties;
# "ratio_picks" the first pass over the block's rows and its publication;
# "barriers_b" barriers B and B'; "ties_fetch" the ties' combine, the pivot
# row and the devex weights; "update_resident" the resident rows' update
# (the RHS is the finish's); "finish_rhs" the finish with the block's share
# of the RHS rows and the basis and, after barrier D, the combine of their
# sums and picks; "owner_picks" the first pass on the clock of the block
# that owns the entering column (bounded_grid's GRID_DEVICE_VECTOR_STAGES)
RANK1_GRID_DEVICE_STAGES = (
    "load", "scan", "price", "barrier_a", "combine_ties", "ratio_picks",
    "barriers_b", "barrier_c", "ties_fetch", "update_resident", "stream",
    "finish_rhs", "barrier_d", "store", "owner_picks")
# the wide plan's: the device-vector plan's spans where they are the same,
# "price" with each column's pass in it ("scan" 0), and two of its own:
# "verdict" the step's scalars (the pivot row and the weights are the
# stream's, chunk by chunk); "first_tile" the first chunk's pivot row
# entry and weight asked for and column j's entries of the first tile
# staged (bounded_grid's GRID_WIDE_STAGES)
RANK1_GRID_WIDE_STAGES = (
    "load", "scan", "price", "barrier_a", "combine_ties", "ratio_picks",
    "barriers_b", "barrier_c", "verdict", "first_tile", "stream",
    "finish_rhs", "barrier_d", "store", "owner_picks")
# ints_out: phase, status, niter, stuck
_NOUT = 4
_NARGS, _NINTS, _NTOLS = 25, 18, 6
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
                    blocks: int | None = None, rows: int | None = None,
                    vectors: str | None = None) -> GridPlan:
    """The launch plan of a walk on an (M, N) = (m + 2, n + 1) frame on a
    card of ``sms`` SMs (``kernels.bounded_grid.bounded_grid_plan``'s rule
    over this kernel's layouts): W = max(ceil(n / sms), ceil(4096 / M))
    columns a block and G = ceil(n / W) blocks (``blocks`` forces another
    grid, ``grid_slabs(n, blocks)``); resident where a block's whole slab
    fits ``GRID_SMEM_LIMIT``, else streamed: R rows resident beside the
    ring, rows [R, M) in a ``scratch`` buffer of tiles (``rows`` forces R,
    3 to M). 1538 x 3073 at f64 on 132 SMs: 128 blocks of 24 columns, R
    824 (18.9 MB streamed); at f32 resident.

    Where rows 0-2 and the ring do not fit beside the replicated vectors
    (with n = 2m, past 8,978 rows (m = 8,976) at f64 and 13,306 (m =
    13,304) at f32 on 132 SMs; at M = 18, past n = 153,384 at f64 and
    170,808 at f32), the device-vector plan (``vectors`` "device": the
    vectors in device memory, R the most rows the rest of a block holds,
    at most M - 1); where even its rows 0-2 and ring do not fit (a slab
    past 3,098 columns at f64 and 6,032 at f32: n past 408,936 and 796,224
    on 132 SMs), the wide plan (``vectors`` "wide": no row of a slab in
    shared memory).
    ``vectors`` forces the kind: "shared" the first two plans, "device" the
    device-vector plan at any frame (``rows``, 3 to M - 1, forces its R),
    "wide" the wide plan at any frame (``rows`` must then be None).

    Raises ``GridPlanTooLarge`` where a shared-vector or device-vector plan
    is forced past its edge; ValueError for another type, a frame outside
    2^24, a grid, an R or a kind out of range."""
    return plan_grid(M, N, dtype, sms, blocks, rows, _smem, "rank1_grid",
                     _smem_device, vectors, wide=True)


def rank1_grid_stages(plan: GridPlan) -> tuple[str, ...]:
    """The names of ``stage_cycles``' counters on ``plan``: the last is
    the owner's clock."""
    return {"device": RANK1_GRID_DEVICE_STAGES,
            "wide": RANK1_GRID_WIDE_STAGES}.get(plan.vectors,
                                                RANK1_GRID_STAGES)


def _plan_ints(plan: GridPlan, M: int, N: int, dtype, walk: str):
    es = 4 if dtype == torch.float32 else 8
    tile = plan.tile_rows * plan.chunk * es if plan.vectors == "wide" \
        else _align(plan.tile_rows * plan.width * es)
    return _INTS(M, N, 0, 0, 0, 0, WALKS.index(walk), plan.blocks,
                 plan.width, plan.threads, plan.smem, plan.mail, plan.rows,
                 plan.stages, plan.tile_rows, tile, RAY_SCAN_EVERY,
                 ("shared", "device", "wide").index(plan.vectors))


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
               stage_cycles: torch.Tensor | None = None,
               vectors: str | None = None):
    """The walk of ``state`` (one problem on one CUDA device) to its exit or
    to ``max_iters`` in one cooperative launch: ``simplex_step``'s, with
    devex weights ``gamma`` ``devex_simplex_step``'s, with ``dual``
    ``dual_simplex_step``'s; a RUNNING exit at the budget stays RUNNING.
    ``blocks`` forces another grid, ``rows`` another split of the slabs'
    rows and ``vectors`` the plan's kind (``rank1_grid_plan``'s by default;
    a streamed plan allocates its scratch buffer here, the device-vector and
    wide plans their RHS and basis copies too). ``stage_cycles``, an int64
    tensor of ``len(RANK1_GRID_STAGES)`` on the card, accumulates block 0's
    SM cycles by stage (``rank1_grid_stages(plan)`` names them; a
    measurement, the kernel walks the same). Returns (state, weights); the
    caller's tensors are never written."""
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
                           rows=rows, vectors=vectors)
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
    # the mailbox's columns; the device-vector and wide plans' two copies
    # of the RHS after them, and of the basis apart
    dvec = plan.vectors != "shared"
    cols = torch.empty(((4 if dvec else 2) * M,), dtype=dtype, device=dev)
    bvec = torch.empty((2 * m,), dtype=torch.int32, device=dev) \
        if dvec else None
    bar = torch.zeros((1,), dtype=torch.int32, device=dev)
    scratch = torch.empty((plan.scratch,), dtype=torch.uint8, device=dev) \
        if plan.scratch else None
    ins = [x.contiguous() for x in state]
    ptrs = (ins[0], out.T, ins[1], out.basis, ins[2], out.col_active, ins[3],
            out.art_cols, g_in, g_out, *ins[4:], ints, out.bland, out.last_z,
            mail, cols, bar, stage_cycles, scratch, bvec)
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
                         dual: bool = False, blocks: int = 1,
                         vectors: str = "shared"):
    """``rank1_grid``'s walk in plain torch on ``blocks`` slabs
    (``grid_slabs``; any count >= 1): the plain stages step by step, the
    finiteness sums in the kernel's order: ``vectors`` "device" and "wide"
    take those plans' |b| sum (``grid_sum`` over G slabs of ceil(m / G)
    rows), "shared" the resident and streamed plans' (one block's).
    Returns (state, weights); the caller's tensors are never written."""
    if vectors not in ("shared", "device", "wide"):
        raise ValueError(f"rank1_grid_reference: vectors={vectors!r}")
    W, G = grid_slabs(state.T.shape[1] - 1, blocks)
    m = state.T.shape[0] - 2
    rec = make_record(state, opts, gamma, dual)
    while _live(rec.ints.tolist(), max_iters):
        rank1_scan_reference(rec, opts, max_iters)
        rank1_price_reference(rec, opts, max_iters)
        # finiteness checks only: the walk does not depend on G
        rec.ints[CROW_OK] = int(_crow_ok(rec, W, G))
        rank1_ratio_reference(rec, opts, max_iters)
        rank1_update_reference(rec, max_iters)
        absb = rec.T[2:, -1].abs()
        rhs_ok = bool(torch.isfinite(
            grid_sum(absb, -(-m // G), G) if vectors != "shared"
            else block_sum(absb, GRID_THREADS)))
        rank1_finish_reference(rec, opts, stall_limit, max_iters,
                               rhs_ok=rhs_ok)
    return record_state(rec), rec.gamma
