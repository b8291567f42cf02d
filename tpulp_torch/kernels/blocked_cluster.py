"""``blocked_cluster``: a block of K eta-pivot slots of the solo rank-K
blocked engine in one thread-block-cluster launch
(``csrc/blocked_cluster.cu``), with the block's eta factors in the
cluster's shared memory; the walk around it; and its plain version.

Where the block's factors fit the shared memory of a cluster of 8 blocks
(16 where 8 do not hold them and the card holds such a cluster), the K
slots of a block run in one cluster launch (past that,
``kernels.blocked_grid`` runs them on the whole card): block b of the
cluster keeps ``V[0..K, b W:(b + 1) W]`` and ``U[0..K, b H:(b + 1) H]``
(``W = ceil(N / C)``, ``H = ceil(M / C)``) in its shared memory with its
entries of the running vectors, and the blocks combine their candidates in
rank order between three cluster barriers a slot. ``blocked_cluster_plan``
picks C with the kernel's own layout (the launch refuses a plan that
disagrees).
Between two blocks nothing changes: B1 (``block.fused_flush``) flushes the
factors and ``kernels.blocked``'s ray launch evaluates the per-block ray
scan and resets the carry, with one host read of (status, niter) a block.

``blocked_cluster`` takes a state on one CUDA device and raises on anything
else (CPU tensors, mixed devices, a strided tableau, a type other than f32
and f64, a block whose factors 16 blocks cannot hold, a plan whose cluster
the card cannot hold: ``cudaOccupancyMaxActiveClusters`` reports 0). It
never writes the caller's tensors.

``blocked_cluster_batch`` is the same walk over every lane of a batched
state (``solve.blocked.run_simplex_blocked_batch`` on the card): a block is
one launch of one cluster a lane (``kernels.blocked.make_batch_record``'s
record, lane y on cluster y), one B1 launch over the lanes
(``block.fused_flush_batch``) and one ray launch over them
(``kernels.blocked.ray_batch``), with one host read of every lane's
(status, niter). A lane that is not running within its budget at a
block's start is frozen through that block, as in tpulp's vmapped
``while_loop``: its cluster returns at once and B1 and the ray launch skip
it (the record's ``LIVE``), so each lane walks exactly its solo walk.
``blocked_cluster_batch_reference`` is its plain version, lane by lane.

``blocked_cluster_reference`` is the same walk in plain torch: the plain
stages of ``kernels.blocked`` composed slot by slot (which equal
``blocked.cu``'s launches bit for bit), flushed by B1's plain version. The
kernel's sums that feed finiteness checks only, the pre-step ``|c|`` over
the active columns and the post-step ``|bvec[2:]|``, are taken per block
(per thread, the warp tree, across warps: ``sums.slab_sum``) and
across blocks in rank order; the plain version takes them in that order.
``kernels.blocked``'s plain stages take them in the launches' order, so the
two plain versions can part only where one order overflows to infinity and
the other does not (a sum within a few ulps of the type's largest value):
on every other input they give the same walk in every field, whatever C.
Nothing on the solver's path calls the plain version: ``solve.blocked``
runs the eager engine on CPU tensors and the kernels on CUDA tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..core.state import SimplexState, SolverOptions, Status
from . import blocked as kb
from .block import fused_flush_reference
from .bounded_grid import GridPlanTooLarge
from .launch import LAUNCHES, check, lib_for, raise_on, stream_of, suffix
from .sums import slab_sum

__all__ = ["BlockedClusterPlan", "blocked_cluster_plan",
           "blocked_cluster_occupancy", "blocked_cluster",
           "blocked_cluster_block", "blocked_cluster_block_reference",
           "blocked_cluster_reference", "blocked_cluster_batch",
           "blocked_cluster_batch_block", "blocked_cluster_batch_reference",
           "BLOCKED_CLUSTER_SIZES",
           "BLOCKED_CLUSTER_THREADS", "BLOCKED_CLUSTER_SMEM_LIMIT",
           "BLOCKED_CLUSTER_STATIC_SMEM", "BLOCKED_CLUSTER_STAGES"]

# the cluster sizes the kernel launches: the plan takes 8 (the portable
# size), else 16 (non-portable); ``blocks=`` forces any of them
BLOCKED_CLUSTER_SIZES = (1, 2, 4, 8, 16)
_PLAN_SIZES = (8, 16)
BLOCKED_CLUSTER_THREADS = 512
# the static shared memory left to the kernel's reduction scratch, inboxes
# (16 entries of each of three) and combines (chip_smoke.py holds ptxas's
# figure to it), and the dynamic shared memory a block may then take on an
# H100: the opt-in maximum, 232,448 bytes, less that
BLOCKED_CLUSTER_STATIC_SMEM = 4_096
BLOCKED_CLUSTER_SMEM_LIMIT = 232_448 - BLOCKED_CLUSTER_STATIC_SMEM
# the stages that ``stage_cycles`` splits a launch into (csrc/
# blocked_cluster.cu's Stage): the load; a slot's clean-up and pricing,
# barrier A1, the combine and the read of the entering column's V slots,
# its eta sums, the ratio test, barrier A2, the combine and the read of the
# pivot row's U slots, the pivot row and the updates (and the clean-up scan
# beside them), the block's reduction, barrier A3, the finish; the store
BLOCKED_CLUSTER_STAGES = ("load", "price", "barrier1", "fetch1", "column",
                          "ratio", "barrier2", "fetch2", "row", "reduce",
                          "barrier3", "finish", "store")
_NARGS, _NINTS = 13, 13
_ARGS = ctypes.c_longlong * _NARGS
_INTS = ctypes.c_int * _NINTS


class BlockedClusterPlan(NamedTuple):
    blocks: int   # C, the blocks of the cluster
    width: int    # W, the columns of a block's slab
    height: int   # H, the rows of a block's slab
    threads: int  # threads a block
    smem: int     # dynamic shared-memory bytes a block


def _align(x: int) -> int:
    return (x + 15) // 16 * 16


def _smem(M: int, N: int, K: int, W: int, H: int, es: int) -> int:
    """csrc/blocked_cluster.cu's smem_bytes: V's and U's slabs; row0, row1
    and the weights of the column slab; bvec, colj and the pending w of the
    row slab; U's rows 0 and 1, V's column N - 1 and the peer's eta
    coefficients; the basis; the slab's active mask; the artificial
    mask."""
    m, n = M - 2, N - 1
    return (_align(K * W * es) + _align(K * H * es) + 3 * _align(W * es)
            + 3 * _align(H * es) + 4 * _align(K * es) + _align(4 * m)
            + _align(W) + _align(n))


@functools.lru_cache(maxsize=256)
def blocked_cluster_plan(M: int, N: int, K: int, dtype,
                         blocks: int | None = None) -> BlockedClusterPlan:
    """The launch plan of a block of ``K`` slots on an (M, N) = (m + 2, n +
    1) tableau: a cluster of 8 blocks, else of 16, whose blocks hold their
    slabs and vectors in ``BLOCKED_CLUSTER_SMEM_LIMIT`` bytes each (or the
    one of ``blocks``, to hold the kernel at another size). Raises
    ``GridPlanTooLarge`` (a ValueError) for a block that 16 blocks cannot
    hold, ValueError for another type, a frame outside 2^24, a K or a
    cluster size out of range."""
    es = {torch.float32: 4, torch.float64: 8}.get(dtype)
    if es is None:
        raise ValueError(f"blocked_cluster takes float32 or float64, not "
                         f"{dtype}")
    if M < 3 or N < 2 or max(M, N) >= kb._MAX_SIDE:
        raise ValueError(f"tableau {M} x {N} outside 3..2^24 x 2..2^24")
    if not 1 <= K <= kb.MAX_K:
        raise ValueError(f"block of {K} pivots outside 1..{kb.MAX_K}")
    if blocks is not None and blocks not in BLOCKED_CLUSTER_SIZES:
        raise ValueError(f"a cluster of {blocks} blocks: expected one of "
                         f"{BLOCKED_CLUSTER_SIZES}")
    for C in _PLAN_SIZES if blocks is None else (blocks,):
        W, H = -(-N // C), -(-M // C)
        smem = _smem(M, N, K, W, H, es)
        if smem <= BLOCKED_CLUSTER_SMEM_LIMIT:
            return BlockedClusterPlan(C, W, H, BLOCKED_CLUSTER_THREADS, smem)
    raise GridPlanTooLarge(
        f"block of {K} pivots on {M} x {N} {dtype}: a block of a cluster of "
        f"{C} needs {smem} bytes of shared memory, above "
        f"{BLOCKED_CLUSTER_SMEM_LIMIT}")


def _plan_ints(plan: BlockedClusterPlan, M: int, N: int, K: int,
               lanes: int = 1):
    """The launch's int arguments (csrc/blocked_cluster.cu's Int) but the
    walk's: the shape, the plan, the lanes and the record's per-lane
    extents (``ints`` and ``vals``)."""
    return _INTS(M, N, K, 0, 0, 0, 0, plan.blocks, plan.threads, plan.smem,
                 lanes, kb.NI + kb._cdiv(N - 1, kb.GRID_THREADS), kb.NV)


@functools.lru_cache(maxsize=64)
def _occupancy(index: int, plan: BlockedClusterPlan, M: int, N: int, K: int,
               dtype) -> int:
    lib = lib_for(torch.device("cuda", index))
    out = ctypes.c_int(0)
    fn = getattr(lib, f"tpulp_blocked_cluster_occupancy_{suffix(dtype)}")
    raise_on(lib, fn(_plan_ints(plan, M, N, K), ctypes.byref(out)),
             "blocked_cluster occupancy")
    return out.value


def blocked_cluster_occupancy(M: int, N: int, K: int, dtype,
                              device: torch.device | None = None,
                              blocks: int | None = None) -> int:
    """``cudaOccupancyMaxActiveClusters`` of the launch of a block of ``K``
    slots on an (M, N) tableau (``blocked_cluster_plan(M, N, K, dtype,
    blocks)``): how many of its clusters the card holds at once (asked once
    a plan and device)."""
    index = 0 if device is None or device.index is None else device.index
    return _occupancy(index, blocked_cluster_plan(M, N, K, dtype, blocks),
                      M, N, K, dtype)


def _check_cycles(stage_cycles, device) -> None:
    if stage_cycles is not None:
        check(stage_cycles, "stage_cycles", torch.int64,
              (len(BLOCKED_CLUSTER_STAGES),))
        if stage_cycles.device != device:
            raise ValueError(f"stage_cycles: expected a tensor on {device}")


def _launch(rec: kb.BlockedRecord, opts: SolverOptions, stall_limit: int,
            max_iters: int, blocks: int | None, stage_cycles,
            batch: bool) -> None:
    lib, args, iargs, tols = kb._entry(rec, opts, stall_limit, max_iters)
    T = rec.T
    if T.dim() != (3 if batch else 2):
        raise ValueError(f"expected a {'batched' if batch else 'solo'} "
                         f"record, got a tableau of {tuple(T.shape)}")
    M, N = T.shape[-2:]
    K = rec.U.shape[-2]
    _check_cycles(stage_cycles, T.device)
    plan = blocked_cluster_plan(M, N, K, T.dtype, blocks)
    cargs = _ARGS(*(0 if x is None else x.data_ptr() for x in (
        T, rec.U, rec.V, rec.row0, rec.row1, rec.bvec, rec.gamma, rec.basis,
        rec.col_active, rec.art_cols, rec.ints, rec.vals, stage_cycles)))
    ci = _plan_ints(plan, M, N, K, T.shape[0] if batch else 1)
    for k in range(3, 7):  # stall, budget, rule, tie break: as kb's
        ci[k] = iargs[k]
    kind = "blocked_cluster_batch" if batch else "blocked_cluster"
    fn = getattr(lib, f"tpulp_{kind}_{suffix(T.dtype)}")
    err = fn(cargs, ci, tols, stream_of(T.device))
    if err:
        raise_on(lib, err, kind)
    LAUNCHES[kind] += 1


def blocked_cluster_block(rec: kb.BlockedRecord, opts: SolverOptions,
                          stall_limit: int, max_iters: int,
                          blocks: int | None = None,
                          stage_cycles: torch.Tensor | None = None) -> None:
    """The K slots of the record's block in one cluster launch (counted in
    ``LAUNCHES["blocked_cluster"]``), in place: what K of the plain
    stages' slots (``kernels.blocked.blocked_pivot_reference``) compute;
    the record's scratch and verdict fields are left as they were, but
    ``LIVE``. A
    record that is not running within ``max_iters`` is left as it is, but
    ``LIVE = 0``. ``blocks`` forces the cluster's size; ``stage_cycles``
    (int64, ``len(BLOCKED_CLUSTER_STAGES)`` on the card) accumulates block
    0's SM cycles by stage."""
    _launch(rec, opts, stall_limit, max_iters, blocks, stage_cycles, False)


def blocked_cluster_batch_block(rec: kb.BlockedRecord, opts: SolverOptions,
                                stall_limit: int, max_iters: int,
                                blocks: int | None = None,
                                stage_cycles: torch.Tensor | None = None
                                ) -> None:
    """``blocked_cluster_block`` of every lane of a batched record in one
    launch, one cluster a lane (counted in
    ``LAUNCHES["blocked_cluster_batch"]``); ``stage_cycles`` counts lane
    0's block 0."""
    _launch(rec, opts, stall_limit, max_iters, blocks, stage_cycles, True)


def _require_cluster(M: int, N: int, K: int, dtype, device,
                     blocks: int | None) -> None:
    """Raise unless the card holds one cluster of the plan."""
    plan = blocked_cluster_plan(M, N, K, dtype, blocks)
    if blocked_cluster_occupancy(M, N, K, dtype, device, blocks) == 0:
        raise RuntimeError(f"blocked_cluster: the card holds no cluster of "
                           f"{plan.blocks} blocks with {plan.smem} bytes of "
                           f"shared memory each ({M} x {N} {dtype}, K {K})")


def blocked_cluster(state: SimplexState, opts: SolverOptions,
                    stall_limit: int, max_iters: int, K: int,
                    blocks: int | None = None,
                    stage_cycles: torch.Tensor | None = None):
    """The rank-K blocked walk of ``state`` (one problem on one CUDA
    device) in blocks of ``K`` pivots, to its exit or to ``max_iters``: a
    block is one cluster launch, B1's flush and the ray launch, with one
    host read of (status, niter) a block; a RUNNING exit at the budget
    stays RUNNING. ``blocks`` and ``stage_cycles`` as in
    ``blocked_cluster_block``. Returns (state, devex weights); the caller's
    tensors are never written."""
    kb._check(state, K)
    T = state.T
    M, N = T.shape
    _check_cycles(stage_cycles, T.device)
    _require_cluster(M, N, K, T.dtype, T.device, blocks)
    rec = kb.make_record(state, K)

    def block(r):
        blocked_cluster_block(r, opts, stall_limit, max_iters, blocks,
                              stage_cycles)
        kb.flush_and_ray(r, opts, stall_limit, max_iters)

    kb._walk(rec, max_iters, block)
    return kb.record_state(rec), rec.gamma


def blocked_cluster_batch(batched: SimplexState, opts: SolverOptions,
                          stall_limit: int, max_iters: int, K: int,
                          blocks: int | None = None,
                          stage_cycles: torch.Tensor | None = None):
    """``blocked_cluster``'s walk of every lane of ``batched`` (B lanes of
    one shape on one CUDA device) in blocks of ``K`` pivots, while any lane
    runs within ``max_iters``: a block is one cluster launch over every
    lane, one B1 launch and one ray launch over them, with one host read of
    every lane's (status, niter); a lane that is not running within the
    budget at a block's start keeps its whole state through the block.
    ``blocks`` forces the cluster's size; ``stage_cycles`` counts lane 0's
    block 0. Returns (batched state, devex weights (B, n)); the caller's
    tensors are never written. Clusters past the card's
    ``cudaOccupancyMaxActiveClusters`` wait for a free slot."""
    kb._check(batched, K, batched=True)
    T = batched.T
    M, N = T.shape[-2:]
    _check_cycles(stage_cycles, T.device)
    _require_cluster(M, N, K, T.dtype, T.device, blocks)
    rec = kb.make_batch_record(batched, K)

    def block(r):
        blocked_cluster_batch_block(r, opts, stall_limit, max_iters, blocks,
                                    stage_cycles)
        kb.flush_and_ray_batch(r, opts, stall_limit, max_iters)

    kb._walk_batch(rec, max_iters, block)
    return kb.record_state(rec), rec.gamma


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def _crow_ok(rec: kb.BlockedRecord, C: int) -> bool:
    """The finiteness of the pre-step pricing row's |c| sum over the active
    columns, in the kernel's order (the column slabs)."""
    N = rec.T.shape[1]
    crow = (rec.row1 if int(rec.ints[kb.PHASE]) == 1 else rec.row0)[:-1]
    vals = torch.where(rec.col_active, crow.abs(), 0.0)
    return bool(torch.isfinite(slab_sum(vals, -(-N // C), C)))


def _bvec_sum(rec: kb.BlockedRecord, C: int) -> torch.Tensor:
    """The post-step |bvec[2:]| sum in the kernel's order (the row slabs;
    rows 0 and 1 add nothing)."""
    M = rec.T.shape[0]
    vals = rec.bvec.abs()
    vals[:2] = 0.0
    return slab_sum(vals, -(-M // C), C)


def blocked_cluster_block_reference(rec: kb.BlockedRecord,
                                    opts: SolverOptions, stall_limit: int,
                                    max_iters: int, C: int) -> None:
    """``blocked_cluster_block``'s K slots in plain torch on a cluster of
    ``C`` blocks (any C >= 1), in place: ``kernels.blocked``'s plain stages
    slot by slot, the two finiteness sums in the kernel's order (the
    record's scratch holds them as the plain stages leave it, except that
    its row partials hold the |bvec[2:]| sum in its first slot). A record
    that is not running within ``max_iters`` is left as it is, but ``LIVE
    = 0``."""
    M, N = rec.T.shape
    G = kb.partials(M, N)
    status, niter = rec.ints[kb.STATUS:kb.NITER + 1].tolist()
    live = status == Status.RUNNING and niter < max_iters
    rec.ints[kb.LIVE] = int(live)
    if not live:
        return
    for _ in range(rec.U.shape[0]):
        if not kb._running(rec.ints.tolist()):
            return
        kb.blocked_cleanup_reference(rec, opts, max_iters)
        kb.blocked_price_reference(rec, opts, max_iters)
        rec.ints[kb.CROW_OK] = int(_crow_ok(rec, C))
        kb.blocked_column_reference(rec, opts, max_iters)
        kb.blocked_ratio_reference(rec, opts, max_iters)
        kb.blocked_row_reference(rec, opts, max_iters)
        # the finish adds the partials from 0: the sum, then zeros
        part = rec.scratch[M + N + G:]
        part.zero_()
        part[0] = _bvec_sum(rec, C)
        kb.blocked_finish_reference(rec, opts, stall_limit, max_iters)


def blocked_cluster_reference(state: SimplexState, opts: SolverOptions,
                              stall_limit: int, max_iters: int, K: int,
                              C: int, flush=fused_flush_reference):
    """``blocked_cluster``'s walk in plain torch on a cluster of ``C``
    blocks, in blocks of ``K``, each flushed through ``flush`` (B1's plain
    version or ``block.fused_flush``) and ended by the ray stage. Returns
    (state, devex weights); a RUNNING exit at the budget stays RUNNING.
    The caller's tensors are never written."""
    rec = kb.make_record(state, K)

    def block(r):
        blocked_cluster_block_reference(r, opts, stall_limit, max_iters, C)
        _, scan = flush(*kb.flush_inputs(r), float(opts.opt_tol),
                        float(opts.piv_tol))
        kb.blocked_ray_reference(r, scan, opts)

    kb._walk(rec, max_iters, block)
    return kb.record_state(rec), rec.gamma


def blocked_cluster_batch_reference(batched: SimplexState,
                                    opts: SolverOptions, stall_limit: int,
                                    max_iters: int, K: int, C: int,
                                    flush=fused_flush_reference):
    """``blocked_cluster_batch``'s walk in plain torch on clusters of ``C``
    blocks: a block is ``blocked_cluster_block_reference`` of every lane
    (each frozen unless running within ``max_iters`` at the block's start),
    then ``flush`` (B1's plain version or ``block.fused_flush``) and the ray
    stage of every live lane. Returns (batched state, devex weights); the
    caller's tensors are never written."""
    rec = kb.make_batch_record(batched, K)
    lanes = [kb.lane_record(rec, k) for k in range(rec.T.shape[0])]

    def block(r):
        for lane in lanes:
            blocked_cluster_block_reference(lane, opts, stall_limit,
                                            max_iters, C)
        for lane in lanes:
            if int(lane.ints[kb.LIVE]):
                _, scan = flush(*kb.flush_inputs(lane), float(opts.opt_tol),
                                float(opts.piv_tol))
                kb.blocked_ray_reference(lane, scan, opts)

    kb._walk_batch(rec, max_iters, block)
    return kb.record_state(rec), rec.gamma
