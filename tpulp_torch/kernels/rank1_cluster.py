"""``rank1_cluster``: the solo rank-1, devex and dual walks of a frame that
fits one thread-block cluster, as one launch a walk
(``csrc/rank1_cluster.cu``), and its plain version.

Where the frame fits the shared memory of a cluster of at most 8 blocks,
the whole walk runs in one launch: block b of
the cluster keeps the column slab ``[b W, min(N, (b + 1) W))`` of all rows
(``W = ceil(N / C)``) in its shared memory, prices its own columns, and
the blocks combine their candidates in rank order between two cluster
barriers a step; the entering column is read from its owner's shared
memory, and every block updates its own slab in place. ``cluster_plan``
picks C, the smallest of 1, 2, 4 or 8 that holds the frame, with the
kernel's own layout (the launch refuses a plan that disagrees).

``rank1_cluster`` takes a state on one CUDA device and raises on anything
else (CPU tensors, mixed devices, a strided tableau, a type other than f32
and f64, weights of the wrong length, a frame that 8 blocks cannot hold,
a plan whose cluster the card cannot hold: ``cudaOccupancyMaxActiveClusters``
reports 0). It allocates the output state and never writes the caller's
tensors.

``rank1_cluster_lanes`` runs the same kernel with a lane axis: every lane
of a batched state walked by ``simplex_step`` (the primal walk) or, with
``dual``, by ``dual_simplex_step`` to its own exit in one launch, a
cluster a lane; ``solve.lanes.primal_lanes`` and ``dual_lanes`` take it
for frames past one block's shared memory. Its plain version
``rank1_cluster_lanes_reference`` runs ``rank1_cluster_reference`` on each
lane.

``rank1_cluster_reference`` is the same walk in plain torch: the plain
stages of ``kernels.rank1`` composed step by step (which give
``simplex_step``, ``devex_simplex_step`` and ``dual_simplex_step`` bit for
bit). The kernel's sums feed finiteness checks only. The sum of the
pricing row's ``|c|`` over the active columns, which the kernel takes per
block and then across blocks, is taken here in the kernel's order (per
thread, the warp tree, across warps, then across blocks in rank order);
the kernel takes the ``|b|`` sum in one block, whose finiteness the plain
stage's torch sum matches. So the walk's tableau, basis, pivots and status
do not depend on C. Nothing on the solver's path calls the plain
version: ``solve.driver`` runs the plain loops on CPU tensors and the
kernels on CUDA tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..core.state import SimplexState, SolverOptions
from .bounded import _live
from .launch import LAUNCHES, check, lib_for, raise_on, stream_of, suffix
from .rank1 import (CROW_OK, PHASE, RAY_SCAN_EVERY, RESET_ABOVE, WALKS,
                    _check, make_record, rank1_finish_reference,
                    rank1_price_reference, rank1_ratio_reference,
                    rank1_scan_reference, rank1_update_reference,
                    record_state)
from .sums import block_sum, block_sums, slab_sum

__all__ = ["ClusterPlan", "cluster_plan", "cluster_occupancy",
           "rank1_cluster", "rank1_cluster_reference",
           "rank1_cluster_lanes", "rank1_cluster_lanes_reference", "slab_sum",
           "block_sums",
           "block_sum", "cluster_sum", "CLUSTER_SIZES",
           "CLUSTER_THREADS", "CLUSTER_SMEM_LIMIT", "CLUSTER_STATIC_SMEM",
           "CLUSTER_STAGES"]

# the cluster sizes the kernel launches (portable: at most 8 blocks)
CLUSTER_SIZES = (1, 2, 4, 8)
CLUSTER_THREADS = 512
# the static shared memory left to the kernel's reduction scratch and
# mailboxes (chip_smoke.py holds ptxas's figure to it), and the dynamic
# shared memory a block may then take on an H100: the opt-in maximum,
# 232,448 bytes, less that
CLUSTER_STATIC_SMEM = 2_048
CLUSTER_SMEM_LIMIT = 232_448 - CLUSTER_STATIC_SMEM
# the stages that ``stage_cycles`` splits a walk into (csrc/
# rank1_cluster.cu's Stage): the load; a step's price, barrier A1, the
# combine and the ratio test, the pivot row (and devex's weights), the
# update, the finish, barrier A2's wait and what follows it; the store
CLUSTER_STAGES = ("load", "price", "barrier1", "ratio", "row", "update",
                  "finish", "barrier2", "store")
# the pointers, then the lanes' strides (11 inputs' and the int32 outputs'
# field stride); the plan's ints, then the lanes
_NARGS, _NINTS, _NTOLS = 32, 12, 6
_ARGS = ctypes.c_longlong * _NARGS
_INTS = ctypes.c_int * _NINTS
_TOLS = ctypes.c_double * _NTOLS
_INT_MAX = 2 ** 31 - 1
# basis values go through the tableau's type in Bland's row tie: exact in
# float32 below 2^24
_MAX_SIDE = 1 << 24


class ClusterPlan(NamedTuple):
    blocks: int   # C, the blocks of the cluster
    width: int    # W, the columns of a block's slab
    threads: int  # threads a block
    smem: int     # dynamic shared-memory bytes a block


def _align(x: int) -> int:
    return (x + 15) // 16 * 16


def _smem(M: int, N: int, W: int, es: int) -> int:
    """csrc/rank1_cluster.cu's smem_bytes: the slab, the pivot's column and
    the RHS, the pivot row's and the weights' segments, the basis, the
    segment's active mask, the artificial mask."""
    m, n = M - 2, N - 1
    return (_align(M * W * es) + 2 * _align(M * es) + 2 * _align(W * es)
            + _align(4 * m) + _align(W) + _align(n))


@functools.lru_cache(maxsize=256)
def cluster_plan(M: int, N: int, dtype, blocks: int | None = None
                 ) -> ClusterPlan:
    """The launch plan of a walk on an (M, N) = (m + 2, n + 1) frame: the
    smallest cluster of ``CLUSTER_SIZES`` (or the one of ``blocks``, to hold
    the kernel at another size) whose blocks hold their slabs and vectors
    in ``CLUSTER_SMEM_LIMIT`` bytes each. Raises for a frame that 8 blocks
    cannot hold."""
    es = {torch.float32: 4, torch.float64: 8}.get(dtype)
    if es is None:
        raise ValueError(f"rank1_cluster takes float32 or float64, not "
                         f"{dtype}")
    if M < 3 or N < 2 or max(M, N) >= _MAX_SIDE:
        raise ValueError(f"frame {M} x {N} outside 3..2^24 x 2..2^24")
    if blocks is not None and blocks not in CLUSTER_SIZES:
        raise ValueError(f"a cluster of {blocks} blocks: expected one of "
                         f"{CLUSTER_SIZES}")
    for C in CLUSTER_SIZES if blocks is None else (blocks,):
        W = -(-N // C)
        smem = _smem(M, N, W, es)
        if smem <= CLUSTER_SMEM_LIMIT:
            return ClusterPlan(C, W, CLUSTER_THREADS, smem)
    raise ValueError(f"frame {M} x {N} {dtype}: a block of a cluster of "
                     f"{C} needs {smem} bytes of shared memory, above "
                     f"{CLUSTER_SMEM_LIMIT}")


def _plan_ints(plan: ClusterPlan, M: int, N: int, walk: str, lanes: int = 1):
    return _INTS(M, N, 0, 0, 0, 0, WALKS.index(walk), plan.blocks,
                 plan.threads, plan.smem, RAY_SCAN_EVERY, lanes)


@functools.lru_cache(maxsize=64)
def _occupancy(index: int, plan: ClusterPlan, M: int, N: int, dtype,
               walk: str) -> int:
    lib = lib_for(torch.device("cuda", index))
    out = ctypes.c_int(0)
    fn = getattr(lib, f"tpulp_rank1_cluster_occupancy_{suffix(dtype)}")
    raise_on(lib, fn(_plan_ints(plan, M, N, walk), ctypes.byref(out)),
             "rank1_cluster occupancy")
    return out.value


def cluster_occupancy(M: int, N: int, dtype, walk: str = "primal",
                      device: torch.device | None = None,
                      blocks: int | None = None) -> int:
    """``cudaOccupancyMaxActiveClusters`` of the walk's launch on an (M, N)
    frame (``cluster_plan(M, N, dtype, blocks)``): how many of its clusters
    the card holds at once (asked once a plan and device)."""
    if walk not in WALKS:
        raise ValueError(f"unknown walk {walk!r}")
    index = 0 if device is None or device.index is None else device.index
    return _occupancy(index, cluster_plan(M, N, dtype, blocks), M, N, dtype,
                      walk)


def rank1_cluster(state: SimplexState, opts: SolverOptions,
                  stall_limit: int, max_iters: int,
                  gamma: torch.Tensor | None = None, dual: bool = False,
                  blocks: int | None = None,
                  stage_cycles: torch.Tensor | None = None):
    """The walk of ``state`` (one problem on one CUDA device) to its exit or
    to ``max_iters`` in one cluster launch: ``simplex_step``'s, with devex
    weights ``gamma`` ``devex_simplex_step``'s, with ``dual``
    ``dual_simplex_step``'s; a RUNNING exit at the budget stays RUNNING.
    ``blocks`` forces the cluster's size (``cluster_plan``'s by default).
    ``stage_cycles``, an int64 tensor of ``len(CLUSTER_STAGES)`` on the
    card, accumulates block 0's SM cycles by stage (a measurement; the
    kernel walks the same). Returns (state, weights); the caller's tensors
    are never written."""
    _check(state, gamma, dual)
    if stage_cycles is not None:
        check(stage_cycles, "stage_cycles", torch.int64,
              (len(CLUSTER_STAGES),))
        if stage_cycles.device != state.T.device:
            raise ValueError("stage_cycles: expected a tensor on "
                             f"{state.T.device}")
    walk = "dual" if dual else "primal" if gamma is None else "devex"
    T = state.T
    M, N = T.shape
    m, n = M - 2, N - 1
    dtype, dev = T.dtype, T.device
    plan = cluster_plan(M, N, dtype, blocks)
    if cluster_occupancy(M, N, dtype, walk, dev, blocks) == 0:
        raise RuntimeError(f"rank1_cluster: the card holds no cluster of "
                           f"{plan.blocks} blocks with {plan.smem} bytes of "
                           f"shared memory each ({M} x {N} {dtype})")
    # one allocation for the int32 fields and one for the bool ones: each
    # allocation is host time on a warm re-solve's path
    ints = torch.empty((4 + m,), dtype=torch.int32, device=dev)
    bools = torch.empty((1 + 2 * n,), dtype=torch.bool, device=dev)
    out = SimplexState(
        T=torch.empty((M, N), dtype=dtype, device=dev),
        basis=ints[4:], col_active=bools[1:1 + n], art_cols=bools[1 + n:],
        phase=ints[0], status=ints[1], niter=ints[2], stuck=ints[3],
        bland=bools[0], last_z=torch.empty((), dtype=dtype, device=dev))
    g_in = None if gamma is None else gamma.contiguous()
    g_out = None if gamma is None else torch.empty_like(g_in)
    ins = [x.contiguous() for x in state]
    ptrs = (ins[0], out.T, ins[1], out.basis, ins[2], out.col_active, ins[3],
            out.art_cols, g_in, g_out, *ins[4:], ints, out.bland, out.last_z,
            stage_cycles)
    # one lane: every input's lane stride 0, the int32 fields one apart
    args = _ARGS(*(0 if x is None else x.data_ptr() for x in ptrs),
                 *([0] * 11), 1)
    iargs = _plan_ints(plan, M, N, walk)
    iargs[2] = min(int(stall_limit), _INT_MAX)
    iargs[3] = min(int(max_iters), _INT_MAX)
    iargs[4] = int(opts.rule)
    iargs[5] = int(opts.tie_break)
    tols = _TOLS(opts.opt_tol, opts.piv_tol, opts.degen_tol,
                 opts.infeas_tol, opts.feas_tol, RESET_ABOVE)
    lib = lib_for(dev)
    fn = getattr(lib, f"tpulp_rank1_cluster_{suffix(dtype)}")
    err = fn(args, iargs, tols, stream_of(dev))
    if err:
        raise_on(lib, err, "rank1_cluster")
    LAUNCHES["rank1_cluster"] += 1
    return out, g_out


def rank1_cluster_lanes(state: SimplexState, opts: SolverOptions,
                        stall_limit: int, max_iters: int,
                        blocks: int | None = None,
                        stage_cycles: torch.Tensor | None = None,
                        dual: bool = False) -> SimplexState:
    """Every lane of the batched ``state`` (B, M, N) on one CUDA device
    walked by ``simplex_step`` (the primal walk: ``RULE_DEVEX`` priced as
    Dantzig) or, with ``dual``, by ``dual_simplex_step`` to its own exit or
    to ``max_iters``, in one launch: a cluster a lane (grid (C, B), cluster
    y = lane), each as ``rank1_cluster``'s solo walk. A lane not RUNNING
    below its budget at the launch is copied out as it is. The masks,
    basis and scalars are read through their lane strides (the waves'
    broadcast rows, lane stride 0, are never expanded); the caller's
    tensors are never written, and the dual walk's masks are the input's,
    as ``lane_dual``'s. ``blocks`` forces C; ``stage_cycles`` accumulates
    lane 0's block 0's clock by stage."""
    T = state.T
    if T.dim() != 3:
        raise ValueError(f"T: expected (B, m + 2, n + 1) frames, got "
                         f"{tuple(T.shape)}")
    B, M, N = T.shape
    if T.stride(1) != N or T.stride(2) != 1:
        raise ValueError(f"T: each lane's frame must be contiguous, stride "
                         f"{T.stride()}")
    dtype, dev = T.dtype, T.device
    m, n = M - 2, N - 1
    strides = [T.stride(0)]
    for x, name, width, dt in ((state.basis, "basis", m, torch.int32),
                               (state.col_active, "col_active", n,
                                torch.bool),
                               (state.art_cols, "art_cols", n, torch.bool)):
        if x.dtype != dt or tuple(x.shape) != (B, width) or \
                (width > 1 and x.stride(1) != 1):
            raise ValueError(f"{name}: expected {dt} {(B, width)} with "
                             f"contiguous rows, got {x.dtype} "
                             f"{tuple(x.shape)} stride {x.stride()}")
        strides.append(x.stride(0))
    strides.append(0)  # no devex weights: the primal or the dual walk
    for name, dt in (("phase", torch.int32), ("status", torch.int32),
                     ("niter", torch.int32), ("stuck", torch.int32),
                     ("bland", torch.bool), ("last_z", dtype)):
        x = getattr(state, name)
        if x.dtype != dt or tuple(x.shape) != (B,):
            raise ValueError(f"{name}: expected {dt} ({B},), got {x.dtype} "
                             f"{tuple(x.shape)}")
        strides.append(x.stride(0))
    if dev.type != "cuda" or any(x.device != dev for x in state):
        raise ValueError("rank1_cluster_lanes takes the state's tensors on "
                         "one CUDA device; got "
                         f"{sorted({str(x.device) for x in state})}")
    if stage_cycles is not None:
        check(stage_cycles, "stage_cycles", torch.int64,
              (len(CLUSTER_STAGES),))
    walk = "dual" if dual else "primal"
    plan = cluster_plan(M, N, dtype, blocks)
    if cluster_occupancy(M, N, dtype, walk, dev, blocks) == 0:
        raise RuntimeError(f"rank1_cluster_lanes: the card holds no cluster "
                           f"of {plan.blocks} blocks with {plan.smem} bytes "
                           f"of shared memory each ({M} x {N} {dtype})")
    ints = torch.empty((B * (4 + m),), dtype=torch.int32, device=dev)
    bools = torch.empty((B * (1 + 2 * n),), dtype=torch.bool, device=dev)
    out = SimplexState(
        T=torch.empty((B, M, N), dtype=dtype, device=dev),
        basis=ints[4 * B:].view(B, m),
        col_active=bools[B:B + B * n].view(B, n),
        art_cols=bools[B + B * n:].view(B, n),
        phase=ints[:B], status=ints[B:2 * B], niter=ints[2 * B:3 * B],
        stuck=ints[3 * B:4 * B], bland=bools[:B],
        last_z=torch.empty((B,), dtype=dtype, device=dev))
    ptrs = (state.T, out.T, state.basis, out.basis, state.col_active,
            out.col_active, state.art_cols, out.art_cols, None, None,
            state.phase, state.status, state.niter, state.stuck, state.bland,
            state.last_z, ints, out.bland, out.last_z, stage_cycles)
    # the int32 outputs field by field: phase, status, niter, stuck, each
    # B long
    args = _ARGS(*(0 if x is None else x.data_ptr() for x in ptrs),
                 *strides, B)
    iargs = _plan_ints(plan, M, N, walk, B)
    iargs[2] = min(int(stall_limit), _INT_MAX)
    iargs[3] = min(int(max_iters), _INT_MAX)
    iargs[4] = int(opts.rule)
    iargs[5] = int(opts.tie_break)
    tols = _TOLS(opts.opt_tol, opts.piv_tol, opts.degen_tol,
                 opts.infeas_tol, opts.feas_tol, RESET_ABOVE)
    lib = lib_for(dev)
    fn = getattr(lib, f"tpulp_rank1_cluster_{suffix(dtype)}")
    err = fn(args, iargs, tols, stream_of(dev))
    if err:
        raise_on(lib, err, "rank1_cluster_lanes")
    LAUNCHES["rank1_cluster_lanes"] += 1
    if dual:
        # the kernel wrote the masks it read: the dual walk changes none
        return out._replace(col_active=state.col_active,
                            art_cols=state.art_cols)
    return out


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def cluster_sum(x: torch.Tensor, C: int) -> torch.Tensor:
    """The sum of the ``n`` columns' values ``x`` as the cluster takes it:
    each block's slab of ``W = ceil((n + 1) / C)`` columns, then the blocks'
    sums in rank order (``slab_sum``)."""
    return slab_sum(x, -(-(x.numel() + 1) // C), C)


def _crow_ok(rec, C: int) -> bool:
    """The finiteness of the pre-step pricing row's |c| sum over the active
    columns (the dual walk's objective row), in the kernel's order."""
    T = rec.T
    phase1 = rec.walk != "dual" and int(rec.ints[PHASE]) == 1
    crow = T[1, :-1] if phase1 else T[0, :-1]
    vals = torch.where(rec.col_active, crow.abs(), 0.0)
    return bool(torch.isfinite(cluster_sum(vals, C)))


def rank1_cluster_reference(state: SimplexState, opts: SolverOptions,
                            stall_limit: int, max_iters: int,
                            gamma: torch.Tensor | None = None,
                            dual: bool = False, C: int = 1):
    """``rank1_cluster``'s walk in plain torch on a cluster of ``C`` blocks
    (any C >= 1): the plain stages step by step, the pricing row's
    finiteness sum in the kernel's order. Returns (state, weights); the
    caller's tensors are never written."""
    rec = make_record(state, opts, gamma, dual)
    while _live(rec.ints.tolist(), max_iters):
        rank1_scan_reference(rec, opts, max_iters)
        rank1_price_reference(rec, opts, max_iters)
        # a finiteness check only: the walk does not depend on C
        rec.ints[CROW_OK] = int(_crow_ok(rec, C))
        rank1_ratio_reference(rec, opts, max_iters)
        rank1_update_reference(rec, max_iters)
        rank1_finish_reference(rec, opts, stall_limit, max_iters)
    return record_state(rec), rec.gamma


def rank1_cluster_lanes_reference(state: SimplexState, opts: SolverOptions,
                                  stall_limit: int, max_iters: int,
                                  C: int = 1, dual: bool = False
                                  ) -> SimplexState:
    """``rank1_cluster_lanes`` in plain torch: ``rank1_cluster_reference``'s
    primal walk (with ``dual``, its dual walk) on each lane (a cluster of
    ``C`` blocks), every lane to its own exit; a lane not RUNNING below its
    budget is left as it is."""
    B = state.T.shape[0]
    outs = []
    for b in range(B):
        lane = SimplexState(*(x[b] for x in state))
        if _live([int(lane.phase), int(lane.status), int(lane.niter)],
                 max_iters):
            lane = rank1_cluster_reference(lane, opts, stall_limit,
                                           max_iters, None, dual, C)[0]
        outs.append(lane)
    return SimplexState(*(torch.stack([getattr(o, f) for o in outs])
                          for f in SimplexState._fields))
