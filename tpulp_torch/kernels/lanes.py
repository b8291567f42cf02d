"""``lane_dual`` / ``lane_primal`` / ``lane_bounded``: the launch of
``csrc/lanes.cu``.

One block per lane steps the lane's dual-simplex loop
(``solve.dual.dual_simplex_step``), rank-1 primal loop
(``solve.driver.simplex_step``) or bounded-variable loop
(``solve.bounded.bounded_simplex_step``, on a batched ``BoundedState``) to
the lane's own exit (status leaves RUNNING or ``niter`` reaches
``max_iters``), in one launch with no host read. ``lane_plan``,
``lane_bounded_plan`` and ``lane_dual_plan`` say whether a lane's frame
fits the block's shared memory beside its vectors ("resident") or is
worked on in place in device memory ("streamed"), with the block size and
the shared-memory bytes of the kernel's own layout (the launch refuses a
plan that disagrees). The three kernels share one layout, and take a
block of 32 to 256 threads from the frame's width (``lane_threads``: one
warp for 10c's 3 x 30 span nodes, whose block then passes no block
barrier).

The wrappers take CUDA tensors only (``solve.lanes`` runs the plain loops
on CPU tensors) and raise on what the kernels do not take. Besides the
batches, ``solve.driver`` runs the solo rank-1 and dual walks of a
resident frame through them as a batch of one lane. They read the
masks, spans and weights through their strides, so the broadcast rows of
``dual._lanes`` (lane stride 0) are never expanded; they allocate a new
output state with ``torch.empty`` and never write the caller's tensors
(pool slots and the scheduler's frames stay live).
"""

from __future__ import annotations

import array
import ctypes
from typing import NamedTuple

import torch

from ..core.state import RULE_DEVEX, SimplexState, SolverOptions
from .launch import LAUNCHES, check, lib_for, raise_on, stream_of, suffix

__all__ = ["LanePlan", "lane_plan", "lane_bounded_plan", "lane_dual_plan",
           "lane_threads", "lane_dual", "lane_primal", "lane_bounded",
           "LANE_SMEM_LIMIT", "LANE_STATIC_SMEM", "LANE_THREADS",
           "LANE_STAGES"]

# the static shared memory left to the kernels' reduction scratch
# (chip_smoke.py holds ptxas's figures to it), and the dynamic shared
# memory a block may then take on an H100: the opt-in maximum, 232,448
# bytes, less that
LANE_STATIC_SMEM = 2_048
LANE_SMEM_LIMIT = 232_448 - LANE_STATIC_SMEM
# the most threads a block
LANE_THREADS = 256
# the stages that ``stage_cycles`` splits a launch into (csrc/lanes.cu's
# WalkStage: block 0's clock, summed over the steps): the load; a step's
# price pass and its reduction (with the previous step's finish; the dual
# loop's leaving-row decision); the clean-up pass, the ratio test and the
# ties (the dual loop's entering-column decision); the update; the store;
# then the block barriers block 0 passed
LANE_STAGES = ("load", "price", "ratio", "update", "store", "barriers")
# the largest frame side the kernels index (basis values go through the
# tableau's type in Bland's tie rule: exact in float32 below 2^24)
_MAX_SIDE = 1 << 24
# the lanes' 20 pointers and 10 strides, the bounded lanes' 5 pointers and
# 3 strides, the stage clock (an int64 array)
_NINTS, _NTOLS = 10, 5
_INTS = ctypes.c_int * _NINTS
_TOLS = ctypes.c_double * _NTOLS
_INT_MAX = 2 ** 31 - 1


class LanePlan(NamedTuple):
    resident: bool  # the frame lives in shared memory
    threads: int    # threads a block
    smem: int       # dynamic shared-memory bytes a block


def _align(x: int) -> int:
    return (x + 15) // 16 * 16


def _itemsize(M: int, N: int, dtype) -> int:
    es = {torch.float32: 4, torch.float64: 8}.get(dtype)
    if es is None:
        raise ValueError(f"lane kernels take float32 or float64, not {dtype}")
    if M < 3 or N < 2 or max(M, N) >= _MAX_SIDE:
        raise ValueError(f"lane frame {M} x {N} outside 3..2^24 x 2..2^24")
    return es


def lane_threads(M: int, N: int) -> int:
    """``lane_primal``'s and ``lane_bounded``'s block for (M, N) frames: a
    thread a column of the n = N - 1 and a row of the M, in whole warps,
    32 to ``LANE_THREADS``; doubled while that stays within
    ``LANE_THREADS`` and the frame has 32 rows or more (the kernel then
    splits each column's rows over two lanes of a warp)."""
    threads = min(LANE_THREADS, max(32, -(-max(M, N - 1) // 32) * 32))
    if 2 * threads <= LANE_THREADS and M >= 32:
        threads *= 2
    return threads


def _fit(vectors: int, frame: int, M: int, N: int, threads: int,
         resident: bool | None) -> LanePlan:
    if resident is not False and vectors + frame <= LANE_SMEM_LIMIT:
        return LanePlan(True, threads, vectors + frame)
    if resident:
        raise ValueError(f"lane frame {M} x {N}: resident it needs "
                         f"{vectors + frame} bytes of shared memory, above "
                         f"{LANE_SMEM_LIMIT}")
    if vectors > LANE_SMEM_LIMIT:
        raise ValueError(f"lane frame {M} x {N}: its vectors need {vectors} "
                         f"bytes of shared memory, above {LANE_SMEM_LIMIT}")
    return LanePlan(False, threads, vectors)


def _walk_plan(M: int, N: int, dtype, bounded: bool, threads: int | None,
               resident: bool | None) -> LanePlan:
    es = _itemsize(M, N, dtype)
    if threads is None:
        threads = lane_threads(M, N)
    elif threads % 32 or not 32 <= threads <= LANE_THREADS:
        raise ValueError(f"a lane block of {threads} threads: expected a "
                         f"multiple of 32 from 32 to {LANE_THREADS}")
    m, n = M - 2, N - 1
    # csrc/lanes.cu's walk_smem_bytes: the RHS twice, the pivot's column,
    # the basis twice, the two masks; bounded: the spans, the weights, the
    # at-upper flags and two snapshot columns; resident: the frame's n
    # columns at an odd pitch
    vectors = 3 * _align(M * es) + 2 * _align(4 * m) + 2 * _align(n)
    if bounded:
        vectors += 2 * _align(n * es) + _align(n) + 2 * _align(M * es)
    return _fit(vectors, _align(M * (n | 1) * es), M, N, threads, resident)


def lane_plan(M: int, N: int, dtype, threads: int | None = None,
              resident: bool | None = None) -> LanePlan:
    """``lane_primal``'s launch plan of lanes with (M, N) = (m + 2, n + 1)
    frames: resident when the frame's n columns (at an odd row pitch) and
    the per-lane vectors fit ``LANE_SMEM_LIMIT``, else streamed;
    ``lane_threads(M, N)`` a block. ``threads`` forces the block (a
    multiple of 32 up to 256), ``resident=False`` the streamed plan
    (``True`` raises where the frame does not fit)."""
    return _walk_plan(M, N, dtype, False, threads, resident)


def lane_bounded_plan(M: int, N: int, dtype, threads: int | None = None,
                      resident: bool | None = None) -> LanePlan:
    """``lane_plan`` for ``lane_bounded``: the per-lane vectors also hold
    the spans and the devex weights (n of the tableau's type each), the
    at-upper flags (n bytes) and two columns of M (the flip's and
    basis[0]'s, snapshotted where a basic column is not a unit vector)."""
    return _walk_plan(M, N, dtype, True, threads, resident)


def lane_dual_plan(M: int, N: int, dtype, threads: int | None = None,
                   resident: bool | None = None) -> LanePlan:
    """``lane_dual``'s launch plan: ``lane_plan``'s (the kernels share one
    layout; the dual loop reads its pivot's column in the frame and keeps
    the vector's room unused), with the same ``threads`` and ``resident``
    options."""
    return _walk_plan(M, N, dtype, False, threads, resident)


def _vector(x: torch.Tensor, name: str, B: int, width: int, dtype) -> int:
    """The lane stride of a (B, width) operand whose rows are contiguous
    (a lane stride of 0 is a broadcast row)."""
    if x.dtype != dtype or tuple(x.shape) != (B, width):
        raise ValueError(f"{name}: expected {dtype} {(B, width)}, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if width > 1 and x.stride(1) != 1:
        raise ValueError(f"{name}: rows must be contiguous, stride "
                         f"{x.stride()}")
    return x.stride(0)


def _scalar(x: torch.Tensor, name: str, B: int, dtype) -> int:
    if x.dtype != dtype or tuple(x.shape) != (B,):
        raise ValueError(f"{name}: expected {dtype} ({B},), got {x.dtype} "
                         f"{tuple(x.shape)}")
    return x.stride(0)


def _pointers(xs) -> list:
    return [0 if x is None else x.data_ptr() for x in xs]


class _Call(NamedTuple):
    """What a launch takes from its operands' shapes, strides, types and
    devices, its options and its plan: computed once, then reused."""
    dims: tuple    # B, M, N
    tail: list     # the args after the 20 pointers of the lanes (strides,
                   # the bounded lanes' pointers' places, their strides)
    iargs: object  # _INTS
    tols: object   # _TOLS
    name: str      # the entry point
    devex: bool


# the launches' _Call by their key (kind, options, budget, forced plan and
# every operand's shape, stride, type and device): the waves call with the
# same few layouts every wave, and building a launch's plan and argument
# arrays costs more host time than the launch
_CALLS: dict = {}
_MAX_CALLS = 256


def _operands(kind: str, st: SimplexState, opts: SolverOptions, bs):
    ops = list(st)
    if kind == "bounded":
        ops += [bs.upper, bs.at_upper]
        if opts.rule == RULE_DEVEX:
            ops.append(bs.gamma)
    return ops


def _call(kind: str, st: SimplexState, opts: SolverOptions,
          stall_limit: int, max_iters: int, bs, threads, resident) -> _Call:
    """The checks of a launch's operands, its plan and its argument arrays
    but the pointers (``_Call``), cached by ``_CALLS``' key."""
    ops = _operands(kind, st, opts, bs)
    key = (kind, opts, int(stall_limit), int(max_iters), threads, resident,
           tuple((x.shape, x.stride(), x.dtype, x.device) for x in ops))
    call = _CALLS.get(key)
    if call is None:
        call = _new_call(kind, st, opts, stall_limit, max_iters, bs, ops,
                         threads, resident)
        if len(_CALLS) >= _MAX_CALLS:
            _CALLS.clear()
        _CALLS[key] = call
    return call


def _new_call(kind, st, opts, stall_limit, max_iters, bs, ops, threads,
              resident) -> _Call:
    T = st.T
    if T.dim() != 3:
        raise ValueError(f"T: expected (B, m + 2, n + 1) frames, got "
                         f"{tuple(T.shape)}")
    B, M, N = T.shape
    if T.stride(1) != N or T.stride(2) != 1:
        raise ValueError(f"T: each lane's frame must be contiguous, stride "
                         f"{T.stride()}")
    dtype = T.dtype
    bounded = kind == "bounded"
    plan = {"dual": lane_dual_plan, "primal": lane_plan,
            "bounded": lane_bounded_plan}[kind](M, N, dtype, threads,
                                                resident)
    m, n = M - 2, N - 1
    strides = [T.stride(0),
               _vector(st.basis, "basis", B, m, torch.int32),
               _vector(st.col_active, "col_active", B, n, torch.bool),
               _vector(st.art_cols, "art_cols", B, n, torch.bool)]
    for name, dt in (("phase", torch.int32), ("status", torch.int32),
                     ("niter", torch.int32), ("stuck", torch.int32),
                     ("bland", torch.bool), ("last_z", dtype)):
        strides.append(_scalar(getattr(st, name), name, B, dt))
    devex = bounded and opts.rule == RULE_DEVEX
    bstrides = [0, 0, 0]
    if bounded:
        bstrides = [_vector(bs.upper, "upper", B, n, dtype),
                    _vector(bs.at_upper, "at_upper", B, n, torch.bool),
                    _vector(bs.gamma, "gamma", B, n, dtype) if devex else 0]
    if T.device.type != "cuda" or any(x.device != T.device for x in ops):
        raise ValueError(
            "lane kernels take the state's tensors on one CUDA device; got "
            f"{sorted({str(x.device) for x in ops})}")
    # the C side's order: the lanes' 20 pointers and 10 strides, the
    # bounded lanes' 5 pointers and 3 strides, the stage clock
    tail = strides + [0] * 5 + bstrides
    iargs = _INTS(B, M, N, min(int(stall_limit), _INT_MAX),
                  min(int(max_iters), _INT_MAX), int(opts.rule),
                  int(opts.tie_break), int(plan.resident), plan.threads,
                  plan.smem)
    tols = _TOLS(opts.opt_tol, opts.piv_tol, opts.degen_tol,
                 opts.infeas_tol, opts.feas_tol)
    return _Call((B, M, N), tail, iargs, tols,
                 f"tpulp_lane_{kind}_{suffix(dtype)}", devex)


def _launch(kind: str, st: SimplexState, opts: SolverOptions,
            stall_limit: int, max_iters: int, bs=None, threads=None,
            resident=None, stage_cycles=None):
    """The launch of the ``kind`` ("dual", "primal" or "bounded") loop;
    ``bs`` is the batched ``BoundedState`` of a bounded launch."""
    call = _call(kind, st, opts, stall_limit, max_iters, bs, threads,
                 resident)
    B, M, N = call.dims
    m, n = M - 2, N - 1
    dtype, dev = st.T.dtype, st.T.device
    bounded = kind == "bounded"
    masks = kind != "dual"  # the loops that write the masks
    if stage_cycles is not None:
        check(stage_cycles, "stage_cycles", torch.int64, (len(LANE_STAGES),))
        if stage_cycles.device != dev:
            raise ValueError(f"stage_cycles: expected a tensor on {dev}")
    # one allocation for the int32 fields and one for the bool ones, each
    # split into its fields by one call: each allocation and view is host
    # time on the waves' path
    ints = torch.empty((B * (4 + m),), dtype=torch.int32, device=dev)
    phase, status, niter, stuck, basis = torch.split_with_sizes(
        ints, (B, B, B, B, B * m))
    bools = torch.empty((B * (1 + (2 * masks + bounded) * n),),
                        dtype=torch.bool, device=dev)
    bland, col_active, art_cols, at_upper = bools, st.col_active, \
        st.art_cols, None
    if masks:
        bland, col_active, art_cols, *rest = torch.split_with_sizes(
            bools, (B, B * n, B * n) + (B * n,) * bounded)
        col_active, art_cols = col_active.view(B, n), art_cols.view(B, n)
        if bounded:
            at_upper = rest[0].view(B, n)
    out = SimplexState(
        T=torch.empty((B, M, N), dtype=dtype, device=dev),
        basis=basis.view(B, m), col_active=col_active, art_cols=art_cols,
        phase=phase, status=status, niter=niter, stuck=stuck, bland=bland,
        last_z=torch.empty((B,), dtype=dtype, device=dev))
    ptrs = [st.T.data_ptr(), out.T.data_ptr(), st.basis.data_ptr(),
            out.basis.data_ptr(), st.col_active.data_ptr(),
            st.art_cols.data_ptr()]
    ptrs += ([out.col_active.data_ptr(), out.art_cols.data_ptr()] if masks
             else [0, 0])
    ptrs += [x.data_ptr() for x in (
        st.phase, st.status, st.niter, st.stuck, st.bland, st.last_z,
        out.phase, out.status, out.niter, out.stuck, out.bland, out.last_z)]
    tail = call.tail
    gamma = None
    if bounded:
        gamma = (torch.empty((B, n), dtype=dtype, device=dev) if call.devex
                 else bs.gamma)
        tail = tail[:10] + _pointers(
            [bs.upper, bs.at_upper, at_upper,
             bs.gamma if call.devex else None,
             gamma if call.devex else None]) + tail[15:]
    # the C side reads the arguments before the call returns
    args = array.array("q", ptrs + tail + _pointers([stage_cycles]))
    lib = lib_for(dev)
    err = getattr(lib, call.name)(args.buffer_info()[0], call.iargs,
                                  call.tols, stream_of(dev))
    if err:
        raise_on(lib, err, "lane kernel")
    LAUNCHES[f"lane_{kind}"] += 1
    if bounded:
        return bs._replace(s=out, at_upper=at_upper, gamma=gamma)
    return out


def lane_dual(state: SimplexState, opts: SolverOptions, stall_limit: int,
              max_iters: int, threads: int | None = None,
              resident: bool | None = None,
              stage_cycles: torch.Tensor | None = None) -> SimplexState:
    """The dual-simplex loop (``dual_simplex_step``) of every lane of
    ``state`` (a batched state on one CUDA device) to its exit; RUNNING
    lanes at the budget stay RUNNING. The masks of the result are the
    input's. ``threads``, ``resident`` and ``stage_cycles`` as
    ``lane_primal``'s."""
    return _launch("dual", state, opts, stall_limit, max_iters,
                   threads=threads, resident=resident,
                   stage_cycles=stage_cycles)


def lane_primal(state: SimplexState, opts: SolverOptions, stall_limit: int,
                max_iters: int, threads: int | None = None,
                resident: bool | None = None,
                stage_cycles: torch.Tensor | None = None) -> SimplexState:
    """The rank-1 primal loop of every lane of ``state`` to its exit (both
    phases, the artificial clean-up, Dantzig / Bland / greatest-increase
    pricing with first-index or largest-pivot ratio ties; devex prices as
    Dantzig, as ``simplex_step`` does). ``threads`` and ``resident``
    force the plan (``lane_plan``'s); ``stage_cycles``, an int64 tensor of
    ``len(LANE_STAGES)`` on the card, accumulates block 0's clock by stage
    and its barriers (a measurement; the kernel walks the same)."""
    return _launch("primal", state, opts, stall_limit, max_iters,
                   threads=threads, resident=resident,
                   stage_cycles=stage_cycles)


def lane_bounded(bs, opts: SolverOptions, stall_limit: int, max_iters: int,
                 threads: int | None = None, resident: bool | None = None,
                 stage_cycles: torch.Tensor | None = None):
    """The bounded-variable loop (``bounded_simplex_step``) of every lane of
    the batched ``BoundedState`` ``bs`` (one CUDA device) to its exit:
    both phases, the clean-up, Dantzig or devex pricing (every other rule
    priced as Dantzig, as the step does) with the Bland switch, the
    three-way ratio test, the pivot and the column flips. RUNNING lanes at
    the budget stay RUNNING. The spans are the input's; ``gamma`` is
    required under ``RULE_DEVEX`` and passed through otherwise.
    ``threads``, ``resident`` and ``stage_cycles`` as ``lane_primal``'s."""
    if opts.rule == RULE_DEVEX and bs.gamma is None:
        raise ValueError("lane_bounded: devex pricing needs the weights "
                         "gamma")
    return _launch("bounded", bs.s, opts, stall_limit, max_iters, bs,
                   threads=threads, resident=resident,
                   stage_cycles=stage_cycles)
