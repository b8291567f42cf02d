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
plan that disagrees). ``lane_primal`` and ``lane_bounded`` take a block of
32 to 256 threads from the frame's width (``lane_threads``: one warp for
10c's 3 x 30 span nodes, whose block then passes no block barrier);
``lane_dual`` keeps 256.

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
# the most threads a block (lane_dual's block)
LANE_THREADS = 256
# the stages that ``stage_cycles`` splits a lane_primal / lane_bounded
# launch into (csrc/lanes.cu's WalkStage: block 0's clock, summed over the
# steps): the load; a step's price pass and its reduction (with the
# previous step's finish); the clean-up pass, the ratio test and the ties;
# the update; the store; then the block barriers block 0 passed
LANE_STAGES = ("load", "price", "ratio", "update", "store", "barriers")
# the largest frame side the kernels index (basis values go through the
# tableau's type in Bland's tie rule: exact in float32 below 2^24)
_MAX_SIDE = 1 << 24
# the lanes' 20 pointers and 10 strides, the bounded lanes' 5 pointers and
# 3 strides, the stage clock
_NARGS, _NINTS, _NTOLS = 39, 10, 5
_ARGS = ctypes.c_longlong * _NARGS
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


def lane_dual_plan(M: int, N: int, dtype) -> LanePlan:
    """``lane_dual``'s launch plan: the frame (M x N) and its vectors
    (the pivot's column and row, the basis, two masks) in shared memory
    while they fit ``LANE_SMEM_LIMIT``, else streamed; ``LANE_THREADS``
    a block."""
    es = _itemsize(M, N, dtype)
    m, n = M - 2, N - 1
    vectors = (_align(M * es) + _align(N * es) + _align(4 * m)
               + 2 * _align(n))
    return _fit(vectors, _align(M * N * es), M, N, LANE_THREADS, None)


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


def _launch(kind: str, st: SimplexState, opts: SolverOptions,
            stall_limit: int, max_iters: int, bs=None, threads=None,
            resident=None, stage_cycles=None):
    """The launch of the ``kind`` ("dual", "primal" or "bounded") loop;
    ``bs`` is the batched ``BoundedState`` of a bounded launch."""
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
    masks = kind != "dual"  # the loops that write the masks
    if kind == "dual":
        plan = lane_dual_plan(M, N, dtype)
    else:
        plan = (lane_bounded_plan if bounded else lane_plan)(
            M, N, dtype, threads, resident)
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
    operands = list(st)
    if bounded:
        operands += [bs.upper, bs.at_upper]
        strides += [_vector(bs.upper, "upper", B, n, dtype),
                    _vector(bs.at_upper, "at_upper", B, n, torch.bool)]
        if devex:
            operands.append(bs.gamma)
            strides.append(_vector(bs.gamma, "gamma", B, n, dtype))
        else:
            strides.append(0)
    else:
        strides += [0, 0, 0]
    if T.device.type != "cuda" or any(x.device != T.device
                                      for x in operands):
        raise ValueError(
            "lane kernels take the state's tensors on one CUDA device; got "
            f"{sorted({str(x.device) for x in operands})}")
    dev = T.device
    if stage_cycles is not None:
        check(stage_cycles, "stage_cycles", torch.int64, (len(LANE_STAGES),))
        if stage_cycles.device != dev:
            raise ValueError(f"stage_cycles: expected a tensor on {dev}")
    # one allocation for the int32 fields and one for the bool ones: each
    # allocation is host time on the waves' path
    ints = torch.empty((B * (4 + m),), dtype=torch.int32, device=dev)
    bools = torch.empty((B * (1 + (2 * masks + bounded) * n),),
                        dtype=torch.bool, device=dev)
    out = SimplexState(
        T=torch.empty((B, M, N), dtype=dtype, device=dev),
        basis=ints[4 * B:].view(B, m),
        col_active=(bools[B:B + B * n].view(B, n) if masks
                    else st.col_active),
        art_cols=(bools[B + B * n:B + 2 * B * n].view(B, n) if masks
                  else st.art_cols),
        phase=ints[:B], status=ints[B:2 * B], niter=ints[2 * B:3 * B],
        stuck=ints[3 * B:4 * B], bland=bools[:B],
        last_z=torch.empty((B,), dtype=dtype, device=dev))
    ins = [st.T, out.T, st.basis, out.basis, st.col_active, st.art_cols]
    ins += ([out.col_active, out.art_cols] if masks else [None, None])
    ins += [st.phase, st.status, st.niter, st.stuck, st.bland, st.last_z,
            out.phase, out.status, out.niter, out.stuck, out.bland,
            out.last_z]
    extra = [None] * 5
    at_upper = gamma = None
    if bounded:
        at_upper = bools[B + 2 * B * n:].view(B, n)
        gamma = (torch.empty((B, n), dtype=dtype, device=dev) if devex
                 else bs.gamma)
        extra = [bs.upper, bs.at_upper, at_upper,
                 bs.gamma if devex else None, gamma if devex else None]
    # the C side's order: the lanes' 20 pointers and 10 strides, the
    # bounded lanes' 5 pointers and 3 strides, the stage clock
    args = _ARGS(*_pointers(ins), *strides[:10], *_pointers(extra),
                 *strides[10:], *_pointers([stage_cycles]))
    iargs = _INTS(B, M, N, min(int(stall_limit), _INT_MAX),
                  min(int(max_iters), _INT_MAX), int(opts.rule),
                  int(opts.tie_break), int(plan.resident), plan.threads,
                  plan.smem)
    tols = _TOLS(opts.opt_tol, opts.piv_tol, opts.degen_tol,
                 opts.infeas_tol, opts.feas_tol)
    lib = lib_for(dev)
    fn = getattr(lib, f"tpulp_lane_{kind}_{suffix(dtype)}")
    err = fn(args, iargs, tols, stream_of(dev))
    if err:
        raise_on(lib, err, "lane kernel")
    LAUNCHES[f"lane_{kind}"] += 1
    if bounded:
        return bs._replace(s=out, at_upper=at_upper, gamma=gamma)
    return out


def lane_dual(state: SimplexState, opts: SolverOptions, stall_limit: int,
              max_iters: int) -> SimplexState:
    """The dual-simplex loop of every lane of ``state`` (a batched state on
    one CUDA device) to its exit; RUNNING lanes at the budget stay
    RUNNING. The masks of the result are the input's."""
    return _launch("dual", state, opts, stall_limit, max_iters)


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
