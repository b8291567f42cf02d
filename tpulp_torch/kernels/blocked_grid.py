"""``blocked_grid``: a block of K eta-pivot slots of the solo rank-K
blocked engine in one persistent cooperative launch on the whole card
(``csrc/blocked_grid.cu``), the block's eta factors in slabs whose first
slots live in the SMs' shared memory; its launch plans, the walk around it
and its plain version.

``kernels.blocked_cluster`` runs the K slots of a block in one launch only
where a cluster of 8 or 16 blocks holds the block's factors (K = 64, f64:
M + N up to ~7,100); every other solo blocked walk runs here, in one launch
of G blocks, one an SM: block g keeps its slabs ``V[0..K, g W:(g + 1) W]``
and ``U[0..K, g H:(g + 1) H]`` (``W = ceil(N / G)``, ``H = ceil(M / G)``)
with its entries of the running vectors, and the blocks meet at two grid
barriers a slot (three in a clean-up slot), exchanging their candidates and
the factors' columns that the winners need through mailboxes in device
memory (the header of ``csrc/blocked_grid.cu``). ``blocked_grid_plan``
picks G, how many of a slab's K slots live in shared memory
(``resident``, KR: all K where they fit, as many as fit past that, the
others read and written in the record's U and V in device memory) and
where the running vectors, the basis and the artificial bits live
(``vectors``: "shared", a block's shared memory; "device", the record in
device memory, the basis by row slab, with a barrier D a slot), and counts
the kernel's shared memory and mailboxes (the launch refuses a plan that
disagrees). It refuses no f32 or f64 frame that ``kernels.blocked._check``
accepts; only a plan forced past a block's shared memory raises
``GridPlanTooLarge``. Between two blocks nothing changes: B1
(``block.fused_flush``) flushes the factors and ``kernels.blocked``'s ray
launch evaluates the per-block ray scan and resets the carry, with one
host read of (status, niter) a block.

``blocked_grid`` takes a state on one CUDA device and raises on anything
else (CPU tensors, mixed devices, a strided tableau, a type other than f32
and f64, a forced plan past a block's shared memory, a grid the card
cannot hold at once: ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
times the SMs below G). It never writes the caller's tensors.

``blocked_grid_reference`` is the same walk in plain torch over G slabs,
on every plan: the plain stages of ``kernels.blocked`` composed slot by
slot, flushed by B1's plain version. The kernel's sums that feed
finiteness checks only, the pre-step ``|c|`` over the active columns and
the post-step ``|bvec[2:]|``, are taken per block and across blocks in
block order (``sums.grid_sum``) on every plan; the plain version takes
them in that order. So it parts from ``blocked_walk_reference`` and
``blocked_cluster_reference`` only where one order overflows to infinity
and another does not; on every other input the three give the same walk in
every field, whatever G. Nothing on the solver's path calls the plain
version: ``solve.blocked`` runs the eager engine on CPU tensors and the
kernels on CUDA tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..core.state import SimplexState, SolverOptions, Status
from . import blocked as kb
from .block import fused_flush_reference
from .bounded_grid import GRID_SMS, GridPlanTooLarge
from .launch import (LAUNCHES, check, lib_for, raise_on, sm_count,
                     stream_of, suffix)
from .sums import THREADS, grid_sum

__all__ = ["BlockedGridPlan", "blocked_grid_plan", "blocked_grid_occupancy",
           "blocked_grid", "blocked_grid_block", "blocked_grid_work",
           "blocked_grid_block_reference", "blocked_grid_reference",
           "BLOCKED_GRID_THREADS", "BLOCKED_GRID_SMEM_LIMIT",
           "BLOCKED_GRID_STATIC_SMEM", "BLOCKED_GRID_STAGES",
           "BLOCKED_GRID_VECTORS", "GridPlanTooLarge"]

BLOCKED_GRID_THREADS = THREADS
# the static shared memory left to the kernel's key reductions, combines
# and stage clock (chip_smoke.py holds ptxas's figure to it), and the
# dynamic shared memory a block may then take on an H100: the opt-in
# maximum, 232,448 bytes, less that
BLOCKED_GRID_STATIC_SMEM = 3_072
BLOCKED_GRID_SMEM_LIMIT = 232_448 - BLOCKED_GRID_STATIC_SMEM
# the stages that ``stage_cycles`` splits a launch into (csrc/
# blocked_grid.cu's Stage; block 0's clock): the load; a slot's clean-up
# row (barrier C and its read), pricing and its post, barrier A, the
# combine with the read of the entering column's V slots, the column's
# rows, the ratio test and its post, barrier B, the combine with the read of
# the pivot row's U slots, the pivot row and the updates, the block's
# reduction, the finish, barrier D with its post and combine (the
# device-vector plan only); the last slot's sums (one barrier); the store
BLOCKED_GRID_STAGES = ("load", "cleanup", "price", "barrier_a", "combine_a",
                       "column", "ratio", "barrier_b", "combine_b", "row",
                       "reduce", "finish", "barrier_d", "final", "store")
# where a plan keeps the running vectors, the basis and the artificial bits
BLOCKED_GRID_VECTORS = ("shared", "device")
# the mailboxes' headers and tails (csrc/blocked_grid.cu's HEAD_A, HEAD_B,
# HEAD_D, TAIL)
_HEAD_A, _HEAD_B, _HEAD_D, _TAIL = 64, 32, 16, 32
_NARGS, _NINTS = 15, 15
_ARGS = ctypes.c_longlong * _NARGS
_INTS = ctypes.c_int * _NINTS


class BlockedGridPlan(NamedTuple):
    blocks: int    # G, the blocks of the grid (at most one an SM)
    width: int     # W, the columns of a block's slab
    height: int    # H, the rows of a block's slab
    threads: int   # threads a block
    smem: int      # dynamic shared-memory bytes a block
    mail: int      # bytes of the mailboxes (and colj) in device memory
    resident: int  # KR, a slab's slots in shared memory (the rest in U, V)
    vectors: str   # "shared" or "device": where the running vectors live


def _align(x: int) -> int:
    return (x + 15) // 16 * 16


def _smem(M: int, N: int, K: int, KR: int, W: int, H: int, G: int, es: int,
          vectors: str) -> int:
    """csrc/blocked_grid.cu's smem_bytes: the first KR slots of V's and
    U's slabs; on the "shared" plans row0, row1 and the weights of the
    column slab, bvec and colj of the row slab; U's rows 0 and 1, V's
    column N - 1 and the entering column's, the pivot row's and the
    clean-up row's eta coefficients; on the "shared" plans the basis, the
    slab's active mask and the artificial mask (a bit a column); the G
    mailbox headers a combine brings."""
    m, n = M - 2, N - 1
    b = (_align(KR * W * es) + _align(KR * H * es) + 6 * _align(K * es)
         + _align(_HEAD_A * G))
    if vectors == "shared":
        b += (3 * _align(W * es) + 2 * _align(H * es) + _align(4 * m)
              + _align(W) + _align(4 * -(-n // 32)))
    return b


def _mail(G: int, K: int, es: int, M: int, vectors: str) -> int:
    """csrc/blocked_grid.cu's mail_bytes: G price headers, G ratio headers,
    G blocks' price columns (two V columns of K and a tail) and ratio
    columns (two U columns of K and a tail), the clean-up row's U column;
    on the "device" plan G barrier-D headers, G U columns of K and colj (M
    values)."""
    vec = _align(K * es)
    b = G * (_HEAD_A + 2 * vec + _HEAD_B + 2 * vec + 2 * _TAIL) + vec
    if vectors == "device":
        b += G * (_HEAD_D + vec) + _align(M * es)
    return b


def _resident(M, N, K, W, H, G, es, vectors) -> int:
    """The most slots of a slab (0 to K) that fit a block's shared memory
    beside the rest of the plan's layout, or -1 where none do."""
    def fits(kr):
        return _smem(M, N, K, kr, W, H, G, es, vectors) <= \
            BLOCKED_GRID_SMEM_LIMIT

    if not fits(0):
        return -1
    per = (W + H) * es
    kr = min(K, (BLOCKED_GRID_SMEM_LIMIT - _smem(M, N, K, 0, W, H, G, es,
                                                 vectors)) // per)
    while kr > 0 and not fits(kr):
        kr -= 1
    while kr < K and fits(kr + 1):
        kr += 1
    return kr


def _grid(L: int, sms: int) -> int:
    return -(-L // -(-L // sms))


@functools.lru_cache(maxsize=256)
def blocked_grid_plan(M: int, N: int, K: int, dtype, sms: int = GRID_SMS,
                      blocks: int | None = None, resident: int | None = None,
                      vectors: str | None = None) -> BlockedGridPlan:
    """The launch plan of a block of ``K`` slots on an (M, N) = (m + 2, n +
    1) tableau on a card of ``sms`` SMs. The first plan that fits a
    block's shared memory: "shared" vectors on G = ceil(N / ceil(N / sms))
    blocks with every slot of the slabs resident (KR = K), else as many
    slots as fit (KR < K, the rest in the record's U and V); else "device"
    vectors on G = ceil(L / ceil(L / sms)) blocks, L = max(M, N), with as
    many slots as fit. W = ceil(N / G) columns and H = ceil(M / G) rows a
    block (a block may own no column or no row), the dynamic shared memory
    a block needs and the mailboxes' bytes. 258 x 14,257 at f64 on 132 SMs:
    K 64, 131 blocks of 109 columns and 2 rows, 73,888 bytes a block, every
    slot resident; K 256, 228 of the 256 slots resident.

    ``blocks`` forces G (1 to ``sms``), ``resident`` KR (0 to K) and
    ``vectors`` the kind ("shared" or "device"); a forced plan past
    ``BLOCKED_GRID_SMEM_LIMIT`` raises ``GridPlanTooLarge``, which no
    unforced plan does. Raises ValueError for another type, a frame outside
    2^24, a K, a grid, a KR or a kind out of range."""
    es = {torch.float32: 4, torch.float64: 8}.get(dtype)
    if es is None:
        raise ValueError(f"blocked_grid takes float32 or float64, not "
                         f"{dtype}")
    if M < 3 or N < 2 or max(M, N) >= kb._MAX_SIDE:
        raise ValueError(f"tableau {M} x {N} outside 3..2^24 x 2..2^24")
    if not 1 <= K <= kb.MAX_K:
        raise ValueError(f"block of {K} pivots outside 1..{kb.MAX_K}")
    if blocks is not None and not 1 <= blocks <= sms:
        raise ValueError(f"a grid of {blocks} blocks: expected 1 to {sms}")
    if resident is not None and not 0 <= resident <= K:
        raise ValueError(f"{resident} resident slots: expected 0 to {K}")
    if vectors is not None and vectors not in BLOCKED_GRID_VECTORS:
        raise ValueError(f"vectors {vectors!r}: expected one of "
                         f"{BLOCKED_GRID_VECTORS}")
    for kind in (vectors,) if vectors else BLOCKED_GRID_VECTORS:
        G = blocks or _grid(N if kind == "shared" else max(M, N), sms)
        W, H = -(-N // G), -(-M // G)
        KR = _resident(M, N, K, W, H, G, es, kind)
        if resident is not None:
            KR = resident if KR >= resident else -1
        if KR >= 0:
            return BlockedGridPlan(
                G, W, H, BLOCKED_GRID_THREADS,
                _smem(M, N, K, KR, W, H, G, es, kind),
                _mail(G, K, es, M, kind), KR, kind)
    KR = 0 if resident is None else resident
    raise GridPlanTooLarge(
        f"block of {K} pivots on {M} x {N} {dtype}: a block of a grid of "
        f"{G} ({W} columns, {H} rows) with {KR} slots and {kind} vectors "
        f"needs {_smem(M, N, K, KR, W, H, G, es, kind)} bytes of shared "
        f"memory, above {BLOCKED_GRID_SMEM_LIMIT}")


def _plan_ints(plan: BlockedGridPlan, M: int, N: int, K: int):
    """The launch's int arguments (csrc/blocked_grid.cu's Int) but the
    walk's: the shape and the plan."""
    return _INTS(M, N, K, 0, 0, 0, 0, plan.blocks, plan.width, plan.height,
                 plan.threads, plan.smem, plan.mail, plan.resident,
                 int(plan.vectors == "device"))


@functools.lru_cache(maxsize=64)
def _occupancy(index: int, plan: BlockedGridPlan, M: int, N: int, K: int,
               dtype) -> int:
    lib = lib_for(torch.device("cuda", index))
    out = ctypes.c_int(0)
    fn = getattr(lib, f"tpulp_blocked_grid_occupancy_{suffix(dtype)}")
    raise_on(lib, fn(_plan_ints(plan, M, N, K), ctypes.byref(out)),
             "blocked_grid occupancy")
    return out.value


def blocked_grid_occupancy(M: int, N: int, K: int, dtype,
                           device: torch.device | None = None,
                           blocks: int | None = None,
                           resident: int | None = None,
                           vectors: str | None = None) -> int:
    """``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` of the launch of a
    block of ``K`` slots on an (M, N) tableau (the plan on ``device``'s
    SMs; ``blocks``, ``resident`` and ``vectors`` as in
    ``blocked_grid_plan``): the blocks an SM holds at once (asked once a
    plan and device)."""
    device = torch.device("cuda", 0) if device is None else device
    plan = blocked_grid_plan(M, N, K, dtype, sm_count(device), blocks,
                             resident, vectors)
    return _occupancy(device.index or 0, plan, M, N, K, dtype)


class BlockedGridWork(NamedTuple):
    """A walk's scratch in device memory: the mailboxes (and, on the
    device-vector plan, the entering column) and the grid barrier's counter
    (zeroed by each launch)."""

    mail: torch.Tensor
    bar: torch.Tensor


def blocked_grid_work(plan: BlockedGridPlan,
                      device: torch.device) -> BlockedGridWork:
    """The scratch of a walk on ``plan``: allocated once a walk."""
    return BlockedGridWork(
        mail=torch.empty((plan.mail,), dtype=torch.uint8, device=device),
        bar=torch.zeros((1,), dtype=torch.int32, device=device))


def _check_cycles(stage_cycles, device) -> None:
    if stage_cycles is not None:
        check(stage_cycles, "stage_cycles", torch.int64,
              (len(BLOCKED_GRID_STAGES),))
        if stage_cycles.device != device:
            raise ValueError(f"stage_cycles: expected a tensor on {device}")


def blocked_grid_block(rec: kb.BlockedRecord, opts: SolverOptions,
                       stall_limit: int, max_iters: int,
                       blocks: int | None = None,
                       stage_cycles: torch.Tensor | None = None,
                       work: BlockedGridWork | None = None,
                       resident: int | None = None,
                       vectors: str | None = None) -> None:
    """The K slots of the record's block in one cooperative launch (counted
    in ``LAUNCHES["blocked_grid"]``), in place: what K of the plain stages'
    slots (``kernels.blocked.blocked_pivot_reference``) compute; the
    record's scratch and verdict fields are left as they were, but
    ``LIVE``. A record that is not running within ``max_iters`` is left as
    it is, but ``LIVE = 0``. ``blocks``, ``resident`` and ``vectors`` force
    the plan (``blocked_grid_plan``); ``stage_cycles`` (int64,
    ``len(BLOCKED_GRID_STAGES)`` on the card) accumulates block 0's SM
    cycles by stage; ``work`` is the walk's scratch
    (``blocked_grid_work``; allocated here when absent)."""
    lib, args, iargs, tols = kb._entry(rec, opts, stall_limit, max_iters)
    T = rec.T
    if T.dim() != 2:
        raise ValueError(f"expected a solo record, got a tableau of "
                         f"{tuple(T.shape)}")
    M, N = T.shape
    K = rec.U.shape[0]
    _check_cycles(stage_cycles, T.device)
    plan = blocked_grid_plan(M, N, K, T.dtype, sm_count(T.device), blocks,
                             resident, vectors)
    if work is None:
        work = blocked_grid_work(plan, T.device)
    if work.mail.numel() < plan.mail or work.mail.device != T.device or \
            work.bar.device != T.device:
        raise ValueError(f"work: expected {plan.mail} bytes of mailboxes "
                         f"and a counter on {T.device}")
    gargs = _ARGS(*(0 if x is None else x.data_ptr() for x in (
        T, rec.U, rec.V, rec.row0, rec.row1, rec.bvec, rec.gamma, rec.basis,
        rec.col_active, rec.art_cols, rec.ints, rec.vals, work.mail,
        work.bar, stage_cycles)))
    gi = _plan_ints(plan, M, N, K)
    for k in range(3, 7):  # stall, budget, rule, tie break: as kb's
        gi[k] = iargs[k]
    fn = getattr(lib, f"tpulp_blocked_grid_{suffix(T.dtype)}")
    err = fn(gargs, gi, tols, stream_of(T.device))
    if err:
        raise_on(lib, err, "blocked_grid")
    LAUNCHES["blocked_grid"] += 1


def _require_grid(M: int, N: int, K: int, dtype, device,
                  blocks: int | None, resident: int | None = None,
                  vectors: str | None = None) -> BlockedGridPlan:
    """The plan, raising unless the card holds its grid at once."""
    plan = blocked_grid_plan(M, N, K, dtype, sm_count(device), blocks,
                             resident, vectors)
    occ = blocked_grid_occupancy(M, N, K, dtype, device, blocks,
                                 resident=resident, vectors=vectors)
    if occ * sm_count(device) < plan.blocks:
        raise RuntimeError(f"blocked_grid: the card holds {occ} blocks of "
                           f"{plan.smem} bytes of shared memory an SM, not "
                           f"a grid of {plan.blocks} ({M} x {N} {dtype}, "
                           f"K {K})")
    return plan


def blocked_grid(state: SimplexState, opts: SolverOptions, stall_limit: int,
                 max_iters: int, K: int, blocks: int | None = None,
                 stage_cycles: torch.Tensor | None = None,
                 resident: int | None = None, vectors: str | None = None):
    """The rank-K blocked walk of ``state`` (one problem on one CUDA
    device) in blocks of ``K`` pivots, to its exit or to ``max_iters``: a
    block is one cooperative launch, B1's flush and the ray launch, with
    one host read of (status, niter) a block; a RUNNING exit at the budget
    stays RUNNING. ``blocks``, ``stage_cycles``, ``resident`` and
    ``vectors`` as in ``blocked_grid_block``. Returns (state, devex
    weights); the caller's tensors are never written."""
    kb._check(state, K)
    T = state.T
    M, N = T.shape
    _check_cycles(stage_cycles, T.device)
    plan = _require_grid(M, N, K, T.dtype, T.device, blocks, resident,
                         vectors)
    rec = kb.make_record(state, K)
    work = blocked_grid_work(plan, T.device)

    def block(r):
        blocked_grid_block(r, opts, stall_limit, max_iters, blocks,
                           stage_cycles, work, resident, vectors)
        kb.flush_and_ray(r, opts, stall_limit, max_iters)

    kb._walk(rec, max_iters, block)
    return kb.record_state(rec), rec.gamma


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def _crow_ok(rec: kb.BlockedRecord, W: int, G: int) -> bool:
    """The finiteness of the pre-step pricing row's |c| sum over the active
    columns, in the kernel's order (the column slabs, then the grid)."""
    crow = (rec.row1 if int(rec.ints[kb.PHASE]) == 1 else rec.row0)[:-1]
    vals = torch.where(rec.col_active, crow.abs(), 0.0)
    return bool(torch.isfinite(grid_sum(vals, W, G)))


def _bvec_sum(rec: kb.BlockedRecord, H: int, G: int) -> torch.Tensor:
    """The post-step |bvec[2:]| sum in the kernel's order (the row slabs,
    then the grid; rows 0 and 1 add nothing)."""
    vals = rec.bvec.abs()
    vals[:2] = 0.0
    return grid_sum(vals, H, G)


def blocked_grid_block_reference(rec: kb.BlockedRecord, opts: SolverOptions,
                                 stall_limit: int, max_iters: int,
                                 G: int) -> None:
    """``blocked_grid_block``'s K slots in plain torch on a grid of ``G``
    blocks (any G >= 1), in place: ``kernels.blocked``'s plain stages slot
    by slot, the two finiteness sums in the kernel's order (the record's
    scratch holds them as the plain stages leave it, except that its row
    partials hold the |bvec[2:]| sum in its first slot). A record that is
    not running within ``max_iters`` is left as it is, but ``LIVE = 0``."""
    M, N = rec.T.shape
    W, H = -(-N // G), -(-M // G)
    P = kb.partials(M, N)
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
        rec.ints[kb.CROW_OK] = int(_crow_ok(rec, W, G))
        kb.blocked_column_reference(rec, opts, max_iters)
        kb.blocked_ratio_reference(rec, opts, max_iters)
        kb.blocked_row_reference(rec, opts, max_iters)
        # the finish adds the partials from 0: the sum, then zeros
        part = rec.scratch[M + N + P:]
        part.zero_()
        part[0] = _bvec_sum(rec, H, G)
        kb.blocked_finish_reference(rec, opts, stall_limit, max_iters)


def blocked_grid_reference(state: SimplexState, opts: SolverOptions,
                           stall_limit: int, max_iters: int, K: int, G: int,
                           flush=fused_flush_reference):
    """``blocked_grid``'s walk in plain torch on a grid of ``G`` blocks, in
    blocks of ``K``, each flushed through ``flush`` (B1's plain version or
    ``block.fused_flush``) and ended by the ray stage. Returns (state,
    devex weights); a RUNNING exit at the budget stays RUNNING. The
    caller's tensors are never written."""
    rec = kb.make_record(state, K)

    def block(r):
        blocked_grid_block_reference(r, opts, stall_limit, max_iters, G)
        _, scan = flush(*kb.flush_inputs(r), float(opts.opt_tol),
                        float(opts.piv_tol))
        kb.blocked_ray_reference(r, scan, opts)

    kb._walk(rec, max_iters, block)
    return kb.record_state(rec), rec.gamma
