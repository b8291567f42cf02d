"""``bounded_grid``: the solo bounded-variable walk in one persistent
cooperative launch (``csrc/bounded_grid.cu``), its launch plan and its
plain version.

The whole walk of ``solve.bounded.bounded_simplex_step`` runs in one
launch: G blocks (at most one an SM) each own the structural columns
``[g W, min(n, (g + 1) W))`` of all M rows, price them, and combine their
candidates in slab order after a grid barrier; the owner of the entering
column runs the three-way ratio test and publishes the verdict and its
column before a second barrier; every block then updates its slab and its
copy of the RHS in place. A third barrier runs only where a basic column
is not an exact unit vector (csrc/bounded_grid.cu's header). Where the
column slabs fit the SMs' shared memory, all M rows of a slab live there
(a resident plan); past that, its first R rows do, and rows [R, M) are
streamed each step through device memory, tile by tile, through a ring
of ``GRID_RING_STAGES`` tiles of about ``GRID_TILE_BYTES`` in shared
memory (a streamed plan). Where every block's copy of the per-row vectors
(the RHS, the basis, the spans, the artificial mask) leaves rows 0-2 and
the ring no room, those vectors live in device memory instead (two
copies, a step reading one and writing the other), every block updating
its share of the RHS rows and taking its share of the ratio test's rows,
and a block keeps R rows as large as what is left (the device-vector
plan, always streamed, with a ring of ``GRID_DEVICE_STAGES``; two more
grid barriers a step). Where even a slab's rows 0-2 and that ring do not
fit a block (slabs past 3,098 columns at f64 and 6,032 at f32: n past
408,936 and 796,224 on 132 SMs), no row of a slab lives in shared memory
(the wide plan): every row streams from the scratch buffer, the slab cut
into chunks of ``GRID_WIDE_CHUNK`` columns (one a thread) and each chunk
into tiles of TR rows, through a ring of ``GRID_WIDE_SLOTS`` tiles; the
pivot row's entries, the devex weights and the masks are read from device
memory one chunk at a time, the per-row vectors live in device memory as
on the device-vector plan.
``bounded_grid_plan`` picks W (at least ``GRID_MIN_ENTRIES`` entries a
slab, so that small frames take few blocks) and G, counts the kernel's
shared memory and, past the resident slab, R and the streamed buffer; it
refuses no f32 or f64 frame with sides under 2^24. ``solve.bounded.
bounded_route`` sends every solo walk on the card here.

``bounded_grid`` takes a state on one CUDA device and raises on anything
else (CPU tensors, mixed devices, a strided tableau, a type other than f32
and f64, devex without weights, a frame with a side of 2^24 or more, a
forced plan past its edge, a grid the card cannot hold at once; a frame
and scratch past the card's memory raise torch's allocation error). It
allocates the output state and never writes the caller's tensors. The
entering flips and upper hits of the walk are added to
``kernels.bounded.FLIPS`` (one host read a walk).

``bounded_grid_reference`` is the same walk cut into G slabs, in plain
torch (every plan alike: the split of a slab's rows between shared and
device memory changes no entry's arithmetic, an entry's update being one
fma of its own pre-step value): the plain stages of ``kernels.bounded``
(pricing, whose first-index argmin is the slabs' candidates combined in
slab order; the ratio test on the entering column; the update from its
snapshot: the mailbox's colj and colf; the finish), with the finiteness
sums in the kernel's order (``grid_sum``, ``block_sum``; the
device-vector and wide plans add |b| as ``grid_sum`` over slabs of
ceil(m / G) rows). It equals
``bounded_simplex_step`` walked step by step, bit for bit. Nothing on the
solver's path calls it: ``solve.bounded`` runs the plain loop on CPU
tensors and the kernels on CUDA tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..core.state import RULE_DEVEX, SimplexState, SolverOptions
from . import bounded as kb
from .launch import (LAUNCHES, check, lib_for, raise_on, sm_count,
                     stream_of, suffix)
from .sums import block_sum, grid_sum

__all__ = ["GridPlan", "GridPlanTooLarge", "bounded_grid_plan", "plan_grid",
           "bounded_grid_occupancy", "bounded_grid",
           "bounded_grid_reference", "grid_slabs", "grid_sum",
           "GRID_THREADS", "GRID_SMS", "GRID_MIN_ENTRIES", "GRID_SMEM_LIMIT",
           "GRID_STATIC_SMEM", "GRID_STAGES", "GRID_DEVICE_VECTOR_STAGES",
           "GRID_WIDE_STAGES", "GRID_RING_STAGES", "GRID_TILE_BYTES",
           "GRID_WIDE_CHUNK", "GRID_WIDE_SLOTS", "grid_stages"]

GRID_THREADS = 512
# the SMs of an H100 SXM: the plan's default
GRID_SMS = 132
# the fewest entries a block's slab holds (8 a thread), so that a small
# frame takes few blocks: W >= ceil(GRID_MIN_ENTRIES / M) (32 columns at
# 130 rows), not ceil(n / SMs)
GRID_MIN_ENTRIES = 4_096
# the static shared memory left to the kernel's reductions and mailbox
# copies (chip_smoke.py holds ptxas's figure to it), and the dynamic shared
# memory a block may then take on an H100: the opt-in maximum, 232,448
# bytes, less that
GRID_STATIC_SMEM = 3_072
GRID_SMEM_LIMIT = 232_448 - GRID_STATIC_SMEM
# a streamed plan's ring: its slots, and the bytes a tile aims at (TR rows
# of the slab's W columns, TR the largest power of two that fits, at most
# GRID_THREADS): while a block updates one tile, the loads of the next
# GRID_RING_STAGES - 1 are in flight (32 KB, its share of 3.35 TB/s at ~1.5
# us of latency)
GRID_RING_STAGES = 3
GRID_TILE_BYTES = 16_384
# the device-vector plan's ring, its own: it streams most of a frame, so
# it takes a slot more (each slot is reloaded a tile after its store); on
# an NVIDIA H100 80GB HBM3 at 700 W, at chip_smoke's 8a (x), 4 slots of
# 16 KB beat 3, 6 and 8 of them, 4 of 32 KB and 6 of 8 KB (PERF.md)
GRID_DEVICE_STAGES = 4
# the wide plan's chunks (csrc/bounded_grid.cu's WCH: one column a thread)
# and its ring's slots of TR x GRID_WIDE_CHUNK entries (TR the largest
# power of two whose tile takes at most GRID_WIDE_TILE_BYTES; a slot is
# reloaded a tile after its store): with no row of the slab in shared
# memory the tiles can be larger than the other plans'; on an NVIDIA H100
# 80GB HBM3 at 700 W, at chip_smoke's 8a (z), (z64) and (z32), 4 slots of
# 32 KB beat 6 and 8 of 16 KB, 6 of 32 KB and 3 of 64 KB
# (tools/torch_wide_plan_sweep.py; PERF.md)
GRID_WIDE_CHUNK = GRID_THREADS
GRID_WIDE_SLOTS = 4
GRID_WIDE_TILE_BYTES = 32_768
_MAX_STAGES = 8  # csrc/bounded_grid.cu's MAX_STAGES
# the stages that ``stage_cycles`` splits a walk into on the resident and
# streamed plans (csrc/bounded_grid.cu's Stage; block 0's clock): the load;
# a step's price, barrier A, the combine, the ratio test and its
# publication where block 0 owns the entering column, barrier B, barrier
# C, the fetch of the verdict and the entering column with the pivot row,
# the update of the resident rows and the RHS, the streamed rows' update
# (0 on a resident plan), the finish, barrier D (0: the device-vector plan
# only); the store; then "owner": the ratio test and its publication on
# the clock of the block that owns the entering column, whichever it is
GRID_STAGES = ("load", "price", "barrier_a", "combine", "ratio",
               "barrier_b", "barrier_c", "fetch", "update", "stream",
               "finish", "barrier_d", "store", "owner")
# the same counters on the device-vector plan, whose spans differ, under
# names of their own: the load, the price, barrier A; "combine_ties" the
# combine, the combine of the blocks' ratio picks and the pass over the
# block's rows for the winning kind's ties; "ratio_picks" the first pass
# over the block's rows (its two picks) and their publication;
# "barriers_b" barriers B and B'; barrier C; "ties_fetch" the ties'
# combine, the pivot row and the devex weights; "update_resident" the
# resident rows' update (the RHS is the finish's); the streamed rows'
# update; "finish_rhs" the finish with the block's share of the RHS rows,
# the basis and the spans and, after barrier D, the |b| sums' combine;
# barrier D; the store; "owner_picks" the first pass on the clock of the
# block that owns the entering column
GRID_DEVICE_VECTOR_STAGES = (
    "load", "price", "barrier_a", "combine_ties", "ratio_picks",
    "barriers_b", "barrier_c", "ties_fetch", "update_resident", "stream",
    "finish_rhs", "barrier_d", "store", "owner_picks")
# the wide plan's: the device-vector plan's spans where they are the same,
# and two of its own: "verdict" the ties' combine and the step's scalars
# (the pivot row and the weights are the stream's, chunk by chunk);
# "first_tile" the first chunk's pivot row entry and weight asked for and
# column j's entries of the first tile staged
GRID_WIDE_STAGES = (
    "load", "price", "barrier_a", "combine_ties", "ratio_picks",
    "barriers_b", "barrier_c", "verdict", "first_tile", "stream",
    "finish_rhs", "barrier_d", "store", "owner_picks")
# the mailbox: three regions of a slot a block (a step's candidates, the
# repricing after a devex reset, the last weights' maxima) and the verdict
_SLOT, _REGIONS = 64, 3
# ints_out: phase, status, niter, stuck, entering flips, upper hits
_NOUT = 6
_NARGS, _NINTS, _NTOLS = 28, 15, 5
_ARGS = ctypes.c_longlong * _NARGS
_INTS = ctypes.c_int * _NINTS
_TOLS = ctypes.c_double * _NTOLS
_INT_MAX = 2 ** 31 - 1


class GridPlan(NamedTuple):
    blocks: int   # G, the blocks of the grid
    width: int    # W, the structural columns of a block's slab
    threads: int  # threads a block
    smem: int     # dynamic shared-memory bytes a block
    mail: int     # bytes of the mailbox in device memory
    rows: int     # R, the slab's rows in shared memory (M: resident)
    stages: int   # the tile ring's slots (0: resident)
    tile_rows: int  # TR, rows a streamed tile (0: resident)
    scratch: int  # bytes of the streamed rows' buffer (0: resident)
    # where the per-row vectors live: "shared" (every block's copy),
    # "device" (one copy in device memory) or "wide" (there too, and no
    # row of the slab in shared memory); the last two bounded_grid's only
    vectors: str = "shared"
    chunk: int = 0  # WC, the wide plan's columns a chunk (0: no chunks)


class GridPlanTooLarge(ValueError):
    """A block's shared memory does not hold the frame's first three slab
    rows and tile ring (beside the replicated vectors, where the kernel
    keeps them there): ``solve.driver.solo_route`` then takes
    ``rank1_steps``; ``bounded_grid_plan`` raises it only where a plan is
    forced past its edge (its wide plan takes every other frame)."""


def _align(x: int) -> int:
    return (x + 15) // 16 * 16


def _smem(M: int, N: int, W: int, es: int, rows: int | None = None,
          stages: int = 0, tile: int = 0) -> int:
    """csrc/bounded_grid.cu's smem_bytes: the slab's ``rows`` resident rows
    (all M by default), the ring (``stages`` tiles of ``tile`` bytes), the
    RHS and the pivot's column, the pivot row's and the weights' segments,
    the basic variables' spans, the basis, the segment's active mask, the
    artificial mask and the ring's mbarriers."""
    m, n = M - 2, N - 1
    R = M if rows is None else rows
    return (_align(R * W * es) + stages * tile + 2 * _align(M * es)
            + 2 * _align(W * es) + _align(m * es) + _align(4 * m)
            + _align(W) + _align(n) + _align(8 * stages))


def _smem_device(W: int, es: int, rows: int, stages: int, tile: int,
                 tile_rows: int) -> int:
    """csrc/bounded_grid.cu's smem_bytes_dv, the device-vector plan's
    block: the slab's ``rows`` resident rows, the ring, the pivot row's and
    the weights' segments, column j's entries of two tiles, the segment's
    active and artificial masks and the ring's mbarriers."""
    return (_align(rows * W * es) + stages * tile + 2 * _align(W * es)
            + _align(2 * tile_rows * es) + 2 * _align(W) + _align(8 * stages))


def _smem_wide(es: int, stages: int, tile: int, tile_rows: int) -> int:
    """csrc/bounded_grid.cu's smem_bytes_wide, the wide plan's block: the
    ring, column j's entries of two tiles and the ring's mbarriers."""
    return stages * tile + _align(2 * tile_rows * es) + _align(8 * stages)


def _tile_rows(W: int, es: int, cap: int) -> int:
    """TR: the largest power of two of at most ``cap`` rows (and
    GRID_THREADS) whose W columns take at most GRID_TILE_BYTES (1 where a
    row takes more)."""
    tr = 1
    while (2 * tr <= min(cap, GRID_THREADS)
           and 2 * tr * W * es <= GRID_TILE_BYTES):
        tr *= 2
    return tr


def grid_slabs(n: int, blocks: int) -> tuple[int, int]:
    """(W, G): ``blocks`` slabs of the n structural columns, W = ceil(n /
    blocks) each and G = ceil(n / W) of them (the last may be narrower;
    none is empty)."""
    W = -(-n // blocks)
    return W, -(-n // W)


@functools.lru_cache(maxsize=256)
def bounded_grid_plan(M: int, N: int, dtype, sms: int = GRID_SMS,
                      blocks: int | None = None,
                      rows: int | None = None,
                      vectors: str | None = None) -> GridPlan:
    """The launch plan of a walk on an (M, N) = (m + 2, n + 1) frame on a
    card of ``sms`` SMs: W = max(ceil(n / sms), ceil(GRID_MIN_ENTRIES / M))
    columns a block and G = ceil(n / W) blocks (with ``blocks``,
    ``grid_slabs(n, blocks)``: another grid, to hold the kernel there), and
    the dynamic shared memory a block needs.

    Where a block's whole slab fits ``GRID_SMEM_LIMIT`` the plan is
    resident (``rows`` = M). Past it, the plan is streamed: the ring of
    GRID_RING_STAGES tiles of TR rows (``_tile_rows``) and the replicated
    vectors take their bytes, and R, the most rows that the rest holds (at
    most M - 1), stay in shared memory; rows [R, M) of each slab live in a
    ``scratch`` buffer of G regions of ceil((M - R) / TR) tiles.
    ``rows`` forces R (3 to M; M asks for the resident plan): the split
    that the tests and chip_smoke.py's edge walks hold at small frames.

    Where even rows 0-2 with the ring do not fit beside the replicated
    vectors (with n = 2m, past 6,284 rows (m = 6,282) at f64 and 10,800
    (m = 10,798) at f32 on 132 SMs), the plan keeps the vectors in device
    memory (``vectors`` "device"): the same W and G, the ring, and R the
    most rows the rest of a block holds (at most M - 1). ``vectors``
    forces the kind: "shared" the plans above (refused past them, as a
    forced R is), "device" the device-vector plan at any frame (``rows``,
    3 to M - 1, forces its R).

    Where even the device-vector plan's rows 0-2 and ring do not fit (a
    slab past 3,098 columns at f64 and 6,032 at f32: n past 408,936 and
    796,224 on 132 SMs), the plan keeps no row in shared memory
    (``vectors`` "wide", ``_wide_plan``): the same W and G, every row
    streamed in tiles of TR rows x GRID_WIDE_CHUNK columns; "wide" forces
    it at any frame (``rows`` must then be None).

    Raises ``GridPlanTooLarge`` where a shared-vector or device-vector
    plan is forced past its edge; ValueError for another type, a frame
    outside 2^24, a grid, an R or a kind out of range."""
    return plan_grid(M, N, dtype, sms, blocks, rows, _smem, "bounded_grid",
                     _smem_device, vectors, wide=True)


def plan_grid(M: int, N: int, dtype, sms: int, blocks: int | None,
              rows: int | None, smem, name: str, device_smem=None,
              vectors: str | None = None, wide: bool = False) -> GridPlan:
    """The plan of a grid walk (``bounded_grid_plan``'s rule) whose kernel
    counts a block's dynamic shared memory as ``smem(M, N, W, es, rows=M,
    stages=0, tile=0)`` does and, where it has a device-vector plan, as
    ``device_smem(W, es, rows, stages, tile, tile_rows)`` there (None: it
    has none, and ``vectors`` stays None or "shared"); ``wide``: the kernel
    has the wide plan too, taken where the device-vector plan refuses (or
    forced, ``vectors`` "wide"); ``name`` names the kernel in the
    refusals."""
    es = {torch.float32: 4, torch.float64: 8}.get(dtype)
    if es is None:
        raise ValueError(f"{name} takes float32 or float64, not {dtype}")
    if M < 3 or N < 2 or max(M, N) >= kb._MAX_SIDE:
        raise ValueError(f"frame {M} x {N} outside 3..2^24 x 2..2^24")
    if vectors not in (None, "shared", "device", "wide") or (
            vectors == "device" and device_smem is None) or (
            vectors == "wide" and not wide):
        raise ValueError(f"{name}: vectors={vectors!r}")
    if vectors == "wide" and rows is not None:
        raise ValueError(f"{name}: the wide plan keeps no row in shared "
                         f"memory, not rows={rows}")
    n = N - 1
    if blocks is None:
        W = min(n, max(-(-n // sms), -(-GRID_MIN_ENTRIES // M)))
        G = -(-n // W)
    else:
        if not 1 <= blocks <= min(sms, GRID_THREADS):
            raise ValueError(f"a grid of {blocks} blocks: expected 1 to "
                             f"{min(sms, GRID_THREADS)}")
        W, G = grid_slabs(n, blocks)
    if rows is not None and not 3 <= rows <= M:
        raise ValueError(f"rows={rows}: a slab keeps 3 to {M} rows in "
                         "shared memory")
    mail = _SLOT * (_REGIONS * G + 1)
    if vectors == "wide":
        return _wide_plan(M, W, G, es, mail)
    if vectors == "device":
        return _device_plan(M, W, G, es, rows, mail, name, device_smem)
    try:
        return _shared_plan(M, N, W, G, es, rows, mail, dtype, smem)
    except GridPlanTooLarge:
        # a forced split, or a kernel without the device-vector plan
        if vectors == "shared" or rows is not None or device_smem is None:
            raise
    try:
        return _device_plan(M, W, G, es, None, mail, name, device_smem)
    except GridPlanTooLarge:
        # a slab whose rows 0-2 and ring pass a block: the wide plan
        if not wide:
            raise
    return _wide_plan(M, W, G, es, mail)


def _shared_plan(M: int, N: int, W: int, G: int, es: int,
                 rows: int | None, mail: int, dtype, smem) -> GridPlan:
    """The resident or streamed plan, every block holding the per-row
    vectors (``plan_grid``'s W and G)."""
    full = smem(M, N, W, es)
    if rows is None or rows == M:
        if full <= GRID_SMEM_LIMIT:
            return GridPlan(G, W, GRID_THREADS, full, mail, M, 0, 0, 0)
        if rows == M:
            raise GridPlanTooLarge(
                f"frame {M} x {N} {dtype}: a resident block of {W} columns "
                f"needs {full} bytes of shared memory, above "
                f"{GRID_SMEM_LIMIT}")
    S = GRID_RING_STAGES
    tr = _tile_rows(W, es, GRID_THREADS)
    # the most rows the bytes left beside the ring and the vectors hold
    free = GRID_SMEM_LIMIT - smem(M, N, W, es, 0, S, _align(tr * W * es))
    R = min(M - 1, max(free, 0) // (W * es))
    while R > 0 and _align(R * W * es) > free:
        R -= 1
    if R < 3 or (rows is not None and rows > R):
        raise GridPlanTooLarge(
            f"frame {M} x {N} {dtype}: a block of {W} columns keeps "
            f"{R} of its rows in {GRID_SMEM_LIMIT} bytes of shared memory "
            f"beside a ring of {S} tiles of {tr} rows"
            + ("" if rows is None else f", not rows={rows}")
            + " (at least 3)")
    if rows is not None:
        R = rows
    # no tile taller than the streamed rows need
    tr = _tile_rows(W, es, M - R)
    tile = _align(tr * W * es)
    scratch = G * -(-(M - R) // tr) * tile
    return GridPlan(G, W, GRID_THREADS, smem(M, N, W, es, R, S, tile),
                    mail, R, S, tr, scratch)


def _device_plan(M: int, W: int, G: int, es: int, rows: int | None,
                 mail: int, name: str, device_smem) -> GridPlan:
    """The device-vector plan (``plan_grid``'s W and G): the ring of
    GRID_DEVICE_STAGES tiles and the block's segments take their bytes,
    and R, the most rows the rest holds (at most M - 1; ``rows`` forces
    it), stay in shared memory; rows [R, M) stream as on the streamed
    plan."""
    if rows == M:
        raise ValueError(f"rows={rows}: the device-vector plan streams at "
                         f"least one row (3 to {M - 1})")
    S = GRID_DEVICE_STAGES
    tr = _tile_rows(W, es, GRID_THREADS)
    free = GRID_SMEM_LIMIT - device_smem(W, es, 0, S, _align(tr * W * es),
                                         tr)
    R = min(M - 1, max(free, 0) // (W * es))
    while R > 0 and _align(R * W * es) > free:
        R -= 1
    if R < 3 or (rows is not None and rows > R):
        raise GridPlanTooLarge(
            f"{name}: a block of {W} columns keeps {R} of its rows in "
            f"{GRID_SMEM_LIMIT} bytes of shared memory beside a ring of "
            f"{S} tiles of {tr} rows, the vectors in device memory"
            + ("" if rows is None else f", not rows={rows}")
            + " (at least 3)")
    if rows is not None:
        R = rows
    tr = _tile_rows(W, es, M - R)
    tile = _align(tr * W * es)
    scratch = G * -(-(M - R) // tr) * tile
    return GridPlan(G, W, GRID_THREADS, device_smem(W, es, R, S, tile, tr),
                    mail, R, S, tr, scratch, "device")


def _wide_plan(M: int, W: int, G: int, es: int, mail: int) -> GridPlan:
    """The wide plan (``plan_grid``'s W and G): no row of a slab in shared
    memory; the slab in chunks of GRID_WIDE_CHUNK columns, each an M-row
    matrix in the scratch buffer (G regions of M x ceil(W / WC) WC
    entries), streamed in tiles of TR rows (the largest power of two of at
    most M rows whose tile takes at most GRID_WIDE_TILE_BYTES) through a
    ring of GRID_WIDE_SLOTS tiles."""
    WC = GRID_WIDE_CHUNK
    tr = 1
    while 2 * tr <= M and 2 * tr * WC * es <= GRID_WIDE_TILE_BYTES:
        tr *= 2
    S, tile = GRID_WIDE_SLOTS, tr * WC * es
    scratch = G * M * -(-W // WC) * WC * es
    return GridPlan(G, W, GRID_THREADS, _smem_wide(es, S, tile, tr), mail,
                    0, S, tr, scratch, "wide", WC)


def grid_stages(plan: GridPlan) -> tuple[str, ...]:
    """The names of ``stage_cycles``' counters on ``plan``: the last is
    the owner's clock."""
    return {"device": GRID_DEVICE_VECTOR_STAGES,
            "wide": GRID_WIDE_STAGES}.get(plan.vectors, GRID_STAGES)


def _plan_ints(plan: GridPlan, M: int, N: int, dtype, devex: bool):
    es = 4 if dtype == torch.float32 else 8
    tile = plan.tile_rows * plan.chunk * es if plan.vectors == "wide" \
        else _align(plan.tile_rows * plan.width * es)
    return _INTS(M, N, 0, 0, int(devex), plan.blocks, plan.width,
                 plan.threads, plan.smem, plan.mail, plan.rows, plan.stages,
                 plan.tile_rows, tile,
                 ("shared", "device", "wide").index(plan.vectors))


@functools.lru_cache(maxsize=64)
def _occupancy(index: int, plan: GridPlan, M: int, N: int, dtype,
               devex: bool) -> int:
    lib = lib_for(torch.device("cuda", index))
    out = ctypes.c_int(0)
    fn = getattr(lib, f"tpulp_bounded_grid_occupancy_{suffix(dtype)}")
    raise_on(lib, fn(_plan_ints(plan, M, N, dtype, devex),
                     ctypes.byref(out)),
             "bounded_grid occupancy")
    return out.value


def bounded_grid_occupancy(M: int, N: int, dtype, devex: bool = True,
                           device: torch.device | None = None,
                           blocks: int | None = None) -> int:
    """``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` of the walk's
    launch on an (M, N) frame (the plan on ``device``'s SMs): the blocks an
    SM holds at once (asked once a plan and device)."""
    device = torch.device("cuda", 0) if device is None else device
    plan = bounded_grid_plan(M, N, dtype, sm_count(device), blocks=blocks)
    return _occupancy(device.index or 0, plan, M, N, dtype, devex)


def _check(bs, opts: SolverOptions) -> None:
    """Raise on a state the kernel does not take: a dtype other than f32 /
    f64, a strided tableau, devex without weights, a field of the wrong
    type or length, a tensor off the card or on another card."""
    s = bs.s
    T = s.T
    suffix(T.dtype)
    if T.dim() != 2 or not T.is_contiguous():
        raise ValueError(f"T: expected a contiguous (m + 2, n + 1) tableau, "
                         f"got {tuple(T.shape)} stride {T.stride()}")
    M, N = T.shape
    if M < 3 or N < 2 or max(M, N) >= kb._MAX_SIDE:
        raise ValueError(f"tableau {M} x {N} outside 3..2^24 x 2..2^24")
    if opts.rule == RULE_DEVEX and bs.gamma is None:
        raise ValueError("devex pricing needs the state's gamma")
    m, n = M - 2, N - 1
    for name, x, dt, size in (
            ("basis", s.basis, torch.int32, m),
            ("col_active", s.col_active, torch.bool, n),
            ("art_cols", s.art_cols, torch.bool, n),
            ("at_upper", bs.at_upper, torch.bool, n),
            ("upper", bs.upper, T.dtype, n),
            ("gamma", bs.gamma, T.dtype, n)):
        if x is not None and (x.dtype != dt or tuple(x.shape) != (size,)):
            raise ValueError(f"{name}: expected {dt} ({size},), got "
                             f"{x.dtype} {tuple(x.shape)}")
    tensors = [*s, bs.upper, bs.at_upper]
    if bs.gamma is not None:
        tensors.append(bs.gamma)
    if T.device.type != "cuda" or any(x.device != T.device
                                      for x in tensors):
        raise ValueError("the bounded kernel takes a state on one CUDA "
                         "device; got "
                         f"{sorted({str(x.device) for x in tensors})}")


def bounded_grid(bs, opts: SolverOptions, stall_limit: int, max_iters: int,
                 blocks: int | None = None,
                 stage_cycles: torch.Tensor | None = None,
                 rows: int | None = None, vectors: str | None = None):
    """The bounded walk of ``bs`` (a ``solve.bounded.BoundedState`` on one
    CUDA device) to its exit or to ``max_iters`` in one cooperative launch;
    a RUNNING exit at the budget stays RUNNING. ``blocks`` forces another
    grid, ``rows`` another split of the slabs' rows and ``vectors`` the
    plan's kind (``bounded_grid_plan``'s by default; a streamed plan
    allocates its scratch buffer here, the device-vector and wide plans
    their RHS and spans too). ``stage_cycles``, an int64
    tensor of ``len(GRID_STAGES)`` on the card, accumulates block 0's SM
    cycles by stage (``grid_stages(plan)`` names them; a measurement, the
    kernel walks the same). Returns the
    walk's state; the caller's tensors are never written."""
    _check(bs, opts)
    s = bs.s
    T = s.T
    M, N = T.shape
    m, n = M - 2, N - 1
    dtype, dev = T.dtype, T.device
    if stage_cycles is not None:
        check(stage_cycles, "stage_cycles", torch.int64, (len(GRID_STAGES),))
        if stage_cycles.device != dev:
            raise ValueError(f"stage_cycles: expected a tensor on {dev}")
    devex = opts.rule == RULE_DEVEX
    plan = bounded_grid_plan(M, N, dtype, sm_count(dev), blocks=blocks,
                             rows=rows, vectors=vectors)
    # one allocation for the int32 fields, one for the bool ones
    ints = torch.empty((_NOUT + m,), dtype=torch.int32, device=dev)
    bools = torch.empty((1 + 3 * n,), dtype=torch.bool, device=dev)
    out = SimplexState(
        T=torch.empty((M, N), dtype=dtype, device=dev), basis=ints[_NOUT:],
        col_active=bools[1:1 + n], art_cols=bools[1 + n:1 + 2 * n],
        phase=ints[0], status=ints[1], niter=ints[2], stuck=ints[3],
        bland=bools[0], last_z=torch.empty((), dtype=dtype, device=dev))
    at_upper = bools[1 + 2 * n:]
    g_in = bs.gamma.contiguous() if devex else None
    g_out = torch.empty_like(g_in) if devex else None
    mail = torch.empty((plan.mail,), dtype=torch.uint8, device=dev)
    # the mailbox's columns; the device-vector and wide plans' two copies
    # of the RHS and of the spans after them, and of the basis apart
    dvec = plan.vectors in ("device", "wide")
    cols = torch.empty(((3 * M + 2 * M + 2 * m) if dvec else 3 * M,),
                       dtype=dtype, device=dev)
    bvec = torch.empty((2 * m,), dtype=torch.int32, device=dev) \
        if dvec else None
    bar = torch.zeros((1,), dtype=torch.int32, device=dev)
    scratch = torch.empty((plan.scratch,), dtype=torch.uint8, device=dev) \
        if plan.scratch else None
    ins = [x.contiguous() for x in s]
    ptrs = (ins[0], out.T, ins[1], out.basis, ins[2], out.col_active, ins[3],
            out.art_cols, bs.upper.contiguous(), bs.at_upper.contiguous(),
            at_upper, g_in, g_out, *ins[4:], ints, out.bland, out.last_z,
            mail, cols, bar, stage_cycles, scratch, bvec)
    args = _ARGS(*(0 if x is None else x.data_ptr() for x in ptrs))
    iargs = _plan_ints(plan, M, N, dtype, devex)
    iargs[2] = min(int(stall_limit), _INT_MAX)
    iargs[3] = min(int(max_iters), _INT_MAX)
    tols = _TOLS(opts.opt_tol, opts.piv_tol, opts.degen_tol,
                 opts.infeas_tol, kb.DEVEX_RESET_ABOVE)
    lib = lib_for(dev)
    fn = getattr(lib, f"tpulp_bounded_grid_{suffix(dtype)}")
    err = fn(args, iargs, tols, stream_of(dev))
    if err:
        raise_on(lib, err, "bounded_grid")
    LAUNCHES["bounded_grid"] += 1
    enter, uphit = ints[4:6].tolist()
    kb.FLIPS["entering_flips"] += enter
    kb.FLIPS["upper_hits"] += uphit
    return bs._replace(s=out, at_upper=at_upper,
                       gamma=g_out if devex else bs.gamma)


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def _grid_price(rec: kb.BoundedRecord, opts: SolverOptions, max_iters: int,
                W: int, G: int) -> None:
    """The plain price stage with the |c| sum's finiteness in the kernel's
    order (``grid_sum``). The kernel combines the slabs' candidates (each
    slab's NaN-first argmin of c_eff, or devex's argmax of c^2 / gamma,
    first index on ties) in slab order: that is the first-index argmin
    (argmax) over all columns, so the plain stage's entering column is the
    kernel's."""
    kb.bounded_price_reference(rec, opts, max_iters)
    iv = rec.ints.tolist()
    if not kb._live(iv, max_iters):
        return
    crow = rec.T[1, :-1] if iv[kb.PHASE] == 1 else rec.T[0, :-1]
    absc = torch.where(rec.col_active, crow.abs(), 0.0)
    rec.ints[kb.CROW_OK] = int(bool(torch.isfinite(grid_sum(absc, W, G))))


def bounded_grid_reference(bs, opts: SolverOptions, stall_limit: int,
                           max_iters: int, blocks: int = 1,
                           vectors: str = "shared"):
    """``bounded_grid``'s walk in plain torch on ``blocks`` slabs
    (``grid_slabs``; any count >= 1): the plain price, ratio, update and
    finish stages of
    ``kernels.bounded`` (the update from the entering column and the flip's
    column, as the kernel's mailbox holds them), the finiteness sums in the
    kernel's order: ``vectors`` "device" and "wide" take the device-vector
    and wide plans' |b| sum (``grid_sum`` over G slabs of ceil(m / G)
    rows), "shared" the other plans' (one block's). Returns (state,
    {"entering_flips": e, "upper_hits": u}); the caller's tensors are never
    written."""
    if vectors not in ("shared", "device", "wide"):
        raise ValueError(f"bounded_grid_reference: vectors={vectors!r}")
    devex = opts.rule == RULE_DEVEX
    if devex and bs.gamma is None:
        raise ValueError("devex pricing needs the state's gamma")
    work = bs if devex else bs._replace(gamma=None)
    W, G = grid_slabs(bs.s.T.shape[1] - 1, blocks)
    m = bs.s.T.shape[0] - 2
    rec = kb.make_record(work)
    while kb._live(rec.ints.tolist(), max_iters):
        _grid_price(rec, opts, max_iters, W, G)
        kb.bounded_ratio_reference(rec, opts, max_iters)
        kb.bounded_update_reference(rec, max_iters)
        absb = rec.T[2:, -1].abs()
        rhs_ok = bool(torch.isfinite(
            grid_sum(absb, -(-m // G), G) if vectors != "shared"
            else block_sum(absb, GRID_THREADS)))
        kb.bounded_finish_reference(rec, opts, stall_limit, max_iters,
                                    rhs_ok=rhs_ok)
    out = kb.record_state(rec, work)
    counts = {"entering_flips": int(rec.ints[kb.N_ENTER]),
              "upper_hits": int(rec.ints[kb.N_UPHIT])}
    return out._replace(gamma=out.gamma if devex else bs.gamma), counts
