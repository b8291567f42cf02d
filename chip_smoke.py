#!/usr/bin/env python3
"""Smoke test of the PyTorch port (tpulp_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Builds the CUDA kernels from the twelve sources of
tpulp_torch/kernels/csrc (flush, inner block, FMA, the lane kernels, the
rank-1 step's five launches, the blocked engine's seven, the cluster
walks, the blocked engine's cluster launch,
the three grid walks and the sharded pivot's two kernels; and checks
in their machine code that the f64 flush runs on the FP64 tensor cores
and the f32 flush uses no TF32), prints nvcc's registers and spills,
holds the flush and the inner block against their plain PyTorch versions
at the shape the main path gives them (1538 x 3073, float64, K = 128) and
at the bench shape (m = n = 4096, K = 256, float32 and float64) -- the
inner block in both variants (eta slices resident in shared memory, or
streamed from L2), bit for bit against its plain version summing in the
kernel's order, walked to the end through cleanup, devex and Bland pivots,
with its per-stage split -- times one grid barrier of each kind, holds the
FMA kernel bit for bit against the CPU's addcmul (broadcast and vmapped),
holds the flush against its plain version on ragged shapes and on a case
built to probe every rule of its scan, solves the Wyndor LP and the whole
LP corpus exactly through ``tpulp_torch.solve_lp``, drives the main path
at a real size (a 1536 x 1536 LP through ``solve_lp(driver="auto")``,
which must take the kernel engine), checks that a caller's TF32 setting
does not reach the engines' products, and runs the kernel engine on the
bench instance.
Phase 5c drives the solo walks on their kernels: ``solve_lp(driver=
"auto")`` on phase 7c's 256 x 512 LP (one ``rank1_cluster`` launch a walk,
no ``rank1_step`` and no FMA launch) and on two artificial LPs that auto
prices with devex (one unbounded, one optimal with no FMA launch), the
walks held in every field at f32 and f64 against their plain versions
(``rank1_cluster_reference`` on the cluster route; the plain loop on the
lane routes) and, on the cluster route, against ``rank1_steps``' walk on
the same frame, timed beside it in turns (Dantzig, devex past its
ray-scan and probe ticks, Bland, the greatest increase and largest-pivot
ties on a resident frame, where ``lane_primal`` runs the walk at B = 1, and
on the 258 x 769 frame), each of the rank-1 step's launches against its
plain stage (a clean-up, a phase change with its devex reset, both devex
ticks, a greatest-increase step, a dual pivot and a dual exit), the warm
re-solves (``lane_dual`` at B = 1 on a resident frame, the cluster's dual
walk on the 258 x 769 frame, ``rank1_grid``'s on phase 5's 1538 x 3073 one
and on a 514 x 1537 one), ``solve_lp(driver="rank1")`` on phase 5's LP
(one ``rank1_grid`` launch, streamed at f64) and the refreshed rung's
rank-1 segments; each grid walk is held whole against ``rank1_steps``' and
over a window against ``rank1_grid_reference`` at f32 and f64, with 210
small grid walks at forced splits; ``rank1_step`` runs alone past the
grid's plan (a 10002 x 10513 frame). It prints the cluster and grid plans,
their occupancy and stages, times the grid and the rank-1 step by launch
in turns and the plain step, and solves a bounded state whose tableau is
a strided view.
Phase 5d drives the solo rank-K blocked engine on its kernels (where a
cluster holds a block's eta factors, one ``blocked_cluster`` launch a
block of 64 slots, else ``blocked_step``'s six launches a slot; B1's flush
and one ray launch a block): ``solve_lp(driver="auto")`` on a 512 x 1024
LP (514 x 1537 on the cluster route: one ``blocked_cluster`` launch a
block and no ``blocked_step``, certified, the eager engine's objective
exactly, no FMA and no B2 launch), devex on an
artificial LP at 512 rows (optimal and certified, with the eager engine's
objective) and on its variant with four dependent rows (its status
recorded beside the eager engine's and those of other walks; within 1e-9
of the eager engine's at f64), the refreshed rung's blocked segments, each
cluster walk held in every field at f32 and f64 against
``blocked_cluster_reference`` and ``blocked_steps``' walk (timed in turns,
with its plan, ``cudaOccupancyMaxActiveClusters`` and its stages on block
0's clock), and ``blocked_steps``' walk against its plain-stage walk, each
flushed by the same B1; the cluster's edge walks (a budget stop inside a
block, a slot past the budget that ends the walk, the clean-up, retire and
ray-gate LP, the 1e8 reset) at every cluster size; a wide LP past the
cluster's plan (258 x 14,257) on ``blocked_step``; each of the seven
launches against its plain stage (a
Dantzig pivot, a budget stop inside a block, Bland, a largest-pivot tie, a
clean-up pivot, a retire, the phase change with devex's reset, the 1e8
reset, the ray launch with and without an artificial basic); it times a
slot by launch (and the cluster's by stage), B1 at the blocked shapes
beside ``addmm``, and the rank-1 walk, the blocked engine on its route and
on ``blocked_step``, and the kernel engine at four sizes around the `auto`
thresholds.
Phase 7 drives ``solve_milp`` on bench.py's 28-item knapsack (f32 and f64,
the DP oracle exactly) and on a 5-constraint 40-item knapsack (equal f32
and f64 optima, checked in Fractions) with every wave tensor checked to be
on the card; the bench knapsack's waves run the lane kernels (no vmapped
step loop) and, timed beside them, the plain lane loops, which must give
the same tree (every ``BnbStats`` counter); the f64 bench knapsack must
explore tpulp's 789 nodes. Phase 7d holds both lane kernels bit for bit
against the plain lane loops at f32 and f64 (the bench knapsack's cold
wave and its warm frames with seeded RHS rewrites, a stall limit of 1, a
NaN lane and an overflowing |b| sum, 7c's scenarios cold in phase 1 under
Dantzig and under the greatest increase with largest-pivot ties, and 258 x
513 frames on the streamed path) and times them. Phase 7 then times a
batched pivot at B = 128 beside the lane kernels' us a step, and runs
``solve_lp_batch`` cold and warm over 64 RHS scenarios and
``solve_lp(warm_start=)`` at 256 x 512.
Phase 8 solves a 1024 x 2048 box LP with ``simple_bounds`` (the
bounded-variable simplex on ``bounded_grid``, one cooperative launch a walk
with the tableau's column slabs in the SMs' shared memory, no FMA launch,
certified, held against the row-lowered solve on the kernel engine; at f32
answered on the ladder's f64 retry), holds the grid walk on the f64 devex
walk's first 4,096 steps, the f32 walk's first 2,048 steps and a Dantzig
walk that switches to Bland against one plain loop in every field, and the
grid kernel against its plain version ``bounded_grid_reference`` on the
card; times the grid's steps on the card and on the host clock, with its
stage split; solves a 2048 x 2048 box LP past the resident slab in one
streamed ``bounded_grid`` launch (its rows past R through device memory;
certified; its f64 and f32 windows held to the plain walk and the plain
version; the launch timed by stage), holds the grid at forced splits and
forced plans on small frames, walks a 7000 x 64 box LP at f64 and a 12000
x 64 one at f32, past the streamed plan, on the grid's plan with the
per-row vectors in device memory (held to the plain walk, timed), walks
16 x 409,584 (f64, 4,096 steps) and 16 x 1,048,576 (f64 and f32) box LPs,
past the device-vector plan, on the wide plan (no row of a slab in shared
memory; one launch a walk, their first steps held to the plain walk and a
window that pivots to the plain version on the card, timed by stage),
times a frame both plans hold on each in turns, and runs the grid's
``cuda`` tests (tests/test_torch_bounded_grid_card.py) in a pytest process
of their own; then it
solves a batch of 256 box LPs with and without bound rows (the bounded
batch's walk one ``lane_bounded`` launch, timed apart from its per-lane
extraction) and holds ``lane_bounded`` bit for bit against the plain
lane loop at f64 and f32 (Dantzig, devex, a budget, the Bland switch, a
NaN lane, span-encoded nodes, streamed 258 x 513 lanes; timed on the
card), a blocked batch of 8 LPs of 512 x 1024 on ``blocked_cluster`` with a lane
axis (f64 and f32: every lane equal to its solo cluster walk bit for bit,
one cluster, B1 and ray launch a block, the eager batch timed beside it),
a small batch held to its plain version at every cluster size, a batch of
more lanes than the card holds clusters and a wide one past the plan, the
corpus's infeasible and unbounded cases with verified certificates,
Wyndor's ranging, ``find_iis`` with every oracle solve on the card, and
``python -m tpulp_torch solve`` in a subprocess. Phase 9 brings up a
one-process NCCL group and ``make_mesh(1)``, solves phase 5's LP through
``solve_lp(mesh=...)`` with the sharded blocked driver (which flushes each
rank's block with the flush kernel) and the sharded rank-1 driver (each
certified, the exact objective phase 5's; the rank-1 driver's pivot one
``shard_pivot`` launch a step, the rank-K driver's running vectors one
``shard_vectors`` launch a pivot, no FMA launch), holds the sharded bounded
driver's Dantzig walk on a 128 x 256 box LP to the solo walk (its pivot,
gate and flip one ``shard_pivot`` launch a step), holds both kernels bit
for bit against their plain versions on the walks' own steps (9b's block
at f64 and f32, the no-op pivot, 9c's pivots, upper hits, entering flips
and idle steps, 9a's vectors) and times them in turns with the plain
versions (the former path), times windows of the sharded rank-1 and
bounded walks under torch.profiler with each, runs the kernels' ``cuda``
tests (tests/test_torch_shard_pivot_card.py) in a pytest process, times the
sharded machinery against the solo blocked driver at P = 1, and holds the
flush against its plain version at the sharded block's shape (9d's solo
baseline is the eager blocked loop, ``run_simplex_blocked_reference``, with
the blocked kernels timed beside it). Phase 10
runs the batch half of multi-device solving over a one-process NCCL group,
on a ``(batch, cols)`` mesh of shape (1, 1) and a 1-D ``("batch",)``
mesh: ``solve_lp_batch(mesh=)`` over phase 7c's 64 scenarios (statuses,
pivots and exact objectives equal to the solo batch's), ``solve_milp(mesh=)``
on the bench knapsack (the DP oracle, every ``BnbStats`` counter equal to
phase 7's f64 solve; on the (1, 1) mesh every lane-sharded step one
``shard_pivot`` launch over its lanes, held to the plain version and
timed, no FMA launch in the pivots), the span-encoded knapsack (the DP oracle; one
``lane_bounded`` launch a wave, the waves' walks timed) and
``tpulp_torch.entry.dryrun_multichip(1)``; every operand layout of those
paths' FMA launches is held against the CPU's addcmul. Every phase that
fails raises. The line before the last is a JSON summary of the kernels
(each with its bound, its plain version's time and, where one exists, a
library call's); the last line is ``{"ok": true, "device":
{...}}``. Without CUDA the script exits non-zero and prints no result. It
imports nothing of jax or tpulp.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from fractions import Fraction

import numpy as np

BENCH_M = 4096
BENCH_N = 4096
BENCH_K = 256
MAIN_M = 1536
MAIN_N = 1536
# the kernel engine's block in solve_lp: max(block, 128) with block = 64
MAIN_K = 128
RUNS = 20  # timed runs of each kernel and of its plain version
# (M, N, K) of the flush cases: every tile edge ragged, down to one element,
# up to the main path's and the bench shape
FLUSH_SHAPES = [(2, 3, 1), (130, 257, 17), (67, 8193, 255),
                (1538, 3073, 128), (4098, 8193, 256)]
TF32_M = TF32_N = 512  # the bench instance of the TF32 check
ART_M, ART_N, ART_K = 192, 256, 32  # the walks from an artificial basis
BLAND_SHAPE = (96, 128)  # Bland's walk (1,088 pivots)
# phase 7, MILP: bench.py's knapsack (run_bench_milp), a multidimensional
# knapsack, a scenario batch and a warm re-solve
MILP_ITEMS = 28
MILP_BATCH = 128
MDK_ITEMS, MDK_ROWS, MDK_SEED = 40, 5, 1
SCEN_M, SCEN_N, SCEN_LANES = 64, 128, 64
WARM_M, WARM_N = 256, 512
PIVOT_STEPS = 64  # timed batched steps per measurement
BARRIER_PROBE_N = 2 * BENCH_K * 4  # barriers per probe launch (2K, x4)
# the card's peaks for the bounds (NVIDIA H100 SXM data sheet, dense): HBM
# bytes/s; FP32 outside the tensor cores; FP64 outside them (B2's eta sums
# and the FMA kernel at f64); FP64 on the tensor cores (the f64 flush's DMMA)
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
FP64_FLOP_S = 34e12
FP64_TC_FLOP_S = 67e12
# the f64 bench knapsack's tree: tpulp's and the port's on the CPU
KNAPSACK_F64_NODES = 789
# phase 8, the bounded and exact layer: the box LP at full size, the box
# batch, the blocked batch and the planted IIS
BND_M, BND_N = 1024, 2048
# the f32 solve of the same LP fails its certificate and answers on the
# ladder's f64 retry, which repeats the f64 walk (tpulp does the same,
# tools/box_rung.py): the one run on the card of the f32-to-f64 retry
BND_F32_RUNG = "device-float64"
# the box LP's pricing: Dantzig's walk takes ~82k host-bound steps here
# (~7 minutes a dtype on the card), devex far fewer
BND_PRICING = "devex"
BND_MAX_ITERS = 200_000
# the f32 walks 8a holds to the plain loop: the devex walk's first steps,
# and a Dantzig walk whose stall limit of 1 switches it to Bland; the step
# the kernels are timed from and the steps timed
BND_F32_WINDOW = 2048
# the f64 devex walk's window held to the plain loop (its whole walk,
# ~15,000 steps, took the plain loop 70-120 s)
BND_F64_WINDOW = 4096
BND_BLAND_STEPS = 1024
BND_TIMED_FROM = 2000
# the grid walk: the steps of one timed launch (from BND_TIMED_FROM), the
# steps held against its plain version on the card at full size, and the
# box LP past the resident slab (2050 x 4097: slabs of 32 columns, 525 KB
# at f64), whose walk streams the rows past a block's shared memory (461
# of 2,050 rows resident at f64, 1,117 at f32), held to the plain loop and
# the plain version over a window at f64 and f32
BND_GRID_TIMED_STEPS = 1024
BND_GRID_REF_WINDOW = 96
BND_WIDE_M, BND_WIDE_N, BND_WIDE_WINDOW = 2048, 2048, 192
# (x): a box LP past the streamed plan at f64 (7002 x 7065: the replicated
# vectors alone pass a block's shared memory), walked on the grid's
# device-vector plan to a budget and held to the plain loop; one grid
# launch of BND_PAST_GRID_TIMED steps timed from its eighth, twice; (y):
# the same recipe at f32 with BND_PAST32_M rows (12,002 x 12,065, past the
# f32 streamed plan)
BND_PAST_M, BND_PAST_N, BND_PAST_STEPS = 7000, 64, 64
BND_PAST_GRID_TIMED = 64
BND_PAST32_M = 12_000
# (z): a box LP whose slabs pass the device-vector plan at f64 (18 x
# 409,601: slabs of 3,104 columns on 132 SMs, past its 3,098), the wide
# plan's main path: walked to BND_WIDEST_STEPS steps in one launch, its
# first BND_PAST_STEPS held to the plain loop; (z64) and (z32): 18 x
# 1,048,593 at f64 and f32 (past the f32 device-vector plan's 6,032-column
# slabs too), walked to BND_PAST_STEPS steps and held; in each frame's
# first chunk of BND_WIDE_SCAN steps that mostly pivots, a window past
# its entering flips held to the plain version on the card and timed;
# (s): 18 x 400,001 f64, which both the device-vector and the wide plan
# hold, timed on each in turns
BND_WIDEST_M, BND_WIDEST_N = 16, 409_584
BND_WIDEST_STEPS = 4096
BND_Z64_N = 1_048_576
BND_SHARED_N = 399_984
BND_WIDE_SCAN = 512
BOX_M, BOX_N, BOX_LANES = 64, 128, 256
# the row-lowered batch that 8b holds the box batch to: its first lanes
# only (its exact refinement and certificate take ~0.6 s a lane on the
# host, ~150-200 s for all 256), so that the full-size f32 box LP of 8a,
# the card's one run of the ladder's f32-to-f64 retry, fits the time
BOX_ROW_LANES = 64
BLK_M, BLK_N, BLK_LANES, BLK_K = 512, 1024, 8, 64
# 8c (iii): a small batch held to its plain version on the card at every
# cluster size, in blocks of BLK_SMALL_K: BLK_SMALL_LANES LPs of
# BLK_SMALL_M x BLK_SMALL_N (66 x 193 tableaus), whole and to a budget
# inside a block, with one lane ended and one at its budget at the start
BLK_SMALL_M, BLK_SMALL_N, BLK_SMALL_LANES, BLK_SMALL_K = 64, 128, 6, 8
BLK_SMALL_BUDGET = 37
BLK_SMALL_SIZES = (1, 2, 4, 8)
# (iv): more lanes than the card holds clusters at once (130 x 385)
BLK_OCC_M, BLK_OCC_N, BLK_OCC_LANES = 128, 256, 24
# (v): lanes of 5d (g)'s wide LP, past the cluster's plan, cut to a budget
# of three blocks
BLK_WIDE_LANES, BLK_WIDE_BUDGET = 2, 3 * BLK_K
IIS_VARS, IIS_ROWS = 10, 24
# phase 9, the sharded path over a one-process NCCL group: solve_lp's
# shard_block; the box LP cut to a size Dantzig walks in seconds (PERF.md
# §6: 428 s at 1024 x 2048); the bench shape's budget for the machinery
# ratio
SHARD_K = 64
SHARD_BOX_M, SHARD_BOX_N = 128, 256
SHARD_BENCH_PIVOTS = 512
# 9b's shard_pivot launches held to the plain version: every SHARD_KEEP-th
# and the last; the sharded walks' windows timed under torch.profiler
SHARD_KEEP = 500
SHARD_WINDOW = 64
# 10a's and 10b's shard_pivot launches (every lane of a step in one) copied
# and held to the plain version: every SHARD_LANE_KEEP-th
SHARD_LANE_KEEP = 64


def bound(nbytes: float, flops: float, flop_s: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate for their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / flop_s
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def log(msg: str) -> None:
    print(msg, flush=True)


def bench_arrays(m: int, n: int, seed: int = 0):
    """bench.py's instance recipe (``bounded=True``): (c, A, b, hint)."""
    rng = np.random.default_rng(seed)
    D = rng.normal(size=(m, n))
    x0 = np.abs(rng.normal(size=n))
    b = np.abs(D @ x0) + np.abs(rng.normal(size=m))
    c = rng.normal(size=n)
    D[-1] = 1.0
    b[-1] = 2.0 * x0.sum()
    A = np.concatenate([D, np.eye(m)], axis=1)
    cfull = np.concatenate([c, np.zeros(m)])
    return cfull, A, b, list(range(n, n + m))


def cuda_time_ms(fn, runs: int, setup=None) -> float:
    """Median over ``runs`` of ``fn()`` timed with CUDA events; ``setup``
    runs before each timed call, outside the timed region."""
    import torch

    times = []
    for _ in range(runs):
        if setup is not None:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


# ---------------------------------------------------------------------------
# phase 3: the kernels against their plain versions
# ---------------------------------------------------------------------------

def check_flush(T0, U, V, ca, opt_tol, piv_tol, dtype_name, runs):
    """The flush kernel against its plain version: Tn within 1e-5 (f32) or
    1e-12 (f64) relative to |T| + |U|^T |V| (the size of the sum, which
    the two sum in different orders), and the kernel's scan bit for bit
    equal to the scan recomputed from its own Tn. Returns errors and
    times."""
    import torch

    from tpulp_torch.core.precision import full_precision
    from tpulp_torch.kernels import fused_flush, fused_flush_reference

    Tk, scan_k = fused_flush(T0.clone(), U, V, ca, opt_tol, piv_tol)
    Tr, _ = fused_flush_reference(T0.clone(), U, V, ca, opt_tol, piv_tol)
    torch.cuda.synchronize()
    mag = T0.abs() + U.abs().T @ V.abs()
    rtol = 1e-5 if dtype_name == "float32" else 1e-12
    err = (Tk - Tr).abs()
    worst = float((err / mag.clamp_min(1e-30)).max())
    max_abs = float(err.max())
    shape = f"{tuple(T0.shape)} K={U.shape[0]}"
    if not bool((err <= rtol * mag).all()):
        raise AssertionError(f"flush {dtype_name} {shape}: |Tn - ref| / "
                             f"(|T| + |U|^T|V|) = {worst:.3e} > {rtol:g}")
    if not torch.equal(scan_k, scan_of(Tk, ca, opt_tol, piv_tol)):
        raise AssertionError(f"flush {dtype_name} {shape}: scan differs "
                             "from the scan recomputed from the kernel's Tn")
    work = T0.clone()

    def reset():
        work.copy_(T0)

    ms = cuda_time_ms(lambda: fused_flush(work, U, V, ca, opt_tol, piv_tol),
                      runs, reset)
    plain_ms = cuda_time_ms(lambda: fused_flush_reference(
        work, U, V, ca, opt_tol, piv_tol), runs, reset)
    with full_precision():
        library_ms = cuda_time_ms(lambda: work.addmm_(U.T, V), runs, reset)
    (M, N), K = T0.shape, U.shape[0]
    size = T0.element_size()
    bound_ms, bound_by = bound(
        size * (2 * M * N + K * (M + N)) + 4 * N + 8 * N, 2 * K * M * N,
        FP32_FLOP_S if dtype_name == "float32" else FP64_TC_FLOP_S)
    gflop = 2 * M * N * K / 1e9
    log(f"# B1 fused_flush {dtype_name} {shape}: ok, max |err| "
        f"{max_abs:.3e}, max err/mag {worst:.3e} (rtol {rtol:g}); kernel "
        f"{ms:.3f} ms = {gflop / ms:.2f} TFLOP/s, plain {plain_ms:.3f} ms = "
        f"{gflop / plain_ms:.2f} TFLOP/s, torch.addmm {library_ms:.3f} ms; "
        f"bound {bound_ms:.4f} ms ({bound_by}) (median of {runs})")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "tflops": gflop / ms,
            "plain_tflops": gflop / plain_ms}


def scan_of(Tn, ca, opt_tol, piv_tol):
    """The flush's (2, N) scan, computed from a flushed tableau."""
    import torch

    return torch.stack([(ca > 0) & (Tn[0] < -opt_tol),
                        (Tn[2:] > piv_tol).any(dim=0)]).to(torch.int32)


def flush_inputs(M, N, K, seed):
    """T, U, V, ca of a flush case, from a numpy seed, in float64."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(M, N)), rng.normal(size=(K, M)) * 0.1,
            rng.normal(size=(K, N)) * 0.1,
            rng.integers(0, 2, size=N).astype(np.int32))


def scan_case(M=67, N=300, K=17, seed=5):
    """A flush case whose Tn is exact at f32 and f64 (small integers and
    binary fractions) and which probes every rule of the scan: row 0
    straddles -tol (below, at, just above), ca is 0 at some improving
    columns, rows 0 and 1 hold entries above tol that must not count,
    constraint entries sit at tol (not counted) and just above it, and the
    only positive constraint entry of some columns is in the last row, and
    of the last column in the first constraint row. Returns (T, U, V, ca,
    tol, the exact Tn, the exact scan)."""
    tol = 2.0 ** -10
    rng = np.random.default_rng(seed)
    U = rng.integers(-1, 2, size=(K, M)).astype(np.float64)
    U[:, :2] = 0.0  # rows 0 and 1 of the product are zero
    V = rng.integers(-1, 2, size=(K, N)).astype(np.float64)
    exact = np.arange(0, N - 1, 7)  # columns with a zero product
    V[:, exact] = 0.0
    P = U.T @ V  # exact: small integers
    Tn = np.full((M, N), -1.0)
    Tn[0] = np.resize([-tol - 2.0 ** -20, -tol, -tol + 2.0 ** -20, 0.5,
                       -3.0], N)
    Tn[1] = 5.0  # above tol, but row 1 is no constraint row
    Tn[M - 1, 1::5] = 1.0  # the only positive entry: the last row
    Tn[2, N - 1] = 1.0  # the last column's: the first constraint row
    Tn[5, exact[0::2]] = tol  # at tol: not counted
    Tn[7, exact[1::2]] = tol + 2.0 ** -20  # just above: counted
    T = Tn - P
    ca = rng.integers(0, 2, size=N).astype(np.int32)
    scan = np.stack([(ca > 0) & (Tn[0] < -tol),
                     (Tn[2:] > tol).any(axis=0)]).astype(np.int32)
    return T, U, V, ca, tol, Tn, scan


def phase_flush_cases(dev):
    """Phase 3b: the flush against its plain version at every shape of
    FLUSH_SHAPES and on the scan case, at f32 and f64; returns the errors
    and times per case."""
    import torch

    from tpulp_torch.kernels import fused_flush

    stats = {}
    for dt in (torch.float32, torch.float64):
        name = str(dt).replace("torch.", "")
        for M, N, K in FLUSH_SHAPES:
            T, U, V, ca = (torch.tensor(x, device=dev) for x in
                           flush_inputs(M, N, K, seed=M + N + K))
            stats[f"{name} {M}x{N} K={K}"] = check_flush(
                T.to(dt), U.to(dt), V.to(dt), ca, 1e-5, 1e-5, name,
                RUNS)
            del T, U, V
        T, U, V, ca, tol, Tn, scan = scan_case()
        args = [torch.tensor(x, device=dev).to(dt) for x in (T, U, V)]
        ca_t = torch.tensor(ca, device=dev)
        check_flush(*args, ca_t, tol, tol, name, 3)
        Tk, scan_k = fused_flush(args[0].clone(), args[1], args[2], ca_t,
                                 tol, tol)
        if not np.array_equal(Tk.double().cpu().numpy(), Tn):
            raise AssertionError(f"scan case {name}: Tn is not exact")
        if not np.array_equal(scan_k.cpu().numpy(), scan):
            raise AssertionError(f"scan case {name}: scan differs from the "
                                 "exact scan")
        log(f"# B1 scan case {name} {T.shape} K={U.shape[0]}: Tn exact, "
            f"scan equal to numpy's ({int(scan[0].sum())} improving, "
            f"{int(scan[1].sum())} blocked columns)")
        torch.cuda.empty_cache()
    return stats


def _rel(a, b) -> float:
    scale = max(float(b.abs().max()), 1.0)
    return float((a - b).abs().max()) / scale


def inner_block_bound(M, N, K, niter, dtype_name):
    """(bound_ms, bound_by) of one inner block that took ``niter`` pivots:
    bytes = T0's column and row per pivot, U and V written, the running
    vectors and masks read and written once; operations = the eta sums
    (pivot p: 2p(M + N) flops, in double at either dtype) over the FP64
    rate, plus ~10(M + N) a pivot at the data's rate."""
    size = 4 if dtype_name == "float32" else 8
    nbytes = (size * (niter * (M + N) + K * (M + N) + 2 * (3 * N + M))
              + 4 * 2 * (2 * N + 2 * (M - 2)))
    t_eta = niter * (niter - 1) * (M + N) / FP64_FLOP_S
    t_rest = 10 * niter * (M + N) / (FP32_FLOP_S if size == 4
                                      else FP64_FLOP_S)
    return bound(nbytes, (t_eta + t_rest) * FP64_FLOP_S, FP64_FLOP_S)


def check_inner_block(state, opts, dtype_name, runs, K):
    """Two blocks of K pivots of the kernel engine from the same state, run
    with the plain versions and with the kernels, the inner-block kernel in
    each variant (resident: eta slices in shared memory; streaming: read
    from L2). At f64: the same iscal, basis and art-basic mask, and U, V
    and the flushed T within 1e-10 relative; at f32: block 1's basis and
    niter. Returns errors, times (each variant, the plain version) and the
    bound of block 1."""
    import functools

    import torch

    from tpulp_torch.kernels import (blocked_inner_block,
                                     blocked_inner_block_reference,
                                     fused_flush_reference)
    from tpulp_torch.kernels.block import (INNER_BLOCK_STAGES,
                                           inner_block_plan)
    from tpulp_torch.solve.blocked_kernel import kernel_block, kernel_inputs

    M, N = state.T.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stall = opts.resolved_stall_limit(state.m, state.n)
    inputs = kernel_inputs(state)
    plain_side, plain = [x.clone() for x in inputs], []
    for blk in range(2):
        plain_side, etas = kernel_block(plain_side, opts, stall, K,
                                        inner=blocked_inner_block_reference,
                                        flush=fused_flush_reference)
        # the next block flushes T in place: keep a copy
        plain.append(([x.clone() for x in plain_side], etas))
    torch.cuda.synchronize()
    exact = blocked_inner_block_reference(*inputs, opts, stall, K,
                                          kernel_order=True)
    max_abs, out = 0.0, {"variants": {}}
    default = inner_block_plan(M, N, K, state.T.dtype, sms).variant
    for variant in ("resident", "streaming"):
        plan = inner_block_plan(M, N, K, state.T.dtype, sms, variant)
        inner = functools.partial(blocked_inner_block, variant=variant)
        got = inner(*inputs, opts, stall, K)
        if not all(torch.equal(x, y) for x, y in zip(got, exact)):
            raise AssertionError(
                f"B2 {variant} {dtype_name} {(M, N)} K={K}: block 1 not bit "
                "for bit the plain version summing in the kernel's order")
        log(f"# B2 {variant} {dtype_name} {(M, N)} K={K} block 1: every "
            "output bit for bit the plain version's in the kernel's order")
        side = [x.clone() for x in inputs]
        for blk in range(2):
            side, etas = kernel_block(side, opts, stall, K, inner=inner)
            torch.cuda.synchronize()
            p, p_etas = plain[blk]
            same_iscal = torch.equal(side[9], p[9])
            same_basis = torch.equal(side[6], p[6])
            same_ab = torch.equal(side[7], p[7])
            rels = {"U": _rel(etas[0], p_etas[0]),
                    "V": _rel(etas[1], p_etas[1]), "T": _rel(side[0], p[0])}
            max_abs = max(max_abs, *(float((a - b).abs().max()) for a, b in
                                     zip(etas, p_etas)))
            if blk == 0:
                niter = int(side[9][2]) - int(inputs[9][2])
            log(f"# B2 blocked_inner_block {variant} {dtype_name} "
                f"{(M, N)} K={K} block {blk + 1}: iscal "
                f"{side[9].tolist()} vs plain {p[9].tolist()}; basis "
                f"{'same' if same_basis else 'DIFFERENT'}, ab "
                f"{'same' if same_ab else 'DIFFERENT'}; rel err "
                + " ".join(f"{n} {v:.2e}" for n, v in rels.items()))
            if dtype_name == "float64":
                if not (same_iscal and same_basis and same_ab):
                    raise AssertionError(
                        f"B2 {variant} f64 block {blk + 1}: decisions "
                        "differ from the plain version")
                bad = {n: v for n, v in rels.items() if v > 1e-10}
                if bad:
                    raise AssertionError(
                        f"B2 {variant} f64 block {blk + 1}: values differ "
                        f"beyond 1e-10 relative: {bad}")
            elif blk == 0:
                if not (same_basis and int(side[9][2]) == int(p[9][2])):
                    raise AssertionError(
                        f"B2 {variant} f32 block 1: basis or niter differ "
                        "from the plain version")
            elif not (same_iscal and same_basis):
                log(f"# B2 {variant} float32 block 2: the walk diverged from "
                    "the plain version (recorded, not gated)")
        args = list(inputs) + [opts, stall, K]
        ms = cuda_time_ms(lambda: inner(*args), runs)
        out["variants"][variant] = {
            "ms": ms, "smem": plan.smem, "grid": plan.grid,
            "rows": plan.rows, "cols": plan.cols,
            "barriers_per_pivot": plan.barriers_per_pivot}
        log(f"# B2 {variant} {dtype_name} {(M, N)} K={K}: {ms:.3f} ms per "
            f"block = {1e3 * ms / max(niter, 1):.2f} us a pivot ({niter} "
            f"pivots; median of {runs}); grid {plan.grid}, {plan.rows} rows "
            f"and {plan.cols} columns a block, {plan.smem} bytes of dynamic "
            f"shared memory, {plan.barriers_per_pivot} grid barriers "
            f"(flag) per typical pivot"
            + (" [the plan's choice]" if variant == default else ""))
    args = list(inputs) + [opts, stall, K]
    # where a pivot's time goes: block 0's cycles per stage, as shares of
    # the measured time per block
    cyc = torch.zeros((len(INNER_BLOCK_STAGES),), dtype=torch.int64,
                      device=state.T.device)
    blocked_inner_block(*args, stage_cycles=cyc)
    share = (cyc.double() / cyc.sum().double()).tolist()
    us = 1e3 * out["variants"][default]["ms"] / max(niter, 1)
    out["stages_us"] = {name: us * f
                        for name, f in zip(INNER_BLOCK_STAGES, share)}
    log(f"# B2 {default} {dtype_name} {(M, N)} K={K}: us a pivot by stage "
        "(block 0's clock) " + ", ".join(
            f"{k} {v:.2f}" for k, v in out["stages_us"].items()))
    plain_ms = cuda_time_ms(lambda: blocked_inner_block_reference(*args),
                            max(3, runs // 4))
    bound_ms, bound_by = inner_block_bound(M, N, K, niter, dtype_name)
    log(f"# B2 {dtype_name} {(M, N)} K={K}: plain {plain_ms:.3f} ms per "
        f"block; bound {bound_ms:.4f} ms ({bound_by}) for its {niter} pivots")
    out.update({"max_abs_err": max_abs,
                "ms": out["variants"][default]["ms"], "variant": default,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None,
                "pivots": niter})
    return out


# ---------------------------------------------------------------------------
# phase 5: the main path at a real size
# ---------------------------------------------------------------------------

def main_path_arrays(m: int, n: int, seed: int = 0):
    """An integer-data LP with slack columns: D in [-3, 3]^(m x n), b =
    |D| x0 + U{1..4} with x0 in [1, 3], the last row all ones with b =
    2 sum(x0), c in [-5, 5], slack basis. Returns (c, A, b, hint)."""
    rng = np.random.default_rng(seed)
    D = rng.integers(-3, 4, size=(m, n))
    x0 = rng.integers(1, 4, size=n)
    b = np.abs(D) @ x0 + rng.integers(1, 5, size=m)
    D[-1] = 1
    b[-1] = 2 * int(x0.sum())
    c = rng.integers(-5, 6, size=n)
    A = np.concatenate([D, np.eye(m, dtype=D.dtype)], axis=1)
    return (np.concatenate([c, np.zeros(m, dtype=c.dtype)]), A, b,
            list(range(n, n + m)))


def main_path_form(m: int, n: int, seed: int = 0):
    """``main_path_arrays`` as a StandardForm."""
    return standard_form(*main_path_arrays(m, n, seed), n)


def standard_form(c, A, b, hint, n: int):
    """(c, A, b, hint) with n structural columns and a slack basis as a
    StandardForm, built directly (going through LinExpr at this size costs
    minutes of Python)."""
    from tpulp_torch import StandardForm

    m = len(b)
    names = [f"x{j}" for j in range(n)] + [f"s{i}" for i in range(m)]
    return StandardForm(
        c=c.tolist(),
        A=A.tolist(),
        b=b.tolist(),
        col_names=names,
        obj_const=Fraction(0),
        sense="min",
        basis_hint=hint,
        recover={f"x{j}": ([(j, Fraction(1))], Fraction(0))
                 for j in range(n)},
        n_struct=n,
        row_provenance=[("con", i, 1) for i in range(m)],
    )


def gate_terminal_basis(out, c, A, b, dtype_name, opt_tol):
    """bench.py's terminal-basis gates on the original f64 data:
    feasibility (min x_B >= -10 feas_tol scale), corner agreement
    (|corner - z64| <= max(32 eps niter, 1e-5) |z64|) and, when optimal, the
    f64 dual check (min reduced cost >= -10 opt_tol max(|c|, 1))."""
    from tpulp_torch import Status

    basis = out.basis.cpu().numpy().astype(np.int64)
    niter = int(out.niter)
    corner = float(-out.T[0, -1])
    B = A[:, basis]
    xb = np.linalg.solve(B, b)
    z64 = float(c[basis] @ xb)
    scale = max(float(np.abs(b).max()), 1.0)
    eps = {"float32": 1.19e-7, "float64": 2.22e-16}[dtype_name]
    feas_tol = {"float32": 1e-5, "float64": 1e-9}[dtype_name]
    feas_gate = 10 * feas_tol * scale
    corner_gate = max(32 * eps * max(niter, 1), 1e-5) * max(abs(z64), 1.0)
    res = {"min_xb": float(xb.min()), "feas_gate": feas_gate,
           "corner": corner, "z64": z64, "corner_gate": corner_gate}
    if not (xb >= -feas_gate).all():
        raise AssertionError(f"terminal basis infeasible on f64 data: {res}")
    if abs(corner - z64) > corner_gate:
        raise AssertionError(f"corner drifted from the f64 basis z: {res}")
    if int(out.status) == Status.OPTIMAL:
        y = np.linalg.solve(B.T, c[basis])
        s = c - A.T @ y
        nb = np.ones(A.shape[1], dtype=bool)
        nb[basis] = False
        res["min_rc"] = float(s[nb].min())
        res["rc_gate"] = -10 * opt_tol * max(float(np.abs(c).max()), 1.0)
        if res["min_rc"] < res["rc_gate"]:
            raise AssertionError(f"f64 dual check failed: {res}")
    return res


def artificial_arrays(m: int, n: int, seed: int = 1):
    """An equality LP that starts on artificials and keeps some of them
    basic into phase 2: D x = b with D's last four rows sums of earlier
    rows (redundant), a quarter of b zero (degenerate), no slack basis.
    Returns (c, A, b, hint)."""
    rng = np.random.default_rng(seed)
    D = rng.normal(size=(m, n))
    D[m - 4:] = D[0:4] + D[4:8]
    x0 = np.abs(rng.normal(size=n)) * (rng.random(n) < 0.5)
    b = D @ x0
    neg = b < 0
    D[neg] *= -1.0
    b[neg] *= -1.0
    return rng.normal(size=n), D, b, [-1] * m


def check_walk(case, state, opts, K, max_blocks=64):
    """The kernel engine block by block from ``state`` to termination, with
    the inner-block kernel in each variant and with its plain version
    summing in the kernel's order (both sides flush with the flush
    kernel): every output of every block bit for bit equal. Returns
    (blocks, final iscal)."""
    import functools

    import torch

    from tpulp_torch import Status
    from tpulp_torch.kernels import (blocked_inner_block,
                                     blocked_inner_block_reference)
    from tpulp_torch.solve.blocked_kernel import kernel_block, kernel_inputs

    stall = opts.resolved_stall_limit(state.m, state.n)
    plain = functools.partial(blocked_inner_block_reference,
                              kernel_order=True)
    for variant in ("resident", "streaming"):
        k = kernel_inputs(state)
        p = [x.clone() for x in k]
        inner = functools.partial(blocked_inner_block, variant=variant)
        for blk in range(max_blocks):
            k, _ = kernel_block(k, opts, stall, K, inner=inner)
            p, _ = kernel_block(p, opts, stall, K, inner=plain)
            same = all(torch.equal(x, y) for x, y in zip(k, p))
            if not same:
                raise AssertionError(
                    f"B2 {variant} walk {case}, block {blk + 1}: iscal "
                    f"{k[9].tolist()} vs plain {p[9].tolist()}, outputs not "
                    f"bit for bit equal (T rel err {_rel(k[0], p[0]):.2e})")
            if int(k[9][1]) != Status.RUNNING:
                break
        log(f"# B2 {variant} walk {case} {tuple(state.T.shape)} K={K}: "
            f"{blk + 1} blocks bit for bit the plain version's, final iscal "
            f"{k[9].tolist()} (phase, status, niter, stuck, bland, t), "
            f"{int(k[7].sum())} artificials still basic")
    return blk + 1, k[9].tolist()


def phase_kernels(dev):
    """Phase 3: both kernels against their plain versions at the shape the
    main path of phase 5 gives them (f64, K = 128) and at the bench shape
    (f32 and f64, K = 256); returns their errors and times per case."""
    import torch

    from tpulp_torch import SolverOptions, make_state
    from tpulp_torch.core import eta_scaled_options
    from tpulp_torch.kernels import blocked_inner_block
    from tpulp_torch.solve.blocked_kernel import kernel_inputs

    cases = {
        "main_path": (main_path_arrays(MAIN_M, MAIN_N), torch.float64,
                      MAIN_K),
        "bench_float32": (bench_arrays(BENCH_M, BENCH_N), torch.float32,
                          BENCH_K),
        "bench_float64": (bench_arrays(BENCH_M, BENCH_N), torch.float64,
                          BENCH_K),
    }
    stats = {}
    for case, ((c, A, b, hint), dt, K) in cases.items():
        name = str(dt).replace("torch.", "")
        state = make_state(c, A, b, hint, dtype=dt, device=dev)
        opts = eta_scaled_options(SolverOptions.for_dtype(dt), dt)
        inner = check_inner_block(state, opts, name, RUNS, K)
        # the flush's inputs: the eta factors of the kernel's first block
        ins = kernel_inputs(state)
        stall = opts.resolved_stall_limit(state.m, state.n)
        out = blocked_inner_block(*ins, opts, stall, K)
        flush = check_flush(ins[0], out[0], out[1], out[5], opts.opt_tol,
                            opts.piv_tol, name, RUNS)
        stats[case] = {"fused_flush": flush, "blocked_inner_block": inner}
        del state, ins, out
        torch.cuda.empty_cache()
    # the cleanup (B) and Bland (D) stages and devex weights, walked to the
    # end from an artificial basis
    from tpulp_torch.core.state import RULE_BLAND, RULE_DEVEX

    for rule, rname, (m, n) in ((RULE_DEVEX, "devex", (ART_M, ART_N)),
                                (RULE_BLAND, "bland", BLAND_SHAPE)):
        c, A, b, hint = artificial_arrays(m, n)
        state = make_state(c, A, b, hint, dtype=torch.float64, device=dev)
        opts = eta_scaled_options(SolverOptions.for_dtype(
            torch.float64, rule=rule), torch.float64)
        check_walk(f"artificial-{rname}", state, opts, ART_K)
    return stats


def phase_small_lps():
    """Phase 4: Wyndor and the whole corpus, exact, on the kernel engine."""
    import tpulp_torch
    from tpulp_torch import LinExpr, LinProg
    from tpulp_torch.corpus import CASES

    lp = LinProg()
    lp.addVar("x")
    lp.addVar("y")
    lp.maximize(LinExpr(40, "x", 30, "y"))
    lp.addConstraint(LinExpr(1, "x", 1, "y").constraintLeq(12))
    lp.addConstraint(LinExpr(2, "x", 1, "y").constraintLeq(16))
    sol = tpulp_torch.solve_lp(lp, device="cuda", driver="kernel")
    if not (sol.status == "optimal" and sol.objective == Fraction(400)):
        raise AssertionError(f"Wyndor: {sol.status} {sol.objective}")
    log(f"# Wyndor: optimal {sol.objective} (rung {sol.rung})")
    bad = []
    for case in CASES:
        t0 = time.perf_counter()
        sol = tpulp_torch.solve_lp(case.lp().lower(), device="cuda",
                                   driver="kernel", max_iters=case.max_iters)
        ok = sol.status == case.status and (
            case.status != "optimal" or sol.objective == case.objective)
        log(f"# corpus {case.name}: {sol.status} rung {sol.rung} niter "
            f"{sol.niter} {'exact' if ok else 'WRONG'} "
            f"({time.perf_counter() - t0:.2f} s)")
        if not ok:
            bad.append(case.name)
    if bad:
        raise AssertionError(f"corpus cases wrong: {bad}")
    log(f"# corpus: {len(CASES)}/{len(CASES)} exact")


def phase_main_path():
    """Phase 5: solve_lp(driver="auto") at 1536 x 1536 must take the kernel
    engine and certify optimal; returns the launch counts of that run and
    its timing."""
    import torch

    import tpulp_torch
    from tpulp_torch.kernels import LAUNCHES, reset_launches
    from tpulp_torch.solve.refine import float_basis_certificate

    sf = main_path_form(MAIN_M, MAIN_N)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    sol = tpulp_torch.solve_lp(sf, device="cuda", driver="auto")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    if not (launches["fused_flush"] > 0
            and launches["blocked_inner_block"] > 0):
        raise AssertionError(f"solve_lp(driver='auto') at {MAIN_M}x{MAIN_N} "
                             f"did not take the kernel engine: {launches}")
    if sol.status != "optimal":
        raise AssertionError(f"main path: status {sol.status}")
    primal_ok, dual_ok = float_basis_certificate(sf, sol.basis)
    if not (primal_ok and dual_ok):
        raise AssertionError("main path: float_basis_certificate failed")
    log(f"# main path solve_lp {MAIN_M}x{MAIN_M + MAIN_N} (auto -> kernel "
        f"engine, f64): optimal, rung {sol.rung}, objective "
        f"{sol.objective:.6f}, niter {sol.niter}, {secs:.2f} s, "
        f"{sol.niter / secs:.1f} pivots/s (lowering, set-up and refinement "
        f"included); launches {launches}")
    return launches, {"niter": sol.niter, "seconds": secs,
                      "pivots_per_s": sol.niter / secs,
                      "objective": str(sol.objective)}


def phase_tf32_guard():
    """Phase 5b: a caller's ``allow_tf32 = True`` must not reach the
    engines' products. solve_lp(f32, driver="blocked") on the bench
    instance at 512 x 512 gives the same status, niter and basis with the
    flag True as with it False, and leaves the flag True; switching it back
    to False then leaves torch's settings readable ("highest")."""
    import torch

    import tpulp_torch

    sf = standard_form(*bench_arrays(TF32_M, TF32_N), TF32_N)

    def solve():
        sol = tpulp_torch.solve_lp(sf, dtype=torch.float32, driver="blocked",
                                   device="cuda")
        torch.cuda.synchronize()
        return sol.status, sol.niter, sol.basis, sol.rung

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    ref = solve()
    secs = time.perf_counter() - t0
    torch.backends.cuda.matmul.allow_tf32 = True
    out = solve()
    still_on = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    # torch raises here if the engines left its settings disagreeing
    after = torch.get_float32_matmul_precision()
    same = out == ref
    log(f"# TF32 guard: solve_lp {TF32_M}x{TF32_M + TF32_N} f32 blocked with "
        f"allow_tf32 True: {out[0]}, niter {out[1]}, rung {out[3]}; with it "
        f"False: {ref[0]}, niter {ref[1]}, rung {ref[3]} ({secs:.2f} s); "
        f"status/niter/basis {'same' if same else 'DIFFERENT'}; flag "
        f"{'still True' if still_on else 'RESET'} after the call; set back "
        f"to False, torch reports matmul precision {after!r}")
    if not same:
        raise AssertionError("TF32 guard: the walk changed under "
                             "allow_tf32 = True")
    if not still_on:
        raise AssertionError("TF32 guard: solve_lp did not restore the "
                             "caller's allow_tf32 = True")
    if after != "highest":
        raise AssertionError(f"TF32 guard: matmul precision {after!r} after "
                             "allow_tf32 = False")
    return {"status": out[0], "niter": out[1], "rung": out[3]}


# ---------------------------------------------------------------------------
# phase 5c: the solo walks on their kernels
# ---------------------------------------------------------------------------

# (b): artificial_arrays(256, n) at the largest n whose frame, 258 x (n +
# 257), stays under solve_lp's rank-1 limit of 200k elements; the optimal
# devex LP: its 256 independent rows at n = 384 with c >= 0 (258 x 641)
SOLO_DEVEX_N = 518
SOLO_DEVEX_OPT_N = 384
# (e): the deeper warm re-solves halve the RHS of the first 1 / SOLO_CUT
# of the rows
SOLO_CUT = 4
# (c): a frame that lane_plan keeps resident in one block (42 x 121)
SOLO_RESIDENT_M, SOLO_RESIDENT_N = 40, 80
# the 5c solves on the frames a cluster holds, f64 and f32
SOLO_SOLVES = tuple(f"{case}_{dt}" for case in ("a", "b", "b_optimal", "e",
                                                "e_deep", "g")
                    for dt in ("float64", "float32"))
# the steps timed by launch (at most), after a few untimed ones
SOLO_TIMED_STEPS, SOLO_ADVANCE = 32, 8
# (c): Bland's walk on the 258 x 769 frame runs past 10,000 pivots; it is
# held over its first steps
SOLO_BLAND_WINDOW = 1024


def equality_form(c, A, b):
    """min c x, A x = b, x >= 0 with every row on an artificial, as a
    StandardForm."""
    from tpulp_torch import StandardForm

    m, n = A.shape
    return StandardForm(
        c=c.tolist(), A=A.tolist(), b=b.tolist(),
        col_names=[f"x{j}" for j in range(n)], obj_const=Fraction(0),
        sense="min", basis_hint=[-1] * m,
        recover={f"x{j}": ([(j, Fraction(1))], Fraction(0))
                 for j in range(n)},
        n_struct=n, row_provenance=[("con", i, 1) for i in range(m)])


def solo_plain(walk: str, state, opts):
    """The plain walk (the CPU path's loop, here on the card): (state,
    devex weights or None, seconds)."""
    from tpulp_torch.solve.devex import devex_simplex_step, make_devex_state
    from tpulp_torch.solve.driver import finish, run_chunked, simplex_step
    from tpulp_torch.solve.dual import dual_simplex_step

    stall = opts.resolved_stall_limit(state.m, state.n)
    sync(state.T.device)
    t0 = time.perf_counter()
    if walk == "devex":
        out = run_chunked(
            lambda c: devex_simplex_step(c, opts, stall, opts.max_iters),
            make_devex_state(state), lambda c: c.s, opts.max_iters)
        s, g = finish(out.s), out.gamma
    else:
        step = dual_simplex_step if walk == "dual" else simplex_step
        s, g = finish(run_chunked(
            lambda x: step(x, opts, stall, opts.max_iters), state,
            lambda x: x, opts.max_iters)), None
    sync(state.T.device)
    return s, g, time.perf_counter() - t0


def solo_kernel(walk: str, state, opts, route: str):
    """The kernels' walk through the solo drivers (``run_simplex``,
    ``run_dual_simplex``; devex through the route's wrapper,
    ``rank1_cluster``, ``rank1_grid`` or ``rank1_steps``, which
    ``run_simplex_devex`` calls, for its weights): (state, weights,
    seconds, launches)."""
    import torch

    from tpulp_torch.kernels import LAUNCHES, reset_launches
    from tpulp_torch.kernels import rank1_cluster as kc
    from tpulp_torch.kernels.rank1 import rank1_steps
    from tpulp_torch.kernels.rank1_grid import rank1_grid
    from tpulp_torch.solve import run_dual_simplex, run_simplex
    from tpulp_torch.solve.driver import finish

    sync(state.T.device)
    reset_launches()
    t0 = time.perf_counter()
    g = None
    if walk == "devex":
        stall = opts.resolved_stall_limit(state.m, state.n)
        run = {"rank1_cluster": kc.rank1_cluster,
               "rank1_grid": rank1_grid}.get(route, rank1_steps)
        s, g = run(state, opts, stall, opts.max_iters, torch.ones(
            (state.n,), dtype=state.T.dtype, device=state.T.device))
        s = finish(s)
    elif walk == "dual":
        s = run_dual_simplex(state, opts)
    else:
        s = run_simplex(state, opts)
    sync(state.T.device)
    return s, g, time.perf_counter() - t0, dict(LAUNCHES)


def cluster_plain(walk: str, state, opts):
    """``rank1_cluster_reference`` on the card, on the plan's cluster size:
    (state, devex weights or None, seconds)."""
    import torch

    from tpulp_torch.kernels import rank1_cluster as kc
    from tpulp_torch.solve.driver import finish

    stall = opts.resolved_stall_limit(state.m, state.n)
    gamma = torch.ones((state.n,), dtype=state.T.dtype,
                       device=state.T.device) if walk == "devex" else None
    C = kc.cluster_plan(*state.T.shape, state.T.dtype).blocks
    sync(state.T.device)
    t0 = time.perf_counter()
    s, g = kc.rank1_cluster_reference(state, opts, stall, opts.max_iters,
                                      gamma, walk == "dual", C)
    s = finish(s)
    sync(state.T.device)
    return s, g, time.perf_counter() - t0


def weights_equal(gk, gp, label: str) -> None:
    import torch

    if (gk is None) != (gp is None) or (
            gk is not None and not torch.equal(gk.cpu() + 0.0,
                                               gp.cpu() + 0.0)):
        raise AssertionError(f"5c {label}: the devex weights differ")


def solo_walk_check(walk: str, state, opts, label: str, route: str):
    """One solo walk on its kernels and as its plain version (the plain
    loop; on the cluster route ``rank1_cluster_reference``), held equal in
    every field (``T + 0.0``, the basis, the masks, every scalar, the
    devex weights); the launches must be the route's alone (one launch a
    walk on a lane or cluster route) and no FMA. On the cluster route the
    walk is also held equal to ``rank1_steps``' and timed beside it
    (``cluster_vs_step``). Returns the numbers."""
    import torch

    k, gk, secs, launches = solo_kernel(walk, state, opts, route)
    plain = cluster_plain if route == "rank1_cluster" else solo_plain
    p, gp, plain_secs = plain(walk, state, opts)
    err = lanes_equal(k, p)
    weights_equal(gk, gp, label)
    others = {key: v for key, v in launches.items() if key != route and v}
    want = 1 if route.startswith("lane_") or route == "rank1_cluster" \
        else None
    if others or not launches[route] or (want and launches[route] != want):
        raise AssertionError(f"5c {label}: launches {launches}, want "
                             f"{route} alone")
    niter = int(k.niter) - int(state.niter)
    M, N = state.T.shape
    flop_s = FP64_FLOP_S if state.T.dtype == torch.float64 else FP32_FLOP_S
    # the walk: the frame read and written once, one fma an entry a pivot
    bound_ms, bound_by = bound(2.0 * M * N * state.T.element_size(),
                               2.0 * M * N * niter, flop_s)
    res = {"status": int(k.status), "niter": niter, "bland": bool(k.bland),
           "seconds": secs, "plain_seconds": plain_secs,
           "max_abs_err": err, "launches": launches[route], "route": route,
           "ms_per_step": 1e3 * secs / max(niter, 1),
           "plain_ms_per_step": 1e3 * plain_secs / max(niter, 1),
           "bound_ms": bound_ms, "bound_by": bound_by}
    if route.startswith("lane_") and state.T.device.type == "cuda":
        # one launch a walk (no host read): its time on the card alone
        from tpulp_torch.solve import run_dual_simplex, run_simplex

        run = run_dual_simplex if walk == "dual" else run_simplex
        res["device_ms"] = device_time_ms(lambda: run(state, opts), 5)
        res["device_us_per_step"] = 1e3 * res["device_ms"] / max(niter, 1)
    log(f"# 5c {label} {tuple(state.T.shape)} {str(state.T.dtype)[6:]}: "
        f"{route} x {launches[route]}, the walk equals "
        + ("rank1_cluster_reference" if route == "rank1_cluster"
           else "the plain walk")
        + f" in every field (status {res['status']}, {niter} pivots, bland "
        f"{res['bland']}); {1e3 * secs:.2f} ms = "
        f"{1e3 * res['ms_per_step']:.1f} us a pivot on the host clock"
        + (f" ({res['device_us_per_step']:.2f} on the card)"
           if "device_ms" in res else "")
        + f", the plain walk {res['plain_ms_per_step']:.3f} ms a pivot")
    if route == "rank1_cluster":
        res.update(cluster_vs_step(walk, state, opts, k, gk, label, res))
    return res


def cluster_vs_step(walk: str, state, opts, k, gk, label: str, res: dict):
    """The cluster kernel's walk beside ``rank1_step``'s on the same frame:
    ``rank1_steps``' walk held equal to the cluster's in every field; both
    timed on the host clock in turns (cluster, step, step, cluster, twice);
    the cluster's launch on the card alone (CUDA events after a sleep), its
    load and store alone (a launch with no step), its stages (block 0's
    clock, as shares of the launch), its plan and
    ``cudaOccupancyMaxActiveClusters``; ``rank1_step``'s launches a walk."""
    import torch

    from tpulp_torch.kernels import LAUNCHES, reset_launches
    from tpulp_torch.kernels import rank1_cluster as kc
    from tpulp_torch.kernels.rank1 import rank1_steps
    from tpulp_torch.solve.driver import finish

    dev = state.T.device
    stall = opts.resolved_stall_limit(state.m, state.n)
    gamma = torch.ones((state.n,), dtype=state.T.dtype, device=dev) \
        if walk == "devex" else None
    dual = walk == "dual"
    M, N = state.T.shape
    plan = kc.cluster_plan(M, N, state.T.dtype)
    occ = kc.cluster_occupancy(M, N, state.T.dtype,
                               "primal" if walk == "primal" else walk, dev)
    runs = {"cluster": lambda: kc.rank1_cluster(
                state, opts, stall, opts.max_iters, gamma, dual),
            "step": lambda: rank1_steps(state, opts, stall, opts.max_iters,
                                        gamma, dual)}
    reset_launches()
    s, g = runs["step"]()
    sync(dev)
    step_launches = LAUNCHES["rank1_step"]
    err = lanes_equal(k, finish(s))
    weights_equal(gk, g, f"{label} against rank1_step")
    host = {"cluster": [], "step": []}
    for name in ("cluster", "step", "step", "cluster") * 2:
        sync(dev)
        t0 = time.perf_counter()
        runs[name]()
        sync(dev)
        host[name].append(time.perf_counter() - t0)
    niter = max(res["niter"], 1)
    dev_ms = device_time_ms(runs["cluster"], 5)
    # a budget already spent: the launch loads and stores the frame only
    # (read on the host here, not inside the timed call)
    spent = int(state.niter)
    ls_ms = device_time_ms(lambda: kc.rank1_cluster(
        state, opts, stall, spent, gamma, dual), 5)
    cyc = torch.zeros((len(kc.CLUSTER_STAGES),), dtype=torch.int64,
                      device=dev)
    kc.rank1_cluster(state, opts, stall, opts.max_iters, gamma, dual,
                     stage_cycles=cyc)
    share = (cyc.double() / cyc.sum().double().clamp_min(1)).tolist()
    stage_us = {name: 1e3 * dev_ms * f / niter
                for name, f in zip(kc.CLUSTER_STAGES, share)
                if name not in ("load", "store")}
    cl_us = 1e6 * float(np.median(host["cluster"])) / niter
    st_us = 1e6 * float(np.median(host["step"])) / niter
    log(f"# 5c {label} {M}x{N} {str(state.T.dtype)[6:]}: rank1_cluster on "
        f"{plan.blocks} blocks of {plan.width} columns ({plan.smem} bytes "
        f"of shared memory a block; cudaOccupancyMaxActiveClusters {occ}): "
        f"{cl_us:.2f} us a pivot on the host clock, "
        f"{1e3 * dev_ms / niter:.2f} on the card (1 launch; the load and "
        f"store {1e3 * ls_ms:.1f} us a walk; "
        + ", ".join(f"{k} {v:.2f}" for k, v in stage_us.items())
        + f"); rank1_step's walk equal in every field, {st_us:.2f} us a "
        f"pivot on the host clock ({step_launches} steps), in turns")
    # the table's convention for a step: the tableau read and written once
    # from device memory
    step_bound_ms, _ = bound(2.0 * M * N * state.T.element_size(), 0.0,
                             FP64_FLOP_S)
    return {"blocks": plan.blocks, "width": plan.width, "smem": plan.smem,
            "occupancy": occ, "host_us_per_step": cl_us,
            "step_bound_ms": step_bound_ms,
            "device_ms": dev_ms,
            "device_us_per_step": 1e3 * dev_ms / niter,
            "load_store_ms": ls_ms, "device_us_by_stage": stage_us,
            "rank1_step": {"max_abs_err": err, "ms_per_step": st_us / 1e3,
                           "plain_ms_per_step": res["plain_ms_per_step"],
                           "steps": step_launches,
                           "niter": res["niter"]}}


def rank1_step_us(state, opts, gamma, label: str, niter: int,
                  dual: bool = False):
    """A kernel step of a walk of ``niter`` pivots (the dual walk with
    ``dual``), up to ``SOLO_ADVANCE`` steps in: the device us a step of
    ``steps`` steps enqueued by one C call
    (``launches_us``), the host's us to enqueue one, the device us of the
    scan, price and ratio launches alone (``steps`` launches of each on the
    same record: they write only the partials, the verdict and the
    snapshot) beside the rest (update and finish), and the bound; three
    rounds, medians. The walk must run through every timed step."""
    import torch

    from tpulp_torch.kernels import rank1 as kr

    advance = min(SOLO_ADVANCE, niter // 4)
    steps = max(1, min(SOLO_TIMED_STEPS, (niter - advance) // 4))
    stall = opts.resolved_stall_limit(state.m, state.n)
    rec = kr.make_record(state, opts, gamma, dual)
    kr.enqueue_steps(rec, opts, stall, opts.max_iters, advance)
    stages = (("scan",) if rec.scan is not None else ()) + ("price",
                                                             "ratio")
    dev_us, host_us, split = [], [], {stage: [] for stage in stages}
    for _ in range(3):
        for stage in stages:
            split[stage].append(launches_us(lambda: [
                kr.rank1_stage(rec, stage, opts, stall, opts.max_iters)
                for _ in range(steps)], steps)[0])
        d, h = launches_us(lambda: kr.enqueue_steps(rec, opts, stall,
                                                    opts.max_iters, steps),
                           steps)
        if int(rec.ints[kr.STATUS]) != 0:
            raise AssertionError("5c: the timed steps ran past the walk")
        dev_us.append(d)
        host_us.append(h)
    split = {k: float(np.median(v)) for k, v in split.items()}
    dev_us, host_us = float(np.median(dev_us)), float(np.median(host_us))
    split["update_and_finish"] = dev_us - sum(split.values())
    M, N = state.T.shape
    flop_s = FP64_FLOP_S if state.T.dtype == torch.float64 else FP32_FLOP_S
    # the update: the tableau read and written once, one fma an entry
    bound_ms, bound_by = bound(2.0 * M * N * state.T.element_size(),
                               2.0 * M * N, flop_s)
    log(f"# 5c rank1_step {label} {M}x{N} {str(state.T.dtype)[6:]}: "
        f"{dev_us:.2f} us a step on the card (CUDA events over "
        f"{steps} steps from step {advance}; "
        + ", ".join(f"{k} {v:.2f}" for k, v in split.items())
        + f"), {host_us:.2f} us of host time to enqueue one; bound "
        f"{1e3 * bound_ms:.3f} us (the tableau read and written once at "
        "3.35 TB/s)")
    return {"device_us_per_step": dev_us, "host_us_per_step": host_us,
            "bound_us_per_step": 1e3 * bound_ms, "bound_by": bound_by,
            "device_us_by_stage": split, "steps_timed": steps}


def rank1_stage_checks(state, opts, gamma, label: str, want,
                       min_step: int = 0, max_steps: int = 5000,
                       dual: bool = False):
    """Each launch of a step held against its plain stage on the card
    (every record field), on the first step at or past ``min_step`` of
    each kind in ``want``: "cleanup" (a clean-up pivot or retire),
    "phase_change", "devex_reset" (the phase change's, under devex),
    "ray_scan" and "probe" (devex's ticks), "max_increase" (a
    greatest-increase step), "dual_pivot" and "dual_exit" (with ``dual``:
    a dual walk's pivot and its optimal step).
    The record walks on through the kernels' stages. Returns {kind:
    step}."""
    import torch

    from tpulp_torch.kernels import rank1 as kr

    stall = opts.resolved_stall_limit(state.m, state.n)
    mi = opts.max_iters
    rec = kr.make_record(state, opts, gamma, dual)
    devex = rec.walk == "devex"
    head = ("scan", "price") if rec.scan is not None else ("price",)
    found = {}
    for step in range(max_steps):
        for stage in head:
            kr.rank1_stage(rec, stage, opts, stall, mi)
        iv = rec.ints.tolist()
        if iv[kr.STATUS] != 0:
            break
        tick = iv[kr.NITER] % kr.RAY_SCAN_EVERY
        plain2 = iv[kr.PHASE] == 2 and not iv[kr.CLEANUP]
        kinds = {
            "cleanup": iv[kr.CLEANUP],
            "phase_change": iv[kr.TO_PHASE2],
            "devex_reset": devex and iv[kr.TO_PHASE2],
            "ray_scan": devex and plain2 and tick == 0,
            "probe": devex and plain2 and not iv[kr.BLAND]
            and tick == kr.RAY_SCAN_EVERY // 2,
            "max_increase": rec.scan is not None and not devex,
            "dual_pivot": dual and not iv[kr.FEASIBLE],
            "dual_exit": dual and iv[kr.FEASIBLE]}
        new = {k for k, v in kinds.items() if v and k in want
               and k not in found}
        if step >= min_step and new:
            base = kr.clone_record(rec)
            for stage in kr.STAGES:
                if stage == "scan" and base.scan is None:
                    continue
                k, p = kr.clone_record(base), kr.clone_record(base)
                kr.rank1_stage(k, stage, opts, stall, mi)
                kr.rank1_stage_reference(p, stage, opts, stall, mi)
                torch.cuda.synchronize()
                for (name, a), (_, b) in zip(kr.record_tensors(k),
                                             kr.record_tensors(p)):
                    a, b = a.cpu(), b.cpu()
                    if a.is_floating_point():
                        a, b = a.nan_to_num(0.5) + 0.0, b.nan_to_num(0.5) + 0.0
                    if not torch.equal(a, b):
                        raise AssertionError(
                            f"5c {label}: the {stage} launch of step {step} "
                            f"({sorted(new)}) differs from its plain stage "
                            f"in {name}")
                base = p
            for kind in new:
                found[kind] = step
        for stage in ("ratio", "update", "finish"):
            kr.rank1_stage(rec, stage, opts, stall, mi)
        if set(found) == set(want):
            break
    if set(found) != set(want):
        raise AssertionError(f"5c {label}: no step of kinds "
                             f"{set(want) - set(found)} in {step + 1}")
    log(f"# 5c stages, {label}: "
        + ("price, ratio, update and finish" if rec.scan is None
           else "scan, price, ratio, update and finish")
        + " each equal their plain stage on the card (every record field) "
        "at step "
        + ", ".join(f"{s} ({k})" for k, s in sorted(found.items(),
                                                    key=lambda x: x[1])))
    return found


def solo_solve(sf, dt, driver: str, label: str, route: str,
               optimal: bool = True, dev="cuda", **kw):
    """``solve_lp`` with the launch counts set to 0 just before it and read
    just after: the route's kernel launched and, with ``optimal``, the
    answer optimal with no FMA launch (an answer that is not optimal is
    re-derived on the refreshed rung, whose devex segments run the
    blocked engine's kernels)."""
    import torch

    import tpulp_torch
    from tpulp_torch.kernels import LAUNCHES, reset_launches

    sync(dev)
    reset_launches()
    t0 = time.perf_counter()
    sol = tpulp_torch.solve_lp(sf, dtype=dt, device=dev, driver=driver,
                               **kw)
    sync(dev)
    secs = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    log(f"# 5c solve_lp {label} {str(dt)[6:]} (driver={driver!r}): "
        f"{sol.status}, rung {sol.rung}, {sol.niter} pivots, objective "
        f"{sol.objective!r}, {secs:.2f} s; launches {launches}")
    # the solo walks of the other rank-1 routes: none
    rank1 = ("rank1_cluster", "rank1_grid", "rank1_step")
    others = [r for r in rank1 if r != route] if route in rank1 else []
    if not (launches[route] > 0
            and (launches["fused_fma"] == 0 or not optimal)
            and not any(launches[r] for r in others)):
        raise AssertionError(f"5c {label}: launches {launches}, want "
                             f"{route}, none of {others} and no FMA")
    if optimal and sol.status != "optimal":
        raise AssertionError(f"5c {label}: {sol.status}")
    return sol, {"status": sol.status, "rung": sol.rung,
                 "niter": sol.niter, "seconds": secs, "launches": launches,
                 "objective": str(sol.objective)}


def cluster_edge_cases(dt, dev="cuda"):
    """``rank1_cluster`` at every cluster size that holds a 22 x 61 frame,
    against ``rank1_cluster_reference`` in every field: a redirected
    exit pivot that is no no-op (column ``basis[0]`` off the unit vector;
    with row 2 infinite too), an infinite b, a NaN in the pricing row, a
    warm dual frame, its NaN in b and its redirected exit; primal cases
    also under devex. Returns the number of walks held."""
    import torch

    from tpulp_torch import SolverOptions
    from tpulp_torch.kernels import rank1_cluster as kc
    from tpulp_torch.solve.api import state_from_standard_form
    from tpulp_torch.solve.driver import run_simplex
    from tpulp_torch.solve.dual import warm_state_from_basis

    A, b, c = dense_leq_arrays(20, 40, seed=7)
    st = state_from_standard_form(scenario_form(A, b, c), dtype=dt,
                                  device="cpu")
    o = SolverOptions.for_dtype(dt)
    stall = o.resolved_stall_limit(st.m, st.n)
    fin = run_simplex(st, o)
    j0 = int(fin.basis[0])

    def edit(s, *cells, reopen=False):
        T = s.T.clone()
        for i, j, v in cells:
            T[i, j] = v
        s = s._replace(T=T)
        return s._replace(status=torch.zeros_like(s.status)) if reopen \
            else s

    b2 = st.T[2:, -1].clone()
    b2[:6] *= 0.3
    fr = warm_state_from_basis(
        st.T[2:, :-1], st.T[0, :-1], st.col_active & ~st.art_cols,
        st.art_cols, fin.basis.numpy(), b2)
    cases = [("redirected", edit(fin, (5, j0, 1e-3), reopen=True), False),
             ("row 2 infinite", edit(fin, (5, j0, 1e-3), (2, 7, np.inf),
                                     reopen=True), False),
             ("infinite b", edit(st, (6, -1, np.inf)), False),
             ("NaN in c", edit(st, (0, 3, np.nan)), False),
             ("dual", fr, True),
             ("dual NaN in b", edit(fr, (4, -1, np.nan)), True),
             ("dual redirected", edit(fr, (5, int(fr.basis[0]), 1e-3)),
              True)]
    held = 0
    for label, s, dual in cases:
        for devex in (False,) if dual else (False, True):
            g = torch.ones(s.n, dtype=dt) if devex else None
            for C in kc.CLUSTER_SIZES:
                k, kg = kc.rank1_cluster(
                    type(s)(*(x.to(dev) for x in s)), o, stall,
                    o.max_iters, None if g is None else g.to(dev), dual,
                    blocks=C)
                p, pg = kc.rank1_cluster_reference(s, o, stall, o.max_iters,
                                                   g, dual, C)
                sync(dev)
                lanes_equal(type(k)(*(x.cpu() for x in k)), p)
                if g is not None and not torch.equal(
                        kg.cpu().nan_to_num(0.5) + 0.0,
                        pg.nan_to_num(0.5) + 0.0):
                    raise AssertionError(f"5c edge {label}: the devex "
                                         "weights differ")
                held += 1
    log(f"# 5c rank1_cluster on edge cases, {str(dt)[6:]} (22 x 61, "
        f"C = 1, 2, 4, 8): {held} walks equal their plain version in "
        "every field (" + ", ".join(c[0] for c in cases) + ")")
    return held


# the grid walks of 5c (rank1_grid): their windows held against
# rank1_grid_reference on the card, f64 and f32; one timed launch of
# SOLO_GRID_TIMED steps from step SOLO_GRID_ADVANCE; the resident warm
# re-solve's LP (514 x 1537); the LP past the grid's plan (10002 x 10513,
# rank1_step's route since the grid) and its budget
SOLO_GRID_WINDOW, SOLO_GRID_WINDOW_F32 = 256, 96
SOLO_GRID_TIMED, SOLO_GRID_ADVANCE = 1024, 8
GRID_RES_M, GRID_RES_N = 512, 1024
RANK1_PAST_M, RANK1_PAST_N, RANK1_PAST_STEPS = 10000, 512, 64


def sm_clock_hz() -> float:
    """The card's largest SM clock (nvidia-smi), for the shared-memory
    bounds."""
    return 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])


def grid_walk(walk: str, state, opts, max_iters=None, **kw):
    """``rank1_grid``'s walk of ``state`` (devex from unit weights):
    (state, weights)."""
    import torch

    from tpulp_torch.kernels.rank1_grid import rank1_grid

    stall = opts.resolved_stall_limit(state.m, state.n)
    gamma = torch.ones((state.n,), dtype=state.T.dtype,
                       device=state.T.device) if walk == "devex" else None
    return rank1_grid(state, opts, stall,
                      opts.max_iters if max_iters is None else max_iters,
                      gamma, walk == "dual", **kw)


def grid_walk_check(walk: str, state, opts, label: str, window: int):
    """5c: a walk on ``rank1_grid`` through the solo drivers (one launch, no
    other kernel), held equal in every field to ``rank1_steps``' walk of
    the same frame, whole, and over its first ``window`` steps to
    ``rank1_grid_reference`` on the card (the plan's G); both kernels'
    whole walks timed on the host clock in turns (grid, steps, steps,
    grid, twice). Returns the numbers."""
    import torch

    from tpulp_torch.kernels import LAUNCHES, reset_launches
    from tpulp_torch.kernels import rank1_grid as kg
    from tpulp_torch.kernels.launch import sm_count
    from tpulp_torch.kernels.rank1 import rank1_steps
    from tpulp_torch.solve.driver import finish

    dev = state.T.device
    M, N = state.T.shape
    dual = walk == "dual"
    stall = opts.resolved_stall_limit(state.m, state.n)
    gamma = torch.ones((state.n,), dtype=state.T.dtype, device=dev) \
        if walk == "devex" else None
    k, gk, secs, launches = solo_kernel(walk, state, opts, "rank1_grid")
    others = {key: v for key, v in launches.items()
              if key != "rank1_grid" and v}
    if others or launches["rank1_grid"] != 1:
        raise AssertionError(f"5c {label}: launches {launches}, want one "
                             "rank1_grid launch alone")
    reset_launches()
    s, g = rank1_steps(state, opts, stall, opts.max_iters, gamma, dual)
    sync(dev)
    step_launches = LAUNCHES["rank1_step"]
    err = lanes_equal(k, finish(s))
    weights_equal(gk, g, f"{label} against rank1_step")
    # the window against the plain version
    budget = int(state.niter) + window
    kw, kgw = grid_walk(walk, state, opts, budget)
    plan = kg.rank1_grid_plan(M, N, state.T.dtype, sm_count(dev))
    sync(dev)
    t0 = time.perf_counter()
    pw, pg = kg.rank1_grid_reference(state, opts, stall, budget, gamma,
                                     dual, plan.blocks)
    sync(dev)
    plain_secs = time.perf_counter() - t0
    err = max(err, lanes_equal(kw, pw))
    weights_equal(kgw, pg, f"{label} against rank1_grid_reference")
    wsteps = max(int(pw.niter) - int(state.niter), 1)
    runs = {"grid": lambda: grid_walk(walk, state, opts),
            "step": lambda: rank1_steps(state, opts, stall, opts.max_iters,
                                        gamma, dual)}
    host = {"grid": [], "step": []}
    for name in ("grid", "step", "step", "grid") * 2:
        sync(dev)
        t0 = time.perf_counter()
        runs[name]()
        sync(dev)
        host[name].append(time.perf_counter() - t0)
    niter = max(int(k.niter) - int(state.niter), 1)
    flop_s = FP64_FLOP_S if state.T.dtype == torch.float64 else FP32_FLOP_S
    bound_ms, bound_by = bound(2.0 * M * N * state.T.element_size(),
                               2.0 * M * N * niter, flop_s)
    res = {"status": int(k.status), "niter": niter, "bland": bool(k.bland),
           "route": "rank1_grid", "launches": launches["rank1_grid"],
           "seconds": float(np.median(host["grid"])),
           "first_seconds": secs,
           "ms_per_step": 1e3 * float(np.median(host["grid"])) / niter,
           "max_abs_err": err, "window_steps": wsteps,
           "plain_seconds": plain_secs,
           "plain_ms_per_step": 1e3 * plain_secs / wsteps,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "blocks": plan.blocks, "width": plan.width, "rows": plan.rows,
           "smem": plan.smem, "scratch": plan.scratch,
           "rank1_step": {"max_abs_err": err, "steps": step_launches,
                          "plain_ms_per_step": 1e3 * plain_secs / wsteps,
                          "seconds": float(np.median(host["step"])),
                          "ms_per_step": 1e3 * float(np.median(
                              host["step"])) / niter,
                          "niter": niter}}
    log(f"# 5c {label} {M}x{N} {str(state.T.dtype)[6:]}: rank1_grid x 1 "
        f"(G {plan.blocks}, W {plan.width}, R {plan.rows}, "
        f"{plan.scratch} bytes streamed), status {res['status']}, {niter} "
        f"pivots: the walk equals rank1_steps' in every field, and its "
        f"first {wsteps} steps rank1_grid_reference's; "
        f"{1e3 * res['seconds']:.2f} ms = {1e3 * res['ms_per_step']:.2f} us "
        f"a pivot on the host clock, rank1_steps "
        f"{1e3 * res['rank1_step']['seconds']:.2f} ms = "
        f"{1e3 * res['rank1_step']['ms_per_step']:.2f} us ({step_launches} "
        f"steps), in turns; the plain version "
        f"{res['plain_ms_per_step']:.3f} ms a pivot")
    return res


def rank1_grid_us(walk: str, state, opts, label: str, niter: int,
                  clock_hz: float, steps: int = SOLO_GRID_TIMED,
                  advance: int = SOLO_GRID_ADVANCE):
    """One ``rank1_grid`` launch of up to ``steps`` steps of a walk of
    ``niter`` pivots, ``advance`` steps in, on the card alone (CUDA events
    after a sleep; median of three), by stage (block 0's cycles of each
    stage as a share of the launch's time; the owner's ratio test apart),
    with the plan, the occupancy and the bounds (``grid_bounds``: the
    walk's, the kernel's own convention and the table's step
    convention)."""
    import torch

    from tpulp_torch.kernels import rank1_grid as kg
    from tpulp_torch.kernels.launch import sm_count

    dev = state.T.device
    M, N = state.T.shape
    dtype = state.T.dtype
    start = int(state.niter)
    steps = max(1, min(steps, niter - advance - 1))
    mid, mg = grid_walk(walk, state, opts, start + advance)
    if int(mid.niter) != start + advance:
        raise AssertionError(f"5c {label}: the grid walk ended before step "
                             f"{advance}")
    stall = opts.resolved_stall_limit(state.m, state.n)
    dual = walk == "dual"

    def launch(**kw):
        return kg.rank1_grid(mid, opts, stall, start + advance + steps, mg,
                             dual, **kw)

    dev_us, host_us = [], []
    for _ in range(3):
        d, h = launches_us(launch, steps)
        dev_us.append(d)
        host_us.append(h)
    cyc = torch.zeros(len(kg.RANK1_GRID_STAGES), dtype=torch.int64,
                      device=dev)
    out, _ = launch(stage_cycles=cyc)
    if int(out.niter) != start + advance + steps:
        raise AssertionError(f"5c {label}: the timed grid steps ran past "
                             "the walk")
    c = dict(zip(kg.RANK1_GRID_STAGES, cyc.tolist()))
    owner = c.pop("owner")
    total = max(sum(c.values()), 1)
    us = float(np.median(dev_us))
    per_cycle = us * steps / total
    split = {k: v * per_cycle / steps for k, v in c.items()
             if k not in ("load", "store")}
    split["load_and_store_per_launch"] = (c["load"] + c["store"]) * per_cycle
    split["owner"] = owner * per_cycle / steps
    plan = kg.rank1_grid_plan(M, N, dtype, sm_count(dev))
    es = state.T.element_size()
    wb, own, step_b = grid_bounds(M, N, es, plan.blocks, niter, clock_hz,
                                  rows=plan.rows)
    occ = kg.rank1_grid_occupancy(M, N, dtype, walk, dev)
    res = {"device_us_per_step": us,
           "host_us_per_step": float(np.median(host_us)),
           "device_us_by_stage": split, "blocks": plan.blocks,
           "width": plan.width, "rows": plan.rows, "smem": plan.smem,
           "scratch": plan.scratch, "occupancy": occ, "steps": steps,
           "advance": advance, "bound_ms": wb[0], "bound_by": wb[1],
           "grid_bound_ms": own, "step_bound_ms": step_b,
           "sm_clock_hz": clock_hz}
    log(f"# 5c rank1_grid {label} {M}x{N} {str(dtype)[6:]}: {us:.3f} us a "
        f"step on the card (one launch of {steps} steps from step "
        f"{advance}; by stage "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
        + f"); G {plan.blocks}, W {plan.width}, R {plan.rows} of {M} rows "
        f"resident, {plan.scratch} bytes streamed, {plan.smem} bytes of "
        f"shared memory a block, occupancy {occ}; bounds a step: "
        f"{1e3 * wb[0]:.4f} us ({wb[1]}), {1e3 * own:.3f} us (the kernel's "
        f"convention), {1e3 * step_b:.2f} us (the table's step convention)")
    return res


def grid_and_step_us(walk: str, state, opts, label: str, niter: int,
                     clock_hz: float):
    """``rank1_grid_us`` and ``rank1_step_us`` on the same walk in turns
    (grid, steps, steps, grid): the grid's figures with its turns, and
    ``rank1_step``'s (the means)."""
    dual = walk == "dual"
    grids, steps = [], []
    for kind in ("grid", "step", "step", "grid"):
        if kind == "grid":
            grids.append(rank1_grid_us(walk, state, opts, label, niter,
                                       clock_hz))
        else:
            steps.append(rank1_step_us(state, opts, None, label, niter,
                                       dual=dual))
    g = dict(grids[0])
    g["device_us_turns"] = [r["device_us_per_step"] for r in grids]
    g["device_us_per_step"] = float(np.mean(g["device_us_turns"]))
    g["device_us_by_stage"] = {
        k: float(np.mean([r["device_us_by_stage"][k] for r in grids]))
        for k in grids[0]["device_us_by_stage"]}
    s = dict(steps[0])
    s["device_us_turns"] = [r["device_us_per_step"] for r in steps]
    s["device_us_per_step"] = float(np.mean(s["device_us_turns"]))
    s["device_us_by_stage"] = {
        k: float(np.mean([r["device_us_by_stage"][k] for r in steps]))
        for k in steps[0]["device_us_by_stage"]}
    log(f"# 5c {label}, in turns: rank1_grid {g['device_us_turns']} us a "
        f"step on the card, rank1_step {s['device_us_turns']}")
    return g, s


def grid_edge_cases(dt, dev="cuda"):
    """``rank1_grid`` bit for bit against ``rank1_grid_reference`` (on CPU
    copies, the same slabs) on small frames: 22 x 61 (``dense_leq_arrays``)
    under Dantzig, Bland, the greatest increase, largest-pivot ties, a
    stall limit of 1, devex and a budget of 7, with devex weights above
    1e8, a NaN in b, a redirected exit pivot that is no no-op (column
    ``basis[0]`` off the unit vector: barrier C) and a warm dual frame (its
    Bland switch and NaN too); 42 x 131 (``artificial_arrays``: phase 1,
    the clean-up and a retire) under Dantzig and devex. Each on the plan's
    grid and on 1, 3 and 7 blocks resident, and streamed at forced splits
    (rows 3, M // 2, M - 1) on 1, 3 and 7 blocks in turn. Returns the
    counts (resident, streamed)."""
    import torch

    from tpulp_torch import SolverOptions
    from tpulp_torch.core.state import (RULE_BLAND, RULE_MAX_INCREASE,
                                        TIE_MAXPIV)
    from tpulp_torch.kernels import rank1_grid as kg
    from tpulp_torch.kernels.launch import sm_count
    from tpulp_torch.solve.api import state_from_standard_form
    from tpulp_torch.solve.driver import run_simplex
    from tpulp_torch.solve.dual import warm_state_from_basis

    sms = sm_count(torch.device(dev)) if dev == "cuda" else kg.GRID_SMS
    A, b, c = dense_leq_arrays(20, 40, seed=7)
    st = state_from_standard_form(scenario_form(A, b, c), dtype=dt,
                                  device="cpu")
    ca, Aa, ba, _ = artificial_arrays(40, 90, seed=2)
    sa = state_from_standard_form(equality_form(ca, Aa, ba), dtype=dt,
                                  device="cpu")
    o = SolverOptions.for_dtype(dt)
    fin = run_simplex(st, o)
    j0 = int(fin.basis[0])

    def edit(s, *cells, reopen=False):
        T = s.T.clone()
        for i, j, v in cells:
            T[i, j] = v
        s = s._replace(T=T)
        return s._replace(status=torch.zeros_like(s.status)) if reopen \
            else s

    b2 = st.T[2:, -1].clone()
    b2[:6] *= 0.3
    fr = warm_state_from_basis(
        st.T[2:, :-1], st.T[0, :-1], st.col_active & ~st.art_cols,
        st.art_cols, fin.basis.numpy(), b2)
    big = torch.ones(st.n, dtype=dt)
    big[::3] = 3e8
    # (label, state, walk, options, weights)
    cases = [("dantzig", st, "primal", o, None),
             ("bland", st, "primal",
              SolverOptions.for_dtype(dt, rule=RULE_BLAND), None),
             ("max_increase", st, "primal",
              SolverOptions.for_dtype(dt, rule=RULE_MAX_INCREASE), None),
             ("maxpiv", st, "primal",
              SolverOptions.for_dtype(dt, tie_break=TIE_MAXPIV), None),
             ("stall 1", st, "primal",
              SolverOptions.for_dtype(dt, stall_limit=1, degen_tol=1e30),
              None),
             ("devex", st, "devex", o, torch.ones(st.n, dtype=dt)),
             ("budget 7", st, "devex", dataclasses.replace(o, max_iters=7),
              torch.ones(st.n, dtype=dt)),
             ("weights past 1e8", st, "devex", o, big),
             ("NaN in b", edit(st, (6, -1, np.nan)), "primal", o, None),
             ("redirected", edit(fin, (5, j0, 1e-3), reopen=True), "primal",
              o, None),
             ("phase 1", sa, "primal", o, None),
             ("phase 1 devex", sa, "devex", o, torch.ones(sa.n, dtype=dt)),
             ("dual", fr, "dual", o, None),
             ("dual bland", fr, "dual",
              SolverOptions.for_dtype(dt, stall_limit=1, degen_tol=1e30),
              None),
             ("dual NaN in b", edit(fr, (4, -1, np.nan)), "dual", o, None)]
    count = {"resident": 0, "streamed": 0}
    t0 = time.perf_counter()
    for label, s, walk, opts, g in cases:
        stall = opts.resolved_stall_limit(s.m, s.n)
        M = s.T.shape[0]
        splits = [(None, blocks) for blocks in (None, 1, 3, 7)]
        splits += [(rows, (1, 3, 7)[q])
                   for q, rows in enumerate((3, M // 2, M - 1))]
        for rows, blocks in splits:
            plan = kg.rank1_grid_plan(*s.T.shape, dt, sms, blocks=blocks,
                                      rows=rows)
            if dev == "cuda":
                k, kgw = kg.rank1_grid(
                    type(s)(*(x.to(dev) for x in s)), opts, stall,
                    opts.max_iters, None if g is None else g.to(dev),
                    walk == "dual", blocks=blocks, rows=rows)
            else:
                k, kgw = kg.rank1_grid_reference(s, opts, stall,
                                                 opts.max_iters, g,
                                                 walk == "dual",
                                                 plan.blocks)
            p, pg = kg.rank1_grid_reference(s, opts, stall, opts.max_iters,
                                            g, walk == "dual", plan.blocks)
            sync(dev)
            try:
                lanes_equal(type(k)(*(x.cpu() for x in k)), p)
                if g is not None:
                    tensors_equal("weights", kgw, pg)
            except AssertionError as err:
                raise AssertionError(
                    f"5c grid edge {label} {str(dt)[6:]} G {plan.blocks} "
                    f"R {plan.rows}: {err}") from None
            count["resident" if rows is None else "streamed"] += 1
    log(f"# 5c rank1_grid on edge cases, {str(dt)[6:]} (22 x 61, 42 x 131): "
        f"{count['resident']} resident and {count['streamed']} streamed "
        "walks equal rank1_grid_reference in every field ("
        + ", ".join(c[0] for c in cases) + f"; resident on the plan's grid "
        "and 1, 3, 7 blocks, streamed at rows 3, M // 2, M - 1 on 1, 3, 7 "
        f"blocks; {time.perf_counter() - t0:.1f} s)")
    return count


def past_grid_walk(dev="cuda"):
    """5c (x): ``run_simplex`` on a RANK1_PAST_M x RANK1_PAST_N LP
    (``main_path_arrays``, a slack basis, 10002 x 10513 at f64) past the
    grid's plan (``solo_route``: "rank1_step"), to a budget of
    RANK1_PAST_STEPS pivots: on ``rank1_steps`` (no ``rank1_grid`` and no
    FMA launch), held to the plain loop in every field; the step timed by
    launch."""
    import torch

    from tpulp_torch import SolverOptions, make_state
    from tpulp_torch.kernels.launch import sm_count
    from tpulp_torch.solve.driver import solo_route

    m, n = RANK1_PAST_M, RANK1_PAST_N
    state = make_state(*main_path_arrays(m, n, seed=4), dtype=torch.float64,
                       device=dev)
    M, N = state.T.shape
    route = solo_route("primal", M, N, torch.float64,
                       sm_count(torch.device(dev)), torch.device(dev))
    if route != "rank1_step":
        raise AssertionError(f"5c (x): {M} x {N} takes {route}")
    opts = SolverOptions.for_dtype(torch.float64,
                                   max_iters=RANK1_PAST_STEPS)
    k, _, secs, launches = solo_kernel("primal", state, opts, "rank1_step")
    p, _, plain_secs = solo_plain("primal", state, opts)
    err = lanes_equal(k, p)
    steps = int(k.niter)
    if steps != RANK1_PAST_STEPS or launches["rank1_step"] == 0 or \
            launches["rank1_grid"] or launches["fused_fma"]:
        raise AssertionError(f"5c (x): {steps} pivots, launches {launches}")
    u = rank1_step_us(state, SolverOptions.for_dtype(torch.float64), None,
                      "(x) past the grid's plan", 4 * RANK1_PAST_STEPS)
    log(f"# 5c (x) {m}x{n} ({M} x {N}, past the grid's plan: {route}) "
        f"f64: its first {steps} pivots through run_simplex equal the plain "
        f"walk in every field ({secs:.3f} s against {plain_secs:.2f} s); "
        f"launches {launches}")
    return {"route": route, "steps": steps, "seconds": secs,
            "plain_seconds": plain_secs, "max_abs_err": err,
            "launches": launches, "step_us": u,
            "ms_per_step": 1e3 * secs / steps,
            "plain_ms_per_step": 1e3 * plain_secs / steps}


def phase_solo_walks(main_pivots_per_s: float, dev="cuda"):
    """Phase 5c: the solo rank-1, devex and dual walks on their kernels,
    each held against its plain version in every field at f64 and f32
    (``rank1_cluster_reference`` on the cluster route, the plain loop on
    the others) and, on the cluster route, against ``rank1_steps``' walk
    on the same frame, timed beside it in turns: (a) ``solve_lp(driver=
    "auto")`` on phase 7c's LP (258 x 769, the top of the rank-1 engine's
    range) on ``rank1_cluster`` (no ``rank1_step``, no FMA); (b) the devex
    walk of the largest artificial LP under 200k elements, past a ray-scan
    and a probe tick, and an optimal devex LP whose solve launches no FMA;
    (c) Bland, the greatest increase and largest-pivot ties on a resident
    frame (``lane_primal`` at B = 1) and on (a)'s; (d) each of
    ``rank1_step``'s launches against its plain stage, on (a)'s and (b)'s
    frames; (e) the warm re-solves: phase 7c's and a deeper one on the
    cluster's dual walk, a resident one on ``lane_dual`` at B = 1, one on
    phase 5's 1538 x 3073 frame on ``rank1_grid``'s streamed plan (f64;
    resident at f32) and one of a 514 x 1537 LP on its resident plan;
    (f) ``solve_lp(driver="rank1")`` on phase 5's LP, on ``rank1_grid``;
    (g) the refreshed rung's rank-1 segments. The grid's walks (one launch
    each) are held whole against ``rank1_steps``' and over a window against
    ``rank1_grid_reference`` (``grid_walk_check``), and one launch of up to
    1,024 steps is timed by stage in turns with ``rank1_step``
    (``grid_and_step_us``); (x) a 10002 x 10513 LP past the grid's plan
    runs ``rank1_step`` (``past_grid_walk``). ``rank1_step`` is timed by
    launch on (a), (b), (e), (f) and (x). Also the cluster walk on edge
    cases at every cluster size (``cluster_edge_cases``), the grid's at
    forced splits (``grid_edge_cases``) and the bounded walk of a strided
    tableau. Returns the numbers; ``launches`` are (a)'s f64 solve's."""
    import dataclasses as dc

    import torch

    from tpulp_torch import SolverOptions, make_state
    from tpulp_torch.core.state import (RULE_BLAND, RULE_DEVEX,
                                        RULE_MAX_INCREASE, TIE_MAXPIV)
    from tpulp_torch.kernels import lane_plan
    from tpulp_torch.solve.api import state_from_standard_form
    from tpulp_torch.solve.bounded import run_simplex_bounded
    from tpulp_torch.solve.dual import warm_state_from_basis
    from tpulp_torch.solve.refresh import stabilized_options

    def warm_frame(form, sol, dt):
        """The dual simplex's frame of ``form`` from ``sol``'s basis."""
        s2 = state_from_standard_form(form, dtype=dt, device=dev)
        return warm_state_from_basis(
            s2.T[2:, :-1], s2.T[0, :-1], s2.col_active & ~s2.art_cols,
            s2.art_cols, np.asarray(sol.basis, np.int32), s2.T[2:, -1])

    def cut(b):
        """The RHS with the first 1 / SOLO_CUT of its rows halved (rounded
        down on integer data)."""
        b2, k = b.copy(), len(b) // SOLO_CUT
        b2[:k] = b2[:k] // 2 if b.dtype.kind == "i" else b2[:k] * 0.5
        return b2

    res = {"walks": {}, "stages": {}, "step_us": {}, "grid_us": {},
           "solves": {}}
    A, b, c = dense_leq_arrays(WARM_M, WARM_N)
    sf_a = scenario_form(A, b, c)
    ca, Aa, ba, _ = artificial_arrays(WARM_M, SOLO_DEVEX_N)
    sf_b = equality_form(ca, Aa, ba)
    # the optimal devex LP: artificial_arrays without its four dependent
    # rows, c >= 0
    co, Ao, bo, _ = artificial_arrays(WARM_M + 4, SOLO_DEVEX_OPT_N)
    sf_bo = equality_form(np.abs(co), Ao[:WARM_M], bo[:WARM_M])
    Ar, br, cr = dense_leq_arrays(SOLO_RESIDENT_M, SOLO_RESIDENT_N, seed=3)
    sf_c = scenario_form(Ar, br, cr)
    # the resident warm re-solve: integer data (solve_lp refines a basis of
    # at most 192 rows in rationals)
    ci, Ai, bi, hi = main_path_arrays(SOLO_RESIDENT_M, SOLO_RESIDENT_N,
                                      seed=3)
    sf_ci = standard_form(ci, Ai, bi, hi, SOLO_RESIDENT_N)
    sf_ci2 = standard_form(ci, Ai, cut(bi), hi, SOLO_RESIDENT_N)
    objective = {}
    for dt in (torch.float64, torch.float32):
        name = str(dt)[6:]
        if not lane_plan(SOLO_RESIDENT_M + 2, SOLO_RESIDENT_M
                         + SOLO_RESIDENT_N + 1, dt).resident:
            raise AssertionError("5c: the resident frame is not resident")
        # (a) the rank-1 engine's main case
        sol, res["solves"][f"a_{name}"] = solo_solve(
            sf_a, dt, "auto", f"(a) {WARM_M}x{WARM_N + WARM_M}",
            "rank1_cluster", dev=dev)
        objective[name] = sol.objective
        if name == "float64":
            res["launches"] = res["solves"]["a_float64"]["launches"]
        st = state_from_standard_form(sf_a, dtype=dt, device=dev)
        opts = SolverOptions.for_dtype(dt)
        w = solo_walk_check("primal", st, opts, "(a) Dantzig",
                            "rank1_cluster")
        if w["status"] != 1:
            raise AssertionError(f"5c (a): status {w['status']}")
        res["walks"][f"a_{name}"] = w
        res["step_us"][f"a_{name}"] = rank1_step_us(
            st, opts, None, "(a)", w["niter"])
        # (b) devex, chosen by solve_lp for the artificial LP (unbounded at
        # f64 past 13 ray-scan ticks in phase 2; at f32 phase 1 ends
        # infeasible)
        _, res["solves"][f"b_{name}"] = solo_solve(
            sf_b, dt, "auto", f"(b) {WARM_M}x{SOLO_DEVEX_N}",
            "rank1_cluster", optimal=False, dev=dev)
        sb = state_from_standard_form(sf_b, dtype=dt, device=dev)
        ob = SolverOptions.for_dtype(dt, rule=RULE_DEVEX)
        wb = solo_walk_check("devex", sb, ob, "(b) devex", "rank1_cluster")
        res["walks"][f"b_{name}"] = wb
        ones = torch.ones((sb.n,), dtype=dt, device=dev)
        if name == "float64":
            # (d) on the devex walk: the clean-up, the phase change and
            # its reset of the weights, the ray-scan and probe ticks
            res["stages"]["b_float64"] = rank1_stage_checks(
                sb, ob, ones, "(b) devex float64",
                ("cleanup", "phase_change", "devex_reset", "ray_scan",
                 "probe"))
        res["step_us"][f"b_{name}"] = rank1_step_us(
            sb, ob, ones, "(b) devex", wb["niter"])
        # (b) the optimal devex LP: solve_lp's answer on the rank-1 step
        # with no FMA launch, and its walk
        _, res["solves"][f"b_optimal_{name}"] = solo_solve(
            sf_bo, dt, "auto", f"(b) optimal {WARM_M}x{SOLO_DEVEX_OPT_N}",
            "rank1_cluster", dev=dev)
        so = state_from_standard_form(sf_bo, dtype=dt, device=dev)
        wo = solo_walk_check("devex", so, ob, "(b) optimal devex",
                             "rank1_cluster")
        if wo["status"] != 1:
            raise AssertionError(f"5c (b) optimal: status {wo['status']}")
        res["walks"][f"b_optimal_{name}"] = wo
        # (c) the other rules and ties, resident and not
        sc = state_from_standard_form(sf_c, dtype=dt, device=dev)
        for rule, over in (("bland", {"rule": RULE_BLAND}),
                           ("max_increase", {"rule": RULE_MAX_INCREASE}),
                           ("maxpiv", {"tie_break": TIE_MAXPIV})):
            o = SolverOptions.for_dtype(dt, **over)
            res["walks"][f"c_{rule}_resident_{name}"] = solo_walk_check(
                "primal", sc, o, f"(c) {rule}, resident", "lane_primal")
            if rule == "bland":
                o = dc.replace(o, max_iters=SOLO_BLAND_WINDOW)
            res["walks"][f"c_{rule}_{name}"] = solo_walk_check(
                "primal", st, o, f"(c) {rule}", "rank1_cluster")
        om = SolverOptions.for_dtype(dt, rule=RULE_MAX_INCREASE)
        res["stages"][f"a_max_increase_{name}"] = rank1_stage_checks(
            st, om, None, f"(a) greatest increase {name}",
            ("max_increase",), min_step=5)
        res["step_us"][f"a_max_increase_{name}"] = rank1_step_us(
            st, om, None, "(a) greatest increase",
            res["walks"][f"c_max_increase_{name}"]["niter"])
        # (e) the warm re-solves: phase 7c's (three rows x 0.8) and a
        # deeper one on rank1_step's dual walk, a resident one on lane_dual
        # at B = 1
        b2 = b.copy()
        b2[:3] *= 0.8
        form2 = scenario_form(A, b2, c)
        warm, res["solves"][f"e_{name}"] = solo_solve(
            form2, dt, "auto", "(e) warm_start", "rank1_cluster", dev=dev,
            warm_start=sol)
        if not warm.niter < sol.niter:
            raise AssertionError("5c (e): no fewer pivots warm")
        frame = warm_frame(form2, sol, dt)
        res["walks"][f"e_{name}"] = solo_walk_check(
            "dual", frame, opts, "(e) warm dual", "rank1_cluster")
        form3 = scenario_form(A, cut(b), c)
        _, res["solves"][f"e_deep_{name}"] = solo_solve(
            form3, dt, "auto", "(e) deeper warm_start", "rank1_cluster",
            dev=dev, warm_start=sol)
        frame3 = warm_frame(form3, sol, dt)
        w3 = solo_walk_check("dual", frame3, opts, "(e) deeper warm dual",
                             "rank1_cluster")
        res["walks"][f"e_deep_{name}"] = w3
        res["step_us"][f"e_deep_{name}"] = rank1_step_us(
            frame3, opts, None, "(e) dual", w3["niter"], dual=True)
        if name == "float64":
            # (d) on the dual walk: a pivot and the optimal exit
            res["stages"]["e_float64"] = rank1_stage_checks(
                frame3, opts, None, "(e) dual float64",
                ("dual_pivot", "dual_exit"), dual=True)
        solc, res["solves"][f"e_resident_cold_{name}"] = solo_solve(
            sf_ci, dt, "auto", "(e) resident cold", "lane_primal", dev=dev)
        _, res["solves"][f"e_resident_{name}"] = solo_solve(
            sf_ci2, dt, "auto", "(e) resident warm_start", "lane_dual",
            dev=dev, warm_start=solc)
        res["walks"][f"e_resident_{name}"] = solo_walk_check(
            "dual", warm_frame(sf_ci2, solc, dt), opts,
            "(e) resident warm dual", "lane_dual")
        # (g) the refreshed rung's rank-1 segments (largest-pivot ties)
        ref, res["solves"][f"g_{name}"] = solo_solve(
            sf_a, dt, "refreshed", "(g) refreshed", "rank1_cluster", dev=dev)
        if ref.objective != objective[name]:
            raise AssertionError(f"5c (g): objective {ref.objective!r}, "
                                 f"(a) {objective[name]!r}")
        res["walks"][f"g_{name}"] = solo_walk_check(
            "primal", st, stabilized_options(opts), "(g) TIE_MAXPIV",
            "rank1_cluster")
        res["edge_walks_held"] = res.get("edge_walks_held", 0) + \
            cluster_edge_cases(dt, dev)
        del st, sb, sc, so, frame, frame3
        torch.cuda.empty_cache()

    # (f) phase 5's LP on the rank-1 engine: rank1_grid (streamed at f64,
    # resident at f32), one launch a walk
    clock_hz = sm_clock_hz()
    sf_f = main_path_form(MAIN_M, MAIN_N)
    sol_f, res["solves"]["f_float64"] = solo_solve(
        sf_f, torch.float64, "rank1", f"(f) {MAIN_M}x{MAIN_M + MAIN_N}",
        "rank1_grid", dev=dev)
    sfl = res["solves"]["f_float64"]
    sfl["pivots_per_s"] = sfl["niter"] / sfl["seconds"]
    log(f"# 5c (f): driver='rank1' {sfl['pivots_per_s']:.1f} pivots/s "
        f"against phase 5's kernel engine {main_pivots_per_s:.1f} "
        "(lowering, set-up and refinement included in both)")
    for dt in (torch.float64, torch.float32):
        name = str(dt)[6:]
        sm = make_state(*main_path_arrays(MAIN_M, MAIN_N), dtype=dt,
                        device=dev)
        of = SolverOptions.for_dtype(dt)
        w = grid_walk_check(
            "primal", sm, of, "(f) the rank-1 walk",
            SOLO_GRID_WINDOW if dt == torch.float64 else SOLO_GRID_WINDOW_F32)
        res["walks"][f"f_{name}"] = w
        if dt == torch.float64:
            res["grid_us"]["f_float64"], res["step_us"]["f_float64"] = \
                grid_and_step_us("primal", sm, of, "(f)", w["niter"],
                                 clock_hz)
        del sm
        torch.cuda.empty_cache()
    # (e) at (f)'s size: the warm re-solve of phase 5's LP with a quarter
    # of its RHS halved, on the grid's dual walk
    cf, Af, bf, hf = main_path_arrays(MAIN_M, MAIN_N)
    sf_f2 = standard_form(cf, Af, cut(bf), hf, MAIN_N)
    _, res["solves"]["e_main_float64"] = solo_solve(
        sf_f2, torch.float64, "rank1",
        f"(e) warm_start {MAIN_M}x{MAIN_M + MAIN_N}", "rank1_grid", dev=dev,
        warm_start=sol_f)
    for dt in (torch.float64, torch.float32):
        name = str(dt)[6:]
        frame_f = warm_frame(sf_f2, sol_f, dt)
        od = SolverOptions.for_dtype(dt)
        wf = grid_walk_check(
            "dual", frame_f, od, "(e) the warm dual walk",
            SOLO_GRID_WINDOW if dt == torch.float64 else SOLO_GRID_WINDOW_F32)
        res["walks"][f"e_main_{name}"] = wf
        if dt == torch.float64:
            res["grid_us"]["e_main_float64"], \
                res["step_us"]["e_main_float64"] = grid_and_step_us(
                    "dual", frame_f, od, "(e) dual main", wf["niter"],
                    clock_hz)
        del frame_f
        torch.cuda.empty_cache()
    # (e) resident on the grid: a warm re-solve of a 514 x 1537 LP, f64
    o64 = SolverOptions.for_dtype(torch.float64)
    cr, Ar, br, hr = main_path_arrays(GRID_RES_M, GRID_RES_N, seed=5)
    sf_r = standard_form(cr, Ar, br, hr, GRID_RES_N)
    sf_r2 = standard_form(cr, Ar, cut(br), hr, GRID_RES_N)
    size = f"{GRID_RES_M}x{GRID_RES_M + GRID_RES_N}"
    sol_r, res["solves"]["e_grid_resident_cold_float64"] = solo_solve(
        sf_r, torch.float64, "rank1", f"(e) resident grid cold {size}",
        "rank1_grid", dev=dev)
    _, res["solves"]["e_grid_resident_float64"] = solo_solve(
        sf_r2, torch.float64, "rank1", f"(e) resident grid warm {size}",
        "rank1_grid", dev=dev, warm_start=sol_r)
    frame_r = warm_frame(sf_r2, sol_r, torch.float64)
    wr = grid_walk_check("dual", frame_r, o64,
                         "(e) the resident warm dual walk", SOLO_GRID_WINDOW)
    res["walks"]["e_grid_resident_float64"] = wr
    if wr["niter"] > 4 * SOLO_GRID_ADVANCE:
        res["grid_us"]["e_grid_resident_float64"] = rank1_grid_us(
            "dual", frame_r, o64, "(e) resident dual", wr["niter"], clock_hz)
    del frame_r
    # the grid on edge cases at forced splits; rank1_step past its plan
    res["edge_grid"] = {str(dt)[6:]: grid_edge_cases(dt, dev)
                        for dt in (torch.float64, torch.float32)}
    res["past"] = past_grid_walk(dev)
    torch.cuda.empty_cache()

    # the bounded walk of a strided tableau (a transposed view) equals the
    # contiguous one's
    bs, bo = bounded_state(box_form(0, BOX_M, BOX_N), dev, torch.float64,
                           False)
    strided = bs._replace(s=bs.s._replace(T=bs.s.T.t().contiguous().t()))
    if strided.s.T.is_contiguous():
        raise AssertionError("5c: the transposed view is contiguous")
    err = bounded_equal(run_simplex_bounded(strided, bo),
                        run_simplex_bounded(bs, bo))
    log(f"# 5c the bounded walk of a strided tableau (stride "
        f"{strided.s.T.stride()}) equals the contiguous one's (max |err| "
        f"{err})")
    res["strided_bounded"] = {"stride": list(strided.s.T.stride()),
                              "max_abs_err": err}
    return res


# ---------------------------------------------------------------------------
# phase 5d: the blocked engine on its kernel
# ---------------------------------------------------------------------------

# solve_lp's block, the eta slots of the blocked engine
BLK5_K = 64
# (b): artificial_arrays at 512 + 4 rows and this many columns: 518 x 1285
# with the four dependent rows, 514 x 1281 without (past 200k elements)
BLK5_ART_N = 768
# the plain walk held beside the kernels' over its first blocks where the
# whole walk is long; the cluster's plain version over fewer
BLK5_WINDOW = 1024
BLK5_CLUSTER_WINDOW = 512
# (d): the stage checks' block (block ends fall inside the clean-up), the
# budget that stops a walk inside a block, and cleanup_arrays' size (154 x
# 369; at 538 x 1329 the f32 walk pivots on its dependent rows' roundoff
# instead of retiring them) with its rows "-x_j = 0" that keep artificials
# basic into phase 2
BLK5_STAGE_K = 16
BLK5_BUDGET = 100
BLK5_CLEANUP_M, BLK5_CLEANUP_N, BLK5_CLEANUP_ROWS = 128, 192, 24
# (g): a wide LP in auto's blocked range (258 x 14,257, 3.7M elements)
# whose block of 64 eta slots no cluster holds: blocked_grid's route
BLK5_WIDE_M, BLK5_WIDE_N = 256, 14_000
# the first pivots of (g)'s walk held against blocked_grid_reference
BLK5_WIDE_WINDOW = 512
# (p): (g)'s LP in blocks of BLK5_PAST_K slots, whose slabs pass a block's
# shared memory (the grid's plan refuses it): blocked_step's route, walked
# to a budget (the plain-stage walk held beside it runs every slot of its
# block, so the budget stays small) and its first slots timed
BLK5_PAST_K, BLK5_PAST_BUDGET, BLK5_PAST_TIMED = 256, 96, 32
# the grid's edge walks: Bland's walk of the 64 x 128 LP cut to a budget
BLK5_GRID_BLAND = 200
# (f): bench.py's recipe at (m, n), the tableau (m + 2) x (n + m + 1), and
# the pivots timed on each engine
THRESH_SHAPES = ((256, 512), (512, 512), (1024, 1024), (1536, 1536))
THRESH_PIVOTS = 384


def cleanup_arrays(m: int, n: int, extra: int = BLK5_CLEANUP_ROWS,
                   seed: int = 1):
    """An integer equality LP on artificials whose phase 2 opens with
    clean-up pivots and retires: m rows of small integers over n columns
    (its last two rows 2 x row 0 and row 1 + row 2, dependent), then
    ``extra`` rows "-x_j = 0" on columns of their own, whose artificials
    phase 1 never prices out (their columns' phase-1 reduced cost is +1).
    Returns (c, A, b)."""
    rng = np.random.default_rng(seed)
    A = rng.integers(0, 4, size=(m - 2, n))
    x0 = rng.integers(1, 4, size=n) * (rng.random(n) < 0.5)
    A = np.vstack([A, 2 * A[0], A[1] + A[2]])
    b = np.concatenate([A @ x0, np.zeros(extra, dtype=A.dtype)])
    A = np.block([[A, np.zeros((m, extra), dtype=A.dtype)],
                  [np.zeros((extra, n), dtype=A.dtype),
                   -np.eye(extra, dtype=A.dtype)]])
    c = rng.integers(-5, 6, size=n + extra)
    return c.astype(float), A.astype(float), b.astype(float)


def blocked_plain(state, opts, K: int, max_iters=None):
    """The plain-stage walk (the launches' plain versions, flushed by B1 as
    the kernels' walk is): (state, devex weights, seconds)."""
    from tpulp_torch.core import eta_scaled_options
    from tpulp_torch.kernels.blocked import blocked_walk_reference
    from tpulp_torch.kernels.block import fused_flush
    from tpulp_torch.solve.driver import finish

    opts = eta_scaled_options(opts, state.T.dtype)
    stall = opts.resolved_stall_limit(state.m, state.n)
    sync(state.T.device)
    t0 = time.perf_counter()
    s, g = blocked_walk_reference(state, opts, stall, max_iters or
                                  opts.max_iters, K, flush=fused_flush)
    sync(state.T.device)
    return finish(s), g, time.perf_counter() - t0


def blocked_kernel_walk(state, opts, K: int):
    """The kernels' walk through ``blocked_steps`` (what
    ``run_simplex_blocked`` calls on the card, with its weights): (state,
    weights, seconds, launches)."""
    from tpulp_torch.core import eta_scaled_options
    from tpulp_torch.kernels import LAUNCHES, reset_launches
    from tpulp_torch.kernels.blocked import blocked_steps
    from tpulp_torch.solve.driver import finish

    opts = eta_scaled_options(opts, state.T.dtype)
    stall = opts.resolved_stall_limit(state.m, state.n)
    sync(state.T.device)
    reset_launches()
    t0 = time.perf_counter()
    s, g = blocked_steps(state, opts, stall, opts.max_iters, K)
    sync(state.T.device)
    return finish(s), g, time.perf_counter() - t0, dict(LAUNCHES)


def blocked_walk_check(state, opts, label: str, K: int = BLK5_K,
                       window: int | None = BLK5_WINDOW):
    """The kernels' walk and the plain-stage walk held equal in every field
    (``T + 0.0``, NaN equal, the devex weights too), over the whole walk or
    over its first ``window`` pivots (the budget of both, a multiple of K);
    the launches must be ``blocked_step`` slots, one ray launch and one B1
    flush a block, and nothing else. Returns the numbers."""
    import dataclasses as dc

    import torch

    if window is not None:
        opts = dc.replace(opts, max_iters=min(opts.max_iters, window))
    k, gk, secs, launches = blocked_kernel_walk(state, opts, K)
    p, gp, plain_secs = blocked_plain(state, opts, K)
    err = lanes_equal(k, p)
    if not torch.equal(gk.cpu() + 0.0, gp.cpu() + 0.0):
        raise AssertionError(f"5d {label}: the devex weights differ")
    blocks = launches["blocked_ray"]
    others = {key: v for key, v in launches.items() if v and key not in (
        "blocked_step", "blocked_ray", "fused_flush")}
    if others or not blocks or launches["fused_flush"] != blocks or \
            launches["blocked_step"] != K * blocks:
        raise AssertionError(f"5d {label}: launches {launches}")
    niter = int(k.niter) - int(state.niter)
    res = {"status": int(k.status), "niter": niter, "bland": bool(k.bland),
           "blocks": blocks, "seconds": secs, "plain_seconds": plain_secs,
           "max_abs_err": err, "launches": launches["blocked_step"],
           "us_per_pivot": 1e6 * secs / max(niter, 1),
           "plain_ms_per_pivot": 1e3 * plain_secs / max(niter, 1),
           "window": window}
    log(f"# 5d {label} {tuple(state.T.shape)} {str(state.T.dtype)[6:]} "
        f"K={K}: the kernels' walk equals the plain-stage walk in every field"
        f" (status {res['status']}, {niter} pivots in {blocks} blocks"
        + (f", the first {window} pivots" if window else "")
        + f"); {1e3 * secs:.2f} ms = {res['us_per_pivot']:.1f} us a pivot on "
        f"the host clock, the plain walk {res['plain_ms_per_pivot']:.3f} ms "
        "a pivot")
    return res


def blocked_stage_checks(state, opts, label: str, want, K: int,
                         max_slots: int = 6000):
    """Each launch held against its plain stage on the card (every record
    field, ``T + 0.0``), on the first slot or block end of each kind in
    ``want``: "pivot" (a pricing pivot, not under Bland), "bland" (one
    under Bland), "maxpiv_tie" (a pricing pivot with two or more rows in
    the min-ratio tie under largest-pivot ties), "cleanup", "retire",
    "devex_reset" (a phase change under devex), "reset_1e8" (the weights
    past 1e8), "budget_stop" (a slot the budget stops), and at a block's
    end "ray_art" / "ray_clear" (the ray launch in phase 2 with an
    artificial basic / with none). The record walks on through the
    kernels' launches. Returns {kind: slot}."""
    import torch

    from tpulp_torch.core import Status, eta_scaled_options
    from tpulp_torch.core.state import RULE_BLAND, RULE_DEVEX, TIE_MAXPIV
    from tpulp_torch.kernels import blocked as kb
    from tpulp_torch.kernels.block import fused_flush

    opts = eta_scaled_options(opts, state.T.dtype)
    stall = opts.resolved_stall_limit(state.m, state.n)
    mi = opts.max_iters
    devex = opts.rule == RULE_DEVEX
    M, N = state.T.shape
    G = kb.partials(M, N)
    rec = kb.make_record(state, K)
    found = {}

    def held(base, stages, kinds, scan=None):
        for stage in stages:
            k, p = kb.clone_record(base), kb.clone_record(base)
            kb.blocked_stage(k, stage, opts, stall, mi, scan)
            kb.blocked_stage_reference(p, stage, opts, stall, mi, scan)
            torch.cuda.synchronize()
            for (name, a), (_, b) in zip(kb.record_tensors(k),
                                         kb.record_tensors(p)):
                a, b = a.cpu(), b.cpu()
                if a.is_floating_point():
                    a, b = a.nan_to_num(0.5) + 0.0, b.nan_to_num(0.5) + 0.0
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"5d {label}: the {stage} launch differs from its "
                        f"plain stage in {name} ({sorted(kinds)})")
            base = p

    slot = 0
    while slot < max_slots and set(found) != set(want):
        iv = rec.ints.tolist()
        if iv[kb.STATUS] != Status.RUNNING or iv[kb.NITER] >= mi:
            break
        for _ in range(K):
            before = kb.clone_record(rec)
            for stage in kb.SLOT_STAGES:
                kb.blocked_stage(rec, stage, opts, stall, mi)
            b, a = before.ints.tolist(), rec.ints.tolist()
            if b[kb.STATUS] == Status.RUNNING:
                pricing = bool(a[kb.DO_PRICING] and a[kb.ACT])
                under_bland = bool(b[kb.BLAND]) or opts.rule == RULE_BLAND
                ties = 0
                if pricing and opts.tie_break == TIE_MAXPIV:
                    col, bv = rec.scratch[2:M], before.bvec[2:]
                    pos = col > opts.piv_tol
                    ratios = torch.where(pos, bv / torch.where(pos, col, 1.0),
                                         float("inf"))
                    ties = int((ratios <= ratios.min()).sum())
                kinds = {
                    "pivot": pricing and not under_bland,
                    "bland": pricing and under_bland,
                    "maxpiv_tie": ties >= 2,
                    "cleanup": bool(a[kb.DO_CLEANUP] and a[kb.ACT]),
                    "retire": bool(a[kb.RETIRE]),
                    "devex_reset": devex and bool(a[kb.TO_PHASE2]),
                    "reset_1e8": devex and bool(
                        rec.scratch[M + N:M + N + G].max() > 1e8),
                    "budget_stop": bool(a[kb.DO_CLEANUP] or a[kb.DO_PRICING])
                    and not a[kb.ACT]}
                new = {k for k, v in kinds.items() if v and k in want
                       and k not in found}
                if new:
                    held(before, kb.SLOT_STAGES, new)
                    for kind in new:
                        found[kind] = slot
            slot += 1
        _, scan = fused_flush(*kb.flush_inputs(rec), float(opts.opt_tol),
                              float(opts.piv_tol))
        iv = rec.ints.tolist()
        new = set()
        if iv[kb.STATUS] == Status.RUNNING and iv[kb.PHASE] == 2:
            kind = "ray_art" if iv[kb.ART_ROW] != kb.BIG_I else "ray_clear"
            if kind in want and kind not in found:
                new = {kind}
        if new:
            held(kb.clone_record(rec), ("ray",), new, scan)
            found.update({kind: slot for kind in new})
        kb.blocked_stage(rec, "ray", opts, stall, mi, scan)
    if set(found) != set(want):
        raise AssertionError(f"5d {label}: no slot of kinds "
                             f"{set(want) - set(found)} in {slot}")
    log(f"# 5d stages, {label} {tuple(state.T.shape)} "
        f"{str(state.T.dtype)[6:]} K={K}: each launch equals its plain "
        "stage on the card (every record field) at slot "
        + ", ".join(f"{s} ({k})" for k, s in sorted(found.items(),
                                                    key=lambda x: x[1])))
    return found


def blocked_slot_us(state, opts, label: str, K: int = BLK5_K):
    """A kernel slot of the walk of ``state``, half a block into its second
    block: device us a slot of a whole block's K slots enqueued by one C
    call (``launches_us``, on a copy of the record at the block's start),
    the host's us to enqueue one, the device us of the cleanup, price,
    column, ratio and row launches alone (32 launches of each on a copy)
    beside the finish, the flush and ray launches a block, and the bound;
    three rounds, medians."""
    import torch

    from tpulp_torch.core import eta_scaled_options
    from tpulp_torch.core.state import RULE_DEVEX
    from tpulp_torch.kernels import blocked as kb
    from tpulp_torch.kernels.block import fused_flush

    opts = eta_scaled_options(opts, state.T.dtype)
    stall = opts.resolved_stall_limit(state.m, state.n)
    mi = opts.max_iters
    rec = kb.make_record(state, K)
    kb.blocked_block(rec, opts, stall, mi)
    start = kb.clone_record(rec)
    kb.enqueue_slots(rec, opts, stall, mi, K // 2)
    steps = 32
    stages = kb.SLOT_STAGES[:-1]
    dev_us, host_us, block_us = [], [], []
    split = {stage: [] for stage in stages}
    for _ in range(3):
        for stage in stages:
            c = kb.clone_record(rec)
            split[stage].append(launches_us(lambda: [
                kb.blocked_stage(c, stage, opts, stall, mi)
                for _ in range(steps)], steps)[0])
        c = kb.clone_record(start)
        d, h = launches_us(lambda: kb.enqueue_slots(c, opts, stall, mi, K),
                           K)
        if int(c.ints[kb.STATUS]) != 0 or int(c.ints[kb.SLOT]) != K:
            raise AssertionError("5d: the timed slots ran past the walk")
        dev_us.append(d)
        host_us.append(h)

        def end():
            _, scan = fused_flush(*kb.flush_inputs(c), float(opts.opt_tol),
                                  float(opts.piv_tol))
            kb.blocked_stage(c, "ray", opts, stall, mi, scan)

        block_us.append(launches_us(end, 1)[0])
    split = {k: float(np.median(v)) for k, v in split.items()}
    dev_us, host_us = float(np.median(dev_us)), float(np.median(host_us))
    split["finish"] = dev_us - sum(split.values())
    M, N = state.T.shape
    bound_ms, bound_by = slot_bound(state, opts, K)
    res = {"device_us_per_slot": dev_us, "host_us_per_slot": host_us,
           "bound_us_per_slot": 1e3 * bound_ms, "bound_by": bound_by,
           "device_us_by_stage": split,
           "flush_and_ray_us_per_block": float(np.median(block_us))}
    log(f"# 5d blocked_step {label} {M}x{N} {str(state.T.dtype)[6:]} K={K}: "
        f"{dev_us:.2f} us a slot on the card (CUDA events over a block of "
        f"{K} slots; " + ", ".join(f"{k} {v:.2f}" for k, v in split.items())
        + f"), {host_us:.2f} us of host time to enqueue one; B1's flush and "
        f"the ray launch {res['flush_and_ray_us_per_block']:.1f} us a block; "
        f"bound {1e3 * bound_ms:.3f} us a slot ({bound_by})")
    return res


def slot_bound(state, opts, K: int = BLK5_K):
    """(bound_ms, bound_by) of a pivot slot of ``blocked_step``, whose six
    launches a slot read their operands from device memory, at the block's
    mean slot index t = (K - 1) / 2: T0's column and row, the t slots of U
    and V written before it, U[t] and V[t] written, row0, row1 (N) and bvec
    (M) read and written, and under devex the weights (N - 1) read and
    written; one fma an entry of each eta sum."""
    from tpulp_torch.core.state import RULE_DEVEX

    M, N = state.T.shape
    size = state.T.element_size()
    t_mean = (K - 1) / 2
    devex = opts.rule == RULE_DEVEX
    nbytes = size * ((M + N) * (2 + t_mean) + 2 * (2 * N + M)
                     + (2 * (N - 1) if devex else 0))
    return bound(nbytes, 2.0 * t_mean * (M + N),
                 FP64_FLOP_S if size == 8 else FP32_FLOP_S)


def cluster_bound(state, opts, K: int = BLK5_K):
    """(bound_ms, bound_by) a slot of one ``blocked_cluster`` launch of K
    slots, which keeps U and V in shared memory for the whole launch: a
    slot reads T0's column and row; the launch loads and stores U and V
    (K (M + N)) once, reads and writes row0, row1 (N), bvec (M), the basis
    (int32, M - 2) and under devex the weights (N - 1) once; divided by K.
    The operations are ``slot_bound``'s: one fma an entry of each eta sum
    at the mean slot index t = (K - 1) / 2."""
    from tpulp_torch.core.state import RULE_DEVEX

    M, N = state.T.shape
    size = state.T.element_size()
    devex = opts.rule == RULE_DEVEX
    launch = size * (2 * K * (M + N) + 2 * (2 * N + M)
                     + (2 * (N - 1) if devex else 0)) + 2 * 4 * (M - 2)
    nbytes = size * (M + N) + launch / K
    return bound(nbytes, 2.0 * (K - 1) / 2 * (M + N),
                 FP64_FLOP_S if size == 8 else FP32_FLOP_S)


def cluster_walk_check(state, opts, label: str, K: int = BLK5_K,
                       window: int | None = BLK5_CLUSTER_WINDOW):
    """``blocked_cluster``'s walk on its plan's cluster (what
    ``run_simplex_blocked`` runs on the card where the plan fits) held
    equal in every field (``T + 0.0``, NaN equal, the devex weights too) to
    ``blocked_cluster_reference`` on the same cluster size, flushed by the
    same B1, and to ``blocked_steps``' walk, over the whole walk or its
    first ``window`` pivots; its launches one ``blocked_cluster``, one B1
    flush and one ray launch a block and nothing else; the two kernels'
    walks timed on the host clock in turns (cluster, step, step, cluster,
    twice). Returns the numbers, and under "plain" the plain version's
    (state, weights)."""
    import dataclasses as dc

    import torch

    from tpulp_torch.core import eta_scaled_options
    from tpulp_torch.kernels import LAUNCHES, reset_launches
    from tpulp_torch.kernels import blocked as kb
    from tpulp_torch.kernels import blocked_cluster as kbc
    from tpulp_torch.kernels.block import fused_flush
    from tpulp_torch.solve.driver import finish

    dt, dev = state.T.dtype, state.T.device
    o = eta_scaled_options(opts, dt)
    if window is not None:
        o = dc.replace(o, max_iters=min(o.max_iters, window))
    stall = o.resolved_stall_limit(state.m, state.n)
    M, N = state.T.shape
    plan = kbc.blocked_cluster_plan(M, N, K, dt)
    occ = kbc.blocked_cluster_occupancy(M, N, K, dt, dev)
    runs = {"cluster": lambda: kbc.blocked_cluster(state, o, stall,
                                                   o.max_iters, K),
            "step": lambda: kb.blocked_steps(state, o, stall, o.max_iters,
                                             K)}
    sync(dev)
    reset_launches()
    k, gk = runs["cluster"]()
    sync(dev)
    launches = dict(LAUNCHES)
    blocks = launches["blocked_cluster"]
    others = {key: v for key, v in launches.items() if v and key not in (
        "blocked_cluster", "blocked_ray", "fused_flush")}
    if others or not blocks or launches["fused_flush"] != blocks or \
            launches["blocked_ray"] != blocks:
        raise AssertionError(f"5d {label}: the cluster walk's launches "
                             f"{launches}")
    sp, gs = runs["step"]()
    sync(dev)
    t0 = time.perf_counter()
    p, gp = kbc.blocked_cluster_reference(state, o, stall, o.max_iters, K,
                                          plan.blocks, flush=fused_flush)
    sync(dev)
    plain_secs = time.perf_counter() - t0
    k, sp, p = finish(k), finish(sp), finish(p)
    err = lanes_equal(k, p)
    lanes_equal(k, sp)
    for g, what in ((gp, "blocked_cluster_reference"),
                    (gs, "blocked_steps")):
        if not torch.equal(gk.cpu() + 0.0, g.cpu() + 0.0):
            raise AssertionError(f"5d {label}: the devex weights differ "
                                 f"from {what}'s")
    host = {"cluster": [], "step": []}
    for name in ("cluster", "step", "step", "cluster") * 2:
        sync(dev)
        t0 = time.perf_counter()
        runs[name]()
        sync(dev)
        host[name].append(time.perf_counter() - t0)
    niter = max(int(k.niter) - int(state.niter), 1)
    res = {"status": int(k.status), "niter": niter, "blocks": blocks,
           "cluster": plan.blocks, "width": plan.width,
           "height": plan.height, "smem": plan.smem, "occupancy": occ,
           "max_abs_err": err,
           "us_per_pivot": 1e6 * float(np.median(host["cluster"])) / niter,
           "step_us_per_pivot": 1e6 * float(np.median(host["step"])) / niter,
           "plain_ms_per_pivot": 1e3 * plain_secs / niter,
           "window": window, "plain": (p, gp)}
    log(f"# 5d {label} {M}x{N} {str(dt)[6:]} K={K}: blocked_cluster on "
        f"{plan.blocks} blocks ({plan.width} columns, {plan.height} rows, "
        f"{plan.smem} bytes of shared memory a block; "
        f"cudaOccupancyMaxActiveClusters {occ}), {blocks} launches: its walk"
        f" equals blocked_cluster_reference and blocked_steps' walk in every"
        f" field (status {res['status']}, {niter} pivots"
        + (f", the first {window}" if window else "")
        + f"); {res['us_per_pivot']:.2f} us a pivot on the host clock, "
        f"blocked_step {res['step_us_per_pivot']:.2f} in turns; the plain "
        f"version {res['plain_ms_per_pivot']:.3f} ms a pivot")
    return res


def cluster_slot_us(state, opts, label: str, K: int = BLK5_K):
    """A cluster launch of the walk of ``state``, its second block: device
    us a slot (CUDA events after a sleep over the launch of a block's K
    slots, on a copy of the record at the block's start), the host's us to
    launch it, the stage split (block 0's clock, as shares of the launch),
    B1 and the ray launch a block, and the slot's bound; three rounds,
    medians."""
    import torch

    from tpulp_torch.core import eta_scaled_options
    from tpulp_torch.kernels import blocked as kb
    from tpulp_torch.kernels import blocked_cluster as kbc

    o = eta_scaled_options(opts, state.T.dtype)
    stall = o.resolved_stall_limit(state.m, state.n)
    mi = o.max_iters
    rec = kb.make_record(state, K)
    kbc.blocked_cluster_block(rec, o, stall, mi)
    kb.flush_and_ray(rec, o, stall, mi)
    start = kb.clone_record(rec)
    dev_us, host_us, block_us = [], [], []
    for _ in range(3):
        c = kb.clone_record(start)
        d, h = launches_us(lambda: kbc.blocked_cluster_block(c, o, stall,
                                                             mi), K)
        if int(c.ints[kb.STATUS]) != 0 or int(c.ints[kb.SLOT]) != K:
            raise AssertionError("5d: the timed slots ran past the walk")
        dev_us.append(d)
        host_us.append(h)
        block_us.append(launches_us(lambda: kb.flush_and_ray(c, o, stall,
                                                             mi), 1)[0])
    cyc = torch.zeros((len(kbc.BLOCKED_CLUSTER_STAGES),), dtype=torch.int64,
                      device=state.T.device)
    kbc.blocked_cluster_block(kb.clone_record(start), o, stall, mi,
                              stage_cycles=cyc)
    share = (cyc.double() / cyc.sum().double().clamp_min(1)).tolist()
    dev_us, host_us = float(np.median(dev_us)), float(np.median(host_us))
    split = {name: dev_us * f for name, f in
             zip(kbc.BLOCKED_CLUSTER_STAGES, share)}
    bound_ms, bound_by = cluster_bound(state, opts, K)
    M, N = state.T.shape
    res = {"device_us_per_slot": dev_us, "host_us_per_slot": host_us,
           "bound_us_per_slot": 1e3 * bound_ms, "bound_by": bound_by,
           "device_us_by_stage": split,
           "flush_and_ray_us_per_block": float(np.median(block_us))}
    log(f"# 5d blocked_cluster {label} {M}x{N} {str(state.T.dtype)[6:]} "
        f"K={K}: {dev_us:.2f} us a slot on the card (CUDA events over one "
        f"launch of {K} slots; block 0's clock: "
        + ", ".join(f"{k} {v:.2f}" for k, v in split.items())
        + f"), {host_us:.3f} us of host time a slot to launch; B1's flush "
        f"and the ray launch {res['flush_and_ray_us_per_block']:.1f} us a "
        f"block; bound {1e3 * bound_ms:.3f} us a slot ({bound_by})")
    return res


def cluster_edge_walks(dt, sf_a, sf_d, sf_r, a_walk, dev="cuda"):
    """``blocked_cluster`` at every cluster size whose plan holds the LP
    (1, 2, 4, 8, 16; the plan's own among them, and a size whose plan fits
    but the card holds no such cluster fails) held in every field against
    ``blocked_cluster_reference``: (a)'s LP to a budget that stops inside a
    block (BLK5_BUDGET) and to the budget of its walk's last pivot (inside
    a block: the slot past it still ends the walk, OPTIMAL; held to the
    plain version of the whole walk, ``a_walk``'s, which it equals), the
    clean-up LP under devex with largest-pivot ties (K = 16:
    the clean-up pivots, a retire, the phase change with devex's reset, the
    ray launch's gate with an artificial basic and without), and devex's
    first pivot on 2e-4 (the 1e8 reset). Returns {walk: numbers}."""
    import dataclasses as dc

    import torch

    from tpulp_torch import SolverOptions
    from tpulp_torch.core import Status, eta_scaled_options
    from tpulp_torch.core.state import RULE_DEVEX, TIE_MAXPIV
    from tpulp_torch.kernels import blocked_cluster as kbc
    from tpulp_torch.kernels.block import fused_flush
    from tpulp_torch.solve.api import state_from_standard_form
    from tpulp_torch.solve.driver import finish

    plain = SolverOptions.for_dtype(dt)
    devex = SolverOptions.for_dtype(dt, rule=RULE_DEVEX)
    cases = {
        "budget_inside_a_block": (sf_a, plain, BLK5_K, BLK5_BUDGET),
        "slot_past_the_budget": (sf_a, plain, BLK5_K, a_walk["niter"]),
        "cleanup_retire_devex_reset_ray_gate": (
            sf_d, dc.replace(devex, tie_break=TIE_MAXPIV), BLK5_STAGE_K,
            None),
        "reset_1e8": (sf_r, devex, BLK5_STAGE_K, None)}
    out = {}
    for name, (sf, opts, K, budget) in cases.items():
        st = state_from_standard_form(sf, dtype=dt, device=dev)
        o = eta_scaled_options(opts, dt)
        if budget is not None:
            o = dc.replace(o, max_iters=budget)
        stall = o.resolved_stall_limit(st.m, st.n)
        M, N = st.T.shape
        plan = kbc.blocked_cluster_plan(M, N, K, dt)
        if name == "slot_past_the_budget":
            p, gp = a_walk["plain"]
        else:
            p, gp = kbc.blocked_cluster_reference(
                st, o, stall, o.max_iters, K, plan.blocks, flush=fused_flush)
            p = finish(p)
        sizes = []
        for C in kbc.BLOCKED_CLUSTER_SIZES:
            try:
                kbc.blocked_cluster_plan(M, N, K, dt, C)
            except ValueError:
                continue
            occ = kbc.blocked_cluster_occupancy(M, N, K, dt, st.T.device,
                                                C)
            if occ < 1:
                raise AssertionError(f"5d edge walk {name}: the card holds "
                                     f"no cluster of {C} blocks whose plan "
                                     f"fits ({occ})")
            k, gk = kbc.blocked_cluster(st, o, stall, o.max_iters, K,
                                        blocks=C)
            sync(dev)
            lanes_equal(finish(k), p)
            if not torch.equal(gk.cpu() + 0.0, gp.cpu() + 0.0):
                raise AssertionError(f"5d edge walk {name} C={C}: the devex "
                                     "weights differ")
            sizes.append(C)
        if plan.blocks not in sizes:
            raise AssertionError(f"5d edge walk {name}: the plan's cluster "
                                 f"of {plan.blocks} did not run ({sizes})")
        status, niter = int(p.status), int(p.niter)
        if name == "budget_inside_a_block" and (
                niter != budget or status != Status.ITERATION_LIMIT):
            raise AssertionError(f"5d edge walk {name}: {status}, {niter}")
        if name == "slot_past_the_budget" and (
                niter != budget or status != Status.OPTIMAL
                or budget % K == 0):
            raise AssertionError(f"5d edge walk {name}: {status}, {niter}, "
                                 f"budget {budget}")
        out[name] = {"status": status, "niter": niter, "K": K,
                     "sizes": sizes, "shape": [M, N]}
    log(f"# 5d blocked_cluster edge walks, {str(dt)[6:]}: each equals "
        "blocked_cluster_reference in every field at every cluster size "
        "that holds it: " + "; ".join(
            f"{k} {tuple(v['shape'])} K={v['K']} (status {v['status']}, "
            f"{v['niter']} pivots; C {v['sizes']})" for k, v in out.items()))
    return out


def grid_walk_blocked(state, opts, K: int = BLK5_K, max_iters=None,
                      **kw):
    """``blocked_grid``'s walk of ``state`` (eta-scaled ``opts``):
    (finished state, weights)."""
    from tpulp_torch.kernels import blocked_grid as kg
    from tpulp_torch.solve.driver import finish

    stall = opts.resolved_stall_limit(state.m, state.n)
    s, g = kg.blocked_grid(state, opts, stall, opts.max_iters if max_iters
                           is None else max_iters, K, **kw)
    return finish(s), g


def blocked_grid_check(state, opts, label: str, K: int = BLK5_K,
                       window: int = BLK5_WIDE_WINDOW):
    """5d (g): ``blocked_grid``'s walk on its plan's grid (what
    ``run_simplex_blocked`` runs on the card past the cluster's plan) held
    equal in every field (``T + 0.0``, NaN equal, the devex weights too) to
    ``blocked_steps``' whole walk, and over its first ``window`` pivots to
    ``blocked_grid_reference`` on the card (the plan's G, flushed by the
    same B1); its launches one ``blocked_grid``, one B1 flush and one ray
    launch a block and nothing else; the two kernels' whole walks timed on
    the host clock in turns (grid, step, step, grid, twice). Returns the
    numbers."""
    import dataclasses as dc

    import torch

    from tpulp_torch.core import eta_scaled_options
    from tpulp_torch.kernels import LAUNCHES, reset_launches
    from tpulp_torch.kernels import blocked as kb
    from tpulp_torch.kernels import blocked_grid as kg
    from tpulp_torch.kernels.block import fused_flush
    from tpulp_torch.kernels.launch import sm_count
    from tpulp_torch.solve.driver import finish

    dt, dev = state.T.dtype, state.T.device
    o = eta_scaled_options(opts, dt)
    stall = o.resolved_stall_limit(state.m, state.n)
    M, N = state.T.shape
    plan = kg.blocked_grid_plan(M, N, K, dt, sm_count(dev))
    occ = kg.blocked_grid_occupancy(M, N, K, dt, dev)
    runs = {"grid": lambda: grid_walk_blocked(state, o, K),
            "step": lambda: kb.blocked_steps(state, o, stall, o.max_iters,
                                             K)}
    sync(dev)
    reset_launches()
    k, gk = runs["grid"]()
    sync(dev)
    launches = dict(LAUNCHES)
    blocks = launches["blocked_grid"]
    others = {key: v for key, v in launches.items() if v and key not in (
        "blocked_grid", "blocked_ray", "fused_flush")}
    if others or not blocks or launches["fused_flush"] != blocks or \
            launches["blocked_ray"] != blocks:
        raise AssertionError(f"5d {label}: the grid walk's launches "
                             f"{launches}")
    sp, gs = runs["step"]()
    sync(dev)
    err = lanes_equal(k, finish(sp))
    if not torch.equal(gk.cpu() + 0.0, gs.cpu() + 0.0):
        raise AssertionError(f"5d {label}: the devex weights differ from "
                             "blocked_steps'")
    # the window against the plain version
    ow = dc.replace(o, max_iters=min(o.max_iters, int(state.niter) + window))
    kw_, gkw = grid_walk_blocked(state, ow, K)
    sync(dev)
    t0 = time.perf_counter()
    pw, gpw = kg.blocked_grid_reference(state, ow, stall, ow.max_iters, K,
                                        plan.blocks, flush=fused_flush)
    sync(dev)
    plain_secs = time.perf_counter() - t0
    err = max(err, lanes_equal(kw_, finish(pw)))
    if not torch.equal(gkw.cpu() + 0.0, gpw.cpu() + 0.0):
        raise AssertionError(f"5d {label}: the devex weights differ from "
                             "blocked_grid_reference's")
    wsteps = max(int(pw.niter) - int(state.niter), 1)
    host = {"grid": [], "step": []}
    for name in ("grid", "step", "step", "grid") * 2:
        sync(dev)
        t0 = time.perf_counter()
        runs[name]()
        sync(dev)
        host[name].append(time.perf_counter() - t0)
    niter = max(int(k.niter) - int(state.niter), 1)
    res = {"status": int(k.status), "niter": niter, "blocks": blocks,
           "grid": plan.blocks, "width": plan.width, "height": plan.height,
           "smem": plan.smem, "mail": plan.mail, "occupancy": occ,
           "max_abs_err": err, "window": wsteps,
           "walk_seconds": float(np.median(host["grid"])),
           "step_walk_seconds": float(np.median(host["step"])),
           "us_per_pivot": 1e6 * float(np.median(host["grid"])) / niter,
           "step_us_per_pivot": 1e6 * float(np.median(host["step"])) / niter,
           "plain_ms_per_pivot": 1e3 * plain_secs / wsteps}
    log(f"# 5d {label} {M}x{N} {str(dt)[6:]} K={K}: blocked_grid on "
        f"{plan.blocks} blocks ({plan.width} columns, {plan.height} rows, "
        f"{plan.smem} bytes of shared memory a block, {plan.mail} bytes of "
        f"mailboxes; occupancy {occ} a block an SM), {blocks} launches: its "
        f"walk equals blocked_steps' whole walk in every field (status "
        f"{res['status']}, {niter} pivots) and its first {wsteps} pivots "
        f"blocked_grid_reference's; {res['us_per_pivot']:.2f} us a pivot on "
        f"the host clock, blocked_step {res['step_us_per_pivot']:.2f} in "
        f"turns; the plain version {res['plain_ms_per_pivot']:.3f} ms a "
        "pivot")
    return res


def grid_slot_bound(state, K: int, G: int, clock_hz: float):
    """The kernel's own convention for a ``blocked_grid`` slot, ms: T0's
    column and row read through 3.35 TB/s, the launch's load and store of U
    and V (K (M + N)) and of the running vectors through 3.35 TB/s divided
    by K, and the eta sums' U and V entries (t + 1) (M + N) at the mean slot
    t = (K - 1) / 2 read from shared memory at 128 bytes a clock on the G
    SMs used."""
    M, N = state.T.shape
    es = state.T.element_size()
    hbm = es * (M + N) + es * (2 * K * (M + N) + 2 * (2 * N + M)) / K
    smem = es * ((K - 1) / 2 + 1) * (M + N)
    return 1e3 * (hbm / HBM_BYTES_S + smem / (128 * G * clock_hz))


def grid_slot_us(state, opts, label: str, clock_hz: float,
                 K: int = BLK5_K):
    """One ``blocked_grid`` launch of the walk's second block (K slots, on
    a copy of the record at the block's start) on the card alone, in turns
    with ``blocked_step``'s K slots enqueued from the same record (grid,
    step, step, grid; CUDA events after a sleep that covers the host's
    enqueue): device us a slot of each, the grid's host us to launch, its
    stage split (block 0's cycles as shares of the launch), the plan and
    occupancy, and the slot's bounds: the table's step convention
    (``slot_bound``), the contract's (``cluster_bound``: each input read
    once a launch) and the kernel's own (``grid_slot_bound``)."""
    import torch

    from tpulp_torch.core import eta_scaled_options
    from tpulp_torch.kernels import blocked as kb
    from tpulp_torch.kernels import blocked_grid as kg
    from tpulp_torch.kernels.launch import sm_count

    o = eta_scaled_options(opts, state.T.dtype)
    stall = o.resolved_stall_limit(state.m, state.n)
    mi = o.max_iters
    dev = state.T.device
    M, N = state.T.shape
    plan = kg.blocked_grid_plan(M, N, K, state.T.dtype, sm_count(dev))
    work = kg.blocked_grid_work(plan, dev)
    rec = kb.make_record(state, K)
    kg.blocked_grid_block(rec, o, stall, mi, work=work)
    kb.flush_and_ray(rec, o, stall, mi)
    start = kb.clone_record(rec)
    grid_us, step_us, host_us = [], [], []
    for kind in ("grid", "step", "step", "grid") * 2:
        c = kb.clone_record(start)
        if kind == "grid":
            d, h = launches_us(lambda: kg.blocked_grid_block(
                c, o, stall, mi, work=work), K)
            grid_us.append(d)
            host_us.append(h)
        else:
            step_us.append(launches_us(lambda: kb.enqueue_slots(
                c, o, stall, mi, K), K)[0])
        if int(c.ints[kb.STATUS]) != 0 or int(c.ints[kb.SLOT]) != K:
            raise AssertionError("5d: the timed slots ran past the walk")
    cyc = torch.zeros((len(kg.BLOCKED_GRID_STAGES),), dtype=torch.int64,
                      device=dev)
    kg.blocked_grid_block(kb.clone_record(start), o, stall, mi,
                          stage_cycles=cyc, work=work)
    share = (cyc.double() / cyc.sum().double().clamp_min(1)).tolist()
    us = float(np.mean(grid_us))
    split = {name: us * f for name, f in zip(kg.BLOCKED_GRID_STAGES, share)}
    step_ms, step_by = slot_bound(state, opts, K)
    bound_ms, bound_by = cluster_bound(state, opts, K)
    own_ms = grid_slot_bound(state, K, plan.blocks, clock_hz)
    res = {"device_us_per_slot": us, "device_us_turns": grid_us,
           "step_device_us_per_slot": float(np.mean(step_us)),
           "step_device_us_turns": step_us,
           "host_us_per_slot": float(np.median(host_us)),
           "device_us_by_stage": split, "blocks": plan.blocks,
           "width": plan.width, "height": plan.height, "smem": plan.smem,
           "occupancy": kg.blocked_grid_occupancy(M, N, K, state.T.dtype,
                                                  dev),
           "bound_us_per_slot": 1e3 * bound_ms, "bound_by": bound_by,
           "step_bound_us_per_slot": 1e3 * step_ms,
           "grid_bound_us_per_slot": 1e3 * own_ms, "sm_clock_hz": clock_hz}
    log(f"# 5d blocked_grid {label} {M}x{N} {str(state.T.dtype)[6:]} "
        f"K={K}: {us:.2f} us a slot on the card (CUDA events over one launch "
        f"of {K} slots, in turns: {[round(x, 3) for x in grid_us]}), "
        f"blocked_step {res['step_device_us_per_slot']:.2f} "
        f"({[round(x, 3) for x in step_us]}); block 0's clock: "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
        + f"; {res['host_us_per_slot']:.3f} us of host time a slot to "
        f"launch; G {plan.blocks}, W {plan.width}, H {plan.height}, "
        f"{plan.smem} bytes of shared memory a block, occupancy "
        f"{res['occupancy']}; bounds a slot: {1e3 * bound_ms:.4f} us "
        f"({bound_by}, each input once a launch), {1e3 * own_ms:.4f} us (the "
        f"kernel's convention), {1e3 * step_ms:.3f} us (the table's step "
        "convention)")
    return res


def grid_vs_cluster_us(state, opts, label: str, K: int = BLK5_K):
    """At a shape both hold ((a)'s 514 x 1537): one ``blocked_grid`` launch
    and one ``blocked_cluster`` launch of the walk's second block on the
    card alone, in turns (cluster, grid, grid, cluster, twice; CUDA events
    after a sleep, one untimed launch of each first): device us a slot of
    each, and the two blocks equal."""
    from tpulp_torch.core import eta_scaled_options
    from tpulp_torch.kernels import blocked as kb
    from tpulp_torch.kernels import blocked_cluster as kbc
    from tpulp_torch.kernels import blocked_grid as kg
    from tpulp_torch.kernels.launch import sm_count

    o = eta_scaled_options(opts, state.T.dtype)
    stall = o.resolved_stall_limit(state.m, state.n)
    mi = o.max_iters
    dev = state.T.device
    M, N = state.T.shape
    plan = kg.blocked_grid_plan(M, N, K, state.T.dtype, sm_count(dev))
    work = kg.blocked_grid_work(plan, dev)
    rec = kb.make_record(state, K)
    kbc.blocked_cluster_block(rec, o, stall, mi)
    kb.flush_and_ray(rec, o, stall, mi)
    start = kb.clone_record(rec)
    # one untimed launch of each first (the grid's first launch at a plan
    # raises its shared-memory limit)
    for fn in (lambda c: kg.blocked_grid_block(c, o, stall, mi, work=work),
               lambda c: kbc.blocked_cluster_block(c, o, stall, mi)):
        fn(kb.clone_record(start))
    out = {"grid": [], "cluster": []}
    ends = {}
    for kind in ("cluster", "grid", "grid", "cluster") * 2:
        c = kb.clone_record(start)
        fn = (lambda: kg.blocked_grid_block(c, o, stall, mi, work=work)) \
            if kind == "grid" else \
            (lambda: kbc.blocked_cluster_block(c, o, stall, mi))
        out[kind].append(launches_us(fn, K)[0])
        ends[kind] = c
        if int(c.ints[kb.STATUS]) != 0 or int(c.ints[kb.SLOT]) != K:
            raise AssertionError("5d: the timed slots ran past the walk")
    for name, a, b in zip(kb.BlockedRecord._fields, ends["grid"],
                          ends["cluster"]):
        if name not in ("scratch", "ints") and not raw_equal(
                a + 0.0 if a.is_floating_point() else a,
                b + 0.0 if b.is_floating_point() else b):
            raise AssertionError(f"5d {label}: the grid's block and the "
                                 f"cluster's differ in {name}")
    res = {"grid_us_per_slot": float(np.mean(out["grid"])),
           "cluster_us_per_slot": float(np.mean(out["cluster"])),
           "grid_turns": out["grid"], "cluster_turns": out["cluster"],
           "grid": plan.blocks}
    log(f"# 5d {label} {M}x{N} {str(state.T.dtype)[6:]} K={K}, one launch "
        f"of the second block in turns: blocked_grid "
        f"{res['grid_us_per_slot']:.2f} us a slot on the card "
        f"({[round(x, 3) for x in out['grid']]}; G {plan.blocks}), "
        f"blocked_cluster {res['cluster_us_per_slot']:.2f} "
        f"({[round(x, 3) for x in out['cluster']]}); the two blocks equal")
    return res


def blocked_grid_edge_walks(dt, sf_d, sf_r, dev="cuda"):
    """``blocked_grid`` on grids of 1, 2, 3, 7 blocks and the plan's held in
    every field against ``blocked_grid_reference`` on the card (the plan's
    G, flushed by the same B1): the clean-up LP under devex with
    largest-pivot ties (K = 16: the clean-up pivots, barrier C, a retire,
    the phase change with devex's reset, the ray launch's gate with an
    artificial basic and without), devex's first pivot on 2e-4 (K = 16: the
    1e8 reset, its pick under unit weights), and on a 64 x 128 LP (K = 8)
    Bland's walk to BLK5_GRID_BLAND pivots, a budget inside a block and the
    budget of the walk's last pivot (the slot past it still ends the walk).
    Returns {walk: numbers}."""
    import dataclasses as dc

    import torch

    from tpulp_torch import SolverOptions
    from tpulp_torch.core import Status, eta_scaled_options
    from tpulp_torch.core.state import RULE_BLAND, RULE_DEVEX, TIE_MAXPIV
    from tpulp_torch.kernels import blocked_grid as kg
    from tpulp_torch.kernels.block import fused_flush
    from tpulp_torch.kernels.launch import sm_count
    from tpulp_torch.solve.api import state_from_standard_form
    from tpulp_torch.solve.driver import finish

    plain = SolverOptions.for_dtype(dt)
    devex = SolverOptions.for_dtype(dt, rule=RULE_DEVEX)
    # a walk of a few blocks (66 x 193: 27 pivots under Dantzig at f64)
    sf_s = scenario_form(*dense_leq_arrays(64, 128, seed=3))
    st_s = state_from_standard_form(sf_s, dtype=dt, device=dev)
    last = int(grid_walk_blocked(st_s, eta_scaled_options(plain, dt),
                                 8)[0].niter)
    cases = {
        "cleanup_retire_devex_reset_ray_gate": (
            sf_d, dc.replace(devex, tie_break=TIE_MAXPIV), BLK5_STAGE_K,
            None),
        "reset_1e8": (sf_r, devex, BLK5_STAGE_K, None),
        "bland": (sf_s, SolverOptions.for_dtype(dt, rule=RULE_BLAND), 8,
                  BLK5_GRID_BLAND),
        "budget_inside_a_block": (sf_s, plain, 8, 13),
        "slot_past_the_budget": (sf_s, plain, 8, last)}
    out = {}
    for name, (sf, opts, K, budget) in cases.items():
        st = state_from_standard_form(sf, dtype=dt, device=dev)
        o = eta_scaled_options(opts, dt)
        if budget is not None:
            o = dc.replace(o, max_iters=budget)
        stall = o.resolved_stall_limit(st.m, st.n)
        M, N = st.T.shape
        G = kg.blocked_grid_plan(M, N, K, dt, sm_count(st.T.device)).blocks
        p, gp = kg.blocked_grid_reference(st, o, stall, o.max_iters, K, G,
                                          flush=fused_flush)
        p = finish(p)
        for blocks in (1, 2, 3, 7, None):
            k, gk = grid_walk_blocked(st, o, K, blocks=blocks)
            sync(dev)
            lanes_equal(k, p)
            if not torch.equal(gk.cpu() + 0.0, gp.cpu() + 0.0):
                raise AssertionError(f"5d grid edge walk {name} G={blocks}: "
                                     "the devex weights differ")
        status, niter = int(p.status), int(p.niter)
        if name == "budget_inside_a_block" and (
                niter != budget or status != Status.ITERATION_LIMIT):
            raise AssertionError(f"5d grid edge walk {name}: {status}, "
                                 f"{niter}")
        if name == "slot_past_the_budget" and (
                niter != budget or status != Status.OPTIMAL
                or budget % K == 0):
            raise AssertionError(f"5d grid edge walk {name}: {status}, "
                                 f"{niter}, budget {budget}")
        out[name] = {"status": status, "niter": niter, "K": K,
                     "grids": [1, 2, 3, 7, G], "shape": [M, N]}
    log(f"# 5d blocked_grid edge walks, {str(dt)[6:]}: each equals "
        "blocked_grid_reference in every field on grids of 1, 2, 3, 7 and the"
        " plan's: " + "; ".join(
            f"{k} {tuple(v['shape'])} K={v['K']} (status {v['status']}, "
            f"{v['niter']} pivots; plan G {v['grids'][-1]})"
            for k, v in out.items()))
    return out


def past_grid_blocked(dev="cuda"):
    """5d (p): (g)'s wide LP in blocks of BLK5_PAST_K slots, past the grid's
    plan (its slabs pass a block's shared memory): ``run_simplex_blocked``
    runs ``blocked_step`` (counts set to 0 just before it, read just after:
    slots, no ``blocked_grid``) to a budget of BLK5_PAST_BUDGET pivots, its
    walk held in every field to the plain-stage walk flushed by the same
    B1, and its slots timed on the card (the first BLK5_PAST_TIMED slots
    enqueued by one C call, CUDA events after a sleep), with the table's
    step bound at their mean slot."""
    import dataclasses as dc

    import torch

    from tpulp_torch import SolverOptions
    from tpulp_torch.core import eta_scaled_options
    from tpulp_torch.kernels import LAUNCHES, reset_launches
    from tpulp_torch.kernels import blocked as kb
    from tpulp_torch.kernels import blocked_grid as kg
    from tpulp_torch.kernels.launch import sm_count
    from tpulp_torch.solve import run_simplex_blocked
    from tpulp_torch.solve.api import state_from_standard_form
    from tpulp_torch.solve.blocked import blocked_route

    dt = torch.float64
    Aw, bw, cw = dense_leq_arrays(BLK5_WIDE_M, BLK5_WIDE_N, seed=2)
    st = state_from_standard_form(scenario_form(Aw, bw, cw), dtype=dt,
                                  device=dev)
    M, N = st.T.shape
    K = BLK5_PAST_K
    try:
        kg.blocked_grid_plan(M, N, K, dt, sm_count(st.T.device))
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError(f"5d (p): the grid's plan holds K = {K}")
    if blocked_route(M, N, K, dt, st.T.device) != "blocked_step":
        raise AssertionError(f"5d (p): {M} x {N} K={K} is not on "
                             "blocked_step's route")
    o = eta_scaled_options(dc.replace(SolverOptions.for_dtype(dt),
                                      max_iters=BLK5_PAST_BUDGET), dt)
    sync(dev)
    reset_launches()
    t0 = time.perf_counter()
    k = run_simplex_blocked(st, o, K)
    sync(dev)
    secs = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    if launches["blocked_grid"] or launches["blocked_cluster"] or \
            launches["blocked_step"] != K * launches["blocked_ray"] or \
            not launches["blocked_step"]:
        raise AssertionError(f"5d (p): launches {launches}")
    p, _, plain_secs = blocked_plain(st, o, K)
    err = lanes_equal(k, p)
    niter = max(int(k.niter), 1)
    stall = o.resolved_stall_limit(st.m, st.n)
    rec = kb.make_record(st, K)
    dev_us, host_us = [], []
    for _ in range(3):
        c = kb.clone_record(rec)
        d, h = launches_us(lambda: kb.enqueue_slots(
            c, o, stall, o.max_iters, BLK5_PAST_TIMED), BLK5_PAST_TIMED)
        dev_us.append(d)
        host_us.append(h)
    # the table's step convention at the timed slots' mean slot index
    bound_ms, bound_by = slot_bound(st, o, BLK5_PAST_TIMED)
    res = {"launches": launches, "status": int(k.status), "niter": niter,
           "seconds": secs, "plain_seconds": plain_secs,
           "max_abs_err": err, "ms_per_pivot": 1e3 * secs / niter,
           "plain_ms_per_pivot": 1e3 * plain_secs / niter,
           "device_us_per_slot": float(np.median(dev_us)),
           "host_us_per_slot": float(np.median(host_us)),
           "bound_us_per_slot": 1e3 * bound_ms, "bound_by": bound_by,
           "timed_slots": BLK5_PAST_TIMED, "K": K, "refused": refused}
    log(f"# 5d (p) {M}x{N} f64 K={K}, past the grid's plan ({refused}): "
        f"run_simplex_blocked runs blocked_step (launches {launches}), "
        f"{niter} pivots to the budget in {1e3 * secs:.1f} ms, equal to the "
        f"plain-stage walk in every field; {res['device_us_per_slot']:.2f} "
        f"us a slot on the card over its first {BLK5_PAST_TIMED} slots "
        f"({res['host_us_per_slot']:.2f} us of host time to enqueue one); "
        f"bound {1e3 * bound_ms:.4f} us a slot ({bound_by})")
    return res


def blocked_flush_case(state, K: int = BLK5_K):
    """B1 at the blocked engine's shape: the flush of the walk's first
    block of K slots against its plain version, with ``addmm`` beside
    it."""
    from tpulp_torch.core import eta_scaled_options
    from tpulp_torch.core import SolverOptions
    from tpulp_torch.kernels import blocked as kb

    opts = eta_scaled_options(SolverOptions.for_dtype(state.T.dtype),
                              state.T.dtype)
    stall = opts.resolved_stall_limit(state.m, state.n)
    rec = kb.make_record(state, K)
    kb.enqueue_slots(rec, opts, stall, opts.max_iters, K)
    T, U, V, ca = kb.flush_inputs(rec)
    return check_flush(T.clone(), U, V, ca, opts.opt_tol, opts.piv_tol,
                       str(state.T.dtype)[6:], RUNS)


def threshold_table(dev="cuda"):
    """5d (f): us a pivot of the rank-1 walk on its route
    (``rank1_cluster``, ``rank1_grid``) and on ``rank1_step``, the blocked
    engine on its route (``blocked_cluster`` where its plan fits), on
    ``blocked_step`` and the kernel engine on bench.py's recipe at each of
    THRESH_SHAPES, f64, over THRESH_PIVOTS pivots (the better of two runs,
    host clock): the data for the `auto` thresholds, which stay as they
    are."""
    import torch

    from tpulp_torch import SolverOptions, make_state
    from tpulp_torch.core import eta_scaled_options
    from tpulp_torch.kernels.blocked import blocked_steps
    from tpulp_torch.kernels.launch import sm_count
    from tpulp_torch.kernels.rank1 import rank1_steps
    from tpulp_torch.solve import (run_simplex, run_simplex_blocked,
                                   run_simplex_blocked_kernel)
    from tpulp_torch.solve.blocked import blocked_route
    from tpulp_torch.solve.driver import finish, solo_route

    def on_steps(s, o):
        o = eta_scaled_options(o, s.T.dtype)
        out, _ = blocked_steps(s, o, o.resolved_stall_limit(s.m, s.n),
                               o.max_iters, BLK5_K)
        return finish(out)

    def on_rank1_steps(s, o):
        out, _ = rank1_steps(s, o, o.resolved_stall_limit(s.m, s.n),
                             o.max_iters)
        return finish(out)

    engines = {"rank1": lambda s, o: run_simplex(s, o),
               "rank1_step": on_rank1_steps,
               "blocked": lambda s, o: run_simplex_blocked(s, o, BLK5_K),
               "blocked_step": on_steps,
               "kernel": lambda s, o: run_simplex_blocked_kernel(
                   s, o, max(BLK5_K, 128))}
    table = {}
    for m, n in THRESH_SHAPES:
        st = make_state(*bench_arrays(m, n), dtype=torch.float64,
                        device=dev)
        opts = SolverOptions.for_dtype(torch.float64,
                                       max_iters=THRESH_PIVOTS)
        row = {}
        for name, run in engines.items():
            best = None
            for _ in range(2):
                sync(dev)
                t0 = time.perf_counter()
                out = run(st, opts)
                sync(dev)
                secs = time.perf_counter() - t0
                niter = int(out.niter)
                us = 1e6 * secs / max(niter, 1)
                if best is None or us < best["us_per_pivot"]:
                    best = {"us_per_pivot": us, "niter": niter,
                            "status": int(out.status)}
            row[name] = best
        key = f"{m + 2}x{n + m + 1}"
        row["blocked_route"] = blocked_route(m + 2, n + m + 1, BLK5_K,
                                             torch.float64, st.T.device)
        row["rank1_route"] = solo_route("primal", m + 2, n + m + 1,
                                        torch.float64, sm_count(st.T.device))
        table[key] = row
        log(f"# 5d (f) {key} f64 ({(m + 2) * (n + m + 1)} elements), "
            f"{THRESH_PIVOTS} pivots: " + ", ".join(
                f"{k} {v['us_per_pivot']:.1f} us a pivot ({v['niter']})"
                for k, v in row.items() if not k.endswith("_route"))
            + f"; the blocked engine's route {row['blocked_route']}, the "
            f"rank-1 walk's {row['rank1_route']}")
        del st
        torch.cuda.empty_cache()
    return table


def blocked_solve(sf, dt, driver: str, label: str, optimal: bool = True,
                  dev="cuda", route: str = "blocked_cluster"):
    """``solve_lp`` with the launch counts set to 0 just before it and read
    just after: the blocked engine's kernels on ``route`` launched (one
    ``blocked_cluster`` or ``blocked_grid`` launch a block, or
    ``blocked_step`` slots), one ray launch and one B1 flush a block,
    nothing of the other routes, no FMA, no B2; with ``optimal`` the answer
    optimal and certified (``float_basis_certificate``)."""
    import tpulp_torch
    from tpulp_torch.kernels import LAUNCHES, reset_launches
    from tpulp_torch.solve.refine import float_basis_certificate

    sync(dev)
    reset_launches()
    t0 = time.perf_counter()
    sol = tpulp_torch.solve_lp(sf, dtype=dt, device=dev, driver=driver)
    sync(dev)
    secs = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    log(f"# 5d solve_lp {label} {str(dt)[6:]} (driver={driver!r}): "
        f"{sol.status}, rung {sol.rung}, {sol.niter} pivots, objective "
        f"{sol.objective!r}, {secs:.2f} s; launches {launches}")
    others = [r for r in ("blocked_cluster", "blocked_grid",
                          "blocked_step") if r != route]
    blocks = launches["blocked_ray"]
    if not (launches[route] > 0 and not any(launches[r] for r in others)
            and launches["fused_fma"] == 0
            and launches["blocked_inner_block"] == 0
            and launches["fused_flush"] == blocks > 0
            and (route == "blocked_step" or launches[route] == blocks)):
        raise AssertionError(f"5d {label}: launches {launches}, want "
                             f"{route} (one launch a block for the cluster "
                             "and the grid), one B1 flush and one ray launch "
                             f"a block, none of {others}, no FMA, no B2")
    out = {"status": sol.status, "rung": sol.rung, "niter": sol.niter,
           "seconds": secs, "launches": launches, "route": route,
           "objective": str(sol.objective)}
    if optimal:
        if sol.status != "optimal":
            raise AssertionError(f"5d {label}: {sol.status}")
        primal_ok, dual_ok = float_basis_certificate(sf, sol.basis)
        if not (primal_ok and dual_ok):
            raise AssertionError(f"5d {label}: float_basis_certificate "
                                 f"({primal_ok}, {dual_ok})")
        out["certified"] = True
    return sol, out


def eager_solve(sol, sf, dt, driver: str, label: str, out: dict,
                dev="cuda", same_walk: bool = True):
    """The same ``solve_lp`` with the blocked engine's eager loop
    (``run_simplex_blocked_reference``) in place of its kernels, in the
    solve and in the refreshed rung's segments. Where the two walk the
    same pivots at f64 (``same_walk``) the status and objective must be
    ``sol``'s exactly there, and at f32, where the eta sums' order can
    part the walks, both answers must be optimal and within 1e-9 relative
    (two optimal bases refined in f64: 2e-15 seen). Where the walks part
    at f64 too, that limit holds at f64 and at f32 both statuses are
    recorded. Adds its numbers to ``out`` (the kernels' solve's
    record)."""
    import tpulp_torch
    from tpulp_torch.solve import api, blocked

    kernels = blocked.run_simplex_blocked
    api.run_simplex_blocked = blocked.run_simplex_blocked = \
        blocked.run_simplex_blocked_reference
    try:
        sync(dev)
        t0 = time.perf_counter()
        eager = tpulp_torch.solve_lp(sf, dtype=dt, device=dev, driver=driver)
        sync(dev)
    finally:
        api.run_simplex_blocked = blocked.run_simplex_blocked = kernels
    secs = time.perf_counter() - t0
    rel = abs(float(eager.objective) - float(sol.objective)) / max(
        1.0, abs(float(sol.objective))) if eager.objective is not None \
        and sol.objective is not None else float("inf")
    f64 = str(dt) == "torch.float64"
    if f64 and same_walk:
        bad = eager.status != sol.status or eager.objective != sol.objective
    else:
        bad = (f64 or same_walk) and not (
            sol.status == eager.status == "optimal" and rel <= 1e-9)
    if bad:
        raise AssertionError(f"5d {label} {str(dt)[6:]}: {sol.status}, "
                             f"objective {sol.objective!r}, the eager "
                             f"engine's {eager.status}, {eager.objective!r}")
    out["eager"] = {"status": eager.status, "seconds": secs,
                    "niter": eager.niter, "rung": eager.rung,
                    "objective": str(eager.objective), "rel_diff": rel}
    log(f"# 5d {label} {str(dt)[6:]}: the eager engine's solve {secs:.2f} "
        f"s, {eager.status}, {eager.niter} pivots, rung {eager.rung}, "
        f"objective {eager.objective!r} (relative difference {rel:.1e})")


def other_walks(state, opts, label: str):
    """The walk of ``state`` on the blocked kernels at blocks of 16 and of
    1 eta and on the devex rank-1 walk: (status, pivots) each, recorded
    beside the solve's to tell a stall of the LP at a dtype from one of
    the blocked engine's sum order."""
    from tpulp_torch.solve import run_simplex_blocked, run_simplex_devex

    out = {}
    for name, run in (("blocked_K16", lambda: run_simplex_blocked(
            state, opts, 16)), ("blocked_K1", lambda: run_simplex_blocked(
                state, opts, 1)), ("rank1_devex", lambda: run_simplex_devex(
                    state, opts))):
        o = run()
        out[name] = {"status": int(o.status), "niter": int(o.niter)}
    log(f"# 5d {label} {str(state.T.dtype)[6:]}, the other walks: "
        + ", ".join(f"{k} status {v['status']} in {v['niter']} pivots"
                    for k, v in out.items()))
    return out


def phase_blocked_engine(dev="cuda"):
    """Phase 5d: the solo rank-K blocked engine on its kernels: on the
    cluster route (``blocked_cluster``, one launch a block of 64 slots,
    where its plan fits), on the grid route past it (``blocked_grid``, one
    cooperative launch a block) and on ``blocked_step`` (six launches a
    slot, past the grid's plan), B1 and the ray launch a block. (a) ``solve_lp(driver="auto")`` on phase
    8c's recipe, one LP of 512 x 1024 (514 x 1537, the blocked engine on
    the cluster route: one ``blocked_cluster`` launch a block, no
    ``blocked_step``; optimal, certified, the eager engine's objective
    exactly); (b) devex, which auto picks for the artificial LP at 512 + 4
    rows: its independent rows with c >= 0 (optimal, certified) and the
    variant with its dependent rows (the retire; its status beside the
    eager engine's, at f64, and those of ``other_walks``); (c) the
    refreshed rung's
    blocked segments (largest-pivot ties). Each walk on the cluster held in
    every field at f64 and f32 against ``blocked_cluster_reference`` and
    ``blocked_steps``' walk, and ``blocked_steps``' walk against the
    plain-stage walk, each flushed by the same B1; the two kernels timed in
    turns. (d) each of ``blocked_step``'s launches against its plain stage
    on a Dantzig pivot and a budget stop inside a block ((a)'s LP), Bland,
    a largest-pivot tie, a clean-up pivot, a retire, the phase change with
    its devex reset and the ray launch with and without an artificial basic
    (``cleanup_arrays``), and the 1e8 reset (a pivot on 2e-4); the cluster's
    edge walks on the same LPs at every cluster size, the grid's on grids of
    1, 2, 3, 7 and the plan's. (e) the device us a slot, by launch for
    ``blocked_step`` and by stage for the cluster (block 0's clock), the
    host's enqueue, B1 at the blocked shapes beside ``addmm``, the grid and
    the cluster in turns at (a)'s shape; (f) the `auto` thresholds' table;
    (g) past the cluster's plan: ``solve_lp(driver="auto")`` on a wide LP
    (258 x 14,257) runs ``blocked_grid`` at f64 and f32, whose walk there is
    held against ``blocked_steps``' and, over its first BLK5_WIDE_WINDOW
    pivots, ``blocked_grid_reference``, and whose slot is timed in turns
    with ``blocked_step``'s; (p) past the grid's plan (the same LP in blocks
    of BLK5_PAST_K) ``blocked_step`` runs and holds. Returns the numbers;
    ``launches`` are (a)'s f64 solve's, ``grid_launches`` (g)'s f64
    solve's, ``step_launches`` (p)'s walk's."""
    import dataclasses as dc

    import torch

    from tpulp_torch import SolverOptions, make_state
    from tpulp_torch.core.state import RULE_BLAND, RULE_DEVEX, TIE_MAXPIV
    from tpulp_torch.solve.api import (RANK1_BELOW, KERNEL_FROM,
                                       _auto_engine, state_from_standard_form)
    from tpulp_torch.solve.refresh import stabilized_options

    res = {"solves": {}, "walks": {}, "stages": {}, "slot_us": {},
           "flush": {}, "cluster_walks": {}, "cluster_slot_us": {},
           "edge_walks": {}, "grid_walks": {}, "grid_slot_us": {},
           "grid_edge_walks": {}}
    A, b, c = dense_leq_arrays(BLK_M, BLK_N)
    sf_a = scenario_form(A, b, c)
    M, N = BLK_M + 2, BLK_M + BLK_N + 1
    if _auto_engine(M * N, torch.device(dev)) != "blocked" or not \
            RANK1_BELOW <= M * N < KERNEL_FROM:
        raise AssertionError(f"5d: auto does not pick the blocked engine "
                             f"at {M} x {N}")
    co, Ao, bo, _ = artificial_arrays(BLK_M + 4, BLK5_ART_N)
    sf_b = equality_form(co, Ao, bo)
    sf_bo = equality_form(np.abs(co), Ao[:BLK_M], bo[:BLK_M])
    # the clean-up pivots, the retire and the ray launch's gate
    sf_d = equality_form(*cleanup_arrays(BLK5_CLEANUP_M, BLK5_CLEANUP_N))
    # the 1e8 reset: devex's first pivot on 2e-4 in a row that holds a 3
    Ar, br, cr = dense_leq_arrays(64, 128, seed=5)
    Ar[:, 0], Ar[:, 1], cr[0] = 2e-4, 3.0, -100.0
    sf_r = scenario_form(Ar, br, cr)
    for dt in (torch.float64, torch.float32):
        name = str(dt)[6:]
        opts = SolverOptions.for_dtype(dt)
        ob = SolverOptions.for_dtype(dt, rule=RULE_DEVEX)
        # (a) the blocked engine's main case
        sol, res["solves"][f"a_{name}"] = blocked_solve(
            sf_a, dt, "auto", f"(a) {BLK_M}x{BLK_N}", dev=dev)
        if name == "float64":
            res["launches"] = res["solves"]["a_float64"]["launches"]
        eager_solve(sol, sf_a, dt, "auto", "(a)", res["solves"][f"a_{name}"],
                    dev)
        st = state_from_standard_form(sf_a, dtype=dt, device=dev)
        cw = cluster_walk_check(st, opts, "(a) Dantzig", window=None)
        if cw["status"] != 1:
            raise AssertionError(f"5d (a): status {cw['status']}")
        res["cluster_walks"][f"a_{name}"] = cw
        res["cluster_slot_us"][f"a_{name}"] = cluster_slot_us(st, opts,
                                                              "(a)")
        if name == "float64":
            # the grid and the cluster at a shape both hold, in turns
            res["grid_vs_cluster"] = grid_vs_cluster_us(st, opts, "(a)")
        w = blocked_walk_check(st, opts, "(a) Dantzig", window=None)
        if w["status"] != 1:
            raise AssertionError(f"5d (a): status {w['status']}")
        res["walks"][f"a_{name}"] = w
        res["slot_us"][f"a_{name}"] = blocked_slot_us(st, opts, "(a)")
        # (b) devex: the optimal LP, then the one with dependent rows
        solo, res["solves"][f"b_optimal_{name}"] = blocked_solve(
            sf_bo, dt, "auto", f"(b) optimal {BLK_M}x{BLK5_ART_N}", dev=dev)
        # (the eager engine's f32 solves of (b), ~30-40 s each, cut for
        # the script's time; its f64 ones and (a)'s and (c)'s f32 stay)
        if name == "float64":
            eager_solve(solo, sf_bo, dt, "auto", "(b) optimal",
                        res["solves"][f"b_optimal_{name}"], dev)
        so = state_from_standard_form(sf_bo, dtype=dt, device=dev)
        res["cluster_walks"][f"b_optimal_{name}"] = cluster_walk_check(
            so, ob, "(b) optimal devex")
        res["cluster_slot_us"][f"b_{name}"] = cluster_slot_us(
            so, ob, "(b) devex")
        res["walks"][f"b_optimal_{name}"] = blocked_walk_check(
            so, ob, "(b) optimal devex")
        res["slot_us"][f"b_{name}"] = blocked_slot_us(so, ob, "(b) devex")
        solb, res["solves"][f"b_{name}"] = blocked_solve(
            sf_b, dt, "auto", f"(b) {BLK_M + 4}x{BLK5_ART_N}", optimal=False,
            dev=dev)
        if name == "float64":
            eager_solve(solb, sf_b, dt, "auto", "(b) dependent rows",
                        res["solves"][f"b_{name}"], dev, same_walk=False)
        sb = state_from_standard_form(sf_b, dtype=dt, device=dev)
        res["solves"][f"b_{name}"]["other_walks"] = other_walks(
            sb, ob, "(b) dependent rows")
        res["cluster_walks"][f"b_{name}"] = cluster_walk_check(
            sb, ob, "(b) devex, dependent rows")
        res["walks"][f"b_{name}"] = blocked_walk_check(
            sb, ob, "(b) devex, dependent rows")
        # (c) the refreshed rung's blocked segments
        ref, res["solves"][f"c_{name}"] = blocked_solve(
            sf_a, dt, "refreshed", "(c) refreshed", dev=dev)
        eager_solve(ref, sf_a, dt, "refreshed", "(c) refreshed",
                    res["solves"][f"c_{name}"], dev)
        # a basis of the same optimum: (a)'s objective to rounding
        rel = abs(float(ref.objective) - float(sol.objective)) / max(
            1.0, abs(float(sol.objective)))
        if rel > 1e-9:
            raise AssertionError(f"5d (c): objective {ref.objective!r}, (a) "
                                 f"{sol.objective!r}")
        res["cluster_walks"][f"c_{name}"] = cluster_walk_check(
            st, stabilized_options(opts), "(c) TIE_MAXPIV", window=None)
        res["walks"][f"c_{name}"] = blocked_walk_check(
            st, stabilized_options(opts), "(c) TIE_MAXPIV", window=None)
        # (d) each launch against its plain stage
        res["stages"][f"a_{name}"] = blocked_stage_checks(
            st, dc.replace(opts, max_iters=BLK5_BUDGET), "(a) Dantzig",
            ("pivot", "budget_stop"), BLK5_K)
        res["stages"][f"a_bland_{name}"] = blocked_stage_checks(
            st, SolverOptions.for_dtype(dt, rule=RULE_BLAND), "(a) Bland",
            ("bland",), BLK5_K)
        sd = state_from_standard_form(sf_d, dtype=dt, device=dev)
        res["stages"][f"cleanup_{name}"] = blocked_stage_checks(
            sd, dc.replace(ob, tie_break=TIE_MAXPIV),
            "clean-up LP, devex, largest-pivot ties",
            ("cleanup", "retire", "devex_reset", "maxpiv_tie", "ray_art",
             "ray_clear"), BLK5_STAGE_K)
        sr = state_from_standard_form(sf_r, dtype=dt, device=dev)
        res["stages"][f"reset_{name}"] = blocked_stage_checks(
            sr, ob, "a pivot on 2e-4", ("reset_1e8",), BLK5_STAGE_K)
        # (d) the cluster's and the grid's edge walks on the same LPs
        res["edge_walks"][name] = cluster_edge_walks(
            dt, sf_a, sf_d, sf_r, cw, dev)
        res["grid_edge_walks"][name] = blocked_grid_edge_walks(
            dt, sf_d, sf_r, dev)
        for walk in res["cluster_walks"].values():
            walk.pop("plain", None)
        # (e) B1 at the blocked engine's shape
        res["flush"][f"a_{name}"] = blocked_flush_case(st)
        del st, so, sb, sd, sr
        torch.cuda.empty_cache()
    # (e) at bench.py's 1024 x 1024: the slot and B1
    s1 = make_state(*bench_arrays(1024, 1024), dtype=torch.float64,
                    device=dev)
    res["slot_us"]["bench_1026x2049_float64"] = blocked_slot_us(
        s1, SolverOptions.for_dtype(torch.float64), "bench")
    res["flush"]["bench_1026x2049_float64"] = blocked_flush_case(s1)
    del s1
    torch.cuda.empty_cache()
    # (f) the thresholds, measured
    res["thresholds"] = threshold_table(dev)
    # (g) past the cluster's plan: a wide LP in auto's blocked range on the
    # grid; (p) past the grid's plan on blocked_step
    wide_route(res, dev)
    res["grid_launches"] = res["solves"]["g_wide_float64"]["launches"]
    res["step_launches"] = res["past"]["launches"]
    return res


def wide_route(res, dev="cuda"):
    """5d (g): ``solve_lp(driver="auto")`` on a wide LP in auto's blocked
    range past the cluster's plan (258 x 14,257) at f64 and f32 runs
    ``blocked_grid``, one launch a block, and no ``blocked_step``; its walk
    there held against ``blocked_steps``' whole walk and
    ``blocked_grid_reference`` over the first BLK5_WIDE_WINDOW pivots
    (``blocked_grid_check``), its slot timed in turns with
    ``blocked_step``'s (``grid_slot_us``); (p) the route past the grid's
    plan (``past_grid_blocked``). Adds to ``res``'s "solves",
    "grid_walks", "grid_slot_us" and "past"."""
    import torch

    from tpulp_torch import SolverOptions
    from tpulp_torch.solve.api import _auto_engine, state_from_standard_form
    from tpulp_torch.solve.blocked import blocked_route

    Aw, bw, cw = dense_leq_arrays(BLK5_WIDE_M, BLK5_WIDE_N, seed=2)
    Mw, Nw = BLK5_WIDE_M + 2, BLK5_WIDE_M + BLK5_WIDE_N + 1
    if _auto_engine(Mw * Nw, torch.device(dev)) != "blocked":
        raise AssertionError(f"5d (g): {Mw} x {Nw} is not on auto's "
                             "blocked engine")
    sf_w = scenario_form(Aw, bw, cw)
    clock_hz = sm_clock_hz()
    for dt in (torch.float64, torch.float32):
        name = str(dt)[6:]
        if blocked_route(Mw, Nw, BLK5_K, dt, torch.device(dev)) != \
                "blocked_grid":
            raise AssertionError(f"5d (g): {Mw} x {Nw} {name} is not on the "
                                 "grid's route")
        label = f"(g) wide {BLK5_WIDE_M}x{BLK5_WIDE_N}"
        _, res["solves"][f"g_wide_{name}"] = blocked_solve(
            sf_w, dt, "auto", label, dev=dev, route="blocked_grid")
        sw = state_from_standard_form(sf_w, dtype=dt, device=dev)
        opts = SolverOptions.for_dtype(dt)
        res["grid_walks"][f"g_wide_{name}"] = blocked_grid_check(
            sw, opts, label)
        res["grid_slot_us"][f"g_wide_{name}"] = grid_slot_us(
            sw, opts, label, clock_hz)
        del sw
        torch.cuda.empty_cache()
    res["past"] = past_grid_blocked(dev)


def check_static_smem(ptxas) -> None:
    """The inner-block kernel's static shared memory (ptxas's report) must
    fit the room ``inner_block_plan`` leaves beside the dynamic share it
    plans, or a plan that fits on paper would not launch. The lane
    kernels' must fit the room ``lane_plan`` leaves, and each of the eight
    bounded kernels' and the sixteen rank-1 kernels' the 33 slots of its
    block reduction, and each of the fourteen blocked kernels' those and
    its eta coefficients, and the two cluster kernels' and the three grid
    walks' the room their plans leave."""
    from tpulp_torch.kernels.block import IB_STATIC_SMEM
    from tpulp_torch.kernels.blocked_cluster import \
        BLOCKED_CLUSTER_STATIC_SMEM
    from tpulp_torch.kernels.blocked_grid import BLOCKED_GRID_STATIC_SMEM
    from tpulp_torch.kernels.bounded_grid import GRID_STATIC_SMEM
    from tpulp_torch.kernels.lanes import LANE_STATIC_SMEM
    from tpulp_torch.kernels.rank1_cluster import CLUSTER_STATIC_SMEM

    got = {k: v.get("static_smem", 0) for k, v in ptxas.items()
           if k.startswith("inner_block")}
    if len(got) != 2 or max(got.values()) > IB_STATIC_SMEM:
        raise AssertionError(f"inner block static shared memory {got}: "
                             f"the plan leaves {IB_STATIC_SMEM} bytes")
    lane = {k: v.get("static_smem", 0) for k, v in ptxas.items()
            if k.startswith("lane_")}
    if len(lane) != len(LANE_KERNELS) or \
            max(lane.values()) > LANE_STATIC_SMEM:
        raise AssertionError(f"lane kernels' static shared memory {lane}: "
                             f"the plan leaves {LANE_STATIC_SMEM} bytes")
    rk1 = {k: v.get("static_smem", 0) for k, v in ptxas.items()
           if k.startswith("rank1_")}
    if len(rk1) != len(RANK1_KERNELS) or \
            max(rk1.values()) > BOUNDED_STATIC_SMEM:
        raise AssertionError(f"rank-1 kernels' static shared memory {rk1}: "
                             f"their reductions take {BOUNDED_STATIC_SMEM}")
    clu = {k: v.get("static_smem", 0) for k, v in ptxas.items()
           if k.startswith("cluster_kernel")}
    if len(clu) != len(CLUSTER_KERNELS) or \
            max(clu.values()) > CLUSTER_STATIC_SMEM:
        raise AssertionError(f"rank1_cluster's static shared memory {clu}: "
                             f"the plan leaves {CLUSTER_STATIC_SMEM}")
    blk = {k: v.get("static_smem", 0) for k, v in ptxas.items()
           if k in BLOCKED_KERNELS.values()}
    if len(blk) != len(BLOCKED_KERNELS) or \
            max(blk.values()) > BLOCKED_STATIC_SMEM:
        raise AssertionError(f"blocked kernels' static shared memory {blk}: "
                             f"at most {BLOCKED_STATIC_SMEM}")
    bgr = {k: v.get("static_smem", 0) for k, v in ptxas.items()
           if k in BOUNDED_GRID_KERNELS.values()}
    if len(bgr) != len(BOUNDED_GRID_KERNELS) or \
            max(bgr.values()) > GRID_STATIC_SMEM:
        raise AssertionError(f"bounded_grid's static shared memory {bgr}: "
                             f"the plan leaves {GRID_STATIC_SMEM}")
    rgr = {k: v.get("static_smem", 0) for k, v in ptxas.items()
           if k in RANK1_GRID_KERNELS.values()}
    if len(rgr) != len(RANK1_GRID_KERNELS) or \
            max(rgr.values()) > GRID_STATIC_SMEM:
        raise AssertionError(f"rank1_grid's static shared memory {rgr}: "
                             f"the plan leaves {GRID_STATIC_SMEM}")
    bkc = {k: v.get("static_smem", 0) for k, v in ptxas.items()
           if k in BLOCKED_CLUSTER_KERNELS.values()}
    if len(bkc) != len(BLOCKED_CLUSTER_KERNELS) or \
            max(bkc.values()) > BLOCKED_CLUSTER_STATIC_SMEM:
        raise AssertionError(f"blocked_cluster's static shared memory {bkc}:"
                             f" the plan leaves {BLOCKED_CLUSTER_STATIC_SMEM}")
    bgd = {k: v.get("static_smem", 0) for k, v in ptxas.items()
           if k in BLOCKED_GRID_KERNELS.values()}
    if len(bgd) != len(BLOCKED_GRID_KERNELS) or \
            max(bgd.values()) > BLOCKED_GRID_STATIC_SMEM:
        raise AssertionError(f"blocked_grid's static shared memory {bgd}: "
                             f"the plan leaves {BLOCKED_GRID_STATIC_SMEM}")
    log(f"# inner block static shared memory {got} bytes, within the "
        f"{IB_STATIC_SMEM} the plan leaves; lane kernels {lane} bytes, "
        f"within {LANE_STATIC_SMEM}; rank-1 kernels {rk1} bytes, within "
        f"{BOUNDED_STATIC_SMEM}; blocked "
        f"kernels {blk} bytes, within {BLOCKED_STATIC_SMEM}; rank1_cluster "
        f"{clu} bytes, within {CLUSTER_STATIC_SMEM}; blocked_cluster {bkc} "
        f"bytes, within {BLOCKED_CLUSTER_STATIC_SMEM}; bounded_grid {bgr} "
        f"and rank1_grid {rgr} bytes, within {GRID_STATIC_SMEM}; "
        f"blocked_grid {bgd} bytes, within {BLOCKED_GRID_STATIC_SMEM}")


# the lane kernels' instantiations as their mangled names spell them:
# <float or double, RESIDENT>
LANE_KERNELS = tuple(f"lane_{kind}_kernelI{t}Lb{r}" for kind in
                     ("dual", "primal", "bounded") for t in "fd"
                     for r in "10")


def _walk_kernels(ns: str, stages) -> dict:
    """{mangled-name fragment: readable name} of a stream-ordered walk's
    kernels in namespace ``tpulp::<ns>``, <float or double> (the namespace
    tells rank1.cu's price_kernel from blocked.cu's)."""
    prefix = {"rk1": "rank1", "blk": "blocked"}[ns]
    return {f"{len(ns)}{ns}{len(k)}{k}I{t}":
            f"{prefix}_{k}<{'float' if t == 'f' else 'double'}>"
            for k in (f"{stage}_kernel" for stage in stages) for t in "fd"}


# the rank-1 step's eight kernels (five, and the dual walk's price, ratio
# and finish)
RANK1_KERNELS = _walk_kernels("rk1", ("scan", "price", "ratio", "update",
                                      "finish", "dual_price", "dual_ratio",
                                      "dual_finish"))
# the blocked engine's seven kernels
BLOCKED_KERNELS = _walk_kernels("blk", ("cleanup", "price", "column",
                                        "ratio", "row", "finish", "ray"))
# the cluster walk's instantiations: <float or double, the walk>
CLUSTER_KERNELS = {f"3rkc14cluster_kernelI{t}Li{w}E":
                   f"cluster_kernel<{'float' if t == 'f' else 'double'},"
                   f"{walk}>" for t in "fd"
                   for w, walk in enumerate(("primal", "devex", "dual"))}
# the bounded grid walk's instantiations: <float or double, devex,
# streamed, the per-row vectors in device memory (always streamed)>, and
# the wide plan's kernel <float or double, devex>
BOUNDED_GRID_KERNELS = {
    **{f"3bgr11grid_kernelI{t}Lb{d}ELb{r}ELb{v}E":
       f"bgrid_kernel<{'float' if t == 'f' else 'double'},"
       f"{'devex' if d == '1' else 'dantzig'}"
       f"{',streamed' if r == '1' else ''}"
       f"{',device_vectors' if v == '1' else ''}>"
       for t in "fd" for d in "01" for r, v in (("0", "0"), ("1", "0"),
                                                ("1", "1"))},
    **{f"3bgr11wide_kernelI{t}Lb{d}E":
       f"bgrid_kernel<{'float' if t == 'f' else 'double'},"
       f"{'devex' if d == '1' else 'dantzig'},wide>"
       for t in "fd" for d in "01"}}
# the rank-1 grid walk's instantiations: <float or double, the walk,
# streamed>
# the sharded pivot's instantiations: <float or double, elements a load>
SHARD_KERNELS = {
    **{f"shard_pivot_kernelI{t}Li{v}E":
       f"shard_pivot_kernel<{'float' if t == 'f' else 'double'},{v}>"
       for t, vs in (("f", (1, 4)), ("d", (1, 2))) for v in vs},
    **{f"shard_vectors_kernelI{t}E":
       f"shard_vectors_kernel<{'float' if t == 'f' else 'double'}>"
       for t in "fd"}}
RANK1_GRID_KERNELS = {
    f"3rgr11grid_kernelI{t}Li{w}ELb{r}E":
    f"rgrid_kernel<{'float' if t == 'f' else 'double'},{walk}"
    f"{',streamed' if r == '1' else ''}>"
    for t in "fd" for w, walk in enumerate(("primal", "devex", "dual"))
    for r in "01"}
# the blocked cluster's instantiations: <float or double>
BLOCKED_CLUSTER_KERNELS = {
    f"3bkc14cluster_kernelI{t}E":
    f"blocked_cluster_kernel<{'float' if t == 'f' else 'double'}>"
    for t in "fd"}
# the blocked grid's instantiations: <float or double>
BLOCKED_GRID_KERNELS = {
    f"3bgd19blocked_grid_kernelI{t}E":
    f"blocked_grid_kernel<{'float' if t == 'f' else 'double'}>"
    for t in "fd"}
# the static shared memory of a single-block walk kernel: the block
# reduction's 33 slots (common.cuh's Red<double>: 32 bytes each); a blocked
# kernel's adds at most MAX_K eta coefficients of 8 bytes and a scalar or
# two
BOUNDED_STATIC_SMEM = 33 * 32
BLOCKED_STATIC_SMEM = BOUNDED_STATIC_SMEM + 1024 * 8 + 16


# the flush's instantiations: <float or double, LANES> (B1 batched: LANES)
FLUSH_KERNELS = {f"flush_kernelI{t}Lb{b}E":
                 f"flush_kernel<{'float' if t == 'f' else 'double'}"
                 f"{',lanes' if b == '1' else ''}>"
                 for t in "fd" for b in "01"}


def _ptxas_name(name: str) -> str:
    """A readable kernel name: ``flush_kernel<float>``,
    ``lane_dual_kernel<double,resident>``."""
    if name in FLUSH_KERNELS:
        return FLUSH_KERNELS[name]
    t = "float" if "kernelIf" in name else "double"
    head = name.split("kernelI")[0] + "kernel" if "kernelI" in name \
        else name
    if name.startswith("lane_"):
        return f"{head}<{t},{'resident' if name.endswith('1') else 'streamed'}>"
    if name in RANK1_KERNELS:
        return RANK1_KERNELS[name]
    if name in BLOCKED_KERNELS:
        return BLOCKED_KERNELS[name]
    if name in CLUSTER_KERNELS:
        return CLUSTER_KERNELS[name]
    if name in BLOCKED_CLUSTER_KERNELS:
        return BLOCKED_CLUSTER_KERNELS[name]
    if name in BLOCKED_GRID_KERNELS:
        return BLOCKED_GRID_KERNELS[name]
    if name in BOUNDED_GRID_KERNELS:
        return BOUNDED_GRID_KERNELS[name]
    if name in RANK1_GRID_KERNELS:
        return RANK1_GRID_KERNELS[name]
    if name in SHARD_KERNELS:
        return SHARD_KERNELS[name]
    return f"{head}<{t}>" if "kernelI" in name else head


def ptxas_report(text: str):
    """{kernel: {"registers": n, "spill_bytes": n, "static_smem": n}} from
    nvcc's -Xptxas=-v output, for the inner-block, flush and FMA
    kernels."""
    import re

    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?(\w+)'?", line)
        if m:
            fn = m.group(1)
            continue
        if fn is None:
            continue
        name = next((k for k in ("inner_block_kernelIf",
                                 "inner_block_kernelId", *FLUSH_KERNELS,
                                 "fma_kernelIf", "fma_kernelId",
                                 "barrier_probe_kernel", *LANE_KERNELS,
                                 *RANK1_KERNELS,
                                 *BLOCKED_KERNELS, *CLUSTER_KERNELS,
                                 *BLOCKED_CLUSTER_KERNELS,
                                 *BLOCKED_GRID_KERNELS,
                                 *BOUNDED_GRID_KERNELS, *RANK1_GRID_KERNELS,
                                 *SHARD_KERNELS)
                     if k in fn), None)
        if name is None:
            continue
        rec = out.setdefault(_ptxas_name(name), {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            rec["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rec["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            rec["static_smem"] = int(m.group(1))
    return out


def phase_barrier_probe():
    """Phase 3c: one grid barrier, timed in an otherwise empty persistent
    cooperative kernel (one 256-thread block per SM, BARRIER_PROBE_N
    barriers), for cooperative_groups' grid.sync() and the flag barrier;
    the faster is the inner-block kernel's latency floor per barrier."""
    from tpulp_torch.kernels.block import barrier_probe

    res = {}
    for _ in range(2):
        for kind in ("grid_sync", "flag"):
            us = 1e3 * barrier_probe(BARRIER_PROBE_N, kind)
            res[kind] = min(res.get(kind, us), us)
    best = min(res, key=res.get)
    log(f"# barrier probe ({BARRIER_PROBE_N} barriers a launch, best of 2): "
        f"grid.sync() {res['grid_sync']:.3f} us, flag barrier "
        f"{res['flag']:.3f} us per barrier; faster: {best}; the inner "
        f"block uses the flag barrier")
    return {"us_per_barrier": res, "faster": best, "inner_block_uses": "flag"}


# (name, shapes of c, a, b, value, lanes, view of c): the engines' calls on
# the card; a case with lanes batches a leading dimension of that many
# under vmap; a view takes c from a wider tensor of its shape, as the
# lane-sharded step takes its block and RHS from each lane's frame
FMA_CASES = [
    ("rank1_pivot_vmap", [(59, 114), (59, 1), (1, 114)], -1.0, MILP_BATCH,
     None),
    ("rhs_rewrite", [(MILP_BATCH, 59), (MILP_BATCH, 1), (MILP_BATCH, 59)],
     1.0, None, None),
    ("running_vector", [(3073,), (), (3073,)], 1.0, None, None),
    ("running_bvec_vmap", [(1538,), (1538,), ()], 1.0, MILP_BATCH, None),
    ("rank1_pivot_big", [(1538, 3073), (1538, 1), (1, 3073)], -1.0, None,
     None),
    # phase 8: the bounded driver's pivot and flip at the bounded LP's
    # tableau (1026 x 3073), and the bounded batch's pivot (66 x 193)
    ("bounded_pivot", [(1026, 3073), (1026, 1), (1, 3073)], -1.0, None,
     None),
    ("bounded_flip_rhs", [(1026,), (1026,), ()], -1.0, None, None),
    ("bounded_pivot_vmap", [(66, 193), (66, 1), (1, 193)], -1.0,
     MILP_BATCH, None),
    # phase 10 on the (1, 1) mesh: the lane-sharded pivot of each frame's
    # coefficient block (a strided view) and of its RHS column, at 10a's
    # 64 lanes of 66 x 193 frames and 10b's 128 of 59 x 114; 10c: the
    # span-encoded knapsack's bounded batch, 128 lanes of 3 x 30, its pivot
    # and its flip of the RHS column
    ("lane_block_10a", [(66, 193), (66, 1), (1, 192)], -1.0, SCEN_LANES,
     "block"),
    ("lane_rhs_10a", [(66, 193), (66,), ()], -1.0, SCEN_LANES, "rhs"),
    ("lane_block_10b", [(59, 114), (59, 1), (1, 113)], -1.0, MILP_BATCH,
     "block"),
    ("lane_rhs_10b", [(59, 114), (59,), ()], -1.0, MILP_BATCH, "rhs"),
    ("spans_pivot_10c", [(3, 30), (3, 1), (1, 30)], -1.0, MILP_BATCH, None),
    ("spans_flip_10c", [(3, 30), (3,), ()], -1.0, MILP_BATCH, "rhs"),
]
# a frame's coefficient block and its RHS column
FMA_VIEWS = {None: lambda x: x, "block": lambda x: x[..., :-1],
             "rhs": lambda x: x[..., -1]}


def phase_fma(dev):
    """Phase 3d: the FMA kernel bit for bit equal to the CPU's
    torch.addcmul (one rounding: fma(value * a, b, c)) on seeded f32 and
    f64 data, broadcast and vmapped; timed against CUDA's torch.addcmul
    (which rounds the product first) and the plain version on the CPU.
    Returns the cases' numbers; the headline is the vmapped rank-1 pivot of
    the MILP waves at f64."""
    import torch

    from tpulp_torch.kernels import fused_fma

    stats = {}
    for dt in (torch.float32, torch.float64):
        name = str(dt).replace("torch.", "")
        for case, shapes, value, lanes, view in FMA_CASES:
            rng = np.random.default_rng(len(stats))
            lead = (lanes,) if lanes else ()
            cpu = [torch.tensor(rng.normal(size=lead + s)).to(dt)
                   for s in shapes]
            # the view is taken on each device, so the card's c has the
            # CPU's strides
            gpu = [x.to(dev) for x in cpu]
            cpu[0], gpu[0] = FMA_VIEWS[view](cpu[0]), FMA_VIEWS[view](gpu[0])
            if lanes:
                def kern(c, a, b):
                    return torch.func.vmap(
                        lambda c, a, b: fused_fma(c, a, b, value))(c, a, b)

                def lib(c, a, b):
                    return torch.func.vmap(lambda c, a, b: torch.addcmul(
                        c, a, b, value=value))(c, a, b)
            else:
                def kern(c, a, b):
                    return fused_fma(c, a, b, value)

                def lib(c, a, b):
                    return torch.addcmul(c, a, b, value=value)
            got = kern(*gpu)
            torch.cuda.synchronize()
            want = lib(*cpu)
            if not torch.equal(got.cpu(), want):
                bad = int((got.cpu() != want).sum())
                raise AssertionError(f"fused_fma {case} {name}: {bad} of "
                                     f"{want.numel()} elements differ from "
                                     "the CPU's addcmul")
            two = int((lib(*gpu).cpu() != want).sum())
            ms = cuda_time_ms(lambda: kern(*gpu), RUNS)
            lib_ms = cuda_time_ms(lambda: lib(*gpu), RUNS)
            t0 = time.perf_counter()
            for _ in range(RUNS):
                lib(*cpu)
            plain_ms = 1e3 * (time.perf_counter() - t0) / RUNS
            size = got.element_size()
            nbytes = size * (sum(x.numel() for x in gpu) + got.numel())
            bound_ms, bound_by = bound(
                nbytes, 3 * got.numel(),
                FP32_FLOP_S if dt == torch.float32 else FP64_FLOP_S)
            stats[f"{case} {name}"] = {
                "shape": list(got.shape), "c_strides": list(gpu[0].stride()),
                "max_abs_err": 0.0, "ms": ms,
                "plain_ms": plain_ms, "plain_on": "cpu",
                "cuda_addcmul_ms": lib_ms, "cuda_addcmul_differs": two,
                "bound_ms": bound_ms, "bound_by": bound_by}
            log(f"# FMA {case} {name} {tuple(got.shape)} (c's strides "
                f"{tuple(gpu[0].stride())}): bit for bit the "
                f"CPU's addcmul (CUDA addcmul differs at {two} of "
                f"{got.numel()}); kernel {ms:.4f} ms, CUDA addcmul "
                f"{lib_ms:.4f} ms, plain on the CPU {plain_ms:.4f} ms; "
                f"bound {bound_ms:.5f} ms ({bound_by})")
    return stats


def fma_layouts_held(dev, plans) -> int:
    """Every operand layout of a path's FMA launches (the shapes and
    strides of c, a and b, as the kernel's plan cache keys them), run again
    on seeded data at f32 and f64 and both signs of ``value``: bit for bit
    the CPU's addcmul on operands of the same strides. Returns the number
    of layouts held."""
    import torch

    from tpulp_torch.kernels import fused_fma

    rng = np.random.default_rng(1)
    for key in plans:
        shapes, strides = key[0::2], key[1::2]
        for dt in (torch.float32, torch.float64):
            cpu, gpu = [], []
            for shape, stride in zip(shapes, strides):
                size = 1 + sum(max(n - 1, 0) * st
                               for n, st in zip(shape, stride))
                base = torch.tensor(rng.normal(size=size)).to(dt)
                cpu.append(base.as_strided(shape, stride))
                gpu.append(base.to(dev).as_strided(shape, stride))
            for value in (-1.0, 1.0):
                got = fused_fma(*gpu, value).cpu()
                want = torch.addcmul(*cpu, value=value)
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"fused_fma at the layout {key} ({dt}, value "
                        f"{value}): {int((got != want).sum())} of "
                        f"{want.numel()} elements differ from the CPU's "
                        "addcmul")
    return len(plans)


class FmaLayouts:
    """The operand layouts of the FMA launches made inside the block: the
    kernel's plan cache, emptied on entry, read on exit (launches on the
    CPU make no plan)."""

    def __enter__(self):
        from tpulp_torch.kernels import fma

        fma._PLANS.clear()
        return self

    def __exit__(self, *exc):
        from tpulp_torch.kernels import fma

        if len(fma._PLANS) >= fma._MAX_PLANS:
            raise AssertionError("the FMA plan cache filled up: layouts "
                                 "were dropped")
        self.plans = list(fma._PLANS)
        return False


def check_machine_code(lib_path):
    """The flush's machine code: the f64 kernel issues DMMA (FP64 tensor
    cores) and the f32 kernel no tensor-core instruction at all (so no
    TF32); returns the counts per kernel."""
    import os

    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            fn = line.split(":", 1)[1].strip()
            continue
        if fn is None or "flush_kernel" not in fn or "*/" not in line:
            continue
        # "/*0130*/  @!P0 DMMA.8x8x4 R4, R8, R12, R4 ;  /* 0x... */"
        words = line.split("*/", 1)[1].split()
        if words and words[0].startswith("@"):
            words = words[1:]
        if not words or words[0].startswith("/*"):
            continue
        op = words[0]
        # flush_kernel<T, LANES>: the solo flush and B1 batched
        kind = ("f64" if "flush_kernelId" in fn else "f32") + (
            " lanes" if "Lb1E" in fn else "")
        c = counts.setdefault(kind, {"DMMA": 0, "HMMA": 0, "FFMA": 0,
                                     "DFMA": 0})
        for key in c:
            if op.startswith(key):
                c[key] += 1
    log(f"# machine code of the flush: {counts}")
    if set(counts) != {"f32", "f64", "f32 lanes", "f64 lanes"}:
        raise AssertionError(f"flush kernels not found in the SASS: {counts}")
    for lanes in ("", " lanes"):
        if counts["f64" + lanes]["DMMA"] == 0:
            raise AssertionError(f"the f64{lanes} flush issues no DMMA")
        if counts["f32" + lanes]["HMMA"] or counts["f32" + lanes]["DMMA"]:
            raise AssertionError(f"the f32{lanes} flush issues tensor-core "
                                 "instructions")
        if counts["f32" + lanes]["FFMA"] == 0:
            raise AssertionError(f"the f32{lanes} flush issues no FFMA")
    return counts


def phase_bench(dev):
    """Phase 6: the kernel engine on the bench instance (f32, K = 256) to
    termination or 20,000 pivots, gated like bench.py; then the per-block
    split between the two kernels."""
    import torch

    from tpulp_torch import SolverOptions, Status, make_state
    from tpulp_torch.core import eta_scaled_options
    from tpulp_torch.kernels import LAUNCHES, blocked_inner_block, fused_flush
    from tpulp_torch.solve.blocked_kernel import (kernel_inputs,
                                                  run_simplex_blocked_kernel)

    c, A, b, hint = bench_arrays(BENCH_M, BENCH_N)
    state = make_state(c, A, b, hint, dtype=torch.float32, device=dev)
    opts = SolverOptions.for_dtype(torch.float32, max_iters=20_000)
    torch.cuda.synchronize()
    blocks0 = LAUNCHES["blocked_inner_block"]
    t0 = time.perf_counter()
    out = run_simplex_blocked_kernel(state, opts, block=BENCH_K)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    niter = int(out.niter)
    status = Status.NAMES[int(out.status)]
    gates = gate_terminal_basis(out, c, A, b, "float32", opts.opt_tol)
    blocks = LAUNCHES["blocked_inner_block"] - blocks0
    log(f"# bench shape {BENCH_M}x{BENCH_M + BENCH_N} f32 K={BENCH_K}: "
        f"{status}, niter {niter}, {blocks} blocks, {secs:.2f} s, "
        f"{niter / secs:.1f} pivots/s; gates ok {gates}")

    eopts = eta_scaled_options(opts, torch.float32)
    ins = kernel_inputs(state)
    stall = eopts.resolved_stall_limit(state.m, state.n)
    etas = blocked_inner_block(*ins, eopts, stall, BENCH_K)
    b2_ms = cuda_time_ms(
        lambda: blocked_inner_block(*ins, eopts, stall, BENCH_K), 5)
    work = ins[0].clone()
    b1_ms = cuda_time_ms(
        lambda: fused_flush(work, etas[0], etas[1], etas[5], eopts.opt_tol,
                            eopts.piv_tol), 5, lambda: work.copy_(ins[0]))
    log(f"# per-block split at the bench shape (first block, median of 5): "
        f"B2 {b2_ms:.3f} ms, B1 {b1_ms:.3f} ms")
    return {"niter": niter, "status": status, "seconds": secs,
            "pivots_per_s": niter / secs, "b2_ms": b2_ms, "b1_ms": b1_ms}


# ---------------------------------------------------------------------------
# phase 7: MILP, batches and warm starts
# ---------------------------------------------------------------------------

def knapsack_lp(values, weights_rows, caps):
    """max v x s.t. W x <= caps, x binary (one row per weight vector)."""
    from tpulp_torch import LinExpr, LinProg

    lp = LinProg()
    obj = LinExpr()
    for i, v in enumerate(values):
        lp.addVar(f"x{i}", integral=True, lb=0, ub=1)
        obj += LinExpr(int(v), f"x{i}")
    lp.maximize(obj)
    for w, cap in zip(weights_rows, caps):
        e = LinExpr()
        for i, wi in enumerate(w):
            e += LinExpr(int(wi), f"x{i}")
        lp.addConstraint(e.constraintLeq(int(cap)))
    return lp


def bench_knapsack(n_items=MILP_ITEMS, seed=0):
    """bench.py's MILP instance (``run_bench_milp``): (values, weights,
    cap)."""
    rng = np.random.default_rng(seed)
    values = [int(v) for v in rng.integers(10, 60, size=n_items)]
    weights = [int(w) for w in rng.integers(5, 25, size=n_items)]
    return values, weights, int(sum(weights) * 0.4)


def dp_knapsack(values, weights, cap) -> int:
    """The exact 0/1 knapsack optimum by dynamic programming."""
    best = [0] * (cap + 1)
    for v, w in zip(values, weights):
        for c in range(cap, w - 1, -1):
            best[c] = max(best[c], best[c - w] + v)
    return best[cap]


def md_knapsack(n=MDK_ITEMS, rows=MDK_ROWS, seed=MDK_SEED):
    """A multidimensional knapsack: bench.py's values and weights in
    ``rows`` constraints, each capacity 40% of its weights. Returns
    (values, W, caps)."""
    rng = np.random.default_rng(seed)
    values = rng.integers(10, 60, size=n)
    W = rng.integers(5, 25, size=(rows, n))
    return values, W, (W.sum(axis=1) * 0.4).astype(int)


def spy_wave_devices():
    """Wrap the wave entry points that ``tpulp_torch.milp.bnb`` calls so
    that every tensor they take or return must be a CUDA tensor: the
    template, the pool, R/const, the states, the summaries and the
    generation chain. Returns (call counts, restore)."""
    import torch

    import tpulp_torch.milp.bnb as bnb

    names = ("make_batched_states", "new_pool", "pool_write",
             "pack_wave_summary", "run_simplex_batch", "run_warm_wave",
             "run_expand_generation", "run_warm_batch")
    saved = {name: getattr(bnb, name) for name in names}
    calls = {name: 0 for name in names}

    def tensors(x):
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (tuple, list)):
            for y in x:
                yield from tensors(y)

    def wrap(name, fn):
        def spy(*args, **kw):
            out = fn(*args, **kw)
            for t in tensors([args, list(kw.values()), out]):
                if not t.is_cuda:
                    raise AssertionError(f"{name}: a {tuple(t.shape)} "
                                         f"tensor on {t.device}")
            calls[name] += 1
            return out
        return spy

    for name, fn in saved.items():
        setattr(bnb, name, wrap(name, fn))

    def restore():
        for name, fn in saved.items():
            setattr(bnb, name, fn)

    return calls, restore


class PlainLaneLoops:
    """Within the block the lane loops of the waves and batches run as the
    plain vmapped steps on the card (``*_lanes_reference``), for phase 7's
    nodes/s without the lane kernels in the same run."""

    SITES = ("tpulp_torch.solve.dual", "tpulp_torch.batch.vmap_driver",
             "tpulp_torch.shard.sharded_batch")

    def __enter__(self):
        import importlib

        from tpulp_torch.solve import lanes

        self.saved = []
        for site in self.SITES:
            mod = importlib.import_module(site)
            for fn, ref in (("dual_lanes", lanes.dual_lanes_reference),
                            ("primal_lanes", lanes.primal_lanes_reference)):
                if hasattr(mod, fn):
                    self.saved.append((mod, fn, getattr(mod, fn)))
                    setattr(mod, fn, ref)
        return self

    def __exit__(self, *exc):
        for mod, fn, saved in self.saved:
            setattr(mod, fn, saved)


class VmapCalls:
    """Counts the calls of ``torch.func.vmap`` within the block (every
    vmapped step loop of the port starts with one)."""

    def __enter__(self):
        import torch

        self.n = 0
        self.saved = torch.func.vmap

        def spy(*args, **kw):
            self.n += 1
            return self.saved(*args, **kw)

        torch.func.vmap = spy
        return self

    def __exit__(self, *exc):
        import torch

        torch.func.vmap = self.saved


def milp_stats_line(stats, secs):
    warm = max(stats.warm_nodes, 1)
    return (f"{stats.nodes_solved} nodes in {stats.waves} waves "
            f"({stats.gen_waves} device generations, {stats.gen_nodes} "
            f"nodes), {stats.warm_nodes} warm nodes at "
            f"{stats.warm_pivots / warm:.2f} pivots each, "
            f"{stats.solo_resolves} solo re-solves, {stats.incumbent_updates}"
            f" incumbents; {secs:.3f} s = {stats.nodes_solved / secs:.1f} "
            f"nodes/s; assemble {stats.t_assemble:.3f} s, device "
            f"{stats.t_device:.3f} s, process {stats.t_process:.3f} s, "
            f"verify {stats.t_verify:.3f} s")


def bnb_counters(stats) -> dict:
    """Every ``BnbStats`` counter (the wave-time splits left out)."""
    return {f.name: getattr(stats, f.name)
            for f in dataclasses.fields(stats) if not f.name.startswith("t_")}


def device_busy(fn):
    """(wall s, device busy s, CUDA kernels) of ``fn()`` under
    torch.profiler, tracing the card only. Keep ``fn`` short: a whole MILP
    solve (~70,000 kernels) takes over 30 s to trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, kernels = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy += e.self_device_time_total / 1e6
            kernels += e.count
    return wall, busy, kernels


def phase_milp_knapsacks():
    """Phase 7a/7b: the bench knapsack (f32 and f64: one untimed solve,
    one timed) must hit the DP oracle exactly; the multidimensional
    knapsack's f32 and f64 optima must be equal, integral and feasible in
    Fractions. Every tensor of every wave must be a CUDA tensor."""
    import warnings

    import torch

    import tpulp_torch
    from tpulp_torch.kernels import LAUNCHES, reset_launches

    warnings.filterwarnings("error", message="There is a performance drop")
    values, weights, cap = bench_knapsack()
    oracle = dp_knapsack(values, weights, cap)
    res = {}
    calls, restore = spy_wave_devices()
    try:
        for dt in (torch.float32, torch.float64):
            name = str(dt).replace("torch.", "")
            lp = knapsack_lp(values, [weights], [cap])
            t0 = time.perf_counter()
            tpulp_torch.solve_milp(lp, dtype=dt, batch_size=MILP_BATCH,
                                   device="cuda")
            torch.cuda.synchronize()
            first = time.perf_counter() - t0
            torch.cuda.reset_peak_memory_stats()
            # the MILP main path: counts set to 0 just before the timed
            # solve and read just after it
            reset_launches()
            with VmapCalls() as vm:
                t0 = time.perf_counter()
                sol, st = tpulp_torch.solve_milp(lp, dtype=dt,
                                                 batch_size=MILP_BATCH,
                                                 return_stats=True,
                                                 device="cuda")
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
            launches = dict(LAUNCHES)
            fma_launches = launches["fused_fma"]
            if fma_launches == 0 or launches["lane_dual"] == 0 \
                    or launches["lane_primal"] == 0:
                raise AssertionError(f"bench knapsack {name}: solve_milp "
                                     "never launched the FMA kernel or a "
                                     f"lane kernel: {launches}")
            if vm.n:
                raise AssertionError(f"bench knapsack {name}: {vm.n} "
                                     "vmapped step loops on the card")
            # the same solve with the plain lane loops: the same tree
            with PlainLaneLoops(), VmapCalls() as vm_plain:
                t0 = time.perf_counter()
                _, st_plain = tpulp_torch.solve_milp(
                    lp, dtype=dt, batch_size=MILP_BATCH, return_stats=True,
                    device="cuda")
                torch.cuda.synchronize()
                secs_plain = time.perf_counter() - t0
            if bnb_counters(st_plain) != bnb_counters(st) or not vm_plain.n:
                raise AssertionError(
                    f"bench knapsack {name}: the plain lane loops' tree "
                    f"{bnb_counters(st_plain)} differs from the kernels' "
                    f"{bnb_counters(st)}")
            peak = torch.cuda.max_memory_allocated()
            if not (sol.status == "optimal" and sol.objective == oracle):
                raise AssertionError(f"bench knapsack {name}: {sol.status} "
                                     f"{sol.objective}, DP oracle {oracle}")
            if (dt == torch.float64
                    and st.nodes_solved != KNAPSACK_F64_NODES):
                raise AssertionError(
                    f"bench knapsack f64: {st.nodes_solved} nodes, tpulp's "
                    f"tree has {KNAPSACK_F64_NODES} (the fused FMA keeps "
                    "the card's pivots on tpulp's walk)")
            log(f"# MILP bench knapsack n={MILP_ITEMS} batch={MILP_BATCH} "
                f"{name}: optimal {sol.objective} = DP oracle; "
                + milp_stats_line(st, secs)
                + f"; peak device memory {peak / 2**20:.1f} MiB, pool "
                f"{st.pool_bytes / 2**20:.2f} MiB; the untimed first solve "
                f"took {first:.3f} s; launches {launches}, no vmapped step "
                f"loop; with the plain lane loops the same tree in "
                f"{secs_plain:.3f} s = {st.nodes_solved / secs_plain:.1f} "
                f"nodes/s ({vm_plain.n} vmapped loops)")
            res[f"bench_knapsack_{name}"] = {
                "counters": bnb_counters(st),
                "nodes": st.nodes_solved, "waves": st.waves,
                "gen_waves": st.gen_waves, "warm_nodes": st.warm_nodes,
                "warm_pivots": st.warm_pivots,
                "solo_resolves": st.solo_resolves, "seconds": secs,
                "nodes_per_s": st.nodes_solved / secs,
                "plain_loops_seconds": secs_plain,
                "plain_loops_nodes_per_s": st.nodes_solved / secs_plain,
                "t_assemble": st.t_assemble, "t_device": st.t_device,
                "t_process": st.t_process, "t_verify": st.t_verify,
                "peak_bytes": peak, "launches": launches}
        v, W, caps = md_knapsack()
        optima = {}
        for dt in (torch.float64, torch.float32):
            name = str(dt).replace("torch.", "")
            t0 = time.perf_counter()
            sol, st = tpulp_torch.solve_milp(
                knapsack_lp(v, W, caps), dtype=dt, batch_size=MILP_BATCH,
                return_stats=True, device="cuda")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            if sol.status != "optimal":
                raise AssertionError(f"md knapsack {name}: {sol.status}")
            x = [Fraction(sol.x[f"x{i}"]) for i in range(len(v))]
            if any(xi not in (0, 1) for xi in x):
                raise AssertionError(f"md knapsack {name}: x not binary")
            for r in range(MDK_ROWS):
                if sum(int(W[r, i]) * x[i] for i in range(len(v))) > caps[r]:
                    raise AssertionError(f"md knapsack {name}: row {r} "
                                         "violated")
            if sum(int(v[i]) * x[i] for i in range(len(v))) != sol.objective:
                raise AssertionError(f"md knapsack {name}: objective "
                                     "differs from v x")
            optima[name] = sol.objective
            log(f"# MILP {MDK_ROWS}-constraint knapsack n={MDK_ITEMS} seed "
                f"{MDK_SEED} {name}: optimal {sol.objective} (x binary and "
                f"feasible in Fractions); pool {st.pool_bytes} bytes; "
                + milp_stats_line(st, secs))
            res[f"md_knapsack_{name}"] = {
                "objective": str(sol.objective), "nodes": st.nodes_solved,
                "seconds": secs, "nodes_per_s": st.nodes_solved / secs,
                "pool_bytes": st.pool_bytes}
        if optima["float32"] != optima["float64"]:
            raise AssertionError(f"md knapsack optima differ: {optima}")
    finally:
        restore()
    for name in ("make_batched_states", "new_pool", "pool_write",
                 "pack_wave_summary", "run_simplex_batch", "run_warm_wave",
                 "run_expand_generation"):
        if calls[name] == 0:
            raise AssertionError(f"the MILP runs never called {name}")
    log(f"# MILP waves: every tensor on the card ({calls})")
    res["wave_calls"] = calls
    return res


def phase_drop_scatters():
    """Phase 7e: the writes tpulp drops out of range (``mode="drop"``) on
    the card. ``pool_write`` with padded (slot = cap) and past-capacity
    slots must leave exactly the valid writes in the pool; a device-built
    generation whose children overflow the batch must drop the lanes past
    B and agree with the same call on the host CPU (statuses, bases,
    genealogy)."""
    import torch

    from tpulp_torch import SolverOptions, lower_to_standard_form
    from tpulp_torch.batch import make_batched_states, run_simplex_batch
    from tpulp_torch.milp.bnb import _int_recover_matrix
    from tpulp_torch.solve.dual import (new_pool, pack_wave_summary,
                                        pool_write, run_expand_generation)

    cap, B = 6, 8
    rng = np.random.default_rng(3)
    T_wave = torch.tensor(rng.normal(size=(B, 5, 7)), device="cuda")
    basis = torch.tensor(rng.integers(0, 6, size=(B, 3)), device="cuda")
    slots = [3, 0, cap, 5, cap + 2, cap, cap + 9, 1]
    lanes = [7, 6, 5, 4, 3, 2, 1, 0]
    pool_T, pool_b = new_pool(cap, (5, 7), 3, torch.float64, "cuda")
    pool_write(pool_T, pool_b, np.array(slots, np.int32), T_wave, basis,
               np.array(lanes, np.int32))
    want = np.zeros((cap, 5, 7))
    for s_, l_ in zip(slots, lanes):
        if s_ < cap:
            want[s_] = T_wave[l_].cpu().numpy()
    if not np.array_equal(pool_T[:cap].cpu().numpy(), want):
        raise AssertionError("pool_write: padded or past-capacity slots "
                             "reached the pool")

    values, weights, cap_w = bench_knapsack(n_items=12, seed=1)
    sf = lower_to_standard_form(knapsack_lp(values, [weights], [cap_w]),
                                integer_bound_rows=True)
    names = list(sf.int_bound_rows)
    row_adj = {int(nm[2:]): (j, 1 if nm[1] == "s" else -1)
               for j, nm in enumerate(sf.col_names)
               if j >= sf.n_struct and nm[:2] in ("_s", "_e")}
    meta = [[], [], [], []]
    for nm in names:
        le_row, ge_row = sf.int_bound_rows[nm]
        for k, (col, sign) in enumerate((row_adj[le_row], row_adj[ge_row])):
            meta[2 * k].append(col)
            meta[2 * k + 1].append(float(sign))
    outs = {}
    for dev in ("cuda", "cpu"):
        st = make_batched_states([sf] * B, device=dev)
        opts = SolverOptions.for_dtype(st.T.dtype)
        out = run_simplex_batch(st, opts)
        R, const = (torch.as_tensor(x, device=dev) for x in
                    _int_recover_matrix(sf, names, st.T.shape[2] - 1,
                                        np.float64))
        summ = pack_wave_summary(out, R, const)
        f64 = dict(dtype=torch.float64, device=dev)
        bounds = torch.tensor([[0.0, 1.0]] * len(names), **f64)
        art0 = st.art_cols[0]
        outs[dev] = run_expand_generation(
            out.T, out.basis, summ, torch.ones(B, dtype=torch.bool,
                                               device=dev),
            bounds[:, 0].expand(B, -1), bounds[:, 1].expand(B, -1),
            st.col_active[0] & ~art0, art0,
            torch.tensor(meta[0], device=dev), torch.tensor(meta[1], **f64),
            torch.tensor(meta[2], device=dev), torch.tensor(meta[3], **f64),
            torch.tensor(-np.inf, **f64), torch.tensor(1e-6, **f64),
            opts.max_iters, R, const, opts=opts)
    g, c = outs["cuda"], outs["cpu"]
    expanded = int(g[5].sum())
    same = (torch.equal(g[0].status.cpu(), c[0].status)
            and torch.equal(g[0].basis.cpu(), c[0].basis)
            and all(torch.equal(x.cpu(), y) for x, y in zip(g[2:], c[2:]))
            and torch.equal(g[1][:, -2:].cpu(), c[1][:, -2:]))
    log(f"# drop-mode writes on the card: pool_write dropped slots "
        f"{[s_ for s_ in slots if s_ >= cap]}; a generation of B={B} lanes "
        f"expanded {expanded} parents into {int(g[2].sum())} child lanes "
        f"({max(0, 2 * expanded - B)} dropped); statuses, bases and "
        f"genealogy {'equal to' if same else 'DIFFERENT from'} the CPU's")
    if not same or 2 * expanded <= B:
        raise AssertionError("device-built generation: no overflow, or "
                             "the card and the CPU disagree")


def batched_pivot_ms(lane_cases):
    """ms per batched step (one pivot on every lane) at B = MILP_BATCH on
    the bench knapsack's node tableau, rank-1 and dual, f32 and f64: host
    clock around PIVOT_STEPS synchronised steps, and the device time and
    kernel count per step under torch.profiler; beside them the lane
    kernels' us a step on the knapsack's cold and warm waves (phase 7d's
    ``lane_cases``: the launch's time over its longest lane's steps)."""
    import torch

    from tpulp_torch import SolverOptions, lower_to_standard_form
    from tpulp_torch.batch import make_batched_states
    from tpulp_torch.solve.driver import simplex_step
    from tpulp_torch.solve.dual import dual_simplex_step

    values, weights, cap = bench_knapsack()
    sf = lower_to_standard_form(knapsack_lp(values, [weights], [cap]),
                                integer_bound_rows=True)
    res = {}
    for dt in (torch.float32, torch.float64):
        name = str(dt).replace("torch.", "")
        state = make_batched_states([sf] * MILP_BATCH, dtype=dt,
                                    device="cuda")
        opts = SolverOptions.for_dtype(dt)
        stall = opts.resolved_stall_limit(state.T.shape[1] - 2,
                                          state.T.shape[2] - 1)
        for kind, fn in (("rank-1", simplex_step),
                         ("dual", dual_simplex_step)):
            step = torch.func.vmap(
                lambda s, fn=fn: fn(s, opts, stall, 10 ** 9))
            s = state
            for _ in range(4):
                s = step(s)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(PIVOT_STEPS):
                s = step(s)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0) / PIVOT_STEPS

            def run(s=s):
                for _ in range(16):
                    s = step(s)

            wall, busy, kernels = device_busy(run)
            key = f"{kind} {name}"
            lane = lane_cases[name]["knapsack_cold" if kind == "rank-1"
                                    else "knapsack_warm"]
            res[key] = {"ms": ms, "device_ms": 1e3 * busy / 16,
                        "kernels": kernels / 16,
                        "busy_share": busy / wall,
                        "kernel_us_per_step": lane["us_per_step"],
                        "kernel_steps": lane["steps"]}
            log(f"# batched {kind} step, B={MILP_BATCH}, tableau "
                f"{tuple(state.T.shape[1:])} {name}: {ms:.3f} ms per step "
                f"(host clock, mean of {PIVOT_STEPS}); "
                f"device {1e3 * busy / 16:.3f} ms and {kernels / 16:.0f} "
                f"kernels per step, the card busy {100 * busy / wall:.1f}% "
                "of the traced 16 steps (torch.profiler); the lane kernel "
                f"{lane['us_per_step']:.2f} us a step ({lane['steps']} "
                "steps in one launch, CUDA events)")
    return res


# ---------------------------------------------------------------------------
# phase 7d: the lane kernels against the plain lane loops
# ---------------------------------------------------------------------------

# the streamed case: lanes of dense_leq_arrays(LANE_STREAM_M, LANE_STREAM_N)
# with their slacks, (258, 513) frames past a block's shared memory
LANE_STREAM_LANES, LANE_STREAM_M, LANE_STREAM_N = 8, 256, 256
# the clean-up case: lanes of small mixed-sign LPs, every row artificial,
# with a redundant row; phase 2 starts with artificials basic at zero
LANE_MIXED_LANES, LANE_MIXED_M, LANE_MIXED_N = 128, 16, 24
LANE_SEED = 7
# the card's sleep before a launch timed alone (~2.5 ms at the H100's
# clock): longer than the host's work for one wrapper call
SLEEP_CYCLES = 5_000_000
# the sleep before a run of single-stage launches from Python is timed
# (~10 ms): 64 of them take the host up to ~2.5 ms on a slow host
STEPS_SLEEP_CYCLES = 4 * SLEEP_CYCLES


def tensors_equal(label: str, a, b) -> None:
    """Raise unless the tensors ``a`` and ``b`` are equal bit for bit
    (floats compared as ``x + 0.0``, NaN equal to NaN)."""
    import torch

    a, b = a.cpu(), b.cpu()
    if a.shape != b.shape:
        raise AssertionError(f"{label}: shapes {a.shape} and {b.shape}")
    if a.is_floating_point():
        if not torch.equal(torch.isnan(a), torch.isnan(b)):
            raise AssertionError(f"{label}: NaN entries of the kernel and "
                                 "the plain loop differ")
        ints = torch.int64 if a.dtype == torch.float64 else torch.int32
        a = (a.nan_to_num(0.0, posinf=np.inf, neginf=-np.inf) + 0.0
             ).view(ints)
        b = (b.nan_to_num(0.0, posinf=np.inf, neginf=-np.inf) + 0.0
             ).view(ints)
    if not torch.equal(a, b):
        raise AssertionError(f"{label}: the kernel and the plain loop "
                             "differ")


def max_finite_diff(a, b) -> float:
    """The largest |a - b| over the entries finite in both."""
    import torch

    fin = torch.isfinite(a) & torch.isfinite(b)
    return float((a - b).abs()[fin].max()) if bool(fin.any()) else 0.0


def lanes_equal(k, p) -> float:
    """Raise unless the lane kernel's state ``k`` equals the plain loop's
    ``p`` bit for bit in every field (``tensors_equal``); returns the
    largest |difference| over the tableau entries finite in both."""
    for name, a, b in zip(k._fields, k, p):
        tensors_equal(f"lane field {name}", a, b)
    return max_finite_diff(k.T, p.T)


def device_time_ms(fn, runs: int) -> float:
    """Median over ``runs`` of ``fn()``'s time on the card alone: the card
    sleeps while the host does the call's own work, so the CUDA events
    bracket the launches and not the host time between them."""
    import torch

    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def lane_plans(kind: str, st, opts, stall: int, p, dev="cuda") -> dict:
    """7d's further holds of one case of the ``kind`` ("primal" or "dual")
    loop: the plan ``primal_lanes`` / ``dual_lanes`` takes (its route); on
    a resident frame the one-block kernel on one warp and on 256 threads,
    past it the one-block streamed plan, each bit for bit the plain loop
    ``p``; the route's stage split on block 0's clock, block 0 given the
    lane with the most pivots (its steps, its pivots and the step that
    ends it: us a stage a step, the block barriers a step)."""
    import torch

    from tpulp_torch.kernels import lanes as kl
    from tpulp_torch.kernels.rank1_cluster import (CLUSTER_STAGES,
                                                   rank1_cluster_lanes)
    from tpulp_torch.solve.lanes import dual_lanes_route, primal_lanes_route

    dual = kind == "dual"
    one_block = kl.lane_dual if dual else kl.lane_primal
    B, M, N = st.T.shape
    route = (dual_lanes_route if dual else primal_lanes_route)(
        M, N, st.T.dtype)
    out = {"route": route, "held": []}
    if route == "resident":
        others = {f"threads {th}": dict(threads=th) for th in (32, 256)}
    else:
        others = {"streamed": dict(resident=False)}
    for label, kw in others.items():
        lanes_equal(one_block(st, opts, stall, opts.max_iters, **kw), p)
        out["held"].append(label)
    if dev != "cuda":
        return out
    # block 0's clock on the lane with the most pivots, moved to the front
    # (lane 0 of a warm wave may not pivot)
    dn = p.niter - st.niter
    first = int(torch.argmax(dn))
    order = torch.tensor([first] + [b for b in range(B) if b != first],
                         device=dev)
    st = type(st)(*(x.index_select(0, order) for x in st))
    # its steps: its pivots and, where it ended below its budget, the step
    # that ended it
    steps0 = max(1, int(dn[first]) + int(int(p.status[first]) != 0))
    if route == "cluster":
        names = CLUSTER_STAGES
        cyc = torch.zeros(len(names), dtype=torch.int64, device=dev)
        rank1_cluster_lanes(st, opts, stall, opts.max_iters,
                            stage_cycles=cyc, dual=dual)
    else:
        names = kl.LANE_STAGES
        cyc = torch.zeros(len(names), dtype=torch.int64, device=dev)
        one_block(st, opts, stall, opts.max_iters, stage_cycles=cyc)
    sync(dev)
    hz = sm_clock_hz()
    vals = dict(zip(names, cyc.tolist()))
    if "barriers" in vals:
        out["barriers_per_step"] = vals.pop("barriers") / steps0
    out["stage_us_per_step"] = {k: 1e6 * v / hz / steps0
                                for k, v in vals.items()}
    out["lane0_steps"] = steps0
    return out


def lane_run(kind: str, st, opts, runs: int, plain_runs: int,
             dev="cuda"):
    """Phase 7d's check of one loop on one batched state: the kernel and
    its plain loop, held bit for bit; CUDA-event medians of ``runs``
    kernel calls and ``plain_runs`` plain calls (the call time, host work
    included; the first plain call is the one held) and of ``runs``
    kernel calls on the card alone
    (``device_time_ms``); the steps (the longest lane's pivots), the
    pivots, the bound. Returns (kernel state, plain state, stats)."""
    import torch

    from tpulp_torch.kernels import lane_dual_plan, lane_plan
    from tpulp_torch.solve import lanes

    from tpulp_torch.kernels import LAUNCHES, reset_launches

    fn = lanes.dual_lanes if kind == "dual" else lanes.primal_lanes
    ref_fn = (lanes.dual_lanes_reference if kind == "dual"
              else lanes.primal_lanes_reference)
    B, M, N = st.T.shape
    stall = opts.resolved_stall_limit(M - 2, N - 1)
    sync(dev)
    reset_launches()
    k = fn(st, opts, stall, opts.max_iters)
    sync(dev)
    launches = {name: v for name, v in LAUNCHES.items() if v}
    # the plain loop's call that the kernel is held to is also the first of
    # its ``plain_runs`` timed calls (CUDA events)
    plain = [] if dev != "cuda" else [torch.cuda.Event(enable_timing=True),
                                      torch.cuda.Event(enable_timing=True)]
    if plain:
        plain[0].record()
    p = ref_fn(st, opts, stall, opts.max_iters)
    if plain:
        plain[1].record()
    sync(dev)
    err = lanes_equal(k, p)
    extra = lane_plans(kind, st, opts, stall, p, dev)
    # a CPU rehearsal times nothing
    timed = cuda_time_ms if dev == "cuda" else lambda fn, runs: None
    ms = timed(lambda: fn(st, opts, stall, opts.max_iters), runs)
    plain_ms = None if not plain else float(np.median(
        [plain[0].elapsed_time(plain[1])] + [
            timed(lambda: ref_fn(st, opts, stall, opts.max_iters), 1)
            for _ in range(plain_runs - 1)]))
    device_ms = None if dev != "cuda" else device_time_ms(
        lambda: fn(st, opts, stall, opts.max_iters), runs)
    dn = (k.niter - st.niter).cpu()
    steps, pivots = int(dn.max()), int(dn.sum())
    es = st.T.element_size()
    flop_s = FP64_FLOP_S if st.T.dtype == torch.float64 else FP32_FLOP_S
    # each frame read and written once; one fma a tableau entry a pivot
    bound_ms, bound_by = bound(2.0 * B * M * N * es, 2.0 * pivots * M * N,
                               flop_s)
    plan = (lane_plan if kind == "primal" else lane_dual_plan)(
        M, N, st.T.dtype)
    statuses = {int(v): int(c) for v, c in
                zip(*np.unique(k.status.cpu().numpy(), return_counts=True))}
    return k, p, {
        "kind": kind, "lanes": B, "frame": [M, N],
        "resident": plan.resident, "launches": launches, **extra,
        "threads": plan.threads, "smem": plan.smem, "steps": steps,
        "pivots": pivots, "statuses": statuses, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms,
        "us_per_step": 1e3 * ms / steps if steps and ms else None,
        "device_ms": device_ms,
        "device_us_per_step": (1e3 * device_ms / steps
                               if steps and device_ms else None),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def phase1_lanes(rows, dt, dev):
    """A batched phase-1 state (every row artificial) of the (c, A, b)
    ``rows`` on ``dev``."""
    from tpulp_torch.core.state import Status, _numpy_state, from_numpy_state

    leaves = [_numpy_state(c, A, b, [-1] * A.shape[0], 0)
              + (Status.RUNNING, 0, 0, False, np.inf) for c, A, b in rows]
    return from_numpy_state([np.stack([x[i] for x in leaves])
                             for i in range(10)], device=dev, dtype=dt)


def mixed_rows(rng):
    """LANE_MIXED_LANES small LPs with mixed-sign rows at a sparse integer
    vertex, the last row the sum of the first two: (c, A, b) each."""
    m, n = LANE_MIXED_M, LANE_MIXED_N
    rows = []
    for _ in range(LANE_MIXED_LANES):
        A = rng.integers(-2, 4, size=(m, n)).astype(np.float64)
        x0 = rng.integers(0, 3, size=n).astype(np.float64)
        x0[rng.random(n) < 0.5] = 0.0
        A[A @ x0 < 0] *= -1.0
        A[-1] = A[0] + A[1]
        c = rng.integers(-5, 5, size=n).astype(np.float64)
        rows.append((c, A, A @ x0))
    return rows


def lane_inputs(dt, dev="cuda"):
    """Phase 7d's batched states on the card at ``dt``: the bench
    knapsack's cold wave (MILP_BATCH lanes, seeded bound fixings), 7c's
    scenarios cold in phase 1 (every row artificial), the streamed lanes
    and the clean-up lanes. Returns (knapsack cold, knapsack standard
    form, scenarios, streamed, mixed)."""
    import torch

    from tpulp_torch import lower_to_standard_form
    from tpulp_torch.batch import make_batched_states
    from tpulp_torch.milp import bnb

    rng = np.random.default_rng(LANE_SEED)
    values, weights, cap = bench_knapsack()
    sf = lower_to_standard_form(knapsack_lp(values, [weights], [cap]),
                                integer_bound_rows=True)
    names = list(sf.int_bound_rows)
    b_mat = []
    for _ in range(MILP_BATCH):
        fix = rng.choice(len(names), size=3, replace=False)
        bd = {names[i]: (v, v) for i, v in
              zip(fix, (int(x) for x in rng.integers(0, 2, size=3)))}
        b_mat.append([float(v) for v in bnb._node_standard_form(sf, bd).b])
    f = dict(dtype=dt, device=dev)
    mask = torch.tensor([1.0 if h < 0 else 0.0 for h in sf.basis_hint], **f)
    cold = bnb._refresh_template(make_batched_states([sf] * MILP_BATCH, **f),
                                 torch.tensor(b_mat, **f), mask)

    A, rhs, _, c = scenario_arrays()
    m = A.shape[0]
    Afull = np.concatenate([A, np.eye(m)], axis=1).astype(np.float64)
    cfull = np.concatenate([c, np.zeros(m)]).astype(np.float64)
    scen = phase1_lanes([(cfull, Afull, r.astype(np.float64)) for r in rhs],
                        dt, dev)

    streamed = make_batched_states(
        [scenario_form(*dense_leq_arrays(LANE_STREAM_M, LANE_STREAM_N,
                                         seed=k))
         for k in range(LANE_STREAM_LANES)], **f)
    return cold, sf, scen, streamed, phase1_lanes(mixed_rows(rng), dt, dev)


def rewritten(solved, cols, coef):
    """Warm frames: the terminal frames of ``solved`` with b moved through
    columns ``cols`` by ``coef`` (the waves' sparse RHS rewrite), phase-2
    lanes with the wave's broadcast masks."""
    from tpulp_torch.solve.dual import _lanes, _rhs_rewrite

    art0 = solved.art_cols[0]
    return _lanes(_rhs_rewrite(solved.T.clone(), cols, coef), solved.basis,
                  solved.col_active[0] & ~art0, art0)


def reopened(st):
    import torch

    from tpulp_torch.core import Status

    return st._replace(status=torch.where(st.status == Status.OPTIMAL,
                                          Status.RUNNING, st.status))


def phase_lane_kernels(dev="cuda"):
    """Phase 7d: ``lane_dual`` and ``lane_primal`` bit for bit against the
    plain lane loops (``*_lanes_reference``) at f32 and f64: the bench
    knapsack's cold wave (primal) and its warm frames with seeded RHS
    rewrites (the dual loop, then the clean-up), the same under a stall
    limit of 1 (the Bland switch), a NaN lane and an overflowing |b| sum
    (NUMERIC), 7c's scenarios cold in phase 1 under Dantzig and under the
    greatest increase with largest-pivot ties, small mixed-sign LPs whose
    phase 2 pivots basic artificials out and retires others, and lanes of
    258 x 513 (primal then dual). Each case runs its loop's route
    (``primal_lanes_route`` / ``dual_lanes_route``; resident: ``lane_primal``
    / ``lane_dual``; the 258 x 513 frames: the cluster lanes' primal or
    dual walk, with 0 one-block launches) and is held again on the other
    plans (resident: one warp and 256 threads; else the one-block streamed
    plan), with the route's stage split on block 0's clock and its block
    barriers a step. Each case is timed (CUDA events); the knapsack's cold
    and warm waves at f64 are the headline. Then (w) 128 lanes of 258 x 513
    on both plans past a block in turns, for the primal loop and for the
    dual loop, (t) tests/test_torch_lanes_card.py in a pytest process of
    its own, and (m) the cluster lanes' main path, ``solve_lp_batch`` over
    258 x 513 frames."""
    import dataclasses as dc

    import torch

    from tpulp_torch import SolverOptions
    from tpulp_torch.core.state import RULE_MAX_INCREASE, TIE_MAXPIV, Status

    res = {}
    for dt in (torch.float32, torch.float64):
        name = str(dt).replace("torch.", "")
        rng = np.random.default_rng(LANE_SEED)
        opts = SolverOptions.for_dtype(dt)
        stall_opts = dc.replace(opts, stall_limit=1, degen_tol=1e300)
        cold, sf, scen, streamed, mixed = lane_inputs(dt, dev)
        f = dict(dtype=dt, device=dev)
        cases = {}

        def run(label, kind, st, o, runs=5, plain_runs=1):
            k, p, stats = lane_run(kind, st, o, runs, plain_runs, dev)
            cases[label] = stats
            plan = stats.get("route") or (
                "resident" if stats["resident"] else "streamed")
            split = "" if "stage_us_per_step" not in stats else (
                f"; held too: {stats['held']}; stages (block 0, us a step) "
                + ", ".join(f"{k} {v:.3f}" for k, v in
                            stats["stage_us_per_step"].items())
                + (f", {stats['barriers_per_step']:.2f} block barriers a "
                   "step" if "barriers_per_step" in stats else ""))
            log(f"# 7d {label} {name}: {kind} loop, {stats['lanes']} lanes "
                f"of {tuple(stats['frame'])} ({plan}, {stats['threads']} "
                f"threads a block; launches {stats['launches']}){split}, "
                f"bit for bit the plain loop; {stats['steps']} steps, "
                f"{stats['pivots']} pivots, statuses {stats['statuses']}; "
                f"kernel {stats['ms']} ms a call, {stats['us_per_step']} "
                f"us a step (device {stats['device_ms']} ms, "
                f"{stats['device_us_per_step']} us a step), plain "
                f"{stats['plain_ms']} ms, bound "
                f"{stats['bound_ms']:.5f} ms ({stats['bound_by']})")
            return k, p

        _, solved = run("knapsack_cold", "primal", cold, opts, RUNS, 5)
        slack = [j for j, nm in enumerate(sf.col_names)
                 if j >= sf.n_struct and nm[:2] in ("_s", "_e")]
        cols = torch.tensor(rng.choice(slack, size=MILP_BATCH), device=dev)
        coef = torch.tensor(rng.uniform(-1.5, -0.25, size=MILP_BATCH), **f)
        warm = rewritten(solved, cols, coef)
        _, d = run("knapsack_warm", "dual", warm, opts, RUNS, 5)
        run("knapsack_warm_cleanup", "primal", reopened(d), opts)
        _, d = run("knapsack_warm_stall", "dual", warm, stall_opts)
        run("knapsack_warm_stall_cleanup", "primal", reopened(d), stall_opts)
        T = warm.T.clone()
        T[0, 3, -1] = float("nan")
        T[1, 3:5, -1] = torch.finfo(dt).max / 1.5
        k, _ = run("knapsack_numeric", "dual", warm._replace(T=T), opts)
        if k.status[:2].tolist() != [Status.NUMERIC] * 2:
            raise AssertionError(f"7d knapsack_numeric {name}: statuses "
                                 f"{k.status[:2].tolist()}, not NUMERIC")
        run("scenarios_phase1", "primal", scen, opts)
        run("scenarios_max_increase_maxpiv", "primal", scen,
            dc.replace(opts, rule=RULE_MAX_INCREASE, tie_break=TIE_MAXPIV))
        k, _ = run("mixed_cleanup", "primal", mixed, opts)
        if not bool((mixed.art_cols & ~k.art_cols).any()):
            raise AssertionError(f"7d mixed_cleanup {name}: no artificial "
                                 "was retired")
        _, solved = run("streamed_cold", "primal", streamed, opts)
        # each lane's row tightened by 0.5 to 1.5 times its largest b,
        # through the row's slack column
        rows = rng.integers(0, LANE_STREAM_M, size=LANE_STREAM_LANES)
        scale = torch.tensor(rng.uniform(0.5, 1.5, size=LANE_STREAM_LANES),
                             **f)
        warm_s = rewritten(
            solved, torch.as_tensor(LANE_STREAM_N + rows, device=dev),
            -scale * solved.T[:, 2:, -1].abs().amax(dim=1))
        _, d = run("streamed_warm", "dual", warm_s, opts)
        run("streamed_warm_cleanup", "primal", reopened(d), opts)
        for label, st in cases.items():
            want = "cluster" if label.startswith("streamed") else "resident"
            one_block = st["launches"].get(f"lane_{st['kind']}", 0)
            clusters = st["launches"].get("rank1_cluster_lanes", 0)
            counted = dev == "cuda" and ((want == "cluster" and (
                one_block or clusters != 1)) or (want == "resident" and (
                    one_block != 1 or clusters)))
            if st["route"] != want or counted:
                raise AssertionError(
                    f"7d {label} {name}: the route {st['route']} with "
                    f"launches {st['launches']}; the knapsack's frames "
                    f"must run lane_{st['kind']}'s resident plan and the "
                    "258 x 513 frames the cluster lanes, with 0 one-block "
                    "launches")
        if dt == torch.float64:
            wide = wide_states(dev)
            cases["wide_128"] = wide_lanes_turns(wide, dev)
            cases["wide_128_dual"] = wide_lanes_turns(wide, dev, dual=True)
        res[name] = cases
    res["card_tests"] = lanes_card_tests(dev)
    res["cluster_main_path"] = cluster_lanes_main_path(dev)
    return res


# 7d's 128 lanes of 258 x 513 frames (LANE_STREAM_M x LANE_STREAM_N), timed
# on the cluster lanes and on lane_primal's one-block streamed plan in turns
LANE_WIDE_LANES = 128


def wide_states(dev="cuda"):
    """7d (w)'s cold frames: LANE_WIDE_LANES LPs of LANE_STREAM_M x
    LANE_STREAM_N with their slacks (258 x 513 frames), f64."""
    import torch

    from tpulp_torch.batch import make_batched_states

    return make_batched_states(
        [scenario_form(*dense_leq_arrays(LANE_STREAM_M, LANE_STREAM_N,
                                         seed=k))
         for k in range(LANE_WIDE_LANES)], dtype=torch.float64, device=dev)


def wide_lanes_turns(st, dev="cuda", dual: bool = False) -> dict:
    """7d (w): the lanes of ``st`` (``wide_states``) on both plans past a
    block's shared memory, the cluster lanes (the route) and the one-block
    kernel a lane, each held bit for bit against the plain loop, then
    timed on the card alone in turns (cluster, one block, one block,
    cluster): the primal loop from the cold frames, or with ``dual`` the
    dual loop from their optimal frames with one row each tightened (as
    7d's streamed_warm)."""
    import torch

    from tpulp_torch import SolverOptions
    from tpulp_torch.solve import lanes

    dt = st.T.dtype
    opts = SolverOptions.for_dtype(dt)
    stall = opts.resolved_stall_limit(LANE_STREAM_M, LANE_STREAM_M
                                      + LANE_STREAM_N)
    loop, ref_fn = lanes.primal_lanes, lanes.primal_lanes_reference
    if dual:
        solved = lanes.primal_lanes(st, opts, stall, opts.max_iters)
        rng = np.random.default_rng(LANE_SEED)
        rows = rng.integers(0, LANE_STREAM_M, size=LANE_WIDE_LANES)
        scale = torch.tensor(rng.uniform(0.5, 1.5, size=LANE_WIDE_LANES),
                             dtype=dt, device=dev)
        st = rewritten(
            solved, torch.as_tensor(LANE_STREAM_N + rows, device=dev),
            -scale * solved.T[:, 2:, -1].abs().amax(dim=1))
        loop, ref_fn = lanes.dual_lanes, lanes.dual_lanes_reference
    p = ref_fn(st, opts, stall, opts.max_iters)
    routes = {"cluster": None, "streamed": None}
    for route in routes:
        routes[route] = loop(st, opts, stall, opts.max_iters, route=route)
        sync(dev)
        lanes_equal(routes[route], p)
    steps = int((p.niter - st.niter).max())
    pivots = int((p.niter - st.niter).sum())
    B, M, N = st.T.shape
    # each frame read and written once; one fma a tableau entry a pivot
    bound_ms, bound_by = bound(2.0 * B * M * N * 8, 2.0 * pivots * M * N,
                               FP64_FLOP_S)
    route_of = lanes.dual_lanes_route if dual else lanes.primal_lanes_route
    kind = "dual" if dual else "primal"
    out = {"kind": kind, "lanes": LANE_WIDE_LANES, "frame": [M, N],
           "steps": steps, "pivots": pivots, "bound_ms": bound_ms,
           "bound_by": bound_by, "route": route_of(M, N, dt)}
    if dev != "cuda":
        return out
    turns = {"cluster": [], "streamed": []}
    for route in ("cluster", "streamed", "streamed", "cluster"):
        turns[route].append(device_time_ms(lambda: loop(
            st, opts, stall, opts.max_iters, route=route), 5))
    for route, ms in turns.items():
        out[route] = {"device_ms": ms,
                      "us_per_step": [1e3 * t / steps for t in ms]}
    log(f"# 7d (w) {kind} loop, {LANE_WIDE_LANES} lanes of "
        f"{tuple(out['frame'])} f64, {steps} steps, {pivots} pivots (bound "
        f"{bound_ms:.5f} ms, {bound_by}), each plan bit for bit the plain "
        f"loop: the cluster lanes {turns['cluster']} ms, lane_{kind}'s one "
        f"block a lane {turns['streamed']} ms (device, in turns); the route "
        f"{out['route']}")
    return out


def lanes_card_tests(dev):
    """7d (t): tests/test_torch_lanes_card.py, the lane kernels' and the
    cluster lanes' ``cuda`` tests (each against its plain version on the
    CPU's small cases: both resident plans, the streamed plan, every
    cluster size, frozen lanes, a budget of 1, broadcast masks), run on the
    card in a process of their own; a failure, or a test that skips, fails
    the run."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda",
           "-q", "-p", "no:cacheprovider", "tests/test_torch_lanes_card.py"]
    if dev != "cuda":
        return {"skipped": "no card"}
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                          timeout=600)
    secs = time.perf_counter() - t0
    tail = proc.stdout.strip().splitlines()[-1:] or [""]
    log(f"# 7d (t) {' '.join(cmd[2:])}: exit {proc.returncode}, "
        f"{tail[0]} ({secs:.1f} s)")
    if proc.returncode != 0 or "skipped" in tail[0] or \
            "passed" not in tail[0]:
        raise AssertionError(f"7d (t): the lane kernels' card tests: "
                             f"{proc.stdout[-4000:]}{proc.stderr[-2000:]}")
    return {"summary": tail[0], "seconds": secs}


def cluster_lanes_main_path(dev="cuda") -> dict:
    """7d (m): the cluster lanes' main path, ``solve_lp_batch`` over
    LANE_STREAM_LANES LPs of 256 x 256 (258 x 513 frames, past a block's
    shared memory): the launch counts set to 0 just before it and read
    just after (one rank1_cluster_lanes launch, no one-block lane_primal
    launch), every lane optimal and its objective equal to the solo
    solve's (solve_lp, on rank1_cluster)."""
    import tpulp_torch
    from tpulp_torch.kernels import LAUNCHES, reset_launches

    forms = [scenario_form(*dense_leq_arrays(LANE_STREAM_M, LANE_STREAM_N,
                                             seed=k))
             for k in range(LANE_STREAM_LANES)]
    sync(dev)
    reset_launches()
    t0 = time.perf_counter()
    sols = tpulp_torch.solve_lp_batch(forms, device=dev)
    sync(dev)
    secs = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    solo = [tpulp_torch.solve_lp(f, device=dev) for f in forms]
    bad = [k for k, (a, s) in enumerate(zip(sols, solo))
           if a.status != "optimal" or a.objective != s.objective]
    log(f"# 7d (m) solve_lp_batch {LANE_STREAM_LANES} LPs of "
        f"{LANE_STREAM_M}x{LANE_STREAM_N}: {secs:.3f} s, launches "
        f"{ {k: v for k, v in launches.items() if v} }; objectives "
        f"{'equal to the solo solves' if not bad else 'DIFFER'}")
    if bad:
        raise AssertionError(f"7d (m): lanes {bad} differ from their solo "
                             "solves")
    if dev == "cuda" and (launches.get("rank1_cluster_lanes", 0) < 1
                          or launches.get("lane_primal", 0) != 0):
        raise AssertionError(f"7d (m): launches {launches}: the batch must "
                             "run the cluster lanes and no one-block "
                             "lane_primal")
    return {"seconds": secs, "launches": launches}


def scenario_form(A, b, c):
    """min c x, A x <= b, x >= 0 with a slack basis, as a StandardForm."""
    m, n = A.shape
    return standard_form(np.concatenate([c, np.zeros(m, dtype=c.dtype)]),
                         np.concatenate([A, np.eye(m, dtype=A.dtype)],
                                        axis=1), b, list(range(n, n + m)), n)


def dense_leq_arrays(m: int, n: int, seed: int = 0):
    """tests/test_warm_start.py's recipe: min c x, A x <= b, x >= 0 with
    A = |N(0, 1)| + 0.1, b = A x0 + |N(0, 1)| + 0.5, c = -(|N(0, 1)| + 0.1).
    Returns (A, b, c)."""
    rng = np.random.default_rng(seed)
    A = np.abs(rng.normal(size=(m, n))) + 0.1
    x0 = np.abs(rng.normal(size=n))
    b = A @ x0 + np.abs(rng.normal(size=m)) + 0.5
    c = -(np.abs(rng.normal(size=n)) + 0.1)
    return A, b, c


def scenario_arrays():
    """(A, the SCEN_LANES scenario RHS, the base RHS, c) of one SCEN_M x
    SCEN_N integer LP, seed 0."""
    rng = np.random.default_rng(0)
    A = rng.integers(1, 10, size=(SCEN_M, SCEN_N))
    b = A @ rng.integers(0, 3, size=SCEN_N) + rng.integers(1, 20,
                                                           size=SCEN_M)
    c = -rng.integers(1, 10, size=SCEN_N)
    rhs = [b - rng.integers(0, b // 10 + 2) for _ in range(SCEN_LANES)]
    return A, rhs, b, c


def scenario_batch():
    """(the SCEN_LANES RHS scenarios, the base form) of one SCEN_M x
    SCEN_N integer LP, seed 0."""
    A, rhs, b, c = scenario_arrays()
    return [scenario_form(A, r, c) for r in rhs], scenario_form(A, b, c)


def phase_batch_and_warm():
    """Phase 7c: ``solve_lp_batch`` over SCEN_LANES RHS scenarios of one
    SCEN_M x SCEN_N integer LP, cold and with ``warm_start`` (statuses and
    exact objectives equal lane for lane, fewer pivots warm), then
    ``solve_lp(warm_start=)`` on tests/test_warm_start.py's recipe at
    WARM_M x WARM_N with three rows tightened by 0.8 (the objective within
    one f64 ulp of the cold solve's, fewer pivots)."""
    import math

    import tpulp_torch

    scens, base_form = scenario_batch()
    base = tpulp_torch.solve_lp(base_form, device="cuda")
    times = {}
    t0 = time.perf_counter()
    cold = tpulp_torch.solve_lp_batch(scens, device="cuda")
    times["cold"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    warm = tpulp_torch.solve_lp_batch(scens, warm_start=base, device="cuda")
    times["warm"] = time.perf_counter() - t0
    bad = [k for k, (w, cd) in enumerate(zip(warm, cold))
           if w.status != cd.status or w.objective != cd.objective]
    if bad or any(s.status != "optimal" for s in cold):
        raise AssertionError(f"scenario batch: lanes {bad} differ")
    piv = {k: sum(s.niter for s in v) for k, v in
           (("cold", cold), ("warm", warm))}
    if not piv["warm"] < piv["cold"]:
        raise AssertionError(f"scenario batch: warm took {piv}")
    log(f"# solve_lp_batch {SCEN_LANES} scenarios of {SCEN_M}x{SCEN_N}: "
        f"statuses and exact objectives equal lane for lane; pivots cold "
        f"{piv['cold']}, warm {piv['warm']}; {times['cold']:.2f} s cold, "
        f"{times['warm']:.2f} s warm (exact refinement per lane included)")

    A, b, c = dense_leq_arrays(WARM_M, WARM_N)
    sol = tpulp_torch.solve_lp(scenario_form(A, b, c), device="cuda")
    b2 = b.copy()
    b2[:3] *= 0.8
    form2 = scenario_form(A, b2, c)
    t0 = time.perf_counter()
    cold2 = tpulp_torch.solve_lp(form2, device="cuda")
    t_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    warm2 = tpulp_torch.solve_lp(form2, warm_start=sol, device="cuda")
    t_warm = time.perf_counter() - t0
    ok = (cold2.status == warm2.status == "optimal"
          and abs(warm2.objective - cold2.objective)
          <= math.ulp(cold2.objective))
    log(f"# solve_lp(warm_start=) {WARM_M}x{WARM_N}, three rows x 0.8: "
        f"cold {cold2.status} {cold2.objective!r} in {cold2.niter} pivots "
        f"({t_cold:.2f} s), warm {warm2.status} {warm2.objective!r} in "
        f"{warm2.niter} pivots ({t_warm:.2f} s)")
    if not ok or not warm2.niter < cold2.niter:
        raise AssertionError("warm re-solve: objective beyond one ulp or "
                             "no fewer pivots")
    return {"batch_pivots": piv, "batch_seconds": times,
            "warm_lp": {"cold_niter": cold2.niter,
                        "warm_niter": warm2.niter}}


# ---------------------------------------------------------------------------
# phase 8: the bounded-variable simplex and the exact layer
# ---------------------------------------------------------------------------

def bounded_arrays(m: int, n: int, seed: int = 0):
    """bench.py's instance recipe without its sum row (D ~ N(0, 1), b =
    |D x0| + |N(0, 1)|, free-sign c ~ N(0, 1)) with a finite upper bound
    u_j = 2 x0_j + 1 on every structural: (D, b, c, u)."""
    rng = np.random.default_rng(seed)
    D = rng.normal(size=(m, n))
    x0 = np.abs(rng.normal(size=n))
    b = np.abs(D @ x0) + np.abs(rng.normal(size=m))
    c = rng.normal(size=n)
    return D, b, c, 2.0 * x0 + 1.0


def bounded_form(m: int, n: int, seed: int = 0):
    """``bounded_arrays``' LP with a slack basis as a simple_bounds
    StandardForm (no bound rows). Returns (form, D, b, u)."""
    D, b, c, u = bounded_arrays(m, n, seed)
    sf = scenario_form(D, b, c)
    return (dataclasses.replace(sf, upper=u.tolist() + [None] * m), D, b,
            u)


def bounded_state(sf, dev, dtype, devex: bool = True, **kw):
    """(state, options) of the bounded walk of ``sf`` from its initial
    basis, devex (weights at 1) or Dantzig, options overridden by
    ``kw``."""
    import torch

    from tpulp_torch import SolverOptions
    from tpulp_torch.core.state import RULE_DANTZIG, RULE_DEVEX
    from tpulp_torch.solve.api import state_from_standard_form
    from tpulp_torch.solve.bounded import make_bounded_state

    opts = SolverOptions.for_dtype(
        dtype, rule=RULE_DEVEX if devex else RULE_DANTZIG, **kw)
    bs = make_bounded_state(state_from_standard_form(sf, dtype=dtype,
                                                     device=dev), sf.upper)
    if devex:
        bs = bs._replace(gamma=torch.ones_like(bs.upper))
    return bs, opts


def bounded_equal(k, p) -> float:
    """Raise unless two bounded states agree in every field (the tableau
    as ``T + 0.0``, NaN equal to NaN; at_upper, gamma); returns the largest
    |difference| of the tableaus' entries finite in both."""
    import torch

    err = lanes_equal(k.s, p.s)
    if not torch.equal(k.at_upper.cpu(), p.at_upper.cpu()):
        raise AssertionError("bounded walk: at_upper differs")
    if (k.gamma is None) != (p.gamma is None) or (
            k.gamma is not None and not torch.equal(
                k.gamma.cpu() + 0.0, p.gamma.cpu() + 0.0)):
        raise AssertionError("bounded walk: gamma differs")
    return err


def bounded_walk_check(sf, dev, dtype, label: str, devex: bool = True,
                       **kw):
    """One bounded walk from the initial basis through ``run_simplex_bounded``
    on the card (``bounded_route``'s kernel: ``bounded_grid``, one launch
    and no other) twice, timed on the host clock, and once through the
    plain loop (``run_simplex_bounded_reference``); the walk held equal to
    it in every field."""
    from tpulp_torch.kernels import LAUNCHES, reset_launches
    from tpulp_torch.kernels.bounded import FLIPS
    from tpulp_torch.solve.bounded import (run_simplex_bounded,
                                           run_simplex_bounded_reference)

    bs, opts = bounded_state(sf, dev, dtype, devex, **kw)
    sync(dev)
    runs = []
    for _ in range(2):
        flips0 = dict(FLIPS)
        reset_launches()
        t0 = time.perf_counter()
        k = run_simplex_bounded(bs, opts)
        sync(dev)
        runs.append(time.perf_counter() - t0)
        launches = dict(LAUNCHES)
        flips = {key: FLIPS[key] - flips0[key] for key in FLIPS}
    t0 = time.perf_counter()
    p = run_simplex_bounded_reference(bs, opts)
    sync(dev)
    plain_secs = time.perf_counter() - t0
    err = bounded_equal(k, p)
    niter = int(k.s.niter)
    res = {"status": int(k.s.status), "niter": niter,
           "bland": bool(k.s.bland), "seconds": min(runs),
           "seconds_turns": runs, "plain_seconds": plain_secs,
           "max_abs_err": err,
           "bounded_grid": launches["bounded_grid"],
           "fused_fma": launches["fused_fma"], **flips}
    log(f"# 8a {label}: the grid walk equals the plain walk in every field "
        f"(status {res['status']}, {niter} steps, bland {res['bland']}, "
        f"{res['entering_flips']} entering flips and {res['upper_hits']} "
        f"upper hits); host clock {runs} s, the plain walk "
        f"{plain_secs:.2f} s; launches: grid {launches['bounded_grid']} "
        f"(FMA {launches['fused_fma']})")
    if dev == "cuda" and not (launches["bounded_grid"] == 1
                              and launches["fused_fma"] == 0):
        raise AssertionError(f"8a {label}: launches {launches}")
    return res


def grid_reference_check(sf, dev, dtype, label: str, window: int,
                         devex: bool = True):
    """``bounded_grid`` on the plan's grid (resident or streamed) against
    its plain version ``bounded_grid_reference`` on the same slabs, on the
    card, over the devex (or Dantzig) walk's first ``window`` steps: every
    field equal, the entering flips and upper hits too. Returns the largest
    |difference| of the tableaus' finite entries, the plain version's ms a
    step and the plan's resident rows."""
    from tpulp_torch.kernels import bounded_grid as kg
    from tpulp_torch.kernels.bounded import FLIPS
    from tpulp_torch.kernels.launch import sm_count

    bs, opts = bounded_state(sf, dev, dtype, devex)
    stall = opts.resolved_stall_limit(bs.s.m, bs.s.n)
    plan = kg.bounded_grid_plan(*bs.s.T.shape, dtype, sm_count(bs.s.T.device)
                                if dev == "cuda" else kg.GRID_SMS)
    flips0 = dict(FLIPS)
    k = kg.bounded_grid(bs, opts, stall, window) if dev == "cuda" else \
        kg.bounded_grid_reference(bs, opts, stall, window, plan.blocks)[0]
    sync(dev)
    kflips = {key: FLIPS[key] - flips0[key] for key in FLIPS}
    t0 = time.perf_counter()
    p, counts = kg.bounded_grid_reference(bs, opts, stall, window,
                                          plan.blocks)
    sync(dev)
    plain_ms = 1e3 * (time.perf_counter() - t0) / max(1, int(p.s.niter))
    err = bounded_equal(k, p)
    if dev == "cuda" and kflips != counts:
        raise AssertionError(f"8a {label}: flips {kflips} against {counts}")
    log(f"# 8a {label}: bounded_grid (G {plan.blocks}, W {plan.width}, "
        f"{plan.rows} of {bs.s.T.shape[0]} rows in shared memory) equals "
        f"bounded_grid_reference on the card in every field over "
        f"{int(k.s.niter)} steps; the plain version {plain_ms:.3f} ms a step")
    return {"max_abs_err": err, "plain_ms_per_step": plain_ms,
            "steps": int(k.s.niter), "rows": plan.rows}


def launches_us(fn, steps: int):
    """(device us, host us) a step of ``fn()``, which enqueues ``steps``
    steps with no host read: CUDA events after a sleep of the card that
    outlasts the host's enqueue (``STEPS_SLEEP_CYCLES``), so that they
    bracket the launches alone; and the host's time to enqueue them."""
    import torch

    torch.cuda.synchronize()
    torch.cuda._sleep(STEPS_SLEEP_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    fn()
    host = time.perf_counter() - t0
    stop.record()
    stop.synchronize()
    return 1e3 * start.elapsed_time(stop) / steps, 1e6 * host / steps


def bounded_step_window(sf, dev, dtype):
    """(device ms, kernels, host ms) per plain bounded step
    (BND_PRICING), from 16 steps from the initial basis under
    torch.profiler: the plain step the kernels replace."""
    from tpulp_torch.solve.bounded import bounded_simplex_step

    bs, opts = bounded_state(sf, dev, dtype, BND_PRICING == "devex")
    stall = opts.resolved_stall_limit(bs.s.m, bs.s.n)

    def window(bs=bs):
        for _ in range(16):
            bs = bounded_simplex_step(bs, opts, stall, None)

    window()
    wall, busy, kernels = device_busy(window)
    return {"plain_device_ms_per_step": 1e3 * busy / 16,
            "plain_kernels_per_step": kernels / 16,
            "plain_host_ms_per_step": 1e3 * wall / 16}


def grid_edge_walks(dev="cuda"):
    """8a (e): ``bounded_grid`` bit for bit against ``bounded_grid_reference``
    (on CPU copies, the same slabs) at f64 and f32 on small frames (8b's
    first box LP, 12 x 20 and 40 x 90 box LPs) under Dantzig, devex, a
    stall limit of 1 (Bland), a budget of 7, a NaN in the RHS (NUMERIC),
    devex weights above the reset threshold and a basic column that is
    not a unit vector (every step through barrier C): each of the 21 walks
    resident on the plan's grid at each type, and again on the
    device-vector plan forced (rows 3 or M - 1 in shared memory, on the
    plan's grid or 3 or 7 blocks, in turn) and on the wide plan forced (no
    row in shared memory, on the plan's grid or 3 or 7 blocks); and every
    forced split once at each type, spread over the walks (stride 8 of
    21): resident on 3, 1, 2 and 7 blocks, streamed at rows 3, M // 2 and
    M - 1 in shared memory on the plan's grid and on 1, 2, 3 and 7 blocks;
    the flips too. Returns the cases' counts (resident, streamed, device
    vectors, wide)."""
    import torch

    from tpulp_torch.kernels import bounded_grid as kg
    from tpulp_torch.kernels.bounded import FLIPS
    from tpulp_torch.kernels.launch import sm_count

    sms = sm_count(torch.device(dev)) if dev == "cuda" else kg.GRID_SMS

    def cpu(bs):
        return bs._replace(s=type(bs.s)(*(x.cpu() for x in bs.s)), **{
            k: None if getattr(bs, k) is None else getattr(bs, k).cpu()
            for k in ("upper", "at_upper", "gamma")})

    forms = {"box64x128": box_form(0, 64, 128),
             "box12x20": box_form(3, 12, 20),
             "bnd40x90": bounded_form(40, 90)[0]}
    rules = {"dantzig": {}, "devex": {},
             "bland": dict(stall_limit=1, degen_tol=1e300, max_iters=300),
             "budget7": dict(max_iters=7), "numeric": {}, "big_weights": {},
             "not_unit": {}}
    pairs = [(f, r) for f in forms for r in rules]
    # the forced splits: resident on G blocks, streamed at split q (rows 3,
    # M // 2, M - 1) on G blocks (None: the plan's)
    forced = [(None, b) for b in (3, 1, 2, 7)] + [
        (q, b) for q in range(3) for b in (None, 1, 2, 3, 7)]
    count = {"resident": 0, "streamed": 0, "device": 0, "wide": 0}
    t0 = time.perf_counter()
    for off, dt in enumerate((torch.float64, torch.float32)):
        tiny = 1e-300 if dt == torch.float64 else 1e-30
        walks = [(f, r, None, None, None) for f, r in pairs] + [
            (*pairs[(8 * i + 3 * off) % len(pairs)], q, b, None)
            for i, (q, b) in enumerate(forced)] + [
            (f, r, (0, 2)[i % 2], (None, 3, 7)[i % 3], "device")
            for i, (f, r) in enumerate(pairs)] + [
            (f, r, None, (None, 3, 7)[i % 3], "wide")
            for i, (f, r) in enumerate(pairs)]
        for fname, rule, q, blocks, vectors in walks:
            kw = rules[rule]
            devex = rule in ("devex", "numeric", "big_weights")
            bs, opts = bounded_state(forms[fname], dev, dt, devex, **kw)
            T = bs.s.T.clone()
            if rule == "numeric":
                T[4, -1] = float("nan")
            if rule == "not_unit":
                T[0, int(bs.s.basis[1])] = tiny
            bs = bs._replace(s=bs.s._replace(T=T))
            if rule == "big_weights":
                g = bs.gamma.clone()
                g[::3] = 3e8
                bs = bs._replace(gamma=g)
            stall = opts.resolved_stall_limit(bs.s.m, bs.s.n)
            M = bs.s.T.shape[0]
            rows = None if q is None else (3, M // 2, M - 1)[q]
            plan = kg.bounded_grid_plan(*bs.s.T.shape, dt, sms,
                                        blocks=blocks, rows=rows,
                                        vectors=vectors)
            flips0 = dict(FLIPS)
            k = kg.bounded_grid(bs, opts, stall, opts.max_iters,
                                blocks=blocks, rows=rows, vectors=vectors) \
                if dev == "cuda" else kg.bounded_grid_reference(
                    bs, opts, stall, opts.max_iters, plan.blocks,
                    plan.vectors)[0]
            sync(dev)
            p, counts = kg.bounded_grid_reference(
                cpu(bs), opts, stall, opts.max_iters, plan.blocks,
                plan.vectors)
            bounded_equal(cpu(k), p)
            got = {key: FLIPS[key] - flips0[key] for key in FLIPS}
            if dev == "cuda" and got != counts:
                raise AssertionError(f"8a (e) {fname} {rule} {dt} "
                                     f"G {plan.blocks} R {plan.rows}: flips "
                                     f"{got} against {counts}")
            count[vectors or ("resident" if rows is None
                              else "streamed")] += 1
    log(f"# 8a (e) bounded_grid equals bounded_grid_reference in every field "
        f"(the flips too) on {count['resident']} resident, "
        f"{count['streamed']} streamed, {count['device']} device-vector and "
        f"{count['wide']} wide small walks: 3 frames x Dantzig, devex, "
        "Bland, a budget, a NaN, weights above 1e8, a basic column that is "
        "not a unit vector, each on the plan's grid and on the device-vector "
        "and wide plans forced at f64 and f32; every forced split once a "
        "type: resident on 3, 1, 2 and 7 "
        "blocks, streamed at rows 3, M // 2 and M - 1 on the plan's grid and "
        f"1, 2, 3 and 7 blocks ({time.perf_counter() - t0:.1f} s)")
    return count


def grid_bounds(M: int, N: int, es: int, G: int, steps: int, clock_hz: float,
                rows: int | None = None):
    """A grid step's bounds, ms: (the walk's, by bytes or operations:
    the frame read and written once a walk over 3.35 TB/s and one fma an
    entry a step at the FP64 / FP32 peak, the larger; the kernel's own
    convention: the frame loaded and stored once a launch over 3.35 TB/s
    divided by the steps, plus a step's vector traffic (every block reads
    the G mailboxes of 48 bytes, column j and the verdict; they are written
    once) over 3.35 TB/s, plus the slab's resident rows (``rows``, all by
    default) read and written from shared memory at 128 bytes a clock on
    132 SMs and its streamed rows read and written once over 3.35 TB/s;
    the table's step convention: the tableau read and written once a step
    over 3.35 TB/s)."""
    frame = 2.0 * M * N * es
    R = M if rows is None else rows
    walk = bound(frame / steps, 2.0 * M * N,
                 FP64_FLOP_S if es == 8 else FP32_FLOP_S)
    vectors = G * (G * 48 + M * es + 32) + G * 48 + M * es + 32
    smem_rate = 132 * 128 * clock_hz
    streamed = 2.0 * (M - R) * N * es
    own = 1e3 * ((frame / steps + vectors + streamed) / HBM_BYTES_S
                 + 2.0 * R * N * es / smem_rate)
    step = bound(frame, 0.0, FP64_FLOP_S)[0]
    return walk, own, step


def bounded_grid_us(sf, dev, dtype, devex: bool = True,
                    advance: int = BND_TIMED_FROM,
                    steps: int = BND_GRID_TIMED_STEPS, state=None, **kw):
    """One ``bounded_grid`` launch of ``steps`` steps of the devex (or
    Dantzig; options overridden by ``kw``) walk ``advance`` steps in, on
    the card alone (CUDA events after a sleep that
    covers the host's work; median of three), by stage: block 0's cycles
    of each stage (``stage_cycles``) as a share of the launch's, times its
    device time, so that no SM clock is assumed; the ratio test on the
    clock of the block that owns the entering column apart ("owner"; the
    device-vector plan's spans under their own names, ``grid_stages``).
    With the plan (G, W, R, TR, scratch, the vectors' place, shared
    memory) and the occupancy. ``state``, a (state, options) pair, walks
    in place of ``sf``'s."""
    import torch

    from tpulp_torch.kernels import bounded_grid as kg
    from tpulp_torch.kernels.launch import sm_count

    bs, opts = bounded_state(sf, dev, dtype, devex, **kw) if state is None \
        else state
    stall = opts.resolved_stall_limit(bs.s.m, bs.s.n)
    M, N = bs.s.T.shape
    plan = kg.bounded_grid_plan(M, N, dtype, sm_count(bs.s.T.device))
    mid = kg.bounded_grid(bs, opts, stall, advance)
    if int(mid.s.niter) != advance:
        raise AssertionError(f"8a: the grid walk ended before step {advance}")
    dev_us, host_us = [], []
    for _ in range(3):
        d, h = launches_us(lambda: kg.bounded_grid(mid, opts, stall,
                                                   advance + steps), steps)
        dev_us.append(d)
        host_us.append(h)
    cyc = torch.zeros(len(kg.GRID_STAGES), dtype=torch.int64, device=dev)
    out = kg.bounded_grid(mid, opts, stall, advance + steps,
                          stage_cycles=cyc)
    if int(out.s.niter) != advance + steps:
        raise AssertionError("8a: the timed grid steps ran past the walk")
    names = kg.grid_stages(plan)
    c = dict(zip(names, cyc.tolist()))
    owner = c.pop(names[-1])
    total = sum(c.values())
    us = float(np.median(dev_us))
    per_cycle = us * steps / total
    split = {k: v * per_cycle / steps for k, v in c.items()
             if k not in ("load", "store")}
    split["load_and_store_per_launch"] = (c["load"] + c["store"]) * per_cycle
    split[names[-1]] = owner * per_cycle / steps
    return {"device_us_per_step": us,
            "host_us_per_step": float(np.median(host_us)),
            "device_us_by_stage": split, "blocks": plan.blocks,
            "width": plan.width, "smem": plan.smem, "rows": plan.rows,
            "scratch": plan.scratch, "tile_rows": plan.tile_rows,
            "vectors": plan.vectors,
            "steps": steps, "advance": advance,
            "es": bs.s.T.element_size(),
            "occupancy": kg.bounded_grid_occupancy(
                M, N, dtype, devex, bs.s.T.device)}


def wide_bounded_lp(dev, clock_hz: float):
    """8a (w): ``solve_lp`` on a BND_WIDE_M x BND_WIDE_N box LP, whose
    frame is past the resident slab at f64 and f32 (``bounded_route``:
    "bounded_grid" on a streamed plan): optimal on the device rung and
    certified in one ``bounded_grid`` launch (no FMA launch); its walk's
    first BND_WIDE_WINDOW steps, at f64 and f32, held to the plain loop and
    to ``bounded_grid_reference`` on the card in every field; the streamed
    launch (BND_GRID_TIMED_STEPS steps from BND_TIMED_FROM) timed by stage
    twice, with its bounds."""
    import torch

    import tpulp_torch
    from tpulp_torch.kernels import LAUNCHES, reset_launches
    from tpulp_torch.kernels import bounded_grid as kg
    from tpulp_torch.kernels.launch import sm_count
    from tpulp_torch.solve.bounded import (bounded_route,
                                           run_simplex_bounded,
                                           run_simplex_bounded_reference)
    from tpulp_torch.solve.refine import float_bounded_certificate

    m, n = BND_WIDE_M, BND_WIDE_N
    sf = bounded_form(m, n, seed=1)[0]
    M, N = m + 2, n + m + 1
    sms = sm_count(torch.device(dev)) if dev == "cuda" else 132
    route = bounded_route(M, N, torch.float64, sms)
    plans = {dt: kg.bounded_grid_plan(M, N, dt, sms)
             for dt in (torch.float64, torch.float32)}
    if route != "bounded_grid" or any(p.rows >= M for p in plans.values()):
        raise AssertionError(f"8a (w): {M} x {N} takes {route}, plans "
                             f"{plans}")
    sync(dev)
    reset_launches()
    t0 = time.perf_counter()
    sol = tpulp_torch.solve_lp(sf, dtype=torch.float64, device=dev,
                               pricing=BND_PRICING, max_iters=BND_MAX_ITERS)
    sync(dev)
    secs = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    primal_ok, dual_ok = float_bounded_certificate(sf, sol.basis,
                                                   sol.at_upper)
    log(f"# 8a (w) box LP {m}x{n} ({M} x {N}, streamed: "
        f"{plans[torch.float64].rows} rows a slab resident at f64, "
        f"{plans[torch.float32].rows} at f32, {plans[torch.float64].scratch}"
        f" bytes streamed at f64) f64: {sol.status}, rung {sol.rung}, "
        f"{sol.niter} steps, {secs:.2f} s, certificate {primal_ok, dual_ok}"
        f", launches {launches}")
    if not (sol.status == "optimal" and sol.rung == "device-float64"
            and primal_ok and dual_ok and (dev != "cuda" or (
                launches["bounded_grid"] == 1
                and launches["fused_fma"] == 0))):
        raise AssertionError(f"8a (w): {sol.status}, rung {sol.rung}, "
                             f"certificate {primal_ok, dual_ok}, launches "
                             f"{launches}")
    windows = {}
    for dt in (torch.float64, torch.float32):
        name = str(dt).replace("torch.", "")
        bs, opts = bounded_state(sf, dev, dt, max_iters=BND_WIDE_WINDOW)
        t0 = time.perf_counter()
        walk = run_simplex_bounded(bs, opts)
        sync(dev)
        walk_secs = time.perf_counter() - t0
        t0 = time.perf_counter()
        p = run_simplex_bounded_reference(bs, opts)
        sync(dev)
        plain_secs = time.perf_counter() - t0
        steps = int(walk.s.niter)
        ref = grid_reference_check(sf, dev, dt, f"(w) the {name} devex "
                                   f"walk's first {BND_WIDE_WINDOW} steps",
                                   BND_WIDE_WINDOW)
        windows[name] = {
            "steps": steps, "seconds": walk_secs,
            "plain_seconds": plain_secs,
            "max_abs_err": max(bounded_equal(walk, p), ref["max_abs_err"]),
            "plain_ms_per_step": ref["plain_ms_per_step"]}
        log(f"# 8a (w) {name}: the first {steps} steps on the streamed grid "
            f"equal the plain walk in every field ({walk_secs:.3f} s against "
            f"{plain_secs:.2f} s)")
    # the streamed launch, twice
    grid_runs = [bounded_grid_us(sf, dev, torch.float64) for _ in range(2)]
    g = dict(grid_runs[0])
    g["device_us_per_step"] = float(np.mean(
        [r["device_us_per_step"] for r in grid_runs]))
    g["device_us_turns"] = [r["device_us_per_step"] for r in grid_runs]
    g["device_us_by_stage"] = {
        k: float(np.mean([r["device_us_by_stage"][k] for r in grid_runs]))
        for k in grid_runs[0]["device_us_by_stage"]}
    wb, own, step_b = grid_bounds(M, N, 8, g["blocks"], sol.niter, clock_hz,
                                  rows=g["rows"])
    g.update(bound_ms=wb[0], bound_by=wb[1], grid_bound_ms=own,
             step_bound_ms=step_b, sm_clock_hz=clock_hz)
    log(f"# 8a (w) bounded_grid streamed float64: "
        f"{g['device_us_per_step']:.3f} us a step on the card (turns "
        f"{g['device_us_turns']}; one launch of {g['steps']} steps from step "
        f"{g['advance']}; by stage "
        + ", ".join(f"{k} {v:.3f}" for k, v in g["device_us_by_stage"].items())
        + f"); G {g['blocks']}, W {g['width']}, R {g['rows']}, {g['smem']} "
        f"bytes of shared memory a block, {g['scratch']} bytes streamed, "
        f"occupancy {g['occupancy']}; bounds a step: {1e3 * wb[0]:.4f} us "
        f"({wb[1]}), {1e3 * own:.3f} us (the streamed convention: the "
        f"streamed rows through device memory, the resident ones through "
        f"shared memory), {1e3 * step_b:.2f} us (the table's step "
        "convention)")
    return {"status": sol.status, "rung": sol.rung, "niter": sol.niter,
            "seconds": secs, "launches": launches, "route": route,
            "plans": {str(dt).replace("torch.", ""): p._asdict()
                      for dt, p in plans.items()},
            "window": windows["float64"], "window_float32":
            windows["float32"], "grid_us": g,
            "bound_us_per_step": 1e3 * bound(2.0 * M * N * 8, 0.0,
                                             FP64_FLOP_S)[0]}


def past_state(dev, m: int, dtype, seed: int, n: int = BND_PAST_N):
    """(state, options) of the devex walk of an m x n box LP
    (``bounded_arrays``' recipe, seed ``seed``) from its slack basis, to a
    budget of BND_PAST_STEPS steps: 8a (x), (y) and (z)'s frames."""
    import torch

    from tpulp_torch import SolverOptions
    from tpulp_torch.core.state import RULE_DEVEX, make_state
    from tpulp_torch.solve.bounded import make_bounded_state

    D, b, c, u = bounded_arrays(m, n, seed=seed)
    state = make_state(np.concatenate([c, np.zeros(m)]),
                       np.concatenate([D, np.eye(m)], axis=1), b,
                       list(range(n, n + m)), dtype=dtype, device=dev)
    bs = make_bounded_state(state, u.tolist() + [None] * m)
    bs = bs._replace(gamma=torch.ones_like(bs.upper))
    return bs, SolverOptions.for_dtype(dtype, rule=RULE_DEVEX,
                                       max_iters=BND_PAST_STEPS)


def past_streamed_lp(dev, label: str, m: int, dtype, clock_hz: float,
                     seed: int = 2):
    """8a (x) and (y): ``run_simplex_bounded`` on an m x BND_PAST_N box LP
    (``bounded_arrays``' recipe, a slack basis, devex) whose frame is past
    the streamed plan at ``dtype`` (``bounded_route``: "bounded_grid" on
    the plan with the per-row vectors in device memory), to a budget of
    BND_PAST_STEPS steps: one ``bounded_grid`` launch (no FMA launch), held
    to the plain loop on the same budget in every field; then, twice, one
    grid launch of BND_PAST_GRID_TIMED steps from the walk's eighth step by
    stage, with the plan and the grid's bounds."""
    import torch

    from tpulp_torch.kernels import LAUNCHES, reset_launches
    from tpulp_torch.kernels import bounded_grid as kg
    from tpulp_torch.kernels.bounded import FLIPS
    from tpulp_torch.kernels.launch import sm_count
    from tpulp_torch.solve.bounded import (bounded_route,
                                           run_simplex_bounded,
                                           run_simplex_bounded_reference)

    n = BND_PAST_N
    M, N = m + 2, n + m + 1
    name = str(dtype).replace("torch.", "")
    es = 8 if dtype == torch.float64 else 4
    sms = sm_count(torch.device(dev)) if dev == "cuda" else kg.GRID_SMS
    route = bounded_route(M, N, dtype, sms,
                          torch.device(dev) if dev == "cuda" else None)
    plan = kg.bounded_grid_plan(M, N, dtype, sms)
    if route != "bounded_grid" or plan.vectors != "device":
        raise AssertionError(f"8a {label}: {M} x {N} takes {route}, plan "
                             f"{plan}")
    bs, opts = past_state(dev, m, dtype, seed)
    sync(dev)
    flips0 = dict(FLIPS)
    reset_launches()
    t0 = time.perf_counter()
    k = run_simplex_bounded(bs, opts)
    sync(dev)
    secs = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    flips = {key: FLIPS[key] - flips0[key] for key in FLIPS}
    t0 = time.perf_counter()
    p = run_simplex_bounded_reference(bs, opts)
    sync(dev)
    plain_secs = time.perf_counter() - t0
    err = bounded_equal(k, p)
    steps = int(k.s.niter)
    if steps != BND_PAST_STEPS or (
            dev == "cuda" and not (launches["bounded_grid"] == 1
                                   and launches["fused_fma"] == 0)):
        raise AssertionError(f"8a {label}: {steps} steps, launches "
                             f"{launches}, flips {flips}")
    # the grid's launch, twice, from the eighth step
    grid_runs = [bounded_grid_us(None, dev, dtype, advance=8,
                                 steps=BND_PAST_GRID_TIMED, state=(bs, opts))
                 for _ in range(2)]
    g = dict(grid_runs[0])
    g["device_us_turns"] = [r["device_us_per_step"] for r in grid_runs]
    g["device_us_per_step"] = float(np.mean(g["device_us_turns"]))
    g["device_us_by_stage"] = {
        key: float(np.mean([r["device_us_by_stage"][key]
                            for r in grid_runs]))
        for key in grid_runs[0]["device_us_by_stage"]}
    wb, own, step_b = grid_bounds(M, N, es, g["blocks"], BND_PAST_STEPS,
                                  clock_hz, rows=g["rows"])
    g.update(bound_ms=wb[0], bound_by=wb[1], grid_bound_ms=own,
             step_bound_ms=step_b, sm_clock_hz=clock_hz)
    bound_us = 1e3 * bound(2.0 * M * N * es, 0.0, FP64_FLOP_S)[0]
    log(f"# 8a {label} box LP {m}x{n} ({M} x {N} {name}, past the streamed "
        f"plan: {route}, the per-row vectors in device memory; G "
        f"{plan.blocks}, W {plan.width}, R {plan.rows}, tiles of "
        f"{plan.tile_rows} rows, {plan.scratch} bytes streamed, {plan.smem} "
        f"bytes of shared memory a block, occupancy {g['occupancy']}): its "
        f"first {steps} steps through run_simplex_bounded ({secs:.3f} s, "
        f"launches {launches}) equal the plain walk ({plain_secs:.2f} s) "
        f"in every field, flips {flips}; bounded_grid "
        f"{g['device_us_per_step']:.3f} us a step on the card (turns "
        f"{g['device_us_turns']}; one launch of {g['steps']} steps from step "
        f"{g['advance']}; by stage "
        + ", ".join(f"{key} {v:.3f}" for key, v in
                    g["device_us_by_stage"].items())
        + "); bounds a step: "
        f"{1e3 * wb[0]:.4f} us ({wb[1]}, the walk's), {1e3 * own:.3f} us "
        f"(the kernel's convention), {bound_us:.2f} us (the table's step "
        "convention: the tableau read and written once)")
    return {"route": route, "plan": plan._asdict(), "steps": steps,
            "seconds": secs, "plain_seconds": plain_secs,
            "max_abs_err": err, "launches": launches, **flips,
            "grid_us": g, "bound_us_per_step": bound_us}


def wide_window(bs, opts, dev, dtype, end: int):
    """A window start past the entering flips: in the first chunk of
    BND_WIDE_SCAN steps, up to ``end``, in which most steps pivot (an
    entering flip changes no basis; ``bounded_grid`` run chunk by chunk),
    the step after as many steps as the chunk has entering flips (these
    walks flip first, then pivot), at most BND_WIDE_SCAN -
    BND_PAST_GRID_TIMED into it; with the chunks' (steps, entering flips,
    upper hits). The walk's first steps on these box LPs are entering
    flips: this finds where its update streams the slab."""
    from tpulp_torch.kernels import bounded_grid as kg
    from tpulp_torch.kernels.bounded import FLIPS

    stall = opts.resolved_stall_limit(bs.s.m, bs.s.n)
    cur, chunks = bs, []
    for c in range(end // BND_WIDE_SCAN if dev == "cuda" else 0):
        f0, n0 = dict(FLIPS), int(cur.s.niter)
        cur = kg.bounded_grid(cur, opts, stall, (c + 1) * BND_WIDE_SCAN)
        d = {k: FLIPS[k] - f0[k] for k in FLIPS}
        chunks.append((int(cur.s.niter) - n0, d["entering_flips"],
                       d["upper_hits"]))
        if int(cur.s.status) != 0 or 2 * d["entering_flips"] < chunks[-1][0]:
            break
    if not chunks:
        return 0, chunks
    skip = min(chunks[-1][1], BND_WIDE_SCAN - BND_PAST_GRID_TIMED)
    return BND_WIDE_SCAN * (len(chunks) - 1) + skip, chunks


def window_bound_ms(M: int, N: int, es: int, steps: int, flips: int):
    """The least time a window of ``steps`` steps of which ``flips`` are
    entering flips could take, a step (ms): a pivot reads and writes the
    frame once, an entering flip reads the pricing row once, over 3.35
    TB/s (the data's own: the rows the window's steps touch)."""
    return 1e3 * ((steps - flips) * 2.0 * M * N * es + flips * N * es) / (
        HBM_BYTES_S * steps)


def wide_plan_lp(dev, label: str, m: int, n: int, dtype, budget: int):
    """8a (z), (z64) and (z32): ``run_simplex_bounded`` on an m x n box LP
    (``past_state``'s recipe, seed 4, devex) whose slabs pass the grid's
    device-vector plan at ``dtype`` (``bounded_route``: "bounded_grid" on
    the wide plan, no row of a slab in shared memory), to a budget of
    ``budget`` steps: one ``bounded_grid`` launch (launches set to 0 just
    before the walk and read just after: no other kernel, no FMA launch),
    its steps, pivots, entering flips, upper hits and host seconds; its
    first BND_PAST_STEPS steps held to the plain loop in every field; a
    window of BND_PAST_GRID_TIMED steps where the walk pivots
    (``wide_window``) held to ``bounded_grid_reference`` on the card; one
    launch of BND_PAST_GRID_TIMED steps
    timed by stage from step 8 (entering flips) and from that window
    (pivots), twice each, with each window's own bound
    (``window_bound_ms``) beside the table's step convention (the frame
    read and written once a step)."""
    import dataclasses

    import torch

    from tpulp_torch.kernels import LAUNCHES, reset_launches
    from tpulp_torch.kernels import bounded_grid as kg
    from tpulp_torch.kernels.bounded import FLIPS
    from tpulp_torch.kernels.launch import sm_count
    from tpulp_torch.solve.bounded import (bounded_route,
                                           run_simplex_bounded,
                                           run_simplex_bounded_reference)

    M, N = m + 2, n + m + 1
    es = 8 if dtype == torch.float64 else 4
    name = str(dtype).replace("torch.", "")
    sms = sm_count(torch.device(dev)) if dev == "cuda" else kg.GRID_SMS
    route = bounded_route(M, N, dtype, sms,
                          torch.device(dev) if dev == "cuda" else None)
    plan = kg.bounded_grid_plan(M, N, dtype, sms)
    if route != "bounded_grid" or plan.vectors != "wide":
        raise AssertionError(f"8a {label}: {M} x {N} takes {route}, plan "
                             f"{plan}")
    bs, opts = past_state(dev, m, dtype, 4, n)
    stall = opts.resolved_stall_limit(bs.s.m, bs.s.n)
    walk_opts = dataclasses.replace(opts, max_iters=budget)
    sync(dev)
    # the main path: the walk to its budget
    flips0 = dict(FLIPS)
    reset_launches()
    t0 = time.perf_counter()
    k = run_simplex_bounded(bs, walk_opts)
    sync(dev)
    secs = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    flips = {key: FLIPS[key] - flips0[key] for key in FLIPS}
    steps = int(k.s.niter)
    if dev == "cuda" and (launches["bounded_grid"] != 1 or any(
            v for key, v in launches.items() if key != "bounded_grid")):
        raise AssertionError(f"8a {label}: launches {launches}")
    # its first BND_PAST_STEPS steps against the plain loop
    held = run_simplex_bounded(bs, opts)
    t0 = time.perf_counter()
    p = run_simplex_bounded_reference(bs, opts)
    sync(dev)
    plain_secs = time.perf_counter() - t0
    err = bounded_equal(held, p)
    if int(held.s.niter) != BND_PAST_STEPS or steps != budget:
        raise AssertionError(f"8a {label}: {int(held.s.niter)} and {steps} "
                             "steps")
    # the first window that mostly pivots, held to the plain version
    start, chunks = wide_window(bs, opts, dev, dtype, BND_WIDEST_STEPS)
    wsteps = BND_PAST_GRID_TIMED
    if dev == "cuda":
        mid = kg.bounded_grid(bs, opts, stall, start)
        f0 = dict(FLIPS)
        kw = kg.bounded_grid(mid, opts, stall, start + wsteps)
        sync(dev)
        kflips = {key: FLIPS[key] - f0[key] for key in FLIPS}
    else:
        mid = bs
        kw, kflips = kg.bounded_grid_reference(
            bs, opts, stall, start + wsteps, plan.blocks, vectors="wide")
    t0 = time.perf_counter()
    pw, wflips = kg.bounded_grid_reference(mid, opts, stall, start + wsteps,
                                           plan.blocks, vectors="wide")
    sync(dev)
    ref_ms = 1e3 * (time.perf_counter() - t0) / wsteps
    werr = bounded_equal(kw, pw)
    if kflips != wflips:
        raise AssertionError(f"8a {label}: flips {kflips} against {wflips}")
    # one launch of wsteps steps by stage, from step 8 and from the window
    timed = {}
    for key, adv in (("flips", 8), ("pivots", start)):
        runs = [bounded_grid_us(None, dev, dtype, advance=adv, steps=wsteps,
                                state=(bs, opts)) for _ in range(2)]
        g = dict(runs[0])
        g["device_us_turns"] = [r["device_us_per_step"] for r in runs]
        g["device_us_per_step"] = float(np.mean(g["device_us_turns"]))
        g["device_us_by_stage"] = {
            st: float(np.mean([r["device_us_by_stage"][st] for r in runs]))
            for st in runs[0]["device_us_by_stage"]}
        timed[key] = g
    # the windows' entering flips: the flip window's all are where the
    # first chunk pivots nowhere (else its bound is not counted)
    all_flips = bool(chunks) and chunks[0][1] == chunks[0][0] and \
        BND_WIDE_SCAN >= 8 + wsteps
    win_flips = {"flips": wsteps if all_flips else None,
                 "pivots": wflips["entering_flips"]}
    for key, g in timed.items():
        nf = win_flips[key]
        g["bound_ms"] = None if nf is None else window_bound_ms(
            M, N, es, wsteps, min(nf, wsteps))
        g["bound_by"] = "bytes"
        g["entering_flips"] = nf
    table_us = 1e3 * bound(2.0 * M * N * es, 0.0, FP64_FLOP_S)[0]
    res = {"route": route, "plan": plan._asdict(), "steps": steps,
           "pivots": steps - flips["entering_flips"], **flips,
           "seconds": secs, "launches": launches,
           "held_steps": BND_PAST_STEPS, "plain_seconds": plain_secs,
           "max_abs_err": max(err, werr), "window_from": start,
           "window_steps": wsteps, "window_flips": wflips,
           "chunks": chunks, "plain_ms_per_step": ref_ms, "grid_us": timed,
           "bound_us_per_step": table_us}
    log(f"# 8a {label} box LP {m}x{n} ({M} x {N} {name}, past the "
        f"device-vector plan: {route} on the wide plan; G {plan.blocks}, W "
        f"{plan.width}, chunks of {plan.chunk} columns, tiles of "
        f"{plan.tile_rows} rows through a ring of {plan.stages}, "
        f"{plan.scratch} bytes of scratch, {plan.smem} bytes of shared "
        f"memory a block): its walk to {budget} steps in one launch "
        f"({secs:.3f} s on the host clock; {res['pivots']} pivots, "
        f"{flips['entering_flips']} entering flips, {flips['upper_hits']} "
        f"upper hits; launches {launches}); its first {BND_PAST_STEPS} steps "
        f"equal the plain walk ({plain_secs:.2f} s) in every field; steps "
        f"{start}-{start + wsteps} (chunks of {BND_WIDE_SCAN}: {chunks}) "
        f"equal bounded_grid_reference on the card ({ref_ms:.3f} ms a step), "
        f"flips {wflips}; one launch of {wsteps} steps on the card: "
        + "; ".join(
            f"from step {g['advance']} ({key}) {g['device_us_per_step']:.3f} "
            f"us a step (turns {g['device_us_turns']}; by stage "
            + ", ".join(f"{st} {v:.3f}" for st, v in
                        g["device_us_by_stage"].items())
            + f"; the window's bound "
            + ("not counted" if g["bound_ms"] is None
               else f"{1e3 * g['bound_ms']:.2f} us") + ")"
            for key, g in timed.items())
        + f"; the table's step bound {table_us:.2f} us (the frame read and "
        "written once)")
    return res


def shared_frame_turns(dev):
    """8a (s): a BND_WIDEST_M x BND_SHARED_N box LP (18 x 400,001 f64),
    which both the device-vector plan (the route's) and the wide plan
    hold: one launch of BND_PAST_GRID_TIMED steps on each, in turns (wide,
    device, device, wide), from step 8 and from its first window that
    mostly pivots; device us a step (median of three a turn)."""
    import torch

    from tpulp_torch.kernels import bounded_grid as kg

    m, n = BND_WIDEST_M, BND_SHARED_N
    bs, opts = past_state(dev, m, torch.float64, 4, n)
    stall = opts.resolved_stall_limit(bs.s.m, bs.s.n)
    M, N = bs.s.T.shape
    plans = {v: kg.bounded_grid_plan(M, N, torch.float64, kg.GRID_SMS,
                                     vectors=v) for v in ("device", "wide")}
    if kg.bounded_grid_plan(M, N, torch.float64, kg.GRID_SMS) != \
            plans["device"]:
        raise AssertionError(f"8a (s): the route's plan is not {plans}")
    if dev != "cuda":
        return {"plans": {v: p._asdict() for v, p in plans.items()}}
    start, chunks = wide_window(bs, opts, dev, torch.float64,
                                BND_WIDEST_STEPS)
    steps = BND_PAST_GRID_TIMED
    turns = {}
    for adv in (8, start):
        mid = kg.bounded_grid(bs, opts, stall, adv)
        for v in ("wide", "device", "device", "wide"):
            runs = [launches_us(lambda: kg.bounded_grid(
                mid, opts, stall, adv + steps, vectors=v), steps)[0]
                for _ in range(3)]
            turns.setdefault(f"from {adv} {v}", []).append(
                float(np.median(runs)))
    log(f"# 8a (s) {M} x {N} float64 on both plans (device-vector: R "
        f"{plans['device'].rows}, {plans['device'].smem} bytes; wide: "
        f"{plans['wide'].smem} bytes), one launch of {steps} steps, device "
        f"us a step in turns: {turns} (chunks {chunks})")
    return {"plans": {v: p._asdict() for v, p in plans.items()},
            "window_from": start, "steps": steps, "turns_us": turns}


def phase_bounded_lp(dev):
    """Phase 8a: solve_lp on the BND_M x BND_N box LP with simple_bounds
    (a (BND_M + 2) x (BND_N + BND_M + 1) tableau, no bound rows, priced
    by BND_PRICING) at f64: the walk on ``bounded_grid`` (launches >= 1, no
    FMA launch), optimal, the f64 bounded
    certificate, 0 <= x <= u and D x <= b within 1e-9 relative, columns at
    upper, and the objective within 1e-9 of the row-lowered solve (3 BND_M
    rows), which takes the kernel engine. The same LP at f32: on the grid
    kernel, optimal on BND_F32_RUNG (the ladder's f64 retry), its answer
    certified and equal to the f64 solve's. Then the grid walk against one
    plain loop each walk: the f64 devex walk's first BND_F64_WINDOW steps,
    the f32 walk's first BND_F32_WINDOW steps and a Dantzig f32 walk that
    switches to Bland, every field equal, timed twice; the grid against
    ``bounded_grid_reference`` on the card over the first
    BND_GRID_REF_WINDOW steps of the devex walks and the f64 Dantzig walk,
    and on small frames' edge cases (e); the grid's device us a step by
    stage (devex at f64 and f32, the f64 Dantzig walk, the f32 Bland
    window); (w), the box LP past the resident slab on the streamed grid;
    (x) and (y), frames past the streamed plan at f64 and f32 on the
    grid's device-vector plan; (z), (z64) and (z32), frames past the
    device-vector plan, on the wide plan, and (s), a frame both plans hold,
    timed on each in turns; and (t), the grid's ``cuda`` tests. Returns
    the numbers and the launches of the f64 solve."""
    import torch

    import tpulp_torch
    from tpulp_torch.kernels import LAUNCHES, reset_launches
    from tpulp_torch.kernels.bounded import FLIPS
    from tpulp_torch.model.equilibrate import (equilibration_powers_dense,
                                               is_material_scaling)
    from tpulp_torch.model.lower import materialize_simple_bounds
    from tpulp_torch.solve.refine import float_bounded_certificate

    # "cuda" or "cpu": main passes a torch.device, and the checks below
    # (the launch gates, the kernel against its plain version) key on the
    # name
    dev = torch.device(dev).type
    m, n = BND_M, BND_N
    sf, D, b, u = bounded_form(m, n)
    rp, cp = equilibration_powers_dense(
        np.concatenate([D, np.eye(m)], axis=1), basis_hint=sf.basis_hint)
    log(f"# bounded LP {m}x{n}: equilibration material: "
        f"{is_material_scaling(rp, cp)}")
    res = {}
    # the seconds of each part of the phase (host clock)
    parts, t_part = {}, time.perf_counter()

    def part(name):
        nonlocal t_part
        now = time.perf_counter()
        parts[name] = now - t_part
        t_part = now

    for dt in (torch.float64, torch.float32):
        name = str(dt).replace("torch.", "")
        window = bounded_step_window(sf, dev, dt)
        torch.cuda.synchronize()
        flips0 = dict(FLIPS)
        # the bounded LP's main path: counts set to 0 just before the solve
        # and read just after it
        reset_launches()
        t0 = time.perf_counter()
        sol = tpulp_torch.solve_lp(sf, dtype=dt, device=dev,
                                   pricing=BND_PRICING,
                                   max_iters=BND_MAX_ITERS)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        enter, up_hit = (FLIPS[k] - flips0[k] for k in FLIPS)
        res[name] = {"status": sol.status, "rung": sol.rung,
                     "niter": sol.niter, "seconds": secs,
                     "launches": launches, "entering_flips": enter,
                     "upper_hits": up_hit, **window,
                     "objective": float(sol.objective)
                     if sol.objective is not None else None}
        log(f"# bounded LP {m}x{n} {name} ({BND_PRICING}): {sol.status}, "
            f"rung {sol.rung}, {sol.niter} steps = {enter} entering flips "
            f"+ {up_hit} upper hits + {sol.niter - enter - up_hit} plain "
            f"pivots (the record's counters, over every walk the solve "
            f"ran); {secs:.2f} s on the host clock (set-up, refinement and "
            f"certificate included); launches {launches}; the plain step "
            f"it replaces: {window['plain_device_ms_per_step']:.4f} ms, "
            f"{window['plain_kernels_per_step']:.0f} kernels and "
            f"{window['plain_host_ms_per_step']:.3f} ms of host time a "
            "step (torch.profiler over 16 steps)")
        kernel_path = (launches["bounded_grid"] > 0
                       and launches["fused_fma"] == 0)
        if dt == torch.float32:
            # the retry's answer, certified again and held to the f64
            # solve's objective
            primal_ok, dual_ok = float_bounded_certificate(sf, sol.basis,
                                                           sol.at_upper)
            rel = abs(float(sol.objective) - float(f64_obj)) / max(
                1.0, abs(float(f64_obj)))
            if not (sol.status == "optimal" and sol.rung == BND_F32_RUNG
                    and primal_ok and dual_ok and rel <= 1e-9
                    and kernel_path):
                raise AssertionError(
                    f"bounded LP f32: {sol.status}, rung {sol.rung} (want "
                    f"{BND_F32_RUNG}), certificate {primal_ok, dual_ok}, "
                    f"relative difference to the f64 solve {rel:.2e}, "
                    f"launches {launches}")
            log(f"# bounded LP f32: answered on the ladder's f64 retry "
                f"({sol.rung}), certified (float_bounded_certificate); "
                f"objective {sol.objective!r}, relative difference to the "
                f"f64 solve's {rel:.2e}")
            res[name]["relative_difference"] = rel
            continue
        f64_obj = sol.objective
        if sol.status != "optimal" or not kernel_path:
            raise AssertionError(f"bounded LP f64: {sol.status}, launches "
                                 f"{launches}")
        primal_ok, dual_ok = float_bounded_certificate(sf, sol.basis,
                                                       sol.at_upper)
        x = np.array([float(sol.x[f"x{j}"]) for j in range(n)])
        lo_ok = bool((x >= -1e-9 * u).all())
        hi_ok = bool((x <= u * (1.0 + 1e-9)).all())
        row_ok = bool((D @ x <= b + 1e-9 * (np.abs(D) @ np.abs(x)
                                            + np.abs(b))).all())
        basic = set(sol.basis)
        at_up = sum(1 for j in range(n) if sol.at_upper[j]
                    and j not in basic)
        if not (primal_ok and dual_ok and lo_ok and hi_ok and row_ok
                and at_up > 0):
            raise AssertionError(
                f"bounded LP f64: certificate {primal_ok, dual_ok}, 0 <= x "
                f"{lo_ok}, x <= u {hi_ok}, D x <= b {row_ok}, {at_up} "
                "columns at upper")
        log(f"# bounded LP f64: certified (float_bounded_certificate), "
            f"0 <= x <= u and D x <= b within 1e-9, {at_up} nonbasic "
            f"columns at upper; objective {sol.objective!r}")
        res[name]["at_upper"] = at_up
        # the row-lowered form of the same LP: 3m rows, the kernel engine
        sfr = materialize_simple_bounds(sf)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        rows = tpulp_torch.solve_lp(sfr, device=dev, driver="auto",
                                    max_iters=BND_MAX_ITERS)
        torch.cuda.synchronize()
        rsecs = time.perf_counter() - t0
        rl = dict(LAUNCHES)
        rel = abs(float(rows.objective) - float(sol.objective)) / max(
            1.0, abs(float(rows.objective)))
        log(f"# row-lowered LP {sfr.m}x{sfr.n} ({(sfr.m + 2) * (sfr.n + 1):,}"
            f" elements) f64: {rows.status}, rung {rows.rung}, "
            f"{rows.niter} pivots, {rsecs:.2f} s, launches {rl}; objective "
            f"{rows.objective!r}, relative difference {rel:.2e}")
        if not (rows.status == "optimal" and rl["fused_flush"] > 0
                and rl["blocked_inner_block"] > 0 and rel <= 1e-9):
            raise AssertionError("bounded LP: the row-lowered solve on the "
                                 "kernel engine disagrees")
        res["row_lowered"] = {"niter": rows.niter, "seconds": rsecs,
                              "launches": rl, "relative_difference": rel}

    part("solves")
    # the kernels against the plain loop, on the card
    walks = {
        "f64_devex": bounded_walk_check(
            sf, dev, torch.float64,
            f"the f64 devex walk's first {BND_F64_WINDOW} steps",
            max_iters=BND_F64_WINDOW),
        "f32_devex_window": bounded_walk_check(
            sf, dev, torch.float32,
            f"the f32 devex walk's first {BND_F32_WINDOW} steps",
            max_iters=BND_F32_WINDOW),
        "f32_dantzig_bland": bounded_walk_check(
            sf, dev, torch.float32,
            f"the f32 Dantzig walk's first {BND_BLAND_STEPS} steps, stall "
            "limit 1 (every pivot stalls: Bland from the second)",
            devex=False, stall_limit=1, degen_tol=1e30,
            max_iters=BND_BLAND_STEPS)}
    if not walks["f32_dantzig_bland"]["bland"]:
        raise AssertionError("8a: the Bland switch did not fire")
    part("walks")
    reference = {str(dt).replace("torch.", ""): grid_reference_check(
        sf, dev, dt, f"the {dt} devex walk's first {BND_GRID_REF_WINDOW} "
        "steps", BND_GRID_REF_WINDOW)
        for dt in (torch.float64, torch.float32)}
    reference["dantzig float64"] = grid_reference_check(
        sf, dev, torch.float64, "the torch.float64 Dantzig walk's first "
        f"{BND_GRID_REF_WINDOW} steps", BND_GRID_REF_WINDOW, devex=False)
    part("reference")
    reference["edge_walks"] = grid_edge_walks(dev)
    part("edge_walks")
    f64 = walks["f64_devex"]
    if f64["niter"] != min(BND_F64_WINDOW, res["float64"]["niter"]):
        raise AssertionError(f"8a: the f64 devex window {f64} is not the "
                             "solve's walk")
    grid_us = {}
    clock_hz = 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])

    def grid_timing(name, dt, walk_steps, devex=True, **kw):
        # one timed launch (bounded_grid_us) with its bounds, the frame's
        # load and store spread over ``walk_steps``
        g = bounded_grid_us(sf, dev, dt, devex, **kw)
        wb, own, step_b = grid_bounds(m + 2, n + m + 1, g["es"],
                                      g["blocks"], walk_steps, clock_hz)
        g.update(bound_ms=wb[0], bound_by=wb[1], grid_bound_ms=own,
                 step_bound_ms=step_b, sm_clock_hz=clock_hz)
        log(f"# 8a bounded_grid {name}: {g['device_us_per_step']:.3f} us a "
            f"step on the card (one launch of {g['steps']} steps from step "
            f"{g['advance']}; by stage "
            + ", ".join(f"{k} {v:.3f}" for k, v in
                        g["device_us_by_stage"].items())
            + f"); G {g['blocks']}, W {g['width']}, {g['smem']} bytes of "
            f"shared memory a block, occupancy {g['occupancy']} a SM; "
            f"bounds a step: {1e3 * wb[0]:.4f} us ({wb[1]}), "
            f"{1e3 * own:.3f} us (the kernel's convention), "
            f"{1e3 * step_b:.2f} us (the table's step convention)")
        return g

    for dt in (torch.float64, torch.float32):
        name = str(dt).replace("torch.", "")
        # the frame's load and store spread over the f64 solve's whole walk,
        # over the f32 window's steps
        grid_us[name] = grid_timing(name, dt, res["float64"]["niter"]
                                    if dt == torch.float64 else
                                    walks["f32_devex_window"]["niter"])
    # the Dantzig instantiations: the f64 walk a window in, and the f32
    # Bland walk within the window held above (from its 64th step)
    grid_us["dantzig float64"] = grid_timing(
        "dantzig float64", torch.float64, BND_GRID_TIMED_STEPS, devex=False)
    grid_us["bland float32"] = grid_timing(
        "bland float32", torch.float32, BND_BLAND_STEPS - 64, devex=False,
        advance=64, steps=BND_BLAND_STEPS - 64, stall_limit=1,
        degen_tol=1e30)
    f64["bound_us_per_step"] = 1e3 * bound(2.0 * (m + 2) * (n + m + 1) * 8,
                                           0.0, FP64_FLOP_S)[0]
    log(f"# 8a the f64 devex walk: bounded_grid {f64['seconds']:.4f} s for "
        f"{f64['niter']} steps = {1e6 * f64['seconds'] / f64['niter']:.2f} "
        f"us a step on the host clock "
        f"({grid_us['float64']['device_us_per_step']:.2f} on the card; the "
        f"table's step bound {f64['bound_us_per_step']:.2f} us)")
    part("timing")
    res.update(walks=walks, grid_us=grid_us, reference=reference,
               wide=wide_bounded_lp(dev, clock_hz))
    part("(w)")
    res["past"] = past_streamed_lp(dev, "(x)", BND_PAST_M, torch.float64,
                                   clock_hz)
    part("(x)")
    res["past_float32"] = past_streamed_lp(dev, "(y)", BND_PAST32_M,
                                           torch.float32, clock_hz, seed=3)
    part("(y)")
    res["too_wide"] = wide_plan_lp(dev, "(z)", BND_WIDEST_M, BND_WIDEST_N,
                                   torch.float64, BND_WIDEST_STEPS)
    part("(z)")
    for label, dt in (("(z64)", torch.float64), ("(z32)", torch.float32)):
        res["too_wide_" + label[2:-1]] = wide_plan_lp(
            dev, label, BND_WIDEST_M, BND_Z64_N, dt, BND_PAST_STEPS)
        part(label)
    res["shared_frame"] = shared_frame_turns(dev)
    part("(s)")
    res["card_tests"] = bounded_grid_card_tests(dev)
    part("(t)")
    res["seconds_by_part"] = parts
    log("# 8a seconds by part (host clock): " + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()))
    return res


def bounded_grid_card_tests(dev):
    """8a (t): tests/test_torch_bounded_grid_card.py, the bounded grid's
    ``cuda`` tests (the kernel against its plain version on the CPU's
    small walks: the plan's grid, forced grids and splits, the
    device-vector plan forced), run on the card in a process of their own;
    a failure, or a test that skips, fails the run."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda",
           "-q", "-p", "no:cacheprovider",
           "tests/test_torch_bounded_grid_card.py"]
    if dev != "cuda":
        return {"skipped": "no card"}
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                          timeout=900)
    secs = time.perf_counter() - t0
    tail = proc.stdout.strip().splitlines()[-1:] or [""]
    log(f"# 8a (t) {' '.join(cmd[2:])}: exit {proc.returncode}, "
        f"{tail[0]} ({secs:.1f} s)")
    if proc.returncode != 0 or "skipped" in tail[0] or \
            "passed" not in tail[0]:
        raise AssertionError(f"8a (t): the bounded grid's card tests: "
                             f"{proc.stdout[-4000:]}{proc.stderr[-2000:]}")
    return {"summary": tail[0], "seconds": secs}


def box_form(seed: int, m: int, n: int):
    """A seeded integer box LP: min c x, A x <= b, 0 <= x <= u with A in
    [0, 9], u in [1, 5], b = A u // 2 + [1, 19] (x = u / 2 is feasible),
    c in [-9, 0], as a simple_bounds StandardForm."""
    rng = np.random.default_rng(seed)
    A = rng.integers(0, 10, size=(m, n))
    u = rng.integers(1, 6, size=n)
    b = A @ u // 2 + rng.integers(1, 20, size=m)
    c = -rng.integers(0, 10, size=n)
    sf = scenario_form(A, b, c)
    return dataclasses.replace(sf, upper=u.tolist() + [None] * m)


def phase_bounded_batch(dev):
    """Phase 8b: solve_lp_batch(simple_bounds=True) over BOX_LANES box LPs
    of BOX_M x BOX_N against the row-lowered batch (BOX_M + BOX_N rows) of
    the first BOX_ROW_LANES: every lane optimal and the exact objectives
    equal lane for lane. The bounded batch's walk is one ``lane_bounded``
    launch and no FMA launch; the solve split into the batched state's
    build, the walk and the per-lane extraction (refinement and
    certificate); then ``bounded_lane_cases``."""
    import torch

    import tpulp_torch
    from tpulp_torch.batch import (extract_batch_bounded_solutions,
                                   make_batched_bounded_states)
    from tpulp_torch.kernels import LAUNCHES, reset_launches
    from tpulp_torch.solve import run_simplex_bounded_batch

    # "cuda" or "cpu": main passes a torch.device, and the checks and
    # timers below key on the name
    dev = torch.device(dev).type
    sfs = [box_form(s, BOX_M, BOX_N) for s in range(BOX_LANES)]
    res = {}
    sols = {}
    for kind, lanes in (("bounded", BOX_LANES), ("rows", BOX_ROW_LANES)):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        sols[kind] = tpulp_torch.solve_lp_batch(
            sfs[:lanes], simple_bounds=kind == "bounded", device=dev)
        secs = time.perf_counter() - t0
        res[kind] = {"seconds": secs, "lanes": lanes,
                     "lanes_per_s": lanes / secs,
                     "pivots": sum(s.niter for s in sols[kind]),
                     "launches": dict(LAUNCHES)}
    rows = sols["rows"]
    bad = [k for k, a in enumerate(sols["bounded"])
           if a.status != "optimal" or (k < BOX_ROW_LANES and (
               rows[k].status != "optimal"
               or a.objective != rows[k].objective))]
    launches = res["bounded"]["launches"]
    log(f"# solve_lp_batch {BOX_LANES} box LPs {BOX_M}x{BOX_N}: "
        f"simple_bounds {res['bounded']['seconds']:.2f} s = "
        f"{res['bounded']['lanes_per_s']:.1f} lanes/s "
        f"({res['bounded']['pivots']} pivots and flips), row-lowered "
        f"({BOX_M + BOX_N} rows, the first {BOX_ROW_LANES} lanes) "
        f"{res['rows']['seconds']:.2f} s = "
        f"{res['rows']['lanes_per_s']:.1f} lanes/s ({res['rows']['pivots']}"
        " pivots); exact refinement and certificate per lane included; "
        f"exact objectives {'equal' if not bad else 'DIFFER'} lane for lane;"
        f" launches of the bounded batch {launches}")
    if bad:
        raise AssertionError(f"bounded batch: lanes {bad[:8]} differ")
    if dev == "cuda" and (launches["lane_bounded"] != 1
                          or launches["fused_fma"] != 0):
        raise AssertionError(f"8b: the bounded batch launched lane_bounded "
                             f"{launches['lane_bounded']} times and the FMA "
                             f"{launches['fused_fma']} times, not 1 and 0")

    # the same solve by parts, each part ending in a synchronisation
    split = {}
    sync(dev)
    t0 = time.perf_counter()
    bs = make_batched_bounded_states(sfs, dtype=torch.float64, device=dev)
    sync(dev)
    split["build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = run_simplex_bounded_batch(bs)
    sync(dev)
    split["walk_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    parts = extract_batch_bounded_solutions(sfs, out, "auto")
    split["extract_s"] = time.perf_counter() - t0
    if [p.objective for p in parts] != [a.objective
                                         for a in sols["bounded"]]:
        raise AssertionError("8b: the solve by parts differs from "
                             "solve_lp_batch's")
    res["split"] = split
    total = sum(split.values())
    log(f"# 8b the bounded batch by parts (f64): build {split['build_s']:.4f}"
        f" s, walk {split['walk_s']:.4f} s, extraction (per-lane "
        f"refinement and certificate) {split['extract_s']:.3f} s "
        f"({100 * split['extract_s'] / total:.1f}% of {total:.3f} s)")
    res["kernel"] = bounded_lane_cases(dev)
    return res


# phase 8b's checks of lane_bounded: the streamed lanes (258 x 513 frames,
# past a block's shared memory), the budget of the budget case, and that of
# the stall case (a stall limit of 1 turns every lane to Bland's rule,
# whose walks run ~30x longer)
BOX_STREAM_LANES, BOX_STREAM_M, BOX_STREAM_N = 8, 256, 256
BOX_BUDGET, BOX_STALL_BUDGET = 7, 300
SPAN_SEED = 3


def bounded_fields(bs) -> list:
    """(name, tensor) of a batched BoundedState: the ten state fields, the
    spans, the at-upper flags and the devex weights."""
    return list(zip(bs.s._fields, bs.s)) + [
        ("upper", bs.upper), ("at_upper", bs.at_upper), ("gamma", bs.gamma)]


def bounded_lanes_equal(k, p) -> float:
    """Raise unless lane_bounded's state ``k`` equals the plain loop's ``p``
    bit for bit in every field (``tensors_equal``); returns the largest
    |difference| over the tableau entries finite in both."""
    for (name, a), (_, b) in zip(bounded_fields(k), bounded_fields(p)):
        if (a is None) != (b is None):
            raise AssertionError(f"bounded lane field {name}: present in "
                                 "one state only")
        if a is not None:
            tensors_equal(f"bounded lane field {name}", a, b)
    return max_finite_diff(k.s.T, p.s.T)


def bounded_pivots(bs, opts, stall: int) -> int:
    """The lanes' pivots, the steps that change a basis (an entering flip
    changes none): the plain step vmapped over the lanes, stepped to the
    last lane's exit, counting."""
    import torch

    from tpulp_torch.core.state import Status
    from tpulp_torch.solve.bounded import BoundedState, bounded_simplex_step

    width = 4 if bs.gamma is not None else 3
    step = torch.func.vmap(lambda c: tuple(bounded_simplex_step(
        BoundedState(*c), opts, stall, opts.max_iters))[:width])
    c = tuple(bs)[:width]
    pivots = torch.zeros((), dtype=torch.int64, device=bs.s.T.device)
    while bool(((c[0].status == Status.RUNNING)
                & (c[0].niter < opts.max_iters)).any()):
        nxt = step(c)
        pivots += (nxt[0].basis != c[0].basis).any(dim=1).sum()
        c = nxt
    return int(pivots)


def bounded_lane_run(bs, opts, runs: int, plain_runs: int, dev="cuda",
                     timed: bool = True):
    """One check of ``lane_bounded`` on a batched BoundedState: the kernel
    and the plain loop (``bounded_lanes_reference``) held bit for bit; with
    ``timed``, CUDA-event medians of ``runs`` kernel calls (host work
    included) and of ``plain_runs`` plain calls, ``runs`` launches on the
    card alone (``device_time_ms``), the longest lane's steps, the
    pivots and flips, and the bound. Returns (kernel state, stats)."""
    import torch

    from tpulp_torch.core.state import RULE_DEVEX
    from tpulp_torch.kernels import lane_bounded_plan
    from tpulp_torch.kernels import lanes as klanes
    from tpulp_torch.solve import lanes

    if opts.rule == RULE_DEVEX and bs.gamma is None:
        bs = bs._replace(gamma=torch.ones_like(bs.upper))
    B, M, N = bs.s.T.shape
    stall = opts.resolved_stall_limit(M - 2, N - 1)

    def kernel():
        return lanes.bounded_lanes(bs, opts, stall, opts.max_iters)

    def plain():
        return lanes.bounded_lanes_reference(bs, opts, stall, opts.max_iters)

    k, p = kernel(), plain()
    sync(dev)
    err = bounded_lanes_equal(k, p)
    dn = (k.s.niter - bs.s.niter).cpu()
    plan = lane_bounded_plan(M, N, bs.s.T.dtype)
    # the other resident plans: one warp and 256 threads
    held = []
    if plan.resident:
        for th in (32, 256):
            bounded_lanes_equal(klanes.lane_bounded(bs, opts, stall,
                                                    opts.max_iters,
                                                    threads=th), p)
            held.append(f"threads {th}")
    statuses = {int(v): int(c) for v, c in
                zip(*np.unique(k.s.status.cpu().numpy(), return_counts=True))}
    stats = {"lanes": B, "frame": [M, N], "resident": plan.resident,
             "threads": plan.threads, "smem": plan.smem, "held": held,
             "steps": int(dn.max()), "acts": int(dn.sum()),
             "statuses": statuses, "max_abs_err": err, "library_ms": None}
    if not timed:
        return k, stats
    if dev == "cuda":
        # block 0's clock by stage (lane 0's steps) and its block barriers
        cyc = torch.zeros(len(klanes.LANE_STAGES), dtype=torch.int64,
                          device=dev)
        klanes.lane_bounded(bs, opts, stall, opts.max_iters,
                            stage_cycles=cyc)
        sync(dev)
        steps0 = max(1, int(p.s.niter[0] - bs.s.niter[0]))
        vals = dict(zip(klanes.LANE_STAGES, cyc.tolist()))
        stats["barriers_per_step"] = vals.pop("barriers") / steps0
        hz = sm_clock_hz()
        stats["stage_us_per_step"] = {key: 1e6 * v / hz / steps0
                                      for key, v in vals.items()}
        stats["lane0_steps"] = steps0
    # a CPU rehearsal times nothing
    timer = cuda_time_ms if dev == "cuda" else lambda fn, runs: None
    stats["ms"] = timer(kernel, runs)
    stats["plain_ms"] = timer(plain, plain_runs)
    stats["device_ms"] = (device_time_ms(kernel, runs) if dev == "cuda"
                          else None)
    steps = max(stats["steps"], 1)
    stats["us_per_step"] = (1e3 * stats["ms"] / steps if stats["ms"]
                            else None)
    stats["device_us_per_step"] = (1e3 * stats["device_ms"] / steps
                                   if stats["device_ms"] else None)
    pivots = bounded_pivots(bs, opts, stall)
    stats["pivots"] = pivots
    es = bs.s.T.element_size()
    m, n = M - 2, N - 1
    devex = bs.gamma is not None
    # a lane's frame, basis, masks, at-upper flags and scalars read and
    # written once, its spans read, its devex weights read and written;
    # an fma a tableau entry a pivot, an fma a row an entering flip
    per_lane = (2 * (M * N * es + 4 * m + 3 * n + 17 + es) + n * es
                + 2 * devex * n * es)
    flops = 2.0 * M * N * pivots + 2.0 * M * (stats["acts"] - pivots)
    stats["bound_ms"], stats["bound_by"] = bound(
        B * per_lane, flops,
        FP64_FLOP_S if bs.s.T.dtype == torch.float64 else FP32_FLOP_S)
    return k, stats


def span_nodes(dt, dev="cuda", seed: int = SPAN_SEED):
    """10c's batched state at ``dt``: MILP_BATCH span-encoded nodes of the
    bench knapsack (3 x 30 frames, no bound rows), each with three seeded
    items fixed."""
    from tpulp_torch.batch import make_batched_bounded_states
    from tpulp_torch.milp.spans import _int_columns, _node_sf
    from tpulp_torch.model.lower import lower_to_standard_form

    values, weights, cap = bench_knapsack()
    prog = knapsack_lp(values, [weights], [cap])
    root = lower_to_standard_form(prog, simple_bounds=True)
    names = [nm for nm, v in prog.vars.items() if v.isint]
    cols = _int_columns(root, names)
    bounds0 = {nm: (prog.vars[nm].lb, prog.vars[nm].ub) for nm in names}
    rng = np.random.default_rng(seed)
    sfs = []
    for _ in range(MILP_BATCH):
        node = dict(bounds0)
        for i in rng.choice(len(names), size=3, replace=False):
            v = int(rng.integers(0, 2))
            node[names[i]] = (v, v)
        sfs.append(_node_sf(root, cols, bounds0, node))
    return make_batched_bounded_states(sfs, dtype=dt, device=dev)


def bounded_lane_cases(dev="cuda"):
    """8b's checks of ``lane_bounded``, each bit for bit against the plain
    loop on the card, at f64 and f32: the BOX_LANES box LPs under Dantzig
    and devex (timed), to a budget of BOX_BUDGET, under a stall limit of 1
    (the Bland switch; to BOX_STALL_BUDGET), with a NaN lane and an
    overflowing |b| sum (both NUMERIC); 10c's span nodes (timed); and
    BOX_STREAM_LANES box LPs of 258 x 513 (streamed, timed). Each resident
    case is held again on one warp and on 256 threads a block; each timed
    one gives block 0's stage split. Then a launch whose plan disagrees
    with the kernel's byte count is refused."""
    import dataclasses as dc

    import torch

    from tpulp_torch import SolverOptions
    from tpulp_torch.batch import make_batched_bounded_states
    from tpulp_torch.core.state import RULE_DEVEX, Status
    from tpulp_torch.kernels import lanes as klanes

    res = {}
    for dt in (torch.float64, torch.float32):
        name = str(dt).replace("torch.", "")
        opts = SolverOptions.for_dtype(dt)
        devex = dc.replace(opts, rule=RULE_DEVEX)
        box = make_batched_bounded_states(
            [box_form(s, BOX_M, BOX_N) for s in range(BOX_LANES)], dtype=dt,
            device=dev)
        T = box.s.T.clone()
        T[0, 4, -1] = float("nan")
        T[1, 3:5, -1] = torch.finfo(dt).max / 1.5
        numeric = box._replace(s=box.s._replace(T=T))
        wide = make_batched_bounded_states(
            [box_form(s, BOX_STREAM_M, BOX_STREAM_N)
             for s in range(BOX_STREAM_LANES)], dtype=dt, device=dev)
        cases = {}
        for label, bs, o, timed in (
                ("box", box, opts, True), ("box_devex", box, devex, True),
                ("box_budget", box, dc.replace(opts, max_iters=BOX_BUDGET),
                 False),
                ("box_stall", box, dc.replace(
                    opts, stall_limit=1, degen_tol=1e300,
                    max_iters=BOX_STALL_BUDGET), False),
                ("box_numeric", numeric, devex, False),
                ("spans", span_nodes(dt, dev), opts, True),
                ("streamed", wide, opts, True),
                ("streamed_devex", wide, devex, False)):
            k, st = bounded_lane_run(bs, o, RUNS, 1, dev, timed)
            cases[label] = st
            split = "" if "stage_us_per_step" not in st else (
                "; stages (block 0, us a step) " + ", ".join(
                    f"{key} {v:.3f}" for key, v in
                    st["stage_us_per_step"].items())
                + f", {st['barriers_per_step']:.2f} block barriers a step")
            log(f"# 8b lane_bounded {label} {name}: {st['lanes']} lanes of "
                f"{tuple(st['frame'])} "
                f"({'resident' if st['resident'] else 'streamed'}, "
                f"{st['threads']} threads a block, {st['smem']} bytes; held "
                f"too: {st['held']}){split}, bit for bit the plain loop; "
                f"{st['steps']} steps, {st['acts']} pivots and flips, "
                f"statuses {st['statuses']}"
                + ("" if not timed else
                   f"; {st['pivots']} pivots; kernel {st['ms']} ms a call, "
                   f"{st['us_per_step']} us a step (device "
                   f"{st['device_ms']} ms, {st['device_us_per_step']} us a "
                   f"step), plain {st['plain_ms']} ms, bound "
                   f"{st['bound_ms']:.5f} ms ({st['bound_by']})"))
            if label == "box_budget" and \
                    int(k.s.niter.max()) != BOX_BUDGET:
                raise AssertionError(f"8b box_budget {name}: niter "
                                     f"{int(k.s.niter.max())}")
            if label == "box_stall" and not bool(k.s.bland.all()):
                raise AssertionError(f"8b box_stall {name}: a lane did not "
                                     "switch to Bland's rule")
            if label == "box_numeric" and \
                    k.s.status[:2].tolist() != [Status.NUMERIC] * 2:
                raise AssertionError(f"8b box_numeric {name}: statuses "
                                     f"{k.s.status[:2].tolist()}")
        if cases["streamed"]["resident"] or not cases["box"]["resident"]:
            raise AssertionError("8b: the box LPs' frames must be resident "
                                 "and the 258 x 513 frames streamed")
        res[name] = cases
    if dev == "cuda":
        # a plan whose byte count is not the kernel's: the launch refuses it
        # (the wrappers' cache of launch plans emptied before, so that the
        # launch plans afresh, and after, so that no later launch reuses it)
        real = klanes.lane_bounded_plan
        klanes.lane_bounded_plan = lambda M, N, dt, *a: real(
            M, N, dt, *a)._replace(smem=real(M, N, dt, *a).smem + 16)
        klanes._CALLS.clear()
        try:
            bounded_lane_run(box, opts, 1, 1, dev, False)
        except RuntimeError:
            pass
        else:
            raise AssertionError("8b: a plan of the wrong byte count was "
                                 "launched")
        finally:
            klanes.lane_bounded_plan = real
            klanes._CALLS.clear()
        log("# 8b lane_bounded refuses a plan whose byte count is not the "
            "kernel's")
    return res


def batch_forms(m: int, n: int, lanes: int, seed0: int = 0):
    """``lanes`` LPs of ``dense_leq_arrays(m, n)`` (seeds seed0, seed0 +
    1, ...) as StandardForms."""
    return [scenario_form(*dense_leq_arrays(m, n, seed=seed0 + s))
            for s in range(lanes)]


def batch_opts(dt, max_iters=None):
    """The options ``run_simplex_blocked_batch`` walks with by default (a
    budget of ``max_iters`` where given)."""
    from tpulp_torch import SolverOptions
    from tpulp_torch.core import eta_scaled_options

    kw = {} if max_iters is None else {"max_iters": max_iters}
    return eta_scaled_options(SolverOptions.for_dtype(dt, **kw), dt)


def raw_equal(a, b) -> bool:
    """Two tensors equal bit for bit, the sign of a zero and NaN payloads
    included."""
    import torch

    a, b = a.cpu(), b.cpu()
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        ints = {torch.float64: torch.int64, torch.float32: torch.int32}
        a, b = a.view(ints[a.dtype]), b.view(ints[b.dtype])
    return bool(torch.equal(a, b))


def solo_lane_walks(batched, opts, K: int, route: str = "blocked_cluster"):
    """The solo walk of each padded lane of ``batched`` on ``route``
    ("blocked_cluster", "blocked_grid" or "blocked_step"), as
    ``run_simplex_blocked`` would run it: (finished states, blocks each
    lane took, weights)."""
    from tpulp_torch.batch import unstack_state
    from tpulp_torch.kernels import LAUNCHES, reset_launches
    from tpulp_torch.kernels import blocked as kb
    from tpulp_torch.kernels import blocked_cluster as kbc
    from tpulp_torch.kernels import blocked_grid as kg
    from tpulp_torch.solve.driver import finish

    B, M, N = batched.T.shape
    stall = opts.resolved_stall_limit(M - 2, N - 1)
    run = {"blocked_cluster": kbc.blocked_cluster,
           "blocked_grid": kg.blocked_grid,
           "blocked_step": kb.blocked_steps}[route]
    outs, blocks, gammas = [], [], []
    for k in range(B):
        reset_launches()
        s, g = run(unstack_state(batched, k), opts, stall, opts.max_iters, K)
        sync(batched.T.device)
        outs.append(finish(s))
        gammas.append(g)
        blocks.append(LAUNCHES["blocked_cluster" if route == "blocked_cluster"
                               else "blocked_ray"])
    return outs, blocks, gammas


def batch_equals_solo(out, solos, label: str) -> None:
    """Raise unless every lane of the batch's terminal state equals its
    solo walk in every field, bit for bit."""
    for k, solo in enumerate(solos):
        for name, a, b in zip(out._fields, out, solo):
            if not raw_equal(a[k], b):
                raise AssertionError(f"8c {label}: lane {k}'s {name} differs "
                                     "from its solo walk's")


def blocked_batch_solve(sfs, dt, dev):
    """8c (i): ``solve_lp_batch(driver="blocked")`` over ``sfs`` at ``dt``,
    cold and then timed warm, and its walk alone
    (``run_simplex_blocked_batch`` on the batched state, the second of two
    runs); every lane's terminal state equal to the solo
    ``blocked_cluster`` walk of its padded lane bit for bit; its launches
    one ``blocked_cluster_batch``, one ``fused_flush_batch`` and one
    ``blocked_ray_batch`` a block (as many as the longest solo walk's) and
    nothing else."""
    import torch

    import tpulp_torch
    from tpulp_torch.batch import make_batched_states
    from tpulp_torch.kernels import LAUNCHES, reset_launches
    from tpulp_torch.solve import run_simplex_blocked_batch

    name = str(dt)[6:]
    secs = {}
    for run in ("cold", "warm"):
        sync(dev)
        reset_launches()
        t0 = time.perf_counter()
        sols, out, _ = tpulp_torch.solve_lp_batch(
            sfs, driver="blocked", block=BLK_K, device=dev, dtype=dt,
            return_state=True)
        sync(dev)
        secs[run] = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    batched = make_batched_states(sfs, dtype=dt, device=dev)
    for _ in range(2):
        sync(dev)
        t0 = time.perf_counter()
        run_simplex_blocked_batch(batched, None, block=BLK_K)
        sync(dev)
        walk = time.perf_counter() - t0
    solos, blocks, _ = solo_lane_walks(batched, batch_opts(dt), BLK_K)
    batch_equals_solo(out, solos, f"(i) {name}")
    nb = max(blocks)
    kinds = ("blocked_cluster_batch", "fused_flush_batch",
             "blocked_ray_batch")
    others = {k: v for k, v in launches.items() if v and k not in kinds}
    if others or any(launches[k] != nb for k in kinds):
        raise AssertionError(f"8c (i) {name}: launches {launches}, the "
                             f"longest solo walk {nb} blocks")
    del batched
    torch.cuda.empty_cache()
    res = {"seconds": secs["warm"], "cold_seconds": secs["cold"],
           "walk_seconds": walk, "niter": [s.niter for s in sols],
           "status": [s.status for s in sols],
           "objective": [float(s.objective) if s.is_optimal else None
                         for s in sols],
           "blocks": nb, "blocks_by_lane": blocks, "launches": launches}
    log(f"# 8c (i) solve_lp_batch(driver='blocked', block={BLK_K}) "
        f"{len(sfs)} LPs {BLK_M}x{BLK_N} {name}: {secs['warm']:.3f} s warm "
        f"({secs['cold']:.3f} cold), the walk alone {walk:.4f} s; niter "
        f"{res['niter']}; {nb} blocks: launches {launches}; every lane "
        "equal to its solo blocked_cluster walk bit for bit")
    return res


def with_frozen_lanes(batched, max_iters: int):
    """``batched`` with every zero of its last two lanes made -0.0, the
    second last ended (OPTIMAL) and the last running at ``max_iters``."""
    from tpulp_torch.core import Status

    T = batched.T.clone()
    for k in (-2, -1):
        T[k][T[k] == 0] = -0.0
    status, niter = batched.status.clone(), batched.niter.clone()
    status[-2] = Status.OPTIMAL
    niter[-1] = max_iters
    return batched._replace(T=T, status=status, niter=niter)


def small_batch_checks(dev):
    """8c (iii): BLK_SMALL_LANES LPs of 66 x 193 in blocks of BLK_SMALL_K,
    whole and to a budget inside a block, with one lane ended and one at
    its budget at the start: ``blocked_cluster_batch`` on clusters of 1, 2,
    4 and 8 against ``blocked_cluster_batch_reference`` on the same cluster
    size (flushed by B1) in every field and the devex weights, at f64 and
    f32; the frozen lanes bit for bit as they went in."""
    import torch

    from tpulp_torch.batch import make_batched_states
    from tpulp_torch.kernels import LAUNCHES, reset_launches
    from tpulp_torch.kernels import blocked_cluster as kbc
    from tpulp_torch.kernels.block import fused_flush

    sfs = batch_forms(BLK_SMALL_M, BLK_SMALL_N, BLK_SMALL_LANES, seed0=100)
    K = BLK_SMALL_K
    res = {}
    for dt in (torch.float64, torch.float32):
        base = make_batched_states(sfs, dtype=dt, device=dev)
        for budget in (None, BLK_SMALL_BUDGET):
            o = batch_opts(dt, budget)
            st = with_frozen_lanes(base, o.max_iters)
            stall = o.resolved_stall_limit(st.T.shape[1] - 2,
                                           st.T.shape[2] - 1)
            for C in BLK_SMALL_SIZES:
                label = f"{str(dt)[6:]} budget {budget} C {C}"
                reset_launches()
                out, g = kbc.blocked_cluster_batch(st, o, stall, o.max_iters,
                                                   K, blocks=C)
                sync(dev)
                launches = LAUNCHES["blocked_cluster_batch"]
                t0 = time.perf_counter()
                ref, gr = kbc.blocked_cluster_batch_reference(
                    st, o, stall, o.max_iters, K, C, flush=fused_flush)
                sync(dev)
                plain = time.perf_counter() - t0
                err = lanes_equal(out, ref)
                if not torch.equal(g.cpu() + 0.0, gr.cpu() + 0.0):
                    raise AssertionError(f"8c (iii) {label}: the devex "
                                         "weights differ")
                for k in (-2, -1):
                    for name, a, b in zip(out._fields, out, st):
                        if not raw_equal(a[k], b[k]):
                            raise AssertionError(
                                f"8c (iii) {label}: frozen lane {k}'s "
                                f"{name} changed")
                live = out.niter[:-2].tolist()
                if budget is not None and max(live) != budget:
                    raise AssertionError(f"8c (iii) {label}: no lane "
                                         f"stopped at the budget: {live}")
                if budget is None and len({n // K for n in live}) < 2:
                    raise AssertionError(f"8c (iii) {label}: every lane "
                                         f"ended in one block: {live}")
                res[label] = {"launches": launches, "niter": live,
                              "max_abs_err": err, "plain_seconds": plain}
        del base
    log("# 8c (iii) " + f"{BLK_SMALL_LANES} LPs {BLK_SMALL_M}x{BLK_SMALL_N}"
        f" K={K}: blocked_cluster_batch equals blocked_cluster_batch_"
        "reference in every field at "
        + "; ".join(f"{k} ({v['launches']} launches, niter {v['niter']})"
                    for k, v in res.items())
        + "; the ended lane and the lane at its budget bit for bit")
    return res


def occupancy_batch(dev):
    """8c (iv): BLK_OCC_LANES LPs of 130 x 385, more lanes than the card
    holds clusters at once: ``run_simplex_blocked_batch`` on
    ``blocked_cluster_batch``, every lane equal to its solo walk bit for
    bit."""
    import torch

    from tpulp_torch.batch import make_batched_states
    from tpulp_torch.kernels import LAUNCHES, reset_launches
    from tpulp_torch.kernels import blocked_cluster as kbc
    from tpulp_torch.solve import run_simplex_blocked_batch

    dt = torch.float64
    st = make_batched_states(batch_forms(BLK_OCC_M, BLK_OCC_N, BLK_OCC_LANES,
                                         seed0=200), dtype=dt, device=dev)
    _, M, N = st.T.shape
    occ = kbc.blocked_cluster_occupancy(M, N, BLK_K, dt, st.T.device)
    plan = kbc.blocked_cluster_plan(M, N, BLK_K, dt)
    if occ >= BLK_OCC_LANES:
        raise AssertionError(f"8c (iv): the card holds {occ} clusters, not "
                             f"fewer than {BLK_OCC_LANES}")
    sync(dev)
    reset_launches()
    t0 = time.perf_counter()
    out = run_simplex_blocked_batch(st, None, block=BLK_K)
    sync(dev)
    secs = time.perf_counter() - t0
    launches = LAUNCHES["blocked_cluster_batch"]
    solos, blocks, _ = solo_lane_walks(st, batch_opts(dt), BLK_K)
    batch_equals_solo(out, solos, "(iv)")
    if launches != max(blocks):
        raise AssertionError(f"8c (iv): {launches} launches, {max(blocks)} "
                             "blocks")
    log(f"# 8c (iv) {BLK_OCC_LANES} LPs {M}x{N} f64: clusters of "
        f"{plan.blocks}, cudaOccupancyMaxActiveClusters {occ}; "
        f"{launches} launches, {secs:.3f} s; every lane equal to its solo "
        f"walk bit for bit (niter {out.niter.tolist()})")
    return {"occupancy": occ, "lanes": BLK_OCC_LANES, "launches": launches,
            "seconds": secs, "niter": out.niter.tolist()}


def wide_batch(dev):
    """8c (v): BLK_WIDE_LANES lanes of 5d (g)'s wide LP (258 x 14,257),
    past the cluster's plan, to a budget of BLK_WIDE_BUDGET pivots:
    ``run_simplex_blocked_batch`` runs each lane on ``blocked_grid`` in turn
    (one launch a block, no batch launch, no ``blocked_step``), every lane
    equal to its solo walk bit for bit."""
    import torch

    from tpulp_torch.batch import make_batched_states
    from tpulp_torch.kernels import LAUNCHES, reset_launches
    from tpulp_torch.solve import run_simplex_blocked_batch
    from tpulp_torch.solve.blocked import blocked_route

    dt = torch.float64
    sfs = [scenario_form(*dense_leq_arrays(BLK5_WIDE_M, BLK5_WIDE_N,
                                           seed=2 + s))
           for s in range(BLK_WIDE_LANES)]
    st = make_batched_states(sfs, dtype=dt, device=dev)
    _, M, N = st.T.shape
    if blocked_route(M, N, BLK_K, dt, st.T.device) != "blocked_grid":
        raise AssertionError(f"8c (v): {M} x {N} is not on the grid's route")
    o = batch_opts(dt, BLK_WIDE_BUDGET)
    sync(dev)
    reset_launches()
    out = run_simplex_blocked_batch(st, o, block=BLK_K)
    sync(dev)
    launches = dict(LAUNCHES)
    if not launches["blocked_grid"] or launches["blocked_grid"] != \
            launches["blocked_ray"] or any(launches[k] for k in (
                "blocked_cluster_batch", "fused_flush_batch",
                "blocked_ray_batch", "blocked_cluster", "blocked_step",
                "fused_fma")):
        raise AssertionError(f"8c (v): launches {launches}")
    solos, _, _ = solo_lane_walks(st, o, BLK_K, route="blocked_grid")
    batch_equals_solo(out, solos, "(v)")
    log(f"# 8c (v) {BLK_WIDE_LANES} LPs {M}x{N} f64, budget "
        f"{BLK_WIDE_BUDGET}: past the cluster's plan, each lane on "
        f"blocked_grid in turn (launches {launches}), every lane equal to "
        "its solo walk bit for bit")
    del st
    torch.cuda.empty_cache()
    return {"launches": launches, "niter": out.niter.tolist()}


def batch_block_times(sfs, dt, dev):
    """8c (vi): the second block of the batch's walk at ``dt``: one
    ``blocked_cluster_batch`` launch over every lane (CUDA events after a
    sleep, the host's time to launch it, lane 0's block 0 clock by stage)
    against the plain version's block on the card (held equal in every
    field of the carry); B1 batched against ``torch.baddbmm`` on the same
    operands and against its plain version; the ray launch over the lanes
    against its plain version; each with its bound."""
    import torch

    from tpulp_torch.batch import make_batched_states, unstack_state
    from tpulp_torch.kernels import blocked as kb
    from tpulp_torch.kernels import blocked_cluster as kbc
    from tpulp_torch.kernels.block import (fused_flush_batch,
                                           fused_flush_batch_reference)

    name = str(dt)[6:]
    st = make_batched_states(sfs, dtype=dt, device=dev)
    B, M, N = st.T.shape
    K = BLK_K
    o = batch_opts(dt)
    stall = o.resolved_stall_limit(M - 2, N - 1)
    mi = o.max_iters
    C = kbc.blocked_cluster_plan(M, N, K, dt).blocks
    rec = kb.make_batch_record(st, K)
    kbc.blocked_cluster_batch_block(rec, o, stall, mi)
    kb.flush_and_ray_batch(rec, o, stall, mi)
    start = kb.clone_record(rec)
    dev_ms, host_ms = [], []
    for _ in range(3):
        c = kb.clone_record(start)
        d, h = launches_us(lambda: kbc.blocked_cluster_batch_block(
            c, o, stall, mi), 1)
        dev_ms.append(d / 1e3)
        host_ms.append(h / 1e3)
    if c.ints[:, kb.STATUS].any() or not bool(
            (c.ints[:, kb.SLOT] == K).all()):
        raise AssertionError(f"8c (vi) {name}: the timed block did not run "
                             f"{K} slots in every lane")
    cyc = torch.zeros((len(kbc.BLOCKED_CLUSTER_STAGES),), dtype=torch.int64,
                      device=st.T.device)
    kbc.blocked_cluster_batch_block(kb.clone_record(start), o, stall, mi,
                                    stage_cycles=cyc)
    p = kb.clone_record(start)
    sync(dev)
    t0 = time.perf_counter()
    for k in range(B):
        kbc.blocked_cluster_block_reference(kb.lane_record(p, k), o, stall,
                                            mi, C)
    sync(dev)
    plain_ms = 1e3 * (time.perf_counter() - t0)
    err = lanes_equal(kb.record_state(c), kb.record_state(p))
    for f in ("U", "V", "row0", "row1", "bvec", "gamma"):
        if not torch.equal(getattr(c, f).cpu() + 0.0,
                           getattr(p, f).cpu() + 0.0):
            raise AssertionError(f"8c (vi) {name}: the launch's {f} differs "
                                 "from the plain block's")
    dev_ms = float(np.median(dev_ms))
    share = (cyc.double() / cyc.sum().double().clamp_min(1)).tolist()
    split = {s: dev_ms * f for s, f in zip(kbc.BLOCKED_CLUSTER_STAGES,
                                           share)}
    slot_ms, by = cluster_bound(unstack_state(st, 0), o, K)
    res = {"cluster": {
        "max_abs_err": err, "ms": dev_ms, "plain_ms": plain_ms,
        "bound_ms": B * K * slot_ms, "bound_by": by, "library_ms": None,
        "host_ms": float(np.median(host_ms)), "device_ms_by_stage": split,
        "lanes": B, "blocks": C}}
    # B1 over the lanes, on the carry after the timed launch (every lane
    # live); the library's batched product on the same operands
    T, U, V, ca = kb.flush_inputs(c)
    live = c.ints[:, kb.LIVE]
    ot, pt = float(o.opt_tol), float(o.piv_tol)
    Tk, Tp = T.clone(), T.clone()
    _, scan = fused_flush_batch(Tk, U, V, ca, live, ot, pt)
    fused_flush_batch_reference(Tp, U, V, ca, live, ot, pt)
    sync(dev)
    # the scan columns of the kernel's own flushed lanes (the two products
    # sum in different orders, so a reduced cost within rounding of a
    # tolerance may fall on either side of it)
    for k in range(B):
        if not torch.equal(scan[k].cpu(), scan_of(Tk[k], ca[k], ot,
                                                  pt).cpu()):
            raise AssertionError(f"8c (vi) {name}: B1 batched's scan "
                                 f"columns of lane {k} are not its T's")
    flush_err = float((Tk - Tp).abs().max())
    tol = 1e-9 if dt == torch.float64 else 1e-3
    if not flush_err <= tol * max(1.0, float(Tp.abs().max())):
        raise AssertionError(f"8c (vi) {name}: B1 batched differs from the "
                             f"plain version by {flush_err}")
    Tw = T.clone()
    es = T.element_size()
    res["flush"] = {
        "max_abs_err": flush_err,
        "ms": device_time_ms(lambda: fused_flush_batch(Tw, U, V, ca, live,
                                                       ot, pt), RUNS),
        "plain_ms": cuda_time_ms(lambda: fused_flush_batch_reference(
            Tw, U, V, ca, live, ot, pt), 5),
        "library_ms": device_time_ms(lambda: torch.baddbmm(
            T, U.transpose(1, 2), V), RUNS)}
    res["flush"]["bound_ms"], res["flush"]["bound_by"] = bound(
        B * (es * (2 * M * N + K * (M + N)) + 4 * 3 * N),
        2.0 * B * M * N * K,
        FP64_TC_FLOP_S if dt == torch.float64 else FP32_FLOP_S)
    # the ray launch over the lanes, after the flush
    ck = kb.clone_record(c)
    ck.T.copy_(Tk)
    cp = kb.clone_record(ck)
    kb.ray_batch(ck, scan, o, stall, mi)
    for k in range(B):
        kb.blocked_ray_reference(kb.lane_record(cp, k), scan[k], o)
    sync(dev)
    for f, a, b in zip(ck._fields, ck, cp):
        if f != "scratch" and not raw_equal(a, b):
            raise AssertionError(f"8c (vi) {name}: the ray launch's {f} "
                                 "differs from the plain stage's")
    cw = kb.clone_record(ck)

    def plain_ray():
        for k in range(B):
            kb.blocked_ray_reference(kb.lane_record(cw, k), scan[k], o)

    res["ray"] = {
        "max_abs_err": 0.0,
        "ms": device_time_ms(lambda: kb.ray_batch(cw, scan, o, stall, mi),
                             RUNS),
        "plain_ms": cuda_time_ms(plain_ray, 5), "library_ms": None}
    res["ray"]["bound_ms"], res["ray"]["bound_by"] = bound(
        B * (es * (2 * (2 * N + M) + K * (M + N)) + 4 * 2 * N), 0.0,
        FP64_FLOP_S)
    log(f"# 8c (vi) {B} LPs {M}x{N} {name} K={K} C={C}: one "
        f"blocked_cluster_batch launch {dev_ms:.4f} ms on the card (host "
        f"{res['cluster']['host_ms']:.4f} ms to launch; lane 0's block 0: "
        + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
        + f"), the plain block {plain_ms:.1f} ms, bound "
        f"{res['cluster']['bound_ms']:.5f} ms ({by}); B1 batched "
        f"{res['flush']['ms']:.4f} ms, torch.baddbmm "
        f"{res['flush']['library_ms']:.4f}, plain "
        f"{res['flush']['plain_ms']:.4f}, bound "
        f"{res['flush']['bound_ms']:.5f} ({res['flush']['bound_by']}), "
        f"max |diff| {flush_err:.2e}; the ray launch {res['ray']['ms']:.4f} "
        f"ms, plain {res['ray']['plain_ms']:.3f}, bound "
        f"{res['ray']['bound_ms']:.5f}")
    del st, rec, start, c, p, ck, cp, cw, Tk, Tp, Tw
    torch.cuda.empty_cache()
    return res


def phase_blocked_batch(dev):
    """Phase 8c: the blocked batch on the card. (i)
    ``solve_lp_batch(driver="blocked", block=BLK_K)`` over BLK_LANES LPs of
    BLK_M x BLK_N (tests/test_warm_start.py's recipe, seeds 0 to BLK_LANES
    - 1) at f64 and f32, timed: every lane equal to the solo
    ``blocked_cluster`` walk of its padded lane bit for bit, one
    ``blocked_cluster_batch``, ``fused_flush_batch`` and
    ``blocked_ray_batch`` launch a block and no other; each f64 objective
    within 1e-9 relative of the solo ``solve_lp(driver="blocked")``'s; (ii)
    the eager batch (``run_simplex_blocked_batch_reference``) on the card
    once at f64, timed, its objectives within 1e-9 of the kernels'; (iii)
    a small batch against its plain version at every cluster size
    (``small_batch_checks``); (iv) more lanes than the card holds clusters
    (``occupancy_batch``); (v) a wide batch past the cluster's plan, on
    the grid (``wide_batch``); (vi) a block's launches timed, each beside its plain
    version, B1 beside ``torch.baddbmm`` (``batch_block_times``)."""
    import torch

    import tpulp_torch
    from tpulp_torch.batch import make_batched_states
    from tpulp_torch.solve.blocked import run_simplex_blocked_batch_reference

    sfs = batch_forms(BLK_M, BLK_N, BLK_LANES)
    res = {"solves": {str(dt)[6:]: blocked_batch_solve(sfs, dt, dev)
                      for dt in (torch.float64, torch.float32)}}
    main = res["solves"]["float64"]
    sync(dev)
    t0 = time.perf_counter()
    solo = [tpulp_torch.solve_lp(sf, driver="blocked", block=BLK_K,
                                 device=dev) for sf in sfs]
    sync(dev)
    solo_secs = time.perf_counter() - t0
    rel = [abs(a - float(s.objective)) / max(1.0, abs(float(s.objective)))
           if a is not None and s.is_optimal else float("inf")
           for a, s in zip(main["objective"], solo)]
    if max(rel) > 1e-9:
        raise AssertionError(f"blocked batch: lanes differ from solo {rel}")
    batched = make_batched_states(sfs, dtype=torch.float64, device=dev)
    sync(dev)
    t0 = time.perf_counter()
    eager = run_simplex_blocked_batch_reference(batched, None, BLK_K)
    sync(dev)
    eager_secs = time.perf_counter() - t0
    eager_obj = (-eager.T[:, 0, -1]).tolist()
    erel = [abs(a - e) / max(1.0, abs(e)) if a is not None else float("inf")
            for a, e in zip(main["objective"], eager_obj)]
    if max(erel) > 1e-9 or [s == "optimal" for s in main["status"]] != [
            int(x) == 1 for x in eager.status.tolist()]:
        raise AssertionError(f"8c (ii): the eager batch differs: {erel}, "
                             f"status {eager.status.tolist()}")
    del batched, eager
    torch.cuda.empty_cache()
    log(f"# solve_lp_batch(driver='blocked', block={BLK_K}) {BLK_LANES} "
        f"LPs {BLK_M}x{BLK_N} f64: {main['seconds']:.3f} s on "
        f"blocked_cluster_batch (f32 {res['solves']['float32']['seconds']:.3f}"
        f" s), its walk {main['walk_seconds']:.4f} s; the eager batch's "
        f"walk {eager_secs:.2f} s; solo: {solo_secs:.2f} s "
        f"for the {BLK_LANES}; niter batch {main['niter']}, solo "
        f"{[s.niter for s in solo]}; max relative objective difference "
        f"{max(rel):.2e} (solo), {max(erel):.2e} (eager)")
    res.update({"seconds": main["seconds"], "solo_seconds": solo_secs,
                "eager_seconds": eager_secs, "niter": main["niter"],
                "solo_niter": [s.niter for s in solo],
                "max_rel_objective": max(rel),
                "max_rel_objective_eager": max(erel)})
    res["small"] = small_batch_checks(dev)
    res["occupancy"] = occupancy_batch(dev)
    res["wide"] = wide_batch(dev)
    res["times"] = {str(dt)[6:]: batch_block_times(sfs, dt, dev)
                    for dt in (torch.float64, torch.float32)}
    return res


def wyndor_ranging_lp():
    """The Wyndor LP: max 3x + 5y, x <= 4 (p1), 2y <= 12 (p2), 3x + 2y <=
    18 (p3); optimum 36 at (2, 6)."""
    from tpulp_torch import LinExpr, LinProg

    lp = LinProg("wyndor")
    lp.addVar("x")
    lp.addVar("y")
    lp.maximize(LinExpr(3, "x", 5, "y"))
    lp.addConstraint(LinExpr(1, "x").constraintLeq(4), name="p1")
    lp.addConstraint(LinExpr(2, "y").constraintLeq(12), name="p2")
    lp.addConstraint(LinExpr(3, "x", 2, "y").constraintLeq(18), name="p3")
    return lp


def infeasible_lp():
    """x >= 3 (hi), x <= 1 (lo), x <= 7: infeasible, IIS {hi, lo}."""
    from tpulp_torch import LinExpr, LinProg

    lp = LinProg("infeasible")
    lp.addVar("x")
    lp.minimize(LinExpr(1, "x"))
    lp.addConstraint(LinExpr(1, "x").constraintGeq(3), name="hi")
    lp.addConstraint(LinExpr(1, "x").constraintLeq(1), name="lo")
    lp.addConstraint(LinExpr(1, "x").constraintLeq(7))
    return lp


def planted_iis_lp(seed: int = 0):
    """IIS_ROWS constraints over IIS_VARS variables: IIS_ROWS - 2 random
    rows A x <= b with A >= 0 that x = 0 and a point with x0 + x1 = 12
    both satisfy, and the planted pair x0 + x1 >= 10 ("need10"),
    x0 + x1 <= 5 ("cap5"). Every infeasible subset holds both, so the
    pair is the only IIS."""
    from tpulp_torch import LinExpr, LinProg

    rng = np.random.default_rng(seed)
    lp = LinProg("planted")
    for j in range(IIS_VARS):
        lp.addVar(f"v{j}")
    lp.minimize(LinExpr())
    point = np.zeros(IIS_VARS, dtype=np.int64)
    point[:2] = 6
    A = rng.integers(0, 4, size=(IIS_ROWS - 2, IIS_VARS))
    b = A @ point + rng.integers(1, 10, size=IIS_ROWS - 2)
    for i in range(IIS_ROWS - 2):
        e = LinExpr()
        for j in range(IIS_VARS):
            if A[i, j]:
                e += LinExpr(int(A[i, j]), f"v{j}")
        lp.addConstraint(e.constraintLeq(int(b[i])))
        if i == IIS_ROWS // 2:
            lp.addConstraint(LinExpr(1, "v0", 1, "v1").constraintGeq(10),
                             name="need10")
    lp.addConstraint(LinExpr(1, "v0", 1, "v1").constraintLeq(5),
                     name="cap5")
    return lp


def phase_exact_layer(dev):
    """Phase 8d/8e: certificates (the corpus's infeasible and unbounded
    cases; verify_farkas / verify_ray), Wyndor's ranging pins, find_iis
    with host_max_m=0 on the planted LP (every oracle call a solve on the
    card), and ``python -m tpulp_torch solve`` in a subprocess on Wyndor
    (--ranging) and on an infeasible file (--certificates)."""
    import os
    import tempfile

    import tpulp_torch
    import tpulp_torch.solve.api as api
    from tpulp_torch.corpus import CASES
    from tpulp_torch.model.serialize import save_prog

    res = {"certificates": {}}
    for case in CASES:
        if case.status not in ("infeasible", "unbounded"):
            continue
        # one program: a corpus builder may draw a new instance each call
        lp = case.lp()
        sol = tpulp_torch.solve_lp(lp, certificates=True, device=dev)
        sf = lp.lower()
        ok = sol.status == case.status and (
            tpulp_torch.verify_farkas(sf, sol.farkas)
            if case.status == "infeasible"
            else tpulp_torch.verify_ray(sf, sol.ray))
        log(f"# certificate {case.name}: {sol.status}, "
            f"{'farkas' if sol.farkas else 'ray'} "
            f"{'verified' if ok else 'WRONG'}")
        if not ok:
            raise AssertionError(f"certificate of {case.name} failed")
        res["certificates"][case.name] = sol.status
    sol = tpulp_torch.solve_lp(wyndor_ranging_lp(), ranging=True, device=dev)
    pins = (sol.cost_ranging == {"x": (0, Fraction(15, 2)), "y": (2, None)}
            and sol.rhs_ranging["p2"] == (6, 18)
            and sol.rhs_ranging["p3"] == (12, 24))
    log(f"# Wyndor ranging: objective {sol.objective}, cost "
        f"{sol.cost_ranging}, rhs p2 {sol.rhs_ranging['p2']} p3 "
        f"{sol.rhs_ranging['p3']}: {'the pins' if pins else 'WRONG'}")
    if not (pins and sol.objective == 36):
        raise AssertionError("Wyndor ranging differs from the pins")

    calls = []
    real = api.solve_lp

    def spy(prog, **kw):
        calls.append(kw.get("device"))
        return real(prog, **kw)

    api.solve_lp = spy
    try:
        t0 = time.perf_counter()
        iis = tpulp_torch.find_iis(planted_iis_lp(), host_max_m=0,
                                   device=dev)
        secs = time.perf_counter() - t0
    finally:
        api.solve_lp = real
    log(f"# find_iis(host_max_m=0) on {IIS_ROWS} constraints: {iis}, "
        f"{len(calls)} oracle solves on {set(calls)}, {secs:.2f} s")
    if sorted(iis) != ["cap5", "need10"] or len(calls) != IIS_ROWS + 1 \
            or set(calls) != {dev}:
        raise AssertionError("find_iis missed the planted conflict or "
                             "solved off the card")
    res["iis"] = {"set": iis, "oracle_solves": len(calls), "seconds": secs}

    tmp = tempfile.mkdtemp()
    paths = {}
    for name, lp in (("wyndor", wyndor_ranging_lp()),
                     ("infeasible", infeasible_lp())):
        paths[name] = os.path.join(tmp, f"{name}.json")
        save_prog(paths[name], lp)
    root = os.path.dirname(os.path.abspath(__file__))
    out = {}
    for name, flag in (("wyndor", "--ranging"),
                       ("infeasible", "--certificates")):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "tpulp_torch", "solve", paths[name],
             flag], cwd=root, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"CLI on {name}: {proc.stderr[-2000:]}")
        out[name] = json.loads(proc.stdout)
        log(f"# python -m tpulp_torch solve {name}.json {flag} (cuda, "
            f"{time.perf_counter() - t0:.1f} s): {proc.stdout.strip()}")
    w, bad = out["wyndor"], out["infeasible"]
    golden = (w["status"] == "optimal" and w["objective"] == "36"
              and w["cost_ranging"] == {"x": ["0", "15/2"],
                                        "y": ["2", None]}
              and w["rhs_ranging_by_name"]["p2"] == ["6", "18"]
              and w["rhs_ranging_by_name"]["p3"] == ["12", "24"]
              and bad["status"] == "infeasible"
              and tpulp_torch.verify_farkas(
                  infeasible_lp().lower(),
                  [Fraction(v) for v in bad["farkas"]]))
    if not golden:
        raise AssertionError(f"CLI JSON differs from the golden values: "
                             f"{out}")
    res["cli"] = out
    return res



# ---------------------------------------------------------------------------
# phase 9: the sharded path (solve_lp(mesh=...)) on a one-process mesh
# ---------------------------------------------------------------------------

def sync(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def collectives_per_step(counts, steps: int):
    """{kind:dtype x elements: calls a step} from comm's call counts."""
    return {f"{k}:{d}x{e}": c / max(steps, 1)
            for (k, d, e), c in sorted(counts.items())}


def first_block(sf, mesh, dtype):
    """(run, flush): ``run()`` takes the sharded blocked driver through the
    first SHARD_K pivots on ``sf`` and returns its carry (the block-start
    block, U, Vl, ...), unflushed; ``flush(carry)`` ends the block."""
    from tpulp_torch import SolverOptions
    from tpulp_torch.comm.collectives import MeshAxis
    from tpulp_torch.core import eta_scaled_options
    from tpulp_torch.shard import to_sharded_state
    from tpulp_torch.shard.sharded_blocked import (_flush, _fresh_carry,
                                                   _sharded_blocked_pivot)
    from tpulp_torch.solve.api import state_from_standard_form

    st = state_from_standard_form(sf, dtype=dtype,
                                  device=mesh.device_type)
    sh = to_sharded_state(st, mesh)
    lay = MeshAxis(mesh)
    opts = eta_scaled_options(SolverOptions.for_dtype(dtype), dtype)
    n_global = sh.T.shape[1] * lay.size
    stall = opts.resolved_stall_limit(st.m, n_global)

    def run():
        carry = _fresh_carry(sh._replace(T=sh.T.clone()), SHARD_K, lay)
        for _ in range(SHARD_K):
            carry = _sharded_blocked_pivot(carry, opts, stall, n_global,
                                           opts.max_iters, lay)
        return carry

    return run, lambda carry: _flush(carry, opts, lay), opts


# ---- the sharded pivot's kernels (shard_pivot, shard_vectors) ------------

def bits_equal(label: str, a, b) -> None:
    """Raise unless float tensors ``a`` and ``b`` hold the same bits (zero
    signs included; every NaN alike)."""
    import torch

    a, b = a.cpu().contiguous(), b.cpu().contiguous()
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{label}: {a.dtype} {tuple(a.shape)} against "
                             f"{b.dtype} {tuple(b.shape)}")
    ints = torch.int64 if a.dtype == torch.float64 else torch.int32
    na, nb = torch.isnan(a), torch.isnan(b)
    if not (torch.equal(na, nb) and torch.equal(
            torch.where(na, 0.0, a).view(ints),
            torch.where(nb, 0.0, b).view(ints))):
        bad = int(((a != b) & ~(na & nb)).sum()) + int((na != nb).sum())
        raise AssertionError(f"{label}: {bad} of {a.numel()} entries differ "
                             "from the plain version")


def _kept(x, copy: bool):
    """A recorded argument: itself, or a copy of a tensor with its strides
    (a lane axis of stride 0 materialised). The lane-sharded paths pass no
    flip."""
    import torch

    if not (copy and isinstance(x, torch.Tensor)):
        return x
    if 0 in x.stride():
        return x.clone()
    return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                               device=x.device).copy_(x)


class PivotRecorder:
    """The arguments of the ``shard_pivot`` launches made inside the block
    (``kernels.shard_pivot._launch``: the lanes, the block, its layout and
    the per-lane scalars): every ``every``-th call, and the last one when
    they are kept by reference (``copy`` False: the solo sharded drivers
    never write a step's inputs; the lane-sharded waves may, so theirs
    are copied)."""

    def __init__(self, copy: bool = False, every: int = 1):
        self.copy, self.every = copy, every
        self.calls, self.count, self.last = [], 0, None

    def __enter__(self):
        from tpulp_torch.kernels import shard_pivot as sp

        self.real = real = sp._launch

        def spy(*args):
            out = real(*args)
            if self.count % self.every == 0:
                self.calls.append((self.count, tuple(
                    _kept(a, self.copy) for a in args)))
            elif not self.copy:
                self.last = (self.count, args)
            self.count += 1
            return out

        sp._launch = spy
        return self

    def __exit__(self, *exc):
        from tpulp_torch.kernels import shard_pivot as sp

        sp._launch = self.real
        if self.last is not None and (not self.calls or
                                      self.last[0] > self.calls[-1][0]):
            self.calls.append(self.last)
        return False


def plain_pivot(args):
    """The plain version (on the card: the former path, FMA launches and
    ``torch.where`` passes) on a recorded launch's arguments: directly on
    one lane, as the solo drivers called it, vmapped over several, as the
    lane-sharded steps did. Returns (Tn, rhsn) with the lane axis."""
    import torch

    from tpulp_torch.kernels.shard_pivot import Flip, shard_pivot_reference

    T, rhs, u, rg, jeff, index, gate, flip, _ = args
    xs = [T, rhs, u, rg, jeff, gate] + (list(flip) if flip is not None
                                        else [])
    if T.shape[0] == 1:
        out = shard_pivot_reference(
            *(None if x is None else x[0] for x in xs[:5]), index,
            None if gate is None else gate[0],
            None if flip is None else Flip(*(x[0] for x in flip)))
        return out[0][None], out[1][None]

    def one(T, rhs, u, rg, j, g, *f):
        return shard_pivot_reference(T, rhs, u, rg, j, index, g,
                                     Flip(*f) if f else None)

    return torch.func.vmap(one, in_dims=tuple(
        None if x is None else 0 for x in xs))(*xs)


def kernel_pivot(args):
    """The kernel on a recorded launch's arguments: (Tn, rhsn) with the
    lane axis (views of the output frames where it writes frames)."""
    from tpulp_torch.kernels import shard_pivot as sp

    out = sp._launch(*args)
    return (out[..., :-1], out[..., -1]) if args[-1] else out


def pivot_held(args, label: str) -> None:
    """The kernel against its plain version on a recorded launch, bit for
    bit."""
    got, want = kernel_pivot(args), plain_pivot(args)
    for g, w, name in zip(got, want, ("block", "RHS")):
        bits_equal(f"shard_pivot {label} ({name})", g, w)


def pivot_bytes(args) -> int:
    """The bytes a launch must move: the block, the RHS and the pivot
    column read once (the flip's column too), the block and the RHS
    written once."""
    T, flip = args[0], args[7]
    L, R, N = T.shape
    cols = 2 * N + 3 + (flip is not None)
    return L * R * cols * T.element_size()


def host_us(fn, calls: int = 50) -> float:
    """Host microseconds a call of ``fn`` while the card sleeps (the
    enqueue alone)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda._sleep(4 * SLEEP_CYCLES)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * secs / calls


def pivot_timing(args, label: str, host_fn=None) -> dict:
    """Device ms a launch of the kernel and of the plain version (CUDA
    events after a sleep) in turns (plain, kernel, kernel, plain), the
    bound, and the host us a call of the kernel's wrapper (``host_fn``,
    else the launch) and of the plain version."""
    pivot_held(args, label)
    turns = {"kernel": [], "plain": []}
    for kind in ("plain", "kernel", "kernel", "plain"):
        fn = kernel_pivot if kind == "kernel" else plain_pivot
        turns[kind].append(device_time_ms(lambda: fn(args), RUNS))
    nbytes = pivot_bytes(args)
    bound_ms, bound_by = bound(nbytes, 2.0 * args[0].numel(),
                               FP64_FLOP_S if args[0].element_size() == 8
                               else FP32_FLOP_S)
    res = {"shape": list(args[0].shape), "frame": bool(args[-1]),
           "t_strides": list(args[0].stride()), "max_abs_err": 0.0,
           "ms": min(turns["kernel"]), "plain_ms": min(turns["plain"]),
           "device_ms_turns": turns["kernel"],
           "plain_device_ms_turns": turns["plain"], "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": None, "bytes": nbytes,
           "host_us": host_us(host_fn or (lambda: kernel_pivot(args))),
           "plain_host_us": host_us(lambda: plain_pivot(args), 10)}
    log(f"# shard_pivot {label} {tuple(args[0].shape)} (T strides "
        f"{tuple(args[0].stride())}{', frames' if args[-1] else ''}): bit "
        f"for bit the plain version; device ms a launch in turns, the "
        f"plain path {turns['plain'][0]:.4f}, kernel {turns['kernel'][0]:.4f}"
        f", {turns['kernel'][1]:.4f}, plain {turns['plain'][1]:.4f}; bound "
        f"{bound_ms:.4f} ms ({bound_by}, {nbytes} bytes); host us a call: "
        f"the wrapper {res['host_us']:.1f}, the plain version "
        f"{res['plain_host_us']:.1f}")
    return res


def as_float32(args):
    """A recorded launch's arguments (with no flip) with its floats in
    float32."""
    import torch

    return tuple(a.float() if isinstance(a, torch.Tensor)
                 and a.is_floating_point() else a for a in args)


class VectorRecorder:
    """The arguments of the rank-K sharded pivot's ``shard_vectors`` calls
    made inside the block (the first and the last), by reference."""

    def __enter__(self):
        import tpulp_torch.shard.sharded_blocked as sbk

        self.real = real = sbk.shard_vectors
        self.first = self.last = None

        def spy(*args):
            if self.first is None:
                self.first = args
            self.last = args
            return real(*args)

        sbk.shard_vectors = spy
        return self

    def __exit__(self, *exc):
        import tpulp_torch.shard.sharded_blocked as sbk

        sbk.shard_vectors = self.real
        return False


def vectors_timing(args, label: str) -> dict:
    """``shard_vectors`` against its plain version (three FMA launches) on
    the recorded arguments, bit for bit; device ms in turns, the bound and
    the host us a call."""
    from tpulp_torch.kernels.shard_pivot import (shard_vectors,
                                                 shard_vectors_reference)

    for g, w, name in zip(shard_vectors(*args),
                          shard_vectors_reference(*args),
                          ("row0", "row1", "bvec")):
        bits_equal(f"shard_vectors {label} ({name})", g, w)
    turns = {"kernel": [], "plain": []}
    for kind in ("plain", "kernel", "kernel", "plain"):
        fn = shard_vectors if kind == "kernel" else shard_vectors_reference
        turns[kind].append(device_time_ms(lambda: fn(*args), RUNS))
    row0, _, bvec = args[:3]
    n, M, es = row0.numel(), bvec.numel(), row0.element_size()
    nbytes = es * (2 * (2 * n + M) + n + M + 1)
    bound_ms, bound_by = bound(nbytes, 2.0 * (2 * n + M),
                               FP64_FLOP_S if es == 8 else FP32_FLOP_S)
    res = {"n_local": n, "M": M, "max_abs_err": 0.0,
           "ms": min(turns["kernel"]), "plain_ms": min(turns["plain"]),
           "device_ms_turns": turns["kernel"],
           "plain_device_ms_turns": turns["plain"], "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": None,
           "host_us": host_us(lambda: shard_vectors(*args)),
           "plain_host_us": host_us(lambda: shard_vectors_reference(*args))}
    log(f"# shard_vectors {label} (n_local {n}, M {M}): bit for bit the "
        f"plain version; device ms in turns, the plain path "
        f"{turns['plain'][0]:.4f}, kernel {turns['kernel'][0]:.4f}, "
        f"{turns['kernel'][1]:.4f}, plain {turns['plain'][1]:.4f}; bound "
        f"{bound_ms:.5f} ms ({bound_by}); host us a call {res['host_us']:.1f}"
        f" (the plain version {res['plain_host_us']:.1f})")
    return res


def bounded_kinds(rec: PivotRecorder) -> dict:
    """The recorded bounded steps by kind (one host read): {kind: first
    call index}, and the counts. Kinds: a pivot alone, a pivot with a
    leaving flip (an upper hit), an entering flip (the gate closed), an
    idle step (the gate closed, no flip)."""
    import torch

    flags = torch.stack([torch.stack([a[6][0], a[7].do_flip[0],
                                      a[7].enter[0]])
                         for _, a in rec.calls]).cpu().tolist()
    kinds = {}
    for k, (gate, do_flip, enter) in enumerate(flags):
        kind = ("pivot" if not do_flip else "leave_flip") if gate else (
            "enter_flip" if do_flip and enter else "idle")
        kinds.setdefault(kind, []).append(k)
    return kinds


def pivot_card_tests(dev) -> dict:
    """tests/test_torch_shard_pivot_card.py, the sharded pivot kernels'
    ``cuda`` tests (each against its plain version on the card and the
    CPU: 9b's block at f64 and f32, the bounded step's kinds at 9c's width
    with NaN and inf entries, the lane frames of 10a and 10b under vmap,
    9a's vectors), run in a process of their own; a failure, or a test
    that skips, fails the run."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda",
           "-q", "-p", "no:cacheprovider",
           "tests/test_torch_shard_pivot_card.py"]
    if dev != "cuda":
        return {"skipped": "no card"}
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                          timeout=600)
    secs = time.perf_counter() - t0
    tail = proc.stdout.strip().splitlines()[-1:] or [""]
    log(f"# 9 (t) {' '.join(cmd[2:])}: exit {proc.returncode}, {tail[0]} "
        f"({secs:.1f} s)")
    if proc.returncode != 0 or "skipped" in tail[0] or \
            "passed" not in tail[0]:
        raise AssertionError(f"9 (t): the sharded pivot's card tests: "
                             f"{proc.stdout[-4000:]}{proc.stderr[-2000:]}")
    return {"summary": tail[0], "seconds": secs}


def sharded_walk_window(sf, mesh, kind: str, steps: int):
    """Host ms and device ms a step (``torch.profiler``) of a window of
    ``steps`` steps of the sharded rank-1 (``kind`` "rank1", 9b's LP) or
    bounded (``"bounded"``, 9c's box LP) driver from its first basis, with
    the kernel and with the plain version in its place (the former
    path), in turns (kernel, plain, plain, kernel); kernels a step and
    launches by kind of the kernel's windows."""
    import torch

    import tpulp_torch.shard.sharded as shm
    import tpulp_torch.shard.sharded_bounded as sbm
    from tpulp_torch import SolverOptions
    from tpulp_torch.comm.collectives import MeshAxis
    from tpulp_torch.kernels import LAUNCHES, reset_launches
    from tpulp_torch.kernels.shard_pivot import shard_pivot_reference
    from tpulp_torch.shard import to_sharded_bounded_state, to_sharded_state
    from tpulp_torch.solve.api import state_from_standard_form
    from tpulp_torch.solve.bounded import make_bounded_state

    lay = MeshAxis(mesh)
    opts = SolverOptions.for_dtype(torch.float64)
    st = state_from_standard_form(sf, dtype=torch.float64, device="cuda")
    if kind == "rank1":
        mod, s0 = shm, to_sharded_state(st, mesh)
        m, n_local = st.m, s0.T.shape[1]
    else:
        mod = sbm
        s0 = to_sharded_bounded_state(make_bounded_state(st, sf.upper), mesh)
        m, n_local = st.m, s0.s.T.shape[1]
    stall = opts.resolved_stall_limit(m, n_local * lay.size)
    step = mod._sharded_step if kind == "rank1" else \
        mod._sharded_bounded_step

    def walk():
        s = s0
        for _ in range(steps):
            s = step(s, opts, stall, n_local * lay.size, lay)
        return s

    real = mod.shard_pivot
    out = {"kernel": [], "plain": []}
    walk()  # warm
    for turn in ("kernel", "plain", "plain", "kernel"):
        mod.shard_pivot = real if turn == "kernel" else shard_pivot_reference
        try:
            reset_launches()
            wall, busy, kernels = device_busy(walk)
        finally:
            mod.shard_pivot = real
        out[turn].append({"host_ms": 1e3 * wall / steps,
                          "device_ms": 1e3 * busy / steps,
                          "kernels": kernels / steps,
                          "launches": {k: v for k, v in LAUNCHES.items()
                                       if v}})
    best = {t: min(out[t], key=lambda r: r["host_ms"]) for t in out}
    log(f"# 9 sharded {kind} window, {steps} steps from the first basis "
        f"under torch.profiler, kernel / plain in turns: host ms a step "
        f"{[round(r['host_ms'], 4) for r in out['kernel']]} / "
        f"{[round(r['host_ms'], 4) for r in out['plain']]}, device ms a "
        f"step {[round(r['device_ms'], 5) for r in out['kernel']]} / "
        f"{[round(r['device_ms'], 5) for r in out['plain']]}, kernels a "
        f"step {best['kernel']['kernels']:.1f} / "
        f"{best['plain']['kernels']:.1f}; launches (kernel) "
        f"{best['kernel']['launches']}")
    if best["kernel"]["launches"].get("fused_fma", 0) or \
            best["kernel"]["launches"].get("shard_pivot") != steps:
        raise AssertionError(f"9 {kind} window: launches "
                             f"{best['kernel']['launches']}")
    return {"steps": steps, "turns": out}


def sharded_window(sf, mesh, dtype):
    """Host ms, device ms, kernels a pivot and the card's busy share of the
    sharded blocked driver's first block (SHARD_K pivots and the flush)
    under torch.profiler."""
    run, flush, _ = first_block(sf, mesh, dtype)
    flush(run())
    wall, busy, kernels = device_busy(lambda: flush(run()))
    return {"host_ms_per_pivot": 1e3 * wall / SHARD_K,
            "busy_share": busy / wall, "kernels_per_pivot": kernels / SHARD_K,
            "device_ms_per_pivot": 1e3 * busy / SHARD_K}


def mesh_main_path(mesh, sf, driver: str, objective: str, dev="cuda"):
    """9a / 9b: solve_lp(mesh=mesh, shard_driver=driver) on phase 5's LP:
    optimal, float_basis_certificate, the exact objective equal to phase
    5's; the launch and collective counts of that solve."""
    import torch

    import tpulp_torch
    from tpulp_torch.comm import COUNTS, reset_counts
    from tpulp_torch.kernels import LAUNCHES, reset_launches
    from tpulp_torch.solve.refine import float_basis_certificate

    sync(dev)
    # the sharded path's main run: counts set to 0 just before, read after
    reset_launches()
    reset_counts()
    t0 = time.perf_counter()
    sol = tpulp_torch.solve_lp(sf, device=dev, mesh=mesh,
                               shard_driver=driver, shard_block=SHARD_K)
    sync(dev)
    secs = time.perf_counter() - t0
    launches, counts = dict(LAUNCHES), dict(COUNTS)
    if sol.status != "optimal":
        raise AssertionError(f"mesh {driver}: status {sol.status}")
    primal_ok, dual_ok = float_basis_certificate(sf, sol.basis)
    if not (primal_ok and dual_ok):
        raise AssertionError(f"mesh {driver}: float_basis_certificate "
                             "failed")
    if str(sol.objective) != objective:
        raise AssertionError(f"mesh {driver}: objective {sol.objective} is "
                             f"not phase 5's {objective}")
    fetch = "psum:float64x" + str(
        (sf.m + 2) + (SHARD_K + 1 if driver == "blocked" else 0))
    steps = sum(c for (k, d, e), c in counts.items()
                if f"{k}:{d}x{e}" == fetch)
    if dev == "cuda" and driver == "blocked" and launches["fused_flush"] == 0:
        raise AssertionError(f"mesh blocked: fused_flush never launched "
                             f"({launches})")
    # the rank-1 driver pivots with shard_pivot, the rank-K driver keeps
    # its running vectors with shard_vectors: one launch a step each, and
    # no FMA launch
    kernel = "shard_vectors" if driver == "blocked" else "shard_pivot"
    if dev == "cuda" and (launches[kernel] == 0
                          or (driver == "rank1"
                              and launches["fused_fma"] != 0)):
        raise AssertionError(f"mesh {driver}: launches {launches}")
    per_step = collectives_per_step(counts, steps)
    log(f"# 9{'a' if driver == 'blocked' else 'b'} solve_lp(mesh, "
        f"shard_driver={driver!r}) {sf.m}x{sf.n} f64 at P = 1 (NCCL): "
        f"optimal, certified, objective = phase 5's exactly; {sol.niter} "
        f"pivots in {steps} steps, {secs:.2f} s ({1e3 * secs / sol.niter:.3f}"
        f" ms a pivot, set-up and refinement included); launches "
        f"{launches}; collectives a step {per_step}")
    return {"niter": sol.niter, "steps": steps, "seconds": secs,
            "launches": launches, "collectives_per_step": per_step,
            "rung": sol.rung}


def sharded_flip_spy():
    """Wraps the sharded bounded step to count on the card, without a host
    read, its entering flips (a step that adds a pivot but keeps the
    basis) and its upper hits (a basis change that flips a column).
    Returns (counts, restore): ``counts()`` reads the two totals."""
    import torch

    import tpulp_torch.shard.sharded_bounded as sb

    real = sb._sharded_bounded_step
    total = []

    def spy(c, *args, **kw):
        nxt = real(c, *args, **kw)
        same = (nxt.s.basis == c.s.basis).all()
        flip = (nxt.at_upper != c.at_upper).any()
        step = torch.stack([(nxt.s.niter > c.s.niter) & same, ~same & flip])
        total[:] = [step.int() + total[0] if total else step.int()]
        return nxt

    def restore():
        sb._sharded_bounded_step = real

    sb._sharded_bounded_step = spy
    return (lambda: total[0].tolist() if total else [0, 0]), restore


def record_flips():
    """The solo walk's (counts, restore), as ``sharded_flip_spy`` gives
    them, from the bounded kernels' record counters (``FLIPS``)."""
    from tpulp_torch.kernels.bounded import FLIPS

    before = dict(FLIPS)
    return (lambda: [FLIPS[k] - before[k] for k in FLIPS]), (lambda: None)


def mesh_bounded(mesh, dev="cuda"):
    """9c: the sharded bounded driver (Dantzig) on phase 8a's box LP at
    SHARD_BOX_M x SHARD_BOX_N, f64, against the solo bounded driver's walk
    on the card (one ``bounded_grid`` launch: the frame is within the
    grid's plan): steps, flips, at-upper flags and basis equal, objectives
    within 1e-9. The drivers run bare (at m <= 192 solve_lp's exact
    refinement and certificate of this float data take ~30 s a solve on
    the host)."""
    import torch

    from tpulp_torch import SolverOptions
    from tpulp_torch.kernels import LAUNCHES, reset_launches
    from tpulp_torch.kernels.shard_pivot import Flip
    from tpulp_torch.shard import (from_sharded_bounded_state,
                                   run_simplex_sharded_bounded,
                                   to_sharded_bounded_state)
    from tpulp_torch.solve.api import state_from_standard_form
    from tpulp_torch.solve.bounded import (make_bounded_state,
                                           run_simplex_bounded)

    sf = bounded_form(SHARD_BOX_M, SHARD_BOX_N)[0]
    opts = SolverOptions.for_dtype(torch.float64)
    res = {}
    # every shard_pivot launch of the mesh walk, by reference (the driver
    # never writes a step's inputs)
    rec = PivotRecorder()
    for kind in ("solo", "mesh"):
        bs = make_bounded_state(state_from_standard_form(
            sf, dtype=torch.float64, device=dev), sf.upper)
        counts, restore = (record_flips if kind == "solo"
                           else sharded_flip_spy)()
        sync(dev)
        reset_launches()
        t0 = time.perf_counter()
        try:
            if kind == "solo":
                out = run_simplex_bounded(bs, opts)
            else:
                with rec:
                    out = from_sharded_bounded_state(
                        run_simplex_sharded_bounded(
                            to_sharded_bounded_state(bs, mesh), mesh, opts),
                        bs.s.n, mesh)
            sync(dev)
        finally:
            restore()
        secs = time.perf_counter() - t0
        res[kind] = {"status": int(out.s.status), "niter": int(out.s.niter),
                     "flips": counts(), "seconds": secs,
                     "launches": dict(LAUNCHES),
                     "basis": out.s.basis.tolist(),
                     "at_upper": out.at_upper.tolist(),
                     "objective": float(out.s.objective())}
    solo, msh = res["solo"], res["mesh"]
    rel = abs(solo["objective"] - msh["objective"]) / max(
        1.0, abs(solo["objective"]))
    same = all(solo[k] == msh[k] for k in ("status", "niter", "flips",
                                           "basis", "at_upper"))
    log(f"# 9c sharded bounded driver (Dantzig) {SHARD_BOX_M}x{SHARD_BOX_N} "
        f"f64: status {msh['status']}, {msh['niter']} steps (entering "
        f"flips, upper hits) {msh['flips']}, {msh['seconds']:.2f} s against "
        f"the solo walk's {solo['niter']} steps {solo['flips']} in "
        f"{solo['seconds']:.2f} s; basis and at_upper "
        f"{'equal' if same else 'DIFFER'}; objective relative difference "
        f"{rel:.2e}; launches {msh['launches']}")
    if not (same and msh["status"] == 1 and rel <= 1e-9
            and (dev != "cuda" or (msh["launches"]["fused_fma"] == 0
                                   and msh["launches"]["shard_pivot"]
                                   == rec.count > 0
                                   and solo["launches"]["bounded_grid"]
                                   == 1))):
        raise AssertionError("9c: the sharded bounded walk differs from the "
                             "solo walk")
    for r in res.values():
        del r["basis"], r["at_upper"]
    res["relative_difference"] = rel
    msh["steps"] = rec.count
    if dev == "cuda":
        # shard_pivot against its plain version on the walk's own steps: the
        # first and the last, and the first of each kind (a pivot alone, an
        # upper hit's leaving flip, an entering flip with the gate closed,
        # an idle step); one bounded step with a flip timed in turns
        kinds = bounded_kinds(rec)
        missing = {"pivot", "leave_flip", "idle"} - set(kinds)
        if missing:
            raise AssertionError(f"9c: no step of the kinds {missing}")
        held = sorted({0, len(rec.calls) - 1}
                      | {ks[0] for ks in kinds.values()})
        for k in held:
            pivot_held(rec.calls[k][1], f"9c step {rec.calls[k][0]}")
        # Dantzig's walk here takes no entering flip: hold one on its
        # first pivot's block (the gate closed, the entering column
        # flipped across a span of 1.5)
        T, rhs, u, rg, j, index, gate, _, frame = \
            rec.calls[kinds["pivot"][0]][1]
        enter = Flip(torch.ones_like(gate), torch.ones_like(gate),
                     j.clone(), torch.full_like(u[:, 0], 1.5), u)
        pivot_held((T, rhs, u, rg, j, index, torch.zeros_like(gate), enter,
                    frame), "9c an entering flip on the walk's block")
        res["shard_pivot"] = {
            "steps_by_kind": {k: len(v) for k, v in kinds.items()},
            "held_steps": [rec.calls[k][0] for k in held],
            "leave_flip": pivot_timing(
                rec.calls[kinds["leave_flip"][0]][1], "9c leaving flip")}
        log(f"# 9c shard_pivot: {rec.count} launches, steps by kind "
            f"{res['shard_pivot']['steps_by_kind']}; steps "
            f"{res['shard_pivot']['held_steps']} held bit for bit")
    return res


def machinery_ratio(mesh, dev="cuda"):
    """9d: the sharded blocked driver at P = 1 against the solo eager
    blocked driver (``run_simplex_blocked_reference``: the same eager pivot
    and matrix-product flush, so like is compared with like), per pivot: on
    tools/torch_scaling_overhead.py's instance, and on the bench shape (f32,
    K = 256, SHARD_BENCH_PIVOTS); the solo blocked kernels
    (``run_simplex_blocked`` on the card) beside them."""
    import importlib.util
    import os

    import torch

    from tpulp_torch import SolverOptions, make_state
    from tpulp_torch.shard import run_simplex_sharded_blocked, to_sharded_state
    from tpulp_torch.solve import blocked as solo

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                        "torch_scaling_overhead.py")
    spec = importlib.util.spec_from_file_location("torch_scaling_overhead",
                                                  path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    # the tool times solve.blocked.run_simplex_blocked as its solo driver:
    # the eager loop here, the kernels after
    kernels = solo.run_simplex_blocked
    solo.run_simplex_blocked = solo.run_simplex_blocked_reference
    try:
        small = tool.measure(dev)
    finally:
        solo.run_simplex_blocked = kernels
    st_small = tool.build_state(dev)
    o_small = SolverOptions.for_dtype(torch.float32,
                                      max_iters=small["pivots"])
    small["kernel_us"], _ = tool._time_best(
        lambda: solo.run_simplex_blocked(st_small, o_small, block=16),
        small["pivots"], 5, "solo kernels", dev)
    log(f"# 9d machinery at P = 1, {tool.__name__}'s 66x513 f32 K=16: solo "
        f"eager {small['solo_us']:.1f} us a pivot, sharded "
        f"{small['p1_us']:.1f}, ratio {small['ratio']:.3f} "
        f"({small['pivots']} pivots); the solo blocked kernels "
        f"{small['kernel_us']:.1f}")
    c, A, b, hint = bench_arrays(BENCH_M, BENCH_N)
    st = make_state(c, A, b, hint, dtype=torch.float32, device=dev)
    opts = SolverOptions.for_dtype(torch.float32,
                                   max_iters=SHARD_BENCH_PIVOTS)
    sh = to_sharded_state(st, mesh)
    solo_us, n1 = tool._time_best(
        lambda: solo.run_simplex_blocked_reference(st, opts, block=BENCH_K),
        SHARD_BENCH_PIVOTS, 2, "solo bench", dev)
    p1_us, n2 = tool._time_best(
        lambda: run_simplex_sharded_blocked(sh, mesh, opts, block=BENCH_K),
        SHARD_BENCH_PIVOTS, 2, "P=1 bench", dev)
    kernel_us, n3 = tool._time_best(
        lambda: solo.run_simplex_blocked(st, opts, block=BENCH_K),
        SHARD_BENCH_PIVOTS, 2, "solo kernels bench", dev)
    if not n1 == n2 == n3:
        raise AssertionError(f"9d: solo {n1}, sharded {n2} and kernel {n3} "
                             "pivots")
    log(f"# 9d machinery at P = 1, bench shape {BENCH_M}x{BENCH_M + BENCH_N}"
        f" f32 K={BENCH_K}, {n1} pivots: solo eager {solo_us:.1f} us a "
        f"pivot, sharded {p1_us:.1f}, ratio {p1_us / solo_us:.3f}; the solo "
        f"blocked kernels {kernel_us:.1f}")
    return {"scaling_overhead_instance": small,
            "bench": {"solo_us": solo_us, "p1_us": p1_us,
                      "ratio": p1_us / solo_us, "pivots": n1,
                      "kernel_us": kernel_us}}


def sharded_pivot_checks(sf, mesh, prec, vrec, dev="cuda") -> dict:
    """9b and 9a on the new kernels: ``shard_pivot`` held bit for bit
    against its plain version on 9b's recorded steps (the first, every
    SHARD_KEEP-th and the last, the idle step's no-op pivot on (row 2,
    ``basis[0]``)), and its first step timed at f64 and f32 in turns with
    the plain version (the former path); ``shard_vectors`` on 9a's first
    and last pivots, timed likewise; the sharded rank-1 and bounded walks'
    windows under torch.profiler; the kernels' card tests."""
    import torch

    from tpulp_torch.kernels.shard_pivot import (shard_pivot, shard_vectors,
                                                 shard_vectors_reference)

    res = {"card_tests": pivot_card_tests(dev)}
    if dev != "cuda":
        return res
    for count, args in prec.calls:
        pivot_held(args, f"9b step {count}")
    # the walk's last step is the idle step that finds the optimum: the
    # no-op pivot on (row 2, basis[0]), which leaves every value
    last = prec.calls[-1][1]
    Tn, rhsn = kernel_pivot(last)
    noop = int(last[3][0]) == 2 and bool(
        torch.equal(Tn + 0.0, last[0] + 0.0)
        and torch.equal(rhsn + 0.0, last[1] + 0.0))
    if not noop:
        raise AssertionError("9b: the walk's last step is not the no-op "
                             "pivot on (row 2, basis[0])")
    first = prec.calls[0][1]

    def wrapper(args):
        # the drivers' call: the public wrapper on one lane
        T, rhs, u, rg, j = (x[0] for x in args[:5])
        return lambda: shard_pivot(T, rhs, u, rg, j, args[5])

    res["9b_float64"] = pivot_timing(first, "9b float64", wrapper(first))
    f32 = as_float32(first)
    res["9b_float32"] = pivot_timing(f32, "9b float32", wrapper(f32))
    res["9b_steps"] = prec.count
    res["9b_held_steps"] = [c for c, _ in prec.calls]
    res["9a_vectors_float64"] = vectors_timing(vrec.first, "9a first pivot")
    for g, w in zip(shard_vectors(*vrec.last),
                    shard_vectors_reference(*vrec.last)):
        bits_equal("shard_vectors 9a last pivot", g, w)
    res["windows"] = {
        "rank1": sharded_walk_window(sf, mesh, "rank1", SHARD_WINDOW),
        "bounded": sharded_walk_window(
            bounded_form(SHARD_BOX_M, SHARD_BOX_N)[0], mesh, "bounded",
            SHARD_WINDOW)}
    return res


def phase_mesh(objective: str, dev="cuda"):
    """Phase 9: a one-process NCCL group, ``make_mesh(1)``, and 9a-9e:
    solve_lp(mesh) blocked and rank-1 on phase 5's LP, the sharded bounded
    driver on a cut box LP, the machinery ratio, and the flush at the
    sharded path's per-rank block. Returns the numbers; the group is
    destroyed at the end."""
    import os
    import socket

    import torch
    import torch.distributed as dist

    from tpulp_torch.comm import init_distributed
    from tpulp_torch.shard import make_mesh

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    init_distributed(f"127.0.0.1:{port}", 1, 0, device=dev)
    try:
        mesh = make_mesh(1, device=dev)
        log(f"# phase 9: one-process NCCL group and make_mesh(1) in "
            f"{time.perf_counter() - t0:.2f} s: {mesh}")
        sf = main_path_form(MAIN_M, MAIN_N)
        with VectorRecorder() as vrec:
            res = {"blocked": mesh_main_path(mesh, sf, "blocked", objective,
                                             dev)}
        window = sharded_window(sf, mesh, torch.float64)
        res["blocked"]["window"] = window
        log(f"# 9a first block under torch.profiler: "
            f"{window['host_ms_per_pivot']:.3f} ms of host time, "
            f"{window['device_ms_per_pivot']:.4f} ms of device time and "
            f"{window['kernels_per_pivot']:.0f} kernels a pivot; the card "
            f"{100 * window['busy_share']:.1f}% busy")
        # 9b's shard_pivot launches: every SHARD_KEEP-th and the last, by
        # reference (the driver never writes a step's inputs)
        with PivotRecorder(every=SHARD_KEEP) as prec:
            res["rank1"] = mesh_main_path(mesh, sf, "rank1", objective, dev)
        res["bounded"] = mesh_bounded(mesh, dev)
        res["shard_pivot"] = sharded_pivot_checks(sf, mesh, prec, vrec, dev)
        res["ratio"] = machinery_ratio(mesh, dev)
        # 9e: the flush at 9a's per-rank block, on its first block's etas
        run, _, opts = first_block(sf, mesh, torch.float64)
        carry = run()
        res["flush"] = check_flush(
            carry.s.T, carry.U, carry.Vl, carry.s.col_active.to(torch.int32),
            opts.opt_tol, opts.piv_tol, "float64", RUNS)
    finally:
        dist.destroy_process_group()
    return res


# ---------------------------------------------------------------------------
# phase 10: the batch half of multi-device solving
# ---------------------------------------------------------------------------

def mesh_axes(mesh) -> dict:
    names = tuple(mesh.mesh_dim_names)
    return {"batch_axis": "batch", "cols_axis": "cols"} if "cols" in names \
        else {"batch_axis": "batch"}


class PivotFma:
    """The FMA launches made inside the lane-sharded walks
    (``sharded_batch.run_simplex_batch_sharded`` and
    ``run_dual_batch_sharded``, the pivots' loops) while the block runs:
    ``fma`` (the waves' RHS rewrite runs outside them)."""

    def __enter__(self):
        import tpulp_torch.shard.sharded_batch as sbt
        from tpulp_torch.kernels import LAUNCHES

        self.real = {k: getattr(sbt, k) for k in (
            "run_simplex_batch_sharded", "run_dual_batch_sharded")}
        self.fma = 0

        def wrap(fn):
            def spy(*args, **kw):
                before = LAUNCHES["fused_fma"]
                try:
                    return fn(*args, **kw)
                finally:
                    self.fma += LAUNCHES["fused_fma"] - before
            return spy

        for k, fn in self.real.items():
            setattr(sbt, k, wrap(fn))
        return self

    def __exit__(self, *exc):
        import tpulp_torch.shard.sharded_batch as sbt

        for k, fn in self.real.items():
            setattr(sbt, k, fn)
        return False


def lane_pivot_checks(rec, label: str) -> dict:
    """``shard_pivot`` on a lane-sharded path's recorded launches (copies
    taken in the run): each held bit for bit against the plain version
    vmapped over the lanes (the former path), the first timed in turns
    with it."""
    for count, args in rec.calls:
        pivot_held(args, f"{label} launch {count}")
    res = pivot_timing(rec.calls[0][1], label)
    res["held_launches"] = [c for c, _ in rec.calls]
    res["launches"] = rec.count
    return res


def mesh_lp_batch(mesh, label: str, scens, solo, t_solo: float,
                  dev="cuda"):
    """10a: ``solve_lp_batch(mesh=)`` over phase 7c's scenarios, f64:
    statuses, pivots and exact objectives equal lane for lane to the solo
    batch's (``solo``, which took ``t_solo`` s); the collectives a step and
    the wall time."""
    import tpulp_torch
    from tpulp_torch.comm import COUNTS, reset_counts
    from tpulp_torch.kernels import LAUNCHES, reset_launches

    # this path's main run: counts set to 0 just before, read after; the
    # shard_pivot launches copied every SHARD_LANE_KEEP-th
    reset_launches()
    reset_counts()
    rec = PivotRecorder(copy=True, every=SHARD_LANE_KEEP)
    with FmaLayouts() as lay, PivotFma() as pfma, rec:
        t0 = time.perf_counter()
        out = tpulp_torch.solve_lp_batch(scens, mesh=mesh, device=dev,
                                         **mesh_axes(mesh))
        sync(dev)
        secs = time.perf_counter() - t0
    launches, counts = dict(LAUNCHES), dict(COUNTS)
    held = fma_layouts_held(dev, lay.plans)
    bad = [k for k, (a, b) in enumerate(zip(out, solo))
           if (a.status, a.niter, a.objective) != (b.status, b.niter,
                                                   b.objective)]
    if bad or any(s.status != "optimal" for s in out):
        raise AssertionError(f"10a {label}: lanes {bad} differ from the "
                             "solo batch")
    # the (1, 1) mesh's lane-sharded steps pivot with shard_pivot, one
    # launch a step for every lane and no FMA; the ("batch",) mesh's whole
    # lanes run the lane kernel
    need = "shard_pivot" if label == "1x1" else "lane_primal"
    if dev == "cuda" and (launches[need] == 0 or pfma.fma
                          or (label == "1x1" and launches["fused_fma"])):
        raise AssertionError(f"10a {label}: launches {launches}, FMA "
                             f"launches in the pivots {pfma.fma}")
    # a lane-sharded primal step makes one (m,) int32 psum for every lane
    steps = counts.get(("psum", "int32", SCEN_LANES * SCEN_M), 0)
    per_step = collectives_per_step(counts, steps) if steps else counts
    log(f"# 10a solve_lp_batch(mesh {label}) {SCEN_LANES} scenarios of "
        f"{SCEN_M}x{SCEN_N} f64: statuses, pivots and exact objectives "
        f"equal to the solo batch's lane for lane; {secs:.2f} s (solo "
        f"{t_solo:.2f} s), {steps} lane-sharded steps; collectives "
        f"{'a step ' if steps else ''}{per_step}; launches {launches}; "
        f"the FMA's {held} operand layouts bit for bit the CPU's addcmul")
    pivots = lane_pivot_checks(rec, f"10a {label}") \
        if dev == "cuda" and rec.calls else None
    return {"seconds": secs, "solo_seconds": t_solo, "steps": steps,
            "fma_layouts": held, "fma_in_pivots": pfma.fma,
            "shard_pivot": pivots,
            "collectives": {f"{k}:{d}x{e}": c
                            for (k, d, e), c in counts.items()},
            "launches": launches}


def mesh_milp(mesh, label: str, solo: dict, dev="cuda"):
    """10b: ``solve_milp(mesh=)`` on the bench knapsack, f64, default
    chaining, an untimed solve then a timed one: the DP oracle and every
    ``BnbStats`` counter of phase 7's solo f64 solve."""
    import torch

    import tpulp_torch
    from tpulp_torch.comm import COUNTS, reset_counts
    from tpulp_torch.kernels import LAUNCHES, reset_launches

    values, weights, cap = bench_knapsack()
    oracle = dp_knapsack(values, weights, cap)
    lp = knapsack_lp(values, [weights], [cap])
    kw = dict(dtype=torch.float64, batch_size=MILP_BATCH, mesh=mesh,
              device=dev, **mesh_axes(mesh))
    # the untimed solve: its shard_pivot launches copied every
    # SHARD_LANE_KEEP-th
    rec = PivotRecorder(copy=True, every=SHARD_LANE_KEEP)
    with rec:
        tpulp_torch.solve_milp(lp, **kw)
    sync(dev)
    reset_launches()
    reset_counts()
    with FmaLayouts() as lay, PivotFma() as pfma:
        t0 = time.perf_counter()
        sol, st = tpulp_torch.solve_milp(lp, return_stats=True, **kw)
        sync(dev)
        secs = time.perf_counter() - t0
    launches, counts = dict(LAUNCHES), dict(COUNTS)
    held = fma_layouts_held(dev, lay.plans)
    if not (sol.status == "optimal" and sol.objective == oracle):
        raise AssertionError(f"10b {label}: {sol.status} {sol.objective}, "
                             f"DP oracle {oracle}")
    if bnb_counters(st) != solo["counters"]:
        raise AssertionError(f"10b {label}: BnbStats {bnb_counters(st)} "
                             f"differ from the solo solve's "
                             f"{solo['counters']}")
    if st.gen_waves == 0:
        raise AssertionError(f"10b {label}: no device generation ran")
    needs = ("shard_pivot",) if label == "1x1" else ("lane_dual",
                                                     "lane_primal")
    if dev == "cuda" and (not all(launches[k] for k in needs) or pfma.fma):
        raise AssertionError(f"10b {label}: {needs} not all launched, or "
                             f"{pfma.fma} FMA launches in the pivots")
    log(f"# 10b solve_milp(mesh {label}) bench knapsack f64: optimal "
        f"{sol.objective} = DP oracle, every BnbStats counter phase 7's; "
        + milp_stats_line(st, secs)
        + f" (phase 7 solo {solo['nodes_per_s']:.1f} nodes/s); "
        f"{sum(counts.values())} collectives; launches {launches}; the "
        f"FMA's {held} operand layouts bit for bit the CPU's addcmul")
    pivots = lane_pivot_checks(rec, f"10b {label}") \
        if dev == "cuda" and rec.calls else None
    return {"seconds": secs, "nodes": st.nodes_solved, "fma_layouts": held,
            "fma_in_pivots": pfma.fma, "shard_pivot": pivots,
            "nodes_per_s": st.nodes_solved / secs,
            "solo_nodes_per_s": solo["nodes_per_s"],
            "gen_waves": st.gen_waves, "collectives": sum(counts.values()),
            "launches": launches}


def spans_knapsack(dev="cuda"):
    """10c: ``solve_milp(node_encoding="spans")`` on the bench knapsack,
    f64: the DP oracle; nodes and nodes/s. Each cold wave's walk is one
    ``lane_bounded`` launch and no FMA launch (the FMA's span layouts stay
    held by phase 3d's ``spans_*_10c`` cases); the waves' walks are timed
    (host clock, each ending in a synchronisation) beside the solve."""
    import torch

    import tpulp_torch
    from tpulp_torch.kernels import LAUNCHES, reset_launches
    from tpulp_torch.solve import bounded

    dev = torch.device(dev).type
    values, weights, cap = bench_knapsack()
    oracle = dp_knapsack(values, weights, cap)
    walks = []
    # milp.spans imports the batch driver at each solve
    run = bounded.run_simplex_bounded_batch

    def timed_walk(bs, opts=None):
        t0 = time.perf_counter()
        out = run(bs, opts)
        sync(dev)
        walks.append(time.perf_counter() - t0)
        return out

    reset_launches()
    bounded.run_simplex_bounded_batch = timed_walk
    try:
        t0 = time.perf_counter()
        sol, st = tpulp_torch.solve_milp(
            knapsack_lp(values, [weights], [cap]), dtype=torch.float64,
            batch_size=MILP_BATCH, node_encoding="spans", return_stats=True,
            device=dev)
        sync(dev)
        secs = time.perf_counter() - t0
    finally:
        bounded.run_simplex_bounded_batch = run
    launches = dict(LAUNCHES)
    if not (sol.status == "optimal" and sol.objective == oracle):
        raise AssertionError(f"10c spans: {sol.status} {sol.objective}, "
                             f"DP oracle {oracle}")
    if len(walks) != st.waves:
        raise AssertionError(f"10c spans: {len(walks)} walks timed for "
                             f"{st.waves} waves")
    if dev == "cuda" and (launches["lane_bounded"] != st.waves
                          or launches["fused_fma"] != 0):
        raise AssertionError(f"10c spans: lane_bounded launched "
                             f"{launches['lane_bounded']} times for "
                             f"{st.waves} waves, fused_fma "
                             f"{launches['fused_fma']} times")
    walk_s = sum(walks)
    log(f"# 10c solve_milp(node_encoding='spans') bench knapsack f64: "
        f"optimal {sol.objective} = DP oracle; {st.nodes_solved} nodes in "
        f"{st.waves} cold waves, {secs:.2f} s = "
        f"{st.nodes_solved / secs:.1f} nodes/s; the waves' walks "
        f"{walk_s:.4f} s ({1e3 * walk_s / st.waves:.3f} ms a wave, "
        f"{100 * walk_s / secs:.1f}% of the solve); launches {launches}")
    return {"seconds": secs, "nodes": st.nodes_solved, "waves": st.waves,
            "walk_seconds": walk_s, "walk_seconds_by_wave": walks,
            "nodes_per_s": st.nodes_solved / secs, "launches": launches}


def phase_batch_mesh(milp_solo: dict, dev="cuda"):
    """Phase 10: a one-process NCCL group, a (batch, cols) mesh of shape
    (1, 1) and a 1-D ("batch",) mesh; 10a-10d. The group is destroyed at
    the end."""
    import os
    import socket

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import tpulp_torch
    from tpulp_torch.comm import init_distributed
    from tpulp_torch.entry import dryrun_multichip

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    init_distributed(f"127.0.0.1:{port}", 1, 0, device=dev)
    res = {}
    try:
        meshes = {"1x1": init_device_mesh(dev, (1, 1),
                                          mesh_dim_names=("batch", "cols")),
                  "batch": init_device_mesh(dev, (1,),
                                            mesh_dim_names=("batch",))}
        scens, _ = scenario_batch()
        sync(dev)
        t0 = time.perf_counter()
        solo = tpulp_torch.solve_lp_batch(scens, device=dev)
        sync(dev)
        t_solo = time.perf_counter() - t0
        if dev == "cuda":
            # a mesh of another device type than the state's raises
            try:
                tpulp_torch.solve_lp_batch(scens[:2], mesh=meshes["1x1"],
                                           device="cpu")
            except ValueError:
                pass
            else:
                raise AssertionError("a cuda mesh with device='cpu' did "
                                     "not raise")
        for label, mesh in meshes.items():
            t0 = time.perf_counter()
            res[f"lp_batch_{label}"] = mesh_lp_batch(mesh, label, scens,
                                                     solo, t_solo, dev)
            res[f"milp_{label}"] = mesh_milp(mesh, label, milp_solo, dev)
            log(f"# 10a+10b on mesh {label}: "
                f"{time.perf_counter() - t0:.1f} s")
        res["spans"] = spans_knapsack(dev)
        t0 = time.perf_counter()
        dryrun_multichip(1, device=dev)
        res["dryrun_seconds"] = time.perf_counter() - t0
        log(f"# 10d dryrun_multichip(1) in process: "
            f"{res['dryrun_seconds']:.2f} s")
    finally:
        dist.destroy_process_group()
    return res


def main() -> int:
    import contextlib
    import io

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs one CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from tpulp_torch.kernels.build import build, load_library

    dev = torch.device("cuda")

    # 1: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"# torch {torch.__version__}, CUDA {torch.version.cuda}, device "
        f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    # 2: build (with nvcc's register, shared-memory and spill report)
    t0 = time.perf_counter()
    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        lib_path = build(verbose=True)
    load_library()
    log(report.getvalue().rstrip())
    ptxas = ptxas_report(report.getvalue())
    log(f"# build: {time.perf_counter() - t0:.1f} s (nvcc, sm_90a); "
        f"registers / spills: {ptxas}")
    sass = check_machine_code(lib_path)
    check_static_smem(ptxas)
    from tpulp_torch.kernels.rank1_cluster import CLUSTER_THREADS
    log(f"# rank1_cluster (ptxas -v, {CLUSTER_THREADS} threads a block): "
        + "; ".join(f"{k} {v.get('registers')} registers, "
                    f"{v.get('spill_bytes')} bytes of spills, "
                    f"{v.get('static_smem')} bytes of static shared memory"
                    for k, v in ptxas.items()
                    if k.startswith("cluster_kernel")))
    log("# shard_pivot, shard_vectors (ptxas -v): " + "; ".join(
        f"{k} {v.get('registers')} registers, {v.get('spill_bytes')} bytes "
        f"of spills" for k, v in ptxas.items() if k.startswith("shard_")))
    log("# lane_primal (ptxas -v): " + "; ".join(
        f"{k} {v.get('registers')} registers, {v.get('spill_bytes')} bytes "
        f"of spills, {v.get('static_smem')} bytes of static shared memory"
        for k, v in ptxas.items() if k.startswith("lane_primal")))
    log("# lane_bounded (ptxas -v): " + "; ".join(
        f"{k} {v.get('registers')} registers, {v.get('spill_bytes')} bytes "
        f"of spills, {v.get('static_smem')} bytes of static shared memory"
        for k, v in ptxas.items() if k.startswith("lane_bounded")))
    from tpulp_torch.kernels.blocked_cluster import BLOCKED_CLUSTER_THREADS
    log(f"# blocked_cluster (ptxas -v, {BLOCKED_CLUSTER_THREADS} threads a "
        "block): " + "; ".join(
            f"{k} {v.get('registers')} registers, {v.get('spill_bytes')} "
            f"bytes of spills, {v.get('static_smem')} bytes of static shared"
            " memory" for k, v in ptxas.items()
            if k in BLOCKED_CLUSTER_KERNELS.values()))
    from tpulp_torch.kernels.bounded_grid import GRID_THREADS
    log(f"# bounded_grid (ptxas -v, {GRID_THREADS} threads a block): "
        + "; ".join(f"{k} {v.get('registers')} registers, "
                    f"{v.get('spill_bytes')} bytes of spills, "
                    f"{v.get('static_smem')} bytes of static shared memory"
                    for k, v in ptxas.items()
                    if k in BOUNDED_GRID_KERNELS.values()))
    log(f"# rank1_grid (ptxas -v, {GRID_THREADS} threads a block): "
        + "; ".join(f"{k} {v.get('registers')} registers, "
                    f"{v.get('spill_bytes')} bytes of spills, "
                    f"{v.get('static_smem')} bytes of static shared memory"
                    for k, v in ptxas.items()
                    if k in RANK1_GRID_KERNELS.values()))
    log(f"# blocked_grid (ptxas -v, {GRID_THREADS} threads a block): "
        + "; ".join(f"{k} {v.get('registers')} registers, "
                    f"{v.get('spill_bytes')} bytes of spills, "
                    f"{v.get('static_smem')} bytes of static shared memory"
                    for k, v in ptxas.items()
                    if k in BLOCKED_GRID_KERNELS.values()))

    # 3: the kernels against their plain versions
    kstats = phase_kernels(dev)
    probe = phase_barrier_probe()
    fma_cases = phase_fma(dev)
    flush_cases = phase_flush_cases(dev)
    phase_small_lps()
    # 5: the LP main path; its launch counts are read right after it
    launches, main_path = phase_main_path()
    tf32 = phase_tf32_guard()
    # 5c: the solo walks on their kernels; each solve reads its own launch
    # counts, (a)'s f64 solve is the rank-1 step's main path
    t0 = time.perf_counter()
    solo = phase_solo_walks(main_path["pivots_per_s"])
    log(f"# phase 5c (solo walks): {time.perf_counter() - t0:.1f} s; kernel "
        f"launches of (a)'s f64 solve {solo['launches']}")
    # 5d: the blocked engine on its kernels; each solve reads its own
    # launch counts, (a)'s f64 solve is the blocked engine's main path
    t0 = time.perf_counter()
    blocked = phase_blocked_engine()
    log(f"# phase 5d (blocked engine): {time.perf_counter() - t0:.1f} s; "
        f"kernel launches of (a)'s f64 solve {blocked['launches']}")
    bench = phase_bench(dev)

    # 7: MILP, the batched waves and warm starts (the batched pivots run
    # the FMA kernel); the f64 bench knapsack's timed solve is the MILP
    # main path, its launch counts read right after it
    secs = {}
    t0 = time.perf_counter()
    milp = phase_milp_knapsacks()
    phase_drop_scatters()
    secs["milp"] = time.perf_counter() - t0
    lane_cases = phase_lane_kernels()
    secs["lanes"] = time.perf_counter() - t0 - sum(secs.values())
    milp["batched_pivot"] = batched_pivot_ms(lane_cases)
    secs["pivot"] = time.perf_counter() - t0 - sum(secs.values())
    milp.update(phase_batch_and_warm())
    secs["batch+warm"] = time.perf_counter() - t0 - sum(secs.values())
    milp_launches = milp["bench_knapsack_float64"]["launches"]
    log(f"# phase 7 (MILP, batch, warm): "
        + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items())
        + f"; kernel launches of the f64 bench knapsack's timed solve "
        f"{milp_launches}")

    # 8: the bounded simplex and the exact layer; the f64 bounded LP's
    # solve is that path's main run, its launch counts read right after it
    secs8 = {}
    t0 = time.perf_counter()
    exact = {"bounded_lp": phase_bounded_lp(dev)}
    secs8["bounded_lp"] = time.perf_counter() - t0
    exact["bounded_batch"] = phase_bounded_batch(dev)
    secs8["bounded_batch"] = time.perf_counter() - t0 - sum(secs8.values())
    exact["blocked_batch"] = phase_blocked_batch(dev)
    secs8["blocked_batch"] = time.perf_counter() - t0 - sum(secs8.values())
    exact.update(phase_exact_layer(dev))
    secs8["exact_layer"] = time.perf_counter() - t0 - sum(secs8.values())
    bounded_launches = exact["bounded_lp"]["float64"]["launches"]
    log("# phase 8 (bounded and exact layer): "
        + ", ".join(f"{k} {v:.1f} s" for k, v in secs8.items())
        + f"; kernel launches of the f64 bounded LP's solve "
        f"{bounded_launches}")

    # 9: the sharded path (solve_lp(mesh=...)) over a one-process NCCL
    # group; each of its runs reads its own launch counts
    t0 = time.perf_counter()
    mesh = phase_mesh(main_path["objective"])
    log(f"# phase 9 (mesh): {time.perf_counter() - t0:.1f} s")

    # 10: the batch half of multi-device solving over a one-process NCCL
    # group; each of its runs reads its own launch counts
    t0 = time.perf_counter()
    batch_mesh = phase_batch_mesh(milp["bench_knapsack_float64"])
    log(f"# phase 10 (batch mesh): {time.perf_counter() - t0:.1f} s")

    loaded = sorted(m for m in sys.modules if m == "jax"
                    or m.startswith("jax.") or m == "tpulp"
                    or m.startswith("tpulp."))
    if loaded:
        raise AssertionError(f"jax or tpulp modules were imported: {loaded}")
    batch_launches = exact["blocked_batch"]["solves"]["float64"]["launches"]
    sources = {
        "fused_flush": ("tpulp_torch/kernels/csrc/flush.cu",
                        "tpulp/kernels/pallas_block.py:491", launches),
        "blocked_inner_block": ("tpulp_torch/kernels/csrc/inner_block.cu",
                                "tpulp/kernels/pallas_block.py:554",
                                launches),
        "fused_fma": ("tpulp_torch/kernels/csrc/fma.cu",
                      "none: XLA's fusion of the rank-1 update "
                      "(tpulp/solve/driver.py)", milp_launches),
        "lane_dual": ("tpulp_torch/kernels/csrc/lanes.cu",
                      "none: XLA's vmapped lax.while_loop over "
                      "dual_simplex_step (tpulp/solve/dual.py:263, 404, "
                      "520, 579)", milp_launches),
        "lane_primal": ("tpulp_torch/kernels/csrc/lanes.cu",
                        "none: XLA's vmapped lax.while_loop over "
                        "simplex_step (tpulp/solve/dual.py:271, 409, 525, "
                        "592; tpulp/batch/vmap_driver.py:250)",
                        milp_launches),
        "rank1_step": ("tpulp_torch/kernels/csrc/rank1.cu",
                       "none: XLA's compiled lax.while_loop over "
                       "simplex_step, devex_simplex_step and "
                       "dual_simplex_step (tpulp/solve/driver.py:74, "
                       "252-293; tpulp/solve/devex.py:75, 240-262; "
                       "tpulp/solve/dual.py:62)", solo["launches"]),
        "blocked_step": ("tpulp_torch/kernels/csrc/blocked.cu",
                         "none: XLA's compiled lax.while_loop over "
                         "_blocked_pivot (tpulp/solve/blocked.py:61-245, "
                         "247-315)", blocked["step_launches"]),
        "rank1_cluster": ("tpulp_torch/kernels/csrc/rank1_cluster.cu",
                          "none: XLA's compiled lax.while_loop over "
                          "simplex_step, devex_simplex_step and "
                          "dual_simplex_step (tpulp/solve/driver.py:74, "
                          "286; tpulp/solve/devex.py:75, 255; "
                          "tpulp/solve/dual.py:62, 162)", solo["launches"]),
        "blocked_cluster": ("tpulp_torch/kernels/csrc/blocked_cluster.cu",
                            "none: XLA's compiled lax.while_loop over "
                            "_blocked_pivot (tpulp/solve/blocked.py:61-245, "
                            "one block of the fori_loop 272-275)",
                            blocked["launches"]),
        "blocked_cluster_batch": (
            "tpulp_torch/kernels/csrc/blocked_cluster.cu",
            "none: XLA's vmapped lax.while_loop over _blocked_pivot "
            "(tpulp/solve/blocked.py:61-245, the batch 335-366)",
            batch_launches),
        "fused_flush_batch": (
            "tpulp_torch/kernels/csrc/flush.cu",
            "tpulp/kernels/pallas_block.py:491 (B1, here with a lane axis: "
            "tpulp's vmapped batch flushes with XLA's product, "
            "tpulp/solve/blocked.py:335-366)", batch_launches),
        "blocked_ray_batch": (
            "tpulp_torch/kernels/csrc/blocked.cu",
            "none: the per-lane ray scan and carry reset of tpulp's "
            "vmapped blocked batch (tpulp/solve/blocked.py:335-366)",
            batch_launches),
        "lane_bounded": (
            "tpulp_torch/kernels/csrc/lanes.cu",
            "none: XLA's jax.jit(jax.vmap(_compiled_bounded_driver)), a "
            "vmapped lax.while_loop over bounded_simplex_step "
            "(tpulp/solve/bounded.py:308-330, 86-275)",
            exact["bounded_batch"]["bounded"]["launches"]),
        "bounded_grid": (
            "tpulp_torch/kernels/csrc/bounded_grid.cu",
            "none: XLA's compiled lax.while_loop over bounded_simplex_step "
            "(tpulp/solve/bounded.py:86-276, 278-307)", bounded_launches),
        # the main path: (f)'s driver="rank1" solve at 1538 x 3073
        "rank1_grid": ("tpulp_torch/kernels/csrc/rank1_grid.cu",
                       "none: XLA's compiled lax.while_loop over "
                       "simplex_step, devex_simplex_step and "
                       "dual_simplex_step (tpulp/solve/driver.py:74, "
                       "252-293; tpulp/solve/devex.py:75, 240-262; "
                       "tpulp/solve/dual.py:62, 143-170)",
                       solo["solves"]["f_float64"]["launches"]),
        # the main path: (g)'s f64 solve_lp(driver="auto") past the cluster
        "blocked_grid": ("tpulp_torch/kernels/csrc/blocked_grid.cu",
                         "none: XLA's compiled lax.while_loop over "
                         "_blocked_pivot (tpulp/solve/blocked.py:61-245, "
                         "one block of the fori_loop 272-275)",
                         blocked["grid_launches"]),
        # the main path: 7d (m)'s solve_lp_batch of 258 x 513 frames
        "rank1_cluster_lanes": (
            "tpulp_torch/kernels/csrc/rank1_cluster.cu",
            "none: XLA's vmapped lax.while_loop over simplex_step "
            "(tpulp/batch/vmap_driver.py:249-252; tpulp/solve/dual.py:271, "
            "409, 525, 592)", lane_cases["cluster_main_path"]["launches"]),
        # the main path: 9b's solve_lp(mesh, shard_driver="rank1"), one
        # launch a step; 9c's bounded walk and 10a's and 10b's lanes ride
        # along
        "shard_pivot": (
            "tpulp_torch/kernels/csrc/shard_pivot.cu",
            "none: XLA's fusion of the sharded pivot (tpulp/shard/"
            "sharded.py:393-405; tpulp/shard/sharded_bounded.py:218-248)",
            mesh["rank1"]["launches"]),
        # the main path: 9a's solve_lp(mesh, shard_driver="blocked"), one
        # launch a pivot
        "shard_vectors": (
            "tpulp_torch/kernels/csrc/shard_pivot.cu",
            "none: XLA's fusion of the rank-K sharded pivot's running "
            "vectors (tpulp/shard/sharded_blocked.py:242-244)",
            mesh["blocked"]["launches"]),
    }
    # rank1_step's main path since the grid took every frame a cluster
    # does not hold up to its plan: (x)'s walk past the plan
    sources["rank1_step"] = sources["rank1_step"][:2] + (
        solo["past"]["launches"],)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    batch_part = {"blocked_cluster_batch": "cluster",
                  "fused_flush_batch": "flush", "blocked_ray_batch": "ray"}
    kernels = []
    for kname, (src, repl, counts) in sources.items():
        if kname == "fused_fma":
            head = dict(fma_cases["rank1_pivot_vmap float64"])
            head["library_ms"] = None  # CUDA addcmul rounds twice
            cases = fma_cases
        elif kname == "bounded_grid":
            # per step of 8a's walks on the grid: the walk's host-clock time,
            # the plain version's, one launch on the card by stage (the same
            # rule and type as the walk), the
            # walk's bound (the frame read and written once, an fma an
            # entry a step) beside the kernel's own convention and the
            # table's step convention; the f64 Dantzig instantiation by its
            # timed launch and its window against the plain version
            bl = exact["bounded_lp"]

            def grid_case(g, **extra):
                return {
                    "bound_ms": g["bound_ms"], "bound_by": g["bound_by"],
                    "library_ms": None,
                    "grid_bound_ms": g["grid_bound_ms"],
                    "step_bound_ms": g["step_bound_ms"],
                    "device_ms": g["device_us_per_step"] / 1e3,
                    "device_ms_by_stage": {
                        k: v / 1e3 for k, v in
                        g["device_us_by_stage"].items()},
                    "blocks": g["blocks"], "width": g["width"],
                    "smem": g["smem"], "occupancy": g["occupancy"],
                    **extra}

            cases = {}
            for dt, walk in (("float64", "f64_devex"),
                             ("float32", "f32_devex_window"),
                             ("bland float32", "f32_dantzig_bland")):
                w = bl["walks"][walk]
                steps = max(1, w["niter"])
                if dt.startswith("bland"):
                    err, plain = w["max_abs_err"], \
                        1e3 * w["plain_seconds"] / steps
                else:
                    ref = bl["reference"][dt]
                    err = max(w["max_abs_err"], ref["max_abs_err"])
                    plain = ref["plain_ms_per_step"]
                cases[dt] = grid_case(
                    bl["grid_us"][dt], max_abs_err=err,
                    ms=1e3 * w["seconds"] / steps, plain_ms=plain,
                    walk_seconds=w["seconds"],
                    plain_walk_seconds=w["plain_seconds"], steps=w["niter"])
            g, ref = bl["grid_us"]["dantzig float64"], \
                bl["reference"]["dantzig float64"]
            cases["dantzig float64"] = grid_case(
                g, max_abs_err=ref["max_abs_err"],
                ms=g["device_us_per_step"] / 1e3,
                plain_ms=ref["plain_ms_per_step"], steps=g["steps"])
            # the streamed plan: (w)'s f64 devex walk, one launch of 1,024
            # steps from step 2,000, twice; its window against the plain
            # walk and the plain version
            wd = bl["wide"]
            win = wd["window"]
            cases["streamed float64 (w)"] = grid_case(
                wd["grid_us"], max_abs_err=win["max_abs_err"],
                ms=1e3 * win["seconds"] / win["steps"],
                plain_ms=win["plain_ms_per_step"],
                device_ms_turns=[v / 1e3 for v in
                                 wd["grid_us"]["device_us_turns"]],
                rows=wd["grid_us"]["rows"], scratch=wd["grid_us"]["scratch"],
                steps=wd["grid_us"]["steps"], solve_steps=wd["niter"],
                solve_seconds=wd["seconds"],
                window_float32_max_abs_err=wd["window_float32"][
                    "max_abs_err"],
                window_float32_plain_ms=wd["window_float32"][
                    "plain_ms_per_step"])
            # the device-vector plan: (x) and (y), past the streamed plan,
            # one launch of BND_PAST_GRID_TIMED steps from step 8, twice;
            # the walk against the plain walk; the bound by the table's step
            # convention beside the walk's and the kernel's own
            for case, key in (("device vectors float64 (x)", "past"),
                              ("device vectors float32 (y)",
                               "past_float32")):
                px = bl[key]
                gx = px["grid_us"]
                cases[case] = grid_case(
                    gx, max_abs_err=px["max_abs_err"],
                    ms=1e3 * px["seconds"] / px["steps"],
                    plain_ms=1e3 * px["plain_seconds"] / px["steps"],
                    table_step_bound_ms=px["bound_us_per_step"] / 1e3,
                    device_ms_turns=[v / 1e3 for v in
                                     gx["device_us_turns"]],
                    rows=gx["rows"], tile_rows=gx["tile_rows"],
                    scratch=gx["scratch"], vectors=gx["vectors"],
                    steps=gx["steps"], solve_steps=px["steps"],
                    launches=px["launches"]["bounded_grid"])
            # the wide plan: (z), (z64) and (z32), past the device-vector
            # plan; the timed launch of the first window that mostly pivots
            # (its bound the window's own: the rows its steps touch) and of
            # the entering flips from step 8; the walk to its budget on the
            # host clock; the held window against the plain version
            for case, key in (("wide float64 (z)", "too_wide"),
                              ("wide float64 (z64)", "too_wide_64"),
                              ("wide float32 (z32)", "too_wide_32")):
                z = bl[key]
                gp, gf = z["grid_us"]["pivots"], z["grid_us"]["flips"]
                cases[case] = {
                    "max_abs_err": z["max_abs_err"],
                    "ms": 1e3 * z["seconds"] / z["steps"],
                    "plain_ms": z["plain_ms_per_step"],
                    "bound_ms": gp["bound_ms"], "bound_by": "bytes",
                    "library_ms": None,
                    "table_step_bound_ms": z["bound_us_per_step"] / 1e3,
                    "device_ms": gp["device_us_per_step"] / 1e3,
                    "device_ms_turns": [v / 1e3 for v in
                                        gp["device_us_turns"]],
                    "device_ms_by_stage": {
                        k: v / 1e3 for k, v in
                        gp["device_us_by_stage"].items()},
                    "window_from": z["window_from"],
                    "window_flips": z["window_flips"],
                    "flips_window_device_ms": gf["device_us_per_step"]
                    / 1e3,
                    "flips_window_bound_ms": gf["bound_ms"],
                    "flips_window_by_stage_ms": {
                        k: v / 1e3 for k, v in
                        gf["device_us_by_stage"].items()},
                    "blocks": gp["blocks"], "width": gp["width"],
                    "smem": gp["smem"], "occupancy": gp["occupancy"],
                    "tile_rows": gp["tile_rows"], "scratch": gp["scratch"],
                    "vectors": gp["vectors"], "steps": z["steps"],
                    "pivots": z["pivots"],
                    "entering_flips": z["entering_flips"],
                    "upper_hits": z["upper_hits"],
                    "launches": z["launches"]["bounded_grid"]}
            cases["shared frame (s)"] = bl["shared_frame"]
            head = cases["float64"]
        elif kname == "rank1_step":
            # per step of 5c's walks: the walk's host-clock time, the plain
            # step's, the tableau's bytes, the launches on the card alone
            cases = {}
            for case, walk, us in (
                    ("float64", "a_float64", "a_float64"),
                    ("float32", "a_float32", "a_float32"),
                    ("devex float64", "b_float64", "b_float64"),
                    ("devex float32", "b_float32", "b_float32"),
                    ("greatest increase float64", "c_max_increase_float64",
                     "a_max_increase_float64"),
                    ("greatest increase float32", "c_max_increase_float32",
                     "a_max_increase_float32"),
                    ("main 1538x3073 float64", "f_float64", "f_float64"),
                    ("dual float64", "e_deep_float64", "e_deep_float64"),
                    ("dual float32", "e_deep_float32", "e_deep_float32"),
                    ("dual main 1538x3073 float64", "e_main_float64",
                     "e_main_float64")):
                w, u = solo["walks"][walk], solo["step_us"][us]
                # on the cluster and grid routes: rank1_step's walk timed
                # beside it
                w = w.get("rank1_step", w)
                cases[case] = {
                    "max_abs_err": w["max_abs_err"], "ms": w["ms_per_step"],
                    "plain_ms": w["plain_ms_per_step"],
                    "bound_ms": u["bound_us_per_step"] / 1e3,
                    "bound_by": u["bound_by"], "library_ms": None,
                    "device_ms": u["device_us_per_step"] / 1e3,
                    "device_ms_by_stage": {
                        k: v / 1e3 for k, v in
                        u["device_us_by_stage"].items()},
                    "host_enqueue_ms": u["host_us_per_step"] / 1e3,
                    "steps": w["niter"]}
            # the route's shape since the grid: (x), past its plan
            px, u = solo["past"], solo["past"]["step_us"]
            cases["past the grid's plan float64 (x)"] = {
                "max_abs_err": px["max_abs_err"], "ms": px["ms_per_step"],
                "plain_ms": px["plain_ms_per_step"],
                "bound_ms": u["bound_us_per_step"] / 1e3,
                "bound_by": u["bound_by"], "library_ms": None,
                "device_ms": u["device_us_per_step"] / 1e3,
                "device_ms_by_stage": {
                    k: v / 1e3 for k, v in u["device_us_by_stage"].items()},
                "host_enqueue_ms": u["host_us_per_step"] / 1e3,
                "steps": px["steps"]}
            head = cases["past the grid's plan float64 (x)"]
        elif kname == "rank1_grid":
            # a pivot of 5c's grid walks: the host clock (in turns with
            # rank1_step's walk of the same frame), one launch of up to
            # 1,024 steps on the card by stage, the plain version's window,
            # the walk's bound (the frame read and written once, an fma an
            # entry a pivot) beside the kernel's own convention and the
            # table's step convention
            cases = {}
            for case, walk, us in (
                    ("float64", "f_float64", "f_float64"),
                    ("float32", "f_float32", None),
                    ("dual float64", "e_main_float64", "e_main_float64"),
                    ("dual float32", "e_main_float32", None),
                    ("resident dual 514x1537 float64",
                     "e_grid_resident_float64", "e_grid_resident_float64")):
                w = solo["walks"][walk]
                g = solo["grid_us"].get(us) if us else None
                steps = max(w["niter"], 1)
                cases[case] = {
                    "max_abs_err": w["max_abs_err"], "ms": w["ms_per_step"],
                    "plain_ms": w["plain_ms_per_step"],
                    "bound_ms": g["bound_ms"] if g else w["bound_ms"] / steps,
                    "bound_by": g["bound_by"] if g else w["bound_by"],
                    "library_ms": None,
                    "rank1_step_ms": w["rank1_step"]["ms_per_step"],
                    "walk_seconds": w["seconds"],
                    "rank1_step_walk_seconds": w["rank1_step"]["seconds"],
                    "blocks": w["blocks"], "width": w["width"],
                    "rows": w["rows"], "smem": w["smem"],
                    "scratch": w["scratch"], "steps": w["niter"]}
                if g:
                    cases[case].update(
                        device_ms=g["device_us_per_step"] / 1e3,
                        device_ms_turns=[v / 1e3 for v in
                                         g.get("device_us_turns", [])],
                        device_ms_by_stage={
                            k: v / 1e3 for k, v in
                            g["device_us_by_stage"].items()},
                        grid_bound_ms=g["grid_bound_ms"],
                        step_bound_ms=g["step_bound_ms"],
                        occupancy=g["occupancy"],
                        timed_steps=g["steps"])
                    if us in solo["step_us"]:
                        cases[case]["rank1_step_device_ms"] = \
                            solo["step_us"][us]["device_us_per_step"] / 1e3
            head = cases["float64"]
        elif kname == "rank1_cluster":
            # a pivot of 5c's walks on the cluster kernel: the host clock
            # (in turns with rank1_step), the launch on the card, the plain
            # version's walk, the walk's bound (the frame read and written
            # once, one fma an entry a pivot) a pivot
            cases = {}
            for case, walk in (
                    ("float64", "a_float64"), ("float32", "a_float32"),
                    ("devex float64", "b_float64"),
                    ("devex float32", "b_float32"),
                    ("devex optimal float64", "b_optimal_float64"),
                    ("devex optimal float32", "b_optimal_float32"),
                    ("greatest increase float64", "c_max_increase_float64"),
                    ("greatest increase float32", "c_max_increase_float32"),
                    ("largest-pivot ties float64", "c_maxpiv_float64"),
                    ("largest-pivot ties float32", "c_maxpiv_float32"),
                    ("bland window float64", "c_bland_float64"),
                    ("bland window float32", "c_bland_float32"),
                    ("dual float64", "e_deep_float64"),
                    ("dual float32", "e_deep_float32"),
                    ("warm re-solve float64", "e_float64"),
                    ("warm re-solve float32", "e_float32"),
                    ("refreshed ties float64", "g_float64"),
                    ("refreshed ties float32", "g_float32")):
                w = solo["walks"][walk]
                steps = max(w["niter"], 1)
                cases[case] = {
                    "max_abs_err": w["max_abs_err"],
                    "ms": w["host_us_per_step"] / 1e3,
                    "plain_ms": w["plain_ms_per_step"],
                    "bound_ms": w["bound_ms"] / steps,
                    "bound_by": w["bound_by"], "library_ms": None,
                    "device_ms": w["device_us_per_step"] / 1e3,
                    "device_ms_by_stage": {
                        k: v / 1e3 for k, v in
                        w["device_us_by_stage"].items()},
                    "walk_ms": w["host_us_per_step"] * steps / 1e6,
                    "load_store_ms": w["load_store_ms"],
                    "step_bound_ms": w["step_bound_ms"],
                    "rank1_step_ms": w["rank1_step"]["ms_per_step"],
                    "rank1_step_steps": w["rank1_step"]["steps"],
                    "blocks": w["blocks"], "width": w["width"],
                    "smem": w["smem"], "occupancy": w["occupancy"],
                    "steps": w["niter"]}
            head = cases["float64"]
        elif kname == "blocked_step":
            # per pivot of 5d's walks: the walk's host-clock time, the plain
            # walk's, a slot's bytes, the launches on the card alone; the
            # headline at the shape its route gives it since the grid, (p):
            # (g)'s LP past the grid's plan
            px = blocked["past"]
            cases = {"past the grid's plan float64 (p)": {
                "max_abs_err": px["max_abs_err"], "ms": px["ms_per_pivot"],
                "plain_ms": px["plain_ms_per_pivot"],
                "bound_ms": px["bound_us_per_slot"] / 1e3,
                "bound_by": px["bound_by"], "library_ms": None,
                "device_ms": px["device_us_per_slot"] / 1e3,
                "host_enqueue_ms": px["host_us_per_slot"] / 1e3,
                "K": px["K"], "steps": px["niter"]}}
            # (g) on blocked_steps, in turns with the grid that took it
            for dt in ("float64", "float32"):
                w = blocked["grid_walks"][f"g_wide_{dt}"]
                u = blocked["grid_slot_us"][f"g_wide_{dt}"]
                cases[f"wide {dt} (g), in turns with blocked_grid"] = {
                    "max_abs_err": w["max_abs_err"],
                    "ms": w["step_us_per_pivot"] / 1e3,
                    "plain_ms": w["plain_ms_per_pivot"],
                    "bound_ms": u["step_bound_us_per_slot"] / 1e3,
                    "bound_by": "bytes", "library_ms": None,
                    "device_ms": u["step_device_us_per_slot"] / 1e3,
                    "device_ms_turns": [v / 1e3 for v in
                                        u["step_device_us_turns"]],
                    "steps": w["niter"]}
            for case, walk, us in (
                    ("float64", "a_float64", "a_float64"),
                    ("float32", "a_float32", "a_float32"),
                    ("devex float64", "b_optimal_float64", "b_float64"),
                    ("devex float32", "b_optimal_float32", "b_float32")):
                w, u = blocked["walks"][walk], blocked["slot_us"][us]
                cases[case] = {
                    "max_abs_err": w["max_abs_err"],
                    "ms": w["us_per_pivot"] / 1e3,
                    "plain_ms": w["plain_ms_per_pivot"],
                    "bound_ms": u["bound_us_per_slot"] / 1e3,
                    "bound_by": u["bound_by"], "library_ms": None,
                    "device_ms": u["device_us_per_slot"] / 1e3,
                    "device_ms_by_stage": {
                        k: v / 1e3 for k, v in
                        u["device_us_by_stage"].items()},
                    "host_enqueue_ms": u["host_us_per_slot"] / 1e3,
                    "flush_and_ray_ms_per_block":
                        u["flush_and_ray_us_per_block"] / 1e3,
                    "steps": w["niter"]}
            head = cases["past the grid's plan float64 (p)"]
        elif kname == "blocked_grid":
            # per pivot of (g)'s walks on the grid: the walk's host-clock
            # time (in turns with blocked_step), the plain version's window,
            # one launch of K slots on the card (in turns with blocked_step's
            # K slots) by stage; the bounds: each input once a launch (the
            # contract's), the kernel's own convention, the table's step
            # convention; beside blocked_cluster at a shape both hold
            cases = {}
            for dt in ("float64", "float32"):
                w = blocked["grid_walks"][f"g_wide_{dt}"]
                u = blocked["grid_slot_us"][f"g_wide_{dt}"]
                cases[dt] = {
                    "max_abs_err": w["max_abs_err"],
                    "ms": w["us_per_pivot"] / 1e3,
                    "plain_ms": w["plain_ms_per_pivot"],
                    "bound_ms": u["bound_us_per_slot"] / 1e3,
                    "bound_by": u["bound_by"], "library_ms": None,
                    "grid_bound_ms": u["grid_bound_us_per_slot"] / 1e3,
                    "step_bound_ms": u["step_bound_us_per_slot"] / 1e3,
                    "device_ms": u["device_us_per_slot"] / 1e3,
                    "device_ms_turns": [v / 1e3 for v in
                                        u["device_us_turns"]],
                    "device_ms_by_stage": {
                        k: v / 1e3 for k, v in
                        u["device_us_by_stage"].items()},
                    "host_launch_ms_per_slot": u["host_us_per_slot"] / 1e3,
                    "blocked_step_ms": w["step_us_per_pivot"] / 1e3,
                    "blocked_step_device_ms":
                        u["step_device_us_per_slot"] / 1e3,
                    "walk_seconds": w["walk_seconds"],
                    "blocked_step_walk_seconds": w["step_walk_seconds"],
                    "blocks": u["blocks"], "width": u["width"],
                    "height": u["height"], "smem": u["smem"],
                    "mail": w["mail"], "occupancy": u["occupancy"],
                    "window": w["window"], "steps": w["niter"]}
            gc = blocked["grid_vs_cluster"]
            cw = blocked["cluster_walks"]["a_float64"]
            cu = blocked["cluster_slot_us"]["a_float64"]
            cases["cluster shape 514x1537 float64 (a)"] = {
                "max_abs_err": 0.0, "ms": gc["grid_us_per_slot"] / 1e3,
                "plain_ms": cw["plain_ms_per_pivot"],
                "bound_ms": cu["bound_us_per_slot"] / 1e3,
                "bound_by": cu["bound_by"], "library_ms": None,
                "device_ms": gc["grid_us_per_slot"] / 1e3,
                "device_ms_turns": [v / 1e3 for v in gc["grid_turns"]],
                "blocked_cluster_device_ms": gc["cluster_us_per_slot"] / 1e3,
                "blocked_cluster_device_ms_turns": [
                    v / 1e3 for v in gc["cluster_turns"]],
                "blocks": gc["grid"]}
            head = cases["float64"]
        elif kname == "blocked_cluster":
            # per pivot of 5d's walks on the cluster: the walk's host-clock
            # time (in turns with blocked_step), the plain version's walk,
            # a slot's share of a launch's bytes (cluster_bound), a launch
            # of K slots on the card alone, by stage (block 0's clock)
            cases = {}
            for case, walk, us in (
                    ("float64", "a_float64", "a_float64"),
                    ("float32", "a_float32", "a_float32"),
                    ("devex float64", "b_optimal_float64", "b_float64"),
                    ("devex float32", "b_optimal_float32", "b_float32"),
                    ("largest-pivot ties float64", "c_float64", None),
                    ("largest-pivot ties float32", "c_float32", None)):
                w = blocked["cluster_walks"][walk]
                u = blocked["cluster_slot_us"][us] if us else {}
                cases[case] = {
                    "max_abs_err": w["max_abs_err"],
                    "ms": w["us_per_pivot"] / 1e3,
                    "plain_ms": w["plain_ms_per_pivot"],
                    "bound_ms": (u or blocked["cluster_slot_us"][
                        walk.replace("c_", "a_")])["bound_us_per_slot"] / 1e3,
                    "bound_by": (u or blocked["cluster_slot_us"][
                        walk.replace("c_", "a_")])["bound_by"],
                    "library_ms": None,
                    "blocked_step_ms": w["step_us_per_pivot"] / 1e3,
                    "device_ms": u["device_us_per_slot"] / 1e3 if u
                    else None,
                    "device_ms_by_stage": {
                        k: v / 1e3 for k, v in
                        u["device_us_by_stage"].items()} if u else None,
                    "flush_and_ray_ms_per_block":
                        u["flush_and_ray_us_per_block"] / 1e3 if u
                        else None,
                    "blocks": w["cluster"], "smem": w["smem"],
                    "occupancy": w["occupancy"], "steps": w["niter"]}
            head = cases["float64"]
        elif kname == "shard_pivot":
            # the headline: 9b's first step (1538 x 3072 and its RHS, f64),
            # in turns with the former path; f32, 9c's leaving flip and the
            # lanes of 10a and 10b ride along
            sp = mesh["shard_pivot"]
            head = sp["9b_float64"]
            cases = {"9b float64": sp["9b_float64"],
                     "9b float32": sp["9b_float32"],
                     "9c leaving flip float64":
                         mesh["bounded"]["shard_pivot"]["leave_flip"],
                     "10a 1x1 float64":
                         batch_mesh["lp_batch_1x1"]["shard_pivot"],
                     "10b 1x1 float64": batch_mesh["milp_1x1"]["shard_pivot"]}
        elif kname == "shard_vectors":
            head = mesh["shard_pivot"]["9a_vectors_float64"]
            cases = {"9a float64": head}
        elif kname in batch_part:
            # a block of 8c's batch (8 lanes of 514 x 1025, K 64): the
            # launch over the lanes on the card, beside its plain version
            times = exact["blocked_batch"]["times"]
            cases = {dt: times[dt][batch_part[kname]]
                     for dt in ("float64", "float32")}
            head = cases["float64"]
        elif kname == "lane_bounded":
            # the headline: 8b's 256 box LPs of 66 x 193, f64, Dantzig;
            # 10c's span nodes and the streamed lanes ride along
            kc = exact["bounded_batch"]["kernel"]
            head = kc["float64"]["box"]
            cases = {f"{case} {dt}": st for dt, by in kc.items()
                     for case, st in by.items()}
        elif kname == "rank1_cluster_lanes":
            # the headline: 7d's 8 lanes of 258 x 513, f64, cold; the
            # other frames past a block's shared memory and (w)'s 128
            # lanes ride along
            head = lane_cases["float64"]["streamed_cold"]
            cases = {f"{case} {dt}": st for dt in ("float64", "float32")
                     for case, st in lane_cases[dt].items()
                     if st.get("route") == "cluster"}
            cases["wide_128 float64"] = lane_cases["float64"]["wide_128"]
            cases["wide_128_dual float64"] = lane_cases["float64"][
                "wide_128_dual"]
        elif kname.startswith("lane_"):
            # the headline: the f64 bench knapsack's warm wave (the dual
            # loop) and cold wave (the primal loop), 128 lanes of 59 x 114
            head = lane_cases["float64"]["knapsack_warm" if kname ==
                                         "lane_dual" else "knapsack_cold"]
            kind = kname[len("lane_"):]
            cases = {f"{case} {dt}": st for dt in ("float64", "float32")
                     for case, st in lane_cases[dt].items()
                     if st.get("kind") == kind}
        else:
            # the headline numbers are taken at the main path's own shape;
            # the bench shape's ride along
            head = kstats["main_path"][kname]
            cases = {case: kstats[case][kname]
                     for case in ("bench_float32", "bench_float64")}
        kernels.append({"name": kname, "route": "cuda", "source": src,
                        "replaces": repl, "launches": counts[kname],
                        **{k: head.get(k) for k in keys},
                        "cases": cases})
    by_name = {k["name"]: k for k in kernels}
    if bounded_launches["fused_fma"] != 0:
        raise AssertionError("the f64 bounded LP's solve launched the FMA "
                             "kernel")
    # the FMA kernel's main path is MILP (its ``launches``); the bounded
    # LP of phase 8 runs the bounded kernels and no FMA
    by_name["fused_fma"]["launches_by_path"] = {
        "milp_bench_knapsack_float64": milp_launches["fused_fma"],
        "bounded_lp_float64": bounded_launches["fused_fma"],
        "bounded_batch_8b_float64":
            exact["bounded_batch"]["bounded"]["launches"]["fused_fma"],
        "sharded_blocked_p1_float64":
            mesh["blocked"]["launches"]["fused_fma"],
        "sharded_rank1_p1_float64": mesh["rank1"]["launches"]["fused_fma"],
        "sharded_bounded_p1_float64":
            mesh["bounded"]["mesh"]["launches"]["fused_fma"],
        **{f"{path}_float64": batch_mesh[path]["launches"]["fused_fma"]
           for path in ("lp_batch_1x1", "lp_batch_batch", "milp_1x1",
                        "milp_batch", "spans")}}
    # phase 10's paths: the operand layouts of their launches, each held
    # bit for bit against the CPU's addcmul
    by_name["fused_fma"]["layouts_held_by_path"] = {
        f"{path}_float64": batch_mesh[path]["fma_layouts"]
        for path in ("lp_batch_1x1", "lp_batch_batch", "milp_1x1",
                     "milp_batch")}
    # the flush runs on two main paths: the kernel engine of phase 5 (its
    # ``launches``) and the sharded blocked driver of phase 9a, which
    # flushes each rank's (m+2, n/P) block
    by_name["fused_flush"]["launches_by_path"] = {
        "main_path_kernel_engine": launches["fused_flush"],
        "sharded_blocked_p1_float64":
            mesh["blocked"]["launches"]["fused_flush"]}
    by_name["fused_flush"]["sharded_block_case"] = {k: mesh["flush"].get(k)
                                        for k in keys}
    by_name["fused_flush"]["flush_cases"] = flush_cases
    by_name["fused_flush"]["sass"] = sass
    by_name["blocked_inner_block"]["barrier_probe"] = probe
    for kname in ("lane_dual", "lane_primal"):
        by_name[kname]["launches_by_path"] = {
            "milp_bench_knapsack_float64": milp_launches[kname],
            **{f"{path}_float64": batch_mesh[path]["launches"][kname]
               for path in ("lp_batch_batch", "milp_batch")}}
        head = lane_cases["float64"]["knapsack_warm" if kname == "lane_dual"
                                     else "knapsack_cold"]
        by_name[kname].update({key: head.get(key) for key in (
            "us_per_step", "device_ms", "device_us_per_step", "steps",
            "pivots", "threads", "stage_us_per_step", "barriers_per_step")})
    bgrid = by_name["bounded_grid"]
    bgrid.update({key: bgrid["cases"]["float64"][key] for key in (
        "device_ms", "device_ms_by_stage", "blocks", "width", "smem",
        "occupancy", "grid_bound_ms", "step_bound_ms", "steps")})
    # every solo bounded walk on the card runs the grid; 8a (z), (z64) and
    # (z32) on its wide plan
    bgrid["launches_by_path"] = {
        "bounded_lp_float64": bounded_launches["bounded_grid"],
        "bounded_lp_float32": exact["bounded_lp"]["float32"]["launches"][
            "bounded_grid"],
        "sharded_bounded_solo_float64":
            mesh["bounded"]["solo"]["launches"]["bounded_grid"],
        "8a_wide_float64": exact["bounded_lp"]["wide"]["launches"][
            "bounded_grid"],
        "8a_past_streamed_float64": exact["bounded_lp"]["past"]["launches"][
            "bounded_grid"],
        "8a_past_streamed_float32": exact["bounded_lp"]["past_float32"][
            "launches"]["bounded_grid"],
        **{f"8a_wide_plan_{key}": exact["bounded_lp"][key]["launches"][
            "bounded_grid"] for key in ("too_wide", "too_wide_64",
                                        "too_wide_32")}}
    bgrid["edge_walks_held"] = exact["bounded_lp"]["reference"]["edge_walks"]
    bgrid["card_tests"] = exact["bounded_lp"]["card_tests"]
    kc = by_name["rank1_step"]
    kc.update({key: kc["cases"][
        "past the grid's plan float64 (x)"][key] for key in (
        "device_ms", "host_enqueue_ms", "steps")})
    # the 5c solves: 0 on the frames a cluster holds (a, b, e, g) since the
    # cluster kernel took them, 0 on (f) and (e) at 1538 x 3073 since the
    # grid; (x)'s walk past the grid's plan
    solves5c = SOLO_SOLVES + ("e_main_float64", "f_float64",
                              "e_grid_resident_cold_float64",
                              "e_grid_resident_float64")
    by_name["rank1_step"]["launches_by_path"] = {
        f"5c_{case}": solo["solves"][case]["launches"]["rank1_step"]
        for case in solves5c}
    by_name["rank1_step"]["launches_by_path"]["5c_past_grid_float64"] = \
        solo["past"]["launches"]["rank1_step"]
    by_name["rank1_step"]["walks"] = {k: v for k, v in solo["walks"].items()
                           if v["route"] == "rank1_step"}
    by_name["rank1_step"]["stages_held_at_step"] = solo["stages"]
    kc = by_name["rank1_cluster"]
    kc.update({key: kc["cases"]["float64"][key] for key in (
        "device_ms", "load_store_ms", "blocks", "occupancy", "steps")})
    by_name["rank1_cluster"]["launches_by_path"] = {
        f"5c_{case}": solo["solves"][case]["launches"]["rank1_cluster"]
        for case in solves5c}
    # the grid: one launch a walk on (f), (e) at 1538 x 3073 and the
    # resident re-solve; 0 on the cluster's frames and past its plan
    kc = by_name["rank1_grid"]
    kc.update({key: kc["cases"]["float64"].get(key)
                        for key in ("device_ms", "device_ms_by_stage",
                                    "blocks", "width", "rows", "smem",
                                    "scratch", "occupancy", "grid_bound_ms",
                                    "step_bound_ms", "rank1_step_ms",
                                    "steps")})
    by_name["rank1_grid"]["launches_by_path"] = {
        f"5c_{case}": solo["solves"][case]["launches"]["rank1_grid"]
        for case in solves5c}
    by_name["rank1_grid"]["launches_by_path"]["5c_past_grid_float64"] = \
        solo["past"]["launches"]["rank1_grid"]
    by_name["rank1_grid"]["walks"] = {k: v for k, v in solo["walks"].items()
                            if v["route"] == "rank1_grid"}
    by_name["rank1_grid"]["edge_walks_held"] = solo["edge_grid"]
    by_name["rank1_cluster"]["walks"] = {k: v for k, v in solo["walks"].items()
                           if v["route"] == "rank1_cluster"}
    by_name["rank1_cluster"]["edge_walks_held"] = solo["edge_walks_held"]
    # the lane kernels at B = 1: one launch a solo walk
    by_name["lane_dual"]["launches_by_path"].update({
        f"5c_resident_warm_resolve_{dt}": solo["solves"][
            f"e_resident_{dt}"]["launches"]["lane_dual"]
        for dt in ("float64", "float32")})
    by_name["lane_dual"]["solo_walks"] = {
        k: v for k, v in solo["walks"].items()
                                if v["route"] == "lane_dual"}
    by_name["lane_primal"]["launches_by_path"].update({
        f"5c_{k}": v["launches"] for k, v in solo["walks"].items()
        if v["route"] == "lane_primal"})
    by_name["lane_primal"]["solo_walks"] = {
        k: v for k, v in solo["walks"].items()
                                if v["route"] == "lane_primal"}
    by_name["fused_fma"]["launches_by_path"]["solo_rank1_5c_a_float64"] = \
        solo["launches"]["fused_fma"]
    # the blocked engine: its slots, ray launches and B1 flushes by path,
    # and no FMA
    by_name["fused_fma"]["launches_by_path"]["solo_blocked_5d_a_float64"] = \
        blocked["launches"]["fused_fma"]
    by_name["fused_flush"]["launches_by_path"]["solo_blocked_5d_a_float64"] = \
        blocked["launches"]["fused_flush"]
    kc = by_name["blocked_step"]
    kc.update({key: kc["cases"][
        "past the grid's plan float64 (p)"][key]
        for key in ("device_ms", "host_enqueue_ms", "steps")})
    # the 5d solves: 0 where the cluster's plan fits (a, b, c), 0 on (g)'s
    # wide LP since the grid took it; (p)'s walk past the grid's plan (its
    # ``launches``)
    solves5d = ("a_float64", "a_float32", "b_optimal_float64",
                "b_optimal_float32", "b_float64", "b_float32", "c_float64",
                "c_float32", "g_wide_float64", "g_wide_float32")
    by_name["blocked_step"]["launches_by_path"] = {
        f"5d_{case}": blocked["solves"][case]["launches"]["blocked_step"]
        for case in solves5d}
    by_name["blocked_step"]["launches_by_path"]["5d_past_grid_float64"] = \
        blocked["past"]["launches"]["blocked_step"]
    by_name["blocked_step"]["ray_launches_by_path"] = {
        f"5d_{case}": blocked["solves"][case]["launches"]["blocked_ray"]
        for case in ("a_float64", "c_float64", "g_wide_float64",
                     "g_wide_float32")}
    by_name["blocked_step"]["walks"] = blocked["walks"]
    by_name["blocked_step"]["stages_held_at_slot"] = blocked["stages"]
    by_name["blocked_step"]["slot_us"] = blocked["slot_us"]
    kc = by_name["blocked_cluster"]
    kc.update({key: kc["cases"]["float64"][key] for key in (
        "device_ms", "device_ms_by_stage", "blocks", "smem", "occupancy",
        "blocked_step_ms", "steps")})
    by_name["blocked_cluster"]["launches_by_path"] = {
        f"5d_{case}": blocked["solves"][case]["launches"]["blocked_cluster"]
        for case in solves5d}
    by_name["blocked_cluster"]["walks"] = blocked["cluster_walks"]
    by_name["blocked_cluster"]["slot_us"] = blocked["cluster_slot_us"]
    by_name["blocked_cluster"]["edge_walks_held"] = blocked["edge_walks"]
    # the grid: one launch a block of (g)'s solves and of 8c (v)'s lanes, 0
    # on the cluster's LPs and past its plan
    kc = by_name["blocked_grid"]
    kc.update({key: kc["cases"]["float64"][key] for key in (
        "device_ms", "device_ms_by_stage", "blocks", "width", "height",
        "smem", "occupancy", "grid_bound_ms", "step_bound_ms",
        "blocked_step_ms", "blocked_step_device_ms", "steps")})
    by_name["blocked_grid"]["launches_by_path"] = {
        f"5d_{case}": blocked["solves"][case]["launches"]["blocked_grid"]
        for case in solves5d}
    by_name["blocked_grid"]["launches_by_path"]["5d_past_grid_float64"] = \
        blocked["past"]["launches"]["blocked_grid"]
    by_name["blocked_grid"]["launches_by_path"]["8c_wide_float64"] = \
        exact["blocked_batch"]["wide"]["launches"]["blocked_grid"]
    by_name["blocked_grid"]["walks"] = blocked["grid_walks"]
    by_name["blocked_grid"]["slot_us"] = blocked["grid_slot_us"]
    by_name["blocked_grid"]["edge_walks_held"] = blocked["grid_edge_walks"]
    by_name["blocked_grid"]["grid_vs_cluster"] = blocked["grid_vs_cluster"]
    by_name["fused_flush"]["blocked_cases"] = blocked["flush"]
    # the blocked batch (8c): its three launches a block by path; past the
    # plan its lanes run blocked_step
    bb = exact["blocked_batch"]
    for k in ("blocked_cluster_batch", "fused_flush_batch",
              "blocked_ray_batch"):
        by_name[k]["launches_by_path"] = {
            "8c_float32": bb["solves"]["float32"]["launches"][k],
            "8c_wide_float64": bb["wide"]["launches"][k]}
    by_name["blocked_cluster_batch"]["launches_by_path"][
        "8c_occupancy_float64"] = bb["occupancy"]["launches"]
    by_name["blocked_cluster_batch"]["small_batch_held"] = bb["small"]
    by_name["blocked_step"]["launches_by_path"]["8c_wide_float64"] = \
        bb["wide"]["launches"]["blocked_step"]
    # the bounded batch's walk: one launch a batch (8b), one a cold wave
    # (10c)
    by_name["lane_bounded"]["launches_by_path"] = {
        "8b_float64": exact["bounded_batch"]["bounded"]["launches"][
            "lane_bounded"],
        "10c_spans_float64": batch_mesh["spans"]["launches"]["lane_bounded"]}
    kc = by_name["lane_bounded"]
    kc.update({key: kc["cases"]["box float64"][key]
                        for key in ("us_per_step", "device_ms",
                                    "device_us_per_step", "steps", "acts",
                                    "pivots")})
    by_name["lane_bounded"]["split_8b"] = exact["bounded_batch"]["split"]
    # the cluster lanes: one launch a batch of frames past a block's shared
    # memory (7d (m)'s solve_lp_batch, the main path; 7d's 258 x 513 cases)
    by_name["rank1_cluster_lanes"].update({
        key: lane_cases["float64"]["streamed_cold"].get(key)
                        for key in ("us_per_step", "device_ms",
                                    "device_us_per_step", "steps", "pivots",
                                    "stage_us_per_step")})
    by_name["rank1_cluster_lanes"]["launches_by_path"] = {
        f"7d_{case}_{dt}": lane_cases[dt][case]["launches"].get(
            "rank1_cluster_lanes", 0)
        for dt in ("float64", "float32") for case in (
            "streamed_cold", "streamed_warm", "streamed_warm_cleanup")}
    # the cluster lanes' dual walk: 7d's streamed_warm (the dual loop on
    # 258 x 513 frames, dual_lanes' route)
    by_name["rank1_cluster_lanes"]["dual_walk"] = {
        key: lane_cases["float64"]["streamed_warm"].get(key)
        for key in ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                    "bound_by", "device_ms", "device_us_per_step", "steps",
                    "pivots", "stage_us_per_step")}
    for kind, cs in (("primal", ("streamed_cold", "streamed_warm_cleanup")),
                     ("dual", ("streamed_warm",))):
        by_name[f"lane_{kind}"]["one_block_launches_on_the_cluster_route"] = {
            f"7d_{case}_{dt}": lane_cases[dt][case]["launches"].get(
                f"lane_{kind}", 0)
            for dt in ("float64", "float32") for case in cs}
    by_name["lane_primal"]["card_tests"] = lane_cases["card_tests"]
    # the sharded pivot's kernels: launches by path (one a step, every lane
    # of a lane-sharded step in one), the FMA's launches on the same runs
    # (0 on every pivot), the card tests, the walks' windows
    by_name["shard_pivot"]["launches_by_path"] = {
        "9b_rank1_float64": mesh["rank1"]["launches"]["shard_pivot"],
        "9c_bounded_float64": mesh["bounded"]["mesh"]["launches"][
            "shard_pivot"],
        "10a_lp_batch_1x1_float64": batch_mesh["lp_batch_1x1"]["launches"][
            "shard_pivot"],
        "10b_milp_1x1_float64": batch_mesh["milp_1x1"]["launches"][
            "shard_pivot"]}
    by_name["shard_pivot"]["fma_launches_in_pivots"] = {
        "9b_rank1_float64": mesh["rank1"]["launches"]["fused_fma"],
        "9c_bounded_float64": mesh["bounded"]["mesh"]["launches"][
            "fused_fma"],
        "10a_lp_batch_1x1_float64":
            batch_mesh["lp_batch_1x1"]["fma_in_pivots"],
        "10b_milp_1x1_float64": batch_mesh["milp_1x1"]["fma_in_pivots"]}
    by_name["shard_pivot"]["steps_by_kind_9c"] = \
        mesh["bounded"]["shard_pivot"]["steps_by_kind"]
    by_name["shard_pivot"]["card_tests"] = mesh["shard_pivot"]["card_tests"]
    by_name["shard_pivot"]["windows"] = mesh["shard_pivot"]["windows"]
    by_name["shard_vectors"]["launches_by_path"] = {
        "9a_blocked_float64": mesh["blocked"]["launches"]["shard_vectors"]}
    by_name["lane_bounded"]["walk_10c"] = {
        key: batch_mesh["spans"][key] for key in ("walk_seconds", "waves",
                                                  "seconds", "nodes_per_s")}
    for k, names in (
            ("fused_flush", ("flush_kernel<float>", "flush_kernel<double>")),
            ("blocked_inner_block", "inner_block"), ("fused_fma", "fma"),
            ("lane_dual", "lane_dual"), ("lane_primal", "lane_primal"),
            ("rank1_step", "rank1"),
            ("blocked_step", tuple(BLOCKED_KERNELS.values())),
            ("rank1_cluster", tuple(CLUSTER_KERNELS.values())),
            ("blocked_cluster", tuple(BLOCKED_CLUSTER_KERNELS.values())),
            ("blocked_cluster_batch",
             tuple(BLOCKED_CLUSTER_KERNELS.values())),
            ("fused_flush_batch", ("flush_kernel<float,lanes>",
                                   "flush_kernel<double,lanes>")),
            ("blocked_ray_batch", ("blocked_ray_kernel<float>",
                                   "blocked_ray_kernel<double>")),
            ("lane_bounded", "lane_bounded"),
            ("bounded_grid", tuple(BOUNDED_GRID_KERNELS.values())),
            ("rank1_grid", tuple(RANK1_GRID_KERNELS.values())),
            ("blocked_grid", tuple(BLOCKED_GRID_KERNELS.values())),
            ("rank1_cluster_lanes",
             tuple(v for v in CLUSTER_KERNELS.values()
                   if v.endswith(("primal>", "dual>")))),
            ("shard_pivot", "shard_pivot_kernel<"),
            ("shard_vectors", "shard_vectors_kernel<")):
        by_name[k]["ptxas"] = {
            f: v for f, v in ptxas.items()
            if (f in names if isinstance(names, tuple) else names in f)}
    log(json.dumps({"kernels": kernels, "card": smi, "ptxas": ptxas,
                    "main_path": main_path, "tf32_guard": tf32,
                    "solo_walks": solo, "blocked_engine": blocked,
                    "bench": bench, "milp": milp, "exact": exact,
                    "mesh": mesh, "batch_mesh": batch_mesh}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
