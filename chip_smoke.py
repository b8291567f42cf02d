#!/usr/bin/env python3
"""Smoke test of the PyTorch port (tpulp_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Builds the three CUDA kernels from tpulp_torch/kernels/csrc (and checks
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
Phase 7 drives ``solve_milp`` on bench.py's 28-item knapsack (f32 and f64,
the DP oracle exactly) and on a 5-constraint 40-item knapsack (equal f32
and f64 optima, checked in Fractions) with every wave tensor checked to be
on the card, times a batched pivot at B = 128, and runs ``solve_lp_batch``
cold and warm over 64 RHS scenarios and ``solve_lp(warm_start=)`` at
256 x 512; the f64 bench knapsack must explore tpulp's 789 nodes.
Phase 8 solves a 1024 x 2048 box LP with ``simple_bounds`` (the
bounded-variable simplex, certified, held against the row-lowered solve on
the kernel engine), a batch of 256 box LPs with and without bound rows,
a blocked batch of 8 LPs of 512 x 1024 against their solo solves, the
corpus's infeasible and unbounded cases with verified certificates,
Wyndor's ranging, ``find_iis`` with every oracle solve on the card, and
``python -m tpulp_torch solve`` in a subprocess. Phase 9 brings up a
one-process NCCL group and ``make_mesh(1)``, solves phase 5's LP through
``solve_lp(mesh=...)`` with the sharded blocked driver (which flushes each
rank's block with the flush kernel) and the sharded rank-1 driver (each
certified, the exact objective phase 5's), holds the sharded bounded
driver's Dantzig walk on a 128 x 256 box LP to the solo walk, times the
sharded machinery against the solo blocked driver at P = 1, and holds the
flush against its plain version at the sharded block's shape. Every phase
that fails raises. The line before the last is a JSON summary of
the kernels (each with its bound, its plain version's time and, where one
exists, a library call's); the last line is ``{"ok": true, "device":
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
BOX_M, BOX_N, BOX_LANES = 64, 128, 256
# the row-lowered batch that 8b holds the box batch to: its first lanes
# only (its exact refinement and certificate take ~0.6 s a lane on the
# host, ~150-200 s for all 256), so that the full-size f32 box LP of 8a,
# the card's one run of the ladder's f32-to-f64 retry, fits the time
BOX_ROW_LANES = 64
BLK_M, BLK_N, BLK_LANES, BLK_K = 512, 1024, 8, 64
IIS_VARS, IIS_ROWS = 10, 24
# phase 9, the sharded path over a one-process NCCL group: solve_lp's
# shard_block; the box LP cut to a size Dantzig walks in seconds (PERF.md
# §6: 428 s at 1024 x 2048); the bench shape's budget for the machinery
# ratio
SHARD_K = 64
SHARD_BOX_M, SHARD_BOX_N = 128, 256
SHARD_BENCH_PIVOTS = 1024


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


def check_static_smem(ptxas) -> None:
    """The inner-block kernel's static shared memory (ptxas's report) must
    fit the room ``inner_block_plan`` leaves beside the dynamic share it
    plans, or a plan that fits on paper would not launch."""
    from tpulp_torch.kernels.block import IB_STATIC_SMEM

    got = {k: v.get("static_smem", 0) for k, v in ptxas.items()
           if k.startswith("inner_block")}
    if len(got) != 2 or max(got.values()) > IB_STATIC_SMEM:
        raise AssertionError(f"inner block static shared memory {got}: "
                             f"the plan leaves {IB_STATIC_SMEM} bytes")
    log(f"# inner block static shared memory {got} bytes, within the "
        f"{IB_STATIC_SMEM} the plan leaves")


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
                                 "inner_block_kernelId",
                                 "flush_kernelIf", "flush_kernelId",
                                 "fma_kernelIf", "fma_kernelId",
                                 "barrier_probe_kernel") if k in fn), None)
        if name is None:
            continue
        rec = out.setdefault(name.replace("kernelIf", "kernel<float>")
                             .replace("kernelId", "kernel<double>"), {})
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


# (name, shapes of c, a, b, value): the engines' calls on the card; vmapped
# cases batch a leading dimension of MILP_BATCH lanes
FMA_CASES = [
    ("rank1_pivot_vmap", [(59, 114), (59, 1), (1, 114)], -1.0, True),
    ("rhs_rewrite", [(MILP_BATCH, 59), (MILP_BATCH, 1), (MILP_BATCH, 59)],
     1.0, False),
    ("running_vector", [(3073,), (), (3073,)], 1.0, False),
    ("running_bvec_vmap", [(1538,), (1538,), ()], 1.0, True),
    ("rank1_pivot_big", [(1538, 3073), (1538, 1), (1, 3073)], -1.0, False),
    # phase 8: the bounded driver's pivot and flip at the bounded LP's
    # tableau (1026 x 3073), and the bounded batch's pivot (66 x 193)
    ("bounded_pivot", [(1026, 3073), (1026, 1), (1, 3073)], -1.0, False),
    ("bounded_flip_rhs", [(1026,), (1026,), ()], -1.0, False),
    ("bounded_pivot_vmap", [(66, 193), (66, 1), (1, 193)], -1.0, True),
]


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
        for case, shapes, value, vmapped in FMA_CASES:
            rng = np.random.default_rng(len(stats))
            lead = (MILP_BATCH,) if vmapped else ()
            cpu = [torch.tensor(rng.normal(size=lead + s)).to(dt)
                   for s in shapes]
            gpu = [x.to(dev) for x in cpu]
            if vmapped:
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
                "shape": list(got.shape), "max_abs_err": 0.0, "ms": ms,
                "plain_ms": plain_ms, "plain_on": "cpu",
                "cuda_addcmul_ms": lib_ms, "cuda_addcmul_differs": two,
                "bound_ms": bound_ms, "bound_by": bound_by}
            log(f"# FMA {case} {name} {tuple(got.shape)}: bit for bit the "
                f"CPU's addcmul (CUDA addcmul differs at {two} of "
                f"{got.numel()}); kernel {ms:.4f} ms, CUDA addcmul "
                f"{lib_ms:.4f} ms, plain on the CPU {plain_ms:.4f} ms; "
                f"bound {bound_ms:.5f} ms ({bound_by})")
    return stats


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
        kind = "f64" if "flush_kernelIdE" in fn else "f32"
        c = counts.setdefault(kind, {"DMMA": 0, "HMMA": 0, "FFMA": 0,
                                     "DFMA": 0})
        for key in c:
            if op.startswith(key):
                c[key] += 1
    log(f"# machine code of the flush: {counts}")
    if set(counts) != {"f32", "f64"}:
        raise AssertionError(f"flush kernels not found in the SASS: {counts}")
    if counts["f64"]["DMMA"] == 0:
        raise AssertionError("the f64 flush issues no DMMA")
    if counts["f32"]["HMMA"] or counts["f32"]["DMMA"]:
        raise AssertionError("the f32 flush issues tensor-core instructions")
    if counts["f32"]["FFMA"] == 0:
        raise AssertionError("the f32 flush issues no FFMA")
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
            t0 = time.perf_counter()
            sol, st = tpulp_torch.solve_milp(lp, dtype=dt,
                                             batch_size=MILP_BATCH,
                                             return_stats=True,
                                             device="cuda")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = dict(LAUNCHES)
            fma_launches = launches["fused_fma"]
            if fma_launches == 0:
                raise AssertionError(f"bench knapsack {name}: solve_milp "
                                     "never launched the FMA kernel")
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
                f"took {first:.3f} s; {fma_launches} FMA kernel launches")
            res[f"bench_knapsack_{name}"] = {
                "nodes": st.nodes_solved, "waves": st.waves,
                "gen_waves": st.gen_waves, "warm_nodes": st.warm_nodes,
                "warm_pivots": st.warm_pivots,
                "solo_resolves": st.solo_resolves, "seconds": secs,
                "nodes_per_s": st.nodes_solved / secs,
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


def batched_pivot_ms():
    """ms per batched step (one pivot on every lane) at B = MILP_BATCH on
    the bench knapsack's node tableau, rank-1 and dual, f32 and f64: host
    clock around PIVOT_STEPS synchronised steps, and the device time and
    kernel count per step under torch.profiler."""
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
            res[key] = {"ms": ms, "device_ms": 1e3 * busy / 16,
                        "kernels": kernels / 16,
                        "busy_share": busy / wall}
            log(f"# batched {kind} step, B={MILP_BATCH}, tableau "
                f"{tuple(state.T.shape[1:])} {name}: {ms:.3f} ms per step "
                f"(host clock, mean of {PIVOT_STEPS}); "
                f"device {1e3 * busy / 16:.3f} ms and {kernels / 16:.0f} "
                f"kernels per step, the card busy {100 * busy / wall:.1f}% "
                "of the traced 16 steps (torch.profiler)")
    return res


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


def phase_batch_and_warm():
    """Phase 7c/7d: ``solve_lp_batch`` over SCEN_LANES RHS scenarios of one
    SCEN_M x SCEN_N integer LP, cold and with ``warm_start`` (statuses and
    exact objectives equal lane for lane, fewer pivots warm), then
    ``solve_lp(warm_start=)`` on tests/test_warm_start.py's recipe at
    WARM_M x WARM_N with three rows tightened by 0.8 (the objective within
    one f64 ulp of the cold solve's, fewer pivots)."""
    import math

    import tpulp_torch

    rng = np.random.default_rng(0)
    A = rng.integers(1, 10, size=(SCEN_M, SCEN_N))
    b = A @ rng.integers(0, 3, size=SCEN_N) + rng.integers(1, 20,
                                                           size=SCEN_M)
    c = -rng.integers(1, 10, size=SCEN_N)
    scens = [scenario_form(A, b - rng.integers(0, b // 10 + 2), c)
             for _ in range(SCEN_LANES)]
    base = tpulp_torch.solve_lp(scenario_form(A, b, c), device="cuda")
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

def bounded_form(m: int, n: int, seed: int = 0):
    """bench.py's instance recipe without its sum row (D ~ N(0, 1), b =
    |D x0| + |N(0, 1)|, free-sign c ~ N(0, 1), slack basis) with a finite
    upper bound u_j = 2 x0_j + 1 on every structural, as a simple_bounds
    StandardForm (no bound rows). Returns (form, D, b, u)."""
    rng = np.random.default_rng(seed)
    D = rng.normal(size=(m, n))
    x0 = np.abs(rng.normal(size=n))
    b = np.abs(D @ x0) + np.abs(rng.normal(size=m))
    c = rng.normal(size=n)
    u = 2.0 * x0 + 1.0
    sf = scenario_form(D, b, c)
    return (dataclasses.replace(sf, upper=u.tolist() + [None] * m), D, b,
            u)


def flip_spy():
    """Wraps the bounded step (the name the bounded driver calls) to count
    on the card, without a host read, its entering flips (a step that adds
    a pivot but keeps the basis) and its upper hits (a basis change that
    flips a column). Returns (counts, restore): ``counts()`` reads the two
    totals."""
    import torch

    import tpulp_torch.solve.bounded as bounded

    real = bounded.bounded_simplex_step
    total = []

    def spy(bs, opts, stall_limit, max_iters=None):
        nxt = real(bs, opts, stall_limit, max_iters)
        same = (nxt.s.basis == bs.s.basis).all()
        flip = (nxt.at_upper != bs.at_upper).any()
        step = torch.stack([(nxt.s.niter > bs.s.niter) & same, ~same & flip])
        total[:] = [step.int() + total[0] if total else step.int()]
        return nxt

    def restore():
        bounded.bounded_simplex_step = real

    bounded.bounded_simplex_step = spy
    return (lambda: total[0].tolist() if total else [0, 0]), restore


def bounded_step_window(sf, dev, dtype):
    """(device ms, kernels, host ms) per bounded step (BND_PRICING), from
    16 steps from the initial basis under torch.profiler."""
    import torch

    from tpulp_torch import SolverOptions
    from tpulp_torch.core.state import RULE_DANTZIG, RULE_DEVEX
    from tpulp_torch.solve.api import state_from_standard_form
    from tpulp_torch.solve.bounded import (bounded_simplex_step,
                                           make_bounded_state)

    devex = BND_PRICING == "devex"
    opts = SolverOptions.for_dtype(
        dtype, rule=RULE_DEVEX if devex else RULE_DANTZIG)
    bs = make_bounded_state(state_from_standard_form(sf, dtype=dtype,
                                                     device=dev), sf.upper)
    if devex:
        bs = bs._replace(gamma=torch.ones_like(bs.upper))
    stall = opts.resolved_stall_limit(bs.s.m, bs.s.n)

    def window(bs=bs):
        for _ in range(16):
            bs = bounded_simplex_step(bs, opts, stall, None)

    window()
    wall, busy, kernels = device_busy(window)
    return {"device_ms_per_step": 1e3 * busy / 16,
            "kernels_per_step": kernels / 16,
            "host_ms_per_step": 1e3 * wall / 16}


def phase_bounded_lp(dev):
    """Phase 8a: solve_lp on the BND_M x BND_N box LP with simple_bounds
    (a (BND_M + 2) x (BND_N + BND_M + 1) tableau, no bound rows, priced
    by BND_PRICING) at f64:
    optimal, the f64 bounded certificate, 0 <= x <= u and D x <= b within
    1e-9 relative, columns at upper, and the objective within 1e-9 of the
    row-lowered solve (3 BND_M rows), which takes the kernel engine. The
    same LP at f32: optimal on BND_F32_RUNG (the ladder's f64 retry), its
    answer certified and equal to the f64 solve's. Returns the numbers and
    the FMA launches of the f64 solve."""
    import torch

    import tpulp_torch
    from tpulp_torch.kernels import LAUNCHES, reset_launches
    from tpulp_torch.model.equilibrate import (equilibration_powers_dense,
                                               is_material_scaling)
    from tpulp_torch.model.lower import materialize_simple_bounds
    from tpulp_torch.solve.refine import float_bounded_certificate

    m, n = BND_M, BND_N
    sf, D, b, u = bounded_form(m, n)
    rp, cp = equilibration_powers_dense(
        np.concatenate([D, np.eye(m)], axis=1), basis_hint=sf.basis_hint)
    log(f"# bounded LP {m}x{n}: equilibration material: "
        f"{is_material_scaling(rp, cp)}")
    res = {}
    for dt in (torch.float64, torch.float32):
        name = str(dt).replace("torch.", "")
        window = bounded_step_window(sf, dev, dt)
        counts, restore = flip_spy()
        torch.cuda.synchronize()
        # the bounded LP's main path: counts set to 0 just before the solve
        # and read just after it
        reset_launches()
        t0 = time.perf_counter()
        try:
            sol = tpulp_torch.solve_lp(sf, dtype=dt, device=dev,
                                       pricing=BND_PRICING,
                                       max_iters=BND_MAX_ITERS)
            torch.cuda.synchronize()
        finally:
            restore()
        secs = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        enter, up_hit = counts()
        est_device = window["device_ms_per_step"] * sol.niter / 1e3
        res[name] = {"status": sol.status, "rung": sol.rung,
                     "niter": sol.niter, "seconds": secs,
                     "launches": launches, "entering_flips": enter,
                     "upper_hits": up_hit,
                     "device_seconds_est": est_device, **window,
                     "objective": float(sol.objective)
                     if sol.objective is not None else None}
        log(f"# bounded LP {m}x{n} {name} ({BND_PRICING}): {sol.status}, "
            f"rung {sol.rung}, {sol.niter} steps = {enter} entering flips "
            f"+ {up_hit} upper hits + {sol.niter - enter - up_hit} plain "
            f"pivots (the flip "
            f"counts are over every walk the solve ran); {secs:.2f} s on "
            f"the host clock (set-up, refinement and certificate included) "
            f"against ~{est_device:.3f} s of device time "
            f"({window['device_ms_per_step']:.4f} ms, "
            f"{window['kernels_per_step']:.0f} kernels and "
            f"{window['host_ms_per_step']:.3f} ms of host time a step, "
            "torch.profiler over 16 steps); launches " + str(launches))
        if dt == torch.float32:
            # the retry's answer, certified again and held to the f64
            # solve's objective
            primal_ok, dual_ok = float_bounded_certificate(sf, sol.basis,
                                                           sol.at_upper)
            rel = abs(float(sol.objective) - float(f64_obj)) / max(
                1.0, abs(float(f64_obj)))
            if not (sol.status == "optimal" and sol.rung == BND_F32_RUNG
                    and primal_ok and dual_ok and rel <= 1e-9
                    and launches["fused_fma"] > 0):
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
        if sol.status != "optimal" or launches["fused_fma"] == 0:
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
    return res


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
    equal lane for lane."""
    import torch

    import tpulp_torch

    sfs = [box_form(s, BOX_M, BOX_N) for s in range(BOX_LANES)]
    res = {}
    sols = {}
    for kind, lanes in (("bounded", BOX_LANES), ("rows", BOX_ROW_LANES)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sols[kind] = tpulp_torch.solve_lp_batch(
            sfs[:lanes], simple_bounds=kind == "bounded", device=dev)
        secs = time.perf_counter() - t0
        res[kind] = {"seconds": secs, "lanes": lanes,
                     "lanes_per_s": lanes / secs,
                     "pivots": sum(s.niter for s in sols[kind])}
    rows = sols["rows"]
    bad = [k for k, a in enumerate(sols["bounded"])
           if a.status != "optimal" or (k < BOX_ROW_LANES and (
               rows[k].status != "optimal"
               or a.objective != rows[k].objective))]
    log(f"# solve_lp_batch {BOX_LANES} box LPs {BOX_M}x{BOX_N}: "
        f"simple_bounds {res['bounded']['seconds']:.2f} s = "
        f"{res['bounded']['lanes_per_s']:.1f} lanes/s "
        f"({res['bounded']['pivots']} pivots and flips), row-lowered "
        f"({BOX_M + BOX_N} rows, the first {BOX_ROW_LANES} lanes) "
        f"{res['rows']['seconds']:.2f} s = "
        f"{res['rows']['lanes_per_s']:.1f} lanes/s ({res['rows']['pivots']}"
        " pivots); exact refinement and certificate per lane included; "
        f"exact objectives {'equal' if not bad else 'DIFFER'} lane for lane")
    if bad:
        raise AssertionError(f"bounded batch: lanes {bad[:8]} differ")
    return res


def phase_blocked_batch(dev):
    """Phase 8c: solve_lp_batch(driver="blocked") over BLK_LANES LPs of
    BLK_M x BLK_N at f64 (tests/test_warm_start.py's recipe, seeds 0 to
    BLK_LANES - 1; bench.py's takes more than 10,000 pivots at this size),
    each lane's objective within 1e-9 relative of the solo
    solve_lp(driver="blocked")."""
    import torch

    import tpulp_torch

    sfs = [scenario_form(*dense_leq_arrays(BLK_M, BLK_N, seed=s))
           for s in range(BLK_LANES)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch = tpulp_torch.solve_lp_batch(sfs, driver="blocked", block=BLK_K,
                                       device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    t0 = time.perf_counter()
    solo = [tpulp_torch.solve_lp(sf, driver="blocked", block=BLK_K,
                                 device=dev) for sf in sfs]
    torch.cuda.synchronize()
    solo_secs = time.perf_counter() - t0
    rel = [abs(float(a.objective) - float(s.objective))
           / max(1.0, abs(float(s.objective)))
           if a.is_optimal and s.is_optimal else float("inf")
           for a, s in zip(batch, solo)]
    log(f"# solve_lp_batch(driver='blocked', block={BLK_K}) {BLK_LANES} "
        f"LPs {BLK_M}x{BLK_N} f64: {secs:.2f} s (solo: {solo_secs:.2f} s "
        f"for the {BLK_LANES}); niter batch {[s.niter for s in batch]}, "
        f"solo {[s.niter for s in solo]}; max relative objective "
        f"difference {max(rel):.2e}")
    if max(rel) > 1e-9:
        raise AssertionError(f"blocked batch: lanes differ from solo {rel}")
    return {"seconds": secs, "solo_seconds": solo_secs,
            "niter": [s.niter for s in batch],
            "solo_niter": [s.niter for s in solo]}


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
    if dev == "cuda" and launches["fused_fma"] == 0:
        raise AssertionError(f"mesh {driver}: fused_fma never launched")
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
    """``flip_spy`` for the sharded bounded step: (counts, restore)."""
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


def mesh_bounded(mesh, dev="cuda"):
    """9c: the sharded bounded driver (Dantzig) on phase 8a's box LP at
    SHARD_BOX_M x SHARD_BOX_N, f64, against the solo bounded driver's walk
    on the card: steps, flips, at-upper flags and basis equal, objectives
    within 1e-9. The drivers run bare (at m <= 192 solve_lp's exact
    refinement and certificate of this float data take ~30 s a solve on
    the host)."""
    import torch

    from tpulp_torch import SolverOptions
    from tpulp_torch.kernels import LAUNCHES, reset_launches
    from tpulp_torch.shard import (from_sharded_bounded_state,
                                   run_simplex_sharded_bounded,
                                   to_sharded_bounded_state)
    from tpulp_torch.solve.api import state_from_standard_form
    from tpulp_torch.solve.bounded import (make_bounded_state,
                                           run_simplex_bounded)

    sf = bounded_form(SHARD_BOX_M, SHARD_BOX_N)[0]
    opts = SolverOptions.for_dtype(torch.float64)
    res = {}
    for kind in ("solo", "mesh"):
        bs = make_bounded_state(state_from_standard_form(
            sf, dtype=torch.float64, device=dev), sf.upper)
        counts, restore = (flip_spy if kind == "solo"
                           else sharded_flip_spy)()
        sync(dev)
        reset_launches()
        t0 = time.perf_counter()
        try:
            if kind == "solo":
                out = run_simplex_bounded(bs, opts)
            else:
                out = from_sharded_bounded_state(run_simplex_sharded_bounded(
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
            and (dev != "cuda" or msh["launches"]["fused_fma"] > 0)):
        raise AssertionError("9c: the sharded bounded walk differs from the "
                             "solo walk")
    for r in res.values():
        del r["basis"], r["at_upper"]
    res["relative_difference"] = rel
    return res


def machinery_ratio(mesh, dev="cuda"):
    """9d: the sharded blocked driver at P = 1 against the solo
    run_simplex_blocked, per pivot: on tools/torch_scaling_overhead.py's
    instance, and on the bench shape (f32, K = 256, SHARD_BENCH_PIVOTS)."""
    import importlib.util
    import os

    import torch

    from tpulp_torch import SolverOptions, make_state
    from tpulp_torch.shard import run_simplex_sharded_blocked, to_sharded_state
    from tpulp_torch.solve.blocked import run_simplex_blocked

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                        "torch_scaling_overhead.py")
    spec = importlib.util.spec_from_file_location("torch_scaling_overhead",
                                                  path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    small = tool.measure(dev)
    log(f"# 9d machinery at P = 1, {tool.__name__}'s 66x513 f32 K=16: solo "
        f"{small['solo_us']:.1f} us a pivot, sharded {small['p1_us']:.1f}, "
        f"ratio {small['ratio']:.3f} ({small['pivots']} pivots)")
    c, A, b, hint = bench_arrays(BENCH_M, BENCH_N)
    st = make_state(c, A, b, hint, dtype=torch.float32, device=dev)
    opts = SolverOptions.for_dtype(torch.float32,
                                   max_iters=SHARD_BENCH_PIVOTS)
    sh = to_sharded_state(st, mesh)
    solo_us, n1 = tool._time_best(
        lambda: run_simplex_blocked(st, opts, block=BENCH_K),
        SHARD_BENCH_PIVOTS, 2, "solo bench", dev)
    p1_us, n2 = tool._time_best(
        lambda: run_simplex_sharded_blocked(sh, mesh, opts, block=BENCH_K),
        SHARD_BENCH_PIVOTS, 2, "P=1 bench", dev)
    if n1 != n2:
        raise AssertionError(f"9d: solo {n1} and sharded {n2} pivots")
    log(f"# 9d machinery at P = 1, bench shape {BENCH_M}x{BENCH_M + BENCH_N}"
        f" f32 K={BENCH_K}, {n1} pivots: solo {solo_us:.1f} us a pivot, "
        f"sharded {p1_us:.1f}, ratio {p1_us / solo_us:.3f}")
    return {"scaling_overhead_instance": small,
            "bench": {"solo_us": solo_us, "p1_us": p1_us,
                      "ratio": p1_us / solo_us, "pivots": n1}}


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
        res = {"blocked": mesh_main_path(mesh, sf, "blocked", objective,
                                         dev)}
        window = sharded_window(sf, mesh, torch.float64)
        res["blocked"]["window"] = window
        log(f"# 9a first block under torch.profiler: "
            f"{window['host_ms_per_pivot']:.3f} ms of host time, "
            f"{window['device_ms_per_pivot']:.4f} ms of device time and "
            f"{window['kernels_per_pivot']:.0f} kernels a pivot; the card "
            f"{100 * window['busy_share']:.1f}% busy")
        res["rank1"] = mesh_main_path(mesh, sf, "rank1", objective, dev)
        res["bounded"] = mesh_bounded(mesh, dev)
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

    # 3: the kernels against their plain versions
    kstats = phase_kernels(dev)
    probe = phase_barrier_probe()
    fma_cases = phase_fma(dev)
    flush_cases = phase_flush_cases(dev)
    phase_small_lps()
    # 5: the LP main path; its launch counts are read right after it
    launches, main_path = phase_main_path()
    tf32 = phase_tf32_guard()
    bench = phase_bench(dev)

    # 7: MILP, the batched waves and warm starts (the batched pivots run
    # the FMA kernel); the f64 bench knapsack's timed solve is the MILP
    # main path, its launch counts read right after it
    secs = {}
    t0 = time.perf_counter()
    milp = phase_milp_knapsacks()
    phase_drop_scatters()
    secs["milp"] = time.perf_counter() - t0
    milp["batched_pivot"] = batched_pivot_ms()
    secs["pivot"] = time.perf_counter() - t0 - secs["milp"]
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

    loaded = sorted(m for m in sys.modules if m == "jax"
                    or m.startswith("jax.") or m == "tpulp"
                    or m.startswith("tpulp."))
    if loaded:
        raise AssertionError(f"jax or tpulp modules were imported: {loaded}")
    sources = {
        "fused_flush": ("tpulp_torch/kernels/csrc/flush.cu",
                        "tpulp/kernels/pallas_block.py:491", launches),
        "blocked_inner_block": ("tpulp_torch/kernels/csrc/inner_block.cu",
                                "tpulp/kernels/pallas_block.py:554",
                                launches),
        "fused_fma": ("tpulp_torch/kernels/csrc/fma.cu",
                      "none: XLA's fusion of the rank-1 update "
                      "(tpulp/solve/driver.py)", milp_launches),
    }
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = []
    for kname, (src, repl, counts) in sources.items():
        if kname == "fused_fma":
            head = dict(fma_cases["rank1_pivot_vmap float64"])
            head["library_ms"] = None  # CUDA addcmul rounds twice
            cases = fma_cases
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
    # the FMA kernel runs on two main paths: MILP (its ``launches``) and
    # the bounded LP of phase 8
    kernels[2]["launches_by_path"] = {
        "milp_bench_knapsack_float64": milp_launches["fused_fma"],
        "bounded_lp_float64": bounded_launches["fused_fma"],
        "sharded_blocked_p1_float64":
            mesh["blocked"]["launches"]["fused_fma"],
        "sharded_rank1_p1_float64": mesh["rank1"]["launches"]["fused_fma"],
        "sharded_bounded_p1_float64":
            mesh["bounded"]["mesh"]["launches"]["fused_fma"]}
    # the flush runs on two main paths: the kernel engine of phase 5 (its
    # ``launches``) and the sharded blocked driver of phase 9a, which
    # flushes each rank's (m+2, n/P) block
    kernels[0]["launches_by_path"] = {
        "main_path_kernel_engine": launches["fused_flush"],
        "sharded_blocked_p1_float64":
            mesh["blocked"]["launches"]["fused_flush"]}
    kernels[0]["sharded_block_case"] = {k: mesh["flush"].get(k)
                                        for k in keys}
    kernels[0]["flush_cases"] = flush_cases
    kernels[0]["sass"] = sass
    kernels[1]["barrier_probe"] = probe
    for k, kname in ((0, "flush"), (1, "inner_block"), (2, "fma")):
        kernels[k]["ptxas"] = {f: v for f, v in ptxas.items() if kname in f}
    log(json.dumps({"kernels": kernels, "card": smi, "ptxas": ptxas,
                    "main_path": main_path, "tf32_guard": tf32,
                    "bench": bench, "milp": milp, "exact": exact,
                    "mesh": mesh}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
