#!/usr/bin/env python3
"""Smoke test of the PyTorch port (tpulp_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Builds the two CUDA kernels from tpulp_torch/kernels/csrc (and checks in
their machine code that the f64 flush runs on the FP64 tensor cores and
the f32 flush uses no TF32), holds each against its plain PyTorch version
at the shape the main path gives it (1538 x 3073, float64, K = 128) and at
the bench shape (m = n = 4096, K = 256, float32 and float64), holds the
flush against its plain version on ragged shapes and on a case built to
probe every rule of its scan, solves the Wyndor LP and the whole LP corpus
exactly through ``tpulp_torch.solve_lp``, drives the main path at a real
size (a 1536 x 1536 LP through ``solve_lp(driver="auto")``, which must take
the kernel engine), checks that a caller's TF32 setting does not reach the
engines' products, and runs the kernel engine on the bench instance. Every
phase that fails raises. The line before the last is a JSON summary of the
kernels; the last line is ``{"ok": true, "device": {...}}``. Without CUDA
the script exits non-zero and prints no result. It imports no jax.
"""

from __future__ import annotations

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
    gflop = 2 * T0.shape[0] * T0.shape[1] * U.shape[0] / 1e9
    log(f"# B1 fused_flush {dtype_name} {shape}: ok, max |err| "
        f"{max_abs:.3e}, max err/mag {worst:.3e} (rtol {rtol:g}); kernel "
        f"{ms:.3f} ms = {gflop / ms:.2f} TFLOP/s, plain {plain_ms:.3f} ms = "
        f"{gflop / plain_ms:.2f} TFLOP/s (median of {runs})")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "tflops": gflop / ms, "plain_tflops": gflop / plain_ms}


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


def check_inner_block(state, opts, dtype_name, runs, K):
    """Two blocks of K pivots of the kernel engine from the same state,
    once with the kernels and once with their plain versions: the same
    decisions, and U/V and the flushed T close."""
    import torch

    from tpulp_torch.kernels import (blocked_inner_block,
                                     blocked_inner_block_reference,
                                     fused_flush_reference)
    from tpulp_torch.solve.blocked_kernel import kernel_block, kernel_inputs

    stall = opts.resolved_stall_limit(state.m, state.n)
    inputs = kernel_inputs(state)
    sides = {"kernel": [x.clone() for x in inputs],
             "plain": [x.clone() for x in inputs]}
    plain = dict(inner=blocked_inner_block_reference,
                 flush=fused_flush_reference)
    max_abs = 0.0
    for blk in range(2):
        etas = {}
        for side in sides:
            sides[side], etas[side] = kernel_block(
                sides[side], opts, stall, K,
                **(plain if side == "plain" else {}))
        torch.cuda.synchronize()
        k, p = sides["kernel"], sides["plain"]
        same_iscal = torch.equal(k[9], p[9])
        same_basis = torch.equal(k[6], p[6])
        same_ab = torch.equal(k[7], p[7])
        rels = {"U": _rel(etas["kernel"][0], etas["plain"][0]),
                "V": _rel(etas["kernel"][1], etas["plain"][1]),
                "T": _rel(k[0], p[0])}
        max_abs = max(max_abs, *(float((a - b).abs().max()) for a, b in
                                 zip(etas["kernel"], etas["plain"])))
        log(f"# B2 blocked_inner_block {dtype_name} {tuple(state.T.shape)} "
            f"K={K} block {blk + 1}: iscal "
            f"{k[9].tolist()} vs plain {p[9].tolist()}; basis "
            f"{'same' if same_basis else 'DIFFERENT'}, ab "
            f"{'same' if same_ab else 'DIFFERENT'}; rel err "
            + " ".join(f"{n} {v:.2e}" for n, v in rels.items()))
        if dtype_name == "float64":
            if not (same_iscal and same_basis and same_ab):
                raise AssertionError(f"B2 f64 block {blk + 1}: decisions "
                                     "differ from the plain version")
            bad = {n: v for n, v in rels.items() if v > 1e-10}
            if bad:
                raise AssertionError(f"B2 f64 block {blk + 1}: values "
                                     f"differ beyond 1e-10 relative: {bad}")
        elif blk == 0:
            if not (same_basis and int(k[9][2]) == int(p[9][2])):
                raise AssertionError("B2 f32 block 1: basis or niter differ "
                                     "from the plain version")
        elif not (same_iscal and same_basis):
            log("# B2 float32 block 2: the walk diverged from the plain "
                "version (recorded, not gated)")
    args = list(inputs) + [opts, stall, K]
    ms = cuda_time_ms(lambda: blocked_inner_block(*args), runs)
    plain_ms = cuda_time_ms(lambda: blocked_inner_block_reference(*args),
                            runs)
    log(f"# B2 blocked_inner_block {dtype_name} {tuple(state.T.shape)} "
        f"K={K}: kernel "
        f"{ms:.3f} ms, plain {plain_ms:.3f} ms per block (median of {runs})")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms}


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
    if not all(v > 0 for v in launches.values()):
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
                      "pivots_per_s": sol.niter / secs}


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


def main() -> int:
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

    # 2: build (with nvcc's register and shared-memory report)
    t0 = time.perf_counter()
    lib_path = build(verbose=True)
    load_library()
    log(f"# build: {time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")
    sass = check_machine_code(lib_path)

    kstats = phase_kernels(dev)
    flush_cases = phase_flush_cases(dev)
    phase_small_lps()
    launches, main_path = phase_main_path()
    tf32 = phase_tf32_guard()
    bench = phase_bench(dev)

    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    sources = {
        "fused_flush": ("tpulp_torch/kernels/csrc/flush.cu",
                        "tpulp/kernels/pallas_block.py:491"),
        "blocked_inner_block": ("tpulp_torch/kernels/csrc/inner_block.cu",
                                "tpulp/kernels/pallas_block.py:554"),
    }
    kernels = []
    for kname, (src, repl) in sources.items():
        # the headline numbers are taken at the main path's own shape; the
        # bench shape's ride along
        kernels.append({"name": kname, "route": "cuda", "source": src,
                        "replaces": repl, "launches": launches[kname],
                        **kstats["main_path"][kname],
                        **{case: kstats[case][kname]
                           for case in ("bench_float32", "bench_float64")}})
    kernels[0]["cases"] = flush_cases
    kernels[0]["sass"] = sass
    log(json.dumps({"kernels": kernels, "card": smi,
                    "main_path": main_path, "tf32_guard": tf32,
                    "bench": bench}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
