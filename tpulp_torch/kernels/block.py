"""The kernel engine's two kernels: wrappers, plain versions, launch counts.

The counterparts of ``tpulp.kernels.pallas_block``:

* ``fused_flush`` (CUDA ``csrc/flush.cu``): the once-per-block
  ``T += U^T V`` in place, with the (2, N) int32 ray-scan columns.
* ``blocked_inner_block`` (CUDA ``csrc/inner_block.cu``): up to K two-phase
  simplex pivots on the implicit tableau ``T0 + U^T V``, all scalars on
  the device.

Each has a plain PyTorch version beside it (``*_reference``), which the
wrapper runs for a tensor on the CPU. For a CUDA tensor the wrapper
launches the kernel or raises; it never falls back. ``LAUNCHES`` counts
the kernel launches of each wrapper. ``inner_block_plan`` decides how the
inner-block kernel lays out a launch: its grid, the rows and columns each
block owns, and whether the block's eta slices stay in shared memory
("resident") or are read from L2 ("streaming").

Shapes are unpadded: T (M, N) with M = m + 2 and the RHS at column N - 1;
row0/row1/gamma (N,); bvec (M,); ca/ac (N,) int32, zero at the RHS column;
basis/ab (m,) int32; iscal (8,) int32 = [phase, status, niter, stuck,
bland, t, 0, 0]; fscal (2,) = [last_z, 0]. The TPU kernels padded to the
Mosaic tile and kept a transposed copy of T; neither changes a decision,
and the port needs neither.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.precision import full_precision
from ..core.state import RULE_BLAND, RULE_DEVEX, SolverOptions, Status
from .fma import fused_fma
from .launch import LAUNCHES, check, lib_for, on_cpu, raise_on, \
    reset_launches, stream_of, suffix

__all__ = ["LAUNCHES", "reset_launches", "fused_flush",
           "fused_flush_reference", "blocked_inner_block",
           "blocked_inner_block_reference", "inner_block_plan",
           "InnerBlockPlan", "barrier_probe", "eta_sum", "BIG_I",
           "DEVEX_RESET"]

BIG_I = 2 ** 30
DEVEX_RESET = 1e8  # re-anchor the devex reference framework past this

# the inner-block kernel's limits (csrc/inner_block.cu) and the card's
IB_MAX_K = 1024
IB_MAX_GRID = 256
SMEM_PER_BLOCK = 232_448  # bytes a block may use on sm_90 (227 KiB)
# the kernel's static reduction scratch, held to this in chip_smoke.py
# against ptxas's report
IB_STATIC_SMEM = 2_048
# the stages of a pivot that ``stage_cycles`` counts (csrc/inner_block.cu)
INNER_BLOCK_STAGES = ("pick", "col_load", "col_dot", "col_reduce",
                      "barrier1", "ratio", "row_load", "row_dot", "update",
                      "update_reduce", "barrier2", "gather", "bookkeeping")


# ---------------------------------------------------------------------------
# B1: the flush
# ---------------------------------------------------------------------------

@full_precision()
def fused_flush_reference(T, U, V, ca, opt_tol: float, piv_tol: float):
    """Plain version of ``fused_flush``: ``T += U^T V`` in place, and the
    scan ``[ca & (T[0] < -opt_tol), any(T[2:] > piv_tol, axis 0)]``."""
    T.add_(U.T @ V)
    scan = torch.stack([
        (ca > 0) & (T[0] < -opt_tol),
        (T[2:] > piv_tol).any(dim=0),
    ]).to(torch.int32)
    return T, scan


def fused_flush(T, U, V, ca, opt_tol: float, piv_tol: float):
    """``T += U^T V`` in place (full FP32/FP64 FMA, no TF32) and the
    (2, N) int32 ray-scan columns; returns ``(T, scan)``."""
    if on_cpu(T, U, V, ca):
        return fused_flush_reference(T, U, V, ca, opt_tol, piv_tol)
    M, N = T.shape
    K = U.shape[0]
    check(T, "T", T.dtype, (M, N))
    check(U, "U", T.dtype, (K, M))
    check(V, "V", T.dtype, (K, N))
    check(ca, "ca", torch.int32, (N,))
    lib = lib_for(T.device)
    scan = torch.zeros((2, N), dtype=torch.int32, device=T.device)
    stream = stream_of(T.device)
    fn = getattr(lib, f"tpulp_flush_{suffix(T.dtype)}")
    raise_on(lib, fn(T.data_ptr(), U.data_ptr(), V.data_ptr(),
                      ca.data_ptr(), scan.data_ptr(), M, N, K,
                      float(opt_tol), float(piv_tol), stream), "flush")
    LAUNCHES["fused_flush"] += 1
    return T, scan


# ---------------------------------------------------------------------------
# B2: K pivots of one block
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class InnerBlockPlan:
    """How one launch of the inner-block kernel is laid out."""

    variant: str       # "resident" or "streaming"
    grid: int          # blocks, one per SM at most
    rows: int          # rows each block owns (RB)
    cols: int          # columns each block owns (CB)
    smem: int          # dynamic shared memory per block, bytes
    barriers_per_pivot: int = 2  # a cleanup or Bland pivot adds one


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _smem(rows: int, cols: int, K: int, resident: bool, tsize: int) -> int:
    """Dynamic shared memory of a launch, as the kernel carves it: the eta
    slices (resident only), the coefficient vector and the copy of
    V[:, N - 1], five column vectors of T, two row vectors of T, and four
    int vectors. The launch passes this figure, and the kernel refuses it
    unless its own count (``inner_block_smem``) agrees."""
    slab = (rows + cols) * K if resident else 0
    return (tsize * (slab + 2 * K + 5 * cols + 2 * rows)
            + 4 * (2 * cols + 2 * rows))


def inner_block_plan(M: int, N: int, K: int, dtype, sms: int,
                     variant: str | None = None) -> InnerBlockPlan:
    """The launch plan of the inner-block kernel for a (M, N) tableau and K
    pivots on a card with ``sms`` SMs: one block per SM (fewer for a small
    tableau, one per 32 rows or columns), each owning ceil(M / G) rows and
    ceil(N / G) columns rounded up to 8; "resident" when the block's eta
    slices U[0:K, rows] and V[0:K, cols] fit in its shared memory, else
    "streaming". ``variant`` forces one (a check runs both). Raises when
    neither can launch."""
    if not 1 <= K <= IB_MAX_K:
        raise ValueError(f"inner block: K = {K} outside [1, {IB_MAX_K}]")
    tsize = {torch.float32: 4, torch.float64: 8}[dtype]
    grid = max(1, min(sms, IB_MAX_GRID, _ceil(max(M, N), 32)))
    rows = 8 * _ceil(_ceil(M, grid), 8)
    cols = 8 * _ceil(_ceil(N, grid), 8)
    room = SMEM_PER_BLOCK - IB_STATIC_SMEM
    fits = {v: _smem(rows, cols, K, v == "resident", tsize) <= room
            for v in ("resident", "streaming")}
    if variant is None:
        variant = next((v for v in ("resident", "streaming") if fits[v]),
                       None)
    if variant is None or not fits.get(variant, False):
        raise ValueError(
            f"inner block: a {M} x {N} tableau at K = {K} ({dtype}) needs "
            f"{_smem(rows, cols, K, variant == 'resident', tsize)} bytes of "
            f"shared memory per block ({rows} rows, {cols} columns), over "
            f"the {room} a block has")
    return InnerBlockPlan(variant, grid, rows, cols,
                          _smem(rows, cols, K, variant == "resident", tsize))


LANES = 32  # a warp: the lanes of one eta sum in the kernel


def eta_sum(coef: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """``coef @ X`` for float64 ``coef`` (t,) and ``X`` (t, n), in the
    inner-block kernel's order: lane q of a warp accumulates k = q, q + 32,
    ... with one fused multiply-add each, then the 32 sums are combined by
    an xor butterfly (at distance 16, 8, 4, 2, 1). The plain version and
    the kernel so agree bit for bit."""
    t, n = X.shape
    acc = torch.zeros((LANES, n), dtype=torch.float64, device=X.device)
    lanes = torch.arange(LANES, device=X.device)
    for k0 in range(0, t, LANES):
        k = k0 + lanes
        live = (k < t)[:, None]
        kc = k.clamp(max=t - 1)
        acc = torch.where(live, fused_fma(acc, coef[kc][:, None], X[kc]),
                          acc)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[lanes ^ off]
    return acc[0]


def _first(mask: torch.Tensor) -> int:
    """Smallest index where ``mask`` holds, else BIG_I."""
    ids = torch.arange(mask.shape[0], device=mask.device)
    return int(torch.where(mask, ids, BIG_I).min())


@full_precision()
def blocked_inner_block_reference(T, row0, row1, bvec, ca, ac, basis, ab,
                                  gamma, iscal, fscal, opts: SolverOptions,
                                  stall_limit: int, K: int,
                                  kernel_order: bool = False):
    """Plain version of ``blocked_inner_block``: the TPU kernel's pivot
    loop step by step, with its scalars on the host. Each eta correction
    (entering column, pivot row, cleanup row) accumulates in float64 and
    rounds once to the iterate dtype, as the CUDA kernel does, so that a
    float32 walk does not depend on the order of a sum; with
    ``kernel_order`` each is summed in the kernel's own order
    (``eta_sum``), and the two agree bit for bit. Inputs are not
    modified; returns ``(U, V, row0, row1, bvec, ca, ac, basis, ab, gamma,
    iscal, fscal)``."""
    M, N = T.shape
    m = M - 2
    dt = T.dtype
    kw = dict(dtype=dt, device=T.device)
    inf = float("inf")
    # the etas are kept in float64 too: every eta correction T0 + coef @ X
    # accumulates in float64 and rounds once to the iterate dtype
    U = torch.zeros((K, M), dtype=torch.float64, device=T.device)
    V = torch.zeros((K, N), dtype=torch.float64, device=T.device)
    T64 = T.to(torch.float64)

    def eta(t0_vec, coef, X):
        if kernel_order:
            return (t0_vec + eta_sum(coef[:t], X[:t])).to(dt)
        return (t0_vec + coef @ X).to(dt)

    row0, row1, bvec = row0.clone(), row1.clone(), bvec.clone()
    ca, basis, ab, gamma = ca.clone(), basis.clone(), ab.clone(), gamma.clone()
    iscal, fscal = iscal.clone(), fscal.clone()
    phase, status, niter, stuck, bland, t = (int(v) for v in
                                             iscal[:6].tolist())
    last_z = fscal[0].clone()
    devex = opts.rule == RULE_DEVEX
    ids_m = torch.arange(M, device=T.device)
    real_cols = torch.arange(N, device=T.device) < N - 1
    ac_v = ac > 0

    for _ in range(K):
        if status != Status.RUNNING:
            break
        in_phase2 = phase == 2
        # ---- cleanup scan ------------------------------------------------
        r_d_raw = _first(ab > 0)
        cleanup = r_d_raw < BIG_I and in_phase2
        r_d = min(r_d_raw, m - 1)
        if cleanup:
            row_d = eta(T64[r_d + 2], U[:, r_d + 2], V)
        else:
            row_d = torch.zeros((N,), **kw)
        ca_v = ca > 0
        j_d = _first(ca_v & ~ac_v & (row_d.abs() > opts.piv_tol))
        has_elig = j_d < BIG_I
        j_d = min(j_d, N - 2)
        retire = cleanup and not has_elig

        # ---- pricing -------------------------------------------------------
        crow = row1 if phase == 1 else row0
        c_eff = torch.where(ca_v, crow, inf)
        improving = c_eff < -opts.opt_tol
        j_bl = _first(improving)
        has_improving = j_bl < BIG_I
        j_bl = min(j_bl, N - 2)
        use_bland = bland > 0 or opts.rule == RULE_BLAND
        if devex:
            score = torch.where(improving, (crow * crow) / gamma, -inf)
            j_dz = min(_first(score >= score.max()), N - 2)
        else:
            j_dz = _first(c_eff <= c_eff.min())
        j_price = j_bl if use_bland else j_dz

        # ---- phase bookkeeping -------------------------------------------
        phase1_done = phase == 1 and not has_improving
        became_infeasible = phase1_done and bool(-row1[N - 1]
                                                 > opts.infeas_tol)
        to_phase2 = phase1_done and not became_infeasible
        pricing_pivot = has_improving and not cleanup and not phase1_done

        # ---- entering column and ratio test --------------------------------
        j = j_d if cleanup else j_price
        jc = min(max(j, 0), N - 1)  # past N only under NaN pricing
        colj = eta(T64[:, jc], V[:, jc], U)
        col = colj[2:]
        pos = col > opts.piv_tol
        has_ratio = bool(pos.any())
        ratios = torch.where(pos, bvec[2:] / torch.where(pos, col, 1.0), inf)
        tie = ratios <= ratios.min()
        if use_bland:
            key = torch.where(tie, basis, BIG_I)
            r_price = _first(key <= key.min())
        else:
            r_price = _first(tie)
        r_price = min(r_price, m - 1)
        became_unbounded = pricing_pivot and not has_ratio and in_phase2
        became_failed1 = pricing_pivot and not has_ratio and not in_phase2

        # ---- the eta pivot -------------------------------------------------
        do_cleanup = cleanup and has_elig
        do_pricing = pricing_pivot and has_ratio
        act = do_cleanup or do_pricing
        actf = 1.0 if act else 0.0
        r = r_d if do_cleanup else r_price
        rg = r + 2
        piv = colj[rg]
        safe_piv = piv if act else torch.ones((), **kw)
        w = ((ids_m == rg).to(dt) - colj) / safe_piv * actf
        if do_cleanup:
            vrow = row_d * actf
        else:
            vrow = eta(T64[rg], U[:, rg], V) * actf
        U[t] = w
        V[t] = vrow

        # ---- running vectors -----------------------------------------------
        # fused multiply-adds (the compiled TPU kernel fuses these too)
        row0 = fused_fma(row0, w[0], vrow)
        row1 = fused_fma(row1, w[1], vrow)
        bvec = fused_fma(bvec, w, vrow[N - 1])
        leaving = int(basis[r])
        j_is_art = 0 <= j < N and bool(ac_v[j])
        if act:
            basis[r] = j
            ab[r] = int(j_is_art)
        if retire:
            ab[r_d] = 0

        # ---- devex weights -------------------------------------------------
        if devex:
            gamma_q = gamma[j] if 0 <= j < N else torch.zeros((), **kw)
            alpha = vrow / safe_piv
            cand = torch.where(real_cols, (alpha * alpha) * gamma_q, 0.0)
            g_new = torch.maximum(gamma, cand) if do_pricing else gamma
            if do_pricing:
                g_new = g_new.clone()
                g_new[leaving] = torch.clamp_min(
                    gamma_q / (safe_piv * safe_piv), 1.0)
            if bool(g_new.max() > DEVEX_RESET) or to_phase2:
                g_new = torch.ones_like(g_new)
            gamma = g_new

        # ---- stall / Bland switch, phase change, status --------------------
        z = -row1[N - 1] if phase == 1 else -row0[N - 1]
        if do_pricing:
            stuck = 0 if bool((last_z - z) > opts.degen_tol) else stuck + 1
            last_z = z
        bland = int(bland > 0 or stuck >= stall_limit)
        if to_phase2:
            phase = 2
            ca = torch.where(ac_v, 0, ca).to(torch.int32)
            stuck = 0
            last_z = torch.full((), inf, **kw)
        finished_opt = in_phase2 and not has_improving and not cleanup
        finite_ok = bool(
            torch.isfinite(z) & torch.isfinite(bvec.abs().sum())
            & torch.isfinite(torch.where(ca_v, crow.abs(), 0.0).sum()))
        if not finite_ok:
            status = Status.NUMERIC
        elif became_infeasible or became_failed1:
            status = Status.INFEASIBLE
        elif became_unbounded:
            status = Status.UNBOUNDED
        elif finished_opt:
            status = Status.OPTIMAL
        niter += int(act)
        t += int(act)

    iscal[:6] = torch.tensor([phase, status, niter, stuck, bland, t],
                             dtype=torch.int32)
    fscal[0] = last_z
    return (U.to(dt), V.to(dt), row0, row1, bvec, ca, ac, basis, ab, gamma,
            iscal, fscal)


def blocked_inner_block(T, row0, row1, bvec, ca, ac, basis, ab, gamma,
                        iscal, fscal, opts: SolverOptions, stall_limit: int,
                        K: int, variant: str | None = None,
                        stage_cycles: torch.Tensor | None = None):
    """Run up to K eta pivots of one block (see the module doc for the
    shapes). Inputs are not modified; returns ``(U, V, row0, row1, bvec,
    ca, ac, basis, ab, gamma, iscal, fscal)``. The pivot budget is the
    caller's: a block may run past it by up to K pivots. ``variant``
    overrides ``inner_block_plan``'s choice (a check runs both).
    ``stage_cycles``, an int64
    tensor of ``len(INNER_BLOCK_STAGES)`` on the card, accumulates block
    0's SM cycles per stage of every pivot (a measurement; the kernel runs
    the same walk)."""
    args = (T, row0, row1, bvec, ca, ac, basis, ab, gamma, iscal, fscal)
    if on_cpu(*args):
        return blocked_inner_block_reference(*args, opts, stall_limit, K)
    M, N = T.shape
    m = M - 2
    dt = T.dtype
    for name, x, dtype, shape in (
            ("T", T, dt, (M, N)), ("row0", row0, dt, (N,)),
            ("row1", row1, dt, (N,)), ("bvec", bvec, dt, (M,)),
            ("ca", ca, torch.int32, (N,)), ("ac", ac, torch.int32, (N,)),
            ("basis", basis, torch.int32, (m,)),
            ("ab", ab, torch.int32, (m,)), ("gamma", gamma, dt, (N,)),
            ("iscal", iscal, torch.int32, (8,)), ("fscal", fscal, dt, (2,))):
        check(x, name, dtype, shape)
    suffix(dt)
    plan = inner_block_plan(
        M, N, K, dt, torch.cuda.get_device_properties(
            T.device).multi_processor_count, variant)
    lib = lib_for(T.device)
    kw = dict(dtype=dt, device=T.device)
    U = torch.zeros((K, M), **kw)
    V = torch.zeros((K, N), **kw)
    outs = [x.clone() for x in (row0, row1, bvec, ca, ac, basis, ab, gamma,
                                iscal, fscal)]
    row0_o, row1_o, bvec_o, ca_o, ac_o, basis_o, ab_o, gamma_o, isc_o, \
        fsc_o = outs
    colj = torch.empty((M,), **kw)
    rowd = torch.empty((N,), **kw)
    slots = lib.tpulp_inner_block_slots()
    pv = torch.empty((slots,), **kw)
    pint = torch.empty((2 * slots,), dtype=torch.int32, device=T.device)
    resident = plan.variant == "resident"
    gslab = None if resident else torch.empty(
        (plan.grid * (plan.rows + plan.cols) * K,), **kw)
    bar = torch.zeros((1,), dtype=torch.int32, device=T.device)
    if stage_cycles is not None:
        check(stage_cycles, "stage_cycles", torch.int64,
              (lib.tpulp_inner_block_stages(),))
    stream = stream_of(T.device)
    fn = getattr(lib, f"tpulp_inner_block_{suffix(dt)}")
    err = fn(T.data_ptr(), U.data_ptr(), V.data_ptr(), row0_o.data_ptr(),
             row1_o.data_ptr(), bvec_o.data_ptr(), ca_o.data_ptr(),
             ac_o.data_ptr(), basis_o.data_ptr(), ab_o.data_ptr(),
             gamma_o.data_ptr(), isc_o.data_ptr(), fsc_o.data_ptr(),
             colj.data_ptr(), rowd.data_ptr(), pv.data_ptr(),
             pint.data_ptr(), 0 if resident else gslab.data_ptr(),
             bar.data_ptr(),
             0 if stage_cycles is None else stage_cycles.data_ptr(),
             M, N, m, K, plan.grid, plan.rows, plan.cols,
             int(resident), plan.smem, int(stall_limit),
             int(opts.rule == RULE_BLAND), int(opts.rule == RULE_DEVEX),
             float(opts.opt_tol), float(opts.piv_tol),
             float(opts.infeas_tol), float(opts.degen_tol), stream)
    raise_on(lib, err, "inner block")
    LAUNCHES["blocked_inner_block"] += 1
    return (U, V, row0_o, row1_o, bvec_o, ca_o, ac_o, basis_o, ab_o,
            gamma_o, isc_o, fsc_o)


def barrier_probe(n: int, barrier: str, device="cuda") -> float:
    """Milliseconds of one grid barrier, ``"flag"`` (the inner-block
    kernel's: a release/acquire counter) or ``"grid_sync"``
    (cooperative_groups): a persistent cooperative launch of one 256-thread
    block per SM that does ``n`` barriers and nothing else, timed with CUDA
    events. A measurement tool, not part of any path."""
    dev = torch.device(device)
    lib = lib_for(dev)
    grid = torch.cuda.get_device_properties(dev).multi_processor_count
    bar = torch.zeros((1,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        bar.zero_()
        raise_on(lib, lib.tpulp_barrier_probe(
            bar.data_ptr(), n, int(barrier == "flag"), grid, stream),
            "barrier probe")

    launch()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    launch()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / n
