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
the kernel launches of each wrapper.

Shapes are unpadded: T (M, N) with M = m + 2 and the RHS at column N - 1;
row0/row1/gamma (N,); bvec (M,); ca/ac (N,) int32, zero at the RHS column;
basis/ab (m,) int32; iscal (8,) int32 = [phase, status, niter, stuck,
bland, t, 0, 0]; fscal (2,) = [last_z, 0]. The TPU kernels padded to the
Mosaic tile and kept a transposed copy of T; neither changes a decision,
and the port needs neither.
"""

from __future__ import annotations

import torch

from ..core.precision import full_precision
from ..core.state import RULE_BLAND, RULE_DEVEX, SolverOptions, Status

__all__ = ["LAUNCHES", "reset_launches", "fused_flush",
           "fused_flush_reference", "blocked_inner_block",
           "blocked_inner_block_reference", "BIG_I", "DEVEX_RESET"]

BIG_I = 2 ** 30
DEVEX_RESET = 1e8  # re-anchor the devex reference framework past this

# kernel launches per wrapper; a wrapper counts where it launches its
# kernel and nowhere else
LAUNCHES = {"fused_flush": 0, "blocked_inner_block": 0}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU; raises on a mix, or on a
    device that has no kernel here."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return False
    raise ValueError(f"tensors must all be on the CPU or on one CUDA "
                     f"device; got {sorted(str(t.device) for t in tensors)}")


def _check(t: torch.Tensor, name: str, dtype, shape) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous {dtype} {shape}, got "
                         f"{t.dtype} {tuple(t.shape)}"
                         f"{'' if t.is_contiguous() else ' (strided)'}")


def _lib_for(device: torch.device):
    from .build import load_library

    lib = load_library()
    _raise_on(lib, lib.tpulp_set_device(device.index or 0), "set device")
    return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.tpulp_error_string(err).decode()
        raise RuntimeError(f"tpulp_torch {what}: CUDA error {err} ({msg})")


def _suffix(dtype) -> str:
    if dtype == torch.float32:
        return "f32"
    if dtype == torch.float64:
        return "f64"
    raise ValueError(f"kernels take float32 or float64, not {dtype}")


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
    if _on_cpu(T, U, V, ca):
        return fused_flush_reference(T, U, V, ca, opt_tol, piv_tol)
    M, N = T.shape
    K = U.shape[0]
    _check(T, "T", T.dtype, (M, N))
    _check(U, "U", T.dtype, (K, M))
    _check(V, "V", T.dtype, (K, N))
    _check(ca, "ca", torch.int32, (N,))
    lib = _lib_for(T.device)
    scan = torch.zeros((2, N), dtype=torch.int32, device=T.device)
    stream = torch.cuda.current_stream(T.device).cuda_stream
    fn = getattr(lib, f"tpulp_flush_{_suffix(T.dtype)}")
    _raise_on(lib, fn(T.data_ptr(), U.data_ptr(), V.data_ptr(),
                      ca.data_ptr(), scan.data_ptr(), M, N, K,
                      float(opt_tol), float(piv_tol), stream), "flush")
    LAUNCHES["fused_flush"] += 1
    return T, scan


# ---------------------------------------------------------------------------
# B2: K pivots of one block
# ---------------------------------------------------------------------------

def _first(mask: torch.Tensor) -> int:
    """Smallest index where ``mask`` holds, else BIG_I."""
    ids = torch.arange(mask.shape[0], device=mask.device)
    return int(torch.where(mask, ids, BIG_I).min())


@full_precision()
def blocked_inner_block_reference(T, row0, row1, bvec, ca, ac, basis, ab,
                                  gamma, iscal, fscal, opts: SolverOptions,
                                  stall_limit: int, K: int):
    """Plain version of ``blocked_inner_block``: the TPU kernel's pivot
    loop step by step, with its scalars on the host. Each eta correction
    (entering column, pivot row, cleanup row) accumulates in float64 and
    rounds once to the iterate dtype, as the CUDA kernel does, so that a
    float32 walk does not depend on the order of a sum. Inputs are not
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
        row0 = torch.addcmul(row0, w[0], vrow)
        row1 = torch.addcmul(row1, w[1], vrow)
        bvec = torch.addcmul(bvec, w, vrow[N - 1])
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
                        K: int):
    """Run up to K eta pivots of one block (see the module doc for the
    shapes). Inputs are not modified; returns ``(U, V, row0, row1, bvec,
    ca, ac, basis, ab, gamma, iscal, fscal)``. The pivot budget is the
    caller's: a block may run past it by up to K pivots."""
    args = (T, row0, row1, bvec, ca, ac, basis, ab, gamma, iscal, fscal)
    if _on_cpu(*args):
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
        _check(x, name, dtype, shape)
    lib = _lib_for(T.device)
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
    stream = torch.cuda.current_stream(T.device).cuda_stream
    fn = getattr(lib, f"tpulp_inner_block_{_suffix(dt)}")
    err = fn(T.data_ptr(), U.data_ptr(), V.data_ptr(), row0_o.data_ptr(),
             row1_o.data_ptr(), bvec_o.data_ptr(), ca_o.data_ptr(),
             ac_o.data_ptr(), basis_o.data_ptr(), ab_o.data_ptr(),
             gamma_o.data_ptr(), isc_o.data_ptr(), fsc_o.data_ptr(),
             colj.data_ptr(), rowd.data_ptr(), pv.data_ptr(),
             pint.data_ptr(), M, N, m, K, int(stall_limit),
             int(opts.rule == RULE_BLAND), int(opts.rule == RULE_DEVEX),
             float(opts.opt_tol), float(opts.piv_tol),
             float(opts.infeas_tol), float(opts.degen_tol), stream)
    _raise_on(lib, err, "inner block")
    LAUNCHES["blocked_inner_block"] += 1
    return (U, V, row0_o, row1_o, bvec_o, ca_o, ac_o, basis_o, ab_o,
            gamma_o, isc_o, fsc_o)
