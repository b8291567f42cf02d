"""Sharded rank-K blocked simplex: eta blocks on the column-partitioned path.

The counterpart of ``tpulp.shard.sharded_blocked``. The product-form eta
scheme of ``solve/blocked.py`` over the layout of ``shard/sharded.py``:

* the eta factors are split like the tableau: the elimination vectors
  ``U`` (K, m+2) and the pivot rows' RHS entries ``vr`` (K,) are
  replicated, the pivot-row slices ``Vl`` (K, n/P) are this shard's;
* per pivot, two collectives, each a latency round the next depends on:
  one all_gather of each shard's packed pricing candidates (the (value,
  index) pair of Dantzig or devex, the first improving column for
  Bland, the first cleanup-eligible column; ``gather_candidates``, which
  the rank-1 and bounded drivers share); then ONE fused psum
  of m+2+K+1 lanes, in which the entering column's owner contributes the
  column's block-start slice, its eta column ``Vl[:, j]`` and its
  artificial flag (devex adds its weight as one more lane, and one scalar
  pmax for the frame reset). tpulp makes the first round of two
  all_gathers and two pmins; they are independent, and torch pays a
  launch per call, so they ride one gather here;
* the replicated ``art_basic`` vector is seeded by one (m,) psum per block
  and kept exact per pivot from the fused psum's flag lane;
* once per K pivots each shard flushes its block in place, ``T += U^T
  Vl``, and ray-scans it, with the B1 kernel ``kernels.block.fused_flush``
  (its plain version on CPU tensors), and ``rhs += U^T vr`` as a plain
  product; the ray flag and the pricing row's non-finite guard ride one
  packed 2-lane psum.

The decisions are those of ``solve/blocked.py`` (and tpulp's sharded
driver), so the walk is the solo blocked driver's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..comm.collectives import MeshAxis
from ..core.precision import full_precision
from ..core.state import (RULE_BLAND, RULE_DEVEX, SolverOptions, Status,
                          eta_scaled_options)
from ..kernels.block import DEVEX_RESET, fused_flush
from ..kernels.shard_pivot import shard_vectors
from ..solve.driver import (BIG_I, finish, put, ratio_rows, status_select,
                             take)
from .sharded import (ShardedState, _check_device, art_basic_scan,
                      gather_candidates, local_ids, retire_dependent)

__all__ = ["run_simplex_sharded_blocked"]


class _ShardedBlockCarry(NamedTuple):
    s: ShardedState          # s.T and s.rhs: the block-start values
    U: torch.Tensor          # (K, m+2) replicated eta vectors
    Vl: torch.Tensor         # (K, n_local) this shard's pivot-row slices
    vr: torch.Tensor         # (K,) replicated pivot-row RHS entries
    t: torch.Tensor          # () int32: etas accumulated this block
    row0: torch.Tensor       # (n_local,) current phase-2 objective slice
    row1: torch.Tensor       # (n_local,) current phase-1 objective slice
    bvec: torch.Tensor       # (m+2,) current RHS column, replicated
    gamma: torch.Tensor      # (n_local,) devex weights (ones unless devex)
    art_basic: torch.Tensor  # (m,) bool, replicated: basic artificials


def _fetch_col_and_eta(T_local, Vl, j, lay: MeshAxis, art_cols, gamma=None):
    """The entering column's block-start slice, its eta column, its
    artificial flag and (devex) its weight, in ONE psum of m+2+K+1(+1)
    lanes from the owner shard."""
    n_local = T_local.shape[1]
    nrows = T_local.shape[0]
    K = Vl.shape[0]
    owner = (j // n_local) == lay.index
    j_local = j % n_local
    parts = [take(T_local, j_local, 1), take(Vl, j_local, 1),
             take(art_cols, j_local).to(T_local.dtype)[None]]
    if gamma is not None:
        parts.append(take(gamma, j_local)[None])
    out = lay.psum(torch.where(owner, torch.cat(parts), 0.0))
    gamma_j = out[nrows + K + 1] if gamma is not None else None
    return out[:nrows], out[nrows:nrows + K], out[nrows + K] > 0.5, gamma_j


def _sharded_blocked_pivot(carry: _ShardedBlockCarry, opts: SolverOptions,
                           stall_limit: int, n_global: int, max_iters: int,
                           lay: MeshAxis) -> _ShardedBlockCarry:
    s = carry.s
    dtype = s.T.dtype
    n_local = s.T.shape[1]
    nrows = s.T.shape[0]
    ax = lay.index
    inf = float("inf")
    running = s.status == Status.RUNNING
    in_phase2 = s.phase == 2
    ids = local_ids(n_local, lay, s.T.device)
    use_devex = opts.rule == RULE_DEVEX

    # ---- cleanup scan on the replicated, exactly kept art_basic ----------
    art_basic = carry.art_basic
    cleanup = art_basic.any() & in_phase2 & running
    r_d = torch.argmax(art_basic.to(torch.int32))
    row_d = torch.where(
        cleanup,
        take(s.T, r_d + 2, 0) + take(carry.U, r_d + 2, 1) @ carry.Vl, 0.0)
    elig = s.col_active & ~s.art_cols & (row_d.abs() > opts.piv_tol)
    l_first_elig = torch.where(elig, ids, BIG_I).min()

    # ---- pricing on the maintained objective-row slices ------------------
    crow = torch.where(s.phase == 1, carry.row1, carry.row0)
    c_eff = torch.where(s.col_active, crow, inf)
    improving_l = c_eff < -opts.opt_tol
    l_first = torch.where(improving_l, ids, n_global).min()
    if use_devex:
        score = torch.where(improving_l, (crow * crow) / carry.gamma, -inf)
        l_val, l_arg = score.max(), torch.argmax(score)
    else:
        l_val, l_arg = c_eff.min(), torch.argmin(c_eff)
    g_vals, g_idxs, j_bland, j_d = gather_candidates(
        l_val, l_arg + ax * n_local, l_first, l_first_elig, lay)
    # the first best in shard order: first-index ties across shards
    k = torch.argmax(g_vals) if use_devex else torch.argmin(g_vals)
    has_improving = (j_bland < n_global) if use_devex \
        else take(g_vals, k) < -opts.opt_tol
    use_bland = s.bland | (opts.rule == RULE_BLAND)
    j_price = torch.where(use_bland, torch.clamp_max(j_bland, n_global - 1),
                          take(g_idxs, k))

    # ---- cleanup decisions ------------------------------------------------
    has_elig, retire, j_d, art_cols = retire_dependent(s, cleanup, r_d, j_d,
                                                       n_global, lay)

    # ---- phase bookkeeping --------------------------------------------------
    z1 = -carry.bvec[1]
    phase1_done = (s.phase == 1) & ~has_improving & running
    became_infeasible = phase1_done & (z1 > opts.infeas_tol)
    to_phase2 = phase1_done & ~became_infeasible
    pricing_pivot = has_improving & ~cleanup & ~phase1_done & running

    # ---- the entering column (one fused psum) and the ratio test -----------
    j = torch.where(cleanup, j_d, j_price)
    tcol, vj, enter_art, gamma_j = _fetch_col_and_eta(
        s.T, carry.Vl, j, lay, s.art_cols,
        carry.gamma if use_devex else None)
    colj = tcol + vj @ carry.U
    has_ratio, r_price = ratio_rows(colj[2:], carry.bvec[2:], s.basis,
                                    opts.piv_tol, use_bland)
    became_unbounded = pricing_pivot & ~has_ratio & in_phase2
    became_failed1 = pricing_pivot & ~has_ratio & ~in_phase2

    # ---- the one (possibly zero) eta pivot --------------------------------
    do_cleanup = cleanup & has_elig
    do_pricing = pricing_pivot & has_ratio
    act = (do_cleanup | do_pricing) & (s.niter < max_iters)
    actf = act.to(dtype)
    r = torch.where(do_cleanup, r_d, r_price)
    rg = r + 2
    safe_piv = torch.where(act, take(colj, rg), 1.0)
    onehot = (torch.arange(nrows, device=s.T.device) == rg).to(dtype)
    w = torch.where(act, (onehot - colj) / safe_piv, 0.0)
    # the pivot row's local slice (for a cleanup pivot it equals row_d)
    vrow = (take(s.T, rg, 0) + take(carry.U, rg, 1) @ carry.Vl) * actf
    vrow_rhs = (take(s.rhs, rg) + take(carry.U, rg, 1) @ carry.vr) * actf
    t = carry.t.reshape(1).long()
    U = carry.U.index_copy(0, t, w[None, :])
    Vl = carry.Vl.index_copy(0, t, vrow[None, :])
    vr = carry.vr.index_copy(0, t, vrow_rhs[None])

    # ---- the running vectors: one rounding each, as XLA fuses them --------
    row0, row1, bvec = shard_vectors(carry.row0, carry.row1, carry.bvec, w,
                                     vrow, vrow_rhs)

    basis = torch.where(act, put(s.basis, r, j), s.basis)
    # retirement clears its row; a pivot installs the entering column's
    # artificial flag (the fused psum's lane) at row r
    art_basic_n = torch.where(retire, put(art_basic, r_d, False), art_basic)
    art_basic_n = torch.where(act, put(art_basic_n, r, enter_art),
                              art_basic_n)

    # ---- devex weights (post-pivot row r = vrow / piv, local slice) --------
    if use_devex:
        alpha = vrow / safe_piv
        cand_w = (alpha * alpha) * gamma_j
        upd = do_pricing & act
        gamma = torch.where(upd, torch.maximum(carry.gamma, cand_w),
                            carry.gamma)
        leaving = take(s.basis.long(), r)  # the pre-pivot basis, replicated
        owner_lv = (leaving // n_local) == ax
        leave_val = torch.clamp_min(gamma_j / (safe_piv * safe_piv), 1.0)
        gamma = torch.where(upd & owner_lv,
                            put(gamma, leaving % n_local, leave_val), gamma)
        # re-anchor on a global overflow or the phase change; the pmax keeps
        # every shard's decision the same
        reset = (lay.pmax(gamma.max()) > DEVEX_RESET) | to_phase2
        gamma = torch.where(reset, torch.ones_like(gamma), gamma)
    else:
        gamma = carry.gamma

    # ---- stall / Bland switch against the current objective ----------------
    z = torch.where(s.phase == 1, -bvec[1], -bvec[0])
    improved = (s.last_z - z) > opts.degen_tol
    stuck = torch.where(do_pricing & act,
                        torch.where(improved, 0, s.stuck + 1),
                        s.stuck).to(torch.int32)
    last_z = torch.where(do_pricing & act, z, s.last_z)
    bland = s.bland | (stuck >= stall_limit)

    # ---- phase transition + termination -----------------------------------
    phase = torch.where(to_phase2, 2, s.phase).to(torch.int32)
    col_active = torch.where(to_phase2, s.col_active & ~art_cols,
                             s.col_active)
    stuck = torch.where(to_phase2, 0, stuck).to(torch.int32)
    last_z = torch.where(to_phase2, inf, last_z)

    finished_opt = in_phase2 & ~has_improving & ~cleanup & running
    # replicated values only: the sharded pricing row's guard runs at the
    # flush, before the loop can exit on a bogus status
    finite_ok = torch.isfinite(z) & torch.isfinite(bvec[2:].abs().sum())
    new_status = status_select(finite_ok, became_infeasible | became_failed1,
                               became_unbounded, finished_opt)
    status = torch.where(running, new_status, s.status)

    s = ShardedState(
        T=s.T,
        rhs=s.rhs,
        basis=basis,
        col_active=col_active,
        art_cols=art_cols,
        phase=phase,
        status=status,
        niter=s.niter + act.to(torch.int32),
        stuck=stuck,
        bland=bland,
        last_z=last_z,
    )
    return _ShardedBlockCarry(
        s=s, U=U, Vl=Vl, vr=vr, t=carry.t + act.to(torch.int32),
        row0=row0, row1=row1, bvec=bvec, gamma=gamma, art_basic=art_basic_n)


def _fresh_carry(s: ShardedState, K: int, lay: MeshAxis,
                 gamma=None) -> _ShardedBlockCarry:
    """A block's start: zero etas, the objective rows and RHS read from the
    block-start tableau, ``art_basic`` seeded by one (m,) psum."""
    M, n_local = s.T.shape
    kw = dict(dtype=s.T.dtype, device=s.T.device)
    return _ShardedBlockCarry(
        s=s,
        U=torch.zeros((K, M), **kw),
        Vl=torch.zeros((K, n_local), **kw),
        vr=torch.zeros((K,), **kw),
        t=torch.zeros((), dtype=torch.int32, device=s.T.device),
        row0=s.T[0, :].clone(),
        row1=s.T[1, :].clone(),
        bvec=s.rhs.clone(),
        gamma=torch.ones((n_local,), **kw) if gamma is None else gamma,
        art_basic=art_basic_scan(s, lay),
    )


def _flush(carry: _ShardedBlockCarry, opts: SolverOptions,
           lay: MeshAxis) -> ShardedState:
    """The block's end: ``T += U^T Vl`` in place and the ray scan on each
    shard (``fused_flush``), ``rhs += U^T vr``, then one 2-lane psum of the
    (ray, non-finite) flags and the status they imply."""
    s = carry.s
    ca = s.col_active.to(torch.int32)
    T, scan = fused_flush(s.T, carry.U, carry.Vl, ca, opts.opt_tol,
                          opts.piv_tol)
    rhs = s.rhs + carry.U.T @ carry.vr
    # an improving active column with no entry above piv_tol
    ray_local = ((scan[0] > 0) & (scan[1] == 0)).any()
    bad_local = ~torch.isfinite(
        torch.where(s.col_active, T[0].abs(), 0.0).sum())
    packed = lay.psum(torch.stack([ray_local.to(torch.int32),
                                   bad_local.to(torch.int32)]))
    ray = ((packed[0] > 0) & ~carry.art_basic.any() & (s.phase == 2)
           & (s.status == Status.RUNNING))
    status = torch.where(packed[1] > 0, Status.NUMERIC,
                         torch.where(ray, Status.UNBOUNDED, s.status))
    return s._replace(T=T, rhs=rhs, status=status.to(torch.int32))


@full_precision()
def run_simplex_sharded_blocked(sh: ShardedState, mesh,
                                opts: SolverOptions | None = None,
                                block: int = 64,
                                axis="cols") -> ShardedState:
    """Run the sharded rank-K driver to termination or ``opts.max_iters``
    (every process of the mesh calls it with its own shard; the host reads
    the replicated status once per block). ``sh`` is left as it is."""
    if opts is None:
        opts = SolverOptions.for_dtype(sh.T.dtype)
    opts = eta_scaled_options(opts, sh.T.dtype)
    _check_device(sh.T, mesh)
    lay = MeshAxis(mesh, axis)
    m = sh.basis.shape[0]
    n_global = sh.T.shape[1] * lay.size
    stall_limit = opts.resolved_stall_limit(m, n_global)
    max_iters = opts.max_iters
    # the flush updates the block in place: work on a copy
    carry = _fresh_carry(sh._replace(T=sh.T.clone()), block, lay)
    while True:
        s = carry.s
        status, niter = torch.stack([s.status, s.niter]).tolist()
        if status != Status.RUNNING or niter >= max_iters:
            break
        for _ in range(block):
            carry = _sharded_blocked_pivot(carry, opts, stall_limit,
                                           n_global, max_iters, lay)
        # devex weights persist across the flush boundary
        carry = _fresh_carry(_flush(carry, opts, lay), block, lay,
                             carry.gamma)
    return finish(carry.s)
