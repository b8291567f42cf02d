"""The solo rank-1, devex and dual walks' record and plain stages: the
walks' steps cut at their global dependencies, stage by stage, which the
grid and cluster walks (``kernels.rank1_grid``, ``kernels.rank1_cluster``)
compose as their plain versions.

``solve.driver.simplex_step`` and ``solve.devex.devex_simplex_step`` are
branchless transitions of ~100-250 small tensor ops and one FMA launch.
Their work has three global dependencies: the entering column (pricing
over every column), the leaving row (the ratio test over that column) and
the pivot itself. Cut there, as ``kernels.bounded`` cuts the bounded step,
a step is a few stages that read and write one walk record:

- **scan** (only for the greatest increase and devex): the column pass
  where the step needs one, else a no-op: every column's minimum ratio
  (the greatest increase, every step) or whether it has an entry above
  ``piv_tol`` (devex's exposed-ray scan, on ``niter % 64 == 0`` in phase
  2), as one partial per chunk of rows (``SCAN_CHUNKS``) and column;
- **price**: the clean-up scan for basic artificials, pricing (Dantzig,
  Bland's first improving column, the greatest increase, or devex ``c^2 /
  gamma`` with the half-period Dantzig probe), the exposed ray, the phase
  bookkeeping and the finiteness sum of the pre-step pricing row;
- **ratio**: the ratio test with first-index or largest-pivot ties
  (Bland's smallest basic index under Bland), and the snapshot of the
  pivot's column and its normalised row, so that the update runs in place;
- **update** (elementwise): ``fma(-col[i], prow[k], T[i, k])``, the pivot
  row set to ``prow``, the entering column to the exact unit vector;
- **finish**: the basis, the retire, the devex weights and their resets,
  the stall counter and the Bland switch, the phase change, the finiteness
  sums and the status.

``solve.dual.dual_simplex_step`` cuts the same way, with no scan: its
price picks the leaving row (the most negative ``b_r``, the first negative
one under Bland) and checks the pre-step objective row, its ratio picks
the entering column (the smallest ``c_j / -T[r, j]`` over ``T[r, j] <
-piv_tol``) and snapshots the pivot, the update is the primal's, and its
finish sets the basis, the stall counter against the dual objective, the
Bland switch and the status.

The record (``Rank1Record``) holds the walk's state (copies of the
caller's tensors, which are never written), the step's verdict (``ints``
past the scalars, ``vals``), the snapshot and the scan's partials. A
record's ``walk`` says which step it takes: "devex" (with the weights
``gamma``) ``devex_simplex_step``, "dual" ``dual_simplex_step``, "primal"
``simplex_step`` under ``opts.rule`` and ``opts.tie_break``. The walks'
constants (``RAY_SCAN_EVERY``, ``SCAN_CHUNKS``, ``RESET_ABOVE``) are
defined here and reach the kernels through their argument arrays. Every
stage returns at once unless the record's status is RUNNING and its
``niter`` is below the budget, so a budget holds exactly, as in
``solve.driver.run_chunked``.

Composed, the plain stages (``rank1_{scan,price,ratio,update,finish}_
reference``) give the plain step bit for bit (``T + 0.0``) in every field.
They take the bounded stages' one liberty: a step that pivots nowhere (a
phase change, a retire, an exit) skips the plain step's redirected pivot
on (row 2, ``basis[0]``) when that pivot is an exact no-op
(``kernels.bounded.noop_exact``): it could then change only the sign of a
zero. Nothing on the solver's path calls the plain stages: ``solve.driver``
runs the plain step on CPU tensors and the kernels (by its route rule) on
CUDA tensors. ``_check`` is the kernels' shared check of a walk's state.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.state import (RULE_BLAND, RULE_MAX_INCREASE, TIE_MAXPIV,
                          SimplexState, SolverOptions, Status)
# the records share their first fields (phase, status, niter) and gate
from .bounded import BIG_I, _first_true, _live, noop_exact
from .fma import fused_fma
from .launch import suffix

__all__ = ["Rank1Record", "make_record", "record_state", "clone_record",
           "scans",
           "rank1_scan_reference", "rank1_price_reference",
           "rank1_ratio_reference", "rank1_update_reference",
           "rank1_finish_reference", "rank1_stage_reference",
           "rank1_step_reference", "STAGES", "WALKS", "SCAN_CHUNKS",
           "RESET_ABOVE", "RAY_SCAN_EVERY"]

RESET_ABOVE = 1e8  # solve.devex: re-anchor the devex frame past this weight
RAY_SCAN_EVERY = 64  # solve.devex: the ray scan and probe cadence
SCAN_CHUNKS = 16  # row chunks of the column pass (the scan stage)

# the record's int32 fields: the walk's scalars, then the step's verdict
# (price writes CLEANUP..RAY, ratio the rest)
PHASE, STATUS, NITER, STUCK, BLAND = range(5)
(CLEANUP, R_D, HAS_ELIG, J, HAS_IMPROVING, PHASE1_DONE, INFEASIBLE,
 TO_PHASE2, PRICING_PIVOT, CROW_OK, RETIRE, RAY,
 DO_PIVOT, DO_PRICING, R, LEAVING, PV, RG, JP, UNBOUNDED,
 FAILED1, FEASIBLE) = range(5, 27)
NI = 27
# the record's values in the tableau's type
LAST_Z, PIV, GAMMA_Q = range(3)
NV = 3
STAGES = ("scan", "price", "ratio", "update", "finish")
# the steps a record walks (csrc/rank1_grid.cu's and rank1_cluster.cu's
# Walk)
WALKS = ("primal", "devex", "dual")
# basis values go through the tableau's type in Bland's row tie: exact in
# float32 below 2^24
_MAX_SIDE = 1 << 24


class Rank1Record(NamedTuple):
    """One walk's state on one device, updated in place by the stages."""

    T: torch.Tensor           # (M, N) the walk's tableau
    basis: torch.Tensor       # (m,) int32
    col_active: torch.Tensor  # (n,) bool
    art_cols: torch.Tensor    # (n,) bool
    gamma: torch.Tensor | None  # (n,) devex weights, or None
    ints: torch.Tensor        # (NI,) int32: scalars and verdict
    vals: torch.Tensor        # (NV,) last_z and the step's values
    snap: torch.Tensor        # (M + N,) column jp | prow
    scan: torch.Tensor | None  # (SCAN_CHUNKS * n,) the column pass
    walk: str = "primal"      # one of WALKS


def scans(opts: SolverOptions, walk: str) -> bool:
    """Whether the walk's steps have a column pass (a scan stage)."""
    return walk == "devex" or (walk == "primal"
                               and opts.rule == RULE_MAX_INCREASE)


def make_record(state: SimplexState, opts: SolverOptions,
                gamma: torch.Tensor | None = None,
                dual: bool = False) -> Rank1Record:
    """A record of ``state`` for the dual walk (``dual``), the devex walk
    (weights ``gamma``) or the primal walk: copies of its tensors, the
    scan's partials where the walk scans."""
    if dual and gamma is not None:
        raise ValueError("the dual walk takes no devex weights")
    walk = "dual" if dual else "primal" if gamma is None else "devex"
    T = state.T
    M, N = T.shape
    n = N - 1
    dev = T.device
    ints = torch.zeros((NI,), dtype=torch.int32, device=dev)
    ints[:BLAND + 1] = torch.stack([state.phase, state.status, state.niter,
                                    state.stuck,
                                    state.bland.to(torch.int32)])
    vals = torch.zeros((NV,), dtype=T.dtype, device=dev)
    vals[LAST_Z] = state.last_z
    return Rank1Record(
        T=T.clone(memory_format=torch.contiguous_format),
        basis=state.basis.clone(), col_active=state.col_active.clone(),
        art_cols=state.art_cols.clone(),
        gamma=None if gamma is None else gamma.clone(),
        ints=ints, vals=vals,
        snap=torch.zeros((M + N,), dtype=T.dtype, device=dev),
        scan=(torch.zeros((SCAN_CHUNKS * n,), dtype=T.dtype, device=dev)
              if scans(opts, walk) else None),
        walk=walk)


def record_tensors(rec: Rank1Record):
    """(name, tensor) of the record's tensors."""
    return [(k, x) for k, x in zip(rec._fields, rec)
            if isinstance(x, torch.Tensor)]


def clone_record(rec: Rank1Record) -> Rank1Record:
    return rec._replace(**{k: x.clone() for k, x in record_tensors(rec)})


def record_state(rec: Rank1Record) -> SimplexState:
    """The walk's state with the record's fields."""
    ints = rec.ints
    return SimplexState(
        T=rec.T, basis=rec.basis, col_active=rec.col_active,
        art_cols=rec.art_cols, phase=ints[PHASE], status=ints[STATUS],
        niter=ints[NITER], stuck=ints[STUCK], bland=ints[BLAND] != 0,
        last_z=rec.vals[LAST_Z])


# ---------------------------------------------------------------------------
# the plain stages
# ---------------------------------------------------------------------------

def _rule(rec: Rank1Record, opts: SolverOptions):
    """(Bland's rule, the greatest increase, largest-pivot ties): devex
    takes neither, as ``devex_simplex_step``, nor does the dual walk."""
    if rec.walk != "primal":
        return False, False, False
    return (opts.rule == RULE_BLAND, opts.rule == RULE_MAX_INCREASE,
            opts.tie_break == TIE_MAXPIV)


def _chunks(rec: Rank1Record) -> torch.Tensor:
    return rec.scan.view(SCAN_CHUNKS, rec.T.shape[1] - 1)


def rank1_scan_reference(rec: Rank1Record, opts: SolverOptions,
                         max_iters: int) -> None:
    """The scan stage: per chunk of rows, every column's
    minimum ratio (the greatest increase) or whether it has an entry above
    ``piv_tol`` (devex, on its ray ticks), into the record's partials."""
    iv = rec.ints.tolist()
    if rec.scan is None or not _live(iv, max_iters):
        return
    devex = rec.gamma is not None
    if devex and (iv[NITER] % RAY_SCAN_EVERY != 0 or iv[PHASE] != 2):
        return
    T = rec.T
    m = T.shape[0] - 2
    A, b = T[2:, :-1], T[2:, -1:]
    pos = A > opts.piv_tol
    rows = -(-m // SCAN_CHUNKS)
    out = _chunks(rec)
    for g in range(SCAN_CHUNKS):
        blk = slice(g * rows, min(m, (g + 1) * rows))
        if blk.start >= blk.stop:
            out[g] = 0.0 if devex else float("inf")
        elif devex:
            out[g] = pos[blk].any(dim=0).to(T.dtype)
        else:
            rat = torch.where(pos[blk], b[blk] / torch.where(
                pos[blk], A[blk], 1.0), float("inf"))
            out[g] = rat.min(dim=0).values


def rank1_price_reference(rec: Rank1Record, opts: SolverOptions,
                          max_iters: int) -> None:
    """The price stage: the clean-up scan, pricing, the
    exposed ray, the phase bookkeeping and the finiteness of the pre-step
    pricing row, into the record's verdict; on the dual walk the leaving
    row and the finiteness of the pre-step objective row."""
    iv = rec.ints.tolist()
    if not _live(iv, max_iters):
        return
    if rec.walk == "dual":
        _dual_price(rec, iv, opts)
        return
    T, inf = rec.T, float("inf")
    n = T.shape[1] - 1
    devex = rec.gamma is not None
    bland_rule, max_inc, _ = _rule(rec, opts)
    phase = iv[PHASE]
    art_basic = rec.art_cols[rec.basis.long()]
    cleanup = bool(art_basic.any()) and phase == 2
    r_d = int(torch.argmax(art_basic.to(torch.int32)))
    tick = iv[NITER] % RAY_SCAN_EVERY
    scan_tick = devex and tick == 0 and phase == 2 and not cleanup
    probe = devex and tick == RAY_SCAN_EVERY // 2 and phase == 2 \
        and not cleanup

    crow = T[1, :-1] if phase == 1 else T[0, :-1]
    c_eff = torch.where(rec.col_active, crow, inf)
    improving = c_eff < -opts.opt_tol
    has_improving = bool(improving.any())
    has_elig, j_d, ray = False, n - 1, False
    if cleanup:
        elig = (rec.col_active & ~rec.art_cols
                & (T[r_d + 2, :-1].abs() > opts.piv_tol))
        has_elig = bool(elig.any())
        j_d = _first_true(elig, n - 1)
    elif scan_tick:
        has_pos = (_chunks(rec) != 0).any(dim=0)
        ray = bool((improving & ~has_pos).any())
    if devex and not probe:
        j_best = int(torch.argmax(torch.where(
            improving, (crow * crow) / rec.gamma, -inf)))
    elif max_inc:
        ratio_j = _chunks(rec).min(dim=0).values
        dec = torch.where(
            improving,
            torch.where(ratio_j < inf, -c_eff * ratio_j, inf), -inf)
        j_best = int(torch.argmax(dec))
    else:
        j_best = int(torch.argmin(c_eff))
    use_bland = bool(iv[BLAND]) or bland_rule
    j_price = _first_true(improving, n - 1) if use_bland else j_best

    phase1_done = phase == 1 and not has_improving
    infeasible = phase1_done and bool(-T[1, -1] > opts.infeas_tol)
    crow_ok = bool(torch.isfinite(
        torch.where(rec.col_active, crow.abs(), 0.0).sum()))
    verdict = {CLEANUP: cleanup, R_D: r_d, HAS_ELIG: has_elig,
               J: j_d if cleanup else j_price,
               HAS_IMPROVING: has_improving, PHASE1_DONE: phase1_done,
               INFEASIBLE: infeasible,
               TO_PHASE2: phase1_done and not infeasible,
               PRICING_PIVOT: (has_improving and not cleanup
                               and not phase1_done),
               CROW_OK: crow_ok, RETIRE: cleanup and not has_elig,
               RAY: ray}
    for k, v in verdict.items():
        rec.ints[k] = int(v)


def rank1_ratio_reference(rec: Rank1Record, opts: SolverOptions,
                          max_iters: int) -> None:
    """The ratio stage: the ratio test over the entering
    column and the pivot, into the record's verdict, and the snapshot of
    the pivot's column and its normalised row when the update pivots; on
    the dual walk the dual ratio test over the leaving row."""
    iv = rec.ints.tolist()
    if not _live(iv, max_iters):
        return
    if rec.walk == "dual":
        _dual_ratio(rec, iv, opts)
        return
    T, inf = rec.T, float("inf")
    M, N = T.shape
    j = iv[J]
    bland_rule, _, max_piv = _rule(rec, opts)
    use_bland = bool(iv[BLAND]) or bland_rule
    pricing_pivot = bool(iv[PRICING_PIVOT])
    has_ratio, r_price = False, 0
    if pricing_pivot:
        # driver.ratio_rows
        col, b = T[2:, j], T[2:, -1]
        pos = col > opts.piv_tol
        has_ratio = bool(pos.any())
        ratios = torch.where(pos, b / torch.where(pos, col, 1.0), inf)
        tie = ratios <= ratios.min()
        if use_bland:
            r_price = int(torch.argmin(torch.where(tie, rec.basis, BIG_I)))
        elif max_piv:
            r_price = int(torch.argmax(torch.where(tie, col, -inf)))
        else:
            r_price = int(torch.argmax(tie.to(torch.int32)))
    do_cleanup = bool(iv[CLEANUP]) and bool(iv[HAS_ELIG])
    do_pricing = pricing_pivot and has_ratio
    do_pivot = do_cleanup or do_pricing
    r = iv[R_D] if do_cleanup else r_price
    pv, rg, jp = _snapshot(rec, do_pivot, r, j)
    in_phase2 = iv[PHASE] == 2
    verdict = {DO_PIVOT: do_pivot, DO_PRICING: do_pricing, R: r,
               LEAVING: int(rec.basis[r]), PV: pv, RG: rg, JP: jp,
               UNBOUNDED: pricing_pivot and not has_ratio and in_phase2,
               FAILED1: pricing_pivot and not has_ratio and not in_phase2}
    for k, v in verdict.items():
        rec.ints[k] = int(v)
    rec.vals[PIV] = T[r + 2, j]
    if rec.gamma is not None:
        rec.vals[GAMMA_Q] = rec.gamma[j]


def _snapshot(rec: Rank1Record, do_pivot: bool, r: int, j: int):
    """(pv, rg, jp): the update's pivot, (r + 2, j) on a pivot, else the
    plain step's redirected one on (row 2, ``basis[0]``), skipped where
    it is an exact no-op; snapshots the pivot's column and its normalised
    row when the update pivots (pv)."""
    T = rec.T
    M = T.shape[0]
    if do_pivot:
        pv, rg, jp = True, r + 2, j
    else:
        rg, jp = 2, int(rec.basis[0])
        pv = not noop_exact(T, jp)
    if pv:
        row = T[rg]
        rec.snap[:M] = T[:, jp]
        rec.snap[M:] = row * (1.0 / row[jp])
    return pv, rg, jp


def _dual_price(rec: Rank1Record, iv, opts: SolverOptions) -> None:
    """The dual walk's price: the leaving row, the most negative ``b_r``
    (the first negative one under Bland), and the finiteness of the
    pre-step objective row over the active columns."""
    T = rec.T
    m = T.shape[0] - 2
    b = T[2:, -1]
    neg = b < -opts.feas_tol
    feasible = not bool(neg.any())
    r = _first_true(neg, m - 1) if iv[BLAND] else int(torch.argmin(b))
    crow_ok = bool(torch.isfinite(
        torch.where(rec.col_active, T[0, :-1].abs(), 0.0).sum()))
    for k, v in ((FEASIBLE, feasible), (R, r), (CROW_OK, crow_ok)):
        rec.ints[k] = int(v)


def _dual_ratio(rec: Rank1Record, iv, opts: SolverOptions) -> None:
    """The dual walk's ratio test: the entering column, the smallest
    ``c_j / -T[r, j]`` over the active ``T[r, j] < -piv_tol`` with
    first-index ties, and the snapshot."""
    T, inf = rec.T, float("inf")
    r = iv[R]
    row, crow = T[r + 2, :-1], T[0, :-1]
    elig = rec.col_active & (row < -opts.piv_tol)
    has_elig = bool(elig.any())
    ratios = torch.where(elig, crow / torch.where(elig, -row, 1.0), inf)
    tie = elig & (ratios <= ratios.min())
    j = int(torch.argmax(tie.to(torch.int32)))
    feasible = bool(iv[FEASIBLE])
    do_pivot = not feasible and has_elig
    pv, rg, jp = _snapshot(rec, do_pivot, r, j)
    for k, v in ((HAS_ELIG, has_elig), (J, j),
                 (INFEASIBLE, not feasible and not has_elig),
                 (DO_PIVOT, do_pivot), (PV, pv), (RG, rg), (JP, jp)):
        rec.ints[k] = int(v)


def _dual_finish(rec: Rank1Record, iv, opts: SolverOptions,
                 stall_limit: int, rhs_ok: bool | None) -> None:
    """The dual walk's finish: the basis, the stall counter against the
    dual objective, the Bland switch, the finiteness sums and the
    status."""
    T = rec.T
    do_pivot = bool(iv[DO_PIVOT])
    if do_pivot:
        rec.basis[iv[R]] = iv[J]
    z = -T[0, -1]
    last_z = rec.vals[LAST_Z].clone()
    stuck = iv[STUCK]
    if do_pivot:
        stuck = 0 if bool((z - last_z) > opts.degen_tol) else stuck + 1
        last_z = z
    bland = bool(iv[BLAND]) or stuck >= stall_limit
    finite_ok = (bool(torch.isfinite(z)) and _rhs_ok(T, rhs_ok)
                 and bool(iv[CROW_OK]))
    if not finite_ok:
        status = Status.NUMERIC
    elif iv[INFEASIBLE]:
        status = Status.INFEASIBLE
    elif iv[FEASIBLE]:
        status = Status.OPTIMAL
    else:
        status = Status.RUNNING
    rec.vals[LAST_Z] = last_z
    for k, v in ((STATUS, status), (NITER, iv[NITER] + do_pivot),
                 (STUCK, stuck), (BLAND, bland)):
        rec.ints[k] = int(v)


def _rhs_ok(T: torch.Tensor, rhs_ok: bool | None) -> bool:
    """The finiteness of the post-step |b| sum: ``rhs_ok`` where a caller
    took the sum in a kernel's order, else torch's sum's."""
    if rhs_ok is None:
        return bool(torch.isfinite(T[2:, -1].abs().sum()))
    return rhs_ok


def rank1_update_reference(rec: Rank1Record, max_iters: int) -> None:
    """The update stage: the pivot from the snapshot, in
    place (``driver.pivot_update``'s arithmetic)."""
    iv = rec.ints.tolist()
    if not _live(iv, max_iters) or not iv[PV]:
        return
    T = rec.T
    M, N = T.shape
    colv, prow = rec.snap[:M], rec.snap[M:]
    is_r = (torch.arange(M, device=T.device) == iv[RG])[:, None]
    is_j = (torch.arange(N, device=T.device) == iv[JP])[None, :]
    Tn = fused_fma(T, colv[:, None], prow[None, :], -1.0)
    Tn = torch.where(is_r, prow[None, :], Tn)
    T.copy_(torch.where(is_j, is_r.to(T.dtype), Tn))


def rank1_finish_reference(rec: Rank1Record, opts: SolverOptions,
                           stall_limit: int, max_iters: int,
                           rhs_ok: bool | None = None) -> None:
    """The finish stage: the basis, the retire, the devex
    weights, the stall counter and the Bland switch, the phase change, the
    finiteness sums and the status; on the dual walk the basis, the stall
    counter, the Bland switch and the status. ``rhs_ok``, where given, is
    the finiteness of the post-step |b| sum taken in a kernel's order."""
    iv = rec.ints.tolist()
    if not _live(iv, max_iters):
        return
    if rec.walk == "dual":
        _dual_finish(rec, iv, opts, stall_limit, rhs_ok)
        return
    T, inf = rec.T, float("inf")
    M, N = T.shape
    do_pivot, do_pricing = bool(iv[DO_PIVOT]), bool(iv[DO_PRICING])
    to_phase2 = bool(iv[TO_PHASE2])
    if rec.gamma is not None:
        gamma = rec.gamma
        if do_pricing:
            # alpha: the post-pivot row r, column j snapped to 1
            alpha = rec.snap[M:M + N - 1].clone()
            alpha[iv[JP]] = 1.0
            gamma_q, piv = rec.vals[GAMMA_Q], rec.vals[PIV]
            gamma = torch.maximum(gamma, (alpha * alpha) * gamma_q)
            gamma[iv[LEAVING]] = torch.clamp_min(gamma_q / (piv * piv), 1.0)
        if gamma.max() > RESET_ABOVE or to_phase2:
            gamma = torch.ones_like(gamma)
        rec.gamma.copy_(gamma)
    if do_pivot:
        rec.basis[iv[R]] = iv[J]
    if iv[RETIRE]:
        rec.art_cols[int(rec.basis[iv[R_D]])] = False

    z = -T[1, -1] if iv[PHASE] == 1 else -T[0, -1]
    last_z = rec.vals[LAST_Z].clone()
    stuck = iv[STUCK]
    if do_pricing:
        stuck = 0 if bool((last_z - z) > opts.degen_tol) else stuck + 1
        last_z = z
    bland = bool(iv[BLAND]) or stuck >= stall_limit
    phase = iv[PHASE]
    if to_phase2:
        phase, stuck, last_z = 2, 0, torch.full_like(last_z, inf)
        rec.col_active.copy_(rec.col_active & ~rec.art_cols)

    finite_ok = (bool(torch.isfinite(z)) and _rhs_ok(T, rhs_ok)
                 and bool(iv[CROW_OK]))
    finished_opt = (iv[PHASE] == 2 and not iv[HAS_IMPROVING]
                    and not iv[CLEANUP])
    if not finite_ok:
        status = Status.NUMERIC
    elif iv[INFEASIBLE] or iv[FAILED1]:
        status = Status.INFEASIBLE
    elif iv[UNBOUNDED] or iv[RAY]:
        status = Status.UNBOUNDED
    elif finished_opt:
        status = Status.OPTIMAL
    else:
        status = Status.RUNNING
    rec.vals[LAST_Z] = last_z
    for k, v in ((PHASE, phase), (STATUS, status),
                 (NITER, iv[NITER] + do_pivot), (STUCK, stuck),
                 (BLAND, bland)):
        rec.ints[k] = int(v)


def rank1_stage_reference(rec: Rank1Record, stage: str, opts: SolverOptions,
                          stall_limit: int, max_iters: int) -> None:
    """One plain stage, ``stage`` one of ``STAGES``."""
    if stage == "scan":
        rank1_scan_reference(rec, opts, max_iters)
    elif stage == "price":
        rank1_price_reference(rec, opts, max_iters)
    elif stage == "ratio":
        rank1_ratio_reference(rec, opts, max_iters)
    elif stage == "update":
        rank1_update_reference(rec, max_iters)
    else:
        rank1_finish_reference(rec, opts, stall_limit, max_iters)


def rank1_step_reference(rec: Rank1Record, opts: SolverOptions,
                         stall_limit: int, max_iters: int) -> None:
    """One step as the plain stages, in order (the scan only
    where the walk has one: the scan stage is a no-op on a record without
    partials)."""
    for stage in STAGES:
        rank1_stage_reference(rec, stage, opts, stall_limit, max_iters)


# ---------------------------------------------------------------------------
# the kernels' check of a state
# ---------------------------------------------------------------------------

def _check(state: SimplexState, gamma: torch.Tensor | None,
           dual: bool = False) -> None:
    """Raise on a state the kernels do not take: a dtype other than f32 /
    f64, a strided tableau, a field of the wrong type or length, a tensor
    off the card or on another card."""
    T = state.T
    suffix(T.dtype)
    if T.dim() != 2 or not T.is_contiguous():
        raise ValueError(f"T: expected a contiguous (m + 2, n + 1) tableau, "
                         f"got {tuple(T.shape)} stride {T.stride()}")
    M, N = T.shape
    if M < 3 or N < 2 or max(M, N) >= _MAX_SIDE:
        raise ValueError(f"tableau {M} x {N} outside 3..2^24 x 2..2^24")
    m, n = M - 2, N - 1
    for name, x, dt, shape in (
            ("basis", state.basis, torch.int32, (m,)),
            ("col_active", state.col_active, torch.bool, (n,)),
            ("art_cols", state.art_cols, torch.bool, (n,)),
            ("phase", state.phase, torch.int32, ()),
            ("status", state.status, torch.int32, ()),
            ("niter", state.niter, torch.int32, ()),
            ("stuck", state.stuck, torch.int32, ()),
            ("bland", state.bland, torch.bool, ()),
            ("last_z", state.last_z, T.dtype, ()),
            ("gamma", gamma, T.dtype, (n,))):
        if x is not None and (x.dtype != dt or tuple(x.shape) != shape):
            raise ValueError(f"{name}: expected {dt} {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
    if dual and gamma is not None:
        raise ValueError("the dual walk takes no devex weights")
    tensors = [*state] + ([] if gamma is None else [gamma])
    if T.device.type != "cuda" or any(x.device != T.device
                                      for x in tensors):
        raise ValueError("the rank-1 kernels take a state on one CUDA "
                         "device; got "
                         f"{sorted({str(x.device) for x in tensors})}")
