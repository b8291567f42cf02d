"""The solo bounded-variable step cut into four plain stages, the parts of
``kernels.bounded_grid.bounded_grid_reference`` (the grid walk's plain
version): the walk record they share, the constants the kernel shares
with the plain step, and the walk's flip counters.

``solve.bounded.bounded_simplex_step`` is one branchless transition of
~250 small tensor ops. Its work has three global dependencies: the
entering column (pricing over every column), the leaving row (the ratio
test over every row of that column) and the pivot itself. Cut there, a
step is four stages that read and write one walk record:

- **price**: the clean-up scan for basic artificials, pricing (Dantzig,
  or devex ``c^2 / gamma``, with the Bland switch), the phase bookkeeping
  and the finiteness sum of the pre-step pricing row;
- **ratio**: the three-way ratio test (a lower hit, then an upper hit,
  then the entering flip on exact ties), the pivot and the flip, and a
  snapshot of three pre-step vectors (the pivot's column, its row over
  the pivot, the flip's column), so that the update can run in place;
- **update** (elementwise): ``fma(-col[i], prow[k], T[i, k])``, the pivot
  row set to ``prow``, the entering column to the exact unit vector, the
  RHS ``fma(-Tn[i, fcol], uf, Tn[i, -1])`` and the flipped column negated;
- **finish**: the basis, the at-upper flags, the devex weights and their
  resets, the stall counter and the Bland switch, the phase change, the
  finiteness sums and the status.

The record (``BoundedRecord``) holds the walk's state (a copy of the
caller's tensors: the caller's are never written), the step's verdict
(``ints`` past the scalars, ``vals``) and the snapshot. Every stage
returns at once unless the record's status is RUNNING and its ``niter``
is below the budget, so the budget holds exactly, as in
``solve.driver.run_chunked``.

Composed, the stages give ``bounded_simplex_step`` bit for bit (``T +
0.0``) in every field. One liberty, taken by the grid kernel and the plain
stages alike: a step that pivots nowhere (an entering flip, a phase
change, a retire, an exit) skips the plain step's redirected pivot on (row
2, ``basis[0]``) when that pivot is an exact no-op (row 2 finite, column
``basis[0]`` exactly the unit vector on row 2): it could then change only
the sign of a zero. Otherwise the redirected pivot runs, as in the plain
step. Nothing on the solver's path calls the plain stages:
``solve.bounded.run_simplex_bounded`` runs the plain step on CPU tensors
and ``bounded_grid`` on CUDA tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.state import RULE_DEVEX, SolverOptions, Status
from .fma import fused_fma

__all__ = ["BoundedRecord", "make_record", "record_state", "clone_record",
           "bounded_price_reference",
           "bounded_ratio_reference", "bounded_update_reference",
           "bounded_finish_reference", "bounded_stage_reference",
           "bounded_step_reference", "noop_exact",
           "STAGES", "FLIPS", "BIG_I", "DEVEX_RESET_ABOVE"]

BIG_I = 2 ** 30
DEVEX_RESET_ABOVE = 1e8  # re-anchor the devex frame past this weight

# the record's int32 fields: the walk's scalars and its two counters
PHASE, STATUS, NITER, STUCK, BLAND, N_ENTER, N_UPHIT = range(7)
# the step's verdict: price writes the first eleven, ratio the rest
(CLEANUP, R_D, HAS_ELIG, J, HAS_IMPROVING, PHASE1_DONE, INFEASIBLE,
 TO_PHASE2, PRICING_PIVOT, CROW_OK, RETIRE,
 DO_PIVOT, DO_PRICE, DO_FLIP, DO_FLIP_ENTER, KIND_FLIP, R, LEAVING, FCOL,
 PV, RG, JP, UNBOUNDED, FAILED1) = range(7, 31)
NI = 32
# the record's values in the tableau's type
LAST_Z, UF, PIV, GAMMA_Q = range(4)
NV = 4
STAGES = ("price", "ratio", "update", "finish")

# entering flips and upper hits of every walk ``bounded_grid`` ran: the
# kernel's counters, read once a walk
FLIPS = {"entering_flips": 0, "upper_hits": 0}

# basis values go through the tableau's type in Bland's row tie: exact in
# float32 below 2^24
_MAX_SIDE = 1 << 24


class BoundedRecord(NamedTuple):
    """One walk's state, updated in place by the four stages."""

    T: torch.Tensor           # (M, N) the walk's tableau
    basis: torch.Tensor       # (m,) int32
    col_active: torch.Tensor  # (n,) bool
    art_cols: torch.Tensor    # (n,) bool
    at_upper: torch.Tensor    # (n,) bool
    upper: torch.Tensor       # (n,) spans (read only)
    gamma: torch.Tensor | None  # (n,) devex weights, or None
    ints: torch.Tensor        # (NI,) int32: scalars, counters, verdict
    vals: torch.Tensor        # (NV,) last_z and the step's values
    snap: torch.Tensor        # (2M + N,) column jp | prow | column fcol


def make_record(bs) -> BoundedRecord:
    """A record of the bounded state ``bs`` (a ``solve.bounded.
    BoundedState``): copies of its tensors, the counters at 0."""
    s = bs.s
    T = s.T
    M, N = T.shape
    dev = T.device
    ints = torch.zeros((NI,), dtype=torch.int32, device=dev)
    ints[:BLAND + 1] = torch.stack([s.phase, s.status, s.niter, s.stuck,
                                    s.bland.to(torch.int32)])
    vals = torch.empty((NV,), dtype=T.dtype, device=dev)
    vals[LAST_Z] = s.last_z
    return BoundedRecord(
        T=T.clone(memory_format=torch.contiguous_format),
        basis=s.basis.clone(), col_active=s.col_active.clone(),
        art_cols=s.art_cols.clone(), at_upper=bs.at_upper.clone(),
        upper=bs.upper.contiguous(),
        gamma=None if bs.gamma is None else bs.gamma.clone(),
        ints=ints, vals=vals,
        snap=torch.empty((2 * M + N,), dtype=T.dtype, device=dev))


def clone_record(rec: BoundedRecord) -> BoundedRecord:
    return BoundedRecord(*(None if x is None else x.clone() for x in rec))


def record_state(rec: BoundedRecord, bs):
    """The bounded state ``bs`` with the record's fields."""
    ints = rec.ints
    return bs._replace(
        s=bs.s._replace(T=rec.T, basis=rec.basis, col_active=rec.col_active,
                        art_cols=rec.art_cols, phase=ints[PHASE],
                        status=ints[STATUS], niter=ints[NITER],
                        stuck=ints[STUCK], bland=ints[BLAND] != 0,
                        last_z=rec.vals[LAST_Z]),
        at_upper=rec.at_upper, gamma=rec.gamma)


# ---------------------------------------------------------------------------
# the plain stages
# ---------------------------------------------------------------------------

def _live(iv, max_iters: int | None) -> bool:
    """RUNNING below the budget (``None``: no budget, as in the step)."""
    return iv[STATUS] == Status.RUNNING and (max_iters is None
                                             or iv[NITER] < max_iters)


def _first_true(mask: torch.Tensor, default: int) -> int:
    ids = torch.arange(mask.shape[0], device=mask.device)
    return int(torch.where(mask, ids, default).min())


def bounded_price_reference(rec: BoundedRecord, opts: SolverOptions,
                            max_iters: int) -> None:
    """The price stage: the clean-up scan, pricing, the
    phase bookkeeping and the finiteness of the pre-step pricing row, into
    the record's verdict."""
    iv = rec.ints.tolist()
    if not _live(iv, max_iters):
        return
    T, inf = rec.T, float("inf")
    n = T.shape[1] - 1
    phase = iv[PHASE]
    art_basic = rec.art_cols[rec.basis.long()]
    cleanup = bool(art_basic.any()) and phase == 2
    r_d = int(torch.argmax(art_basic.to(torch.int32)))
    row_d = T[r_d + 2, :-1]
    elig = rec.col_active & ~rec.art_cols & (row_d.abs() > opts.piv_tol)
    has_elig = bool(elig.any())
    j_d = _first_true(elig, n - 1)

    crow = T[1, :-1] if phase == 1 else T[0, :-1]
    c_eff = torch.where(rec.col_active, crow, inf)
    improving = c_eff < -opts.opt_tol
    has_improving = bool(improving.any())
    if opts.rule == RULE_DEVEX:
        score = torch.where(improving, (crow * crow) / rec.gamma, -inf)
        j_best = int(torch.argmax(score))
    else:
        j_best = int(torch.argmin(c_eff))
    j_price = _first_true(improving, n - 1) if iv[BLAND] else j_best

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
               CROW_OK: crow_ok, RETIRE: cleanup and not has_elig}
    for k, v in verdict.items():
        rec.ints[k] = int(v)


def noop_exact(T: torch.Tensor, jb: int) -> bool:
    """Whether the redirected pivot on (row 2, ``jb``) can change no more
    than the sign of a zero: row 2 finite and column ``jb`` exactly the
    unit vector on row 2."""
    unit = torch.zeros((T.shape[0],), dtype=T.dtype, device=T.device)
    unit[2] = 1.0
    return bool(torch.isfinite(T[2]).all()) and bool((T[:, jb] == unit).all())


def bounded_ratio_reference(rec: BoundedRecord, opts: SolverOptions,
                            max_iters: int) -> None:
    """The ratio stage: the three-way ratio test over the
    entering column, the pivot and the flip, into the record's verdict,
    and the snapshot of the pivot's column and its normalised row (when
    the update pivots) and of the flip's column."""
    iv = rec.ints.tolist()
    if not _live(iv, max_iters):
        return
    T, inf = rec.T, float("inf")
    M, N = T.shape
    j = iv[J]
    col = T[2:, j]
    b = T[2:, -1]
    u_basic = rec.upper[rec.basis.long()]
    pos = col > opts.piv_tol
    t_lo = torch.where(pos, b / torch.where(pos, col, 1.0), inf)
    t_lo_min = t_lo.min()
    neg = (col < -opts.piv_tol) & torch.isfinite(u_basic)
    t_up = torch.where(neg, (u_basic - b) / torch.where(neg, -col, 1.0), inf)
    t_up_min = t_up.min()
    t_star = torch.minimum(torch.minimum(t_lo_min, t_up_min), rec.upper[j])
    has_ratio = bool(torch.isfinite(t_star))
    kind_lo = bool(t_lo_min <= t_star)
    kind_up = not kind_lo and bool(t_up_min <= t_star)
    kind_flip = not kind_lo and not kind_up
    tie = (t_lo <= t_star) if kind_lo else (neg & (t_up <= t_star))
    if iv[BLAND]:
        r_price = int(torch.argmin(torch.where(tie, rec.basis, BIG_I)))
    else:
        r_price = int(torch.argmax(tie.to(torch.int32)))

    in_phase2 = iv[PHASE] == 2
    pricing_pivot = bool(iv[PRICING_PIVOT])
    do_cleanup = bool(iv[CLEANUP]) and bool(iv[HAS_ELIG])
    do_price = pricing_pivot and has_ratio
    do_pivot = do_cleanup or (do_price and not kind_flip)
    do_flip_enter = do_price and kind_flip
    r = iv[R_D] if do_cleanup else r_price
    leaving = int(rec.basis[r])
    do_flip = (do_price and kind_up and not iv[CLEANUP]) or do_flip_enter
    fcol = j if do_flip_enter else leaving
    if do_pivot:
        pv, rg, jp = True, r + 2, j
    else:
        rg, jp = 2, int(rec.basis[0])
        pv = not noop_exact(T, jp)
    verdict = {DO_PIVOT: do_pivot, DO_PRICE: do_price, DO_FLIP: do_flip,
               DO_FLIP_ENTER: do_flip_enter, KIND_FLIP: kind_flip, R: r,
               LEAVING: leaving, FCOL: fcol, PV: pv, RG: rg, JP: jp,
               UNBOUNDED: pricing_pivot and not has_ratio and in_phase2,
               FAILED1: pricing_pivot and not has_ratio and not in_phase2}
    for k, v in verdict.items():
        rec.ints[k] = int(v)
    rec.vals[UF] = rec.upper[fcol] if do_flip else 0.0
    rec.vals[PIV] = T[r + 2, j]
    if rec.gamma is not None:
        rec.vals[GAMMA_Q] = rec.gamma[j]
    if pv:
        row = T[rg]
        rec.snap[:M] = T[:, jp]
        rec.snap[M:M + N] = row * (1.0 / row[jp])
    rec.snap[M + N:] = T[:, fcol]


def bounded_update_reference(rec: BoundedRecord, max_iters: int) -> None:
    """The update stage: the pivot from the snapshot (a
    real one, or the redirected one when it is not an exact no-op), the
    RHS update of the flip and the flipped column negated, in place."""
    iv = rec.ints.tolist()
    if not _live(iv, max_iters):
        return
    T = rec.T
    M, N = T.shape
    Tn = T
    if iv[PV]:
        colv, prow = rec.snap[:M], rec.snap[M:M + N]
        is_r = (torch.arange(M, device=T.device) == iv[RG])[:, None]
        is_j = (torch.arange(N, device=T.device) == iv[JP])[None, :]
        Tn = fused_fma(T, colv[:, None], prow[None, :], -1.0)
        Tn = torch.where(is_r, prow[None, :], Tn)
        Tn = torch.where(is_j, is_r.to(T.dtype), Tn)
    fcol = iv[FCOL]
    rhs = fused_fma(Tn[:, -1], Tn[:, fcol], rec.vals[UF], -1.0)
    flipped = -Tn[:, fcol] if iv[DO_FLIP] else Tn[:, fcol]
    if Tn is not T:
        T.copy_(Tn)
    T[:, -1] = rhs
    T[:, fcol] = flipped


def bounded_finish_reference(rec: BoundedRecord, opts: SolverOptions,
                             stall_limit: int, max_iters: int,
                             rhs_ok: bool | None = None) -> None:
    """The finish stage: the basis, the at-upper flags,
    the devex weights, the stall counter and the Bland switch, the phase
    change, the finiteness sums and the status. ``rhs_ok``, where given, is
    the finiteness of the post-step |b| sum taken in a kernel's order (else
    torch's sum's)."""
    iv = rec.ints.tolist()
    if not _live(iv, max_iters):
        return
    T, inf = rec.T, float("inf")
    M, N = T.shape
    do_pivot, do_price = bool(iv[DO_PIVOT]), bool(iv[DO_PRICE])
    do_flip, do_flip_enter = bool(iv[DO_FLIP]), bool(iv[DO_FLIP_ENTER])
    to_phase2 = bool(iv[TO_PHASE2])
    if rec.gamma is not None:
        gamma = rec.gamma
        if do_price and not iv[KIND_FLIP]:
            # alpha: the post-pivot row r (pre-flip), column j snapped to 1
            alpha = rec.snap[M:M + N - 1].clone()
            alpha[iv[JP]] = 1.0
            gamma_q = rec.vals[GAMMA_Q]
            piv = rec.vals[PIV]
            gamma = torch.maximum(gamma, (alpha * alpha) * gamma_q)
            gamma[iv[LEAVING]] = torch.clamp_min(gamma_q / (piv * piv), 1.0)
        if gamma.max() > DEVEX_RESET_ABOVE or to_phase2:
            gamma = torch.ones_like(gamma)
        rec.gamma.copy_(gamma)
    if do_pivot:
        rec.basis[iv[R]] = iv[J]
    if do_flip:
        rec.at_upper[iv[FCOL]] = ~rec.at_upper[iv[FCOL]]
    if iv[RETIRE]:
        rec.art_cols[int(rec.basis[iv[R_D]])] = False

    act = do_pivot or do_flip_enter
    z = -T[1, -1] if iv[PHASE] == 1 else -T[0, -1]
    last_z = rec.vals[LAST_Z].clone()
    stuck = iv[STUCK]
    if do_price and act:
        stuck = 0 if bool((last_z - z) > opts.degen_tol) else stuck + 1
        last_z = z
    bland = bool(iv[BLAND]) or stuck >= stall_limit
    phase = iv[PHASE]
    if to_phase2:
        phase, stuck, last_z = 2, 0, torch.full_like(last_z, inf)
        rec.col_active.copy_(rec.col_active & ~rec.art_cols)

    if rhs_ok is None:
        rhs_ok = bool(torch.isfinite(T[2:, -1].abs().sum()))
    finite_ok = bool(torch.isfinite(z)) and rhs_ok and bool(iv[CROW_OK])
    finished_opt = (iv[PHASE] == 2 and not iv[HAS_IMPROVING]
                    and not iv[CLEANUP])
    if not finite_ok:
        status = Status.NUMERIC
    elif iv[INFEASIBLE] or iv[FAILED1]:
        status = Status.INFEASIBLE
    elif iv[UNBOUNDED]:
        status = Status.UNBOUNDED
    elif finished_opt:
        status = Status.OPTIMAL
    else:
        status = Status.RUNNING
    rec.vals[LAST_Z] = last_z
    for k, v in ((PHASE, phase), (STATUS, status),
                 (NITER, iv[NITER] + act), (STUCK, stuck), (BLAND, bland),
                 (N_ENTER, iv[N_ENTER] + do_flip_enter),
                 (N_UPHIT, iv[N_UPHIT] + (do_pivot and do_flip))):
        rec.ints[k] = int(v)


def bounded_stage_reference(rec: BoundedRecord, stage: str,
                            opts: SolverOptions, stall_limit: int,
                            max_iters: int) -> None:
    """One stage, ``stage`` one of ``STAGES``."""
    if stage == "price":
        bounded_price_reference(rec, opts, max_iters)
    elif stage == "ratio":
        bounded_ratio_reference(rec, opts, max_iters)
    elif stage == "update":
        bounded_update_reference(rec, max_iters)
    else:
        bounded_finish_reference(rec, opts, stall_limit, max_iters)


def bounded_step_reference(rec: BoundedRecord, opts: SolverOptions,
                           stall_limit: int, max_iters: int) -> None:
    """One step as the four plain stages, in order."""
    for stage in STAGES:
        bounded_stage_reference(rec, stage, opts, stall_limit, max_iters)
