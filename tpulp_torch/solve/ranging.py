"""Sensitivity ranging: coefficient intervals keeping the terminal basis
optimal.

A copy of ``tpulp.solve.ranging`` with the same code
(``tests/test_torch_model.py`` holds the two equal). An optimality
predicate answers only "is this frame optimal", never "for which data
does it STAY optimal". This module finishes the sensitivity surface of
``solve/refine.basis_duals`` / ``original_sensitivity``: the classic
post-optimal *ranging* report —

* **cost ranging** — for each objective coefficient ``c_j``, the closed
  interval of values for which the terminal basis remains optimal (primal
  solution unchanged; the objective moves linearly at rate ``x_j``);
* **rhs ranging** — for each right-hand side ``b_i``, the interval for
  which the basis remains optimal (duals unchanged; the objective moves at
  rate ``y_i``, the shadow price already reported by ``basis_duals``).

Math (standard equality min-form, basis B, nonbasic N):

* basic ``c_j`` at basis row r: perturbing ``c_j += d`` moves every
  nonbasic reduced cost ``d_k -> d_k - d * w_k`` with ``w_k = (B^-1 A_k)_r``
  — dual feasibility bounds d to
  ``[max_{w_k<0} d_k/w_k, min_{w_k>0} d_k/w_k]``;
* nonbasic ``c_j``: only its own reduced cost moves — ``[c_j - d_j, +inf)``;
* rhs ``b_i += d``: ``x_B -> x_B + d * h`` with ``h = B^-1 e_i`` — primal
  feasibility bounds d to ``[max_{h_k>0} -x_k/h_k, min_{h_k<0} -x_k/h_k]``
  (an interval always containing 0 since ``x_B >= 0``).

Everything runs in exact rationals by default (``mode='auto'`` falls back
to f64 past ``exact_max_m`` rows, same ladder convention as
``refine_basis_solution``), so each reported endpoint is EXACT: perturbing
the data *to* the endpoint keeps ``exact_basis_certificate`` green and any
step strictly beyond breaks it — the property the test suite pins.

Bounded-variable bases (``simple_bounds`` lowering: spans live in the
ratio test, not in rows) are covered by the KKT-box generalization:
nonbasic-at-upper columns price ``d_j <= 0`` (so their cost interval is
``(-inf, c_j - d_j]``), a basic cost perturbation must keep BOTH sign
classes (``d_k - delta*w_k >= 0`` at lower, ``<= 0`` at upper), and an
rhs move must keep ``0 <= x_B <= u_B`` — the at-upper flags of the
terminal bounded basis select the classes. Requesting bounded ranging
without those flags raises loudly rather than guessing (the codebase's
no-silent-option-dropping rule).
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..model.lower import StandardForm
from .refine import _artificial_row_map, _basis_columns_exact

__all__ = [
    "RangingReport",
    "standard_form_ranging",
    "original_ranging",
]

ZERO = Fraction(0)
ONE = Fraction(1)

# endpoint convention: None means unbounded on that side
Range = Tuple[Optional[object], Optional[object]]


@dataclass(frozen=True)
class RangingReport:
    """Standard-form ranging output.

    ``cost[j] = (lo, hi)`` — the interval of values of ``c[j]`` (min
    sense) keeping the basis optimal; ``rhs[i]`` likewise for ``b[i]``.
    ``None`` endpoints are unbounded. Exact ``Fraction``s in exact mode,
    floats in f64 mode (``exact`` records which)."""

    cost: List[Range]
    rhs: List[Range]
    exact: bool


def _exact_inv_rows(cols: List[List[Fraction]]) -> List[List[Fraction]]:
    """Rows of ``M^-1`` where M's k-th COLUMN is ``cols[k]``.

    Plain rational Gauss-Jordan on ``[M | I]`` — O(m^3) Fraction ops, used
    once per report (ranging needs the whole inverse: every rhs range reads
    a different column of it). Raises ZeroDivisionError on singular M."""
    m = len(cols)
    aug = [[cols[k][i] for k in range(m)]
           + [ONE if t == i else ZERO for t in range(m)]
           for i in range(m)]
    for col in range(m):
        piv = next((r for r in range(col, m) if aug[r][col] != 0), None)
        if piv is None:
            raise ZeroDivisionError("singular basis matrix")
        if piv != col:
            aug[col], aug[piv] = aug[piv], aug[col]
        pval = aug[col][col]
        if pval != 1:
            aug[col] = [v / pval for v in aug[col]]
        prow = aug[col]
        for r in range(m):
            if r == col:
                continue
            f = aug[r][col]
            if f != 0:
                aug[r] = [a - f * b for a, b in zip(aug[r], prow)]
    return [row[m:] for row in aug]


def _at_upper_spans(sf: StandardForm, basis, at_upper) -> Dict[int, Fraction]:
    """{nonbasic column: finite span} for flagged at-upper columns."""
    if at_upper is None:
        return {}
    bset = {int(j) for j in basis}
    ups: Dict[int, Fraction] = {}
    for j, flag in enumerate(at_upper):
        if flag and j not in bset and j < sf.n and sf.upper is not None \
                and sf.upper[j] is not None:
            ups[j] = sf.upper[j]
    return ups


def _ranging_exact(sf: StandardForm, basis: Sequence[int],
                   at_upper=None) -> RangingReport:
    m, n = sf.m, sf.n
    bcols = _basis_columns_exact(sf, basis)
    binv = _exact_inv_rows(bcols)  # binv[k][i] = (B^-1)[k,i]
    basis = [int(j) for j in basis]
    in_basis = {j: r for r, j in enumerate(basis)}
    ups = _at_upper_spans(sf, basis, at_upper)

    # TRUE basic values: at-upper nonbasics sit at their spans
    rhs_true = list(sf.b)
    for j, u in ups.items():
        for i in range(m):
            rhs_true[i] = rhs_true[i] - u * sf.A[i][j]
    xb = [sum(binv[k][i] * rhs_true[i] for i in range(m)) for k in range(m)]
    cb = [sf.c[j] if j < n else ZERO for j in basis]
    y = [sum(cb[k] * binv[k][i] for k in range(m)) for i in range(m)]
    # nonbasic structural columns and their reduced costs (artificials are
    # permanently priced out of the walk — they never bound a cost range)
    nonb = [j for j in range(n) if j not in in_basis]
    red = {j: sf.c[j] - sum(y[i] * sf.A[i][j] for i in range(m))
           for j in nonb}

    cost: List[Range] = []
    for j in range(n):
        r = in_basis.get(j)
        if r is None:
            # at lower: d_j >= 0 caps the DECREASE; at upper: d_j <= 0
            # caps the INCREASE
            if j in ups:
                cost.append((None, sf.c[j] - red[j]))
            else:
                cost.append((sf.c[j] - red[j], None))
            continue
        # w_k = (B^-1 A_k)_r for nonbasic k, using row r of B^-1
        brow = binv[r]
        dlo: Optional[Fraction] = None
        dhi: Optional[Fraction] = None
        for k in nonb:
            w = sum(brow[i] * sf.A[i][k] for i in range(m))
            if w == 0:
                continue
            cand = red[k] / w
            # keep d_k - delta*w_k >= 0 at lower, <= 0 at upper: the
            # binding side flips with BOTH the sign of w and the class
            upper_k = k in ups
            if (w > 0) != upper_k:
                if dhi is None or cand < dhi:
                    dhi = cand
            else:
                if dlo is None or cand > dlo:
                    dlo = cand
        cost.append((None if dlo is None else sf.c[j] + dlo,
                     None if dhi is None else sf.c[j] + dhi))

    art_pos = [k for k, j in enumerate(basis) if j >= n]
    rhs: List[Range] = []
    for i in range(m):
        # h = B^-1 e_i is COLUMN i of B^-1
        h = [binv[k][i] for k in range(m)]
        # a basic artificial must STAY at exactly 0 (else the original row
        # is violated): any movement along a nonzero h component pins d = 0
        if any(h[k] != 0 for k in art_pos):
            rhs.append((sf.b[i], sf.b[i]))
            continue
        dlo = dhi = None
        for k in range(m):
            if h[k] == 0:
                continue
            jk = basis[k]
            uk = sf.upper[jk] if (sf.upper is not None and jk < n) else None
            lo_c = -xb[k] / h[k]                      # x_k + d*h_k >= 0
            hi_c = None if uk is None else (uk - xb[k]) / h[k]  # <= u_k
            if h[k] < 0:
                lo_c, hi_c = hi_c, lo_c
            if lo_c is not None and (dlo is None or lo_c > dlo):
                dlo = lo_c
            if hi_c is not None and (dhi is None or hi_c < dhi):
                dhi = hi_c
        rhs.append((None if dlo is None else sf.b[i] + dlo,
                    None if dhi is None else sf.b[i] + dhi))
    return RangingReport(cost=cost, rhs=rhs, exact=True)


def _ranging_float(sf: StandardForm, basis: Sequence[int],
                   at_upper=None, tol: float = 1e-11) -> RangingReport:
    m, n = sf.m, sf.n
    c64, A64, b64 = sf.to_dense(np.float64)
    art_rows = _artificial_row_map(sf)
    basis = [int(j) for j in basis]
    ups = _at_upper_spans(sf, basis, at_upper)
    b_orig = b64  # intervals are reported around the ORIGINAL rhs
    b64 = b64.astype(np.float64).copy()
    for j, u in ups.items():
        b64 -= float(u) * A64[:, j]
    B = np.zeros((m, m))
    cb = np.zeros(m)
    for k, j in enumerate(basis):
        if j < n:
            B[:, k] = A64[:, j]
            cb[k] = c64[j]
        else:
            B[art_rows[j - n], k] = 1.0
    binv = np.linalg.inv(B)
    xb = binv @ b64
    y = binv.T @ cb
    in_basis = {j: r for r, j in enumerate(basis)}
    nonb = np.array([j for j in range(n) if j not in in_basis], dtype=int)
    red = c64[nonb] - A64[:, nonb].T @ y if nonb.size else np.zeros(0)
    up_mask = np.array([j in ups for j in nonb], dtype=bool)
    # zero threshold scaled to the data (w/h magnitudes are O(|B^-1 A|))
    wtol = tol * max(1.0, float(np.abs(A64).max()) * float(np.abs(binv).max()))

    cost: List[Range] = []
    for j in range(n):
        r = in_basis.get(j)
        if r is None:
            k = int(np.where(nonb == j)[0][0])
            if j in ups:
                cost.append((None, float(c64[j] - red[k])))
            else:
                cost.append((float(c64[j] - red[k]), None))
            continue
        w = binv[r] @ A64[:, nonb] if nonb.size else np.zeros(0)
        # binding side flips with both the sign of w and the bound class
        hi_side = (w > wtol) & ~up_mask | (w < -wtol) & up_mask
        lo_side = (w < -wtol) & ~up_mask | (w > wtol) & up_mask
        dhi = float(np.min(red[hi_side] / w[hi_side])) \
            if hi_side.any() else None
        dlo = float(np.max(red[lo_side] / w[lo_side])) \
            if lo_side.any() else None
        cost.append((None if dlo is None else float(c64[j]) + dlo,
                     None if dhi is None else float(c64[j]) + dhi))

    art_pos = [k for k, j in enumerate(basis) if j >= n]
    ub = np.full(m, np.inf)
    for k, j in enumerate(basis):
        if j < n and sf.upper is not None and sf.upper[j] is not None:
            ub[k] = float(sf.upper[j])
    rhs: List[Range] = []
    for i in range(m):
        h = binv[:, i]
        if any(abs(h[k]) > wtol for k in art_pos):
            rhs.append((float(b_orig[i]), float(b_orig[i])))
            continue
        pos = h > wtol
        neg = h < -wtol
        los = np.concatenate([-xb[pos] / h[pos], (ub[neg] - xb[neg]) / h[neg]])
        his = np.concatenate([-xb[neg] / h[neg], (ub[pos] - xb[pos]) / h[pos]])
        los = los[np.isfinite(los)]
        his = his[np.isfinite(his)]
        dlo = float(np.max(los)) if los.size else None
        dhi = float(np.min(his)) if his.size else None
        rhs.append((None if dlo is None else float(b_orig[i]) + dlo,
                    None if dhi is None else float(b_orig[i]) + dhi))
    return RangingReport(cost=cost, rhs=rhs, exact=False)


def standard_form_ranging(sf: StandardForm, basis: Sequence[int],
                          mode: str = "auto", at_upper=None,
                          exact_max_m: int = 96) -> RangingReport:
    """Ranging report for an optimal basis of an equality-form LP.

    ``mode``: 'exact' (Fractions, O(m^3) rational inverse), 'float64', or
    'auto' (exact up to ``exact_max_m`` rows — the inverse is denser work
    than a single solve, so the default crossover sits below
    ``refine_basis_solution``'s). For a ``simple_bounds`` form pass the
    terminal basis' ``at_upper`` flags (``Solution.at_upper``) — required,
    because the flags select each nonbasic column's KKT sign class; omitting
    them raises rather than guessing. Raises ZeroDivisionError on a
    singular basis."""
    bounded = sf.upper is not None and any(u is not None for u in sf.upper)
    if bounded and at_upper is None:
        raise ValueError(
            "ranging on a simple_bounds form needs the terminal basis' "
            "at_upper flags (Solution.at_upper): they decide whether each "
            "nonbasic reduced cost is bounded below (at lower) or above "
            "(at upper). Pass at_upper=..., or solve via "
            "solve_lp(..., ranging=True) which threads them through")
    if mode == "auto":
        mode = "exact" if sf.m <= exact_max_m else "float64"
    if mode == "exact":
        return _ranging_exact(sf, basis, at_upper=at_upper)
    if mode != "float64":
        raise ValueError(f"unknown ranging mode {mode!r}")
    return _ranging_float(sf, basis, at_upper=at_upper)


def _map_interval(lo, hi, scale) -> Range:
    """Map interval [lo, hi] through v -> v/scale (scale = +-coeff)."""
    a = None if lo is None else lo / scale
    b = None if hi is None else hi / scale
    if scale < 0:
        a, b = b, a
    return (a, b)


def original_ranging(prog, sf: StandardForm, report: RangingReport
                     ) -> Tuple[Dict, Dict]:
    """Map a standard-form ranging report back to the USER's program.

    Returns ``(cost_ranging, rhs_ranging)``:

    * ``cost_ranging`` — {variable name: (lo, hi)} interval of that
      variable's ORIGINAL-sense objective coefficient keeping the basis
      optimal. A max objective lowers through ``c_std = -c_user``, so the
      interval reflects and swaps. Variables the lowering SPLIT into two
      columns (free variables) map to ``None``: their user coefficient
      moves two standard costs in lockstep, which single-coefficient
      ranging does not cover (a documented non-answer, not a wrong one).
    * ``rhs_ranging`` — {constraint index: (lo, hi)} interval of the
      canonical rhs (``LinCon.simplify``'s constant — the same convention
      as ``Solution.duals``), additionally keyed by constraint name for
      named constraints. Rows the lowering negated to make ``b >= 0``
      reflect back through ``row_provenance``; constraints that produced
      no standard row (constant rows) map to ``None``.
    """
    from ..model.prog import MAX as _MAX

    s_obj = Fraction(-1) if sf.sense == _MAX else ONE
    cost: Dict[str, Optional[Range]] = {}
    for name, (terms, _const) in sf.recover.items():
        if len(terms) != 1:
            cost[name] = None  # split variable: two columns move together
            continue
        col, coeff = terms[0]
        lo, hi = report.cost[col]
        # c_std[col] = s_obj * coeff... inverted: c_user = c_std/(s_obj*coeff)
        cost[name] = _map_interval(lo, hi, s_obj * coeff)

    rhs: Dict = {}
    by_index: Dict[int, Range] = {}
    for i, (kind, ref, sign) in enumerate(sf.row_provenance):
        if kind != "con" or i >= len(report.rhs):
            continue
        lo, hi = report.rhs[i]
        base = sf.b[i] if report.exact else float(sf.b[i])
        dlo = None if lo is None else lo - base
        dhi = None if hi is None else hi - base
        con = prog.constraints[ref].simplify()
        beta = con.right.getConstant() if report.exact \
            else float(con.right.getConstant())
        if sign >= 0:
            by_index[ref] = (None if dlo is None else beta + dlo,
                             None if dhi is None else beta + dhi)
        else:
            by_index[ref] = (None if dhi is None else beta - dhi,
                             None if dlo is None else beta - dlo)
    for ci in range(len(prog.constraints)):
        rhs[ci] = by_index.get(ci)
    names = getattr(prog, "con_names", None) or []
    for ci, nm in enumerate(names):
        if nm is not None and ci in rhs:
            rhs[nm] = rhs[ci]
    return cost, rhs
