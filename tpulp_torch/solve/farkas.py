"""Exact status certificates: PROOFS of infeasibility and unboundedness.

By Farkas' lemma, ``A x = b, x >= 0`` is infeasible iff there exists a row
combination ``y`` with ``y . A_j <= 0`` for every column j and ``y . b > 0``
— multiplying the rows by y exhibits a nonnegative combination of the
variables forced to equal a positive constant. The solver's escalation
ladder re-confirms float 'infeasible' verdicts by re-derivation
(``solve/api.py``); this module upgrades that to an exact, independently
checkable CERTIFICATE, the same way ``exact_basis_certificate`` upgrades
'optimal'.

This module is a copy of ``tpulp.solve.farkas`` with the same code
(``tests/test_torch_model.py`` holds the two equal): pure Fraction host
code, which this package cannot import from tpulp without loading jax.

Construction (infeasibility): solve the phase-1 LP ``min 1.a  s.t.
A x + D a = b`` with ``D = diag(sign(b_i) or 1)`` exactly on the host. If
its optimum w* is 0 the system is feasible (return None). Otherwise the
terminal basis B gives ``y = B^-T c_B``: phase-1 optimality prices every
structural column ``0 - y.A_j >= 0``, i.e. ``y.A_j <= 0``, and
``y.b = w* > 0`` — exactly the certificate.

Unboundedness is the symmetric proof: a recession RAY ``d`` with
``A d = 0``, ``d >= 0`` and ``c . d = -1`` (the -1 is WLOG scaling) —
any feasible point plus t*d stays feasible and drives the objective to
-inf. Finding d IS a phase-1 feasibility solve of the homogeneous system
with the one normalization row appended, so both certificates share the
same exact machinery. Every returned vector is RE-VERIFIED against the
original exact data before it leaves this module.
"""

from __future__ import annotations

from fractions import Fraction
from typing import List, Optional, Tuple

from ..model.lower import StandardForm
from .refine import _exact_gauss_solve

__all__ = ["farkas_certificate", "verify_farkas",
           "ray_certificate", "verify_ray"]

ZERO = Fraction(0)
ONE = Fraction(1)


def _phase1(A1: List[List[Fraction]], b: List[Fraction], n: int
            ) -> Tuple[Fraction, dict, List[int]]:
    """Exact phase-1 of ``[A | D] (x,a) = b, min 1.a``; A1 must already
    carry the D block (columns n..n+m). Returns (w*, bfs, basis)."""
    from ..simplex import Simplex, SolveStatus
    from ..tableau import Tableau

    m = len(b)
    c1 = [ZERO] * n + [ONE] * m
    tab = Tableau.fromArrays(c1, A1, b)
    sx = Simplex(tab, on_infeasible="status")
    if sx.getStatus() is not None:  # pragma: no cover - defensive
        raise RuntimeError("phase-1 construction reported infeasible")
    status = sx.solve()
    if status is not SolveStatus.OPTIMAL:  # pragma: no cover - defensive
        raise RuntimeError(f"phase-1 LP must be bounded, got {status}")
    bfs = sx.getBFS()
    w_star = sum((v for j, v in bfs.items() if j >= n), ZERO)
    return w_star, bfs, list(sx.getBasicSequence())


def verify_farkas(sf: StandardForm, y: List[Fraction]) -> bool:
    """Exactly check that ``y`` proves ``A x = b, x >= 0`` infeasible."""
    if len(y) != sf.m:
        return False
    if sum(y[i] * sf.b[i] for i in range(sf.m)) <= 0:
        return False
    for j in range(sf.n):
        if sum(y[i] * sf.A[i][j] for i in range(sf.m)) > 0:
            return False
    return True


def farkas_certificate(sf: StandardForm
                       ) -> Optional[List[Fraction]]:
    """Exact Farkas certificate of ``sf``'s infeasibility, or None if
    feasible.

    Host-exact phase-1 solve — O(pivots * m * n) rational work, intended
    for the same size regime as the exact refinement rung (m up to a few
    hundred). The certificate is about the EQUALITY system ``A x = b,
    x >= 0``; a span-carrying (``simple_bounds``) form must be
    row-materialized first (``materialize_simple_bounds``) — an instance
    can be equality-feasible yet box-infeasible, and the certificate then
    necessarily combines the bound rows. Raises RuntimeError if the
    extracted vector fails exact re-verification (internal invariant)."""
    if sf.upper is not None and any(u is not None for u in sf.upper):
        raise ValueError(
            "farkas_certificate needs a row-materialized form: pass "
            "materialize_simple_bounds(sf) — the spans can be exactly "
            "what makes the system infeasible")
    m, n = sf.m, sf.n
    if m == 0:
        return None
    # phase-1 data: [A | D] with D_ii = -1 where b_i < 0, else +1, so the
    # artificial basis is feasible without mutating row signs
    signs = [Fraction(-1) if sf.b[i] < 0 else ONE for i in range(m)]
    A1 = [list(sf.A[i]) + [signs[i] if k == i else ZERO for k in range(m)]
          for i in range(m)]
    w_star, _bfs, basis = _phase1(A1, list(sf.b), n)
    if w_star == 0:
        return None
    # y = B^-T c_B from the terminal basis of the AUGMENTED system
    c1 = [ZERO] * n + [ONE] * m
    cols = [[A1[i][j] for i in range(m)] for j in basis]
    bt_cols = [[cols[k][i] for k in range(m)] for i in range(m)]
    cb = [c1[j] for j in basis]
    y = _exact_gauss_solve(bt_cols, cb)
    if not verify_farkas(sf, y):  # pragma: no cover - invariant
        raise RuntimeError("extracted Farkas vector failed verification")
    return y


def verify_ray(sf: StandardForm, d: List[Fraction]) -> bool:
    """Exactly check that ``d`` is an improving recession ray of
    ``min c.x, A x = b, x >= 0``: ``A d = 0``, ``d >= 0``, ``c.d < 0``."""
    if len(d) != sf.n or any(v < 0 for v in d):
        return False
    if sum(sf.c[j] * d[j] for j in range(sf.n)) >= 0:
        return False
    for i in range(sf.m):
        if sum(sf.A[i][j] * d[j] for j in range(sf.n)) != 0:
            return False
    return True


def ray_certificate(sf: StandardForm) -> Optional[List[Fraction]]:
    """Exact improving recession ray of ``sf``, or None if none exists.

    Solves the homogeneous feasibility system ``A d = 0, c . d = -1,
    d >= 0`` with the shared exact phase-1 (the -1 is WLOG: any improving
    ray scales to it). A returned d proves the LP unbounded GIVEN
    feasibility — pair it with the solver's feasible iterate or a
    ``farkas_certificate(sf) is None`` check for the full statement.
    Same span-materialization requirement as ``farkas_certificate``:
    a box-bounded variable cannot ride a ray unboundedly, so spans must
    be rows before the homogeneous system means what it says. Raises
    RuntimeError if the extracted ray fails exact re-verification."""
    if sf.upper is not None and any(u is not None for u in sf.upper):
        raise ValueError(
            "ray_certificate needs a row-materialized form: pass "
            "materialize_simple_bounds(sf) — a span-bounded variable "
            "cannot carry an unbounded ray")
    m, n = sf.m, sf.n
    # rows: A d = 0 (m rows) and c.d = -1; D signs: +1 for the zero rows,
    # -1 for the -1 row
    A1 = [list(sf.A[i]) + [ONE if k == i else ZERO for k in range(m + 1)]
          for i in range(m)]
    A1.append(list(sf.c) + [ZERO] * m + [Fraction(-1)])
    b1 = [ZERO] * m + [Fraction(-1)]
    w_star, bfs, _basis = _phase1(A1, b1, n)
    if w_star != 0:
        return None
    d = [bfs.get(j, ZERO) for j in range(n)]
    if not verify_ray(sf, d):  # pragma: no cover - invariant
        raise RuntimeError("extracted ray failed verification")
    return d
