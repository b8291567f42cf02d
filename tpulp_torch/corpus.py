"""Netlib-style LP corpus: nontrivial instances with exact oracles.

BASELINE.md's parity bar names "lpsol test LPs + netlib-style dense
instances"; the reference ships only two oracle LPs (the libretexts textbook
problem, the reference's lpsol/test_tableau.py:7-29, and Beale's cycling
example exercised by its Dantzig->Bland switch, simplex.py:123-146). This
module is the corpus that bar requires: a registry of generators covering
the structural hazards of real LPs — degeneracy, redundant rows, free
variables, equality-heavy systems (deep phase 1), exponential-path geometry
(Klee-Minty), wide dynamic range, infeasible/unbounded certificates — each
with an EXACT rational optimum, either analytic (dual-certificate and
combinatorial constructions, so instances can be far larger than exact host
solving allows) or from the exact host simplex at build time.

Used by tests/test_corpus.py (every device driver x every case) and by
``bench.py --corpus`` (TPU parity + throughput sweep).
"""

from __future__ import annotations

import dataclasses
import itertools
from fractions import Fraction as F
from typing import Callable, Dict, List, Optional

import numpy as np

from .model.expr import LinExpr
from .model.prog import LinProg

__all__ = ["CorpusCase", "CASES", "get_case", "case_names"]


@dataclasses.dataclass
class CorpusCase:
    """One corpus instance.

    ``objective`` is the exact optimum in the ORIGINAL sense (None for
    non-optimal statuses); ``oracle`` says where it came from ('analytic'
    constructions need no host solve, 'host' means it was pinned by the
    exact rational simplex and is re-checkable via solve_standard_form_host).
    """

    name: str
    build: Callable[[], LinProg]
    objective: Optional[F]
    status: str = "optimal"
    oracle: str = "analytic"
    # rows of the lowered standard form (approx, for test-time budgeting)
    size_hint: int = 0
    # pivot budget that comfortably covers the instance (Dantzig paths on
    # random equality systems run to ~65x m pivots; measured)
    max_iters: int = 10_000

    def lp(self) -> LinProg:
        return self.build()


# ---------------------------------------------------------------------------
# reference-oracle cases
# ---------------------------------------------------------------------------

def _textbook() -> LinProg:
    """The reference's golden LP (test_tableau.py:7-8): max 40x1+30x2 = 400."""
    lp = LinProg("textbook")
    lp.addVar("x1")
    lp.addVar("x2")
    lp.maximize(LinExpr(40, "x1", 30, "x2"))
    lp.addConstraint(LinExpr(1, "x1", 1, "x2").constraintLeq(12))
    lp.addConstraint(LinExpr(2, "x1", 1, "x2").constraintLeq(16))
    return lp


def _beale() -> LinProg:
    """Beale's cycling LP: Dantzig cycles at the origin; optimum -1/20.

    The reference survives it only via its stall-triggered Bland switch
    (simplex.py:123-146); the device drivers must too."""
    lp = LinProg("beale")
    for v in ("x1", "x2", "x3", "x4"):
        lp.addVar(v)
    lp.minimize(LinExpr(F(-3, 4), "x1", 150, "x2", F(-1, 50), "x3", 6, "x4"))
    lp.addConstraint(
        LinExpr(F(1, 4), "x1", -60, "x2", F(-1, 25), "x3", 9, "x4")
        .constraintLeq(0))
    lp.addConstraint(
        LinExpr(F(1, 2), "x1", -90, "x2", F(-1, 50), "x3", 3, "x4")
        .constraintLeq(0))
    lp.addConstraint(LinExpr(1, "x3").constraintLeq(1))
    return lp


# ---------------------------------------------------------------------------
# analytic constructions (exact optimum by duality, any size)
# ---------------------------------------------------------------------------

def _dual_certificate_eq(m: int, n_struct: int, seed: int):
    """Equality-form LP with a KNOWN exact optimum by strong duality.

    A = [D | I] (integer D), x* = (0, b) basic-feasible; pick integer y and
    integer s >= 0 with s_B = 0, set c = A^T y + s. Then x* is primal
    feasible, y is dual feasible (c - A^T y = s >= 0), and complementary
    slackness holds, so min c.x = y.b exactly. Because the constraints are
    EQUALITIES the lowering gets no slack basis: phase 1 must place all m
    rows (the deep-phase-1 stressor the reference's artificial-variable
    method seeds, the reference's lpsol/simplex.py:36-108).
    """
    rng = np.random.default_rng(seed)
    D = rng.integers(-9, 10, size=(m, n_struct))
    b = rng.integers(1, 50, size=m)          # > 0: nondegenerate RHS
    y = rng.integers(-5, 6, size=m)
    s_struct = rng.integers(1, 8, size=n_struct)  # strictly positive
    # c over [D | I]: structural cols get D^T y + s, identity cols get y
    c_struct = D.T @ y + s_struct
    c_id = y                                  # s = 0 on the basic block
    zopt = F(int(y @ b))
    return D, b, c_struct, c_id, zopt


def _equality_heavy(m: int, n_struct: int, seed: int, name: str
                    ) -> Callable[[], LinProg]:
    def build() -> LinProg:
        D, b, c_struct, c_id, _ = _dual_certificate_eq(m, n_struct, seed)
        lp = LinProg(name)
        xs = [lp.addVar(f"x{j}").x for j in range(n_struct)]
        ws = [lp.addVar(f"w{i}").x for i in range(m)]
        obj = LinExpr()
        for j in range(n_struct):
            obj += LinExpr(int(c_struct[j]), xs[j])
        for i in range(m):
            obj += LinExpr(int(c_id[i]), ws[i])
        lp.minimize(obj)
        for i in range(m):
            e = LinExpr(1, ws[i])
            for j in range(n_struct):
                if D[i, j]:
                    e += LinExpr(int(D[i, j]), xs[j])
            lp.addConstraint(e.constraintEq(int(b[i])))
        return lp

    return build


def _klee_minty(d: int) -> LinProg:
    """Klee-Minty cube in d dimensions: max x_d, optimum 5^d.

    max sum-free form: max x_d s.t. 2 sum_{j<i} 2^(i-j) x_j + x_i <= 5^i.
    Dantzig visits an exponential number of vertices on the unit-cost
    variant; here it stresses long pivot paths and large dynamic range."""
    lp = LinProg(f"klee_minty_{d}")
    xs = [lp.addVar(f"x{i}").x for i in range(1, d + 1)]
    lp.maximize(LinExpr(1, xs[-1]))
    for i in range(1, d + 1):
        e = LinExpr(1, xs[i - 1])
        for j in range(1, i):
            e += LinExpr(2 ** (i - j + 1), xs[j - 1])
        lp.addConstraint(e.constraintLeq(5 ** i))
    return lp


def _assignment(k: int, seed: int) -> tuple[Callable[[], LinProg], F]:
    """k x k assignment LP; by Birkhoff-von Neumann the LP optimum equals the
    best permutation, brute-forced exactly at build time (k! small)."""
    rng = np.random.default_rng(seed)
    C = rng.integers(1, 100, size=(k, k))
    best = min(
        sum(int(C[i, p[i]]) for i in range(k))
        for p in itertools.permutations(range(k)))

    def build() -> LinProg:
        lp = LinProg(f"assignment_{k}")
        x = [[lp.addVar(f"x{i}_{j}").x for j in range(k)] for i in range(k)]
        obj = LinExpr()
        for i in range(k):
            for j in range(k):
                obj += LinExpr(int(C[i, j]), x[i][j])
        lp.minimize(obj)
        for i in range(k):
            e = LinExpr()
            for j in range(k):
                e += LinExpr(1, x[i][j])
            lp.addConstraint(e.constraintEq(1))
        for j in range(k):
            e = LinExpr()
            for i in range(k):
                e += LinExpr(1, x[i][j])
            lp.addConstraint(e.constraintEq(1))
        return lp

    return build, F(best)


def _transport_degenerate() -> LinProg:
    """4x4 transportation LP with EQUAL supply/demand subtotals, the classic
    degeneracy source (basic feasible solutions have < m+n-1 nonzeros)."""
    supply = [30, 30, 20, 20]
    demand = [30, 30, 20, 20]
    cost = [
        [4, 8, 8, 6],
        [6, 2, 4, 9],
        [5, 9, 7, 3],
        [8, 3, 6, 2],
    ]
    lp = LinProg("transport_degenerate")
    x = [[lp.addVar(f"t{i}_{j}").x for j in range(4)] for i in range(4)]
    obj = LinExpr()
    for i in range(4):
        for j in range(4):
            obj += LinExpr(cost[i][j], x[i][j])
    lp.minimize(obj)
    for i in range(4):
        e = LinExpr()
        for j in range(4):
            e += LinExpr(1, x[i][j])
        lp.addConstraint(e.constraintEq(supply[i]))
    for j in range(4):
        e = LinExpr()
        for i in range(4):
            e += LinExpr(1, x[i][j])
        lp.addConstraint(e.constraintEq(demand[j]))
    return lp


# ---------------------------------------------------------------------------
# host-oracle cases (structure stressors; optimum pinned by exact host solve)
# ---------------------------------------------------------------------------

def _redundant_rows(seed: int) -> Callable[[], LinProg]:
    """Random integer LP with duplicated AND linearly-combined rows: the
    dependent-row hazard that crashes the reference (SURVEY.md §2.7-1,
    the reference's lpsol/simplex.py:93)."""
    rng = np.random.default_rng(seed)
    m, n = 8, 12
    A = rng.integers(-5, 6, size=(m, n))
    x0 = rng.integers(0, 5, size=n)
    b = A @ x0 + rng.integers(1, 6, size=m)
    c = rng.integers(-9, 10, size=n)

    def build() -> LinProg:
        lp = LinProg(f"redundant_rows_{seed}")
        # box bounds keep the negative-cost directions bounded
        xs = [lp.addVar(f"x{j}", ub=10).x for j in range(n)]
        obj = LinExpr()
        for j in range(n):
            obj += LinExpr(int(c[j]), xs[j])
        lp.minimize(obj)

        def row_expr(coeffs):
            e = LinExpr()
            for j in range(n):
                if coeffs[j]:
                    e += LinExpr(int(coeffs[j]), xs[j])
            return e

        for i in range(m):
            lp.addConstraint(row_expr(A[i]).constraintLeq(int(b[i])))
        # duplicates + an exact linear combination (2*row0 + row1)
        lp.addConstraint(row_expr(A[0]).constraintLeq(int(b[0])))
        lp.addConstraint(
            row_expr(2 * A[0] + A[1]).constraintLeq(int(2 * b[0] + b[1])))
        return lp

    return build


def _free_vars() -> LinProg:
    """Free (unbounded-both-ways) variables exercise the split-variable
    lowering (x = x+ - x-): min |structure| with free y, z."""
    lp = LinProg("free_vars")
    lp.addVar("x")                      # x >= 0
    lp.addVar("y", lb=None)             # free
    lp.addVar("z", lb=None)             # free
    lp.minimize(LinExpr(2, "x", 1, "y", 3, "z"))
    lp.addConstraint(LinExpr(1, "x", 1, "y", 1, "z").constraintGeq(10))
    lp.addConstraint(LinExpr(1, "y", -1, "z").constraintLeq(4))
    lp.addConstraint(LinExpr(1, "y").constraintGeq(-3))
    lp.addConstraint(LinExpr(1, "z").constraintGeq(-2))
    return lp


def _bounded_box() -> LinProg:
    """Two-sided bounds on every variable (shift + upper-bound rows)."""
    lp = LinProg("bounded_box")
    lp.addVar("a", lb=1, ub=4)
    lp.addVar("b", lb=-2, ub=3)
    lp.addVar("c", lb=F(1, 2), ub=F(7, 2))
    lp.maximize(LinExpr(3, "a", -2, "b", 5, "c"))
    lp.addConstraint(LinExpr(1, "a", 1, "b", 1, "c").constraintLeq(6))
    lp.addConstraint(LinExpr(1, "a", -1, "c").constraintGeq(-2))
    return lp


def _ill_scaled() -> LinProg:
    """Coefficients spanning 1e-4..1e4: f32 iterates may fail -> the
    precision ladder (f32 -> f64 -> exact host) must still land exactly."""
    lp = LinProg("ill_scaled")
    lp.addVar("u")
    lp.addVar("v")
    lp.addVar("w")
    lp.minimize(LinExpr(F(1, 10000), "u", 1, "v", 10000, "w"))
    lp.addConstraint(
        LinExpr(10000, "u", 1, "v", F(1, 10000), "w").constraintGeq(100))
    lp.addConstraint(LinExpr(1, "u", 1, "v", 1, "w").constraintGeq(3))
    lp.addConstraint(LinExpr(F(1, 100), "u", 100, "v").constraintLeq(10000))
    return lp


def _degenerate_b0() -> LinProg:
    """Many zero RHS entries: every vertex is massively degenerate."""
    lp = LinProg("degenerate_b0")
    for v in ("x", "y", "z"):
        lp.addVar(v)
    lp.minimize(LinExpr(-1, "x", -2, "y", 1, "z"))
    lp.addConstraint(LinExpr(1, "x", -1, "y").constraintLeq(0))
    lp.addConstraint(LinExpr(1, "y", -1, "z").constraintLeq(0))
    lp.addConstraint(LinExpr(1, "x", 1, "y", -2, "z").constraintLeq(0))
    lp.addConstraint(LinExpr(1, "x", 1, "y", 1, "z").constraintLeq(30))
    return lp


def _infeasible_gap() -> LinProg:
    lp = LinProg("infeasible_gap")
    lp.addVar("x")
    lp.addVar("y")
    lp.minimize(LinExpr(1, "x", 1, "y"))
    lp.addConstraint(LinExpr(1, "x", 1, "y").constraintLeq(3))
    lp.addConstraint(LinExpr(1, "x", 1, "y").constraintGeq(5))
    lp.addConstraint(LinExpr(1, "x", -1, "y").constraintEq(1))
    return lp


def _ill_scaled_1e8() -> LinProg:
    """Coefficients spanning 1e-8..1e8 (round 5, VERDICT r4 item 7): the
    class the equilibration pass (tpulp.model.equilibrate) exists for —
    without scaling, f32 AND f64 iterates see pivot elements below
    piv_tol everywhere and the walk collapses; with the default
    ``scale='auto'`` the device solves it directly."""
    lp = LinProg("ill_scaled_1e8")
    lp.addVar("u")
    lp.addVar("v")
    lp.addVar("w")
    lp.addVar("t")
    B = 10**8
    lp.minimize(LinExpr(B, "u", F(1, B), "v", 1, "w", F(1, 10000), "t"))
    lp.addConstraint(
        LinExpr(F(1, B), "u", B, "v", 1, "w").constraintGeq(1))
    lp.addConstraint(
        LinExpr(1, "u", 1, "v", F(1, 10000), "w", B, "t").constraintGeq(3))
    lp.addConstraint(
        LinExpr(F(1, 100), "u", 10000, "w").constraintLeq(B))
    lp.addConstraint(LinExpr(1, "t").constraintLeq(F(1, 10000)))
    return lp


def _near_parallel_rows() -> LinProg:
    """Nearly-parallel constraint rows (angle ~1e-6): the basis matrix is
    almost singular, so float pivots amplify roundoff ~1e6x per
    elimination — the conditioning hazard equilibration CANNOT fix (it is
    angular, not magnitudinal); the certificate + ladder must carry it."""
    lp = LinProg("near_parallel_rows")
    e = F(1, 10**6)
    for v in ("x", "y", "z"):
        lp.addVar(v)
    # the optimal vertex is the intersection of the three nearly-parallel
    # planes: its basis matrix has determinant O(e^2), so the exact vertex
    # coordinates are determined entirely by the 1e-6 perturbations
    lp.maximize(LinExpr(3, "x", 3 + e, "y", 3, "z"))
    lp.addConstraint(LinExpr(1, "x", 1, "y", 1, "z").constraintLeq(10))
    lp.addConstraint(
        LinExpr(1, "x", 1 + e, "y", 1, "z").constraintLeq(10 + 5 * e))
    lp.addConstraint(
        LinExpr(1 - e, "x", 1, "y", 1 + e, "z").constraintLeq(10 + 3 * e))
    return lp


def _beale_scaled() -> LinProg:
    """Beale's cycling LP under a wild per-variable rescaling
    (x_j -> 10^{k_j} x_j', k in {-6..6}): the Dantzig cycle at the origin
    AND an ill-scaled tableau at once. The optimum is invariant under
    variable rescaling: still -1/20."""
    lp = LinProg("beale_scaled")
    for v in ("x1", "x2", "x3", "x4"):
        lp.addVar(v)
    s1, s2, s3, s4 = F(10**6), F(1, 10**6), F(10**4), F(1, 100)
    lp.minimize(LinExpr(F(-3, 4) * s1, "x1", 150 * s2, "x2",
                        F(-1, 50) * s3, "x3", 6 * s4, "x4"))
    lp.addConstraint(
        LinExpr(F(1, 4) * s1, "x1", -60 * s2, "x2", F(-1, 25) * s3, "x3",
                9 * s4, "x4").constraintLeq(0))
    lp.addConstraint(
        LinExpr(F(1, 2) * s1, "x1", -90 * s2, "x2", F(-1, 50) * s3, "x3",
                3 * s4, "x4").constraintLeq(0))
    lp.addConstraint(LinExpr(s3, "x3").constraintLeq(1))
    return lp


def _hidden_ray(m: int, n: int, seed: int, name: str) -> Callable[[], LinProg]:
    """Unbounded equality LP whose ray is a strictly POSITIVE null
    direction: no single column certifies unboundedness, so pricing must
    WALK to a frame that exposes it (the measured round-4 devex failure
    class — tpulp.solve.devex module doc). Integer data, exact by
    construction: d = all-ones is in the null space and c.d < 0."""
    rng = np.random.default_rng(seed)

    def build() -> LinProg:
        lp = LinProg(name)
        xs = [lp.addVar(f"x{j}").x for j in range(n)]
        # rows with zero row-sum: A @ ones = 0
        rows = rng.integers(-5, 6, size=(m, n))
        rows[:, -1] -= rows.sum(axis=1)
        x0 = rng.integers(0, 4, size=n)
        b = rows @ x0
        cvec = rng.integers(-4, 5, size=n)
        if cvec.sum() >= 0:
            cvec[int(rng.integers(0, n))] -= int(cvec.sum()) + 1
        obj = LinExpr()
        for j in range(n):
            if cvec[j]:
                obj += LinExpr(int(cvec[j]), xs[j])
        lp.minimize(obj)
        for i in range(m):
            e = LinExpr()
            for j in range(n):
                if rows[i, j]:
                    e += LinExpr(int(rows[i, j]), xs[j])
            lp.addConstraint(e.constraintEq(int(b[i])))
        return lp

    return build


def _unbounded_ray() -> LinProg:
    lp = LinProg("unbounded_ray")
    lp.addVar("x")
    lp.addVar("y")
    lp.maximize(LinExpr(1, "x", 1, "y"))
    lp.addConstraint(LinExpr(1, "x", -1, "y").constraintLeq(2))
    lp.addConstraint(LinExpr(-1, "x", 1, "y").constraintLeq(2))
    return lp


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def _build_cases() -> List[CorpusCase]:
    assign6, assign6_opt = _assignment(6, seed=11)
    cases = [
        CorpusCase("textbook", _textbook, F(400), oracle="reference",
                   size_hint=2),
        CorpusCase("beale", _beale, F(-1, 20), oracle="reference",
                   size_hint=3),
        CorpusCase("klee_minty_8", lambda: _klee_minty(8), F(5 ** 8),
                   size_hint=8),
        CorpusCase("assignment_6", assign6, assign6_opt, size_hint=12),
        CorpusCase("transport_degenerate", _transport_degenerate, F(340),
                   oracle="host", size_hint=8),
        CorpusCase("redundant_rows_1", _redundant_rows(1), F(-37672, 223),
                   oracle="host", size_hint=10),
        CorpusCase("redundant_rows_2", _redundant_rows(2), F(-35136, 121),
                   oracle="host", size_hint=10),
        CorpusCase("free_vars", _free_vars, F(16), oracle="host", size_hint=4),
        CorpusCase("bounded_box", _bounded_box, F(67, 2), oracle="host",
                   size_hint=5),
        CorpusCase("ill_scaled", _ill_scaled, F(3, 10000), oracle="host",
                   size_hint=3),
        CorpusCase("degenerate_b0", _degenerate_b0, F(-20), oracle="host",
                   size_hint=4),
        CorpusCase("equality_heavy_24",
                   _equality_heavy(24, 48, seed=7, name="equality_heavy_24"),
                   _dual_certificate_eq(24, 48, 7)[4], size_hint=24),
        CorpusCase("equality_heavy_96",
                   _equality_heavy(96, 192, seed=9, name="equality_heavy_96"),
                   _dual_certificate_eq(96, 192, 9)[4], size_hint=96),
        CorpusCase("equality_heavy_256",
                   _equality_heavy(256, 512, seed=3,
                                   name="equality_heavy_256"),
                   _dual_certificate_eq(256, 512, 3)[4], size_hint=256,
                   max_iters=40_000),
        CorpusCase("infeasible_gap", _infeasible_gap, None,
                   status="infeasible", size_hint=3),
        CorpusCase("unbounded_ray", _unbounded_ray, None,
                   status="unbounded", size_hint=2),
        # adversarial families (round 5, VERDICT r4 item 7)
        CorpusCase("ill_scaled_1e8", _ill_scaled_1e8,
                   F(300009999, 10**20), oracle="host", size_hint=4),
        CorpusCase("near_parallel_rows", _near_parallel_rows,
                   F(6000001, 200000), oracle="host", size_hint=3),
        CorpusCase("beale_scaled", _beale_scaled, F(-1, 20),
                   oracle="host", size_hint=3),
        CorpusCase("hidden_ray_24",
                   _hidden_ray(24, 36, seed=5, name="hidden_ray_24"),
                   None, status="unbounded", size_hint=24),
    ]
    cases.extend(_mps_file_cases())
    cases.extend(_netlib_file_cases())
    return cases


def _mps_file_cases() -> List[CorpusCase]:
    """LP fixtures from data/mps/, exercising the FULL file path
    (read_mps -> lower -> solve) in every corpus sweep. Optima are pinned by
    oracles independent of our simplex (brute-force matching, analytic
    Klee-Minty, min-cost-flow — tests/test_mps_fixtures.py); the genuine
    netlib archive is unreachable offline, so these are netlib-style files
    in the same interchange format."""
    import os

    data = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "data", "mps")
    pins = [
        # (file, exact optimum, oracle, size_hint)
        ("assign6.mps", F(36), "brute-force matching", 12),
        ("kleeminty8.mps", F(5 ** 8), "analytic", 8),
        ("transp45.mps", F(786), "min-cost-flow", 9),
        ("prodmix.mps", F(-972), "host", 6),
    ]
    out = []
    for fn, opt, oracle, hint in pins:
        path = os.path.join(data, fn)
        if not os.path.exists(path):
            continue

        def _mk(p=path):
            from .io.mps import read_mps

            return read_mps(p)

        out.append(CorpusCase(f"mps_{fn.split('.')[0]}", _mk, opt,
                              oracle=oracle, size_hint=hint))
    return out


def _netlib_file_cases() -> List[CorpusCase]:
    """GENUINE netlib instances from data/netlib/ (VERDICT r3 item 1): the
    optimum pin is the archive's PUBLISHED objective value — an oracle fully
    external to this repository. Provenance/checksum methodology in
    data/netlib/README.md (offline reconstruction accepted only on an exact
    match with the published value)."""
    import os

    data = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "data", "netlib")
    pins = [
        # (file, exact optimum, size_hint); published: -4.6475314286E+02
        ("afiro.mps", F(-406659, 875), 27),
    ]
    out = []
    for fn, opt, hint in pins:
        path = os.path.join(data, fn)
        if not os.path.exists(path):
            continue

        def _mk(p=path):
            from .io.mps import read_mps

            return read_mps(p)

        out.append(CorpusCase(f"netlib_{fn.split('.')[0]}", _mk, opt,
                              oracle="published netlib optimum",
                              size_hint=hint))
    return out


CASES: List[CorpusCase] = _build_cases()
_BY_NAME: Dict[str, CorpusCase] = {c.name: c for c in CASES}


def get_case(name: str) -> CorpusCase:
    return _BY_NAME[name]


def case_names() -> List[str]:
    return [c.name for c in CASES]


def oracle_objective(case: CorpusCase) -> Optional[F]:
    """Exact optimum: analytic when recorded, else the exact host simplex."""
    if case.objective is not None or case.status != "optimal":
        return case.objective
    from .solve.api import solve_standard_form_host

    sol = solve_standard_form_host(case.lp().lower())
    if sol.status != case.status:
        raise AssertionError(
            f"host oracle disagrees on {case.name}: {sol.status}")
    return sol.objective
