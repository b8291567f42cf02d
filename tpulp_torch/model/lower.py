"""Lowering: LinProg -> equality standard form  min c.x  s.t. Ax = b, x >= 0.

This is the L3 -> L1 bridge the reference never implemented (it imports
``Tableau`` at linprog.py:7 but ``LinProg`` is a stub — SURVEY.md §1, §2.6).
Design (all exact ``Fraction`` arithmetic; floats only at ``to_dense``):

1. max f -> min -f.
2. Every variable is rewritten as an affine combination of nonnegative
   standard-form columns:
     * fixed  (lb == ub)      : x = lb                       (no column)
     * lb finite              : x = x' + lb,   x' >= 0       (one column)
       - finite ub adds a bound row  x' <= ub - lb
     * lb = -inf, ub finite   : x = ub - x',   x' >= 0       (one column)
     * free                   : x = x+ - x-,   x+, x- >= 0   (two columns)
3. Constraints are canonicalized (vars left, constant right), rewritten over
   the columns, sign-normalized so b >= 0 **before** slack insertion (so <=
   rows contribute identity slack columns usable as an initial basis), then
   made equalities with slack (+1) / surplus (-1) columns.
4. Integer variables may get dedicated bound rows (``integer_bound_rows=True``)
   so branch-and-bound nodes differ ONLY in the b vector — every B&B node then
   shares one static shape, which is what makes batched (vmapped) node solving
   possible on TPU.

The result carries an exact recovery map (column values -> original variable
values) and a basis hint (slack column per row where available) so Phase 1
only needs artificials for rows without one.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from fractions import Fraction
from typing import Dict, List, Optional, Tuple

import numpy as np

from .con import LinCon
from .expr import LinExpr
from .prog import MAX, LinProg
from .var import LinVar

__all__ = ["StandardForm", "lower_to_standard_form", "LoweringError",
           "materialize_simple_bounds"]

ZERO = Fraction(0)
ONE = Fraction(1)


class LoweringError(ValueError):
    pass


# to_dense c/A cache: (id(A), id(c), dtype) -> (A_ref, c_ref, c_arr, A_arr)
_DENSE_CA_CACHE: dict = {}


@dataclass
class StandardForm:
    """Equality-form LP with exact rational data.

    minimize    c . x + obj_const      (x >= 0)
    subject to  A x = b                (b >= 0)
    """

    c: List[Fraction]
    A: List[List[Fraction]]
    b: List[Fraction]
    col_names: List[str]
    obj_const: Fraction
    sense: str  # original objective sense ('min' or 'max')
    # per-row: index of a ready-made unit basic column (slack), or -1
    basis_hint: List[int]
    # original var -> (list[(col_index, coeff)], const): x = const + sum coeff*x_col
    recover: Dict[str, Tuple[List[Tuple[int, Fraction]], Fraction]]
    # trivially detected infeasibility during lowering (conflicting bounds or
    # an unsatisfiable constant constraint)
    trivially_infeasible: bool = False
    # integer var -> (le_row, ge_row) bound-row indices (only when requested)
    int_bound_rows: Dict[str, Tuple[int, int]] = field(default_factory=dict)
    # integer var name -> shift const so node bound u maps to b = u - shift
    int_shift: Dict[str, Fraction] = field(default_factory=dict)
    n_struct: int = 0  # structural columns (before slacks)
    # per-standard-row provenance: ("con", user_constraint_index, sign) for
    # user constraints (sign = -1 when the row was negated to make b >= 0),
    # ("bound", column, sign) for variable upper-bound rows,
    # ("intbound", 0, sign) for dedicated integer bound rows — the map that
    # carries row duals back to the USER's constraints (solve/duals)
    row_provenance: List[Tuple[str, int, int]] = field(default_factory=list)
    # simple_bounds lowering: per-column finite upper bound or None (+inf).
    # When present, finite variable bounds produced NO tableau rows — the
    # bounded-variable simplex (tpulp.solve.bounded) enforces them in the
    # ratio test instead (upper-bound flipping), keeping the tableau
    # quadratically smaller than the bound-row encoding.
    upper: Optional[List[Optional[Fraction]]] = None

    @property
    def m(self) -> int:
        return len(self.b)

    @property
    def n(self) -> int:
        return len(self.c)

    def to_dense(self, dtype=np.float64):
        """(c, A, b) as numpy arrays of the requested dtype.

        ``c``/``A`` are cached per underlying list object: B&B nodes are
        ``dataclasses.replace(root, b=...)`` clones SHARING the root's c/A
        lists, so a 128-node wave densifies the (m x n) Fraction matrix once
        instead of 128 times (measured: the dominant host cost per wave).
        Callers must not mutate the returned c/A arrays."""
        key = (id(self.A), id(self.c), np.dtype(dtype).str)
        ent = _DENSE_CA_CACHE.get(key)
        # the cached tuple holds strong refs to the lists, pinning their ids
        if ent is None or ent[0] is not self.A or ent[1] is not self.c:
            c = np.array([float(v) for v in self.c], dtype=dtype)
            a = np.array([[float(v) for v in row] for row in self.A],
                         dtype=dtype)
            if len(_DENSE_CA_CACHE) >= 8:
                _DENSE_CA_CACHE.clear()
            _DENSE_CA_CACHE[key] = ent = (self.A, self.c, c, a)
        b = np.array([float(v) for v in self.b], dtype=dtype)
        return ent[2], ent[3], b

    def recover_solution(self, x_cols) -> Dict[str, Fraction]:
        """Original variable values from standard-form column values.

        ``x_cols`` may be exact Fractions or floats; values pass through as
        given (exact in, exact out).
        """
        out: Dict[str, Fraction] = {}
        for name, (terms, const) in self.recover.items():
            val = const
            for col, coeff in terms:
                val = val + coeff * x_cols[col]
            out[name] = val
        return out

    def objective_value(self, x_cols) -> Fraction:
        """Objective (in the ORIGINAL sense) at standard-form column values."""
        val = self.obj_const
        for j in range(self.n):
            val = val + self.c[j] * x_cols[j]
        return -val if self.sense == MAX else val


def _canon_rows(prog: LinProg, subst, ncols) -> Tuple[
        List[List[Fraction]], List[Fraction], List[str], bool,
        List[Tuple[str, int, int]]]:
    """Rewrite constraints over columns -> (rows, rhs, comps,
    trivially_infeas, provenance)."""
    rows: List[List[Fraction]] = []
    rhs: List[Fraction] = []
    comps: List[str] = []
    prov: List[Tuple[str, int, int]] = []
    infeas = False
    for ci, con in enumerate(prog.constraints):
        canon = con.simplify()  # vars on left, constant on right
        row = [ZERO] * ncols
        shift = ZERO  # constant contributed by substitutions
        for name, coeff in canon.left.terms().items():
            terms, const = subst[name]
            shift += coeff * const
            for col, ccoef in terms:
                row[col] += coeff * ccoef
        r = canon.right.getConstant() - shift
        if all(v == 0 for v in row):
            # constant constraint: check satisfiability, drop the row
            ok = {"==": r == 0, "<=": r >= 0, ">=": r <= 0}[canon.comp]
            if not ok:
                infeas = True
            continue
        rows.append(row)
        rhs.append(r)
        comps.append(canon.comp)
        prov.append(("con", ci, 1))
    return rows, rhs, comps, infeas, prov


def materialize_simple_bounds(sf: StandardForm) -> StandardForm:
    """Equivalent row-based StandardForm of a ``simple_bounds`` lowering:
    every finite span becomes an explicit ``x_j + s = u`` row with its own
    slack column (and ``upper=None``). Used by paths that do not implement
    the bounded-variable ratio test (the exact host oracle, sharded
    drivers) so the precision ladder stays correct under simple_bounds."""
    import dataclasses as _dc

    if sf.upper is None or not any(u is not None for u in sf.upper):
        return _dc.replace(sf, upper=None)
    n0 = sf.n
    extra = [(j, u) for j, u in enumerate(sf.upper) if u is not None]
    n = n0 + len(extra)
    rows = [list(r) + [ZERO] * len(extra) for r in sf.A]
    rhs = list(sf.b)
    c = list(sf.c) + [ZERO] * len(extra)
    col_names = list(sf.col_names)
    basis_hint = list(sf.basis_hint)
    prov = list(sf.row_provenance)
    for k, (j, u) in enumerate(extra):
        row = [ZERO] * n
        row[j] = ONE
        row[n0 + k] = ONE
        rows.append(row)
        rhs.append(u)
        basis_hint.append(n0 + k)
        col_names.append(f"_ub{j}")
        prov.append(("bound", j, 1))
    return _dc.replace(
        sf, A=rows, b=rhs, c=c, col_names=col_names,
        basis_hint=basis_hint, row_provenance=prov, upper=None)


def lower_to_standard_form(
    prog: LinProg,
    integer_bound_rows: bool = False,
    simple_bounds: bool = False,
) -> StandardForm:
    """Lower ``prog`` to equality standard form with b >= 0. See module doc.

    ``simple_bounds=True`` keeps finite variable upper bounds OUT of the
    constraint matrix (no ``x <= u`` rows): the resulting StandardForm
    carries ``upper[col]`` spans for the bounded-variable simplex. Mutually
    exclusive with ``integer_bound_rows`` (B&B's b-only node encoding needs
    the dedicated rows)."""
    if simple_bounds and integer_bound_rows:
        raise LoweringError(
            "simple_bounds and integer_bound_rows are mutually exclusive")
    obj = prog.objective.expr
    negate_obj = prog.objective.sense == MAX
    if negate_obj:
        obj = -obj

    names = prog.allVarNames()
    lvars = {name: prog.getVariable(name) for name in names}

    # ---- variable rewrites -> columns --------------------------------------
    subst: Dict[str, Tuple[List[Tuple[int, Fraction]], Fraction]] = {}
    col_names: List[str] = []
    bound_cons: List[Tuple[int, Fraction]] = []  # (col, upper) -> x_col <= upper
    col_upper: Dict[int, Fraction] = {}          # simple_bounds spans
    trivially_infeasible = False

    def new_col(label: str) -> int:
        col_names.append(label)
        return len(col_names) - 1

    for name in names:
        v = lvars[name]
        lb, ub = v.getBounds()
        if not v.isFeasible():
            trivially_infeasible = True
            subst[name] = ([], lb if lb is not None else ZERO)
        elif lb is not None and lb == ub:
            subst[name] = ([], lb)
        elif lb is not None:
            col = new_col(name if lb == 0 else f"{name}'")
            subst[name] = ([(col, ONE)], lb)
            if ub is not None and not (integer_bound_rows and v.isint):
                if simple_bounds:
                    col_upper[col] = ub - lb  # span; no tableau row
                else:
                    # integer vars get dedicated bound rows below instead
                    bound_cons.append((col, ub - lb))
        elif ub is not None:
            col = new_col(f"{name}^")
            subst[name] = ([(col, -ONE)], ub)
        else:  # free
            cp = new_col(f"{name}+")
            cn = new_col(f"{name}-")
            subst[name] = ([(cp, ONE), (cn, -ONE)], ZERO)

    n_struct = len(col_names)

    # ---- constraint rows ----------------------------------------------------
    rows, rhs, comps, cinfeas, prov = _canon_rows(prog, subst, n_struct)
    trivially_infeasible = trivially_infeasible or cinfeas

    # variable upper-bound rows (x_col <= u, u >= 0 by construction)
    for col, upper in bound_cons:
        row = [ZERO] * n_struct
        row[col] = ONE
        rows.append(row)
        rhs.append(upper)
        comps.append("<=")
        prov.append(("bound", col, 1))

    # dedicated integer bound rows: node-dependent data lives ONLY in b
    int_bound_rows: Dict[str, Tuple[int, int]] = {}
    int_shift: Dict[str, Fraction] = {}
    if integer_bound_rows:
        for name in names:
            v = lvars[name]
            if not v.isint:
                continue
            terms, const = subst[name]
            if not terms:
                continue  # fixed var: nothing to branch on
            lb, ub = v.getBounds()
            if lb is None or ub is None:
                raise LoweringError(
                    f"integer var {name!r} needs finite root bounds for "
                    f"branch-and-bound (got {v})")
            row = [ZERO] * n_struct
            for col, coeff in terms:
                row[col] = coeff
            # x - const <= ub - const   (rhs >= 0 since root lb <= ub)
            rows.append(list(row))
            rhs.append(ub - const)
            comps.append("<=")
            prov.append(("intbound", 0, 1))
            # x - const >= lb - const   (rhs >= 0: col shift uses lb itself)
            rows.append(list(row))
            rhs.append(lb - const)
            comps.append(">=")
            prov.append(("intbound", 0, 1))
            int_bound_rows[name] = (len(rows) - 2, len(rows) - 1)
            int_shift[name] = const

    # an LP with no remaining rows still needs a nonempty tableau: pad with
    # the vacuous row 0.x <= 0 (its slack gives a ready one-row basis)
    if not rows:
        rows.append([ZERO] * n_struct)
        rhs.append(ZERO)
        comps.append("<=")
        prov.append(("pad", 0, 1))

    # ---- sign-normalize then add slack/surplus ------------------------------
    m = len(rows)
    for i in range(m):
        if rhs[i] < 0:
            rows[i] = [-v for v in rows[i]]
            rhs[i] = -rhs[i]
            comps[i] = {"==": "==", "<=": ">=", ">=": "<="}[comps[i]]
            kind, ref, sign = prov[i]
            prov[i] = (kind, ref, -sign)

    basis_hint = [-1] * m
    for i in range(m):
        if comps[i] == "==":
            continue
        col = len(col_names)
        if comps[i] == "<=":
            col_names.append(f"_s{i}")
            coeff = ONE
            basis_hint[i] = col
        else:
            col_names.append(f"_e{i}")
            coeff = -ONE
        for ii in range(m):
            rows[ii].append(coeff if ii == i else ZERO)

    n = len(col_names)

    # ---- objective over columns --------------------------------------------
    c = [ZERO] * n
    obj_const = obj.getConstant()
    for name, coeff in obj.terms().items():
        terms, const = subst[name]
        obj_const += coeff * const
        for col, ccoef in terms:
            c[col] += coeff * ccoef

    upper = None
    if simple_bounds:
        upper = [col_upper.get(j) for j in range(n)]

    return StandardForm(
        c=c,
        A=rows,
        b=rhs,
        col_names=col_names,
        obj_const=obj_const,
        sense=prog.objective.sense,
        basis_hint=basis_hint,
        recover=subst,
        trivially_infeasible=trivially_infeasible,
        int_bound_rows=int_bound_rows,
        int_shift=int_shift,
        n_struct=n_struct,
        row_provenance=prov,
        upper=upper,
    )
