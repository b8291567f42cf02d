"""MPS reader/writer: load netlib-style LP/MILP instances into ``LinProg``.

The reference's only interchange format is its JSON tableau schema
(lpsol/tableau.py:312-360); real LP test sets (netlib, miplib) ship as MPS.
This module parses the MPS commonly found in the wild — fixed or free field
layout (tokenized by whitespace), ``OBJSENSE``, ``ROWS`` (N/L/G/E),
``COLUMNS`` with ``INTORG``/``INTEND`` integrality markers, ``RHS``
(including an objective-row entry = negated objective constant), ``RANGES``,
and the full ``BOUNDS`` vocabulary (UP LO FX FR MI PL BV UI LI) — and builds
a ``tpulp.model.LinProg`` exactly (coefficients become ``Fraction``s via
their decimal literals, so nothing is lost before the solver chooses a
dtype).

Semantics follow the standard conventions:

* the FIRST ``N`` row is the objective; later ``N`` rows are ignored (free
  rows);
* a ``RANGES`` entry with value r on row with rhs b adds the second side of
  the two-sided constraint: L: b-|r| <= ax <= b; G: b <= ax <= b+|r|;
  E: b <= ax <= b+r for r>=0, b+r <= ax <= b for r<0;
* bounds default to [0, +inf); ``UP`` with a negative value on a variable
  with no explicit lower bound drops the lower bound to -inf (the classical
  MPS quirk, implemented by most solvers);
* ``BV`` makes the variable integral in [0, 1]; ``UI``/``LI`` set integral
  upper/lower bounds.

Variable/row names that are not valid tpulp identifiers
(``VARNAME_RE = [_A-Za-z][_A-Za-z0-9]*``) are sanitized (invalid characters
-> ``_``, digit-leading names prefixed, collisions suffixed); the original
spelling is kept in the returned program's ``mps_names`` attribute
(sanitized -> original) so solutions can be reported in the file's names.
"""

from __future__ import annotations

import re
from fractions import Fraction
from typing import Dict, Optional, TextIO, Union

from ..model import MAX, MIN, LinCon, LinExpr, LinProg, LinVar, VARNAME_RE

__all__ = ["read_mps", "read_mps_string", "write_mps", "write_mps_string"]


def _frac(tok: str) -> Fraction:
    try:
        return Fraction(tok)
    except ValueError as e:
        raise ValueError(f"bad MPS numeric literal: {tok!r}") from e


class _Names:
    """Sanitize arbitrary MPS names into valid tpulp identifiers."""

    def __init__(self):
        self.fwd: Dict[str, str] = {}    # original -> sanitized
        self.rev: Dict[str, str] = {}    # sanitized -> original

    def get(self, orig: str) -> str:
        if orig in self.fwd:
            return self.fwd[orig]
        s = re.sub(r"[^_A-Za-z0-9]", "_", orig)
        if not s or not re.match(r"[_A-Za-z]", s[0]):
            s = "_" + s
        base, k = s, 2
        while s in self.rev:            # collision after sanitizing
            s = f"{base}_{k}"
            k += 1
        assert VARNAME_RE.fullmatch(s)
        self.fwd[orig] = s
        self.rev[s] = orig
        return s


class _Row:
    __slots__ = ("kind", "expr", "rhs", "range_")

    def __init__(self, kind: str):
        self.kind = kind                 # 'N' | 'L' | 'G' | 'E'
        self.expr = LinExpr()
        self.rhs: Optional[Fraction] = None
        self.range_: Optional[Fraction] = None


def read_mps_string(text: str) -> LinProg:
    """Parse MPS text into a ``LinProg`` (see module docstring)."""
    lp = LinProg()
    names = _Names()
    rows: Dict[str, _Row] = {}
    row_order = []
    obj_row: Optional[str] = None
    obj_const = Fraction(0)
    sense = MIN
    integral = False
    # (orig var name, explicit-lb?, explicit-ub?) bookkeeping for the UP<0 rule
    seen_lb: Dict[str, bool] = {}
    section = None

    def ensure_var(orig: str) -> str:
        name = names.get(orig)
        if name not in lp.vars:
            lp.addVar(name, integral=False, lb=0, ub=None)
        return name

    for raw in text.splitlines():
        if not raw.strip() or raw.lstrip().startswith("*"):
            continue
        is_header = not raw[0].isspace()
        toks = raw.split()
        if is_header:
            head = toks[0].upper()
            if head == "NAME":
                lp.name = toks[1] if len(toks) > 1 else ""
                section = "NAME"
            elif head == "OBJSENSE":
                section = "OBJSENSE"
                if len(toks) > 1:
                    sense = MAX if toks[1].upper() in ("MAX", "MAXIMIZE") \
                        else MIN
            elif head in ("ROWS", "COLUMNS", "RHS", "RANGES", "BOUNDS"):
                section = head
            elif head == "ENDATA":
                break
            else:
                raise ValueError(f"unknown MPS section: {toks[0]!r}")
            continue

        if section == "OBJSENSE":
            sense = MAX if toks[0].upper() in ("MAX", "MAXIMIZE") else MIN
        elif section == "ROWS":
            kind = toks[0].upper()
            if kind not in ("N", "L", "G", "E"):
                raise ValueError(f"bad row kind {toks[0]!r}")
            rname = toks[1]
            rows[rname] = _Row(kind)
            row_order.append(rname)
            if kind == "N" and obj_row is None:
                obj_row = rname
        elif section == "COLUMNS":
            if len(toks) >= 3 and toks[1].upper() == "'MARKER'":
                mk = toks[2].strip("'").upper()
                if mk == "INTORG":
                    integral = True
                elif mk == "INTEND":
                    integral = False
                continue
            # tolerate the marker fields in either order
            if "'MARKER'" in (t.upper() for t in toks):
                up = [t.strip("'").upper() for t in toks]
                integral = "INTORG" in up or (integral and "INTEND" not in up)
                continue
            col = ensure_var(toks[0])
            if integral:
                lp.vars[col].isint = True
            pairs = toks[1:]
            if len(pairs) % 2:
                raise ValueError(f"odd COLUMNS fields: {raw!r}")
            for rname, val in zip(pairs[::2], pairs[1::2]):
                if rname not in rows:
                    raise ValueError(f"COLUMNS references unknown row "
                                     f"{rname!r}")
                rows[rname].expr += LinExpr(_frac(val), col)
        elif section == "RHS":
            pairs = toks[1:]
            if len(pairs) % 2:
                # some files omit the rhs-set name
                pairs = toks
            for rname, val in zip(pairs[::2], pairs[1::2]):
                if rname not in rows:
                    raise ValueError(f"RHS references unknown row {rname!r}")
                if rname == obj_row:
                    obj_const = -_frac(val)
                else:
                    rows[rname].rhs = _frac(val)
        elif section == "RANGES":
            pairs = toks[1:]
            if len(pairs) % 2:
                pairs = toks
            for rname, val in zip(pairs[::2], pairs[1::2]):
                if rname not in rows:
                    raise ValueError(f"RANGES references unknown row "
                                     f"{rname!r}")
                rows[rname].range_ = _frac(val)
        elif section == "BOUNDS":
            btype = toks[0].upper()
            # "BTYPE SET COL [VAL]"; tolerate a missing set name for the
            # value-less types
            if btype in ("FR", "MI", "PL", "BV"):
                col = ensure_var(toks[-1] if len(toks) == 2 else toks[2])
                val = None
            else:
                if len(toks) < 4:
                    col = ensure_var(toks[1])
                    val = _frac(toks[2])
                else:
                    col = ensure_var(toks[2])
                    val = _frac(toks[3])
            v = lp.vars[col]
            orig = names.rev[col]
            if btype == "UP":
                v.ub = val
                if val < 0 and not seen_lb.get(orig):
                    v.lb = None          # the classical UP<0 quirk
            elif btype == "LO":
                v.lb = val
                seen_lb[orig] = True
            elif btype == "FX":
                v.lb = v.ub = val
                seen_lb[orig] = True
            elif btype == "FR":
                v.lb = v.ub = None
            elif btype == "MI":
                v.lb = None
            elif btype == "PL":
                v.ub = None
            elif btype == "BV":
                v.isint = True
                v.lb, v.ub = Fraction(0), Fraction(1)
                seen_lb[orig] = True
            elif btype == "UI":
                v.isint = True
                v.ub = val
            elif btype == "LI":
                v.isint = True
                v.lb = val
                seen_lb[orig] = True
            else:
                raise ValueError(f"unknown bound type {btype!r}")
            if v.isint:
                v._snap()
        elif section in ("NAME", None):
            raise ValueError(f"data line outside any section: {raw!r}")

    if obj_row is None:
        raise ValueError("MPS file has no objective (N) row")

    lp.setObjective(rows[obj_row].expr + obj_const, sense)
    row_names = []                       # original row name per constraint

    def add(rname, expr, comp, rhs):
        # the original row name also keys the constraint's dual value
        lp.addConstraint(LinCon(expr, comp, LinExpr(rhs)), name=rname)
        row_names.append(rname)

    for rname in row_order:
        row = rows[rname]
        if row.kind == "N":
            continue                     # objective / free rows
        rhs = row.rhs if row.rhs is not None else Fraction(0)
        if row.kind == "L":
            add(rname, row.expr.copy(), "<=", rhs)
            if row.range_ is not None:
                # the RANGES-generated second side gets a derived name so a
                # write round-trip emits unique row identifiers
                add(f"{rname}__RNG", row.expr.copy(), ">=",
                    rhs - abs(row.range_))
        elif row.kind == "G":
            add(rname, row.expr.copy(), ">=", rhs)
            if row.range_ is not None:
                add(f"{rname}__RNG", row.expr.copy(), "<=",
                    rhs + abs(row.range_))
        else:                            # E
            if row.range_ is None:
                add(rname, row.expr.copy(), "==", rhs)
            else:
                lo = rhs + min(row.range_, 0)
                hi = rhs + max(row.range_, 0)
                add(rname, row.expr.copy(), ">=", lo)
                add(f"{rname}__RNG", row.expr.copy(), "<=", hi)

    lp.mps_names = dict(names.rev)       # sanitized -> original
    lp.mps_row_names = row_names         # aligned with lp.constraints
    lp.mps_obj_name = obj_row
    return lp


def read_mps(path_or_file: Union[str, TextIO]) -> LinProg:
    """Read an MPS file (path or open text file) into a ``LinProg``."""
    if hasattr(path_or_file, "read"):
        return read_mps_string(path_or_file.read())
    with open(path_or_file) as f:
        return read_mps_string(f.read())


def _num(x: Fraction) -> str:
    """Exact decimal if the denominator is 10-smooth, else a float literal."""
    d = x.denominator
    while d % 2 == 0:
        d //= 2
    while d % 5 == 0:
        d //= 5
    if d == 1:
        from decimal import Decimal
        return str(Decimal(x.numerator) / Decimal(x.denominator))
    return repr(float(x))


def write_mps_string(lp: LinProg, name: Optional[str] = None) -> str:
    """Serialize a ``LinProg`` as (free-format) MPS text.

    Programs that came through ``read_mps`` carry their original spellings
    (``mps_names``/``mps_row_names``/``mps_obj_name``); the writer emits
    those, so a read -> write round trip preserves the file's identifiers
    (they are valid whitespace-free MPS tokens by construction). Programs
    built directly get their tpulp variable names and generated ``R{i}``
    row names."""
    var_orig: Dict[str, str] = getattr(lp, "mps_names", None) or {}
    row_orig = getattr(lp, "mps_row_names", None)
    if row_orig is None or len(row_orig) != len(lp.constraints):
        row_orig = [f"R{i}" for i in range(len(lp.constraints))]
    obj_name = getattr(lp, "mps_obj_name", None) or "COST"

    def vname(nm: str) -> str:
        return var_orig.get(nm, nm)

    out = [f"NAME          {name or lp.name or 'TPULP'}"]
    if lp.objective.sense == MAX:
        out += ["OBJSENSE", "    MAX"]
    out.append("ROWS")
    out.append(f" N  {obj_name}")
    cons = []
    for i, con in enumerate(lp.constraints):
        s = con.simplify()               # vars-on-left, const-on-right
        kind = {"<=": "L", ">=": "G", "==": "E"}[s.comp]
        rname = row_orig[i]
        cons.append((rname, kind, s.left, s.right.getConstant()))
        out.append(f" {kind}  {rname}")
    obj = lp.objective.expr
    varnames = sorted(set(lp.vars)
                      | {v for _, _, e, _ in cons for v in e.variables()}
                      | set(obj.variables()))
    out.append("COLUMNS")
    in_int = False
    mk = 0
    ordered = sorted(varnames, key=lambda nm: not lp.getVariable(nm).isint)
    for nm in ordered:
        isint = lp.getVariable(nm).isint
        if isint and not in_int:
            out.append(f"    MARKER{mk}    'MARKER'    'INTORG'")
            in_int, mk = True, mk + 1
        elif not isint and in_int:
            out.append(f"    MARKER{mk}    'MARKER'    'INTEND'")
            in_int, mk = False, mk + 1
        coef = obj.getCoefficient(nm)
        if coef:
            out.append(f"    {vname(nm)}  {obj_name}  {_num(coef)}")
        for rname, _, expr, _ in cons:
            c = expr.getCoefficient(nm)
            if c:
                out.append(f"    {vname(nm)}  {rname}  {_num(c)}")
    if in_int:
        out.append(f"    MARKER{mk}    'MARKER'    'INTEND'")
    out.append("RHS")
    oc = obj.getConstant()
    if oc:
        out.append(f"    RHS  {obj_name}  {_num(-oc)}")
    for rname, _, _, rhs in cons:
        if rhs:
            out.append(f"    RHS  {rname}  {_num(rhs)}")
    out.append("BOUNDS")
    for nm in varnames:
        v = lp.getVariable(nm)
        if v.lb is None and v.ub is None:
            out.append(f" FR BND  {vname(nm)}")
            continue
        if v.lb is None:
            out.append(f" MI BND  {vname(nm)}")
        elif v.lb != 0:
            k = "LI" if v.isint else "LO"
            out.append(f" {k} BND  {vname(nm)}  {_num(v.lb)}")
        if v.ub is not None:
            k = "UI" if v.isint else "UP"
            out.append(f" {k} BND  {vname(nm)}  {_num(v.ub)}")
    out.append("ENDATA")
    return "\n".join(out) + "\n"


def write_mps(lp: LinProg, path_or_file: Union[str, TextIO],
              name: Optional[str] = None) -> None:
    """Write a ``LinProg`` to an MPS file (path or open text file)."""
    text = write_mps_string(lp, name)
    if hasattr(path_or_file, "write"):
        path_or_file.write(text)
        return
    with open(path_or_file, "w") as f:
        f.write(text)
