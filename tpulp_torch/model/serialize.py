"""JSON (de)serialization of LinProg models.

A model-level schema complementing the tableau-level schema (which the
reference defines, tableau.py:322-360). Exact rationals as 'p/q' strings::

    {
      "name": "plan",
      "objective": {"sense": "max", "terms": {"x": "40", "y": "30"},
                    "const": "0"},
      "constraints": [
        {"terms": {"x": "1", "y": "1"}, "comp": "<=", "rhs": "12"}
      ],
      "vars": {"x": {"integral": false, "lb": "0", "ub": null}}
    }
"""

from __future__ import annotations

import json
from fractions import Fraction
from typing import Any, Dict

from .con import LinCon
from .expr import LinExpr
from .prog import LinProg, MAX, MIN
from .var import LinVar

__all__ = ["prog_to_json", "prog_from_json", "save_prog", "load_prog"]


def _enc(f) -> str:
    return str(Fraction(f))


def _expr_terms(e: LinExpr) -> Dict[str, str]:
    return {name: _enc(coeff) for name, coeff in e.terms().items()}


def prog_to_json(prog: LinProg) -> dict:
    out: Dict[str, Any] = {
        "name": prog.name,
        "objective": {
            "sense": prog.objective.sense,
            "terms": _expr_terms(prog.objective.expr),
            "const": _enc(prog.objective.expr.getConstant()),
        },
        "constraints": [],
        "vars": {},
    }
    names = getattr(prog, "con_names", None) or []
    for ci, con in enumerate(prog.constraints):
        canon = con.simplify()
        entry = {
            "terms": _expr_terms(canon.left),
            "comp": canon.comp,
            "rhs": _enc(canon.right.getConstant()),
        }
        # optional, omitted when unnamed — older files (and the
        # reference-era schema) round-trip unchanged
        if ci < len(names) and names[ci] is not None:
            entry["name"] = names[ci]
        out["constraints"].append(entry)
    for name, v in prog.vars.items():
        out["vars"][name] = {
            "integral": v.isint,
            "lb": None if v.lb is None else _enc(v.lb),
            "ub": None if v.ub is None else _enc(v.ub),
        }
    return out


def prog_from_json(data: dict) -> LinProg:
    prog = LinProg(data.get("name", ""))
    obj = data.get("objective", {})
    expr = LinExpr(obj.get("const", "0"))
    for name, coeff in obj.get("terms", {}).items():
        expr += LinExpr(coeff, name)
    sense = obj.get("sense", MIN)
    prog.setObjective(expr, sense)
    for cdata in data.get("constraints", []):
        left = LinExpr()
        for name, coeff in cdata["terms"].items():
            left += LinExpr(coeff, name)
        prog.addConstraint(LinCon(left, cdata["comp"], LinExpr(cdata["rhs"])),
                           name=cdata.get("name"))
    for name, vdata in data.get("vars", {}).items():
        prog.addVariable(LinVar(
            name, vdata.get("integral", False),
            vdata.get("lb"), vdata.get("ub")))
    return prog


def save_prog(path: str, prog: LinProg) -> None:
    with open(path, "w") as fh:
        json.dump(prog_to_json(prog), fh, indent=2)


def load_prog(path: str) -> LinProg:
    with open(path) as fh:
        return prog_from_json(json.load(fh))
