"""LinProg: a full linear/mixed-integer program container.

The reference declared this class but never implemented it (linprog.py:383-394
is an empty stub whose docstring promises max/min objectives, eq/ineq
constraints, and arbitrary bounds — SURVEY.md §2.6). This is the from-scratch
design: a problem container that lowers to standard form (see
``tpulp.model.lower``) and solves on the JAX device path (or the exact host
oracle), with branch-and-bound for integral variables.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from fractions import Fraction
from typing import Any, Dict, List, Optional

from .con import LinCon
from .expr import LinExpr, as_fraction
from .var import LinVar

__all__ = ["LinProg", "Objective", "MIN", "MAX"]

MIN = "min"
MAX = "max"


@dataclass
class Objective:
    expr: LinExpr
    sense: str = MIN

    def copy(self) -> "Objective":
        return Objective(self.expr.copy(), self.sense)


class LinProg:
    """A (mixed-integer) linear program in possibly non-standard form.

    * objective: minimize or maximize a ``LinExpr``
    * constraints: any mix of ``==``, ``<=``, ``>=`` ``LinCon``s
    * variables: arbitrary bounds (including free) via ``LinVar``; variables
      used in constraints/objective but never declared default to **free**
      (consistent with ``LinVar``'s default bounds). ``addVar`` defaults to
      ``lb=0`` for the common nonnegative case.
    """

    def __init__(self, name: str = ""):
        self.name = name
        self.objective: Objective = Objective(LinExpr(), MIN)
        self.constraints: List[LinCon] = []
        self.con_names: List[Optional[str]] = []  # aligned, entries optional
        self.vars: Dict[str, LinVar] = {}

    # -- building ------------------------------------------------------------

    def addVar(
        self,
        name: str,
        integral: bool = False,
        lb: Any = 0,
        ub: Any = None,
    ) -> LinVar:
        """Declare a variable (default nonnegative continuous) and return it."""
        v = LinVar(name, integral, lb, ub)
        return self.addVariable(v)

    def addVariable(self, v: LinVar) -> LinVar:
        if v.x in self.vars:
            raise ValueError(f"duplicate variable {v.x!r}")
        self.vars[v.x] = v
        return v

    def addConstraint(self, con: LinCon, name: Optional[str] = None) -> LinCon:
        """Add a constraint; an optional ``name`` keys its dual value in
        ``Solution.duals`` (sensitivity output)."""
        if not isinstance(con, LinCon):
            raise TypeError(f"expected LinCon, got {type(con).__name__}")
        self.constraints.append(con)
        self.con_names.append(name)
        return con

    def addConstraints(self, cons) -> None:
        for con in cons:
            self.addConstraint(con)

    def setObjective(self, expr: LinExpr, sense: str = MIN) -> None:
        if sense not in (MIN, MAX):
            raise ValueError(f"sense must be '{MIN}' or '{MAX}'")
        if not isinstance(expr, LinExpr):
            expr = LinExpr(as_fraction(expr))
        self.objective = Objective(expr.copy(), sense)

    def minimize(self, expr: LinExpr) -> None:
        self.setObjective(expr, MIN)

    def maximize(self, expr: LinExpr) -> None:
        self.setObjective(expr, MAX)

    # -- introspection -------------------------------------------------------

    def allVarNames(self) -> List[str]:
        """Sorted names of every variable appearing anywhere in the program."""
        names = set(self.vars)
        names.update(self.objective.expr.variables())
        for con in self.constraints:
            names.update(con.left.variables())
            names.update(con.right.variables())
        return sorted(names)

    def getVariable(self, name: str) -> LinVar:
        """The declared LinVar, or a fresh free LinVar for undeclared names."""
        if name in self.vars:
            return self.vars[name]
        return LinVar(name)

    def isMixedInteger(self) -> bool:
        return any(v.isint for v in self.vars.values())

    def copy(self) -> "LinProg":
        out = LinProg(self.name)
        out.objective = self.objective.copy()
        out.constraints = [c.copy() for c in self.constraints]
        out.con_names = list(self.con_names)
        out.vars = {k: v.copy() for k, v in self.vars.items()}
        return out

    def __str__(self) -> str:
        lines = [f"{self.objective.sense} {self.objective.expr}"]
        if self.constraints:
            lines.append("s.t.")
            lines.extend(f"  {c}" for c in self.constraints)
        if self.vars:
            lines.append("vars: " + ", ".join(str(v) for v in sorted(
                self.vars.values(), key=lambda v: v.x)))
        return "\n".join(lines)

    def __repr__(self) -> str:
        return f"<LinProg {self.name!r}: {len(self.allVarNames())} vars, " \
               f"{len(self.constraints)} cons>"

    # -- evaluation ----------------------------------------------------------

    def evaluate(self, assignment: Dict[str, Any]) -> Fraction:
        """Objective value under an assignment (in the stated sense)."""
        return self.objective.expr.evaluate(assignment)

    def isFeasiblePoint(self, assignment: Dict[str, Any]) -> bool:
        """Check constraints + bounds + integrality at a point."""
        for con in self.constraints:
            if not con.evaluate(assignment):
                return False
        for name, var in self.vars.items():
            val = as_fraction(assignment.get(name, 0))
            if var.lb is not None and val < var.lb:
                return False
            if var.ub is not None and val > var.ub:
                return False
            if var.isint and val.denominator != 1:
                return False
        return True

    # -- solving (delegates; see tpulp.solve / tpulp.milp) -------------------

    def lower(self, **kwargs):
        """Lower to standard form (min c.x, Ax = b, x >= 0, b >= 0)."""
        from .lower import lower_to_standard_form

        return lower_to_standard_form(self, **kwargs)

    def solve(self, presolve: bool = False, **options):
        """Solve this program. MILP if any variable is integral, else LP.

        ``presolve=True`` first shrinks the program with the exact presolve
        pass (``tpulp.model.presolve``) and maps the solution back to the
        original variables. Returns a ``tpulp.solve.Solution``. See
        ``tpulp.solve.api.solve_lp`` and ``tpulp.milp.solve_milp`` for
        options.
        """
        if presolve:
            from .presolve import solve_with_presolve

            return solve_with_presolve(self, **options)
        if self.isMixedInteger():
            from ..milp import solve_milp

            return solve_milp(self, **options)
        from ..solve import solve_lp

        return solve_lp(self, **options)
