"""IIS: an Irreducible Infeasible Subsystem of an infeasible program.

When a model is infeasible, the actionable question is *which constraints
conflict*. An IIS is a subset of the constraints that is (a) infeasible and
(b) irreducible — removing ANY single member makes the remainder feasible.

Algorithm: the classic DELETION FILTER. Starting from all constraints,
tentatively drop each one in turn; if the rest is still infeasible the
drop becomes permanent, otherwise the constraint is provably part of every
remaining conflict and is kept. One pass over m constraints yields an IIS
— correctness needs only a sound feasibility oracle, which here is the
exact host simplex at small sizes and the port's certified status ladder
(``solve/api.py``) above them.

Scope: the filter searches over the program's CONSTRAINTS; variable
bounds are treated as hard (kept in every subproblem). A conflict living
entirely inside one variable's bounds (lb > ub) is reported by lowering
as trivially infeasible before any solve. Integrality is ignored — an IIS
is an LP-relaxation notion; ``find_iis`` raises ValueError on a model whose
LP relaxation is feasible rather than fabricating one.

The counterpart of ``tpulp.solve.iis``, with one difference:
``host_max_m`` belongs to the default oracle, so a custom ``solve=``
oracle given ``host_max_m`` raises like any other default-oracle keyword
(tpulp drops it without a word).
"""

from __future__ import annotations

from typing import Callable, List, Optional

from ..model.prog import LinProg

__all__ = ["find_iis"]


def _sub_program(prog: LinProg, keep: List[int]) -> LinProg:
    sub = LinProg(prog.name)
    sub.objective = prog.objective.copy()
    for v in prog.vars.values():
        sub.addVariable(v.copy())
    for ci in keep:
        sub.addConstraint(prog.constraints[ci].copy(),
                          name=prog.con_names[ci])
    return sub


def find_iis(prog: LinProg, solve: Optional[Callable] = None,
             **solve_kwargs) -> List:
    """Deletion-filter IIS of an infeasible ``LinProg``.

    Returns the IIS as a list of constraint indices (a name replaces the
    index where the constraint was named). Raises ValueError if the
    program is feasible (or unbounded — both mean there is no IIS).

    ``solve`` overrides the feasibility oracle; it must accept a
    ``LinProg`` and return an object with a ``status`` attribute. The
    default oracle is the exact host simplex up to ``host_max_m`` rows
    (192 by default) and the port's ``solve_lp(**solve_kwargs)`` above it,
    so ``device=`` reaches the port's solver there. ``solve_kwargs``,
    ``host_max_m`` included, apply to the default oracle only. Cost: at
    most ``len(prog.constraints)`` solves of shrinking subproblems."""
    if solve is None:
        from ..model.lower import lower_to_standard_form
        from .api import Solution, solve_lp, solve_standard_form_host

        host_max_m = solve_kwargs.pop("host_max_m", 192)

        def solve(p):
            sf = lower_to_standard_form(p)
            if sf.trivially_infeasible:
                return Solution(status="infeasible")
            if sf.m <= host_max_m:
                return solve_standard_form_host(sf)
            return solve_lp(sf, **solve_kwargs)
    elif solve_kwargs:
        raise ValueError("solve_kwargs apply to the default oracle only "
                         f"(got {sorted(solve_kwargs)})")

    def feasible(keep: List[int]) -> bool:
        # feasibility only: the objective is irrelevant to an IIS, and a
        # constant objective makes 'unbounded' impossible in subproblems
        sub = _sub_program(prog, keep)
        from ..model.expr import LinExpr

        sub.objective.expr = LinExpr()
        st = solve(sub).status
        if st not in ("optimal", "infeasible", "unbounded"):
            raise RuntimeError(
                f"IIS oracle returned non-terminal status {st!r}")
        return st != "infeasible"

    m = len(prog.constraints)
    if feasible(list(range(m))):
        # distinguish 'feasible' from 'LP-feasible MILP' for the caller
        tag = "feasible"
        if prog.isMixedInteger():
            tag = ("LP-relaxation-feasible (an IIS is an LP notion; "
                   "integer infeasibility has no IIS)")
        raise ValueError(f"program is {tag}: no IIS exists")

    members = list(range(m))
    for ci in list(members):
        trial = [c for c in members if c != ci]
        if not feasible(trial):
            members = trial  # ci is redundant to the conflict: drop it
        # else: every remaining conflict needs ci — keep it
    return [prog.con_names[ci] if prog.con_names[ci] is not None else ci
            for ci in members]
