"""Debug mode: invariant checks and a structured trace, one pivot at a time.

The counterpart of ``tpulp.utils.debug``. The reference verifies itself
only with asserts inside the solver (canonical form, an objective that
never rises: simplex.py:106,133,148); here that is an explicit driver
that steps the port's ``simplex_step`` one pivot at a time from the host,
checks the form predicates and the objective's monotonicity at a chosen
cadence, and records each iteration (objective, entering and leaving
column, degeneracy, phase). Production runs use ``run_simplex`` or
``run_simplex_blocked``; this path trades speed for visibility.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..core.predicates import is_canonical, is_degenerate
from ..core.state import SimplexState, SolverOptions, Status

__all__ = ["IterationRecord", "DebugReport", "run_simplex_debug",
           "InvariantViolation"]


class InvariantViolation(AssertionError):
    pass


@dataclasses.dataclass
class IterationRecord:
    niter: int
    phase: int
    objective: float
    entering: Optional[int]   # column that entered the basis this pivot
    leaving: Optional[int]    # column that left
    row: Optional[int]        # pivot row
    degenerate: bool
    bland_active: bool


@dataclasses.dataclass
class DebugReport:
    status: str
    records: List[IterationRecord]
    violations: List[str]

    @property
    def num_pivots(self) -> int:
        return sum(1 for r in self.records if r.entering is not None)


def run_simplex_debug(
    state: SimplexState,
    opts: Optional[SolverOptions] = None,
    check_every: int = 1,
    raise_on_violation: bool = True,
    max_steps: Optional[int] = None,
) -> tuple:
    """(final_state, DebugReport): step the solver from the host with
    invariant checks. Every ``check_every`` steps: canonical form (basic
    columns are units, b >= 0, zero reduced costs) and, within phase 2, an
    objective that never rises."""
    from ..solve.driver import simplex_step

    if opts is None:
        opts = SolverOptions.for_dtype(state.T.dtype)
    stall_limit = opts.resolved_stall_limit(state.m, state.n)

    records: List[IterationRecord] = []
    violations: List[str] = []
    last_z = float("inf")
    last_phase = int(state.phase)
    steps = 0
    limit = (max_steps if max_steps is not None
             else opts.max_iters + state.m + 8)

    while int(state.status) == Status.RUNNING and steps < limit:
        prev_basis = state.basis.cpu().numpy().copy()
        prev_niter = int(state.niter)
        state = simplex_step(state, opts, stall_limit)
        steps += 1

        basis = state.basis.cpu().numpy()
        pivoted = int(state.niter) > prev_niter
        entering = leaving = row = None
        if pivoted:
            changed = np.nonzero(basis != prev_basis)[0]
            if changed.size:
                row = int(changed[0])
                entering = int(basis[row])
                leaving = int(prev_basis[row])
        phase = int(state.phase)
        z = float(state.objective())
        records.append(IterationRecord(
            niter=int(state.niter),
            phase=phase,
            objective=z,
            entering=entering,
            leaving=leaving,
            row=row,
            degenerate=bool(is_degenerate(state)),
            bland_active=bool(state.bland),
        ))

        if steps % check_every == 0:
            tol = max(opts.opt_tol * 1e3, 1e-6)
            if not bool(is_canonical(state, tol=tol)):
                violations.append(
                    f"step {steps}: tableau not canonical (tol={tol})")
            if phase == last_phase == 2 and pivoted and \
                    z > last_z + max(opts.degen_tol, tol):
                violations.append(
                    f"step {steps}: objective increased {last_z} -> {z}")
            if violations and raise_on_violation:
                raise InvariantViolation(violations[-1])
        if phase == 2:
            if last_phase != 2:
                last_z = float("inf")
            last_z = min(last_z, z) if pivoted else last_z
        last_phase = phase

    status = Status.NAMES.get(int(state.status), "running")
    return state, DebugReport(status=status, records=records,
                              violations=violations)
