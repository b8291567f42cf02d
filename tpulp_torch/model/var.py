"""Decision variables with bounds and integrality.

Capability parity with the reference ``LinVar`` (linprog.py:311-381): integral
variables have their bounds snapped inward to integers on construction and on
every tightening — exactly the bound-tightening step a branch-and-bound node
applies when branching.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Any, Optional, Tuple

from .expr import VARNAME_RE, as_fraction

__all__ = ["LinVar"]


class LinVar:
    """A named variable with optional bounds; ``None`` bound means +/-inf."""

    __slots__ = ("x", "isint", "lb", "ub")

    def __init__(
        self,
        x: str,
        integral: bool = False,
        lb: Any = None,
        ub: Any = None,
    ):
        if not isinstance(x, str) or not VARNAME_RE.fullmatch(x):
            raise ValueError(f"invalid var name: {x!r}")
        self.x: str = x
        self.isint: bool = bool(integral)
        self.lb: Optional[Fraction] = None if lb is None else as_fraction(lb)
        self.ub: Optional[Fraction] = None if ub is None else as_fraction(ub)
        self._snap()

    def _snap(self) -> None:
        """Round bounds inward to integers for integral variables."""
        if not self.isint:
            return
        if self.lb is not None:
            self.lb = Fraction(math.ceil(self.lb))
        if self.ub is not None:
            self.ub = Fraction(math.floor(self.ub))

    def copy(self) -> "LinVar":
        return LinVar(self.x, self.isint, self.lb, self.ub)

    def getBounds(self) -> Tuple[Optional[Fraction], Optional[Fraction]]:
        """(lb, ub) with None meaning unbounded on that side."""
        return (self.lb, self.ub)

    def boundAbove(self, ub: Any) -> None:
        """Tighten: require self <= ub (no-op if looser than current ub)."""
        ub = as_fraction(ub)
        if self.ub is None or ub < self.ub:
            self.ub = ub
            self._snap()

    def boundBelow(self, lb: Any) -> None:
        """Tighten: require self >= lb (no-op if looser than current lb)."""
        lb = as_fraction(lb)
        if self.lb is None or lb > self.lb:
            self.lb = lb
            self._snap()

    def isFeasible(self) -> bool:
        """True iff the feasible interval is nonempty."""
        if self.lb is None or self.ub is None:
            return True
        return self.lb <= self.ub

    def isFixed(self) -> bool:
        """True iff the bounds pin the variable to a single value."""
        return self.lb is not None and self.lb == self.ub

    def __str__(self) -> str:
        lo = "-inf" if self.lb is None else str(self.lb)
        hi = "+inf" if self.ub is None else str(self.ub)
        dom = "Z" if self.isint else "R"
        return f"{self.x}@{dom}[{lo},{hi}]"

    def __repr__(self) -> str:
        def enc(bound: Optional[Fraction]):
            if bound is None:
                return None
            if bound.denominator == 1:
                return bound.numerator
            return str(bound)

        return (
            f"LinVar({self.x!r}, {self.isint!r}, "
            f"{enc(self.lb)!r}, {enc(self.ub)!r})"
        )

    def __eq__(self, other: Any) -> bool:
        if not isinstance(other, LinVar):
            return NotImplemented
        return (
            self.x == other.x
            and self.isint == other.isint
            and self.lb == other.lb
            and self.ub == other.ub
        )

    def __hash__(self) -> int:
        return hash((self.x, self.isint, self.lb, self.ub))
