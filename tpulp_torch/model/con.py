"""Linear constraints: two linear expressions joined by ==, <= or >=.

Capability parity with the reference ``LinCon`` (linprog.py:224-309), with the
side-coercion bug fixed: the reference only wrapped ``right`` when ``left`` was
already a LinExpr (linprog.py:235-238, SURVEY.md §2.7-3); here BOTH sides are
independently coerced to LinExpr.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Any, Mapping

from .expr import LinExpr, as_fraction

__all__ = ["LinCon", "COMPARATORS"]

COMPARATORS = ("==", "<=", ">=")

_REVERSED = {"==": "==", "<=": ">=", ">=": "<="}


def _coerce_side(side: Any) -> LinExpr:
    if isinstance(side, LinExpr):
        return side
    return LinExpr(as_fraction(side))


class LinCon:
    """A constraint ``left comp right`` with ``comp in {'==', '<=', '>='}``."""

    __slots__ = ("left", "comp", "right")

    def __init__(self, left: Any, comp: str, right: Any):
        if comp not in COMPARATORS:
            raise ValueError(f"comparator must be one of {COMPARATORS}, got {comp!r}")
        self.left: LinExpr = _coerce_side(left)
        self.comp: str = comp
        self.right: LinExpr = _coerce_side(right)

    # -- comparison / copy ---------------------------------------------------

    def __eq__(self, other: Any) -> bool:
        if not isinstance(other, LinCon):
            return NotImplemented
        return (
            self.left == other.left
            and self.comp == other.comp
            and self.right == other.right
        )

    def __hash__(self) -> int:
        return hash((self.left, self.comp, self.right))

    def copy(self) -> "LinCon":
        return LinCon(self.left.copy(), self.comp, self.right.copy())

    # -- rendering -----------------------------------------------------------

    def __str__(self) -> str:
        return f"{self.left} {self.comp} {self.right}"

    def __repr__(self) -> str:
        return f"LinCon({self.left!r}, {self.comp!r}, {self.right!r})"

    # -- transforms ----------------------------------------------------------

    def reverse(self) -> "LinCon":
        """Swap sides, flipping the comparator accordingly."""
        return LinCon(self.right.copy(), _REVERSED[self.comp], self.left.copy())

    def simplify(self) -> "LinCon":
        """Canonical form: all variable terms on the left, constant on the right.

        ``left comp right``  ->  ``(left - right - k) comp (-k)`` where
        ``k = (left - right).getConstant()``.
        """
        diff = self.left - self.right
        const = diff.getConstant()
        diff -= const
        return LinCon(diff, self.comp, LinExpr(-const))

    # -- evaluation ----------------------------------------------------------

    def evaluate(self, assignment: Mapping[str, Any]) -> bool:
        lhs = self.left.evaluate(assignment)
        rhs = self.right.evaluate(assignment)
        if self.comp == "==":
            return lhs == rhs
        if self.comp == "<=":
            return lhs <= rhs
        return lhs >= rhs

    # -- in-place side editing ----------------------------------------------

    def addLeft(self, a: Any) -> None:
        self.left += a

    def addRight(self, a: Any) -> None:
        self.right += a

    def subLeft(self, a: Any) -> None:
        self.left -= a

    def subRight(self, a: Any) -> None:
        self.right -= a
