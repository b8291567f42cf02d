"""MILP: branch-and-bound over batched LP relaxations."""

from .bnb import BnbStats, solve_milp

__all__ = ["solve_milp", "BnbStats"]
