"""Batched solving: many independent LPs in one wave of lanes."""

from .vmap_driver import (extract_batch_bounded_solutions,
                          extract_batch_solutions,
                          make_batched_bounded_states, make_batched_states,
                          run_simplex_batch, solve_lp_batch, stack_states,
                          unstack_state)

__all__ = [
    "extract_batch_solutions",
    "extract_batch_bounded_solutions",
    "make_batched_states",
    "make_batched_bounded_states",
    "run_simplex_batch",
    "solve_lp_batch",
    "stack_states",
    "unstack_state",
]
