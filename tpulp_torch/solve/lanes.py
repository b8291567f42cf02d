"""The lanes' simplex loops: the lane kernels on the card, the plain vmapped
loops on the CPU.

``dual_lanes``, ``primal_lanes`` and ``bounded_lanes`` run every lane of a
batched state to its own exit: the dual-simplex loop
(``dual.dual_simplex_step``), the rank-1 primal loop
(``driver.simplex_step``) or the bounded-variable loop
(``bounded.bounded_simplex_step`` on a batched ``BoundedState``), each lane
until its status leaves RUNNING or its ``niter`` reaches ``max_iters``
(such lanes are left RUNNING; the callers' ``finish`` maps them to
ITERATION_LIMIT). On CUDA tensors they launch ``kernels.lanes`` (one block
per lane, the whole loop in one launch, no host read); on CPU tensors
they run the plain loops,
``*_lanes_reference``: the single-state step vmapped over the lanes in
``driver.run_chunked``'s chunks (one host read of "any lane running" per
chunk). The plain loops take no CUDA tensor on the port's paths: tests and
chip_smoke.py call them on the card to hold the kernels against them.

All three give tpulp's vmapped ``lax.while_loop`` walk. The plain loops also
step finished lanes with the no-op unit pivot until the last lane ends,
which may turn a -0.0 into +0.0; the kernels, like tpulp's loops, leave a
finished lane as it was.
"""

from __future__ import annotations

import torch

from ..core.state import SimplexState, SolverOptions
from ..kernels.lanes import lane_bounded, lane_dual, lane_primal
from ..kernels.launch import on_cpu
from .driver import run_chunked, simplex_step

__all__ = ["run_lanes", "dual_lanes", "primal_lanes", "bounded_lanes",
           "dual_lanes_reference", "primal_lanes_reference",
           "bounded_lanes_reference"]


def run_lanes(step, state, max_iters: int, get_state=lambda s: s):
    """``step`` (a single-state transition that freezes finished lanes)
    vmapped over the lane axis of ``state``, until no lane runs;
    ``get_state`` finds the SimplexState in a carry that wraps one."""
    return run_chunked(torch.func.vmap(step), state, get_state, max_iters)


def dual_lanes_reference(state: SimplexState, opts: SolverOptions,
                         stall_limit: int, max_iters: int) -> SimplexState:
    """The plain dual loop: ``dual_simplex_step`` vmapped over the lanes."""
    from .dual import dual_simplex_step

    return run_lanes(
        lambda s: dual_simplex_step(s, opts, stall_limit, max_iters),
        state, max_iters)


def primal_lanes_reference(state: SimplexState, opts: SolverOptions,
                           stall_limit: int, max_iters: int) -> SimplexState:
    """The plain primal loop: ``simplex_step`` vmapped over the lanes."""
    return run_lanes(
        lambda s: simplex_step(s, opts, stall_limit, max_iters),
        state, max_iters)


def bounded_lanes_reference(bs, opts: SolverOptions, stall_limit: int,
                            max_iters: int):
    """The plain bounded loop: ``bounded_simplex_step`` vmapped over the
    lanes of the batched BoundedState ``bs``."""
    from .bounded import BoundedState, bounded_simplex_step

    # vmap maps tensors only: without devex weights the carry is the
    # first three fields, and the step sees gamma=None
    width = 4 if bs.gamma is not None else 3

    def step(c):
        out = bounded_simplex_step(BoundedState(*c), opts, stall_limit,
                                   max_iters)
        return tuple(out)[:width]

    return BoundedState(*run_lanes(step, tuple(bs)[:width], max_iters,
                                   get_state=lambda c: c[0]))


def dual_lanes(state: SimplexState, opts: SolverOptions, stall_limit: int,
               max_iters: int) -> SimplexState:
    """Every lane's dual-simplex loop to its exit: the lane kernel on the
    card, the plain loop on CPU tensors."""
    if on_cpu(*state):
        return dual_lanes_reference(state, opts, stall_limit, max_iters)
    return lane_dual(state, opts, stall_limit, max_iters)


def primal_lanes(state: SimplexState, opts: SolverOptions, stall_limit: int,
                 max_iters: int) -> SimplexState:
    """Every lane's rank-1 primal loop to its exit: the lane kernel on the
    card, the plain loop on CPU tensors."""
    if on_cpu(*state):
        return primal_lanes_reference(state, opts, stall_limit, max_iters)
    return lane_primal(state, opts, stall_limit, max_iters)


def bounded_lanes(bs, opts: SolverOptions, stall_limit: int,
                  max_iters: int):
    """Every lane's bounded-variable loop to its exit: the lane kernel on
    the card, the plain loop on CPU tensors."""
    if on_cpu(*(x for x in (*bs.s, bs.upper, bs.at_upper, bs.gamma)
                if x is not None)):
        return bounded_lanes_reference(bs, opts, stall_limit, max_iters)
    return lane_bounded(bs, opts, stall_limit, max_iters)
