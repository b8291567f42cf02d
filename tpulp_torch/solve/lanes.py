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
from ..kernels.lanes import lane_bounded, lane_dual, lane_plan, lane_primal
from ..kernels.launch import on_cpu
from ..kernels.rank1_cluster import cluster_plan, rank1_cluster_lanes
from .driver import run_chunked, simplex_step

__all__ = ["run_lanes", "dual_lanes", "primal_lanes", "primal_lanes_route",
           "bounded_lanes", "dual_lanes_reference", "primal_lanes_reference",
           "bounded_lanes_reference", "PRIMAL_ROUTES"]

# primal_lanes' plans: lane_primal with the frame in a block's shared
# memory, rank1_cluster_lanes (a cluster a lane, the frame in its blocks'
# shared memory), lane_primal with the frame in device memory
PRIMAL_ROUTES = ("resident", "cluster", "streamed")


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


def primal_lanes_route(M: int, N: int, dtype) -> str:
    """The plan of ``primal_lanes`` on the card for (M, N) frames of
    ``dtype``, whatever the lane count: "resident" (``lane_primal``, a
    block a lane) where ``lane_plan`` keeps the frame in one block's shared
    memory, else "cluster" (``rank1_cluster_lanes``, a cluster a lane)
    where ``rank1_cluster.cluster_plan`` holds it in a cluster of at most 8
    blocks, else "streamed" (``lane_primal``'s one block a lane working on
    the frame in device memory)."""
    try:
        if lane_plan(M, N, dtype).resident:
            return "resident"
    except ValueError:  # the vectors alone past a block's shared memory
        pass
    try:
        cluster_plan(M, N, dtype)
    except ValueError:  # past 8 blocks' shared memory
        return "streamed"
    return "cluster"


def primal_lanes(state: SimplexState, opts: SolverOptions, stall_limit: int,
                 max_iters: int, route: str | None = None) -> SimplexState:
    """Every lane's rank-1 primal loop to its exit: on the card the kernel
    of ``primal_lanes_route`` (``route`` forces one of ``PRIMAL_ROUTES``),
    the plain loop on CPU tensors."""
    if route is not None and route not in PRIMAL_ROUTES:
        raise ValueError(f"unknown route {route!r}: expected one of "
                         f"{PRIMAL_ROUTES}")
    if on_cpu(*state):
        return primal_lanes_reference(state, opts, stall_limit, max_iters)
    if route is None:
        route = primal_lanes_route(*state.T.shape[1:], state.T.dtype)
    if route == "cluster":
        return rank1_cluster_lanes(state, opts, stall_limit, max_iters)
    return lane_primal(state, opts, stall_limit, max_iters,
                       resident=route == "resident")


def bounded_lanes(bs, opts: SolverOptions, stall_limit: int,
                  max_iters: int):
    """Every lane's bounded-variable loop to its exit: the lane kernel on
    the card, the plain loop on CPU tensors."""
    if on_cpu(*(x for x in (*bs.s, bs.upper, bs.at_upper, bs.gamma)
                if x is not None)):
        return bounded_lanes_reference(bs, opts, stall_limit, max_iters)
    return lane_bounded(bs, opts, stall_limit, max_iters)
