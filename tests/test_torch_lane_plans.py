"""The redesigned lane kernels' launch plans, ``primal_lanes``' and
``dual_lanes``' three-way routes and the cluster lanes' plain version, on
the CPU.

``lane_plan`` / ``lane_bounded_plan`` / ``lane_dual_plan`` give
``lane_primal``'s, ``lane_bounded``'s and ``lane_dual``'s layout (the
frame's n columns at an odd row pitch, the RHS and the basis twice, the
pivot's column; bounded: the spans, the devex weights, the at-upper flags
and two snapshot columns; the dual loop shares the primal's) and a block
of 32 to 256 threads from the frame's width. ``primal_lanes`` and
``dual_lanes`` take the one-block kernel where one block holds the frame,
the cluster lanes where a cluster does, else the one-block streamed plan.
The cluster lanes' plain version (``rank1_cluster_lanes_reference``:
``rank1_cluster_reference`` on each lane) is held bit for bit at f64
against tpulp's vmapped driver (``_batched_driver``) on lanes with
broadcast masks (lane stride 0) and a lane frozen at the start, at every
cluster size, and its dual walk against tpulp's ``run_dual_simplex`` lane
by lane. The kernels themselves run on the card only
(tests/test_torch_lanes_card.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpulp_torch.kernels.rank1_cluster as kc
from tpulp.batch.vmap_driver import _batched_driver
from tpulp.core.state import SimplexState as JState
from tpulp.core.state import SolverOptions as JOptions
from tpulp.solve import dual as jdual
from tpulp.solve.driver import _budget_key
from tpulp_torch.core import SolverOptions, Status
from tpulp_torch.core.state import SimplexState
from tpulp_torch.kernels import lanes as kl
from tpulp_torch.kernels.lanes import (lane_bounded_plan, lane_dual_plan,
                                       lane_plan, lane_threads)
from tpulp_torch.solve import lanes
from tpulp_torch.solve.driver import finish

from test_torch_lanes import _cold_leaves, _dual_leaves, _pair, _same

torch.set_num_threads(1)

# (M, N) -> threads: a thread a column or a row in whole warps, doubled
# where the frame has 32 rows or more and the doubled block stays within
# 256 (the kernel then splits each column's rows over two lanes)
THREAD_CASES = {
    "spans_3x30": ((3, 30), 32),
    "small_14x23": ((14, 23), 32),
    "mixed_18x41": ((18, 41), 64),
    "bland_42x121": ((42, 121), 256),
    "knapsack_59x114": ((59, 114), 256),
    "box_66x193": ((66, 193), 192),
    "scenarios_66x257": ((66, 257), 256),
    "tall_300x20": ((300, 20), 256),
    "wide_258x513": ((258, 513), 256),
}


@pytest.mark.parametrize("case", THREAD_CASES)
def test_lane_threads(case):
    (M, N), want = THREAD_CASES[case]
    assert lane_threads(M, N) == want
    assert lane_plan(M, N, torch.float64).threads == want
    assert lane_bounded_plan(M, N, torch.float32).threads == want
    assert lane_dual_plan(M, N, torch.float64).threads == want


@pytest.mark.parametrize("plan", [lane_plan, lane_bounded_plan,
                                  lane_dual_plan])
def test_forced_plans(plan):
    """``threads`` forces the block (its bytes unchanged), ``resident=False``
    the streamed plan (the vectors alone), ``resident=True`` raises where
    the frame does not fit."""
    base = plan(59, 114, torch.float64)
    for th in (32, 64, 160, 256):
        forced = plan(59, 114, torch.float64, threads=th)
        assert forced == base._replace(threads=th)
    for th in (0, 16, 48, 288, 512):
        with pytest.raises(ValueError, match="multiple of 32"):
            plan(59, 114, torch.float64, threads=th)
    streamed = plan(59, 114, torch.float64, resident=False)
    assert not streamed.resident
    assert streamed.smem == base.smem - (59 * 113 * 8 + 15) // 16 * 16
    assert plan(59, 114, torch.float64, resident=True) == base
    with pytest.raises(ValueError, match="resident"):
        plan(258, 513, torch.float64, resident=True)
    assert plan(258, 513, torch.float64) == plan(258, 513, torch.float64,
                                                 resident=False)


def test_lane_plan_counts_the_kernel_layout():
    """The frame's n columns at an odd pitch (n | 1), three vectors of M
    (the RHS twice and the pivot's column), the basis twice, two masks;
    each segment 16-byte aligned."""
    def al(x):
        return (x + 15) // 16 * 16

    for M, N, dt, es in ((59, 114, torch.float64, 8),
                         (66, 193, torch.float32, 4),
                         (3, 30, torch.float64, 8), (9, 17, torch.float32, 4)):
        m, n = M - 2, N - 1
        vectors = 3 * al(M * es) + 2 * al(4 * m) + 2 * al(n)
        assert lane_plan(M, N, dt).smem == vectors + al(M * (n | 1) * es)
        assert (n | 1) % 2 == 1 and n <= (n | 1) <= n + 1


def test_lane_dual_plan_counts_the_kernel_layout():
    """``lane_dual`` launches with csrc/lanes.cu's walk_smem_bytes, as
    ``lane_primal``: the frame's n columns at an odd pitch, three vectors of
    M, the basis twice, two masks, each segment 16-byte aligned; streamed,
    the vectors alone; the block from the frame's width."""
    def al(x):
        return (x + 15) // 16 * 16

    for M, N, dt, es in ((59, 114, torch.float64, 8),
                         (66, 193, torch.float32, 4),
                         (3, 30, torch.float64, 8), (9, 17, torch.float32, 4),
                         (258, 513, torch.float64, 8)):
        m, n = M - 2, N - 1
        vectors = 3 * al(M * es) + 2 * al(4 * m) + 2 * al(n)
        plan = lane_dual_plan(M, N, dt)
        assert plan.smem == vectors + al(M * (n | 1) * es) or (
            not plan.resident and plan.smem == vectors)
        assert lane_dual_plan(M, N, dt, resident=False).smem == vectors
        assert plan.threads == lane_threads(M, N)
        assert plan == lane_plan(M, N, dt)


ROUTE_CASES = [
    (59, 114, torch.float64, "resident"),
    (66, 257, torch.float64, "resident"),
    (3, 30, torch.float32, "resident"),
    (258, 513, torch.float64, "cluster"),
    (258, 513, torch.float32, "cluster"),
    (258, 769, torch.float64, "cluster"),
    (258, 1025, torch.float32, "cluster"),
    (258, 2049, torch.float64, "streamed"),
    (1026, 1025, torch.float32, "streamed"),
]


@pytest.mark.parametrize("case", ROUTE_CASES,
                         ids=lambda c: f"{c[0]}x{c[1]}-{str(c[2])[6:]}")
def test_primal_lanes_route(case):
    M, N, dt, want = case
    assert lanes.primal_lanes_route(M, N, dt) == want


@pytest.mark.parametrize("case", ROUTE_CASES,
                         ids=lambda c: f"{c[0]}x{c[1]}-{str(c[2])[6:]}")
def test_dual_lanes_route(case):
    """The dual loop takes the primal loop's plan for a frame, so that a
    warm wave's two loops run on one route."""
    M, N, dt, want = case
    assert lanes.dual_lanes_route(M, N, dt) == want
    assert lanes.dual_lanes_route(M, N, dt) == lanes.primal_lanes_route(
        M, N, dt)


def test_primal_lanes_route_follows_the_plans():
    """Resident exactly where lane_plan keeps the frame in one block, the
    cluster lanes exactly where cluster_plan holds the rest, else the
    one-block streamed plan; whatever the lane count."""
    for dt in (torch.float32, torch.float64):
        for M in (3, 40, 100, 258, 600):
            for N in (20, 120, 300, 600, 1500, 3000):
                resident = lane_plan(M, N, dt).resident
                try:
                    kc.cluster_plan(M, N, dt)
                    fits = True
                except ValueError:
                    fits = False
                want = ("resident" if resident else
                        "cluster" if fits else "streamed")
                assert lanes.primal_lanes_route(M, N, dt) == want, (M, N)


def test_dual_lanes_route_follows_the_plans():
    """The dual loop resident exactly where lane_dual_plan keeps the frame
    in one block, the cluster lanes exactly where cluster_plan holds the
    rest, else the one-block streamed plan; at the last resident width of
    100 rows and one past it too."""
    for dt in (torch.float32, torch.float64):
        for M in (3, 40, 100, 258, 600):
            for N in (20, 120, 300, 600, 1500, 3000):
                resident = lane_dual_plan(M, N, dt).resident
                try:
                    kc.cluster_plan(M, N, dt)
                    fits = True
                except ValueError:
                    fits = False
                want = ("resident" if resident else
                        "cluster" if fits else "streamed")
                assert lanes.dual_lanes_route(M, N, dt) == want, (M, N)
        N = max(n for n in range(2, 1200)
                if lane_dual_plan(100, n, dt).resident)
        assert lanes.dual_lanes_route(100, N, dt) == "resident"
        assert lanes.dual_lanes_route(100, N + 1, dt) == "cluster"


def _cpu_state(seed=0, lanes_=4):
    _, ts = _pair(_cold_leaves(seed, lanes=lanes_))
    return ts


@pytest.mark.parametrize("route", [None, *lanes.PRIMAL_ROUTES])
def test_primal_lanes_on_cpu_tensors_runs_the_plain_loop(route,
                                                          monkeypatch):
    """On CPU tensors every route runs the plain loop, and no kernel
    wrapper is called."""
    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper was called on the CPU")

    monkeypatch.setattr(lanes, "lane_primal", refuse)
    monkeypatch.setattr(lanes, "rank1_cluster_lanes", refuse)
    st = _cpu_state()
    opts = SolverOptions.for_dtype(torch.float64, max_iters=200)
    stall = opts.resolved_stall_limit(st.T.shape[1] - 2, st.T.shape[2] - 1)
    out = lanes.primal_lanes(st, opts, stall, opts.max_iters, route=route)
    ref = lanes.primal_lanes_reference(st, opts, stall, opts.max_iters)
    for a, b in zip(out, ref):
        assert torch.equal(a, b) or torch.equal(torch.isnan(a), torch.isnan(b))


def test_primal_lanes_refuses_an_unknown_route():
    st = _cpu_state()
    opts = SolverOptions.for_dtype(torch.float64)
    with pytest.raises(ValueError, match="route"):
        lanes.primal_lanes(st, opts, 10, 10, route="grid")


def _warm_state():
    _, ts = _pair(_dual_leaves())
    return ts


@pytest.mark.parametrize("route", [None, *lanes.DUAL_ROUTES])
def test_dual_lanes_on_cpu_tensors_runs_the_plain_loop(route, monkeypatch):
    """On CPU tensors every route of the dual loop runs the plain loop, and
    no kernel wrapper is called."""
    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper was called on the CPU")

    monkeypatch.setattr(lanes, "lane_dual", refuse)
    monkeypatch.setattr(lanes, "rank1_cluster_lanes", refuse)
    st = _warm_state()
    opts = SolverOptions.for_dtype(torch.float64, max_iters=300)
    stall = opts.resolved_stall_limit(st.T.shape[1] - 2, st.T.shape[2] - 1)
    out = lanes.dual_lanes(st, opts, stall, opts.max_iters, route=route)
    ref = lanes.dual_lanes_reference(st, opts, stall, opts.max_iters)
    for a, b in zip(out, ref):
        assert torch.equal(a, b) or torch.equal(torch.isnan(a), torch.isnan(b))


def test_dual_lanes_refuses_an_unknown_route():
    st = _warm_state()
    opts = SolverOptions.for_dtype(torch.float64)
    with pytest.raises(ValueError, match="route"):
        lanes.dual_lanes(st, opts, 10, 10, route="grid")


def test_cluster_lanes_wrapper_refuses_cpu_tensors():
    st = _cpu_state()
    opts = SolverOptions.for_dtype(torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        kc.rank1_cluster_lanes(st, opts, 10, 10)
    with pytest.raises(ValueError, match="CUDA"):
        kl.lane_primal(st, opts, 10, 10, threads=32)


def test_dual_lane_wrappers_refuse_cpu_tensors():
    """The cluster lanes' dual walk and every plan of ``lane_dual`` take
    CUDA tensors only."""
    st = _warm_state()
    opts = SolverOptions.for_dtype(torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        kc.rank1_cluster_lanes(st, opts, 10, 10, dual=True)
    for kw in ({}, {"threads": 32}, {"threads": 256}, {"resident": False}):
        with pytest.raises(ValueError, match="CUDA"):
            kl.lane_dual(st, opts, 10, 10, **kw)


def _frozen_broadcast(leaves):
    """Lane 1 OPTIMAL before the walk; the masks those of lane 0 in every
    lane (the numpy leaves), and as the waves pass them in the port (lane
    stride 0)."""
    leaves = [np.array(x) for x in leaves]
    leaves[5][1] = Status.OPTIMAL
    leaves[2][:] = leaves[2][:1]
    leaves[3][:] = leaves[3][:1]
    js, ts = _pair(leaves)
    B = ts.T.shape[0]
    ts = ts._replace(col_active=ts.col_active[:1].expand(B, -1),
                     art_cols=ts.art_cols[:1].expand(B, -1))
    return js, ts


@pytest.mark.parametrize("C", kc.CLUSTER_SIZES)
@pytest.mark.parametrize("budget", [200, 3])
def test_cluster_lanes_reference_equals_tpulp(C, budget):
    """rank1_cluster_lanes' plain version on four lanes at a forced cluster
    size, one lane frozen and the masks broadcast: bit for bit tpulp's
    vmapped driver at f64 (T + 0.0, every field), the frozen lane as it
    was, and the plain lane loop's walk."""
    js, ts = _frozen_broadcast(_cold_leaves(3, lanes=4))
    assert ts.col_active.stride(0) == 0
    opts = SolverOptions.for_dtype(torch.float64, max_iters=budget)
    jo = JOptions.for_dtype(jnp.float64, max_iters=budget)
    stall = opts.resolved_stall_limit(ts.T.shape[1] - 2, ts.T.shape[2] - 1)
    out = kc.rank1_cluster_lanes_reference(ts, opts, stall, budget, C)
    ref = _batched_driver(_budget_key(jo), stall)(
        js, jnp.asarray(budget, jnp.int32))
    # tpulp's driver maps a RUNNING exit at the budget to ITERATION_LIMIT
    _same(finish(out), ref)
    assert int(out.status[1]) == Status.OPTIMAL and int(out.niter[1]) == 0
    assert torch.equal(out.T[1], ts.T[1])
    plain = lanes.primal_lanes_reference(ts, opts, stall, budget)
    _same(out, JState(*(jnp.asarray((x + 0.0).numpy() if
                                     x.is_floating_point() else x.numpy())
                        for x in plain)))
    if budget == 3:
        assert int(out.niter.max()) == 3
        assert Status.RUNNING in out.status.tolist()


def _dual_frozen():
    """``_dual_leaves``' eight warm lanes with their NaN lane (6) and
    overflowing lane (7); lane 1 OPTIMAL before the walk."""
    leaves = [np.array(x) for x in _dual_leaves(numeric=True)]
    leaves[5][1] = Status.OPTIMAL
    return _pair(leaves)


@pytest.mark.parametrize("C", [1, 2, 4])
@pytest.mark.parametrize("budget", [300, 2])
def test_cluster_lanes_dual_reference_equals_tpulp(C, budget):
    """rank1_cluster_lanes' plain version with the dual walk on warm lanes
    (a frozen lane, a NaN lane and an overflowing one) at a forced cluster
    size: lane by lane bit for bit tpulp's ``run_dual_simplex`` at f64 (T
    + 0.0, every field), the frozen lane as it was, and the plain lane
    loop's walk; the masks are the input's."""
    js, ts = _dual_frozen()
    opts = SolverOptions.for_dtype(torch.float64, max_iters=budget)
    jo = JOptions.for_dtype(jnp.float64, max_iters=budget)
    stall = opts.resolved_stall_limit(ts.T.shape[1] - 2, ts.T.shape[2] - 1)
    out = kc.rank1_cluster_lanes_reference(ts, opts, stall, budget, C,
                                           dual=True)
    refs = [jdual.run_dual_simplex(JState(*(x[b] for x in js)), jo)
            for b in range(ts.T.shape[0])]
    ref = JState(*(jnp.stack([getattr(r, f) for r in refs])
                   for f in JState._fields))
    # tpulp's driver maps a RUNNING exit at the budget to ITERATION_LIMIT
    _same(finish(out), ref)
    assert int(out.status[1]) == Status.OPTIMAL and int(out.niter[1]) == 0
    assert torch.equal(out.T[1], ts.T[1])
    assert torch.equal(out.col_active, ts.col_active)
    assert out.status[6:].tolist() == [Status.NUMERIC] * 2
    plain = lanes.dual_lanes_reference(ts, opts, stall, budget)
    _same(out, JState(*(jnp.asarray((x + 0.0).numpy() if
                                     x.is_floating_point() else x.numpy())
                        for x in plain)))
    if budget == 2:
        assert int(out.niter.max()) == 2
        assert Status.RUNNING in out.status.tolist()
    else:
        assert {Status.OPTIMAL, Status.INFEASIBLE} <= set(
            out.status.tolist())
