"""The solo rank-1, devex and dual walks of a frame that fits a
thread-block cluster (``tpulp_torch/kernels/rank1_cluster.py``), held on
the CPU through the plain version ``rank1_cluster_reference``: at f64, for
clusters of 1, 2, 3 and 8 blocks, the walk equals tpulp's jitted
``lax.while_loop`` over ``simplex_step`` / ``devex_simplex_step`` /
``dual_simplex_step`` bit for bit (status, pivots, basis, the tableau as
``T + 0.0``, the devex weights) under Dantzig, Bland, the greatest
increase, devex, largest-pivot ties, a clean-up, Beale's cycling LP, an
unbounded, an infeasible and a NUMERIC walk; at f32 it equals the plain
stages' walk (``rank1_step_reference``) in every field; budgets hold
exactly. The kernel's sums feed finiteness checks only (the |c| sum in the
kernel's order, ``cluster_sum``), so the walk does not depend on the
cluster's size. ``cluster_plan``'s arithmetic, the route rule, the
wrapper's refusals and the CPU dispatch are held here too. The kernel
itself runs on the card only (tests/test_torch_lanes_card.py; chip_smoke.py's
phase 5c holds it at full size)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpulp_torch
import tpulp_torch.kernels.rank1 as kr
import tpulp_torch.kernels.rank1_cluster as kc
from tpulp.core import make_state as tpulp_make_state
from tpulp.core.state import SolverOptions as TpulpOptions
from tpulp.solve import devex as tdevex
from tpulp.solve import driver as tdriver
from tpulp.solve import dual as tdual
from tpulp_torch.core import SolverOptions, Status
from tpulp_torch.kernels import LAUNCHES, lane_plan, reset_launches
from tpulp_torch.solve import devex as pdevex
from tpulp_torch.solve import driver as pdriver
from tpulp_torch.solve import dual as pdual
from tpulp_torch.solve.driver import finish, solo_route

from test_torch_bounded_kernel import as_bits
from test_torch_dual import _root, _tightened
from test_torch_rank1_kernel import (DUAL_INSTANCES, DUAL_RULES, INSTANCES,
                                     RULES, _small, _wyndor, assert_same,
                                     dual_state, port_state, rule_opts)

torch.set_num_threads(1)
pytestmark = pytest.mark.filterwarnings(
    "error:There is a performance drop")

# (instance, rule): Dantzig's unbounded walk, Bland, the greatest
# increase, devex past a ray-scan and a probe tick, devex through phase 1,
# the clean-up and the phase change's reset, devex's exposed ray,
# largest-pivot ties, a clean-up, Beale's cycling LP (the stall switch to
# Bland), an infeasible and a NUMERIC walk
PRIMAL_CASES = [("random0", "dantzig"), ("bounded1", "bland"),
                ("long", "max_increase"), ("long", "devex"),
                ("equalities", "devex"), ("ray", "devex"),
                ("bounded1", "maxpiv"), ("cleanup", "dantzig"),
                ("equalities", "dantzig"), ("beale", "dantzig"),
                ("infeasible", "dantzig"), ("numeric", "dantzig")]
# (dual frame, rule): warm re-solves (optimal and infeasible exits), the
# stall switch to Bland, an infeasible row, NUMERIC, a NaN in b
DUAL_CASES = [("warm0", "dantzig"), ("warm3", "dantzig"),
              ("deep", "stall_bland"), ("infeasible", "dantzig"),
              ("numeric", "dantzig"), ("nan_b", "dantzig")]
CASES = [("primal",) + c for c in PRIMAL_CASES] + \
    [("dual",) + c for c in DUAL_CASES]
CASE_IDS = [f"{w}-{i}-{r}" for w, i, r in CASES]


def case_inputs(walk, instance, rule, dtype):
    """(state, options, stall limit, devex weights or None, dual)."""
    if walk == "dual":
        state = dual_state(instance, dtype)
        opts, devex = SolverOptions.for_dtype(dtype,
                                              **DUAL_RULES[rule]), False
    else:
        state = port_state(instance, dtype)
        opts, devex = rule_opts(rule, dtype)
    stall = opts.resolved_stall_limit(state.m, state.n)
    gamma = torch.ones(state.n, dtype=dtype) if devex else None
    return state, opts, stall, gamma, walk == "dual"


_TPULP = {}


def tpulp_walk(walk, instance, rule):
    """tpulp's compiled walk of the case at f64 (its driver's
    ``lax.while_loop``): (state, devex weights or None), as numpy."""
    key = (walk, instance, rule)
    if key not in _TPULP:
        if walk == "dual":
            leaves = DUAL_INSTANCES[instance]()
            js = tdual.SimplexState(*(jnp.asarray(x) for x in leaves))
            over = DUAL_RULES[rule]
        else:
            c, A, b, hint = INSTANCES[instance]()
            js = tpulp_make_state(c, A, b, hint, dtype=jnp.float64)
            over = RULES[rule][0]
        jo = TpulpOptions.for_dtype(jnp.float64, **over)
        stall = jo.resolved_stall_limit(js.m, js.n)
        budget = jnp.asarray(jo.max_iters, jnp.int32)
        gamma = None
        if walk == "dual":
            out = tdual._compiled_dual_driver(tdriver._budget_key(jo),
                                              stall)(js, budget)
        elif RULES[rule][1]:
            ds = tdevex._compiled_devex_driver(tdriver._budget_key(jo),
                                               stall)(
                tdevex.make_devex_state(js), budget)
            out, gamma = ds.s, np.array(ds.gamma)
        else:
            out = tdriver._compiled_driver(tdriver._budget_key(jo),
                                           stall)(js, budget)
        _TPULP[key] = ({k: np.array(getattr(out, k)) for k in out._fields},
                       gamma)
    return _TPULP[key]


@pytest.mark.parametrize("C", [1, 2, 3, 8])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_plain_cluster_walk_equals_tpulp(case, C):
    """At f64 the plain cluster walk ends where tpulp's compiled walk does:
    the same status, pivots, basis, phase, Bland flag, masks, tableau
    (``T + 0.0``) and devex weights, whatever the cluster's size."""
    state, opts, stall, gamma, dual = case_inputs(*case, torch.float64)
    out, g = kc.rank1_cluster_reference(state, opts, stall, opts.max_iters,
                                        gamma, dual, C)
    out = finish(out)
    want, wg = tpulp_walk(*case)
    assert torch.equal(as_bits(out.T), as_bits(torch.from_numpy(want["T"])))
    for name in ("basis", "status", "niter", "phase", "stuck", "bland",
                 "col_active", "art_cols"):
        assert np.array_equal(getattr(out, name).numpy(), want[name]), name
    assert (g is None) == (wg is None)
    if g is not None:
        assert torch.equal(as_bits(g), as_bits(torch.from_numpy(wg)))


def plain_stage_walk(state, opts, stall, max_iters, gamma, dual):
    """The plain stages of ``kernels.rank1`` composed to the walk's exit."""
    rec = kr.make_record(state, opts, gamma, dual)
    while kr._live(rec.ints.tolist(), max_iters):
        kr.rank1_step_reference(rec, opts, stall, max_iters)
    return kr.record_state(rec), rec.gamma


@pytest.mark.parametrize("C", [2, 8])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_plain_cluster_walk_equals_the_stages_at_f32(case, C):
    state, opts, stall, gamma, dual = case_inputs(*case, torch.float32)
    out, g = kc.rank1_cluster_reference(state, opts, stall, opts.max_iters,
                                        gamma, dual, C)
    ref, rg = plain_stage_walk(state, opts, stall, opts.max_iters, gamma,
                               dual)
    assert_same(out, ref, g, rg)
    assert int(out.status) != Status.RUNNING


@pytest.mark.parametrize("budget", [1, 7])
@pytest.mark.parametrize("case", [("primal", "equalities", "dantzig"),
                                  ("primal", "equalities", "devex"),
                                  ("primal", "long", "max_increase"),
                                  ("dual", "deep", "dantzig")],
                         ids=lambda c: "-".join(c))
def test_plain_cluster_walk_holds_the_budget(case, budget):
    """The walk stops at the budget (status RUNNING, ``niter`` equal to it)
    where the stages stop, or ends before it."""
    state, opts, stall, gamma, dual = case_inputs(*case, torch.float64)
    out, g = kc.rank1_cluster_reference(state, opts, stall, budget, gamma,
                                        dual, 3)
    ref, rg = plain_stage_walk(state, opts, stall, budget, gamma, dual)
    assert_same(out, ref, g, rg)
    free, _ = kc.rank1_cluster_reference(state, opts, stall, 10_000, gamma,
                                         dual, 3)
    if int(free.niter) > budget:
        assert int(out.niter) == budget
        assert int(out.status) == Status.RUNNING
    else:
        assert_same(out, free)


def test_plain_cluster_walk_leaves_its_inputs():
    state, opts, stall, gamma, _ = case_inputs("primal", "long", "devex",
                                               torch.float64)
    before = [x.clone() for x in state] + [gamma.clone()]
    out, g = kc.rank1_cluster_reference(state, opts, stall, opts.max_iters,
                                        gamma, False, 2)
    assert int(out.niter) > 0
    for x, y in zip([*state, gamma], before):
        assert torch.equal(as_bits(x), as_bits(y))


# ---------------------------------------------------------------------------
# the finiteness sums in the kernel's order
# ---------------------------------------------------------------------------

def _emulated_block_sum(vals, threads):
    """common.cuh's block_reduce sum in Python floats: per thread in turn,
    then shfl_down's tree in each warp (a lane past the warp adds its own
    value), then the same tree over the warps' sums."""
    acc = [0.0] * threads
    for e, v in enumerate(vals):
        acc[e % threads] += v

    def tree(x):
        x = list(x) + [0.0] * (32 - len(x))
        for off in (16, 8, 4, 2, 1):
            x = [x[lane] + (x[lane + off] if lane + off < 32 else x[lane])
                 for lane in range(32)]
        return x[0]

    return tree([tree(acc[w:w + 32]) for w in range(0, threads, 32)])


@pytest.mark.parametrize("length", [1, 31, 1000, 1024, 3000])
def test_block_sum_is_the_kernel_order(length):
    """``block_sum`` adds as the kernel's block reduction does, bit for
    bit, on values whose order changes the sum."""
    rng = np.random.default_rng(length)
    vals = (rng.standard_normal(length)
            * 10.0 ** rng.integers(-8, 9, length)).tolist()
    got = float(kc.block_sum(torch.tensor(vals, dtype=torch.float64)))
    assert got == _emulated_block_sum(vals, kc.CLUSTER_THREADS)


def test_cluster_sum_adds_the_blocks_in_rank_order():
    """Each block's slab of ``ceil((n + 1) / C)`` columns, then the blocks'
    sums from rank 0 on; an empty block adds nothing."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(np.abs(rng.standard_normal(20)) * 1e12)
    for C in (1, 2, 3, 8):
        W = math.ceil(21 / C)
        want = 0.0
        for b in range(C):
            part = x[b * W:(b + 1) * W].tolist()
            want = want + _emulated_block_sum(part, kc.CLUSTER_THREADS) \
                if b else _emulated_block_sum(part, kc.CLUSTER_THREADS)
        assert float(kc.cluster_sum(x, C)) == want
    # a sum that overflows only as a whole reads as not finite
    big = torch.full((9,), 1.7e308, dtype=torch.float64)
    assert not math.isfinite(float(kc.cluster_sum(big, 8)))


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

def _bytes(M, N, W, es):
    """The kernel's layout: the slab; the pivot's column and the RHS; the
    pivot row's and the weights' segments; the basis; the segment's active
    mask; the artificial mask; each rounded up to 16 bytes."""
    up = lambda x: -(-x // 16) * 16  # noqa: E731
    m, n = M - 2, N - 1
    return (up(M * W * es) + 2 * up(M * es) + 2 * up(W * es) + up(4 * m)
            + up(W) + up(n))


@pytest.mark.parametrize("frame", [
    (258, 769, torch.float64, 8, 97),
    (258, 775, torch.float64, 8, 97),
    (258, 769, torch.float32, 4, 193),
    (258, 641, torch.float64, 8, 81),
    (60, 200, torch.float64, 1, 200),
    (42, 121, torch.float32, 1, 121),
    (200, 400, torch.float64, 4, 100),
    (5, 8, torch.float64, 1, 8),
], ids=lambda f: f"{f[0]}x{f[1]}-{str(f[2])[6:]}")
def test_cluster_plan(frame):
    """C is the smallest of 1, 2, 4, 8 whose blocks hold their share: the
    bytes are the kernel's layout, within the limit, and half the blocks
    would not do."""
    M, N, dtype, C, W = frame
    es = 8 if dtype == torch.float64 else 4
    plan = kc.cluster_plan(M, N, dtype)
    assert plan == kc.ClusterPlan(C, W, 512, _bytes(M, N, W, es))
    assert plan.smem <= kc.CLUSTER_SMEM_LIMIT == 230_400
    assert C * W >= N > (C - 1) * W or C == 1
    if C > 1:
        assert _bytes(M, N, -(-N // (C // 2)), es) > kc.CLUSTER_SMEM_LIMIT


def test_cluster_plan_worked_check():
    """258 x 775 at f64 on 8 blocks: 97 columns a block, 200,208 bytes of
    slab and 7,616 of vectors."""
    plan = kc.cluster_plan(258, 775, torch.float64)
    assert (plan.blocks, plan.width) == (8, 97)
    assert 258 * 97 * 8 == 200_208
    assert plan.smem == 200_208 + 7_616


@pytest.mark.parametrize("frame", [
    (1538, 3073, torch.float64),
    # tall frames near 200k elements: 8 slabs of 13 columns and the
    # column vectors pass a block's shared memory
    (2000, 100, torch.float64),
    (10000, 20, torch.float32),
    (8002, 24001, torch.float64),
], ids=lambda f: f"{f[0]}x{f[1]}-{str(f[2])[6:]}")
def test_cluster_plan_refuses_frames_past_8_blocks(frame):
    with pytest.raises(ValueError, match="cluster of 8"):
        kc.cluster_plan(*frame)


def test_cluster_plan_refusals():
    with pytest.raises(ValueError, match="float32 or float64"):
        kc.cluster_plan(258, 769, torch.float16)
    with pytest.raises(ValueError, match="outside"):
        kc.cluster_plan(2, 769, torch.float64)
    with pytest.raises(ValueError, match="expected one of"):
        kc.cluster_plan(258, 769, torch.float64, 3)
    # a forced size that does not hold the frame
    with pytest.raises(ValueError, match="cluster of 4"):
        kc.cluster_plan(258, 769, torch.float64, 4)
    assert kc.cluster_plan(5, 8, torch.float64, 8) == kc.ClusterPlan(
        8, 1, 512, _bytes(5, 8, 1, 8))


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    ("primal", 60, 200, torch.float64, "lane_primal"),
    ("dual", 60, 200, torch.float32, "lane_dual"),
    ("devex", 60, 200, torch.float64, "rank1_cluster"),
    ("devex", 42, 121, torch.float32, "rank1_cluster"),
    ("primal", 258, 769, torch.float64, "rank1_cluster"),
    ("primal", 258, 769, torch.float32, "rank1_cluster"),
    ("devex", 258, 775, torch.float64, "rank1_cluster"),
    ("dual", 258, 769, torch.float64, "rank1_cluster"),
    ("primal", 200, 400, torch.float64, "rank1_cluster"),
    ("devex", 1538, 3073, torch.float64, "rank1_grid"),
    ("primal", 1538, 3073, torch.float64, "rank1_grid"),
    ("dual", 1538, 3073, torch.float64, "rank1_grid"),
    ("primal", 2000, 100, torch.float64, "rank1_grid"),
], ids=lambda c: f"{c[0]}-{c[1]}x{c[2]}-{str(c[3])[6:]}")
def test_solo_route_takes_the_cluster(case):
    walk, M, N, dtype, route = case
    assert solo_route(walk, M, N, dtype) == route


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_solo_route_rule(dtype):
    """The lane kernels where one block holds the primal or dual frame, else
    the cluster where 8 blocks hold it, else the grid (every frame here is
    within its plan)."""
    for M, N in ((40, 300), (100, 280), (200, 400), (258, 769), (514, 1537),
                 (3000, 60), (1538, 3073)):
        resident = lane_plan(M, N, dtype).resident
        try:
            kc.cluster_plan(M, N, dtype)
            fits = True
        except ValueError:
            fits = False
        big = "rank1_cluster" if fits else "rank1_grid"
        for walk, lane in (("primal", "lane_primal"), ("dual", "lane_dual"),
                           ("devex", None)):
            want = lane if resident and lane else big
            assert solo_route(walk, M, N, dtype) == want, (walk, M, N)


# ---------------------------------------------------------------------------
# the wrapper and the dispatch
# ---------------------------------------------------------------------------

def test_rank1_cluster_raises_on_cpu_tensors():
    state, opts = _small()
    with pytest.raises(ValueError, match="CUDA"):
        kc.rank1_cluster(state, opts, 10, 10)
    with pytest.raises(ValueError, match="CUDA"):
        kc.rank1_cluster(state, opts, 10, 10, dual=True)
    assert LAUNCHES["rank1_cluster"] == 0


def test_rank1_cluster_raises_on_mixed_devices():
    state, opts = _small()
    with pytest.raises(ValueError, match="CUDA"):
        kc.rank1_cluster(state._replace(basis=state.basis.to("meta")), opts,
                         10, 10)


def test_rank1_cluster_raises_on_a_strided_tableau():
    state, opts = _small()
    strided = state._replace(T=state.T.t().contiguous().t())
    with pytest.raises(ValueError, match="contiguous"):
        kc.rank1_cluster(strided, opts, 10, 10)


def test_rank1_cluster_raises_on_float16():
    state, opts = _small()
    half = state._replace(T=state.T.half(), last_z=state.last_z.half())
    with pytest.raises(ValueError, match="float32 or float64"):
        kc.rank1_cluster(half, opts, 10, 10)


def test_rank1_cluster_raises_on_weights():
    state, opts = _small()
    with pytest.raises(ValueError, match="gamma"):
        kc.rank1_cluster(state, opts, 10, 10,
                         torch.ones(state.n + 1, dtype=torch.float64))
    with pytest.raises(ValueError, match="dual"):
        kc.rank1_cluster(state, opts, 10, 10,
                         torch.ones(state.n, dtype=torch.float64), dual=True)


def test_rank1_cluster_raises_when_the_card_holds_no_cluster(monkeypatch):
    """A plan whose cluster the card cannot hold (occupancy 0) raises
    before any launch; the walk goes nowhere else."""
    state, opts = _small()
    asked = []

    def occupancy(M, N, dtype, walk, device, blocks):
        asked.append((M, N, walk, blocks))
        return 0

    monkeypatch.setattr(kc, "_check", lambda *a: None)
    monkeypatch.setattr(kc, "cluster_occupancy", occupancy)
    reset_launches()
    with pytest.raises(RuntimeError, match="holds no cluster"):
        kc.rank1_cluster(state, opts, 10, 10,
                         torch.ones(state.n, dtype=torch.float64))
    assert asked == [(*state.T.shape, "devex", None)]
    assert LAUNCHES["rank1_cluster"] == 0


def test_cpu_walks_never_reach_the_cluster_kernel(monkeypatch):
    """On CPU tensors the solo walks are the plain loops: neither kernel
    wrapper is called, and no launch is counted."""
    def refuse(*args, **kw):
        raise AssertionError("a kernel route was taken on the CPU")

    for name in ("rank1_cluster", "rank1_grid", "lane_primal",
                 "lane_dual"):
        monkeypatch.setattr(pdriver, name, refuse)
    monkeypatch.setattr(kc, "rank1_cluster", refuse)
    reset_launches()
    state, opts = _small()
    assert int(pdriver.run_simplex(state, opts).status) == Status.OPTIMAL
    assert int(pdevex.run_simplex_devex(state, opts).status) == \
        Status.OPTIMAL
    A, b, basis, _, tf = _root(0)
    frame = pdual.warm_state_from_basis(*tf, basis,
                                        _tightened(A, b, basis, 0))
    assert int(pdual.run_dual_simplex(frame, opts).status) == \
        Status.OPTIMAL
    sol = tpulp_torch.solve_lp(_wyndor(12), pricing="devex", device="cpu")
    assert sol.objective == 400
    assert not any(LAUNCHES.values())
