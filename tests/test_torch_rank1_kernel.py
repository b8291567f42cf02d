"""The solo rank-1, devex and dual walks' plain stages
(``tpulp_torch/kernels/rank1.py``, the plain versions of the grid and
cluster walks) and the lane kernels at B = 1, held on the CPU: composed,
the scan, price, ratio, update and finish stages give ``simplex_step``,
``devex_simplex_step`` and ``dual_simplex_step`` bit for bit (``T + 0.0``)
in every field at f64 and f32, for Dantzig, Bland, the greatest increase,
devex, largest-pivot ties (with Dantzig and with the greatest increase),
``RULE_DEVEX`` priced as Dantzig and the stall switch to Bland, and
tpulp's jitted steps step for step at f64 (status, pivots, basis, the
tableau). The lane loops at B = 1, the route rule, the record's refusals
and the CPU dispatch are held here too. The kernels themselves run on the
card only (``tests/test_torch_rank1_grid_card.py`` holds the grid walk on
these instances against its plain version; chip_smoke.py's phase 5c holds
the walks at full size)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpulp_torch
import tpulp_torch.kernels.rank1 as kr
from tpulp.core import make_state as tpulp_make_state
from tpulp.core.state import SolverOptions as TpulpOptions
from tpulp.solve.devex import devex_simplex_step as tpulp_devex_step
from tpulp.solve.devex import make_devex_state as tpulp_devex_state
from tpulp.solve import dual as tdual
from tpulp.solve.driver import simplex_step as tpulp_step
from tpulp_torch.core import SolverOptions, Status, from_numpy_state
from tpulp_torch.core.state import (RULE_BLAND, RULE_DEVEX,
                                    RULE_MAX_INCREASE, TIE_MAXPIV)
from tpulp_torch.kernels import LAUNCHES, reset_launches
from tpulp_torch.solve import devex as pdevex
from tpulp_torch.solve import driver as pdriver
from tpulp_torch.solve import dual as pdual
from tpulp_torch.solve import lanes as planes
from tpulp_torch.solve.devex import devex_simplex_step, make_devex_state
from tpulp_torch.solve.driver import (one_lane, run_chunked, simplex_step,
                                      solo_route)

from test_torch_bounded_kernel import as_bits
from test_torch_drivers import _beale, _cleanup, _random
from test_torch_dual import _root, _tightened

torch.set_num_threads(1)
pytestmark = pytest.mark.filterwarnings(
    "error:There is a performance drop")


def _equalities(seed, m=10, n=14):
    """An equality LP on artificials with small integer data whose last two
    rows are 2 x row 0 and row 1 + row 2: phase 1, then the artificials'
    clean-up pivots and a retire (a dependent row keeps its artificial
    basic) in phase 2."""
    rng = np.random.default_rng(seed)
    A = rng.integers(0, 4, size=(m - 2, n)).astype(float)
    x0 = rng.integers(1, 4, size=n) * (rng.random(n) < 0.5)
    A = np.vstack([A, 2 * A[0], A[1] + A[2]])
    return rng.integers(-5, 6, size=n).astype(float), A, A @ x0, [-1] * m


def _infeasible():
    """x + y <= 1 and x + y >= 3 (a surplus row on an artificial)."""
    A = np.array([[1.0, 1.0, 1.0, 0.0], [1.0, 1.0, 0.0, -1.0]])
    return np.array([-1.0, -1.0, 0.0, 0.0]), A, np.array([1.0, 3.0]), \
        [2, -1]


def _numeric():
    """An overflowing |b| sum: NUMERIC at the first step."""
    c, A, b, hint = _random(4)
    b[3] = np.inf
    return c, A, b, hint


def _ray():
    """A phase-2 start with an improving column that has no positive
    entry: devex's scan at niter 0 exposes it."""
    c, A, b, hint = _random(5, bounded=True)
    A[:, 2] = -np.abs(A[:, 2])
    c[2] = -3.0
    return c, A, b, hint


# the instances: phase 2 from a slack basis (optimal, unbounded, Beale's
# cycling LP, a longer walk past the devex probe), phase 1 with the
# artificials' clean-up and retire, infeasible, NUMERIC, an exposed ray
INSTANCES = {
    "random0": lambda: _random(0),
    "bounded1": lambda: _random(1, bounded=True),
    "beale": _beale,
    "cleanup": _cleanup,
    "equalities": lambda: _equalities(5),
    "long": lambda: _random(3, m=24, n=40, bounded=True),
    "infeasible": _infeasible,
    "numeric": _numeric,
    "ray": _ray,
}
# rule name -> (options, devex weights)
RULES = {
    "dantzig": ({}, False),
    "bland": ({"rule": RULE_BLAND}, False),
    "max_increase": ({"rule": RULE_MAX_INCREASE}, False),
    "maxpiv": ({"tie_break": TIE_MAXPIV}, False),
    "max_increase_maxpiv": ({"rule": RULE_MAX_INCREASE,
                             "tie_break": TIE_MAXPIV}, False),
    # simplex_step prices RULE_DEVEX as Dantzig (only the devex walk
    # carries weights)
    "devex_rule": ({"rule": RULE_DEVEX}, False),
    "stall_bland": ({"stall_limit": 1, "degen_tol": 1e30}, False),
    "devex": ({}, True),
}
STEPS = 400


def port_state(instance, dtype):
    c, A, b, hint = INSTANCES[instance]()
    return from_numpy_state(tpulp_make_state(c, A, b, hint, _numpy=True,
                                             dtype=jnp.float64),
                            device="cpu", dtype=dtype)


def assert_same(a, b, ga=None, gb=None):
    """Every field of two states (and two weight vectors) equal, floats as
    ``T + 0.0``, NaN equal to NaN."""
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        assert torch.equal(as_bits(x), as_bits(y)), name
    assert (ga is None) == (gb is None)
    if ga is not None:
        assert torch.equal(as_bits(ga), as_bits(gb))


class Events:
    """What the walks went through, read from consecutive plain states and
    the record's verdict."""

    KINDS = ("cleanups", "retires", "phase_changes", "bland_switches",
             "unbounded", "infeasible", "numeric", "scan_ticks", "rays",
             "probe_ticks", "resets")

    def __init__(self):
        for k in self.KINDS:
            setattr(self, k, 0)

    def see(self, old, new, rec, devex, g_old, g_new):
        if int(old.status) != Status.RUNNING:
            return
        moved = int(new.niter) > int(old.niter)
        cleanup = int(old.phase) == 2 and bool(
            old.art_cols[old.basis.long()].any())
        self.cleanups += moved and cleanup
        self.retires += bool((new.art_cols != old.art_cols).any())
        self.phase_changes += int(new.phase) != int(old.phase)
        self.bland_switches += bool(new.bland) and not bool(old.bland)
        st = int(new.status)
        self.unbounded += st == Status.UNBOUNDED
        self.infeasible += st == Status.INFEASIBLE
        self.numeric += st == Status.NUMERIC
        if devex and int(old.phase) == 2 and not cleanup:
            tick = int(old.niter) % kr.RAY_SCAN_EVERY
            self.scan_ticks += tick == 0
            self.probe_ticks += tick == kr.RAY_SCAN_EVERY // 2
            self.rays += bool(rec.ints[kr.RAY])
        if devex:
            self.resets += bool((g_new == 1).all()) and not bool(
                (g_old == 1).all())


def stage_walk(state, opts, devex, stall, max_iters, steps, events=None):
    """The plain step and the composed stages side by side, ``steps``
    steps (the plain step goes on past the exit, as a chunk does); every
    state held equal. Returns the final record."""
    gamma = torch.ones(state.n, dtype=state.T.dtype) if devex else None
    rec = kr.make_record(state, opts, gamma)
    ds = make_devex_state(state)
    for _ in range(steps):
        if devex:
            nxt = devex_simplex_step(ds, opts, stall, max_iters)
            new, g_new = nxt.s, nxt.gamma
        else:
            new, g_new = simplex_step(state, opts, stall, max_iters), None
        kr.rank1_step_reference(rec, opts, stall, max_iters)
        assert_same(kr.record_state(rec), new, rec.gamma, g_new)
        if events is not None:
            events.see(state, new, rec, devex, ds.gamma, g_new)
        state = new
        if devex:
            ds = nxt
    return rec


def rule_opts(rule, dtype, **kw):
    over, devex = RULES[rule]
    return SolverOptions.for_dtype(dtype, **over, **kw), devex


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("rule", list(RULES))
@pytest.mark.parametrize("instance", list(INSTANCES))
def test_stages_equal_the_step(instance, rule, dtype):
    tt = getattr(torch, dtype)
    state = port_state(instance, tt)
    opts, devex = rule_opts(rule, tt)
    stall = opts.resolved_stall_limit(state.m, state.n)
    rec = stage_walk(state, opts, devex, stall, None, STEPS)
    assert int(rec.ints[kr.STATUS]) != Status.RUNNING


@pytest.mark.parametrize("budget", [1, 7])
@pytest.mark.parametrize("rule", ["dantzig", "max_increase", "devex"])
def test_stages_hold_the_budget(rule, budget):
    """Past the budget every stage is a no-op: the record stops where the
    plain step freezes, status RUNNING and ``niter`` at the budget."""
    state = port_state("equalities", torch.float64)
    opts, devex = rule_opts(rule, torch.float64)
    stall = opts.resolved_stall_limit(state.m, state.n)
    rec = stage_walk(state, opts, devex, stall, budget, budget + 5)
    assert int(rec.ints[kr.NITER]) == budget
    assert int(rec.ints[kr.STATUS]) == Status.RUNNING


def test_every_event_is_covered():
    """The instances above walk through every kind of step the stages
    split: the clean-up pivot and the retire, the phase change, the stall
    switch to Bland, the unbounded, infeasible and NUMERIC exits, devex's
    ray-scan tick (and an exposed ray), its probe tick and a reset of its
    weights."""
    ev = Events()
    for instance in INSTANCES:
        for rule in ("dantzig", "stall_bland", "devex"):
            state = port_state(instance, torch.float64)
            opts, devex = rule_opts(rule, torch.float64)
            stall = opts.resolved_stall_limit(state.m, state.n)
            stage_walk(state, opts, devex, stall, None, STEPS, ev)
    missing = [k for k in Events.KINDS if not getattr(ev, k)]
    assert not missing, missing


def _tpulp_pair(instance):
    c, A, b, hint = INSTANCES[instance]()
    js = tpulp_make_state(c, A, b, hint, dtype=jnp.float64)
    return js, port_state(instance, torch.float64)


@pytest.mark.parametrize("rule", list(RULES))
@pytest.mark.parametrize("instance", ["bounded1", "beale", "equalities",
                                      "long", "ray"])
def test_stages_equal_tpulp_step_for_step(instance, rule):
    """At f64 the composed stages walk tpulp's jitted ``simplex_step`` /
    ``devex_simplex_step``: after every step the status, pivots, basis,
    phase, the Bland flag, the devex weights and the tableau (``T + 0.0``)
    are equal."""
    js, ts = _tpulp_pair(instance)
    over, devex = RULES[rule]
    jo = TpulpOptions.for_dtype(jnp.float64, **over)
    opts = SolverOptions.for_dtype(torch.float64, **over)
    stall = jo.resolved_stall_limit(js.m, js.n)
    if devex:
        step = jax.jit(lambda d: tpulp_devex_step(d, jo, stall))
        jc = tpulp_devex_state(js)
        rec = kr.make_record(ts, opts, torch.ones(ts.n, dtype=torch.float64))
    else:
        step = jax.jit(lambda s: tpulp_step(s, jo, stall))
        jc = js
        rec = kr.make_record(ts, opts)
    for _ in range(STEPS):
        jc = step(jc)
        kr.rank1_step_reference(rec, opts, stall, None)
        jst = jc.s if devex else jc
        ps = kr.record_state(rec)
        assert torch.equal(as_bits(ps.T),
                           as_bits(torch.from_numpy(np.array(jst.T))))
        for name in ("basis", "status", "niter", "phase", "bland",
                     "art_cols", "col_active"):
            assert np.array_equal(getattr(ps, name).numpy(),
                                  np.asarray(getattr(jst, name))), name
        if devex:
            assert torch.equal(as_bits(rec.gamma), as_bits(
                torch.from_numpy(np.array(jc.gamma))))
        if int(ps.status) != Status.RUNNING:
            break
    assert int(ps.status) != Status.RUNNING


# ---------------------------------------------------------------------------
# the dual walk
# ---------------------------------------------------------------------------

def _warm(seed, rows=3):
    """tpulp's warm frame of a root LP whose RHS moved past its optimal
    basis (test_torch_dual.py's), as numpy leaves."""
    A, b, basis, jf, _ = _root(seed)
    b2 = b if rows == 0 else _tightened(A, b, basis, seed, rows)
    return [np.array(x) for x in tdual.warm_state_from_basis(*jf, basis, b2)]


def _dual_infeasible():
    """The most negative row's entries made non-negative: no entering
    column, INFEASIBLE at the first step."""
    f = _warm(0)
    r = int(np.argmin(f[0][2:, -1])) + 2
    f[0][r, :-1] = np.abs(f[0][r, :-1])
    return f


def _dual_numeric():
    """An infinite objective entry on an active column: NUMERIC."""
    f = _warm(1)
    f[0][0, int(np.flatnonzero(f[2])[0])] = np.inf
    return f


def _dual_nan():
    """A NaN in b beside the negative rows: the NaN-first argmin picks it."""
    f = _warm(2)
    f[0][3, -1] = np.nan
    return f


# the dual frames: warm re-solves of a few pivots (0-3, and a deeper cut),
# an optimal frame, an infeasible row, NUMERIC, a NaN in b
DUAL_INSTANCES = {
    "warm0": lambda: _warm(0),
    "warm1": lambda: _warm(1),
    "warm2": lambda: _warm(2),
    "warm3": lambda: _warm(3),
    "deep": lambda: _warm(3, rows=6),
    "optimal": lambda: _warm(0, rows=0),
    "infeasible": _dual_infeasible,
    "numeric": _dual_numeric,
    "nan_b": _dual_nan,
}
DUAL_RULES = {"dantzig": {},
              "stall_bland": {"stall_limit": 1, "degen_tol": 1e30}}


def dual_state(instance, dtype):
    return from_numpy_state(DUAL_INSTANCES[instance](), device="cpu",
                            dtype=dtype)


def dual_stage_walk(state, opts, stall, max_iters, steps):
    """``dual_simplex_step`` and the composed dual stages side by side;
    every state held equal. Returns (the final record, the events: pivots,
    Bland switches and each exit status)."""
    rec = kr.make_record(state, opts, dual=True)
    seen = {"pivots": 0, "bland_switches": 0}
    for _ in range(steps):
        new = pdual.dual_simplex_step(state, opts, stall, max_iters)
        kr.rank1_step_reference(rec, opts, stall, max_iters)
        assert_same(kr.record_state(rec), new)
        seen["pivots"] += int(new.niter) - int(state.niter)
        seen["bland_switches"] += bool(new.bland) and not bool(state.bland)
        if int(state.status) == Status.RUNNING != int(new.status):
            seen[int(new.status)] = seen.get(int(new.status), 0) + 1
        state = new
    return rec, seen


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("rule", list(DUAL_RULES))
@pytest.mark.parametrize("instance", list(DUAL_INSTANCES))
def test_dual_stages_equal_the_step(instance, rule, dtype):
    tt = getattr(torch, dtype)
    state = dual_state(instance, tt)
    opts = SolverOptions.for_dtype(tt, **DUAL_RULES[rule])
    stall = opts.resolved_stall_limit(state.m, state.n)
    rec, _ = dual_stage_walk(state, opts, stall, None, 60)
    assert int(rec.ints[kr.STATUS]) != Status.RUNNING
    assert rec.scan is None and rec.gamma is None


@pytest.mark.parametrize("budget", [1, 2])
def test_dual_stages_hold_the_budget(budget):
    state = dual_state("deep", torch.float64)
    opts = SolverOptions.for_dtype(torch.float64)
    stall = opts.resolved_stall_limit(state.m, state.n)
    rec, _ = dual_stage_walk(state, opts, stall, budget, budget + 4)
    assert int(rec.ints[kr.NITER]) == budget
    assert int(rec.ints[kr.STATUS]) == Status.RUNNING


def test_every_dual_event_is_covered():
    """The dual frames walk through pivots, the stall switch to Bland, and
    the optimal, infeasible and NUMERIC exits."""
    total = {}
    for instance in DUAL_INSTANCES:
        for rule in DUAL_RULES:
            state = dual_state(instance, torch.float64)
            opts = SolverOptions.for_dtype(torch.float64, **DUAL_RULES[rule])
            stall = opts.resolved_stall_limit(state.m, state.n)
            for k, v in dual_stage_walk(state, opts, stall, None, 60)[1] \
                    .items():
                total[k] = total.get(k, 0) + v
    for k in ("pivots", "bland_switches", Status.OPTIMAL,
              Status.INFEASIBLE, Status.NUMERIC):
        assert total.get(k), (k, total)


@pytest.mark.parametrize("rule", list(DUAL_RULES))
@pytest.mark.parametrize("instance", list(DUAL_INSTANCES))
def test_dual_stages_equal_tpulp_step_for_step(instance, rule):
    """At f64 the composed dual stages walk tpulp's jitted
    ``dual_simplex_step`` from the same frame: after every step the
    status, pivots, basis, the Bland flag and the tableau (``T + 0.0``)
    are equal."""
    leaves = DUAL_INSTANCES[instance]()
    js = tdual.SimplexState(*(jnp.asarray(x) for x in leaves))
    ts = from_numpy_state(leaves, device="cpu")
    over = DUAL_RULES[rule]
    jo = TpulpOptions.for_dtype(jnp.float64, **over)
    opts = SolverOptions.for_dtype(torch.float64, **over)
    stall = jo.resolved_stall_limit(js.m, js.n)
    step = jax.jit(lambda s: tdual.dual_simplex_step(s, jo, stall))
    rec = kr.make_record(ts, opts, dual=True)
    for _ in range(60):
        js = step(js)
        kr.rank1_step_reference(rec, opts, stall, None)
        ps = kr.record_state(rec)
        assert torch.equal(as_bits(ps.T),
                           as_bits(torch.from_numpy(np.array(js.T))))
        for name in ("basis", "status", "niter", "stuck", "bland"):
            assert np.array_equal(getattr(ps, name).numpy(),
                                  np.asarray(getattr(js, name))), name
        if int(ps.status) != Status.RUNNING:
            break
    assert int(ps.status) != Status.RUNNING


# ---------------------------------------------------------------------------
# the lane loops at B = 1, the route rule
# ---------------------------------------------------------------------------

def _solo_plain(step, state, opts, stall):
    return run_chunked(lambda s: step(s, opts, stall, opts.max_iters),
                       state, lambda s: s, opts.max_iters)


@pytest.mark.parametrize("rule", ["dantzig", "bland", "max_increase",
                                  "maxpiv"])
@pytest.mark.parametrize("instance", ["bounded1", "cleanup", "equalities"])
def test_primal_lanes_at_one_lane_equal_the_solo_walk(instance, rule):
    state = port_state(instance, torch.float64)
    opts, _ = rule_opts(rule, torch.float64)
    stall = opts.resolved_stall_limit(state.m, state.n)
    out = one_lane(planes.primal_lanes_reference, state, opts, stall,
                   opts.max_iters)
    assert_same(out, _solo_plain(simplex_step, state, opts, stall))
    assert int(out.status) != Status.RUNNING


@pytest.mark.parametrize("seed", [0, 1])
def test_dual_lanes_at_one_lane_equal_the_solo_walk(seed):
    A, b, basis, _, tf = _root(seed)
    frame = pdual.warm_state_from_basis(*tf, basis,
                                        _tightened(A, b, basis, seed))
    opts = SolverOptions.for_dtype(torch.float64)
    stall = opts.resolved_stall_limit(frame.m, frame.n)
    out = one_lane(planes.dual_lanes_reference, frame, opts, stall,
                   opts.max_iters)
    ref = _solo_plain(pdual.dual_simplex_step, frame, opts, stall)
    assert_same(out, ref)
    assert int(out.niter) > 0 and int(out.status) != Status.RUNNING


@pytest.mark.parametrize("case", [
    ("primal", 60, 200, torch.float64, "lane_primal"),
    ("primal", 60, 200, torch.float32, "lane_primal"),
    # past one block, within a cluster of 8 (kernels.rank1_cluster)
    ("primal", 258, 769, torch.float64, "rank1_cluster"),
    ("primal", 258, 769, torch.float32, "rank1_cluster"),
    # past a cluster, within the grid's plan (kernels.rank1_grid)
    ("primal", 1538, 3073, torch.float64, "rank1_grid"),
    ("devex", 60, 200, torch.float64, "rank1_cluster"),
    ("devex", 258, 775, torch.float32, "rank1_cluster"),
    ("dual", 60, 200, torch.float64, "lane_dual"),
    ("dual", 60, 200, torch.float32, "lane_dual"),
    ("dual", 258, 769, torch.float64, "rank1_cluster"),
    ("dual", 1538, 3073, torch.float64, "rank1_grid"),
    # past the lane kernels' shared memory for their vectors, within the
    # grid's streamed plan
    ("dual", 8002, 24001, torch.float64, "rank1_grid"),
    ("primal", 8002, 24001, torch.float64, "rank1_grid"),
])
def test_solo_route(case):
    walk, M, N, dtype, route = case
    assert solo_route(walk, M, N, dtype) == route


def test_solo_route_follows_the_lane_plan():
    """The rank-1 and dual walks leave the lane kernels exactly where a
    frame stops being resident in one block, for the cluster kernel (these
    frames fit a cluster); devex never takes them."""
    from tpulp_torch.kernels import lane_plan

    for dtype in (torch.float32, torch.float64):
        for M, N in ((40, 300), (100, 280), (120, 300), (200, 400)):
            resident = lane_plan(M, N, dtype).resident
            for walk, lane in (("primal", "lane_primal"),
                               ("dual", "lane_dual")):
                want = lane if resident else "rank1_cluster"
                assert solo_route(walk, M, N, dtype) == want
            assert solo_route("devex", M, N, dtype) == "rank1_cluster"
    with pytest.raises(ValueError, match="walk"):
        solo_route("bounded", 10, 10, torch.float64)


# ---------------------------------------------------------------------------
# the wrapper and the dispatch
# ---------------------------------------------------------------------------

def _small():
    return port_state("bounded1", torch.float64), \
        SolverOptions.for_dtype(torch.float64)


def test_dual_walk_takes_no_weights():
    state, opts = _small()
    ones = torch.ones(state.n, dtype=torch.float64)
    with pytest.raises(ValueError, match="dual"):
        kr.make_record(state, opts, ones, dual=True)


def test_cpu_walks_never_reach_a_kernel(monkeypatch):
    """On CPU tensors ``run_simplex``, ``run_simplex_devex`` and
    ``run_dual_simplex`` are the plain loops: a kernel wrapper that raises
    is never called, no launch is counted, and each walk is the plain
    loop's (tpulp's, held in test_torch_drivers.py)."""
    def refuse(*args, **kw):
        raise AssertionError("a kernel route was taken on the CPU")

    for mod in (pdriver, pdevex, pdual):
        monkeypatch.setattr(mod, "solo_walk", refuse)
    for name in ("rank1_cluster", "rank1_grid", "lane_primal", "lane_dual"):
        monkeypatch.setattr(pdriver, name, refuse)
    reset_launches()
    state, opts = _small()
    stall = opts.resolved_stall_limit(state.m, state.n)
    out = pdriver.run_simplex(state, opts)
    assert_same(out, pdriver.finish(_solo_plain(simplex_step, state, opts,
                                                stall)))
    assert int(out.status) == Status.OPTIMAL
    assert int(pdevex.run_simplex_devex(state, opts).status) == \
        Status.OPTIMAL
    A, b, basis, _, tf = _root(0)
    frame = pdual.warm_state_from_basis(*tf, basis,
                                        _tightened(A, b, basis, 0))
    assert int(pdual.run_dual_simplex(frame, opts).status) == \
        Status.OPTIMAL
    lp = _wyndor(12)
    sol = tpulp_torch.solve_lp(lp, device="cpu")
    assert sol.objective == 400
    assert tpulp_torch.solve_lp(lp, pricing="devex",
                                device="cpu").objective == 400
    # the RHS moved past the basis (y = 2 cap - 16 < 0): the warm frame
    # re-solves on the dual simplex
    warm = tpulp_torch.solve_lp(_wyndor(7), warm_start=sol, device="cpu")
    assert warm.objective == 280 and warm.niter > 0
    assert all(LAUNCHES[k] == 0 for k in ("rank1_cluster", "rank1_grid",
                                          "lane_primal", "lane_dual",
                                          "fused_fma"))


def _wyndor(cap):
    """max 40x + 30y, x + y <= cap, 2x + y <= 16."""
    from tpulp_torch import LinExpr, LinProg

    lp = LinProg()
    lp.addVar("x")
    lp.addVar("y")
    lp.maximize(LinExpr(40, "x", 30, "y"))
    lp.addConstraint(LinExpr(1, "x", 1, "y").constraintLeq(cap))
    lp.addConstraint(LinExpr(2, "x", 1, "y").constraintLeq(16))
    return lp
