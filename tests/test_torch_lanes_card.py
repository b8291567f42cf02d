"""The lane kernels on the card against their plain loops on the same
inputs: ``lane_primal`` (``primal_lanes_reference``), ``lane_bounded``
(``bounded_lanes_reference``), ``lane_dual`` (``dual_lanes_reference``),
the cluster lanes ``rank1_cluster_lanes`` and the solo cluster walk
``rank1_cluster`` (their plain versions), every field bit for bit: the
tableau as ``T + 0.0`` (NaN equal to NaN), the basis, the masks, every
scalar, the at-upper flags and the devex weights.

The cases: phase-1 batches with a redundant row (the retire), mixed-sign
rows (the clean-up), an infeasible and an unbounded lane; warm frames for
the dual loop with a NaN and an overflowing |b| sum; box LPs with upper
hits and entering flips; span-encoded knapsack nodes. Each redesigned
kernel runs on both of its resident plans (one warp, and 256 threads),
on its streamed plan, with a lane frozen at the launch (one not RUNNING,
one at its budget), at a budget of 1 and with the waves' broadcast masks
(lane stride 0); the cluster lanes at every cluster size the frame
allows; ``primal_lanes`` on each of its three routes.

Every test here needs a CUDA card (the ``cuda`` marker) and skips without
one. The file imports neither jax nor tpulp, so that it runs on a machine
with the card alone: chip_smoke.py's phase 7d runs it there with
``python -m pytest --noconftest -m cuda -q -p no:cacheprovider
tests/test_torch_lanes_card.py``. The cases are built with the port's own
model classes and its plain CPU walks."""

import dataclasses

import numpy as np
import pytest
import torch

import tpulp_torch.kernels.rank1_cluster as kc
from tpulp_torch import LinExpr, LinProg
from tpulp_torch.batch import make_batched_bounded_states
from tpulp_torch.core import SolverOptions, Status, from_numpy_state
from tpulp_torch.core.state import (RULE_BLAND, RULE_DEVEX,
                                    RULE_MAX_INCREASE, TIE_MAXPIV,
                                    SimplexState, _numpy_state)
from tpulp_torch.kernels import lanes as kl
from tpulp_torch.milp.spans import _int_columns, _node_sf
from tpulp_torch.model.lower import lower_to_standard_form
from tpulp_torch.solve import dual as pdual
from tpulp_torch.solve import lanes
from tpulp_torch.solve.bounded import BoundedState
from tpulp_torch.solve.driver import run_simplex

torch.set_num_threads(1)

DTYPES = ["float32", "float64"]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py's phase 7d runs this "
                    "file there)")


def as_bits(x: torch.Tensor) -> torch.Tensor:
    """Floats as the bits of ``x + 0.0`` with every NaN alike; other
    types as they are."""
    x = x.cpu()
    if not x.is_floating_point():
        return x
    ints = torch.int64 if x.dtype == torch.float64 else torch.int32
    return (torch.where(torch.isnan(x), torch.zeros_like(x), x) + 0.0
            ).view(ints) + torch.isnan(x).to(ints)


def assert_same(a, b, label=""):
    """Every field of two states (SimplexState or BoundedState) equal."""
    if isinstance(a, BoundedState):
        assert (a.gamma is None) == (b.gamma is None)
        pairs = list(zip(a.s._fields, a.s, b.s)) + [
            ("upper", a.upper, b.upper), ("at_upper", a.at_upper,
                                          b.at_upper)]
        if a.gamma is not None:
            pairs.append(("gamma", a.gamma, b.gamma))
    else:
        pairs = list(zip(a._fields, a, b))
    for name, x, y in pairs:
        assert x.dtype == y.dtype, (label, name)
        assert torch.equal(as_bits(x), as_bits(y)), (label, name)


def on_card(st: SimplexState, dtype) -> SimplexState:
    return SimplexState(*(x.to(dtype).cuda() if x.is_floating_point()
                          else x.cuda() for x in st))


def bounded_on_card(bs: BoundedState, dtype) -> BoundedState:
    return BoundedState(s=on_card(bs.s, dtype),
                        upper=bs.upper.to(dtype).cuda(),
                        at_upper=bs.at_upper.cuda(),
                        gamma=None if bs.gamma is None
                        else bs.gamma.to(dtype).cuda())


def stack(rows) -> SimplexState:
    """A batched state of (c, A, b, hint) rows started as they stand."""
    leaves = [_numpy_state(c, A, b, hint, 0)
              + (Status.RUNNING, 0, 0, False, np.inf)
              for c, A, b, hint in rows]
    return from_numpy_state([np.stack([x[i] for x in leaves])
                             for i in range(10)], device="cpu",
                            dtype=torch.float64)


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

def cold_rows(seed, lanes_=6, m0=6, n0=8):
    """Phase-1 LPs of small integer data (every row artificial): ties in
    pricing and ratios, a redundant row (its artificial stays basic at zero
    and is retired in phase 2), an infeasible lane, an unbounded lane, and
    from lane 3 on mixed-sign rows at a sparse vertex, where phase 2 starts
    with artificials basic at zero that the clean-up pivots out."""
    rng = np.random.default_rng(seed)
    rows = []
    for lane in range(lanes_):
        mixed = lane >= 3
        A = rng.integers(-2 if mixed else 0, 4, size=(m0, n0)).astype(float)
        x0 = rng.integers(0, 3, size=n0).astype(float)
        if mixed:
            x0[rng.random(n0) < 0.5] = 0.0
            A[A @ x0 < 0] *= -1.0
        else:
            A[-1] = A[0] + A[1]
        b = A @ x0
        c = rng.integers(-5, 5, size=n0).astype(float)
        if lane == 1:          # inconsistent rows: phase 1 ends above 0
            A[1] = 2 * A[0]
            b[1] = 2 * b[0] + 1
            A[-1] = A[0] + A[1]
            b[-1] = b[0] + b[1]
        if lane == 2:          # an improving column with no positive entry
            A[:, 3] = 0.0
            c[3] = -1.0
        rows.append((c, A, b, [-1] * m0))
    return rows


def cold_state(seed, **kw) -> SimplexState:
    return stack(cold_rows(seed, **kw))


def dual_random(seed, m=14, n=12):
    """A bounded LP with a slack basis: (c, A, b, hint)."""
    rng = np.random.default_rng(seed)
    D = rng.normal(size=(m, n))
    x0 = np.abs(rng.normal(size=n))
    b = np.abs(D @ x0) + np.abs(rng.normal(size=m))
    c = rng.normal(size=n)
    D[-1] = 1.0
    b[-1] = 2.0 * x0.sum()
    A = np.concatenate([D, np.eye(m)], axis=1)
    return np.concatenate([c, np.zeros(m)]), A, b, list(range(n, n + m))


def tightened(A, b, basis, seed, rows=3):
    """The RHS with ``rows`` rows whose slack is basic at the optimum cut
    past the optimal vertex: a dual-feasible, primal-infeasible frame."""
    rng = np.random.default_rng(100 + seed)
    n = A.shape[1] - len(b)
    x_b = np.linalg.solve(A[:, basis], b)
    slack_at = {int(j) - n: r for r, j in enumerate(basis) if j >= n}
    cut = rng.choice(sorted(slack_at), size=min(rows, len(slack_at)),
                     replace=False)
    b2 = b.copy()
    for i in cut:
        b2[i] -= rng.uniform(1.2, 2.0) * x_b[slack_at[i]]
    return b2


def dual_state(numeric=False) -> SimplexState:
    """Eight lanes of one root's warm frames for different tightened RHS
    (some already optimal, some infeasible); with ``numeric`` lane 6 gets a
    NaN in b and lane 7 an |b| sum that overflows."""
    c, A, b, hint = dual_random(2)
    root = stack([(c, A, b, hint)])
    root = SimplexState(*(x[0] for x in root))
    out = run_simplex(root, SolverOptions.for_dtype(torch.float64))
    assert int(out.status) == Status.OPTIMAL
    basis = out.basis.numpy()
    frames = []
    for k in range(8):
        b2 = b if k == 0 else tightened(A, b, basis, 10 + k, rows=1 + k % 5)
        if k == 5:
            b2 = b2 - 50.0 * np.abs(b2)
        frames.append(pdual.warm_state_from_basis(
            root.T[2:, :-1], root.T[0, :-1], root.col_active,
            root.art_cols, basis, b2))
    st = SimplexState(*(torch.stack([getattr(f, k) for f in frames])
                        for k in SimplexState._fields))
    if numeric:
        T = st.T.clone()
        T[6, 4, -1] = float("nan")
        T[7, 3:5, -1] = 1.5e308
        st = st._replace(T=T)
    return st


def phase1_bounded(seed) -> BoundedState:
    """``cold_state``'s lanes with seeded spans on the structural columns
    (lane 2's unbounded column unbounded) and none on the artificials."""
    st = cold_state(seed)
    rng = np.random.default_rng(seed)
    B, _, N = st.T.shape
    n, n0 = N - 1, 8
    upper = np.full((B, n), np.inf)
    upper[:, :n0] = rng.integers(2, 6, size=(B, n0))
    upper[:, :n0][rng.random((B, n0)) < 0.25] = np.inf
    upper[2, 3] = np.inf
    return BoundedState(s=st, upper=torch.tensor(upper),
                        at_upper=torch.zeros((B, n), dtype=torch.bool))


def box_lp(seed, nv=9, mc=6):
    """A random box LP of integer data."""
    rng = np.random.default_rng(seed)
    lp = LinProg()
    obj = LinExpr()
    for j in range(nv):
        lp.addVar(f"v{j}", lb=0, ub=int(rng.integers(1, 9)))
        obj += LinExpr(int(rng.integers(-9, 10)), f"v{j}")
    lp.maximize(obj)
    for _ in range(mc):
        e = LinExpr()
        for j in range(nv):
            e += LinExpr(int(rng.integers(-3, 6)), f"v{j}")
        lp.addConstraint(e.constraintLeq(int(rng.integers(5, 30))))
    return lp


def box_bounded(seeds) -> BoundedState:
    return make_batched_bounded_states(
        [box_lp(s).lower(simple_bounds=True) for s in seeds], device="cpu")


def span_bounded(n_items=12, lanes_=10, seed=4) -> BoundedState:
    """A wave of span-encoded knapsack nodes: the root's spans with seeded
    fixings of three items."""
    rng = np.random.default_rng(seed)
    values = [int(v) for v in rng.integers(10, 60, size=n_items)]
    weights = [int(w) for w in rng.integers(5, 25, size=n_items)]
    lp = LinProg()
    obj, wexpr = LinExpr(), LinExpr()
    for i in range(n_items):
        lp.addVar(f"x{i}", integral=True, lb=0, ub=1)
        obj += LinExpr(values[i], f"x{i}")
        wexpr += LinExpr(weights[i], f"x{i}")
    lp.maximize(obj)
    lp.addConstraint(wexpr.constraintLeq(int(sum(weights) * 0.4)))
    root = lower_to_standard_form(lp, simple_bounds=True)
    names = [f"x{i}" for i in range(n_items)]
    cols = _int_columns(root, names)
    bounds0 = {nm: (lp.vars[nm].lb, lp.vars[nm].ub) for nm in names}
    sfs = []
    for _ in range(lanes_):
        node = dict(bounds0)
        for i in rng.choice(n_items, size=3, replace=False):
            v = int(rng.integers(0, 2))
            node[names[i]] = (v, v)
        sfs.append(_node_sf(root, cols, bounds0, node))
    return make_batched_bounded_states(sfs, device="cpu")


def frozen(st: SimplexState, max_iters: int) -> SimplexState:
    """Lane 0 OPTIMAL and lane 1 at its budget before the launch: the
    kernels and the plain loops leave both as they are."""
    status, niter = st.status.clone(), st.niter.clone()
    status[0] = Status.OPTIMAL
    niter[1] = max_iters
    return st._replace(status=status, niter=niter)


def broadcast(st: SimplexState) -> SimplexState:
    """The masks as the waves pass them: lane 0's rows, lane stride 0."""
    B = st.T.shape[0]
    return st._replace(col_active=st.col_active[:1].expand(B, -1),
                       art_cols=st.art_cols[:1].expand(B, -1))


def stall_of(st: SimplexState, opts) -> int:
    return opts.resolved_stall_limit(st.T.shape[1] - 2, st.T.shape[2] - 1)


# ---------------------------------------------------------------------------
# moved from the CPU test files (which import jax): the kernels against
# the plain loops
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_lane_kernels_match_plain_loops(dtype):
    _card()
    tt = getattr(torch, dtype)
    for st, fn, ref_fn, kw in (
            (cold_state(10), lanes.primal_lanes,
             lanes.primal_lanes_reference, dict(rule=RULE_MAX_INCREASE,
                                                tie_break=TIE_MAXPIV)),
            (dual_state(numeric=True), lanes.dual_lanes,
             lanes.dual_lanes_reference, dict(stall_limit=2,
                                              degen_tol=1e300))):
        ts = on_card(st, tt)
        to = dataclasses.replace(SolverOptions.for_dtype(tt), max_iters=200,
                                 **kw)
        stall = stall_of(ts, to)
        k = fn(ts, to, stall, to.max_iters)
        p = ref_fn(ts, to, stall, to.max_iters)
        torch.cuda.synchronize()
        assert_same(k, p)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_lane_bounded_matches_plain_loop(dtype):
    _card()
    tt = getattr(torch, dtype)
    for bs, kw in ((phase1_bounded(12), dict(rule=RULE_DEVEX)),
                   (box_bounded(range(70, 78)), dict(stall_limit=1,
                                                     degen_tol=1e300)),
                   (span_bounded(), dict(max_iters=4))):
        tbs = bounded_on_card(bs, tt)
        to = dataclasses.replace(SolverOptions.for_dtype(tt),
                                 **{"max_iters": 200, **kw})
        if to.rule == RULE_DEVEX:
            tbs = tbs._replace(gamma=torch.ones_like(tbs.upper))
        stall = stall_of(tbs.s, to)
        k = lanes.bounded_lanes(tbs, to, stall, to.max_iters)
        p = lanes.bounded_lanes_reference(tbs, to, stall, to.max_iters)
        torch.cuda.synchronize()
        assert_same(k, p)


# the solo walks' instances (tests/test_torch_rank1_kernel.py's, built with
# the port alone): (c, A, b, hint)
def _random(seed, m=12, n=20, bounded=False):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n))
    x0 = np.abs(rng.normal(size=n))
    b = A @ x0 + np.abs(rng.normal(size=m))
    c = rng.normal(size=n)
    if bounded:
        A[-1] = 1.0
        b[-1] = 2.0 * x0.sum()
    Af = np.concatenate([A, np.eye(m)], axis=1)
    cf = np.concatenate([c, np.zeros(m)])
    return cf, Af, b, list(range(n, n + m))


def _lowered(lp):
    sf = lp.lower()
    c, A, b = sf.to_dense(np.float64)
    return c, A, b, sf.basis_hint


def _beale():
    lp = LinProg()
    for v in ["x4", "x5", "x6", "x7"]:
        lp.addVar(v)
    lp.minimize(LinExpr("-3/4", "x4", 150, "x5", "-1/50", "x6", 6, "x7"))
    lp.addConstraint(LinExpr("1/4", "x4", -60, "x5", "-1/25", "x6", 9, "x7")
                     .constraintLeq(0))
    lp.addConstraint(LinExpr("1/2", "x4", -90, "x5", "-1/50", "x6", 3, "x7")
                     .constraintLeq(0))
    lp.addConstraint(LinExpr(1, "x6").constraintLeq(1))
    return _lowered(lp)


def _cleanup():
    lp = LinProg()
    lp.addVar("x")
    lp.addVar("y")
    lp.minimize(LinExpr(2, "x", 3, "y"))
    lp.addConstraint(LinExpr(1, "x", 1, "y").constraintGeq(4))
    lp.addConstraint(LinExpr(1, "x", -1, "y").constraintEq(0))
    lp.addConstraint(LinExpr(2, "x", 2, "y").constraintGeq(8))
    return _lowered(lp)


def _equalities(seed, m=10, n=14):
    rng = np.random.default_rng(seed)
    A = rng.integers(0, 4, size=(m - 2, n)).astype(float)
    x0 = rng.integers(1, 4, size=n) * (rng.random(n) < 0.5)
    A = np.vstack([A, 2 * A[0], A[1] + A[2]])
    return rng.integers(-5, 6, size=n).astype(float), A, A @ x0, [-1] * m


def _infeasible():
    A = np.array([[1.0, 1.0, 1.0, 0.0], [1.0, 1.0, 0.0, -1.0]])
    return np.array([-1.0, -1.0, 0.0, 0.0]), A, np.array([1.0, 3.0]), \
        [2, -1]


def _numeric():
    c, A, b, hint = _random(4)
    b[3] = np.inf
    return c, A, b, hint


def _ray():
    c, A, b, hint = _random(5, bounded=True)
    A[:, 2] = -np.abs(A[:, 2])
    c[2] = -3.0
    return c, A, b, hint


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
RULES = {
    "dantzig": ({}, False),
    "bland": ({"rule": RULE_BLAND}, False),
    "max_increase": ({"rule": RULE_MAX_INCREASE}, False),
    "maxpiv": ({"tie_break": TIE_MAXPIV}, False),
    "max_increase_maxpiv": ({"rule": RULE_MAX_INCREASE,
                             "tie_break": TIE_MAXPIV}, False),
    "devex_rule": ({"rule": RULE_DEVEX}, False),
    "stall_bland": ({"stall_limit": 1, "degen_tol": 1e30}, False),
    "devex": ({}, True),
}


def _warm(seed, rows=3):
    c, A, b, hint = dual_random(seed, m=12, n=10)
    root = SimplexState(*(x[0] for x in stack([(c, A, b, hint)])))
    out = run_simplex(root, SolverOptions.for_dtype(torch.float64))
    basis = out.basis.numpy()
    b2 = b if rows == 0 else tightened(A, b, basis, seed, rows)
    return [x.numpy().copy() for x in pdual.warm_state_from_basis(
        root.T[2:, :-1], root.T[0, :-1], root.col_active, root.art_cols,
        basis, b2)]


def _dual_infeasible():
    f = _warm(0)
    r = int(np.argmin(f[0][2:, -1])) + 2
    f[0][r, :-1] = np.abs(f[0][r, :-1])
    return f


def _dual_numeric():
    f = _warm(1)
    f[0][0, int(np.flatnonzero(f[2])[0])] = np.inf
    return f


def _dual_nan():
    f = _warm(2)
    f[0][3, -1] = np.nan
    return f


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


def case_inputs(walk, instance, rule, dtype):
    """(state, options, stall limit, devex weights or None, dual)."""
    if walk == "dual":
        state = from_numpy_state(DUAL_INSTANCES[instance](), device="cpu",
                                 dtype=dtype)
        opts, devex = SolverOptions.for_dtype(dtype,
                                              **DUAL_RULES[rule]), False
    else:
        st = stack([INSTANCES[instance]()])
        state = SimplexState(*(x[0].to(dtype) if x.is_floating_point()
                               else x[0] for x in st))
        over, devex = RULES[rule]
        opts = SolverOptions.for_dtype(dtype, **over)
    stall = opts.resolved_stall_limit(state.m, state.n)
    gamma = torch.ones(state.n, dtype=dtype) if devex else None
    return state, opts, stall, gamma, walk == "dual"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_rank1_cluster_matches_its_plain_version(dtype):
    _card()
    tt = getattr(torch, dtype)
    cases = [("primal", i, r) for i in INSTANCES for r in RULES] + \
        [("dual", i, r) for i in DUAL_INSTANCES for r in DUAL_RULES]
    for case in cases:
        state, opts, stall, gamma, dual = case_inputs(*case, tt)
        M, N = state.T.shape
        for C in kc.CLUSTER_SIZES:
            try:
                kc.cluster_plan(M, N, tt, C)
            except ValueError:
                continue
            for budget in (opts.max_iters, 1):
                out, g = kc.rank1_cluster(
                    type(state)(*(x.cuda() for x in state)), opts, stall,
                    budget, None if gamma is None else gamma.cuda(), dual,
                    blocks=C)
                ref, rg = kc.rank1_cluster_reference(state, opts, stall,
                                                     budget, gamma, dual, C)
                torch.cuda.synchronize()
                assert_same(type(out)(*(x.cpu() for x in out)), ref)
                assert (g is None) == (rg is None)
                if g is not None:
                    assert torch.equal(as_bits(g), as_bits(rg))


# ---------------------------------------------------------------------------
# the redesigned kernels' plans, frozen lanes, budgets, broadcast masks
# ---------------------------------------------------------------------------

PRIMAL_OPTS = {
    "dantzig": {},
    "bland": {"rule": RULE_BLAND},
    "max_increase_maxpiv": {"rule": RULE_MAX_INCREASE,
                            "tie_break": TIE_MAXPIV},
    "stall_bland": {"stall_limit": 1, "degen_tol": 1e300},
}


def primal_cases(tt):
    """(label, state on the card, options): each rule on a cold batch, then
    a frozen lane, a budget of 1 and the broadcast masks."""
    base = SolverOptions.for_dtype(tt, max_iters=300)
    st = on_card(cold_state(11, lanes_=8), tt)
    for name, over in PRIMAL_OPTS.items():
        yield name, st, dataclasses.replace(base, **over)
    yield "frozen", frozen(st, 300), base
    yield "budget_1", st, dataclasses.replace(base, max_iters=1)
    yield "broadcast_masks", broadcast(st), base


@pytest.mark.cuda
@pytest.mark.parametrize("plan", ["one_warp", "threads_256", "streamed"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_lane_primal_plans(dtype, plan):
    """lane_primal on one warp, on 256 threads and on the streamed plan
    against the plain loop."""
    _card()
    tt = getattr(torch, dtype)
    kw = {"one_warp": dict(threads=32), "threads_256": dict(threads=256),
          "streamed": dict(resident=False)}[plan]
    for label, st, opts in primal_cases(tt):
        stall = stall_of(st, opts)
        k = kl.lane_primal(st, opts, stall, opts.max_iters, **kw)
        p = lanes.primal_lanes_reference(st, opts, stall, opts.max_iters)
        torch.cuda.synchronize()
        assert_same(k, p, label)


def bounded_cases(tt):
    base = SolverOptions.for_dtype(tt, max_iters=300)
    devex = dataclasses.replace(base, rule=RULE_DEVEX)
    box = bounded_on_card(box_bounded(range(20, 30)), tt)
    ph1 = bounded_on_card(phase1_bounded(7), tt)
    spans = bounded_on_card(span_bounded(lanes_=12, seed=5), tt)
    for label, bs in (("box", box), ("phase1", ph1), ("spans", spans)):
        yield label, bs, base
        yield label + "_devex", bs._replace(
            gamma=torch.ones_like(bs.upper)), devex
    yield "stall_bland", box, dataclasses.replace(base, stall_limit=1,
                                                   degen_tol=1e300)
    yield "frozen", box._replace(s=frozen(box.s, 300)), base
    yield "budget_1", ph1, dataclasses.replace(base, max_iters=1)
    yield "broadcast_masks", box._replace(s=broadcast(box.s)), base


@pytest.mark.cuda
@pytest.mark.parametrize("plan", ["one_warp", "threads_256", "streamed"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_lane_bounded_plans(dtype, plan):
    """lane_bounded on one warp, on 256 threads and on the streamed plan
    against the plain loop."""
    _card()
    tt = getattr(torch, dtype)
    kw = {"one_warp": dict(threads=32), "threads_256": dict(threads=256),
          "streamed": dict(resident=False)}[plan]
    for label, bs, opts in bounded_cases(tt):
        stall = stall_of(bs.s, opts)
        k = kl.lane_bounded(bs, opts, stall, opts.max_iters, **kw)
        p = lanes.bounded_lanes_reference(bs, opts, stall, opts.max_iters)
        torch.cuda.synchronize()
        assert_same(k, p, label)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_cluster_lanes(dtype):
    """rank1_cluster_lanes at every cluster size the frame allows against
    the plain loop and against its own plain version at that size."""
    _card()
    tt = getattr(torch, dtype)
    for label, st, opts in primal_cases(tt):
        stall = stall_of(st, opts)
        _, M, N = st.T.shape
        p = lanes.primal_lanes_reference(st, opts, stall, opts.max_iters)
        for C in kc.CLUSTER_SIZES:
            try:
                kc.cluster_plan(M, N, tt, C)
            except ValueError:
                continue
            k = kc.rank1_cluster_lanes(st, opts, stall, opts.max_iters,
                                       blocks=C)
            torch.cuda.synchronize()
            assert_same(k, p, f"{label} C {C}")
        if label in ("dantzig", "frozen"):
            cpu = SimplexState(*(x.cpu() for x in st))
            r = kc.rank1_cluster_lanes_reference(cpu, opts, stall,
                                                 opts.max_iters, 2)
            assert_same(SimplexState(*(x.cpu() for x in k)), r, label)


@pytest.mark.cuda
@pytest.mark.parametrize("route", lanes.PRIMAL_ROUTES)
def test_cuda_primal_lanes_routes(route):
    """primal_lanes on each of its routes, forced, against the plain loop
    (f64)."""
    _card()
    st = on_card(cold_state(12, lanes_=8), torch.float64)
    opts = SolverOptions.for_dtype(torch.float64, max_iters=300)
    stall = stall_of(st, opts)
    k = lanes.primal_lanes(st, opts, stall, opts.max_iters, route=route)
    p = lanes.primal_lanes_reference(st, opts, stall, opts.max_iters)
    torch.cuda.synchronize()
    assert_same(k, p)
