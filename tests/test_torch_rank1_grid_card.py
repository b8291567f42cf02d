"""The solo rank-1, devex and dual walks' cooperative launch
(``rank1_grid``, ``tpulp_torch/kernels/csrc/rank1_grid.cu``) on the card
against its plain version ``rank1_grid_reference`` on the CPU: every field
equal (the tableau as ``T + 0.0``, NaN equal to NaN), the devex weights
too, on the plan's grid, on forced grids of 1, 3 and 7 blocks, at forced
splits of the slabs' rows (the streamed plan), on the plan with the
per-row vectors in device memory and on the wide plan (no row of a slab
in shared memory), both forced at small frames and at a frame of three
column chunks, under Dantzig, Bland, the greatest increase, largest-pivot
ties, the stall switch, devex and the dual walk; and every instance and
rule of the CPU tests' plain stages walked to its exit on the grid.

Every test here needs a CUDA card (the ``cuda`` marker) and skips without
one. The file imports neither jax nor tpulp, so that it runs on a machine
with the card alone: chip_smoke.py's phase 5c runs it there with
``python -m pytest --noconftest -m cuda -q -p no:cacheprovider
tests/test_torch_rank1_grid_card.py``. The walks are the CPU tests'
instances (``tests/test_torch_rank1_kernel.py``), built with the port's
own state builders (the warm frames from the port's own root solves)."""

import numpy as np
import pytest
import torch

import tpulp_torch.kernels.rank1_grid as kg
from tpulp_torch import LinExpr, LinProg
from tpulp_torch.core import SolverOptions, from_numpy_state, make_state
from tpulp_torch.core.state import (RULE_BLAND, RULE_DEVEX,
                                    RULE_MAX_INCREASE, TIE_MAXPIV)
from tpulp_torch.solve import dual as pdual
from tpulp_torch.solve.driver import run_simplex

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# the instances (tests/test_torch_rank1_kernel.py's, numpy and the port)
# ---------------------------------------------------------------------------

def _random(seed, m=12, n=20, bounded=False):
    """A random instance on a slack basis; ``bounded`` adds a sum(x) row so
    the optimum exists."""
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
    """Beale's cycling LP."""
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
    """Phase 1 leaves a dependent row: artificial cleanup and retirement."""
    lp = LinProg()
    lp.addVar("x")
    lp.addVar("y")
    lp.minimize(LinExpr(2, "x", 3, "y"))
    lp.addConstraint(LinExpr(1, "x", 1, "y").constraintGeq(4))
    lp.addConstraint(LinExpr(1, "x", -1, "y").constraintEq(0))
    lp.addConstraint(LinExpr(2, "x", 2, "y").constraintGeq(8))
    return _lowered(lp)


def _equalities(seed, m=10, n=14):
    """An equality LP on artificials whose last two rows are 2 x row 0 and
    row 1 + row 2: phase 1, the clean-up pivots and a retire."""
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
    # the wide plan's own case: 1,409 columns, three chunks on one block
    "wide": lambda: _random(6, m=9, n=1400, bounded=True),
}
# rule name -> (options, devex weights)
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


def _bounded_random(seed, m=12, n=10):
    """tests/test_torch_dual.py's bounded instance: (c, A, b, hint)."""
    rng = np.random.default_rng(seed)
    D = rng.normal(size=(m, n))
    x0 = np.abs(rng.normal(size=n))
    b = np.abs(D @ x0) + np.abs(rng.normal(size=m))
    c = rng.normal(size=n)
    D[-1] = 1.0
    b[-1] = 2.0 * x0.sum()
    A = np.concatenate([D, np.eye(m)], axis=1)
    return np.concatenate([c, np.zeros(m)]), A, b, list(range(n, n + m))


def _root(seed, m=12, n=10):
    """(A, b, the optimal basis, the root frame as (A_aug, c_full,
    col_active, art_cols)) of the port's f64 solve on the CPU."""
    c, A, b, hint = _bounded_random(seed, m, n)
    st = make_state(c, A, b, hint, dtype=torch.float64, device="cpu")
    out = run_simplex(st, SolverOptions.for_dtype(torch.float64))
    assert int(out.status) == 1
    return A, b, out.basis.numpy(), (st.T[2:, :-1], st.T[0, :-1],
                                     st.col_active, st.art_cols)


def _tightened(A, b, basis, seed, rows=3):
    """The RHS with ``rows`` rows whose slack is basic at the optimum cut
    past the optimal vertex: dual but not primal feasible."""
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


def _warm(seed, rows=3, m=12, n=10):
    """The warm frame of a root LP whose RHS moved past its optimal basis,
    as numpy leaves."""
    A, b, basis, frame = _root(seed, m, n)
    b2 = b if rows == 0 else _tightened(A, b, basis, seed, rows)
    return [x.numpy().copy()
            for x in pdual.warm_state_from_basis(*frame, basis, b2)]


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
    # three chunks on one block, on the dual walk
    "wide": lambda: _warm(4, rows=3, m=9, n=1400),
}
DUAL_RULES = {"dantzig": {},
              "stall_bland": {"stall_limit": 1, "degen_tol": 1e30}}
# (walk, instance, rule): test_torch_rank1_grid.py's CASES
CASES = [("primal", "equalities", "dantzig"), ("primal", "bounded1", "bland"),
         ("primal", "long", "max_increase"), ("primal", "bounded1", "maxpiv"),
         ("primal", "beale", "stall_bland"), ("primal", "long", "devex"),
         ("primal", "equalities", "devex"), ("primal", "ray", "devex"),
         ("primal", "cleanup", "dantzig"), ("primal", "numeric", "dantzig"),
         ("dual", "warm3", "dantzig"), ("dual", "deep", "stall_bland"),
         ("dual", "nan_b", "dantzig")]
# the wide plan's three-chunk frames, walked to WIDE_BUDGET steps
WIDE_CASES = [("primal", "wide", "dantzig"), ("primal", "wide", "devex"),
              ("primal", "wide", "max_increase_maxpiv"),
              ("dual", "wide", "dantzig")]
WIDE_BUDGET = 120


def case_inputs(walk, instance, rule, dtype):
    """(state, options, stall limit, devex weights or None, dual) on the
    CPU."""
    if walk == "dual":
        state = from_numpy_state(DUAL_INSTANCES[instance](), device="cpu",
                                 dtype=dtype)
        opts, devex = SolverOptions.for_dtype(dtype,
                                              **DUAL_RULES[rule]), False
    else:
        state = make_state(*INSTANCES[instance](), dtype=dtype,
                           device="cpu")
        over, devex = RULES[rule]
        opts = SolverOptions.for_dtype(dtype, **over)
    stall = opts.resolved_stall_limit(state.m, state.n)
    gamma = torch.ones(state.n, dtype=dtype) if devex else None
    return state, opts, stall, gamma, walk == "dual"


def as_bits(x: torch.Tensor) -> torch.Tensor:
    """Floats as their bits after ``+ 0.0`` (NaN as one value)."""
    if not x.is_floating_point():
        return x
    ints = torch.int64 if x.dtype == torch.float64 else torch.int32
    return (torch.nan_to_num(x, nan=0.5) + 0.0).view(ints)


def assert_same(a, b, ga=None, gb=None):
    """Every field of two states (and two weight vectors) equal."""
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        assert torch.equal(as_bits(x), as_bits(y)), name
    assert (ga is None) == (gb is None)
    if ga is not None:
        assert torch.equal(as_bits(ga), as_bits(gb))


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py's phase 5c runs this "
                    "file there)")


def _sms():
    return torch.cuda.get_device_properties(0).multi_processor_count


def _held(state, opts, stall, budget, gamma, dual, vectors="shared", **kw):
    """One ``rank1_grid`` launch (``kw``: blocks, rows, vectors) against
    ``rank1_grid_reference`` on the plan's slabs, every field."""
    plan = kg.rank1_grid_plan(*state.T.shape, state.T.dtype, _sms(),
                              vectors=None if vectors == "shared"
                              else vectors, **kw)
    assert plan.vectors == vectors
    out, g = kg.rank1_grid(
        type(state)(*(x.cuda() for x in state)), opts, stall, budget,
        None if gamma is None else gamma.cuda(), dual,
        vectors=None if vectors == "shared" else vectors, **kw)
    ref, rg = kg.rank1_grid_reference(state, opts, stall, budget, gamma,
                                      dual, plan.blocks, vectors)
    torch.cuda.synchronize()
    assert_same(type(out)(*(x.cpu() for x in out)), ref,
                None if g is None else g.cpu(), rg)
    return ref


def _overflowing(state):
    """Two RHS entries whose |b| sum overflows (NUMERIC after a step)."""
    T = state.T.clone()
    T[3:5, -1] = torch.finfo(T.dtype).max / 1.5
    return state._replace(T=T)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cuda_rank1_grid_matches_its_plain_version(dtype):
    """The plan's grid and forced grids, resident and streamed at forced
    splits (rows 3, M // 2 (3 at least), M - 1), each case to its exit."""
    _need_card()
    tt = getattr(torch, dtype)
    for case in CASES:
        state, opts, stall, gamma, dual = case_inputs(*case, tt)
        M = state.T.shape[0]
        for blocks, rows in ((None, None), (3, None), (1, 3),
                             (3, max(3, M // 2)), (7, M - 1)):
            _held(state, opts, stall, opts.max_iters, gamma, dual,
                  blocks=blocks, rows=rows)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cuda_rank1_kernels_match_the_plain_walk(dtype):
    """Every instance and rule of the plain stages' CPU tests, and every
    dual frame and rule, walked on the grid (the plan's, to a budget of
    500) and held to its plain version, every field."""
    _need_card()
    tt = getattr(torch, dtype)
    for instance in INSTANCES:
        if instance == "wide":
            continue
        for rule in RULES:
            state, opts, stall, gamma, dual = case_inputs(
                "primal", instance, rule, tt)
            _held(state, opts, stall, 500, gamma, dual)
    for instance in DUAL_INSTANCES:
        if instance == "wide":
            continue
        for rule in DUAL_RULES:
            state, opts, stall, gamma, dual = case_inputs(
                "dual", instance, rule, tt)
            _held(state, opts, stall, 500, gamma, dual)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cuda_device_vector_grid_matches_its_plain_version(dtype):
    """The device-vector plan forced at the small frames (rows 3 and M - 1
    in shared memory, the RHS and basis in device memory, the ratio test
    and the dual walk's leaving row over the blocks' rows), on the plan's
    grid and on 1, 3 and 7 blocks, to the exit and to a budget of 7, and
    with an RHS whose |b| sum overflows: every field equal to
    ``rank1_grid_reference`` on that plan (its |b| sum's order)."""
    _need_card()
    tt = getattr(torch, dtype)
    for case in CASES:
        state, opts, stall, gamma, dual = case_inputs(*case, tt)
        M = state.T.shape[0]
        for blocks in (None, 1, 3, 7):
            for rows in (None, 3):
                _held(state, opts, stall, opts.max_iters, gamma, dual,
                      "device", blocks=blocks, rows=rows)
            _held(state, opts, stall, 7, gamma, dual, "device",
                  blocks=blocks, rows=max(3, M // 2))
        _held(_overflowing(state), opts, stall, 7, gamma, dual, "device",
              blocks=3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cuda_wide_grid_matches_its_plain_version(dtype):
    """The wide plan forced at the small frames and at the three-chunk
    frames (every row streamed from device memory in chunks of
    GRID_WIDE_CHUNK columns, the dual walk's leaving row among them), on
    the plan's grid and on 1, 2, 3 and 7 blocks, to the exit (the
    three-chunk frames to WIDE_BUDGET steps) and to a budget of 7, and with
    an RHS whose |b| sum overflows: every field equal to
    ``rank1_grid_reference`` on that plan."""
    _need_card()
    tt = getattr(torch, dtype)
    for case in CASES + WIDE_CASES:
        state, opts, stall, gamma, dual = case_inputs(*case, tt)
        budget = WIDE_BUDGET if case in WIDE_CASES else opts.max_iters
        for blocks in (None, 1, 2, 3, 7):
            _held(state, opts, stall, budget, gamma, dual, "wide",
                  blocks=blocks)
            _held(state, opts, stall, 7, gamma, dual, "wide", blocks=blocks)
        _held(_overflowing(state), opts, stall, 7, gamma, dual, "wide",
              blocks=3)
        if case in WIDE_CASES:
            wp = kg.rank1_grid_plan(*state.T.shape, tt, _sms(), blocks=1,
                                    vectors="wide")
            assert -(-wp.width // wp.chunk) == 3
