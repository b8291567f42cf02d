"""tpulp_torch.solve_milp against tpulp.milp.solve_milp at float64: the same
status, exact objective and x, and equal BnbStats counters (the same tree)
on most-fractional and pseudocost branching, exact and float bounding,
generation chaining, general integers, integral-objective rounding,
presolve exits and pool overflow with the pool audit on; at float32 the
exact optimum against the DP oracle."""

import dataclasses
from fractions import Fraction as F

import numpy as np
import pytest
import torch

import tpulp.milp.bnb as jbnb
import tpulp_torch
import tpulp_torch.milp.bnb as tbnb
from tpulp import LinExpr, LinProg, LinVar

from test_torch_model import to_port

torch.set_num_threads(1)
pytestmark = pytest.mark.filterwarnings(
    "error:There is a performance drop")

COUNTERS = [f.name for f in dataclasses.fields(jbnb.BnbStats)
            if not f.name.startswith("t_")]


def knapsack(n, seed):
    """bench.py's knapsack recipe: (lp, values, weights, cap)."""
    rng = np.random.default_rng(seed)
    values = [int(v) for v in rng.integers(10, 60, size=n)]
    weights = [int(w) for w in rng.integers(5, 25, size=n)]
    cap = int(sum(weights) * 0.4)
    lp = LinProg()
    obj = LinExpr()
    wexpr = LinExpr()
    for i in range(n):
        lp.addVar(f"x{i}", integral=True, lb=0, ub=1)
        obj += LinExpr(values[i], f"x{i}")
        wexpr += LinExpr(weights[i], f"x{i}")
    lp.maximize(obj)
    lp.addConstraint(wexpr.constraintLeq(cap))
    return lp, values, weights, cap


def dp_oracle(values, weights, cap):
    best = [0] * (cap + 1)
    for v, w in zip(values, weights):
        for c in range(cap, w - 1, -1):
            best[c] = max(best[c], best[c - w] + v)
    return best[cap]


def set_cover(n_sets=16, n_elems=12, seed=1):
    """tests/test_milp.py's set cover family: a fractional root (a real
    integrality gap) and an integral objective."""
    rng = np.random.default_rng(seed)
    covers = []
    for _ in range(n_sets):
        k = int(rng.integers(2, 6))
        covers.append(set(int(e) for e in
                          rng.choice(n_elems, size=k, replace=False)))
    for e in range(n_elems):
        if not any(e in c for c in covers):
            covers[int(rng.integers(0, n_sets))].add(e)
    costs = [int(c) for c in rng.integers(3, 20, size=n_sets)]
    lp = LinProg()
    obj = LinExpr()
    for s, c in enumerate(costs):
        lp.addVar(f"s{s}", integral=True, lb=0, ub=1)
        obj += LinExpr(c, f"s{s}")
    lp.minimize(obj)
    for e in range(n_elems):
        cover = LinExpr()
        for s, cv in enumerate(covers):
            if e in cv:
                cover += LinExpr(1, f"s{s}")
        lp.addConstraint(cover.constraintGeq(1))
    return lp


def general_integer(seed, n=12, mcon=4):
    """tests/test_device_gen.py's bounded general-integer family (>= rows,
    non-binary branching)."""
    rng = np.random.default_rng(seed)
    A = rng.integers(-4, 7, size=(mcon, n))
    c = rng.integers(-9, 10, size=n)
    rhs = rng.integers(-10, 15, size=mcon)
    lp = LinProg()
    obj = LinExpr()
    for i in range(n):
        lp.addVar(f"x{i}", integral=True, lb=0, ub=3)
        obj += LinExpr(int(c[i]), f"x{i}")
    lp.minimize(obj)
    for k in range(mcon):
        e = LinExpr()
        for i in range(n):
            if A[k, i]:
                e += LinExpr(int(A[k, i]), f"x{i}")
        lp.addConstraint(e.constraintGeq(int(rhs[k])))
    return lp


def fractional_objective():
    lp = LinProg()
    lp.addVar("a", integral=True, lb=0, ub=5)
    lp.addVar("b", integral=True, lb=0, ub=5)
    lp.addVar("y", lb=0)
    lp.maximize(LinExpr(F(3, 2), "a", 1, "b", F(1, 3), "y"))
    lp.addConstraint(LinExpr(1, "a", 1, "b", 1, "y").constraintLeq("15/2"))
    return lp


def both(make, **kw):
    """(tpulp's, the port's) (Solution, BnbStats) on the same program."""
    ref = jbnb.solve_milp(make(), return_stats=True, **kw)
    out = tpulp_torch.solve_milp(to_port(make()), return_stats=True,
                                 device="cpu", **kw)
    return ref, out


def assert_same_tree(ref, out):
    (rs, rst), (os_, ost) = ref, out
    assert os_.status == rs.status
    assert os_.objective == rs.objective
    assert os_.x == rs.x
    assert os_.mip_gap == rs.mip_gap
    assert {k: getattr(ost, k) for k in COUNTERS} == \
        {k: getattr(rst, k) for k in COUNTERS}


@pytest.fixture
def audit(monkeypatch):
    """The pool audit on in both packages."""
    monkeypatch.setattr(jbnb, "POOL_DEBUG", True)
    monkeypatch.setattr(tbnb, "POOL_DEBUG", True)


CASES = {
    # exact bounding (m <= 32), most fractional
    "knapsack12-exact": (lambda: knapsack(12, 0)[0], dict(batch_size=16)),
    # float bounding with generation chaining
    "knapsack18-chain": (lambda: knapsack(18, 3)[0], dict(batch_size=16)),
    # chain children past the batch, re-queued cold
    "knapsack16-chain-b4": (lambda: knapsack(16, 5)[0],
                            dict(batch_size=4)),
    "knapsack18-refine-exact": (lambda: knapsack(18, 3)[0],
                                dict(batch_size=16, refine="exact")),
    "knapsack14-pseudocost": (lambda: knapsack(14, 13)[0],
                              dict(batch_size=8, branching="pseudocost")),
    # float waves without the chain, full value vectors off the summary
    "setcover-pseudocost": (set_cover,
                            dict(batch_size=16, branching="pseudocost")),
    # integral-objective bound rounding, with the chain
    "setcover-rounding": (set_cover, dict(batch_size=16)),
    "general-integer": (lambda: general_integer(5),
                        dict(batch_size=16, max_nodes=600)),
    "fractional-objective": (fractional_objective, dict(batch_size=4)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_same_tree_as_tpulp(case, audit):
    make, kw = CASES[case]
    ref, out = both(make, **kw)
    assert_same_tree(ref, out)
    assert out[0].status == "optimal"
    assert out[1].nodes_solved > 1


def test_chain_ran_and_children_warm_started():
    _, stats = tpulp_torch.solve_milp(to_port(knapsack(18, 3)[0]),
                                      batch_size=16, return_stats=True,
                                      device="cpu")
    assert stats.gen_waves > 0 and stats.gen_nodes > 0
    assert 2 * stats.warm_nodes > stats.nodes_solved
    assert stats.warm_pivots < 12 * stats.warm_nodes


@pytest.mark.parametrize("cap, refine", [(1, "exact"), (3, "float64")])
def test_pool_overflow_same_tree(monkeypatch, audit, cap, refine):
    """A pool of one or three slots: children cold-solve beside warm ones
    (mixed waves, deferred-write flushes), and the tree stays tpulp's."""
    monkeypatch.setattr(jbnb, "POOL_CAP_MAX", cap)
    monkeypatch.setattr(tbnb, "POOL_CAP_MAX", cap)
    lp, values, weights, c = knapsack(14, 3)
    ref, out = both(lambda: knapsack(14, 3)[0], batch_size=4, refine=refine)
    assert_same_tree(ref, out)
    assert out[0].objective == dp_oracle(values, weights, c)
    assert 0 < out[1].warm_nodes < out[1].nodes_solved - 1


@pytest.mark.parametrize("seed", [0, 1])
def test_float32_hits_the_dp_oracle(seed):
    lp, values, weights, cap = knapsack(18, seed)
    sol, stats = tpulp_torch.solve_milp(to_port(lp), dtype=torch.float32,
                                        batch_size=32, return_stats=True,
                                        device="cpu")
    assert sol.status == "optimal" and sol.mip_gap == 0.0
    assert sol.objective == dp_oracle(values, weights, cap)
    assert all(sol.x[f"x{i}"] in (0, 1) for i in range(18))
    assert stats.gen_waves > 0


def _presolve_reducible():
    """A knapsack plus an integer var the singleton row fixes to 2."""
    lp = knapsack(10, 2)[0]
    lp.addVar("f", integral=True, lb=0, ub=5)
    lp.addConstraint(LinExpr(1, "f").constraintEq(2))
    lp.maximize(lp.objective.expr + LinExpr(5, "f"))
    return lp


def _presolve_infeasible():
    lp = LinProg()
    lp.addVariable(LinVar("x", True, "1/3", "2/3"))
    lp.minimize(LinExpr(1, "x"))
    return lp


def _presolve_unbounded():
    lp = LinProg()
    lp.addVar("x", integral=True, lb=0, ub=4)
    lp.addVar("y", lb=0)
    lp.maximize(LinExpr(1, "x", 1, "y"))
    lp.addConstraint(LinExpr(2, "x").constraintLeq(5))
    return lp


def _presolve_solved():
    lp = LinProg()
    lp.addVar("x", integral=True, lb=2, ub=2)
    lp.maximize(LinExpr(3, "x"))
    return lp


def _pure_lp():
    lp = LinProg()
    lp.addVar("x", ub=4)
    lp.addVar("y")
    lp.maximize(LinExpr(1, "x", 1, "y"))
    lp.addConstraint(LinExpr(1, "x", 2, "y").constraintLeq(7))
    return lp


@pytest.mark.parametrize("make, status", [
    (_presolve_reducible, "optimal"),
    (_presolve_infeasible, "infeasible"),
    (_presolve_unbounded, "unbounded"),
    (_presolve_solved, "optimal"),
    (_pure_lp, "optimal"),
], ids=["reducible", "infeasible", "unbounded", "fully-solved", "pure-lp"])
def test_presolve_exits_match_tpulp(make, status):
    ref, out = both(make, batch_size=4)
    assert_same_tree(ref, out)
    assert out[0].status == status
