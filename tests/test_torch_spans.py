"""Span-encoded branch-and-bound (``solve_milp(node_encoding='spans')``,
``tpulp_torch.milp.spans``) against tpulp's, at float64: the cases of
tests/test_milp.py's ``TestSpanEncodedNodes`` (the knapsacks of seeds 3
and 9, the bound-free node tableaus, the negative-RHS path, the two
rejections), each with the same status, exact objective, x and
``BnbStats`` counters as tpulp's span-encoded run."""

import pytest
import torch

import tpulp.milp.bnb as jbnb
import tpulp_torch
from tpulp import LinExpr, LinProg, LinVar

from test_torch_milp import COUNTERS, dp_oracle, knapsack
from test_torch_model import to_port

torch.set_num_threads(1)
pytestmark = pytest.mark.filterwarnings(
    "error:There is a performance drop")


def spans_both(lp, **kw):
    """(tpulp's, the port's) (Solution, BnbStats) of one span-encoded
    solve, held equal."""
    ref, rst = jbnb.solve_milp(lp, node_encoding="spans", return_stats=True,
                               **kw)
    out, ost = tpulp_torch.solve_milp(to_port(lp), node_encoding="spans",
                                      return_stats=True, device="cpu", **kw)
    assert out.status == ref.status
    assert out.objective == ref.objective
    assert out.x == ref.x
    assert {k: getattr(ost, k) for k in COUNTERS} == \
        {k: getattr(rst, k) for k in COUNTERS}
    return out, ost


@pytest.mark.parametrize("seed", [3, 9])
def test_knapsack_matches_tpulp_rows_and_oracle(seed):
    lp, values, weights, cap = knapsack(16, seed)
    out, stats = spans_both(lp)
    rows = tpulp_torch.solve_milp(to_port(lp), device="cpu")
    assert out.status == rows.status == "optimal"
    assert out.objective == rows.objective == dp_oracle(values, weights,
                                                        cap)
    assert all(out.x[f"x{i}"].denominator == 1 for i in range(16))
    assert stats.nodes_solved > 1 and stats.waves > 1


def test_node_tableaus_are_bound_free():
    from tpulp_torch.milp.spans import _node_sf
    from tpulp_torch.model.lower import lower_to_standard_form

    lp = LinProg()
    for i in range(4):
        lp.addVar(f"x{i}", integral=True, lb=0, ub=1)
    lp.maximize(LinExpr(10, "x0", 13, "x1", 7, "x2", 8, "x3"))
    lp.addConstraint(LinExpr(5, "x0", 6, "x1", 4, "x2", 3, "x3")
                     .constraintLeq(10))
    port = to_port(lp)
    root = lower_to_standard_form(port, simple_bounds=True)
    assert root.m == 1
    assert lower_to_standard_form(port, integer_bound_rows=True).m == 9
    # a node moves a span and the RHS, never the row count
    cols = {f"x{i}": i for i in range(4)}
    bounds0 = {f"x{i}": (0, 1) for i in range(4)}
    node = _node_sf(root, cols, bounds0, dict(bounds0, x1=(1, 1)))
    assert node.m == 1 and node.upper[1] == 0
    spans_both(lp)


def test_raised_lower_bound_negative_rhs_path():
    """An equality row with positive coefficients: raising lower bounds
    pushes the shifted b negative, through ``_node_sf``'s row negation
    and artificial fallback."""
    lp = LinProg()
    lp.addVar("a", integral=True, lb=0, ub=3)
    lp.addVar("b", integral=True, lb=0, ub=3)
    lp.maximize(LinExpr(2, "a", 3, "b"))
    lp.addConstraint(LinExpr(2, "a", 2, "b").constraintEq(5))  # no int pt
    out, _ = spans_both(lp)
    assert out.status == "infeasible"
    lp2 = LinProg()
    lp2.addVar("a", integral=True, lb=0, ub=4)
    lp2.addVar("b", integral=True, lb=0, ub=4)
    lp2.maximize(LinExpr(2, "a", 1, "b"))
    lp2.addConstraint(LinExpr(2, "a", 2, "b").constraintEq(6))
    out2, _ = spans_both(lp2)
    rows = tpulp_torch.solve_milp(to_port(lp2), device="cpu")
    assert out2.status == rows.status == "optimal"
    assert out2.objective == rows.objective


def _free_integer():
    lp = LinProg()
    lp.addVariable(LinVar("x", True, None, None))   # free integer var
    lp.minimize(LinExpr(1, "x"))
    lp.addConstraint(LinExpr(1, "x").constraintGeq(-3))
    return lp


REJECTIONS = {
    "lower bound": (_free_integer, {"presolve": False}),
    "spans": (lambda: knapsack(2, 0)[0], {"checkpoint_path": "ck.json"}),
    "time_limit": (lambda: knapsack(2, 0)[0], {"time_limit": 5.0}),
    "unknown": (lambda: knapsack(2, 0)[0], {"node_encoding": "columns"}),
}


@pytest.mark.parametrize("key", list(REJECTIONS))
def test_rejections_like_tpulp(key):
    make, kw = REJECTIONS[key]
    kw = {"node_encoding": "spans", **kw}
    match = "node_encoding" if key == "unknown" else key
    with pytest.raises(ValueError, match=match):
        jbnb.solve_milp(make(), **kw)
    with pytest.raises(ValueError, match=match):
        tpulp_torch.solve_milp(to_port(make()), device="cpu", **kw)
