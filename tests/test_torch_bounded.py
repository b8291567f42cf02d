"""tpulp_torch's bounded-variable simplex against tpulp's at float64: the
step walks step for step (status, pivots, basis, at-upper flags, and the
whole tableau bit for bit, so the RHS after every flip), the terminal
states of the chunked loop, ``solve_lp(simple_bounds=True)`` (exact
objectives, rungs and the escalation ladder) on the same numpy-seeded
inputs."""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpulp.solve as tpulp_solve
import tpulp_torch
from tpulp import LinExpr, LinProg
from tpulp.core.state import RULE_DEVEX
from tpulp.core.state import SolverOptions as TpulpOptions
from tpulp.corpus import get_case
from tpulp.solve.api import state_from_standard_form as tpulp_state
from tpulp.solve.bounded import bounded_simplex_step as tpulp_step
from tpulp.solve.bounded import extract_bounded_solution as tpulp_extract
from tpulp.solve.bounded import make_bounded_state as tpulp_bounded
from tpulp.solve.bounded import run_simplex_bounded as tpulp_run
from tpulp_torch.core import SolverOptions, Status
from tpulp_torch.solve.api import state_from_standard_form
from tpulp_torch.solve.bounded import (bounded_simplex_step,
                                       extract_bounded_solution,
                                       make_bounded_state,
                                       run_simplex_bounded)

from test_torch_model import _bounded_milp, to_port

torch.set_num_threads(1)


def box_lp(seed, m, n, degenerate=False):
    """A seeded box LP: every variable in [0, u_j], m rows (every third a
    >= row). ``degenerate`` draws small integers, so ratio ties and
    degenerate pivots occur; otherwise normal data."""
    rng = np.random.default_rng(seed)
    lp = LinProg(f"box{seed}")
    obj = LinExpr()
    for j in range(n):
        ub = int(rng.integers(1, 5)) if degenerate \
            else float(rng.uniform(0.5, 4.0))
        lp.addVar(f"v{j}", lb=0, ub=ub)
        cj = int(rng.integers(-5, 6)) if degenerate else float(rng.normal())
        obj += LinExpr(cj, f"v{j}")
    lp.maximize(obj)
    for i in range(m):
        e = LinExpr()
        for j in range(n):
            a = int(rng.integers(-2, 4)) if degenerate \
                else float(rng.normal())
            e += LinExpr(a, f"v{j}")
        if i % 3 == 2:
            rhs = -int(rng.integers(0, 3)) if degenerate \
                else -float(abs(rng.normal()))
            lp.addConstraint(e.constraintGeq(rhs))
        else:
            rhs = int(rng.integers(0, 8)) if degenerate \
                else float(3.0 * abs(rng.normal()))
            lp.addConstraint(e.constraintLeq(rhs))
    return lp


# option overrides per pricing; "bland" counts every pivot as stalled, so
# the stall switch turns Bland's rule on after the first one (the bounded
# step reads only that switch)
RULES = {"dantzig": {}, "devex": {"rule": RULE_DEVEX},
         "bland": {"stall_limit": 1, "degen_tol": 1e30}}
# the degenerate seeds walk through stalled pivots, flips or both
CASES = [(seed, 12, 20, False) for seed in range(3)] + [
    (seed, 12, 20, True) for seed in (0, 3, 8)] + [
    (seed, 30, 60, False) for seed in range(2)] + [
    (seed, 30, 60, True) for seed in (3, 11)]
CASE_IDS = [f"{m}x{n}-{'deg' if d else 'normal'}-{s}" for s, m, n, d in CASES]


def _pair(lp, **kw):
    sf = lp.lower(simple_bounds=True)
    psf = to_port(lp).lower(simple_bounds=True)
    jo = TpulpOptions.for_dtype(jnp.float64, **kw)
    po = SolverOptions.for_dtype(torch.float64, **kw)
    js = tpulp_bounded(tpulp_state(sf), sf.upper)
    ps = make_bounded_state(state_from_standard_form(psf, device="cpu"),
                            psf.upper)
    if jo.rule == RULE_DEVEX:
        js = js._replace(gamma=jnp.ones((js.s.n,), jnp.float64))
        ps = ps._replace(gamma=torch.ones(ps.s.n, dtype=torch.float64))
    return js, ps, jo, po


@pytest.mark.parametrize("rule", list(RULES))
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_walk_step_for_step(case, rule):
    """Every step leaves the same tableau (bit for bit), basis, at-upper
    flags, status and pivot count: the flip's RHS update is one fused
    multiply-add, as XLA contracts tpulp's."""
    seed, m, n, degenerate = case
    js, ps, jo, po = _pair(box_lp(seed, m, n, degenerate), **RULES[rule])
    stall = jo.resolved_stall_limit(js.s.m, js.s.n)
    step = jax.jit(lambda b: tpulp_step(b, jo, stall))
    flips = stalls = 0
    for _ in range(600):
        js2, ps2 = step(js), bounded_simplex_step(ps, po, stall)
        jT = np.asarray(js2.s.T)
        assert np.array_equal(ps2.s.T.numpy().view(np.int64),
                              jT.view(np.int64))
        assert np.array_equal(ps2.at_upper.numpy(), np.asarray(js2.at_upper))
        for name in ("basis", "status", "niter", "phase", "bland"):
            assert np.array_equal(getattr(ps2.s, name).numpy(),
                                  np.asarray(getattr(js2.s, name))), name
        flips += int((ps2.at_upper != ps.at_upper).any())
        stalls += int(ps2.s.stuck > ps.s.stuck)
        js, ps = js2, ps2
        if int(ps.s.status) != Status.RUNNING:
            break
    assert int(ps.s.status) != Status.RUNNING
    assert flips + stalls > 0
    if rule == "bland":
        assert bool(ps.s.bland)


@pytest.mark.parametrize("budget", [10_000, 6])
@pytest.mark.parametrize("rule", list(RULES))
def test_driver_terminal_state(rule, budget):
    kw = dict(RULES[rule], max_iters=budget)
    js, ps, _, _ = _pair(box_lp(4, 30, 60), **kw)
    # the drivers start the devex weights themselves
    js = js._replace(gamma=None)
    ps = ps._replace(gamma=None)
    ref = tpulp_run(js, TpulpOptions.for_dtype(jnp.float64, **kw))
    out = run_simplex_bounded(ps, SolverOptions.for_dtype(torch.float64,
                                                          **kw))
    for name in ("status", "niter", "basis"):
        assert np.array_equal(getattr(out.s, name).numpy(),
                              np.asarray(getattr(ref.s, name))), name
    assert np.array_equal(out.at_upper.numpy(), np.asarray(ref.at_upper))
    x, z = extract_bounded_solution(out)
    xr, zr = tpulp_extract(ref)
    assert np.array_equal(x.numpy(), np.asarray(xr))
    assert float(z) == float(zr)
    if budget == 6:
        assert int(out.s.status) == Status.ITERATION_LIMIT


def _box():
    """max 3x + 2y, x <= 4, y <= 3, x + y <= 5: 14 at (4, 1)."""
    lp = LinProg()
    lp.addVar("x", lb=0, ub=4)
    lp.addVar("y", lb=0, ub=3)
    lp.maximize(LinExpr(3, "x", 2, "y"))
    lp.addConstraint(LinExpr(1, "x", 1, "y").constraintLeq(5))
    return lp


def _ill_scaled_box():
    """A box LP whose equilibration is material, so the spans are divided
    by the column scale on the device."""
    lp = LinProg()
    lp.addVar("x", lb=0, ub=3)
    lp.addVar("y", lb=0, ub=900)
    lp.maximize(LinExpr(1000, "x", 3, "y"))
    lp.addConstraint(LinExpr(4000, "x", 1, "y").constraintLeq(8000))
    lp.addConstraint(LinExpr(1, "x", "1/500", "y").constraintLeq(
        Fraction(7, 2)))
    return lp


PROGRAMS = {
    "box": _box,
    "ill_scaled_box": _ill_scaled_box,
    "bounded_box": get_case("bounded_box").lp,
    "free_vars": get_case("free_vars").lp,
    "bounded_milp_relaxation": _bounded_milp,
    "random_box": lambda: box_lp(11, 12, 20),
}


@pytest.mark.parametrize("pricing", ["dantzig", "devex"])
@pytest.mark.parametrize("name", list(PROGRAMS))
def test_solve_lp_simple_bounds_matches_tpulp(name, pricing):
    lp = PROGRAMS[name]()
    ref = tpulp_solve.solve_lp(lp, simple_bounds=True, pricing=pricing)
    out = tpulp_torch.solve_lp(to_port(lp), simple_bounds=True,
                               pricing=pricing, device="cpu")
    assert out.status == ref.status == "optimal"
    assert out.objective == ref.objective
    assert isinstance(out.objective, Fraction)
    assert out.x == ref.x and out.niter == ref.niter
    assert out.basis == ref.basis and out.at_upper == ref.at_upper
    assert out.rung == ref.rung
    # the row-lowered solve reaches the same exact optimum
    rows = tpulp_torch.solve_lp(to_port(lp), device="cpu")
    assert rows.objective == out.objective


@pytest.mark.parametrize("name", ["box", "ill_scaled_box"])
def test_refine_none_matches_tpulp(name):
    lp = PROGRAMS[name]()
    ref = tpulp_solve.solve_lp(lp, simple_bounds=True, refine="none")
    out = tpulp_torch.solve_lp(to_port(lp), simple_bounds=True,
                               refine="none", device="cpu")
    assert out.status == ref.status == "optimal"
    assert out.objective == ref.objective
    assert out.x == ref.x


def test_f32_matches_tpulp():
    lp = box_lp(2, 12, 20)
    ref = tpulp_solve.solve_lp(lp, simple_bounds=True, dtype=jnp.float32)
    out = tpulp_torch.solve_lp(to_port(lp), simple_bounds=True,
                               dtype=torch.float32, device="cpu")
    assert out.status == ref.status == "optimal"
    assert out.objective == ref.objective and out.rung == ref.rung


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_escalation_rungs_match_tpulp(dtype, monkeypatch):
    """A NUMERIC bounded verdict climbs tpulp's bounded ladder: no
    refreshed rung; float32 retries the bounded driver at float64, and a
    float64 failure goes to the exact host simplex."""
    import tpulp.solve.bounded as jbounded
    import tpulp_torch.solve.api as papi

    def failing_j(real):
        def run(bs, opts=None):
            out = real(bs, opts)
            if bs.s.T.dtype == jnp.float32 or dtype == "float64":
                return out._replace(s=out.s._replace(
                    status=jnp.int32(Status.NUMERIC)))
            return out
        return run

    def failing_p(real):
        def run(bs, opts=None):
            out = real(bs, opts)
            if bs.s.T.dtype == torch.float32 or dtype == "float64":
                return out._replace(s=out.s._replace(
                    status=torch.tensor(Status.NUMERIC, dtype=torch.int32)))
            return out
        return run

    monkeypatch.setattr(jbounded, "run_simplex_bounded",
                        failing_j(jbounded.run_simplex_bounded))
    monkeypatch.setattr(papi, "run_simplex_bounded",
                        failing_p(papi.run_simplex_bounded))
    lp = _box()
    ref = tpulp_solve.solve_lp(lp, simple_bounds=True,
                               dtype=getattr(jnp, dtype))
    out = tpulp_torch.solve_lp(to_port(lp), simple_bounds=True,
                               dtype=getattr(torch, dtype), device="cpu")
    assert out.rung == ref.rung == ("device-float64" if dtype == "float32"
                                    else "host-exact")
    assert out.status == ref.status == "optimal"
    assert out.objective == ref.objective == 14
    assert (out.at_upper is None) == (ref.at_upper is None)


@pytest.mark.parametrize("kind", ["infeasible", "unbounded"])
def test_verdicts_confirmed_as_tpulp(kind):
    lp = LinProg()
    lp.addVar("x", lb=0, ub=5)
    if kind == "infeasible":
        lp.minimize(LinExpr(1, "x"))
        lp.addConstraint(LinExpr(1, "x").constraintGeq(9))
    else:
        lp.addVar("free", lb=0)
        lp.maximize(LinExpr(1, "x", 1, "free"))
        lp.addConstraint(LinExpr(1, "x").constraintLeq(4))
    ref = tpulp_solve.solve_lp(lp, simple_bounds=True)
    out = tpulp_torch.solve_lp(to_port(lp), simple_bounds=True, device="cpu")
    assert out.status == ref.status == kind
    assert out.rung == ref.rung


def test_warm_basis_on_a_bounded_lowering_raises():
    sol = tpulp_torch.solve_lp(to_port(_box()), device="cpu")
    with pytest.raises(ValueError, match="at_upper"):
        tpulp_torch.solve_lp(to_port(_box()), simple_bounds=True,
                             warm_start=sol, device="cpu")


@pytest.mark.parametrize("pricing", ["devex", "dantzig"])
def test_f32_box_lp_rung_equals_tpulps(pricing):
    """chip_smoke's phase 8a box LP at m = 200 (tools/box_rung.py): the
    f32 solve answers on the same rung, in the same steps, with the same
    objective in both packages (at m = 1024 both answer on the float64
    retry, in 14,953 devex steps: tpulp's behaviour too)."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / \
        "box_rung.py"
    spec = importlib.util.spec_from_file_location("box_rung", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    res = tool.rungs(200, pricing)
    tp, port = res["tpulp"], res["port"]
    assert port["status"] == tp["status"] == "optimal"
    assert port["rung"] == tp["rung"] == "device-float32"
    assert port["niter"] == tp["niter"]
    assert port["objective"] == tp["objective"]
