"""tpulp_torch.solve_lp on the CPU against tpulp.solve_lp: the corpus with
exact objectives, duals, the kernel engine, and the options not ported."""

from fractions import Fraction

import pytest
import torch

import tpulp.solve as tpulp_solve
import tpulp_torch
from tpulp import LinExpr, LinProg
from tpulp.corpus import CASES

from test_torch_model import to_port

torch.set_num_threads(1)

# equality_heavy_256 runs on the card in chip_smoke.py
SMALL = [c for c in CASES if c.size_hint <= 96]
SMALL_IDS = [c.name for c in SMALL]


def _wyndor():
    lp = LinProg()
    lp.addVar("x")
    lp.addVar("y")
    lp.maximize(LinExpr(40, "x", 30, "y"))
    lp.addConstraint(LinExpr(1, "x", 1, "y").constraintLeq(12), name="p2")
    lp.addConstraint(LinExpr(2, "x", 1, "y").constraintLeq(16), name="p3")
    return lp


def _port_wyndor():
    return to_port(_wyndor())


@pytest.mark.parametrize("case", SMALL, ids=SMALL_IDS)
def test_corpus_matches_tpulp(case):
    lp = case.lp()
    ref = tpulp_solve.solve_lp(lp.lower(), max_iters=case.max_iters)
    out = tpulp_torch.solve_lp(to_port(lp).lower(), max_iters=case.max_iters,
                               device="cpu")
    assert out.status == ref.status == case.status
    assert out.objective == ref.objective
    if case.status == "optimal":
        assert out.objective == case.objective
        assert isinstance(out.objective, Fraction)
    # the precision-ladder rung that answered, recorded beside tpulp's
    assert out.rung == ref.rung, (out.rung, ref.rung)


@pytest.mark.parametrize("case", SMALL, ids=SMALL_IDS)
def test_corpus_on_kernel_engine(case):
    out = tpulp_torch.solve_lp(to_port(case.lp()).lower(),
                               max_iters=case.max_iters, device="cpu",
                               driver="kernel")
    assert out.status == case.status
    if case.status == "optimal":
        assert out.objective == case.objective


def test_wyndor_duals_match_tpulp():
    lp = _wyndor()
    ref = tpulp_solve.solve_lp(lp, duals=True)
    out = tpulp_torch.solve_lp(to_port(lp), duals=True, device="cpu")
    assert out.objective == ref.objective == 400
    assert out.x == ref.x
    assert out.y == ref.y
    assert out.duals == ref.duals
    assert out.reduced_costs == ref.reduced_costs


@pytest.mark.parametrize("driver", ["rank1", "blocked", "kernel",
                                    "refreshed"])
def test_every_engine_solves_wyndor(driver):
    sol = tpulp_torch.solve_lp(_port_wyndor(), device="cpu", driver=driver)
    assert sol.status == "optimal" and sol.objective == 400
    assert sol.x == {"x": 4, "y": 8}


@pytest.mark.parametrize("option", [
    {"mesh": object()},
    {"simple_bounds": True},
    {"certificates": True},
    {"ranging": True},
], ids=["mesh", "simple_bounds", "certificates", "ranging"])
def test_options_not_ported_raise(option):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpulp_torch.solve_lp(_port_wyndor(), device="cpu", **option)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tpulp_torch.solve_lp(_port_wyndor())
    with pytest.raises(RuntimeError, match="cuda"):
        tpulp_torch.solve_lp(_port_wyndor(), device="cuda")


def test_ladder_escalates_numeric_to_refreshed_rung(monkeypatch):
    """A NUMERIC verdict of the first engine climbs to the refreshed f64
    rung, which answers exactly."""
    import tpulp_torch.solve.api as api
    from tpulp_torch.core import Status

    real = api.run_simplex

    def failing(state, opts=None):
        out = real(state, opts)
        if state.T.dtype == torch.float32:
            return out._replace(status=torch.tensor(Status.NUMERIC,
                                                    dtype=torch.int32))
        return out

    monkeypatch.setattr(api, "run_simplex", failing)
    sol = tpulp_torch.solve_lp(_port_wyndor(), device="cpu",
                               dtype=torch.float32)
    assert sol.status == "optimal" and sol.objective == 400
    assert sol.rung == "refreshed-float64"
