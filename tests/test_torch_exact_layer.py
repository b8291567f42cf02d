"""The port's exact layer against tpulp's on the same programs: Farkas and
ray certificates (``solve_lp(certificates=True)``), sensitivity ranging
(plain and bounded), ``find_iis`` with the host and the device oracle, and
the port's guards against the reference defects that tpulp leaves open
(ADVICE.md: ranging on a basis the host rung shortened, a ray attached to
an infeasible system, ``host_max_m`` dropped with a custom oracle)."""

import ast
import pathlib
from fractions import Fraction as F

import numpy as np
import pytest
import torch

import tpulp.solve as tpulp_solve
import tpulp_torch
from tpulp import LinExpr, LinProg
from tpulp.corpus import get_case
from tpulp_torch.model.lower import materialize_simple_bounds
from tpulp_torch.solve import find_iis, verify_farkas, verify_ray

from test_torch_model import to_port

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _random_system(seed, objective=False):
    """tests/test_farkas.py's random system over free-sign rows: infeasible
    often; with ``objective`` a random cost, so some are unbounded."""
    rng = np.random.default_rng(seed)
    nv = int(rng.integers(2, 5))
    lp = LinProg(f"fk{seed}")
    for j in range(nv):
        lp.addVar(f"v{j}")
    obj = LinExpr()
    if objective:
        for j in range(nv):
            obj += LinExpr(F(int(rng.integers(-6, 7))), f"v{j}")
    lp.minimize(obj)
    for _ in range(int(rng.integers(3, 8))):
        e = LinExpr()
        nz = 0
        for j in range(nv):
            cc = int(rng.integers(-4, 5))
            if cc:
                e += LinExpr(F(cc), f"v{j}")
                nz += 1
        if not nz:
            continue
        comp = ["constraintLeq", "constraintGeq",
                "constraintEq"][int(rng.integers(0, 3))]
        lp.addConstraint(getattr(e, comp)(F(int(rng.integers(-10, 11)))))
    return lp


def _infeasible_box():
    lp = LinProg()
    lp.addVar("x", lb=0, ub=5)
    lp.addVar("y", lb=0, ub=2)
    lp.minimize(LinExpr(1, "x"))
    lp.addConstraint(LinExpr(1, "x", 1, "y").constraintGeq(9))
    return lp


CERT_PROGRAMS = {
    "infeasible_gap": get_case("infeasible_gap").lp,
    "unbounded_ray": get_case("unbounded_ray").lp,
    "hidden_ray_24": get_case("hidden_ray_24").lp,
    **{f"random{s}": (lambda s=s: _random_system(4200 + s)) for s in range(8)},
    **{f"random_obj{s}": (lambda s=s: _random_system(5300 + s, True))
       for s in range(8)},
}


@pytest.mark.parametrize("name", list(CERT_PROGRAMS))
def test_certificates_match_tpulp(name):
    lp = CERT_PROGRAMS[name]()
    ref = tpulp_solve.solve_lp(lp, certificates=True)
    out = tpulp_torch.solve_lp(to_port(lp), certificates=True, device="cpu")
    assert out.status == ref.status
    assert out.farkas == ref.farkas and out.ray == ref.ray
    sf = to_port(lp).lower()
    if out.status == "infeasible" and not sf.trivially_infeasible:
        assert verify_farkas(sf, out.farkas)
    if out.status == "unbounded":
        assert verify_ray(sf, out.ray)
    if out.status == "optimal":
        assert out.objective == ref.objective


def test_bounded_certificate_over_materialized_rows():
    lp = _infeasible_box()
    ref = tpulp_solve.solve_lp(lp, certificates=True, simple_bounds=True)
    out = tpulp_torch.solve_lp(to_port(lp), certificates=True,
                               simple_bounds=True, device="cpu")
    assert out.status == ref.status == "infeasible"
    assert out.farkas == ref.farkas
    sff = materialize_simple_bounds(to_port(lp).lower(simple_bounds=True))
    assert verify_farkas(sff, out.farkas)


def test_no_certificate_without_the_flag():
    out = tpulp_torch.solve_lp(to_port(_infeasible_box()), device="cpu")
    assert out.status == "infeasible"
    assert out.farkas is None and out.ray is None


def test_ray_needs_a_feasible_system(monkeypatch):
    """ADVICE.md: a ray proves unboundedness only of a feasible system. A
    false 'unbounded' verdict on an infeasible system that has an
    improving ray gets the exact host answer here, not the ray. (tpulp
    attaches the ray: the verdict's re-confirmation past m = 192 is float
    only, so such a verdict can reach that code.)"""
    import tpulp_torch.solve.api as api

    lp = LinProg()
    lp.addVar("x")
    lp.addVar("z")
    lp.minimize(LinExpr(-1, "z"))
    lp.addConstraint(LinExpr(1, "x").constraintGeq(1))
    lp.addConstraint(LinExpr(1, "x").constraintLeq(0))
    sf = to_port(lp).lower()
    assert tpulp_torch.ray_certificate(sf) is not None
    assert tpulp_torch.farkas_certificate(sf) is not None
    monkeypatch.setattr(api, "solve_standard_form",
                        lambda *a, **k: api.Solution(status="unbounded"))
    out = tpulp_torch.solve_lp(to_port(lp), certificates=True, device="cpu")
    assert out.status == "infeasible" and out.ray is None
    assert out.rung == "host-exact" and verify_farkas(sf, out.farkas)


def _wyndor():
    lp = LinProg("wyndor")
    lp.addVar("x")
    lp.addVar("y")
    lp.maximize(LinExpr(3, "x", 5, "y"))
    lp.addConstraint(LinExpr(1, "x").constraintLeq(4), name="p1")
    lp.addConstraint(LinExpr(2, "y").constraintLeq(12), name="p2")
    lp.addConstraint(LinExpr(3, "x", 2, "y").constraintLeq(18), name="p3")
    return lp


def test_wyndor_ranging_pins():
    sol = tpulp_torch.solve_lp(to_port(_wyndor()), ranging=True,
                               device="cpu")
    assert sol.objective == 36
    assert sol.cost_ranging == {"x": (0, F(15, 2)), "y": (2, None)}
    assert sol.rhs_ranging["p2"] == (6, 18)
    assert sol.rhs_ranging["p3"] == (12, 24)
    assert sol.rhs_ranging["p1"] == sol.rhs_ranging[0] == (2, None)


def _box():
    lp = LinProg()
    lp.addVar("x", lb=0, ub=4)
    lp.addVar("y", lb=0, ub=3)
    lp.addVar("z", lb=1, ub=6)
    lp.maximize(LinExpr(3, "x", 2, "y", -1, "z"))
    lp.addConstraint(LinExpr(1, "x", 1, "y", 1, "z").constraintLeq(7),
                     name="cap")
    lp.addConstraint(LinExpr(1, "x", -1, "y").constraintGeq(-1))
    return lp


RANGING = {
    "wyndor": (_wyndor, {}),
    "wyndor_float64": (_wyndor, {"refine": "none"}),
    "free_vars": (get_case("free_vars").lp, {}),
    "transport_degenerate": (get_case("transport_degenerate").lp, {}),
    "equality_heavy_24": (get_case("equality_heavy_24").lp, {}),
    "netlib_afiro": (get_case("netlib_afiro").lp, {}),
    "box_rows": (_box, {}),
    "box_bounded": (_box, {"simple_bounds": True}),
    "bounded_box_bounded": (get_case("bounded_box").lp,
                            {"simple_bounds": True}),
    "standard_form": (lambda: get_case("textbook").lp().lower(), {}),
}


@pytest.mark.parametrize("name", list(RANGING))
def test_ranging_matches_tpulp(name):
    make, kw = RANGING[name]
    lp = make()
    ref = tpulp_solve.solve_lp(lp, ranging=True, **kw)
    out = tpulp_torch.solve_lp(to_port(lp), ranging=True, device="cpu", **kw)
    assert out.status == ref.status == "optimal"
    assert out.objective == ref.objective
    assert out.cost_ranging == ref.cost_ranging
    assert out.rhs_ranging == ref.rhs_ranging
    assert out.at_upper == ref.at_upper
    if kw.get("simple_bounds"):
        assert any(out.at_upper)


def test_bounded_ranging_from_the_host_rung_raises(monkeypatch):
    """A bounded solve answered by the exact host rung carries no at-upper
    flags: ranging raises, as tpulp's does."""
    import tpulp_torch.solve.api as api

    def numeric(bs, opts=None):
        return bs._replace(s=bs.s._replace(
            status=torch.tensor(5, dtype=torch.int32)))

    monkeypatch.setattr(api, "run_simplex_bounded", numeric)
    with pytest.raises(ValueError, match="at_upper"):
        tpulp_torch.solve_lp(to_port(_box()), ranging=True,
                             simple_bounds=True, device="cpu")


def test_ranging_on_a_shortened_host_basis_raises(monkeypatch):
    """ADVICE.md: the exact host simplex drops linearly dependent rows, so
    its basis can be shorter than the form; ranging then raises a
    ValueError naming the cause. (tpulp indexes past the basis there and
    fails with an IndexError or a ZeroDivisionError.)"""
    import tpulp_torch.solve.api as api
    from tpulp_torch.core import Status

    def numeric(run):
        def wrapped(*args, **kw):
            out = run(*args, **kw)
            return out._replace(status=torch.tensor(
                Status.NUMERIC, dtype=torch.int32))
        return wrapped

    monkeypatch.setattr(api, "run_simplex", numeric(api.run_simplex))
    monkeypatch.setattr(api, "run_simplex_refreshed",
                        numeric(api.run_simplex_refreshed))
    # a transportation problem: its supply and demand rows are dependent
    lp = to_port(get_case("transport_degenerate").lp())
    sol = tpulp_torch.solve_lp(lp, device="cpu")
    assert sol.rung == "host-exact" and len(sol.basis) < lp.lower().m
    with pytest.raises(ValueError, match="linearly dependent rows"):
        tpulp_torch.solve_lp(lp, ranging=True, device="cpu")


def _conflict_with_noise():
    lp = LinProg()
    lp.addVar("x")
    lp.addVar("y")
    lp.minimize(LinExpr(1, "x"))
    lp.addConstraint(LinExpr(1, "x").constraintGeq(3), name="xhi")
    lp.addConstraint(LinExpr(1, "x").constraintLeq(1), name="xlo")
    lp.addConstraint(LinExpr(1, "y").constraintLeq(5))
    lp.addConstraint(LinExpr(1, "x", 1, "y").constraintLeq(99))
    return lp


def _cycle():
    lp = LinProg()
    for v in ("x", "y", "z"):
        lp.addVar(v, lb=None)
    lp.minimize(LinExpr())
    lp.addConstraint((LinExpr(1, "x") - LinExpr(1, "y")).constraintLeq(-1),
                     name="a")
    lp.addConstraint((LinExpr(1, "y") - LinExpr(1, "z")).constraintLeq(-1),
                     name="b")
    lp.addConstraint((LinExpr(1, "z") - LinExpr(1, "x")).constraintLeq(-1),
                     name="c")
    return lp


def _bound_conflict():
    lp = LinProg()
    lp.addVar("x", lb=0, ub=2)
    lp.minimize(LinExpr())
    lp.addConstraint(LinExpr(1, "x").constraintGeq(5), name="needs5")
    lp.addConstraint(LinExpr(1, "x").constraintLeq(8))
    return lp


IIS_PROGRAMS = {
    "conflict_with_noise": _conflict_with_noise,
    "cycle": _cycle,
    "bound_conflict": _bound_conflict,
    **{f"random{s}": (lambda s=s: _random_system(3100 + s))
       for s in (0, 1, 2, 3, 5, 7)},
}


@pytest.mark.parametrize("name", list(IIS_PROGRAMS))
def test_iis_matches_tpulp(name):
    lp = IIS_PROGRAMS[name]()
    ref = tpulp_solve.find_iis(lp)
    assert find_iis(to_port(lp)) == ref


@pytest.mark.parametrize("name", ["conflict_with_noise", "cycle",
                                  "random1"])
def test_iis_device_oracle_matches_tpulp(name):
    """``host_max_m=0``: every feasibility verdict comes from the device
    solve (the port's ``solve_lp`` on ``device=``)."""
    lp = IIS_PROGRAMS[name]()
    ref = tpulp_solve.find_iis(lp, host_max_m=0)
    assert find_iis(to_port(lp), host_max_m=0, device="cpu") == ref


def test_iis_feasible_program_raises():
    lp = LinProg()
    lp.addVar("x")
    lp.minimize(LinExpr(1, "x"))
    lp.addConstraint(LinExpr(1, "x").constraintLeq(9))
    with pytest.raises(ValueError, match="no IIS"):
        find_iis(to_port(lp))


def test_iis_host_max_m_with_a_custom_oracle_raises():
    """ADVICE.md: ``host_max_m`` belongs to the default oracle, so with a
    custom ``solve=`` it raises like any default-oracle keyword. (tpulp
    drops it without a word.)"""
    lp = to_port(_conflict_with_noise())

    def oracle(p):
        return tpulp_torch.solve_lp(p, device="cpu")

    assert sorted(find_iis(lp, solve=oracle)) == ["xhi", "xlo"]
    with pytest.raises(ValueError, match="default oracle only"):
        find_iis(lp, solve=oracle, host_max_m=5)


def _definitions(path):
    """Top-level statements of a module without docstrings, by name."""
    tree = ast.parse(path.read_text())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Expr) and isinstance(node.value,
                                                     ast.Constant):
            continue
        body = getattr(node, "body", None)
        if body and isinstance(body[0], ast.Expr) and isinstance(
                body[0].value, ast.Constant):
            node.body = body[1:]
        out[getattr(node, "name", ast.dump(node))] = ast.dump(node)
    return out


def test_iis_differs_from_tpulps_in_find_iis_only():
    """The port's ``solve/iis.py`` is tpulp's except for ``find_iis``,
    where the ``host_max_m`` guard above lives."""
    ref = _definitions(ROOT / "tpulp" / "solve" / "iis.py")
    out = _definitions(ROOT / "tpulp_torch" / "solve" / "iis.py")
    assert set(ref) == set(out)
    assert [k for k in ref if ref[k] != out[k]] == ["find_iis"]
