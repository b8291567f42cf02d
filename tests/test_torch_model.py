"""The port's own modeling layer against tpulp's: its copied modules hold
tpulp's code statement for statement, the two lowerings give equal
StandardForms, and the JSON schema carries a program from one package to
the other.

``to_port`` and ``port_form`` are the bridges the other port tests use:
they build their programs once, with tpulp's classes, and hand the port a
copy made of its own classes."""

import ast
import dataclasses
import pathlib
from fractions import Fraction

import numpy as np
import pytest

import tpulp.model.serialize as jser
import tpulp_torch
import tpulp_torch.model.serialize as pser
from tpulp import LinExpr, LinProg
from tpulp.corpus import get_case
from tpulp.model import StandardForm as JStandardForm
from tpulp.model import lower_to_standard_form as j_lower
from tpulp.model.equilibrate import equilibration_powers_dense as j_powers
from tpulp.model.presolve import presolve as j_presolve
from tpulp_torch.model import StandardForm
from tpulp_torch.model import lower_to_standard_form as p_lower
from tpulp_torch.model.equilibrate import \
    equilibration_powers_dense as p_powers
from tpulp_torch.model.presolve import presolve as p_presolve

ROOT = pathlib.Path(__file__).resolve().parents[1]

# tpulp's pure-Python modules and the port's copies of them
COPIES = [f"model/{name}.py" for name in
          ("__init__", "expr", "con", "var", "prog", "lower", "equilibrate",
           "presolve", "serialize")] + [
    "tableau.py", "simplex.py", "corpus.py", "io/render.py", "io/mps.py"]


def to_port(obj):
    """tpulp's LinProg as the port's, through the JSON schema both read; a
    StandardForm by ``port_form``; a list item by item."""
    if isinstance(obj, (list, tuple)):
        return [to_port(x) for x in obj]
    if isinstance(obj, JStandardForm):
        return port_form(obj)
    return pser.prog_from_json(jser.prog_to_json(obj))


def port_form(sf):
    """tpulp's StandardForm as the port's (its fields are plain data)."""
    return StandardForm(**{f.name: getattr(sf, f.name)
                           for f in dataclasses.fields(sf)})


def _wyndor():
    lp = LinProg("wyndor")
    lp.addVar("x")
    lp.addVar("y")
    lp.maximize(LinExpr(40, "x", 30, "y"))
    lp.addConstraint(LinExpr(1, "x", 1, "y").constraintLeq(12), name="p2")
    lp.addConstraint(LinExpr(2, "x", 1, "y").constraintLeq(16), name="p3")
    return lp


def _bounded_milp():
    """Integers with finite bounds, a shifted lower bound, a free variable,
    an equality and a >= row."""
    lp = LinProg("bounded")
    lp.addVar("a", integral=True, lb=0, ub=3)
    lp.addVar("b", integral=True, lb=-2, ub=4)
    lp.addVar("c", lb=Fraction(1, 2), ub=7)
    lp.addVar("f", lb=None)
    lp.minimize(LinExpr(-3, "a", 2, "b", Fraction(-5, 3), "c", 1, "f"))
    lp.addConstraint(LinExpr(1, "a", 1, "b", 1, "c").constraintLeq(9))
    lp.addConstraint(LinExpr(2, "a", -1, "b", 1, "f").constraintEq(1))
    lp.addConstraint(LinExpr(1, "c", 1, "f").constraintGeq(Fraction(-3, 2)))
    return lp


PROGRAMS = {
    "wyndor": _wyndor,
    "bounded_milp": _bounded_milp,
    **{name: get_case(name).lp for name in
       ("textbook", "beale", "bounded_box", "free_vars", "equality_heavy_24",
        "infeasible_gap", "unbounded_ray", "netlib_afiro")},
}


def _code(path: pathlib.Path) -> str:
    """The module's syntax tree without its docstrings (and so without
    comments): what it runs."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                              ast.AsyncFunctionDef)) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("rel", COPIES)
def test_copied_module_is_tpulps(rel):
    """A change to one of these tpulp modules must be mirrored in the port:
    the two files hold the same code, statement for statement (docstrings
    and comments may differ)."""
    src = ROOT / "tpulp" / rel
    dst = ROOT / "tpulp_torch" / rel
    assert _code(dst) == _code(src), (
        f"tpulp_torch/{rel} differs from tpulp/{rel}: mirror the change")


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_json_bridge_round_trips(name):
    lp = PROGRAMS[name]()
    port = to_port(lp)
    assert isinstance(port, tpulp_torch.LinProg)
    assert pser.prog_to_json(port) == jser.prog_to_json(lp)
    back = jser.prog_from_json(pser.prog_to_json(port))
    assert jser.prog_to_json(back) == jser.prog_to_json(lp)


@pytest.mark.parametrize("kw", [{}, {"integer_bound_rows": True},
                                {"simple_bounds": True}],
                         ids=["plain", "int_bound_rows", "simple_bounds"])
@pytest.mark.parametrize("name", list(PROGRAMS))
def test_lowering_equals_tpulps(name, kw):
    lp = PROGRAMS[name]()
    ref = j_lower(lp, **kw)
    out = p_lower(to_port(lp), **kw)
    assert isinstance(out, StandardForm)
    for f in dataclasses.fields(ref):
        assert getattr(out, f.name) == getattr(ref, f.name), f.name
    assert dataclasses.asdict(port_form(ref)) == dataclasses.asdict(out)


@pytest.mark.parametrize("name", ["equality_heavy_24", "bounded_milp"])
def test_equilibration_and_presolve_equal_tpulps(name):
    lp = PROGRAMS[name]()
    sf = j_lower(lp)
    _, A, _ = sf.to_dense(np.float64)
    rp, cp = j_powers(A, basis_hint=sf.basis_hint)
    rq, cq = p_powers(port_form(sf).to_dense(np.float64)[1],
                      basis_hint=sf.basis_hint)
    assert list(rp) == list(rq) and list(cp) == list(cq)
    ref, out = j_presolve(lp), p_presolve(to_port(lp))
    assert out.status == ref.status
    assert (pser.prog_to_json(out.prog) == jser.prog_to_json(ref.prog))


CORPUS_NAMES = [name for name in __import__("tpulp.corpus").corpus.case_names()
                if name != "equality_heavy_256"]


@pytest.mark.parametrize("name", CORPUS_NAMES)
def test_corpus_case_lowers_as_tpulps(name):
    """Each case of the port's own corpus (the MPS files read by its copy
    of tpulp's reader included) lowers to tpulp's StandardForm."""
    from tpulp_torch.corpus import get_case as p_case

    ref = j_lower(get_case(name).lp())
    out = p_case(name).lp().lower()
    assert isinstance(out, StandardForm)
    assert dataclasses.asdict(out) == dataclasses.asdict(port_form(ref))


def test_corpus_is_tpulps():
    from tpulp.corpus import CASES as JCASES
    from tpulp_torch.corpus import CASES as PCASES

    assert [(c.name, c.objective, c.status) for c in PCASES] == \
        [(c.name, c.objective, c.status) for c in JCASES]
    case = [c for c in PCASES if c.name == "textbook"][0]
    assert isinstance(case.lp(), tpulp_torch.LinProg)


def test_host_simplex_solves_wyndor():
    from tpulp_torch.solve.api import solve_standard_form_host

    sol = solve_standard_form_host(to_port(_wyndor()).lower())
    assert sol.status == "optimal" and sol.objective == 400
