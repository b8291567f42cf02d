"""``python -m tpulp_torch`` against ``python -m tpulp``: the same JSON on
the same files for every subcommand (both run in this process through
their ``main``; the port with ``--torch-device cpu``), and the port's two
repairs of tpulp's CLI (ADVICE.md): ``--exact`` rejects the flags it
cannot honour, and ``rhs_ranging`` keeps indices and names apart."""

import contextlib
import io
import json

import pytest
import torch

import tpulp.__main__ as tpulp_cli
import tpulp_torch.__main__ as port_cli
from tpulp import LinExpr, LinProg
from tpulp.io import parse_grid
from tpulp.model.serialize import save_prog

torch.set_num_threads(1)
CPU = ["--torch-device", "cpu"]


def run(cli, argv):
    """(exit code, parsed JSON or raw text, stderr) of one CLI call."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    text = out.getvalue()
    try:
        text = json.loads(text)
    except ValueError:
        pass
    return rc, text, err.getvalue()


def _wyndor():
    lp = LinProg("wyndor")
    lp.addVar("x")
    lp.addVar("y")
    lp.maximize(LinExpr(3, "x", 5, "y"))
    lp.addConstraint(LinExpr(1, "x").constraintLeq(4), name="p1")
    lp.addConstraint(LinExpr(2, "y").constraintLeq(12), name="p2")
    lp.addConstraint(LinExpr(3, "x", 2, "y").constraintLeq(18), name="p3")
    return lp


def _infeasible():
    lp = LinProg()
    lp.addVar("x")
    lp.minimize(LinExpr(1, "x"))
    lp.addConstraint(LinExpr(1, "x").constraintGeq(3), name="hi")
    lp.addConstraint(LinExpr(1, "x").constraintLeq(1), name="lo")
    lp.addConstraint(LinExpr(1, "x").constraintLeq(7))
    return lp


def _unbounded():
    lp = LinProg()
    lp.addVar("x")
    lp.addVar("y", ub=3)
    lp.maximize(LinExpr(1, "x", 1, "y"))
    lp.addConstraint(LinExpr(1, "x", -1, "y").constraintGeq(-2))
    return lp


def _milp():
    lp = LinProg()
    lp.addVar("a", integral=True, lb=0, ub=3)
    lp.addVar("b", integral=True, lb=0, ub=3)
    lp.maximize(LinExpr(5, "a", 4, "b"))
    lp.addConstraint(LinExpr(6, "a", 4, "b").constraintLeq(24))
    lp.addConstraint(LinExpr(1, "a", 2, "b").constraintLeq(6))
    return lp


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    paths = {}
    for name, make in (("wyndor", _wyndor), ("infeasible", _infeasible),
                       ("unbounded", _unbounded), ("milp", _milp)):
        paths[name] = str(d / f"{name}.json")
        save_prog(paths[name], make())
    tab = parse_grid(
        "x1 x2 s1 s2 | z\n-40 -30 0 0 | 0\n1 1 1 0 | 12\n2 1 0 1 | 16")
    paths["tableau"] = str(d / "tableau.json")
    tab.saveFile(paths["tableau"])
    paths["dir"] = d
    return paths


SOLVES = {
    "wyndor": ("wyndor", []),
    "wyndor_ranging": ("wyndor", ["--ranging"]),
    "wyndor_devex_unscaled": ("wyndor", ["--pricing", "devex",
                                         "--scale", "none"]),
    "wyndor_exact": ("wyndor", ["--exact"]),
    "wyndor_exact_presolve": ("wyndor", ["--exact", "--presolve"]),
    "infeasible_certificates_iis": ("infeasible", ["--certificates",
                                                   "--iis"]),
    "unbounded_certificates": ("unbounded", ["--certificates"]),
    "milp": ("milp", []),
    "milp_presolve": ("milp", ["--presolve"]),
}


@pytest.mark.parametrize("case", list(SOLVES))
def test_solve_json_equals_tpulps(files, case):
    name, flags = SOLVES[case]
    argv = ["solve", files[name], *flags]
    rc_j, ref, _ = run(tpulp_cli, argv)
    rc_p, out, _ = run(port_cli, argv + CPU)
    assert rc_j == rc_p == 0
    if "rhs_ranging" in ref:
        # the port keeps tpulp's index keys and moves the names to their
        # own object (below); merged, the two are tpulp's
        assert {**out.pop("rhs_ranging"),
                **out.pop("rhs_ranging_by_name")} == ref.pop("rhs_ranging")
    assert out == ref


def test_ranging_json_golden_values(files):
    _, out, _ = run(port_cli, ["solve", files["wyndor"], "--ranging", *CPU])
    assert out["objective"] == "36"
    assert out["cost_ranging"] == {"x": ["0", "15/2"], "y": ["2", None]}
    assert out["rhs_ranging_by_name"]["p2"] == ["6", "18"]
    assert out["rhs_ranging_by_name"]["p3"] == ["12", "24"]
    assert out["rhs_ranging"]["0"] == ["2", None]


def test_rhs_ranging_keeps_indices_and_names_apart(files):
    """ADVICE.md: a constraint named "0" must not overwrite constraint 0's
    interval. (tpulp emits both under ``str(key)`` in one object, so one
    entry overwrites the other.)"""
    lp = LinProg()
    lp.addVar("x")
    lp.addVar("y")
    lp.maximize(LinExpr(3, "x", 5, "y"))
    lp.addConstraint(LinExpr(1, "x").constraintLeq(4))
    lp.addConstraint(LinExpr(2, "y").constraintLeq(12), name="0")
    lp.addConstraint(LinExpr(3, "x", 2, "y").constraintLeq(18))
    path = str(files["dir"] / "named0.json")
    save_prog(path, lp)
    rc, out, _ = run(port_cli, ["solve", path, "--ranging", *CPU])
    assert rc == 0
    assert out["rhs_ranging"]["0"] == ["2", None]          # constraint 0
    assert out["rhs_ranging_by_name"]["0"] == ["6", "18"]  # the one named 0


@pytest.mark.parametrize("flag", ["--ranging", "--certificates", "--iis"])
def test_exact_rejects_flags_it_cannot_honour(files, flag):
    """ADVICE.md: the exact host path answers status and solution only, so
    ``--exact`` with these flags exits 2 with a message. (tpulp's
    ``--exact`` returns before reading them.)"""
    rc, out, err = run(port_cli, ["solve", files["wyndor"], "--exact", flag,
                                  *CPU])
    assert rc == 2 and out == ""
    assert "--exact" in err and flag in err


@pytest.mark.parametrize("flags", [[], ["--device"], ["--rule", "bland"]],
                         ids=["exact", "device", "bland"])
def test_solve_tableau_json_equals_tpulps(files, flags):
    argv = ["solve-tableau", files["tableau"], *flags]
    rc_j, ref, _ = run(tpulp_cli, argv)
    rc_p, out, _ = run(port_cli, argv + CPU)
    assert rc_j == rc_p == 0 and out == ref


@pytest.mark.parametrize("fmt", ["text", "latex", "csv", "grid"])
def test_render_equals_tpulps(files, fmt):
    argv = ["render", files["tableau"], "--format", fmt]
    assert run(port_cli, argv) == run(tpulp_cli, argv)


def test_save_and_warm_basis_round_trip(files):
    basis = str(files["dir"] / "basis.json")
    rc, cold, _ = run(port_cli, ["solve", files["wyndor"], "--save-basis",
                                 basis, *CPU])
    assert rc == 0
    rc, warm, _ = run(port_cli, ["solve", files["wyndor"], "--warm-basis",
                                 basis, *CPU])
    assert rc == 0 and warm["objective"] == cold["objective"]
    assert warm["iterations"] == 0
    rc, _, err = run(port_cli, ["solve", files["wyndor"], "--warm-basis",
                                basis, "--presolve", *CPU])
    assert rc == 2 and "presolve" in err


def test_spans_node_encoding_raises(files):
    """``--node-encoding spans`` (once a NotImplementedError here) gives
    tpulp's JSON; tpulp's span-encoded run on the same file is the
    reference."""
    argv = ["solve", files["milp"], "--node-encoding", "spans"]
    rc_j, ref, _ = run(tpulp_cli, argv)
    rc_p, out, _ = run(port_cli, argv + CPU)
    assert rc_j == rc_p == 0
    assert out == ref and out["status"] == "optimal"


def test_default_device_is_cuda(files):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        run(port_cli, ["solve", files["wyndor"]])
