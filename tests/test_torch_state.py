"""tpulp_torch.core.state against tpulp.core.state: the same initial arrays,
the numpy carry-across, and the package's independence from jax."""

import pathlib
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulp.core import make_state as tpulp_make_state
from tpulp_torch.core import (SolverOptions, Status, eta_scaled_options,
                              from_numpy_state, make_state, to_numpy_state)

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _instance(kind, seed=0, m=6, n=9):
    """(c, A, b, hint): 'slack' starts in phase 2, 'mixed' needs
    artificials on half the rows."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n))
    b = np.abs(rng.normal(size=m))
    c = rng.normal(size=n)
    if kind == "slack":
        A = np.concatenate([A, np.eye(m)], axis=1)
        c = np.concatenate([c, np.zeros(m)])
        return c, A, b, list(range(n, n + m))
    A = np.concatenate([A, np.eye(m)[:, ::2]], axis=1)
    c = np.concatenate([c, np.zeros(len(range(0, m, 2)))])
    hint = [n + i // 2 if i % 2 == 0 else -1 for i in range(m)]
    return c, A, b, hint


@pytest.mark.parametrize("kind", ["slack", "mixed"])
@pytest.mark.parametrize("n_extra_art", [0, 3])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_make_state_matches_tpulp(kind, n_extra_art, dtype):
    c, A, b, hint = _instance(kind)
    ref = tpulp_make_state(c, A, b, hint, dtype=getattr(jnp, dtype),
                           n_extra_art=n_extra_art, _numpy=True)
    out = to_numpy_state(make_state(c, A, b, hint,
                                    dtype=getattr(torch, dtype),
                                    n_extra_art=n_extra_art, device="cpu"))
    for name, r, o in zip(ref._fields, ref, out):
        r, o = np.asarray(r), np.asarray(o)
        assert r.dtype == o.dtype, (name, r.dtype, o.dtype)
        assert r.shape == o.shape, (name, r.shape, o.shape)
        assert np.array_equal(r, o), name


def test_numpy_round_trip():
    c, A, b, hint = _instance("mixed", seed=3)
    s = make_state(c, A, b, hint, dtype=torch.float64, n_extra_art=1,
                   device="cpu")
    back = from_numpy_state(to_numpy_state(s), device="cpu")
    for name, x, y in zip(s._fields, s, back):
        assert x.dtype == y.dtype and torch.equal(x, y), name


def test_from_tpulp_device_state():
    """np.asarray of a tpulp SimplexState's jax leaves carries over."""
    c, A, b, hint = _instance("mixed", seed=5)
    js = tpulp_make_state(c, A, b, hint, dtype=jnp.float64)
    s = from_numpy_state([np.asarray(x) for x in js], device="cpu")
    assert s.T.dtype == torch.float64 and s.basis.dtype == torch.int32
    assert np.array_equal(s.T.numpy(), np.asarray(js.T))
    assert int(s.phase) == int(js.phase) == 1
    assert int(s.status) == Status.RUNNING
    assert float(s.last_z) == float("inf")


def test_options_mirror_tpulp():
    from tpulp.core.state import SolverOptions as TpulpOptions
    from tpulp.core.state import eta_scaled_options as tpulp_eta

    for dt in ("float32", "float64"):
        ours = SolverOptions.for_dtype(getattr(torch, dt), max_iters=77)
        ref = TpulpOptions.for_dtype(getattr(jnp, dt), max_iters=77)
        assert vars(ours) == vars(ref)
        assert (vars(eta_scaled_options(ours, getattr(torch, dt)))
                == vars(tpulp_eta(ref, getattr(jnp, dt))))


def test_no_jax_import_in_package_source():
    """Neither the port, its tools nor chip_smoke.py imports jax or
    anything of tpulp (the port carries its own copies of tpulp's
    pure-Python modules)."""
    pat = re.compile(r"^\s*(import|from) (jax|tpulp)(\.|\s|$)")
    sources = sorted((ROOT / "tpulp_torch").rglob("*.py")) + sorted(
        (ROOT / "tools").glob("torch_*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [
        f"{p.relative_to(ROOT)}:{i}"
        for p in sources
        for i, line in enumerate(p.read_text().splitlines(), 1)
        if pat.match(line)]
    assert offenders == []


WYNDOR = """
import sys
before = "jax" in sys.modules
import tpulp_torch
import tpulp_torch.batch
import tpulp_torch.milp
from tpulp_torch import LinExpr, LinProg, solve_lp
lp = LinProg()
lp.addVar("x")
lp.addVar("y")
lp.maximize(LinExpr(40, "x", 30, "y"))
lp.addConstraint(LinExpr(1, "x", 1, "y").constraintLeq(12))
lp.addConstraint(LinExpr(2, "x", 1, "y").constraintLeq(16))
sol = solve_lp(lp, device="cpu")
assert sol.status == "optimal" and sol.objective == 400, sol
k = LinProg()
k.addVar("a", integral=True, lb=0, ub=1)
k.addVar("b", integral=True, lb=0, ub=1)
k.maximize(LinExpr(3, "a", 2, "b"))
k.addConstraint(LinExpr(2, "a", 2, "b").constraintLeq(3))
sol = tpulp_torch.solve_milp(k, device="cpu")
assert sol.status == "optimal" and sol.objective == 3, sol
lps = []
for rhs in (12, 10, 8):
    p = LinProg()
    p.addVar("x")
    p.addVar("y")
    p.maximize(LinExpr(40, "x", 30, "y"))
    p.addConstraint(LinExpr(1, "x", 1, "y").constraintLeq(rhs))
    lps.append(p)
sols = tpulp_torch.solve_lp_batch(lps, device="cpu")
assert [s.objective for s in sols] == [480, 400, 320], sols
box = LinProg()
box.addVar("x", lb=0, ub=4)
box.addVar("y", lb=0, ub=3)
box.maximize(LinExpr(3, "x", 2, "y"))
box.addConstraint(LinExpr(1, "x", 1, "y").constraintLeq(5))
sol = solve_lp(box, simple_bounds=True, device="cpu")
assert sol.objective == 14 and sol.at_upper[0], sol
bad = LinProg()
bad.addVar("x")
bad.minimize(LinExpr(1, "x"))
bad.addConstraint(LinExpr(1, "x").constraintGeq(3))
bad.addConstraint(LinExpr(1, "x").constraintLeq(1))
sol = solve_lp(bad, certificates=True, device="cpu")
assert tpulp_torch.verify_farkas(bad.lower(), sol.farkas), sol
import contextlib, io, json, os, tempfile
from tpulp_torch.__main__ import main
from tpulp_torch.model.serialize import save_prog
path = os.path.join(tempfile.mkdtemp(), "bad.json")
save_prog(path, bad)
out = io.StringIO()
with contextlib.redirect_stdout(out):
    rc = main(["solve", path, "--certificates", "--iis",
               "--torch-device", "cpu"])
assert rc == 0 and len(json.loads(out.getvalue())["iis"]) == 2, out
import socket
import torch.distributed as dist
import tpulp_torch.comm, tpulp_torch.core.predicates, tpulp_torch.entry
import tpulp_torch.shard.analysis, tpulp_torch.utils
from tpulp_torch.shard import make_mesh
os.environ["GLOO_SOCKET_IFNAME"] = "lo"
with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
tpulp_torch.comm.init_distributed(f"127.0.0.1:{port}", 1, 0, device="cpu")
mesh = make_mesh(1, device="cpu")
for kw in ({}, {"shard_driver": "rank1"}):
    sol = solve_lp(lp, mesh=mesh, device="cpu", **kw)
    assert sol.objective == 400, sol
sol = solve_lp(box, mesh=mesh, simple_bounds=True, device="cpu")
assert sol.objective == 14, sol
tpulp_torch.shard.analysis.assert_fused_psum(mesh)
dist.destroy_process_group()
after = "jax" in sys.modules
tpulp_side = sorted(m for m in sys.modules
                    if m == "tpulp" or m.startswith("tpulp."))
print("JAX", before, after, tpulp_side)
sys.exit(1 if (after and not before) or tpulp_side else 0)
"""


def test_package_solves_without_importing_jax():
    """The port solves an LP, a batch, a MILP, a bounded LP, a certified
    infeasible LP, a CLI call and LPs over a one-process mesh (with the
    comm, shard, predicate, debug and entry modules loaded) without
    loading jax or any module of tpulp."""
    res = subprocess.run([sys.executable, "-c", WYNDOR], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert ("JAX False False []" in res.stdout
            or "JAX True True []" in res.stdout)
