"""tpulp_torch's column-sharded drivers against tpulp's, on the CPU.

The port's drivers run multi-controller: one process per shard over gloo.
A module fixture starts the ranks once for P = 2 and once for P = 4 (each
``torch.set_num_threads(1)``, the P = 4 ranks as 2 hosts x 2 columns
through ``LOCAL_WORLD_SIZE=2``); P = 1 runs in this process. Every case
runs inside one group and comes back as JSON from every rank, where the
replicated results must agree. tpulp runs the same case at the same P on
the conftest's fake CPU devices (``make_mesh(p)``; the tuple-axis cases on
a 2 x 2 ``(hosts, cols)`` mesh). At f64 the status, ``niter``, basis and
at-upper flags must be equal, and the objective within 1e-12 relative
(5e-11 for the blocked driver, whose eta products sum in the BLAS's
order); ``solve_lp(mesh=...)``'s exact objective must equal tpulp's.

Run as a script, this module is one rank of such a group:
``python tests/test_torch_shard.py RANK WORLD PORT TASKS OUT``. Its
top-level imports are torch-only for that reason; tpulp and jax are
imported inside the functions that hold the port against them.
"""

from __future__ import annotations

import hashlib
import json
import os
import socket
import subprocess
import sys
from fractions import Fraction

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
if REPO not in sys.path:
    sys.path.insert(0, REPO)

torch.set_num_threads(1)

WORKER_TIMEOUT = 300
TOL = 1e-12
# the blocked driver's objective comes out of K-term eta products whose
# summation order is the BLAS's: the largest gap to tpulp's at the same P
# over the blocked cases is 1.42e-11 relative (Dantzig, K = 8, seed 3, at
# P = 1; 1.31e-11 at P = 2, 8.8e-12 at P = 4), every other one below 1e-13
BLOCKED_TOL = 5e-11


# ---------------------------------------------------------------------------
# the instances (numpy, seeded), as plain lists for JSON
# ---------------------------------------------------------------------------

def random_dense(seed, m=24, n=48):
    """tests/test_shard.py's random canonical LP (slack basis)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n))
    x0 = np.abs(rng.normal(size=n))
    b = A @ x0 + np.abs(rng.normal(size=m))
    c = rng.normal(size=n)
    return {"c": np.concatenate([c, np.zeros(m)]).tolist(),
            "A": np.concatenate([A, np.eye(m)], axis=1).tolist(),
            "b": b.tolist(), "hint": list(range(n, n + m))}


def bounded_polytope(seed, m=24, n=48):
    """tests/test_shard.py's hybrid-mesh instance (a sum row: optimal)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n))
    x0 = np.abs(rng.normal(size=n))
    b = A @ x0 + np.abs(rng.normal(size=m))
    c = rng.normal(size=n)
    A[-1] = 1.0
    b[-1] = 2.0 * x0.sum()
    return {"c": np.concatenate([c, np.zeros(m)]).tolist(),
            "A": np.concatenate([A, np.eye(m)], axis=1).tolist(),
            "b": b.tolist(), "hint": list(range(n, n + m))}


def _lp(kind):
    """tests/test_shard.py's small LPs, as tpulp programs."""
    from tpulp import LinExpr, LinProg

    lp = LinProg()
    if kind == "textbook":
        lp.addVar("x1")
        lp.addVar("x2")
        lp.maximize(LinExpr(40, "x1", 30, "x2"))
        lp.addConstraint(LinExpr(1, "x1", 1, "x2").constraintLeq(12))
        lp.addConstraint(LinExpr(2, "x1", 1, "x2").constraintLeq(16))
    elif kind == "phase1":
        lp.addVar("x")
        lp.addVar("y")
        lp.minimize(LinExpr(2, "x", 3, "y"))
        lp.addConstraint(LinExpr(1, "x", 1, "y").constraintGeq(4))
        lp.addConstraint(LinExpr(1, "x", -1, "y").constraintEq(0))
    elif kind == "infeasible":
        lp.addVar("x")
        lp.minimize(LinExpr(1, "x"))
        lp.addConstraint(LinExpr(1, "x").constraintLeq(1))
        lp.addConstraint(LinExpr(1, "x").constraintGeq(3))
    elif kind == "unbounded":
        lp.addVar("x")
        lp.minimize(LinExpr(-1, "x"))
        lp.addConstraint(LinExpr(1, "x").constraintGeq(1))
    elif kind == "box":
        lp.addVar("x", lb=0, ub=4)
        lp.addVar("y", lb=0, ub=3)
        lp.maximize(LinExpr(3, "x", 2, "y"))
        lp.addConstraint(LinExpr(1, "x", 1, "y").constraintLeq(5))
    elif kind == "flip":
        lp.addVar("x", lb=0, ub=2)
        lp.maximize(LinExpr(1, "x"))
        lp.addConstraint(LinExpr(1, "x").constraintLeq(10))
    elif kind == "box_infeasible":
        lp.addVar("x", lb=0, ub=5)
        lp.minimize(LinExpr(1, "x"))
        lp.addConstraint(LinExpr(1, "x").constraintGeq(9))
    elif kind == "box_unbounded":
        lp.addVar("x", lb=0, ub=5)
        lp.addVar("free", lb=0)
        lp.maximize(LinExpr(1, "x", 1, "free"))
        lp.addConstraint(LinExpr(1, "x").constraintLeq(4))
    elif kind.startswith("box_seed"):
        from tpulp import LinExpr as E

        rng = np.random.default_rng(int(kind[len("box_seed"):]))
        obj = E()
        for jv in range(6):
            lp.addVar(f"v{jv}", lb=0, ub=int(rng.integers(1, 9)))
            obj += E(int(rng.integers(-9, 10)), f"v{jv}")
        lp.maximize(obj)
        for _ in range(4):
            e = E()
            for jv in range(6):
                e += E(int(rng.integers(-3, 6)), f"v{jv}")
            lp.addConstraint(e.constraintLeq(int(rng.integers(5, 30))))
    elif kind == "equality_heavy_24":
        from tpulp.corpus import get_case

        return get_case("equality_heavy_24").lp()
    else:
        raise ValueError(kind)
    return lp


def lowered(kind, simple_bounds=False):
    """The dense lowering of one of ``_lp``'s programs."""
    sf = _lp(kind).lower(simple_bounds=simple_bounds)
    c, A, b = sf.to_dense(np.float64)
    out = {"c": c.tolist(), "A": A.tolist(), "b": b.tolist(),
           "hint": list(sf.basis_hint)}
    if simple_bounds:
        out["upper"] = [None if u is None else float(u) for u in sf.upper]
    return out


# ---------------------------------------------------------------------------
# one rank's side (torch only)
# ---------------------------------------------------------------------------

def _port_opts(task):
    import dataclasses

    from tpulp_torch.core import SolverOptions

    opts = SolverOptions.for_dtype(torch.float64)
    return dataclasses.replace(opts, **task.get("opts", {}))


def _port_state(lp, nan=None):
    from tpulp_torch.core import make_state

    st = make_state(lp["c"], lp["A"], lp["b"], lp["hint"],
                    dtype=torch.float64, device="cpu")
    if nan is not None:
        T = st.T.clone()
        T[(0, 0) if nan == "T" else (4, -1)] = float("nan")
        st = st._replace(T=T)
    return st


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()[:16]


def _summary(st, at_upper=None):
    out = {"status": int(st.status), "niter": int(st.niter),
           "basis": [int(v) for v in st.basis.tolist()],
           "z": float(-st.T[0, -1]).hex(), "T": _digest(st.T)}
    if at_upper is not None:
        out["at_upper"] = [bool(v) for v in at_upper.tolist()]
    return out


def run_task(task, meshes):
    """One case on this rank; ``meshes`` maps "cols" to the 1-D mesh and
    "hybrid" to the (hosts, cols) mesh where there is one."""
    from tpulp_torch.shard import (from_sharded_bounded_state,
                                   from_sharded_state, run_simplex_sharded,
                                   run_simplex_sharded_blocked,
                                   run_simplex_sharded_bounded,
                                   to_sharded_bounded_state,
                                   to_sharded_state)
    from tpulp_torch.solve.bounded import make_bounded_state

    kind = task["kind"]
    axis = tuple(task["axis"]) if task.get("axis") else "cols"
    mesh = meshes["hybrid" if isinstance(axis, tuple) else "cols"]
    if kind in ("rank1", "blocked"):
        st = _port_state(task["lp"], task.get("nan"))
        sh = to_sharded_state(st, mesh, axis=axis)
        if kind == "rank1":
            out = run_simplex_sharded(sh, mesh, _port_opts(task), axis=axis)
        else:
            out = run_simplex_sharded_blocked(sh, mesh, _port_opts(task),
                                              block=task["block"], axis=axis)
        return _summary(from_sharded_state(out, st.n, mesh, axis))
    if kind == "bounded":
        st = _port_state(task["lp"])
        sb = to_sharded_bounded_state(
            make_bounded_state(st, task["lp"]["upper"]), mesh, axis=axis)
        out = from_sharded_bounded_state(
            run_simplex_sharded_bounded(sb, mesh, _port_opts(task),
                                        axis=axis), st.n, mesh, axis)
        return _summary(out.s, out.at_upper)
    if kind == "idle":
        return _idle_step(task, mesh)
    if kind == "solve_lp":
        from tpulp_torch.model.serialize import prog_from_json
        from tpulp_torch.solve import solve_lp

        sol = solve_lp(prog_from_json(task["prog"]), mesh=mesh,
                       device="cpu", **task["kw"])
        return {"status": sol.status, "objective": str(sol.objective),
                "rung": sol.rung, "niter": sol.niter, "basis": sol.basis,
                "at_upper": sol.at_upper}
    if kind in HANDLERS:
        return HANDLERS[kind](task, meshes)
    raise ValueError(f"unknown task kind {kind!r}")


def _idle_step(task, mesh):
    """A rank-1 walk to its end, then one more step: the idle step must
    leave the block and the RHS bit for bit."""
    from tpulp_torch.comm.collectives import MeshAxis
    from tpulp_torch.shard import run_simplex_sharded, to_sharded_state
    from tpulp_torch.shard.sharded import _sharded_step

    st = _port_state(task["lp"])
    lay = MeshAxis(mesh)
    opts = _port_opts(task)
    out = run_simplex_sharded(to_sharded_state(st, mesh), mesh, opts)
    n_global = out.T.shape[1] * lay.size
    nxt = _sharded_step(out, opts, 10, n_global, lay)
    return {"status": int(out.status), "niter": int(nxt.niter),
            "same": bool(torch.equal(nxt.T, out.T)
                         and torch.equal(nxt.rhs, out.rhs)
                         and torch.equal(nxt.basis, out.basis))}


# handlers of the comm module's tasks (tests/test_torch_comm.py)
HANDLERS = {}


def run_group(tasks, rank, world, meshes):
    results = {}
    for task in tasks:
        results[task["id"]] = run_task(task, meshes)
    return results


def worker_main(argv) -> int:
    """One rank: ``RANK WORLD PORT TASKS OUT``; writes OUT.RANK."""
    rank, world, port, tasks_path, out_path = argv
    rank, world = int(rank), int(world)
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    import torch.distributed as dist

    from tpulp_torch.comm import global_device_mesh, init_distributed
    from tpulp_torch.shard import make_mesh

    with open(tasks_path) as f:
        spec = json.load(f)
    if spec.get("handlers"):
        import importlib

        HANDLERS.update(importlib.import_module(spec["handlers"]).HANDLERS)
    init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    meshes = {"cols": make_mesh(world, device="cpu")}
    if os.environ.get("LOCAL_WORLD_SIZE"):
        meshes["hybrid"] = global_device_mesh(device="cpu")
    try:
        results = run_group(spec["tasks"], rank, world, meshes)
    finally:
        dist.destroy_process_group()
    with open(f"{out_path}.{rank}", "w") as f:
        json.dump(results, f)
    return 0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_group(tasks, world, tmpdir, handlers=None, local_world=None):
    """Start ``world`` ranks of this script on ``tasks``; returns a
    function that waits for them and returns every rank's results."""
    tasks_path = os.path.join(tmpdir, f"tasks{world}.json")
    out_path = os.path.join(tmpdir, f"out{world}")
    with open(tasks_path, "w") as f:
        json.dump({"tasks": tasks, "handlers": handlers}, f)
    port = free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS", "MASTER_ADDR",
                        "WORLD_SIZE", "RANK", "LOCAL_WORLD_SIZE")}
    env.update(OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo",
               PYTHONPATH=os.pathsep.join([HERE, REPO]))
    if local_world:
        env["LOCAL_WORLD_SIZE"] = str(local_world)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world),
         str(port), tasks_path, out_path],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=REPO) for r in range(world)]

    def wait():
        logs = []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=WORKER_TIMEOUT)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
            logs.append(out)
        failed = [_rank_failure(r, world, p.returncode, log, out_path)
                  for r, (p, log) in enumerate(zip(procs, logs))
                  if p.returncode != 0]
        assert not failed, "\n".join(failed)
        res = []
        for r in range(world):
            with open(f"{out_path}.{r}") as f:
                res.append(json.load(f))
        return res

    return wait


def _rank_failure(rank, world, code, log, out_path) -> str:
    """A failed rank's report: its exit code (the signal that ended it,
    where one did), whether it wrote its results, the end of its log."""
    how = f"exit code {code}"
    if code < 0:
        import signal

        how = f"killed by {signal.Signals(-code).name}"
    wrote = os.path.exists(f"{out_path}.{rank}")
    return (f"rank {rank} of {world}: {how}, results "
            f"{'written' if wrote else 'not written'}:\n{log[-4000:]}")


class InProcessGroup:
    """A one-process gloo group in this process, for the P = 1 cases."""

    def __enter__(self):
        import torch.distributed as dist

        from tpulp_torch.comm import init_distributed
        from tpulp_torch.shard import make_mesh

        assert not dist.is_initialized()
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        init_distributed(f"127.0.0.1:{free_port()}", 1, 0, device="cpu")
        self.meshes = {"cols": make_mesh(1, device="cpu")}
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.destroy_process_group()


def replicated(results, key):
    """The one result of ``key`` that every rank reported alike."""
    first = results[0][key]
    for r, res in enumerate(results[1:], 1):
        assert res[key] == first, f"rank {r} differs on {key}: " \
            f"{res[key]} vs {first}"
    return first


# ---------------------------------------------------------------------------
# the cases, tpulp's side
# ---------------------------------------------------------------------------

STATUS_LPS = ["textbook", "phase1", "infeasible", "unbounded"]
SEEDS = [1, 2, 3]
BOX_CASES = ["box_seed1", "box_seed2", "box_seed3", "box_seed4", "box",
             "flip"]
DEVEX = 3


def _cases():
    """{P: [task]}: every case of the module, by shard count."""
    cases = {1: [], 2: [], 4: []}
    for p in (1, 2, 4):
        for seed in SEEDS:
            cases[p].append({"id": f"rank1-{seed}", "kind": "rank1",
                             "lp": random_dense(seed)})
            for rule in ("dantzig", "devex"):
                for K in (8, 32):
                    cases[p].append({
                        "id": f"blocked-{rule}-{K}-{seed}", "kind": "blocked",
                        "lp": random_dense(seed), "block": K,
                        "opts": {"rule": DEVEX} if rule == "devex" else {}})
        for box in BOX_CASES:
            cases[p].append({"id": f"bounded-{box}", "kind": "bounded",
                             "lp": lowered(box, simple_bounds=True)})
    for lp in STATUS_LPS:
        cases[2].append({"id": f"status-rank1-{lp}", "kind": "rank1",
                         "lp": lowered(lp)})
        cases[2].append({"id": f"status-blocked-{lp}", "kind": "blocked",
                         "lp": lowered(lp), "block": 8})
    for where, seed in (("T", 5), ("rhs", 6)):
        for drv in ("rank1", "blocked"):
            cases[2].append({"id": f"numeric-{drv}-{where}", "kind": drv,
                             "lp": random_dense(seed), "nan": where,
                             "block": 8, "opts": {"max_iters": 50}})
    for p in (1, 2):
        cases[p].append({"id": "idle", "kind": "idle",
                         "lp": bounded_polytope(1)})
    for drv in ("rank1", "blocked"):
        cases[4].append({"id": f"hybrid-{drv}", "kind": drv,
                         "lp": bounded_polytope(2), "block": 8,
                         "axis": ["hosts", "cols"]})
    for p in (1, 2):
        for name, lp, kw in SOLVE_LP_CASES:
            cases[p].append({"id": f"solve_lp-{name}", "kind": "solve_lp",
                             "prog": _prog_json(lp), "kw": kw})
    return cases


SOLVE_LP_CASES = [
    ("textbook-blocked", "textbook", {}),
    ("textbook-rank1", "textbook", {"shard_driver": "rank1"}),
    ("phase1-blocked", "phase1", {"shard_block": 8}),
    ("devex", "equality_heavy_24", {"pricing": "devex"}),
    ("box", "box", {"simple_bounds": True}),
    ("box-infeasible", "box_infeasible", {"simple_bounds": True}),
    ("box-unbounded", "box_unbounded", {"simple_bounds": True}),
]


def _prog_json(kind):
    from tpulp.model.serialize import prog_to_json

    return prog_to_json(_lp(kind))


def _tpulp_mesh(p, axis):
    import jax
    from jax.sharding import Mesh

    from tpulp.shard import make_mesh

    if isinstance(axis, tuple):
        return Mesh(np.array(jax.devices()[:p]).reshape(2, p // 2),
                    ("hosts", "cols"))
    return make_mesh(p)


def tpulp_result(task, p):
    """The same case through tpulp's sharded driver at the same P."""
    import dataclasses

    import jax.numpy as jnp

    from tpulp.core import SolverOptions, make_state
    from tpulp.shard import (from_sharded_bounded_state, from_sharded_state,
                             run_simplex_sharded, run_simplex_sharded_blocked,
                             run_simplex_sharded_bounded,
                             to_sharded_bounded_state, to_sharded_state)
    from tpulp.solve.bounded import make_bounded_state

    kind = task["kind"]
    axis = tuple(task["axis"]) if task.get("axis") else "cols"
    mesh = _tpulp_mesh(p, axis)
    if kind == "solve_lp":
        from tpulp.model.serialize import prog_from_json
        from tpulp.solve import solve_lp

        sol = solve_lp(prog_from_json(task["prog"]), mesh=mesh, **task["kw"])
        return {"status": sol.status, "objective": str(sol.objective),
                "basis": sol.basis, "at_upper": sol.at_upper}
    lp = task["lp"]
    opts = dataclasses.replace(SolverOptions.for_dtype(jnp.float64),
                               **task.get("opts", {}))
    st = make_state(lp["c"], lp["A"], lp["b"], lp["hint"], dtype=jnp.float64)
    if task.get("nan") == "T":
        st = st._replace(T=st.T.at[0, 0].set(jnp.nan))
    elif task.get("nan") == "rhs":
        st = st._replace(T=st.T.at[4, -1].set(jnp.nan))
    if kind == "idle":
        return None
    if kind == "bounded":
        sb = to_sharded_bounded_state(make_bounded_state(st, lp["upper"]),
                                      mesh, axis=axis)
        out = from_sharded_bounded_state(
            run_simplex_sharded_bounded(sb, mesh, opts, axis=axis), st.n)
        s, at_upper = out.s, [bool(v) for v in np.asarray(out.at_upper)]
    else:
        sh = to_sharded_state(st, mesh, axis=axis)
        if kind == "rank1":
            osh = run_simplex_sharded(sh, mesh, opts, axis=axis)
        else:
            osh = run_simplex_sharded_blocked(sh, mesh, opts,
                                              block=task["block"], axis=axis)
        s, at_upper = from_sharded_state(osh, st.n), None
    out = {"status": int(s.status), "niter": int(s.niter),
           "basis": [int(v) for v in np.asarray(s.basis)],
           "z": float(-np.asarray(s.T)[0, -1])}
    if at_upper is not None:
        out["at_upper"] = at_upper
    return out


# ---------------------------------------------------------------------------
# the fixture: every case at every P, once per module
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{(P, case id): (the port's per-rank results, tpulp's result)}."""
    tmp = str(tmp_path_factory.mktemp("shard"))
    cases = _cases()
    waits = {2: start_group(cases[2], 2, tmp),
             4: start_group(cases[4], 4, tmp, local_world=2)}
    out = {}
    with InProcessGroup() as g:
        for task in cases[1]:
            out[(1, task["id"])] = [run_task(task, g.meshes)]
    for p in (1, 2, 4):
        for task in cases[p]:
            ref = tpulp_result(task, p)
            out[(p, task["id"])] = (out.get((p, task["id"])), ref)
    for p in (2, 4):
        per_rank = waits[p]()
        for task in cases[p]:
            out[(p, task["id"])] = ([r[task["id"]] for r in per_rank],
                                    out[(p, task["id"])][1])
    return out


def _held(runs, p, case, tol=TOL):
    ports, ref = runs[(p, case)]
    port = {k: replicated(ports, k) for k in ports[0]}
    assert port["status"] == ref["status"], (port, ref)
    assert port["niter"] == ref["niter"], (port, ref)
    assert port["basis"] == ref["basis"], (port, ref)
    if "at_upper" in ref:
        assert port["at_upper"] == ref["at_upper"]
    z = float.fromhex(port["z"])
    if np.isfinite(ref["z"]) or np.isfinite(z):
        assert abs(z - ref["z"]) <= tol * max(1.0, abs(ref["z"])), (z, ref)
    return port


@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("seed", SEEDS)
def test_rank1_walks_tpulps(runs, p, seed):
    _held(runs, p, f"rank1-{seed}")


@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("rule", ["dantzig", "devex"])
@pytest.mark.parametrize("K", [8, 32])
@pytest.mark.parametrize("seed", SEEDS)
def test_blocked_walks_tpulps(runs, p, rule, K, seed):
    _held(runs, p, f"blocked-{rule}-{K}-{seed}", BLOCKED_TOL)


@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("case", BOX_CASES)
def test_bounded_walks_tpulps(runs, p, case):
    port = _held(runs, p, f"bounded-{case}")
    if case == "flip":
        # max x, x <= 2 by its span alone: one entering flip
        assert port["at_upper"][0] and port["status"] == 1
    if case == "box":
        assert float.fromhex(port["z"]) == -14.0


@pytest.mark.parametrize("driver", ["rank1", "blocked"])
@pytest.mark.parametrize("lp", STATUS_LPS)
def test_statuses(runs, driver, lp):
    port = _held(runs, 2, f"status-{driver}-{lp}",
                 BLOCKED_TOL if driver == "blocked" else TOL)
    want = {"textbook": 1, "phase1": 1, "infeasible": 3, "unbounded": 2}[lp]
    assert port["status"] == want
    if lp in ("textbook", "phase1"):
        assert float.fromhex(port["z"]) == {"textbook": -400.0,
                                            "phase1": 10.0}[lp]


@pytest.mark.parametrize("driver", ["rank1", "blocked"])
@pytest.mark.parametrize("where", ["T", "rhs"])
def test_nan_reports_numeric(runs, driver, where):
    port = _held(runs, 2, f"numeric-{driver}-{where}",
                 BLOCKED_TOL if driver == "blocked" else TOL)
    assert port["status"] == 5


@pytest.mark.parametrize("driver", ["rank1", "blocked"])
def test_tuple_axis_two_hosts(runs, driver):
    """The column split host-major over a (hosts, cols) mesh of 2 x 2."""
    port = _held(runs, 4, f"hybrid-{driver}",
                 BLOCKED_TOL if driver == "blocked" else TOL)
    assert port["status"] == 1


@pytest.mark.parametrize("p", [1, 2])
def test_idle_step_leaves_the_block_bit_for_bit(runs, p):
    ports, _ = runs[(p, "idle")]
    port = {k: replicated(ports, k) for k in ports[0]}
    assert port["status"] == 1 and port["same"], port


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("case", [c[0] for c in SOLVE_LP_CASES])
def test_solve_lp_mesh_equals_tpulps(runs, p, case):
    ports, ref = runs[(p, f"solve_lp-{case}")]
    port = {k: replicated(ports, k) for k in ports[0]}
    assert port["status"] == ref["status"]
    assert port["objective"] == ref["objective"]
    if ref["status"] == "optimal":
        assert port["basis"] == ref["basis"]
        assert port["at_upper"] == ref["at_upper"]
        assert port["rung"] == "device-float64"
    if case == "box":
        assert Fraction(port["objective"]) == 14


# ---------------------------------------------------------------------------
# solve_lp(mesh=...)'s argument checks, in this process at P = 1
# ---------------------------------------------------------------------------

RAISES = [
    ("warm_basis", {"warm": True}),
    ("devex_bounded", {"simple_bounds": True, "pricing": "devex"}),
    ("devex_rank1", {"pricing": "devex", "shard_driver": "rank1"}),
    ("unknown_driver", {"shard_driver": "bogus"}),
]


@pytest.mark.parametrize("name,kw", RAISES, ids=[r[0] for r in RAISES])
def test_solve_lp_mesh_raises_like_tpulp(name, kw):
    from tpulp.shard import make_mesh as tpulp_mesh
    from tpulp.solve import solve_lp as tpulp_solve

    import tpulp_torch
    from test_torch_model import to_port

    kw = dict(kw)
    lp = _lp("box" if kw.get("simple_bounds") else "textbook")
    tp_kw, port_kw = dict(kw), dict(kw)
    if kw.pop("warm", False):
        tp_kw = {"warm_start": tpulp_solve(lp)}
        port_kw = {"warm_start": tpulp_torch.solve_lp(to_port(lp),
                                                      device="cpu")}
    with pytest.raises(ValueError) as tp_err:
        tpulp_solve(lp, mesh=tpulp_mesh(1), **tp_kw)
    with InProcessGroup() as g:
        with pytest.raises(ValueError) as port_err:
            tpulp_torch.solve_lp(to_port(lp), mesh=g.meshes["cols"],
                                 device="cpu", **port_kw)
    key = {"warm_basis": "warm_basis", "devex_bounded": "SHARDED",
           "devex_rank1": "blocked", "unknown_driver": "bogus"}[name]
    assert key in str(tp_err.value) and key in str(port_err.value)


# driver: (the function, tpulp's module that solve_lp reaches it through,
# the program, solve_lp's arguments)
MESH_RETRY = {
    "blocked": ("run_simplex_sharded_blocked", "tpulp.shard", "textbook",
                {}),
    "rank1": ("run_simplex_sharded", "tpulp.shard", "textbook",
              {"shard_driver": "rank1"}),
    "bounded": ("run_simplex_sharded_bounded", "tpulp.shard.sharded_bounded",
                "box", {"simple_bounds": True}),
}


@pytest.mark.parametrize("driver", sorted(MESH_RETRY))
def test_mesh_f32_failure_retries_at_f64_on_the_mesh(driver, monkeypatch):
    """A NUMERIC float32 verdict of a sharded driver climbs tpulp's
    ladder: no refreshed rung (that driver is solo), the same sharded
    driver again at float64 on the same mesh, then refinement."""
    import importlib

    import jax.numpy as jnp
    from tpulp.shard import make_mesh as tpulp_mesh
    from tpulp.solve import solve_lp as tpulp_solve

    import tpulp_torch
    import tpulp_torch.shard as pshard
    from test_torch_model import to_port
    from tpulp_torch.core import Status

    name, tp_module, kind, kw = MESH_RETRY[driver]
    jshard = importlib.import_module(tp_module)
    seen = {"tpulp": [], "port": []}

    def failing(real, key, numeric):
        def run(st, mesh, *args, **kwargs):
            out = real(st, mesh, *args, **kwargs)
            s = out.s if driver == "bounded" else out
            dt = str(s.T.dtype).replace("torch.", "")
            seen[key].append(dt)
            if dt == "float32":
                s = s._replace(status=numeric)
                out = out._replace(s=s) if driver == "bounded" else s
            return out
        return run

    monkeypatch.setattr(jshard, name, failing(
        getattr(jshard, name), "tpulp", jnp.int32(Status.NUMERIC)))
    monkeypatch.setattr(pshard, name, failing(
        getattr(pshard, name), "port",
        torch.tensor(Status.NUMERIC, dtype=torch.int32)))
    lp = _lp(kind)
    ref = tpulp_solve(lp, mesh=tpulp_mesh(1), dtype=jnp.float32, **kw)
    with InProcessGroup() as g:
        out = tpulp_torch.solve_lp(to_port(lp), mesh=g.meshes["cols"],
                                   dtype=torch.float32, device="cpu", **kw)
    assert seen["port"] == seen["tpulp"] == ["float32", "float64"]
    assert out.rung == ref.rung == "device-float64"
    assert out.status == ref.status == "optimal"
    assert out.objective == ref.objective
    assert out.basis == ref.basis and out.at_upper == ref.at_upper


def test_mesh_checks_its_type_and_device():
    import tpulp_torch
    from test_torch_model import to_port

    lp = to_port(_lp("textbook"))
    with pytest.raises(TypeError, match="DeviceMesh"):
        tpulp_torch.solve_lp(lp, mesh=object(), device="cpu")
    with InProcessGroup() as g:
        from tpulp_torch.shard import make_mesh

        if torch.cuda.is_available():
            with pytest.raises(ValueError, match="mesh"):
                tpulp_torch.solve_lp(lp, mesh=g.meshes["cols"],
                                     device="cuda")
        with pytest.raises(ValueError, match="process group"):
            make_mesh(2, device="cpu")


@pytest.mark.parametrize("entry", ["solve_lp_batch", "solve_milp"])
def test_batch_mesh_still_raises_naming_its_item(entry):
    """The batch entries' ``mesh=`` (ported since:
    tests/test_torch_mesh_batch.py) refuses anything but a DeviceMesh,
    naming it, as ``solve_lp`` does."""
    import tpulp_torch
    from test_torch_model import to_port

    lp = to_port(_lp("textbook"))
    args = ([lp],) if entry == "solve_lp_batch" else (lp,)
    with pytest.raises(TypeError, match="DeviceMesh"):
        getattr(tpulp_torch, entry)(*args, mesh=object(), device="cpu")


if __name__ == "__main__":
    code = worker_main(sys.argv[1:])
    # the rank's results are written and its process group destroyed:
    # leave without the interpreter's teardown, in which torch's gloo
    # objects can abort a finished rank ("terminate called without an
    # active exception", SIGABRT)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
