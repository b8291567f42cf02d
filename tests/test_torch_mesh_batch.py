"""The batch half of multi-device solving, the port against tpulp, on the
CPU: ``run_simplex_batch_gspmd`` / ``run_simplex_gspmd`` walks,
``solve_lp_batch(mesh=...)`` and ``solve_milp(mesh=...)`` over
``(batch, cols)`` meshes, and the collectives of a lane-sharded step.

The port runs multi-controller over gloo: ``test_torch_shard``'s harness
starts the P = 2 and P = 4 groups once for the module (every rank
``torch.set_num_threads(1)``), P = 1 runs in this process. The P = 4
ranks form a ``(batch 2, cols 2)`` mesh, the P = 2 ranks a ``(batch 2)``
or a ``(cols 2)`` mesh, P = 1 a ``(batch 1, cols 1)`` mesh. tpulp runs
each case on the conftest's fake CPU devices, on a mesh of the same shape.
At float64 each lane's status, ``niter`` and basis must equal tpulp's,
its objective be within 1e-12 relative of tpulp's, and its terminal
tableau equal the port's solo ``run_simplex_batch`` lane bit for bit, up
to the sign of zero entries (``lane_summaries``); every rank must return
the same results.

The module is also the workers' handler module (``HANDLERS``): its
top-level imports are torch-only, and tpulp is imported inside the
functions that hold the port against it.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from fractions import Fraction

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

from test_torch_shard import (InProcessGroup, _digest, bounded_polytope,  # noqa: E402
                              random_dense, replicated, start_group)

torch.set_num_threads(1)

TOL = 1e-12
# mesh name -> (dims, axis names), by process count
MESHES = {
    "2d": ((2, 2), ("batch", "cols")),
    "batch": ((2,), ("batch",)),
    "cols": ((2,), ("cols",)),
    "cols4": ((4,), ("cols",)),
    "1x1": ((1, 1), ("batch", "cols")),
}
PROCS = {name: int(np.prod(dims)) for name, (dims, _) in MESHES.items()}


# ---------------------------------------------------------------------------
# the instances: built from a model module (tpulp's or the port's)
# ---------------------------------------------------------------------------

def set_cover(model, seed=1, n_items=16, n_sets=28, p=0.2):
    """tests/test_mesh_batch_milp.py's set cover (16 x 28)."""
    rng = np.random.default_rng(seed)
    lp = model.LinProg(f"setcover_{seed}")
    xs = [lp.addVar(f"s{j}", integral=True, lb=0, ub=1).x
          for j in range(n_sets)]
    cost = rng.integers(2, 20, size=n_sets)
    obj = model.LinExpr()
    for j in range(n_sets):
        obj += model.LinExpr(int(cost[j]), xs[j])
    lp.minimize(obj)
    cover = rng.random((n_sets, n_items)) < p
    for i in range(n_items):
        if not cover[:, i].any():
            cover[int(rng.integers(0, n_sets)), i] = True
        e = model.LinExpr()
        for j in range(n_sets):
            if cover[j, i]:
                e += model.LinExpr(1, xs[j])
        lp.addConstraint(e.constraintGeq(1))
    return lp


def dangling_set_cover(model):
    """The set cover with a free column that only the objective holds:
    presolve defers its verdict to a feasibility solve (unbounded if
    feasible)."""
    lp = set_cover(model)
    lp.addVar("w", lb=0, ub=None)
    lp.objective.expr += model.LinExpr(-1, "w")
    return lp


def knapsack(model, n=18, seed=3):
    """test_torch_milp.py's knapsack (bench.py's recipe)."""
    rng = np.random.default_rng(seed)
    values = [int(v) for v in rng.integers(10, 60, size=n)]
    weights = [int(w) for w in rng.integers(5, 25, size=n)]
    lp = model.LinProg()
    obj, wexpr = model.LinExpr(), model.LinExpr()
    for i in range(n):
        lp.addVar(f"x{i}", integral=True, lb=0, ub=1)
        obj += model.LinExpr(values[i], f"x{i}")
        wexpr += model.LinExpr(weights[i], f"x{i}")
    lp.maximize(obj)
    lp.addConstraint(wexpr.constraintLeq(int(sum(weights) * 0.4)))
    return lp


def milp_program(model, task):
    return knapsack(model) if task["prog"] == "knapsack" \
        else set_cover(model, seed=task["seed"])


def status_lps(model):
    """test_mesh_batch_milp.py's mixed statuses: infeasible, unbounded and
    an optimal equality-heavy LP."""
    inf = model.LinProg("inf")
    inf.addVar("x")
    inf.minimize(model.LinExpr(1, "x"))
    inf.addConstraint(model.LinExpr(1, "x").constraintLeq(1))
    inf.addConstraint(model.LinExpr(1, "x").constraintGeq(3))
    unb = model.LinProg("unb")
    unb.addVar("x")
    unb.maximize(model.LinExpr(1, "x"))
    unb.addConstraint(model.LinExpr(1, "x").constraintGeq(1))
    return [inf, unb, model.corpus._equality_heavy(24, 48, seed=2,
                                                   name="eq_ok")()]


def equality_heavy(model, seeds):
    return [model.corpus._equality_heavy(24, 48, seed=s, name=f"eq{s}")()
            for s in seeds]


class _Model:
    """A package's model classes and corpus under one name."""

    def __init__(self, package: str):
        import importlib

        pkg = importlib.import_module(package)
        self.LinProg = pkg.LinProg
        self.LinExpr = pkg.LinExpr
        self.corpus = importlib.import_module(f"{package}.corpus")


def walk_lanes(task):
    """The batch of a walk case: dense LPs made into states, or the
    equality-heavy LPs lowered and batched (phase 1 with artificials)."""
    if task["lanes"] == "dense":
        return [random_dense(1, 12, 20)] + [bounded_polytope(s, 12, 20)
                                           for s in (1, 2, 3)]
    return None


# ---------------------------------------------------------------------------
# the port's side (any rank)
# ---------------------------------------------------------------------------

_MESHES: dict = {}


def port_mesh(name):
    """The port's DeviceMesh ``name`` over the current group (made once
    per group: every rank makes its meshes in the same order)."""
    from torch.distributed.device_mesh import init_device_mesh

    if name not in _MESHES:
        dims, names = MESHES[name]
        _MESHES[name] = init_device_mesh("cpu", dims, mesh_dim_names=names)
    return _MESHES[name]


def _axes(name):
    names = MESHES[name][1]
    return ("batch" if "batch" in names else None,
            "cols" if "cols" in names else None)


def port_batch(task):
    """The port's padded batched state of a walk case."""
    from tpulp_torch.batch.vmap_driver import (make_batched_states,
                                               pad_batched_columns,
                                               stack_states)
    from tpulp_torch.core import make_state

    lanes = walk_lanes(task)
    if lanes is not None:
        batched = stack_states([
            make_state(lp["c"], lp["A"], lp["b"], lp["hint"],
                       dtype=torch.float64, device="cpu") for lp in lanes])
    else:
        sfs = [lp.lower() for lp in equality_heavy(_Model("tpulp_torch"),
                                                   range(4))]
        batched = make_batched_states(sfs, device="cpu")
    dims, names = MESHES[task["mesh"]]
    cols = dims[names.index("cols")] if "cols" in names else 1
    return pad_batched_columns(batched, cols)


def lane_summaries(out):
    """Each lane's status, niter, basis, objective and tableau digest.
    The digest is taken of ``T + 0.0``, which turns -0.0 into +0.0 and
    leaves every other value's bits: a psum of a shard's -0.0 and the
    other shards' +0.0 is +0.0, and an idle step's unit column holds +0.0
    where the solo step's column may hold -0.0, so the sign of a zero
    entry may differ. It never reaches a decision or a non-zero value
    (no pivot divides by a zero)."""
    return [{"status": int(out.status[k]), "niter": int(out.niter[k]),
             "basis": [int(v) for v in out.basis[k].tolist()],
             "z": float(0.0 - out.T[k, 0, -1]).hex(),
             "T": _digest(out.T[k] + 0.0)}
            for k in range(out.T.shape[0])] + [
        {"shape": list(out.T.shape)}]


def port_opts(task):
    from tpulp_torch.core import SolverOptions

    return dataclasses.replace(SolverOptions.for_dtype(torch.float64),
                               **RULES[task.get("rule", "dantzig")])


def _walk(task, meshes):
    from tpulp_torch.shard import run_simplex_batch_gspmd

    batch_axis, cols_axis = _axes(task["mesh"])
    out = run_simplex_batch_gspmd(port_batch(task), port_mesh(task["mesh"]),
                                  port_opts(task), batch_axis=batch_axis,
                                  cols_axis=cols_axis or "cols")
    return lane_summaries(out)


def _one(task, meshes):
    """run_simplex_gspmd on one LP over the 1-D cols mesh of the group."""
    from tpulp_torch.core import make_state
    from tpulp_torch.shard import run_simplex_gspmd, shard_state

    lp = task["lp"]
    mesh = port_mesh(task["mesh"])
    st = shard_state(make_state(lp["c"], lp["A"], lp["b"], lp["hint"],
                                dtype=torch.float64, device="cpu"), mesh)
    out = run_simplex_gspmd(st, mesh)
    return lane_summaries(type(out)(*(x[None] for x in out)))


def _solutions(sols):
    return [{"status": s.status, "objective": str(s.objective),
             "niter": s.niter, "basis": s.basis} for s in sols]


def _lp_batch(task, meshes):
    import tpulp_torch

    model = _Model("tpulp_torch")
    lps = status_lps(model) if task["lps"] == "statuses" \
        else equality_heavy(model, range(5))
    batch_axis, cols_axis = _axes(task["mesh"])
    return _solutions(tpulp_torch.solve_lp_batch(
        lps, mesh=port_mesh(task["mesh"]), device="cpu",
        batch_axis=batch_axis, cols_axis=cols_axis or "cols"))


def milp_result(sol, stats):
    from tpulp_torch.milp.bnb import BnbStats

    return {"status": sol.status, "objective": str(sol.objective),
            "x": None if sol.x is None else
            {k: str(Fraction(v)) for k, v in sol.x.items()},
            "stats": {f.name: getattr(stats, f.name)
                      for f in dataclasses.fields(BnbStats)
                      if not f.name.startswith("t_")
                      and f.name != "pool_bytes"}}


def _milp(task, meshes):
    import tpulp_torch

    sol, stats = tpulp_torch.solve_milp(
        milp_program(_Model("tpulp_torch"), task),
        mesh=port_mesh(task["mesh"]), return_stats=True, device="cpu",
        **task["kw"])
    return milp_result(sol, stats)


def _raises(task, meshes):
    """The error that a call refused on the mesh raises (no collective has
    run when it does, on any rank)."""
    import tpulp_torch

    model = _Model("tpulp_torch")
    mesh = port_mesh(task["mesh"])
    try:
        if task["entry"] == "milp":
            tpulp_torch.solve_milp(set_cover(model), mesh=mesh,
                                   device="cpu", **task["kw"])
        else:
            tpulp_torch.solve_lp_batch(equality_heavy(model, [0]),
                                       mesh=mesh, device="cpu", **task["kw"])
    except ValueError as e:
        return {"error": str(e)}
    return {"error": None}


def _presolve_clock(task, meshes):
    """The dangling set cover on the mesh with a time limit that differs
    between the ranks, as their clocks do: rank 0's has run out."""
    import torch.distributed as dist

    import tpulp_torch

    sol = tpulp_torch.solve_milp(
        dangling_set_cover(_Model("tpulp_torch")),
        mesh=port_mesh(task["mesh"]), batch_size=16, device="cpu",
        time_limit=0.0 if dist.get_rank() == 0 else 1e6)
    return {"status": sol.status, "objective": str(sol.objective)}


def _counts(task, meshes):
    """The collectives of ONE lane-sharded primal step and of one dual
    step over ``lanes`` lanes, and of a whole batched solve."""
    from tpulp_torch.comm import COUNTS, reset_counts
    from tpulp_torch.core import SolverOptions
    from tpulp_torch.shard import run_simplex_batch_gspmd
    from tpulp_torch.shard.sharded_batch import LaneMesh
    from tpulp_torch.batch.vmap_driver import (pad_batched_columns,
                                               stack_states)
    from tpulp_torch.core import make_state

    lp = bounded_polytope(1, 12, 20)
    st = make_state(lp["c"], lp["A"], lp["b"], lp["hint"],
                    dtype=torch.float64, device="cpu")
    dims, names = MESHES[task["mesh"]]
    batched = pad_batched_columns(
        stack_states([st] * task["lanes"]),
        dims[names.index("cols")] if "cols" in names else 1)
    batch_axis, cols_axis = _axes(task["mesh"])
    mesh = port_mesh(task["mesh"])
    lm = LaneMesh(mesh, batch_axis, cols_axis or "cols")
    fr = lm.to_frames(lm.mine(batched))
    opts = SolverOptions.for_dtype(torch.float64)
    out = {}
    for kind, run in (("primal", lm.primal), ("dual", lm.dual)):
        reset_counts()
        one = run(fr, opts, 10, max_iters=1)
        out[kind] = {"calls": sum(COUNTS.values()),
                     "niter": [int(v) for v in one.niter.tolist()]}
    reset_counts()
    run_simplex_batch_gspmd(batched, mesh, batch_axis=batch_axis,
                            cols_axis=cols_axis or "cols")
    out["solve"] = sorted([list(k) + [v] for k, v in COUNTS.items()])
    return out


def rebuilt_frames(task, mesh_name=None):
    """``run_warm_batch`` of the first three checkpointed nodes (an odd
    lane count, padded to the batch axis on a mesh) from the padded root
    template, as ``solve_milp`` rebuilds a resumed wave: every lane's
    summary, whole on every process."""
    from tpulp_torch.batch.vmap_driver import (make_batched_states,
                                               pad_batched_columns)
    from tpulp_torch.io import load_bnb_frontier
    from tpulp_torch.milp.bnb import _node_standard_form
    from tpulp_torch.model.lower import lower_to_standard_form
    from tpulp_torch.shard.sharded_waves import MeshWaves
    from tpulp_torch.solve.dual import run_warm_batch

    root = lower_to_standard_form(knapsack(_Model("tpulp_torch")),
                                  integer_bound_rows=True)
    nodes = load_bnb_frontier(task["checkpoint"])[0][:3]
    basis = np.stack([n[3] for n in nodes])
    b = torch.tensor([[float(v) for v in _node_standard_form(root, n[2]).b]
                      for n in nodes], dtype=torch.float64)
    t = pad_batched_columns(make_batched_states([root], device="cpu"), 2)
    art = t.art_cols[0]
    args = (t.T[0, 2:, :-1], t.T[0, 0, :-1], t.col_active[0] & ~art, art,
            basis, b)
    if mesh_name is None:
        return lane_summaries(run_warm_batch(*args))
    waves = MeshWaves(port_mesh(mesh_name), t.T.shape[2] - 1)
    return lane_summaries(waves.from_frames(waves.run_warm_batch(*args),
                                            t.T.shape[2] - 1))


def _rebuild(task, meshes):
    return rebuilt_frames(task, task["mesh"])


HANDLERS = {"walk": _walk, "one": _one, "lp_batch": _lp_batch,
            "milp": _milp, "raises": _raises, "counts": _counts,
            "rebuild": _rebuild, "presolve_clock": _presolve_clock}


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

WALK_MESHES = ["2d", "batch", "cols", "1x1"]
# the pricing rules and tie breaks of the rank-1 step (SolverOptions
# fields), each walked on the meshes that split columns
RULES = {"dantzig": {}, "bland": {"rule": 1}, "max_increase": {"rule": 2},
         "max_pivot": {"tie_break": 1}}
RULE_MESHES = ["2d", "cols"]
RAISES = {
    "multiple": ("milp", "2d", {"batch_size": 3}),
    "rows": ("milp", "2d", {"batch_size": 16, "node_encoding": "spans"}),
    "bounded": ("lp_batch", "2d", {"simple_bounds": True}),
    "rank1": ("lp_batch", "2d", {"driver": "blocked"}),
}
MILP_CASES = {
    # (mesh, program, seed, solve_milp's arguments)
    "setcover-2d-unchained": ("2d", 1, {"batch_size": 16,
                                        "device_generations": 0}),
    "setcover-2d-chained": ("2d", 1, {"batch_size": 16}),
    # test_mesh_batch_milp.py's batch-only case (solved at the root) and
    # the set cover of seed 1 on that mesh, chained
    "setcover-batch-only": ("batch", 2, {"batch_size": 16}),
    "setcover-batch-only-chained": ("batch", 1, {"batch_size": 16}),
    # a resumed frontier of warm nodes: the first waves rebuild their
    # frames from the checkpointed bases
    "knapsack-2d-resumed": ("2d", None, {"batch_size": 8,
                                         "resume_from": "CHECKPOINT"}),
}
CHECKPOINT_KW = {"batch_size": 8, "max_nodes": 40, "device_generations": 0}


def _cases(checkpoint=None):
    """{P: [task]}; ``checkpoint`` is the resumed case's file."""
    cases = {1: [], 2: [], 4: []}

    def add(mesh, task):
        cases[PROCS[mesh]].append(dict(task, mesh=mesh))

    for mesh in WALK_MESHES:
        for lanes in ("dense", "equality"):
            add(mesh, {"id": f"walk-{lanes}-{mesh}", "kind": "walk",
                       "lanes": lanes})
    for mesh in RULE_MESHES:
        for rule in list(RULES)[1:]:
            add(mesh, {"id": f"walk-{rule}-{mesh}", "kind": "walk",
                       "lanes": "equality", "rule": rule})
    for mesh, seed in (("cols", 4), ("cols4", 5)):
        add(mesh, {"id": f"one-{mesh}", "kind": "one",
                   "lp": bounded_polytope(seed, 12, 20)})
    for mesh in ("2d", "batch"):
        add(mesh, {"id": f"lp_batch-{mesh}", "kind": "lp_batch",
                   "lps": "equality"})
    add("2d", {"id": "lp_batch-statuses", "kind": "lp_batch",
               "lps": "statuses"})
    for name, (entry, mesh, kw) in RAISES.items():
        add(mesh, {"id": f"raises-{name}", "kind": "raises", "entry": entry,
                   "kw": kw})
    for name, (mesh, seed, kw) in MILP_CASES.items():
        add(mesh, {"id": f"milp-{name}", "kind": "milp", "seed": seed,
                   "prog": "set_cover" if seed else "knapsack",
                   "kw": dict(kw, **({"resume_from": checkpoint}
                                     if "resume_from" in kw else {}))})
    add("2d", {"id": "rebuild-2d", "kind": "rebuild",
               "checkpoint": checkpoint})
    for lanes in (2, 16):
        add("2d", {"id": f"counts-2d-{lanes}", "kind": "counts",
                   "lanes": lanes})
    add("batch", {"id": "counts-batch", "kind": "counts", "lanes": 4})
    add("batch", {"id": "presolve-clock", "kind": "presolve_clock"})
    return cases


def write_checkpoint(tmp):
    """The resumed case's checkpoint: the port's solo knapsack stopped at
    its node limit."""
    import tpulp_torch

    path = os.path.join(tmp, "knapsack.ck.json")
    tpulp_torch.solve_milp(knapsack(_Model("tpulp_torch")),
                           checkpoint_path=path, device="cpu",
                           **CHECKPOINT_KW)
    return path


def _run_here(task):
    return HANDLERS[task["kind"]](task, None)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case id: [every rank's result]}."""
    tmp = str(tmp_path_factory.mktemp("mesh_batch"))
    cases = _cases(write_checkpoint(tmp))
    waits = {p: start_group(cases[p], p, tmp,
                            handlers="test_torch_mesh_batch")
             for p in (2, 4)}
    out = {}
    with InProcessGroup():
        _MESHES.clear()
        try:
            for task in cases[1]:
                out[task["id"]] = [_run_here(task)]
        finally:
            _MESHES.clear()
    for p in (2, 4):
        per_rank = waits[p]()
        for task in cases[p]:
            out[task["id"]] = [r[task["id"]] for r in per_rank]
    out["tasks"] = {t["id"]: t for p in cases for t in cases[p]}
    return out


def port_result(runs, case):
    """The one result of ``case`` that every rank returned alike."""
    return replicated([{case: r} for r in runs[case]], case)


# ---------------------------------------------------------------------------
# tpulp's side (the fake CPU devices)
# ---------------------------------------------------------------------------

def tpulp_mesh(name):
    import jax
    from jax.sharding import Mesh

    dims, names = MESHES[name]
    return Mesh(np.array(jax.devices()[:int(np.prod(dims))]).reshape(dims),
                names)


def tpulp_walk(task):
    import jax.numpy as jnp

    from tpulp.batch.vmap_driver import (make_batched_states,
                                         pad_batched_columns, stack_states)
    from tpulp.core import SolverOptions, make_state
    from tpulp.shard.sharded import run_simplex_batch_gspmd

    lanes = walk_lanes(task)
    if lanes is not None:
        batched = stack_states([
            make_state(lp["c"], lp["A"], lp["b"], lp["hint"],
                       dtype=jnp.float64) for lp in lanes])
    else:
        sfs = [lp.lower() for lp in equality_heavy(_Model("tpulp"),
                                                   range(4))]
        batched = make_batched_states(sfs)
    dims, names = MESHES[task["mesh"]]
    batched = pad_batched_columns(
        batched, dims[names.index("cols")] if "cols" in names else 1)
    batch_axis, cols_axis = _axes(task["mesh"])
    opts = dataclasses.replace(SolverOptions.for_dtype(jnp.float64),
                               **RULES[task.get("rule", "dantzig")])
    out = run_simplex_batch_gspmd(batched, tpulp_mesh(task["mesh"]), opts,
                                  batch_axis=batch_axis,
                                  cols_axis=cols_axis or "cols")
    T = np.asarray(out.T)
    return [{"status": int(out.status[k]), "niter": int(out.niter[k]),
             "basis": [int(v) for v in np.asarray(out.basis[k])],
             "z": float(-T[k, 0, -1])} for k in range(T.shape[0])] + [
        {"shape": list(T.shape)}]


def _held(port, ref):
    for p, r in zip(port[:-1], ref[:-1]):
        assert (p["status"], p["niter"], p["basis"]) == \
            (r["status"], r["niter"], r["basis"]), (p, r)
        z = float.fromhex(p["z"])
        if np.isfinite(r["z"]) or np.isfinite(z):
            assert abs(z - r["z"]) <= TOL * max(1.0, abs(r["z"])), (z, r)
    assert port[-1] == ref[-1]  # the padded shape


def solo_walk(task):
    """The port's solo batched driver on the same padded batch."""
    from tpulp_torch.batch.vmap_driver import run_simplex_batch

    return lane_summaries(run_simplex_batch(port_batch(task),
                                            port_opts(task)))


@pytest.mark.parametrize("lanes", ["dense", "equality"])
@pytest.mark.parametrize("mesh", WALK_MESHES)
def test_batch_walks_equal_tpulps_and_the_solo_batch(runs, mesh, lanes):
    task = {"lanes": lanes, "mesh": mesh}
    port = port_result(runs, f"walk-{lanes}-{mesh}")
    _held(port, tpulp_walk(task))
    assert port == solo_walk(task)  # bit for bit, lane for lane
    statuses = {lane["status"] for lane in port[:-1]}
    assert statuses == ({1, 2} if lanes == "dense" else {1})


@pytest.mark.parametrize("rule", list(RULES)[1:])
@pytest.mark.parametrize("mesh", RULE_MESHES)
def test_every_pricing_rule_walks_tpulps(runs, mesh, rule):
    """Bland, greatest-increase pricing and the largest-pivot tie break
    hold across column shards, as tpulp's GSPMD-partitioned step."""
    task = {"lanes": "equality", "mesh": mesh, "rule": rule}
    port = port_result(runs, f"walk-{rule}-{mesh}")
    _held(port, tpulp_walk(task))
    assert port == solo_walk(task)
    assert {lane["status"] for lane in port[:-1]} == {1}


@pytest.mark.parametrize("mesh", ["cols", "cols4"])
def test_one_lp_over_cols_equals_tpulp(runs, mesh):
    import jax.numpy as jnp

    from tpulp.core import make_state as jmake
    from tpulp.shard import run_simplex_gspmd as jrun
    from tpulp.shard import shard_state as jshard
    from tpulp_torch.core import make_state
    from tpulp_torch.solve.driver import run_simplex

    task = next(t for t in _cases()[PROCS[mesh]]
                if t["id"] == f"one-{mesh}")
    lp = task["lp"]
    jm = tpulp_mesh(mesh)
    ref = jrun(jshard(jmake(lp["c"], lp["A"], lp["b"], lp["hint"],
                            dtype=jnp.float64), jm), jm)
    T = np.asarray(ref.T)
    ref_s = [{"status": int(ref.status), "niter": int(ref.niter),
              "basis": [int(v) for v in np.asarray(ref.basis)],
              "z": float(-T[0, -1])}, {"shape": [1] + list(T.shape)}]
    port = port_result(runs, f"one-{mesh}")
    _held(port, ref_s)
    # the solo driver on the same padded state, bit for bit
    st = make_state(lp["c"], lp["A"], lp["b"], lp["hint"],
                    dtype=torch.float64, device="cpu")
    pad = (-(st.n + 1)) % PROCS[mesh]
    st = st._replace(
        T=torch.cat([st.T[:, :-1], torch.zeros(st.T.shape[0], pad,
                                               dtype=st.T.dtype),
                     st.T[:, -1:]], dim=1),
        col_active=torch.cat([st.col_active, torch.zeros(pad, dtype=bool)]),
        art_cols=torch.cat([st.art_cols, torch.zeros(pad, dtype=bool)]))
    solo = run_simplex(st)
    assert port == lane_summaries(type(solo)(*(x[None] for x in solo)))
    assert port[0]["status"] == 1


def _tpulp_lp_batch(lps, mesh):
    from tpulp.batch import solve_lp_batch

    return [{"status": s.status, "objective": str(s.objective)}
            for s in solve_lp_batch(lps, mesh=tpulp_mesh(mesh))]


@pytest.mark.parametrize("mesh", ["2d", "batch"])
def test_lp_batch_objectives_equal_tpulps(runs, mesh):
    import tpulp_torch

    port = port_result(runs, f"lp_batch-{mesh}")
    ref = _tpulp_lp_batch(equality_heavy(_Model("tpulp"), range(5)), mesh)
    solo = _solutions(tpulp_torch.solve_lp_batch(
        equality_heavy(_Model("tpulp_torch"), range(5)), device="cpu"))
    assert [(p["status"], p["objective"]) for p in port] == \
        [(r["status"], r["objective"]) for r in ref]
    assert port == solo
    assert all(p["status"] == "optimal" for p in port)


def test_lp_batch_mixed_statuses(runs):
    port = port_result(runs, "lp_batch-statuses")
    ref = _tpulp_lp_batch(status_lps(_Model("tpulp")), "2d")
    assert [p["status"] for p in port] == [r["status"] for r in ref] == [
        "infeasible", "unbounded", "optimal"]
    assert port[2]["objective"] == ref[2]["objective"]


@pytest.mark.parametrize("name", list(RAISES))
def test_mesh_rejections_like_tpulp(runs, name):
    from tpulp.batch import solve_lp_batch
    from tpulp.milp import solve_milp

    entry, mesh, kw = RAISES[name]
    port = port_result(runs, f"raises-{name}")
    model = _Model("tpulp")
    with pytest.raises(ValueError) as err:
        if entry == "milp":
            solve_milp(set_cover(model), mesh=tpulp_mesh(mesh), **kw)
        else:
            solve_lp_batch(equality_heavy(model, [0]), mesh=tpulp_mesh(mesh),
                           **kw)
    assert port["error"] is not None
    assert name in port["error"] and name in str(err.value)


def tpulp_milp(mesh, task):
    from tpulp.milp import solve_milp

    sol, stats = solve_milp(milp_program(_Model("tpulp"), task),
                            mesh=None if mesh is None else tpulp_mesh(mesh),
                            return_stats=True, **task["kw"])
    return {"status": sol.status, "objective": str(sol.objective),
            "x": {k: str(Fraction(v)) for k, v in sol.x.items()},
            "stats": {f.name: getattr(stats, f.name)
                      for f in dataclasses.fields(type(stats))
                      if not f.name.startswith("t_")}}


@pytest.mark.parametrize("case", list(MILP_CASES))
def test_milp_on_the_mesh_equals_tpulps(runs, case):
    import tpulp_torch

    mesh, seed, _ = MILP_CASES[case]
    task = runs["tasks"][f"milp-{case}"]
    port = port_result(runs, f"milp-{case}")
    ref = tpulp_milp(mesh, task)
    assert port["status"] == ref["status"] == "optimal"
    assert port["objective"] == ref["objective"]
    assert port["x"] == ref["x"]
    assert port["stats"] == ref["stats"]
    if seed != 2:
        assert port["stats"]["nodes_solved"] >= 3
    if case.endswith("-chained"):
        assert port["stats"]["gen_waves"] > 0
    if case.endswith(("-unchained", "-resumed")):
        # the same tree as the port's solo run
        sol, st = tpulp_torch.solve_milp(
            milp_program(_Model("tpulp_torch"), task), return_stats=True,
            device="cpu", **task["kw"])
        assert milp_result(sol, st) == port
    if case.endswith("-resumed"):
        assert port["stats"]["warm_nodes"] > 0


def test_resumed_frames_on_an_uneven_batch(runs):
    """Three checkpointed nodes rebuilt and re-optimized over the 2-D mesh
    (lanes padded to the batch axis and cut back): the solo wave's
    lanes, bit for bit."""
    port = port_result(runs, "rebuild-2d")
    assert len(port) == 4 and port[-1]["shape"][0] == 3
    assert port == rebuilt_frames(runs["tasks"]["rebuild-2d"])
    assert {lane["status"] for lane in port[:-1]} <= {1, 3}


@pytest.mark.parametrize("lanes", [2, 16])
def test_lane_sharded_step_makes_path_b_collectives(runs, lanes):
    """Four collectives a primal step and three a dual step, each carrying
    every local lane (1 and 8 here), as path B's rank-1 step makes."""
    port = port_result(runs, f"counts-2d-{lanes}")
    assert port["primal"]["calls"] == 4
    assert port["dual"]["calls"] == 3
    assert port["primal"]["niter"] == [1] * (lanes // 2)
    kinds = {k for k, *_ in port["solve"]}
    assert kinds == {"psum", "all_gather"}


def test_batch_only_mesh_communicates_once_a_solve(runs):
    port = port_result(runs, "counts-batch")
    assert port["primal"]["calls"] == port["dual"]["calls"] == 0
    # the solve's one collective: the packed gather of its terminal lanes
    [(kind, _, _, calls)] = port["solve"]
    assert (kind, calls) == ("all_gather", 1)


def test_presolve_feasibility_solve_agrees_on_the_clock(runs):
    """Presolve's feasibility solve runs on the mesh: when one rank's time
    is up, every rank stops and returns the same Solution, tpulp's at a
    spent time limit."""
    from tpulp.milp import solve_milp

    port = port_result(runs, "presolve-clock")
    ref = solve_milp(dangling_set_cover(_Model("tpulp")), batch_size=16,
                     time_limit=0.0)
    assert port["status"] == ref.status == "time_limit"
    assert port["objective"] == str(ref.objective)


def test_mesh_argument_is_a_device_mesh():
    import tpulp_torch

    lp = set_cover(_Model("tpulp_torch"))
    for call in (lambda: tpulp_torch.solve_milp(lp, mesh=object(),
                                                device="cpu"),
                 lambda: tpulp_torch.solve_lp_batch([lp], mesh=object(),
                                                    device="cpu")):
        with pytest.raises(TypeError, match="DeviceMesh"):
            call()
