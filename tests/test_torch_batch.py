"""tpulp_torch.batch and warm starts against tpulp at float64: batched
states built alike, the batched rank-1 walk (status, pivot count and basis
per lane), ``solve_lp_batch`` cold and with ``warm_start`` (exact
objectives), and ``solve_lp(warm_start=...)``."""

from fractions import Fraction as F

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpulp_torch
from tpulp import LinExpr, LinProg
from tpulp.batch import make_batched_states as tpulp_make_batched
from tpulp.batch import run_simplex_batch as tpulp_run_batch
from tpulp.batch import solve_lp_batch as tpulp_solve_batch
from tpulp.core.state import SolverOptions as TpulpOptions
from tpulp.solve import solve_lp as tpulp_solve_lp
from tpulp_torch.batch import (make_batched_states, run_simplex_batch,
                               solve_lp_batch, stack_states, unstack_state)
from tpulp_torch.core import SolverOptions, from_numpy_state, to_numpy_state

from test_torch_model import to_port

torch.set_num_threads(1)
pytestmark = pytest.mark.filterwarnings(
    "error:There is a performance drop")


def _textbook():
    lp = LinProg()
    lp.addVar("x1")
    lp.addVar("x2")
    lp.maximize(LinExpr(40, "x1", 30, "x2"))
    lp.addConstraint(LinExpr(1, "x1", 1, "x2").constraintLeq(12))
    lp.addConstraint(LinExpr(2, "x1", 1, "x2").constraintLeq(16))
    return lp


def _beale():
    lp = LinProg()
    for v in ["x4", "x5", "x6", "x7"]:
        lp.addVar(v)
    lp.minimize(LinExpr("-3/4", "x4", 150, "x5", "-1/50", "x6", 6, "x7"))
    lp.addConstraint(LinExpr("1/4", "x4", -60, "x5", "-1/25", "x6", 9, "x7")
                     .constraintLeq(0))
    lp.addConstraint(LinExpr("1/2", "x4", -90, "x5", "-1/50", "x6", 3, "x7")
                     .constraintLeq(0))
    lp.addConstraint(LinExpr(1, "x6").constraintLeq(1))
    return lp


def _infeasible():
    lp = LinProg()
    lp.addVar("x")
    lp.minimize(LinExpr(1, "x"))
    lp.addConstraint(LinExpr(1, "x").constraintLeq(1))
    lp.addConstraint(LinExpr(1, "x").constraintGeq(3))
    return lp


def _unbounded():
    lp = LinProg()
    lp.addVar("x")
    lp.minimize(LinExpr(-1, "x"))
    lp.addConstraint(LinExpr(1, "x").constraintGeq(1))
    return lp


def _random_lp(seed, m=6, n=10):
    """tests/test_batch.py's mixed <=/>= instance."""
    rng = np.random.default_rng(seed)
    A = rng.integers(-4, 5, size=(m, n))
    b = A @ rng.integers(0, 4, size=n)
    c = rng.integers(-5, 6, size=n)
    lp = LinProg()
    for j in range(n):
        lp.addVar(f"x{j}")
    lp.minimize(sum((LinExpr(int(c[j]), f"x{j}") for j in range(n)),
                    LinExpr()))
    for i in range(m):
        e = sum((LinExpr(int(A[i, j]), f"x{j}") for j in range(n)),
                LinExpr())
        lp.addConstraint(e.constraintLeq(int(b[i])) if i % 2
                         else e.constraintGeq(int(b[i])))
    return lp


def _dense_leq_lp(seed, m=12, n=10, b_scale=None, c_override=None):
    """tests/test_warm_start.py's recipe: min c x, A x <= b, x >= 0 with
    A > 0 and c < 0, deterministic from the seed."""
    rng = np.random.default_rng(seed)
    A = np.abs(rng.normal(size=(m, n))) + 0.1
    x0 = np.abs(rng.normal(size=n))
    b = A @ x0 + np.abs(rng.normal(size=m)) + 0.5
    c = -(np.abs(rng.normal(size=n)) + 0.1) if c_override is None \
        else np.asarray(c_override)
    if b_scale is not None:
        b = b * np.asarray(b_scale)
    lp = LinProg()
    for j in range(n):
        lp.addVar(f"x{j}")
    obj = LinExpr()
    for j in range(n):
        obj += LinExpr(float(c[j]), f"x{j}")
    lp.minimize(obj)
    for i in range(m):
        e = LinExpr()
        for j in range(n):
            e += LinExpr(float(A[i, j]), f"x{j}")
        lp.addConstraint(e.constraintLeq(float(b[i])))
    return lp


MIXED = [_textbook, _beale, _infeasible, _unbounded]


def test_make_batched_states_matches_tpulp():
    sfs = [f().lower() for f in MIXED]
    ref, ref_art = tpulp_make_batched(sfs, dtype=jnp.float64,
                                      return_host_art=True)
    out, art = make_batched_states(to_port(sfs), return_host_art=True,
                                   device="cpu")
    for name, r, o in zip(ref._fields, ref, to_numpy_state(out)):
        r = np.asarray(r)
        assert r.dtype == o.dtype and r.shape == o.shape, name
        assert np.array_equal(r, o), name
    assert np.array_equal(art, ref_art)


def test_batched_carry_across_and_lanes():
    """tpulp's batched state (as numpy) becomes the port's, and lanes
    stack and unstack."""
    sfs = [f().lower() for f in MIXED]
    ref = tpulp_make_batched(sfs, dtype=jnp.float64)
    s = from_numpy_state([np.asarray(x) for x in ref], device="cpu")
    assert s.T.shape == ref.T.shape and s.status.shape == (4,)
    lanes = [unstack_state(s, i) for i in range(4)]
    assert lanes[2].T.shape == ref.T.shape[1:]
    back = stack_states(lanes)
    for x, y in zip(s, back):
        assert torch.equal(x, y)


@pytest.mark.parametrize("budget", [2000, 3])
def test_run_simplex_batch_walk_matches_tpulp(budget):
    sfs = [f().lower() for f in MIXED] + [_random_lp(s).lower()
                                          for s in range(4)]
    ref = tpulp_run_batch(tpulp_make_batched(sfs, dtype=jnp.float64),
                          TpulpOptions.for_dtype(jnp.float64,
                                                 max_iters=budget))
    out = run_simplex_batch(make_batched_states(to_port(sfs), device="cpu"),
                            SolverOptions.for_dtype(torch.float64,
                                                    max_iters=budget))
    assert np.array_equal(out.status.numpy(), np.asarray(ref.status))
    assert np.array_equal(out.niter.numpy(), np.asarray(ref.niter))
    assert np.array_equal(out.basis.numpy(), np.asarray(ref.basis))
    np.testing.assert_allclose(out.T.numpy(), np.asarray(ref.T),
                               rtol=0, atol=1e-12 * max(
                                   1.0, float(np.abs(ref.T).max())))
    if budget == 2000:
        assert len(set(out.niter.tolist())) > 1


def _same_solutions(out, ref):
    assert [s.status for s in out] == [s.status for s in ref]
    for o, r in zip(out, ref):
        assert o.objective == r.objective and o.x == r.x
        assert o.niter == r.niter


def test_solve_lp_batch_matches_tpulp():
    progs = [f() for f in MIXED] + [_random_lp(s) for s in range(8)]
    ref = tpulp_solve_batch(progs, refine="exact", max_iters=2000)
    out = solve_lp_batch(to_port(progs), refine="exact", max_iters=2000,
                         device="cpu")
    _same_solutions(out, ref)
    assert out[0].objective == 400 and out[1].objective == F(-1, 20)
    assert [s.status for s in out[:4]] == [
        "optimal", "optimal", "infeasible", "unbounded"]


def test_solve_lp_batch_state_pad_and_trivial_lane():
    bad = LinProg()
    bad.addVar("x", lb=3, ub=1)
    bad.minimize(LinExpr(1, "x"))
    progs = [_textbook(), bad, _beale()]
    ref, rstate, rlanes = tpulp_solve_batch(progs, return_state=True,
                                            pad_to=5)
    out, state, lanes = solve_lp_batch(to_port(progs), return_state=True,
                                       pad_to=5, device="cpu")
    _same_solutions(out, ref)
    assert lanes == rlanes == [0, -1, 1]
    assert state.T.shape == rstate.T.shape and state.T.shape[0] == 5
    none = solve_lp_batch(to_port([_textbook()]), refine="none",
                          device="cpu")[0]
    assert abs(none.objective - 400) < 1e-9


class TestWarmBatch:
    def _scenarios(self, seed=3, k=6):
        base = _dense_leq_lp(seed)
        scens = [_dense_leq_lp(seed, b_scale=1.0 + np.random.default_rng(
            i).uniform(-0.2, 0.1, size=12)) for i in range(k)]
        return base, scens

    def test_warm_wave_matches_tpulp_and_pivots_less(self):
        base, scens = self._scenarios()
        sol_j = tpulp_solve_lp(base)
        sol_t = tpulp_torch.solve_lp(to_port(base), device="cpu")
        assert sol_t.basis == sol_j.basis
        ref = tpulp_solve_batch(scens, warm_start=sol_j)
        out = solve_lp_batch(to_port(scens), warm_start=sol_t, device="cpu")
        _same_solutions(out, ref)
        cold = solve_lp_batch(to_port(scens), device="cpu")
        assert [c.objective for c in cold] == [o.objective for o in out]
        assert sum(o.niter for o in out) < sum(c.niter for c in cold)

    def test_infeasible_lane_confirmed_solo(self):
        def box(lo):
            lp = LinProg()
            lp.addVar("x")
            lp.addVar("y")
            lp.minimize(LinExpr(1, "x", 2, "y"))
            lp.addConstraint(LinExpr(1, "x", 1, "y").constraintLeq(4))
            lp.addConstraint(LinExpr(1, "x", 1, "y").constraintGeq(lo))
            return lp

        sol = tpulp_torch.solve_lp(to_port(box(1)), device="cpu")
        out = solve_lp_batch(to_port([box(2), box(100)]), warm_start=sol,
                             device="cpu")
        assert out[0].status == "optimal" and out[0].objective == 2
        assert out[1].status == "infeasible"

    def test_structure_mismatch_raises(self):
        base, scens = self._scenarios(k=2)
        sol = tpulp_torch.solve_lp(to_port(base), device="cpu")
        scens[1] = _dense_leq_lp(9)
        with pytest.raises(ValueError, match="SAME-STRUCTURE"):
            solve_lp_batch(to_port(scens), warm_start=sol, device="cpu")
        with pytest.raises(ValueError, match="no basis"):
            solve_lp_batch(to_port(scens[:1]), device="cpu",
                           warm_start=tpulp_torch.Solution("infeasible"))


@pytest.mark.parametrize("option", [{"mesh": object()}], ids=["mesh"])
def test_batch_options_not_ported_raise(option):
    """``mesh=`` (ported since; tests/test_torch_mesh_batch.py runs it)
    takes a DeviceMesh and nothing else."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        solve_lp_batch(to_port([_textbook()]), device="cpu", **option)


def _box_lp(seed, nv=6, mc=4):
    """tests/test_bounded.py's random box LP (integer data)."""
    rng = np.random.default_rng(seed)
    lp = LinProg()
    obj = LinExpr()
    for j in range(nv):
        lp.addVar(f"v{j}", lb=0, ub=int(rng.integers(1, 9)))
        obj += LinExpr(int(rng.integers(-9, 10)), f"v{j}")
    lp.maximize(obj)
    for _ in range(mc):
        e = LinExpr()
        for j in range(nv):
            e += LinExpr(int(rng.integers(-3, 6)), f"v{j}")
        lp.addConstraint(e.constraintLeq(int(rng.integers(5, 30))))
    return lp


def _box_mix():
    """Box LPs of different shapes, an infeasible and an unbounded one."""
    bad = LinProg()
    bad.addVar("x", lb=0, ub=5)
    bad.minimize(LinExpr(1, "x"))
    bad.addConstraint(LinExpr(1, "x").constraintGeq(9))
    ray = LinProg()
    ray.addVar("x", lb=0, ub=5)
    ray.addVar("free", lb=0)
    ray.maximize(LinExpr(1, "x", 1, "free"))
    ray.addConstraint(LinExpr(1, "x").constraintLeq(4))
    return ([_box_lp(s) for s in range(6)] + [_box_lp(9, nv=8, mc=5), bad,
                                             ray, _textbook()])


class TestBoundedBatch:
    """``solve_lp_batch(simple_bounds=True)``: the bounded step vmapped over
    lanes of bound-free tableaus, against tpulp's batch lane by lane."""

    def test_batched_bounded_states_match_tpulp(self):
        from tpulp.batch.vmap_driver import \
            make_batched_bounded_states as tpulp_make
        from tpulp_torch.batch import make_batched_bounded_states

        sfs = [lp.lower(simple_bounds=True) for lp in _box_mix()]
        ref = tpulp_make(sfs, dtype=jnp.float64)
        out = make_batched_bounded_states(to_port(sfs), device="cpu")
        for r, o in zip(ref.s, to_numpy_state(out.s)):
            assert np.array_equal(np.asarray(r), o)
        assert np.array_equal(np.asarray(ref.upper), out.upper.numpy())
        assert not out.at_upper.any() and out.gamma is None

    @pytest.mark.parametrize("rule", ["dantzig", "devex"])
    def test_walk_matches_tpulp(self, rule):
        from tpulp.batch.vmap_driver import \
            make_batched_bounded_states as tpulp_make
        from tpulp.core.state import RULE_DEVEX
        from tpulp.solve.bounded import \
            run_simplex_bounded_batch as tpulp_run
        from tpulp_torch.batch import make_batched_bounded_states
        from tpulp_torch.solve import run_simplex_bounded_batch

        r = RULE_DEVEX if rule == "devex" else 0
        sfs = [lp.lower(simple_bounds=True) for lp in _box_mix()]
        ref = tpulp_run(tpulp_make(sfs, dtype=jnp.float64),
                        TpulpOptions.for_dtype(jnp.float64, rule=r,
                                               max_iters=2000))
        out = run_simplex_bounded_batch(
            make_batched_bounded_states(to_port(sfs), device="cpu"),
            SolverOptions.for_dtype(torch.float64, rule=r, max_iters=2000))
        for name in ("status", "niter", "basis"):
            assert np.array_equal(getattr(out.s, name).numpy(),
                                  np.asarray(getattr(ref.s, name))), name
        assert np.array_equal(out.at_upper.numpy(), np.asarray(ref.at_upper))
        assert np.array_equal(out.s.T.numpy(), np.asarray(ref.s.T))
        assert (out.gamma is None) == (rule == "dantzig")

    def test_solve_lp_batch_matches_tpulp(self):
        progs = _box_mix()
        ref = tpulp_solve_batch(progs, simple_bounds=True)
        out = solve_lp_batch(to_port(progs), simple_bounds=True,
                             device="cpu")
        _same_solutions(out, ref)
        assert [s.status for s in out[-4:]] == [
            "optimal", "infeasible", "unbounded", "optimal"]
        # the row-lowered batch reaches the same exact optima
        rows = solve_lp_batch(to_port(progs), device="cpu")
        assert [s.objective for s in rows] == [s.objective for s in out]
        state = solve_lp_batch(to_port(progs), simple_bounds=True,
                               return_state=True, device="cpu")[1]
        # no bound rows: the widest lane keeps its five constraint rows
        assert state.T.shape[1] == 5 + 2

    def test_warm_start_with_simple_bounds_raises(self):
        sol = tpulp_torch.solve_lp(to_port(_box_lp(0)), device="cpu")
        with pytest.raises(ValueError, match="no simple_bounds"):
            solve_lp_batch(to_port([_box_lp(0)]), simple_bounds=True,
                           warm_start=sol, device="cpu")


def _lane(seed, m=12, n=20):
    """tests/test_torch_drivers.py's random instance (a sum row on every
    third seed, so some lanes are bounded and some unbounded) as a
    LinProg."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n))
    x0 = np.abs(rng.normal(size=n))
    b = A @ x0 + np.abs(rng.normal(size=m))
    c = rng.normal(size=n)
    if seed % 3 == 0:
        A[-1] = 1.0
        b[-1] = 2.0 * x0.sum()
    lp = LinProg()
    for j in range(n):
        lp.addVar(f"x{j}")
    lp.minimize(sum((LinExpr(float(c[j]), f"x{j}") for j in range(n)),
                    LinExpr()))
    for i in range(m):
        e = sum((LinExpr(float(A[i, j]), f"x{j}") for j in range(n)),
                LinExpr())
        lp.addConstraint(e.constraintLeq(float(b[i])))
    return lp


class TestBlockedBatch:
    """``solve_lp_batch(driver="blocked")``: the rank-K blocked pivot
    vmapped over the lanes, one batched flush and ray scan per block,
    against tpulp's vmapped blocked driver. Lanes that end at different
    blocks, and budgets inside a block, keep tpulp's walks."""

    @pytest.mark.parametrize("rule", ["dantzig", "devex", "bland"])
    @pytest.mark.parametrize("budget", [2000, 7])
    @pytest.mark.parametrize("block", [4, 8])
    def test_walk_matches_tpulp(self, block, budget, rule):
        from tpulp.core.state import RULE_BLAND, RULE_DEVEX
        from tpulp.solve.blocked import \
            run_simplex_blocked_batch as tpulp_run
        from tpulp_torch.solve import run_simplex_blocked_batch

        r = {"dantzig": 0, "devex": RULE_DEVEX, "bland": RULE_BLAND}[rule]
        sfs = [_lane(s).lower() for s in range(6)] + [
            _lane(6, m=8, n=15).lower()]
        ref = tpulp_run(tpulp_make_batched(sfs, dtype=jnp.float64),
                        TpulpOptions.for_dtype(jnp.float64, rule=r,
                                               max_iters=budget),
                        block=block)
        out = run_simplex_blocked_batch(
            make_batched_states(to_port(sfs), device="cpu"),
            SolverOptions.for_dtype(torch.float64, rule=r, max_iters=budget),
            block=block)
        for name in ("status", "niter", "basis", "phase", "art_cols"):
            assert np.array_equal(getattr(out, name).numpy(),
                                  np.asarray(getattr(ref, name))), name
        np.testing.assert_allclose(out.T.numpy(), np.asarray(ref.T),
                                   rtol=1e-9, atol=1e-9)
        if budget == 2000:
            assert len(set(out.niter.tolist())) > 1
            assert {1, 2} <= set(out.status.tolist())

    def test_finished_lane_keeps_its_state(self):
        """A lane that ended in an earlier block is not touched by a later
        one: its tableau and counters are those it ended with."""
        from tpulp_torch.solve import run_simplex_blocked_batch

        start = make_batched_states(
            to_port([_lane(0).lower(), _lane(1).lower()]), device="cpu")
        opts = SolverOptions.for_dtype(torch.float64, max_iters=2000)
        both = run_simplex_blocked_batch(start, opts, block=4)
        assert int(both.niter[0]) // 4 != int(both.niter[1]) // 4
        for k in range(2):
            alone = run_simplex_blocked_batch(
                stack_states([unstack_state(start, k)]), opts, block=4)
            for name in alone._fields:
                a, b = getattr(alone, name)[0], getattr(both, name)[k]
                if a.is_floating_point():
                    # bit for bit: a flush of zeros would turn -0.0 into 0.0
                    a, b = a.view(torch.int64), b.view(torch.int64)
                assert torch.equal(a, b), name

    def test_solve_lp_batch_matches_tpulp(self):
        progs = [_lane(s) for s in range(6)] + [_textbook(), _infeasible()]
        ref = tpulp_solve_batch(progs, driver="blocked", block=8)
        out = solve_lp_batch(to_port(progs), driver="blocked", block=8,
                             device="cpu")
        _same_solutions(out, ref)
        solo = [tpulp_torch.solve_lp(p, driver="blocked", block=8,
                                     device="cpu")
                for p in to_port(progs[:6])]
        assert [s.objective for s in out[:6]] == [s.objective for s in solo]

    def test_unknown_driver_raises(self):
        with pytest.raises(ValueError, match="unknown batch driver"):
            solve_lp_batch(to_port([_textbook()]), driver="pallas",
                           device="cpu")


def test_batch_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        solve_lp_batch(to_port([_textbook()]))


class TestSolveLpWarmStart:
    """``solve_lp(warm_start=...)`` against tpulp's: the same pivot counts
    and exact objectives."""

    def _pair(self, lp2, lp1):
        sol_j = tpulp_solve_lp(lp1)
        sol_t = tpulp_torch.solve_lp(to_port(lp1), device="cpu")
        assert sol_t.basis == sol_j.basis
        ref = tpulp_solve_lp(lp2, warm_start=sol_j)
        out = tpulp_torch.solve_lp(to_port(lp2), warm_start=sol_t,
                                   device="cpu")
        assert out.status == ref.status
        assert out.objective == ref.objective and out.niter == ref.niter
        return out

    @pytest.mark.parametrize("seed", [0, 3])
    def test_same_data_takes_zero_pivots(self, seed):
        out = self._pair(_dense_leq_lp(seed), _dense_leq_lp(seed))
        assert out.niter == 0

    @pytest.mark.parametrize("seed", [1, 2])
    def test_rhs_change_reoptimizes_with_fewer_pivots(self, seed):
        scale = np.ones(12)
        scale[:3] = 0.8
        lp2 = _dense_leq_lp(seed, b_scale=scale)
        out = self._pair(lp2, _dense_leq_lp(seed))
        cold = tpulp_torch.solve_lp(to_port(lp2), device="cpu")
        assert out.objective == cold.objective
        assert out.niter < max(cold.niter, 2)

    def test_objective_change_continues_primal(self):
        c2 = -(np.abs(np.random.default_rng(99).normal(size=10)) + 0.1)
        out = self._pair(_dense_leq_lp(4, c_override=c2), _dense_leq_lp(4))
        assert out.status == "optimal"

    @pytest.mark.parametrize("seed", range(4))
    def test_randomized_warm_cold_parity(self, seed):
        rng = np.random.default_rng(1000 + seed)
        m, n = int(rng.integers(6, 16)), int(rng.integers(5, 12))
        b_scale = 1.0 + rng.uniform(-0.3, 0.2, size=m)
        c2 = -(np.abs(rng.normal(size=n)) + 0.1) if rng.random() < 0.5 \
            else None
        lp2 = _dense_leq_lp(seed, m=m, n=n, b_scale=b_scale, c_override=c2)
        out = self._pair(lp2, _dense_leq_lp(seed, m=m, n=n))
        cold = tpulp_torch.solve_lp(to_port(lp2), device="cpu")
        assert out.status == cold.status
        assert out.objective == cold.objective

    def test_infeasible_after_tightening(self):
        def lp(rhs):
            p = LinProg()
            p.addVar("x")
            p.addVar("y")
            p.minimize(LinExpr(-1, "x"))
            p.addConstraint(LinExpr(1, "x", 1, "y").constraintLeq(rhs))
            return p

        out = self._pair(lp(-1), lp(4))
        assert out.status == "infeasible"

    def test_garbage_basis_falls_back_to_cold(self):
        lp = _dense_leq_lp(5)
        cold = tpulp_torch.solve_lp(to_port(lp), device="cpu")
        fake = tpulp_torch.Solution(status="optimal", basis=[0] * 12)
        warm = tpulp_torch.solve_lp(to_port(lp), warm_start=fake, device="cpu")
        assert warm.status == "optimal"
        assert warm.objective == cold.objective and warm.niter == cold.niter

    def test_bad_warm_starts_raise(self):
        sol = tpulp_torch.solve_lp(to_port(_dense_leq_lp(0)), device="cpu")
        with pytest.raises(ValueError, match="warm_basis"):
            tpulp_torch.solve_lp(to_port(_dense_leq_lp(0, m=8, n=6)),
                                 warm_start=sol, device="cpu")
        with pytest.raises(ValueError, match="no basis"):
            tpulp_torch.solve_lp(to_port(
                _dense_leq_lp(0)), device="cpu",
                warm_start=tpulp_torch.Solution(status="infeasible"))


def test_warm_frame_check_uses_the_scaled_state():
    """An ill-scaled program (equilibrated on the device) warm-starts from
    its own basis in zero pivots."""
    lp = LinProg()
    lp.addVar("x")
    lp.addVar("y")
    lp.maximize(LinExpr(1000, "x", 3, "y"))
    lp.addConstraint(LinExpr(4000, "x", 1, "y").constraintLeq(8000))
    lp.addConstraint(LinExpr(1, "x", "1/500", "y").constraintLeq(7))
    sol = tpulp_torch.solve_lp(to_port(lp), device="cpu")
    warm = tpulp_torch.solve_lp(to_port(lp), warm_start=sol, device="cpu")
    assert warm.status == sol.status == "optimal"
    assert warm.objective == sol.objective and warm.niter == 0
