"""tpulp_torch's form predicates and debug driver against tpulp's, at
float64 on the same numpy-seeded states: every predicate's verdict, every
``IterationRecord`` of ``run_simplex_debug``, the violations it reports,
and the ``InvariantViolation`` a corrupted state raises in both."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulp import LinExpr, LinProg
from tpulp.core import make_state as tpulp_make_state
from tpulp.core import predicates as tp_pred
from tpulp.core.state import SolverOptions as TpulpOptions
from tpulp.solve.driver import simplex_step as tpulp_step
from tpulp.utils.debug import InvariantViolation as TpulpViolation
from tpulp.utils.debug import run_simplex_debug as tpulp_debug
from tpulp_torch.core import SolverOptions, from_numpy_state, make_state
from tpulp_torch.core import predicates as pred
from tpulp_torch.utils import InvariantViolation, run_simplex_debug

torch.set_num_threads(1)

PREDICATES = ["is_optimal", "is_unbounded", "is_infeasible_form",
              "is_degenerate", "is_canonical"]


def textbook():
    lp = LinProg()
    lp.addVar("x1")
    lp.addVar("x2")
    lp.maximize(LinExpr(40, "x1", 30, "x2"))
    lp.addConstraint(LinExpr(1, "x1", 1, "x2").constraintLeq(12))
    lp.addConstraint(LinExpr(2, "x1", 1, "x2").constraintLeq(16))
    sf = lp.lower()
    c, A, b = sf.to_dense(np.float64)
    return c, A, b, list(sf.basis_hint)


def random_arrays(seed, m=10, n=16, degenerate=False):
    """bench.py's recipe (b = |A x0| + |N(0, 1)|, a sum row; a third of b
    zero when ``degenerate``), slack basis."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n))
    x0 = np.abs(rng.normal(size=n))
    b = np.abs(A @ x0) + np.abs(rng.normal(size=m))
    if degenerate:
        b[: m // 3] = 0.0
        A[: m // 3] = np.abs(A[: m // 3])
    c = rng.normal(size=n)
    A[-1] = 1.0
    b[-1] = 2.0 * x0.sum()
    return (np.concatenate([c, np.zeros(m)]),
            np.concatenate([A, np.eye(m)], axis=1), b,
            list(range(n, n + m)))


INSTANCES = {"textbook": textbook, "seed1": lambda: random_arrays(1),
             "seed2": lambda: random_arrays(2),
             "degenerate": lambda: random_arrays(3, degenerate=True)}


def both_states(arrays, steps=0):
    """tpulp's state after ``steps`` of its simplex_step, and the port's
    copy of it."""
    st = tpulp_make_state(*arrays, dtype=jnp.float64)
    opts = TpulpOptions.for_dtype(jnp.float64)
    stall = opts.resolved_stall_limit(st.m, st.n)
    for _ in range(steps):
        st = tpulp_step(st, opts, stall)
    return st, from_numpy_state([np.asarray(x) for x in st], device="cpu")


def corrupted(arrays):
    """The initial state with a basic column made non-unit (an entry of 0.5
    off its row): not canonical from the start."""
    c, A, b, hint = arrays
    A = np.array(A, dtype=np.float64)
    A[0, hint[-1]] = 0.5
    return c, A, b, hint


@pytest.mark.parametrize("name", sorted(INSTANCES))
@pytest.mark.parametrize("steps", [0, 3, 40])
@pytest.mark.parametrize("predicate", PREDICATES)
def test_predicates_equal_tpulps(name, steps, predicate):
    tp, port = both_states(INSTANCES[name](), steps)
    for tol in (1e-9, 1e-3):
        want = bool(getattr(tp_pred, predicate)(tp, tol=tol))
        got = getattr(pred, predicate)(port, tol=tol)
        assert got.dtype == torch.bool and got.dim() == 0
        assert bool(got) == want, (name, steps, predicate, tol)


def test_predicates_see_the_corruption():
    tp, port = both_states(corrupted(random_arrays(1)))
    assert not bool(tp_pred.is_canonical(tp))
    assert not bool(pred.is_canonical(port))


def _records(report):
    return [dataclasses.asdict(r) for r in report.records]


@pytest.mark.parametrize("name", sorted(INSTANCES))
@pytest.mark.parametrize("check_every", [1, 4])
def test_debug_records_equal_tpulps(name, check_every):
    arrays = INSTANCES[name]()
    tp_state, tp_rep = tpulp_debug(
        tpulp_make_state(*arrays, dtype=jnp.float64),
        check_every=check_every)
    state, rep = run_simplex_debug(
        make_state(*arrays, dtype=torch.float64, device="cpu"),
        check_every=check_every)
    assert rep.status == tp_rep.status == "optimal"
    assert _records(rep) == _records(tp_rep)
    assert rep.violations == tp_rep.violations == []
    assert rep.num_pivots == tp_rep.num_pivots == int(state.niter)
    assert torch.equal(state.T, torch.tensor(np.asarray(tp_state.T)))


def test_debug_budget_and_max_steps():
    arrays = random_arrays(2)
    opts = SolverOptions.for_dtype(torch.float64, max_iters=5)
    tp_opts = TpulpOptions.for_dtype(jnp.float64, max_iters=5)
    for kw in ({"max_steps": 3}, {}):
        _, tp_rep = tpulp_debug(tpulp_make_state(*arrays, dtype=jnp.float64),
                                tp_opts, **kw)
        _, rep = run_simplex_debug(
            make_state(*arrays, dtype=torch.float64, device="cpu"), opts,
            **kw)
        assert _records(rep) == _records(tp_rep)
        assert rep.status == tp_rep.status


def test_corrupted_state_raises_in_both():
    arrays = corrupted(random_arrays(1))
    with pytest.raises(TpulpViolation) as tp_err:
        tpulp_debug(tpulp_make_state(*arrays, dtype=jnp.float64))
    with pytest.raises(InvariantViolation) as err:
        run_simplex_debug(make_state(*arrays, dtype=torch.float64,
                                     device="cpu"))
    assert str(err.value) == str(tp_err.value)
    assert "not canonical" in str(err.value)
    # reported instead of raised: the same list of violations
    _, tp_rep = tpulp_debug(tpulp_make_state(*arrays, dtype=jnp.float64),
                            raise_on_violation=False, max_steps=6)
    _, rep = run_simplex_debug(
        make_state(*arrays, dtype=torch.float64, device="cpu"),
        raise_on_violation=False, max_steps=6)
    assert rep.violations == tp_rep.violations != []
    assert _records(rep) == _records(tp_rep)
    assert issubclass(InvariantViolation, AssertionError)

