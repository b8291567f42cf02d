"""tpulp_torch.solve.dual against tpulp.solve.dual at float64: reconstructed
warm frames (within 1e-10 of the largest entry), dual-simplex walks (the
same status, pivot count and basis) and the batched warm wave."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulp.core import make_state as tpulp_make_state
from tpulp.core.state import SolverOptions as TpulpOptions
from tpulp.solve import run_simplex as tpulp_run_simplex
from tpulp.solve import dual as tdual
from tpulp_torch.core import SolverOptions, Status, from_numpy_state
from tpulp_torch.solve import dual

torch.set_num_threads(1)
# torch.func.vmap must never fall back to its per-sample loop
pytestmark = pytest.mark.filterwarnings(
    "error:There is a performance drop")


def _random(seed, m=12, n=10):
    """tests/test_dual.py's bounded instance: (c, A, b, hint)."""
    rng = np.random.default_rng(seed)
    D = rng.normal(size=(m, n))
    x0 = np.abs(rng.normal(size=n))
    b = np.abs(D @ x0) + np.abs(rng.normal(size=m))
    c = rng.normal(size=n)
    D[-1] = 1.0
    b[-1] = 2.0 * x0.sum()
    A = np.concatenate([D, np.eye(m)], axis=1)
    return np.concatenate([c, np.zeros(m)]), A, b, list(range(n, n + m))


def _opts(**kw):
    return (TpulpOptions.for_dtype(jnp.float64, max_iters=500, **kw),
            SolverOptions.for_dtype(torch.float64, max_iters=500, **kw))


def _root(seed, m=12, n=10):
    """(A, b, the optimal basis, and the root frame of both packages as
    (A_aug, c_full, col_active, art_cols))."""
    c, A, b, hint = _random(seed, m, n)
    js = tpulp_make_state(c, A, b, hint, dtype=jnp.float64)
    out = tpulp_run_simplex(js, _opts()[0])
    assert int(out.status) == Status.OPTIMAL
    ts = from_numpy_state([np.asarray(x) for x in js], device="cpu")
    jframe = (js.T[2:, :-1], js.T[0, :-1], js.col_active, js.art_cols)
    tframe = (ts.T[2:, :-1], ts.T[0, :-1], ts.col_active, ts.art_cols)
    return A, b, np.asarray(out.basis), jframe, tframe


def _close(a, b, rtol):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(float(np.abs(b[np.isfinite(b)]).max(initial=1.0)), 1.0)
    assert np.array_equal(np.isfinite(a), np.isfinite(b))
    fin = np.isfinite(b)
    assert np.abs(a[fin] - b[fin]).max(initial=0.0) <= rtol * scale


def _same_walk(out, ref, rtol=1e-12):
    assert np.array_equal(np.asarray(out.status), np.asarray(ref.status))
    assert np.array_equal(np.asarray(out.niter), np.asarray(ref.niter))
    assert np.array_equal(out.basis.numpy(), np.asarray(ref.basis))
    _close(out.T.numpy(), np.asarray(ref.T), rtol)


def _tightened(A, b, basis, seed, rows=3):
    """The RHS with ``rows`` rows whose slack is basic at the optimum cut
    past the optimal vertex (slack -> -0.2 to -1 times itself): the warm
    frame is then dual but not primal feasible, the shape of a
    branch-and-bound child, and the dual simplex has to pivot."""
    rng = np.random.default_rng(100 + seed)
    n = A.shape[1] - len(b)  # the slack columns come last
    x_b = np.linalg.solve(A[:, basis], b)
    slack_at = {int(j) - n: r for r, j in enumerate(basis) if j >= n}
    cut = rng.choice(sorted(slack_at), size=min(rows, len(slack_at)),
                     replace=False)
    b2 = b.copy()
    for i in cut:
        b2[i] -= rng.uniform(1.2, 2.0) * x_b[slack_at[i]]
    return b2


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_reconstructed_frame_matches_tpulp(seed):
    A, b, basis, jf, tf = _root(seed)
    b2 = _tightened(A, b, basis, seed)
    ref = tdual.warm_state_from_basis(*jf, basis, jnp.asarray(b2))
    out = dual.warm_state_from_basis(*tf, basis, b2)
    _close(out.T.numpy(), np.asarray(ref.T), 1e-10)
    for name in ("basis", "col_active", "art_cols", "phase", "status",
                 "niter", "stuck", "bland", "last_z"):
        assert np.array_equal(getattr(out, name).numpy(),
                              np.asarray(getattr(ref, name))), name


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_dual_walk_matches_tpulp(seed):
    A, b, basis, jf, tf = _root(seed)
    b2 = _tightened(A, b, basis, seed)
    jo, to = _opts()
    ref = tdual.run_dual_simplex(
        tdual.warm_state_from_basis(*jf, basis, jnp.asarray(b2)), jo)
    out = dual.run_dual_simplex(
        dual.warm_state_from_basis(*tf, basis, b2), to)
    _same_walk(out, ref, rtol=1e-10)
    assert int(out.niter) > 0


@pytest.mark.parametrize("stall_limit", [1, 2])
def test_bland_switch_walk_matches_tpulp(stall_limit):
    """A stall limit this low turns the first-negative leaving rule on."""
    A, b, basis, jf, tf = _root(7, m=16, n=12)
    b2 = _tightened(A, b, basis, 7, rows=6)
    jo, to = _opts(stall_limit=stall_limit, degen_tol=1e300)
    ref = tdual.run_dual_simplex(
        tdual.warm_state_from_basis(*jf, basis, jnp.asarray(b2)), jo)
    out = dual.run_dual_simplex(
        dual.warm_state_from_basis(*tf, basis, b2), to)
    _same_walk(out, ref, rtol=1e-10)
    assert bool(out.bland)


def test_budget_is_exact():
    A, b, basis, jf, tf = _root(2)
    b2 = _tightened(A, b, basis, 2, rows=6)
    jo, to = _opts()
    jo = dataclasses.replace(jo, max_iters=2)
    to = dataclasses.replace(to, max_iters=2)
    ref = tdual.run_dual_simplex(
        tdual.warm_state_from_basis(*jf, basis, jnp.asarray(b2)), jo)
    out = dual.run_dual_simplex(
        dual.warm_state_from_basis(*tf, basis, b2), to)
    assert int(out.status) == int(ref.status) == Status.ITERATION_LIMIT
    _same_walk(out, ref, rtol=1e-10)


def test_infeasible_child_detected_like_tpulp():
    A = np.array([[1.0, 1.0, 0.0], [1.0, 0.0, 1.0]])
    c = np.array([-1.0, 0.0, 0.0])
    js = tpulp_make_state(c, A, np.array([4.0, 6.0]), [1, 2],
                          dtype=jnp.float64)
    basis = np.asarray(tpulp_run_simplex(js, _opts()[0]).basis)
    ts = from_numpy_state([np.asarray(x) for x in js], device="cpu")
    b2 = np.array([-1.0, 6.0])
    ref = tdual.run_dual_simplex(tdual.warm_state_from_basis(
        js.T[2:, :-1], js.T[0, :-1], js.col_active, js.art_cols, basis,
        jnp.asarray(b2)))
    out = dual.run_dual_simplex(dual.warm_state_from_basis(
        ts.T[2:, :-1], ts.T[0, :-1], ts.col_active, ts.art_cols, basis,
        b2))
    assert int(out.status) == int(ref.status) == Status.INFEASIBLE
    _same_walk(out, ref)


def test_singular_basis_gives_a_non_finite_frame():
    """A basis naming one slack column twice is exactly singular."""
    A, b, basis, jf, tf = _root(0)
    m = len(b)
    bad = np.arange(10, 10 + m, dtype=np.int32)
    bad[1] = bad[0]
    ref = tdual.warm_state_from_basis(*jf, bad, jnp.asarray(b))
    out = dual.warm_state_from_basis(*tf, bad, b)
    assert not bool(jnp.all(jnp.isfinite(ref.T)))
    assert not bool(torch.isfinite(out.T).all())


@pytest.mark.parametrize("seed", [7, 8])
def test_run_warm_batch_matches_tpulp(seed):
    A, b, basis, jf, tf = _root(seed, m=10, n=8)
    rng = np.random.default_rng(11 + seed)
    B = 8
    b_mat = np.tile(b, (B, 1))
    for k in range(B):
        b_mat[k, rng.integers(0, len(b))] *= rng.uniform(0.3, 0.95)
    basis_mat = np.tile(basis, (B, 1))
    jo, to = _opts()
    ref = tdual.run_warm_batch(*jf, basis_mat, b_mat, jo)
    out = dual.run_warm_batch(*tf, basis_mat, b_mat, to)
    _same_walk(out, ref, rtol=1e-10)
    assert len(set(out.niter.tolist())) > 1  # lanes froze independently
