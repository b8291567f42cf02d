"""The lanes' simplex loops (``tpulp_torch.solve.lanes``) against tpulp's
vmapped ``lax.while_loop`` at float64, bit for bit.

On CPU tensors ``dual_lanes`` / ``primal_lanes`` run the plain loops; the
lane kernels of ``kernels/lanes.py`` run on the card only
(tests/test_torch_lanes_card.py, and chip_smoke.py's phase 7d). Every comparison is exact:
``T + 0.0`` (the plain loops step finished lanes with the no-op unit
pivot, which may turn a -0.0 into +0.0), the basis, the masks and every
scalar, NaN equal to NaN. The cases: cold phase-1 batches with artificial
clean-up and a retire under every pricing rule and tie break, lanes that
exit at different steps, the iteration budget, a low stall limit (the
Bland switch), a NaN lane and an overflowing |b| sum (NUMERIC), broadcast
and contiguous masks; the wave entries (``run_warm_batch``,
``run_warm_carry_batch``, ``run_warm_wave``, ``run_expand_generation``,
``run_simplex_batch``) and the ``("batch",)`` mesh's lane loops, which
all go through them; and the kernels' launch plan."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from tpulp.core.state import SimplexState as JState
from tpulp.core.state import SolverOptions as JOptions
from tpulp.solve import dual as jdual
from tpulp.solve.driver import simplex_step as j_simplex_step
from tpulp_torch.batch import run_simplex_batch
from tpulp_torch.core import SolverOptions, Status
from tpulp_torch.core.state import (RULE_BLAND, RULE_DANTZIG, RULE_DEVEX,
                                    RULE_MAX_INCREASE, TIE_FIRST, TIE_MAXPIV,
                                    SimplexState, _numpy_state)
from tpulp_torch.kernels import LAUNCHES, lane_dual, lane_dual_plan, \
    lane_plan, reset_launches
from tpulp_torch.kernels.lanes import LANE_SMEM_LIMIT
from tpulp_torch.shard.sharded_batch import LaneMesh
from tpulp_torch.solve import dual, lanes
from tpulp_torch.solve.driver import simplex_step as one_step

from test_torch_dual import _root, _tightened
from test_torch_waves import B, CAP, _gen_meta, _Wave

torch.set_num_threads(1)
pytestmark = pytest.mark.filterwarnings(
    "error:There is a performance drop")

KINDS = (np.float64, np.int32, bool, bool, np.int32, np.int32, np.int32,
         np.int32, bool, np.float64)
TKINDS = (torch.float64, torch.int32, torch.bool, torch.bool, torch.int32,
          torch.int32, torch.int32, torch.int32, torch.bool, torch.float64)
FIELDS = ("basis", "col_active", "art_cols", "phase", "status", "niter",
          "stuck", "bland", "last_z")


def _pair(leaves):
    """The same batched state (numpy leaves in SimplexState order) in both
    packages."""
    leaves = [np.asarray(x, dtype=k) for x, k in zip(leaves, KINDS)]
    return (JState(*(jnp.asarray(x) for x in leaves)),
            SimplexState(*(torch.tensor(x, dtype=k)
                           for x, k in zip(leaves, TKINDS))))


def _same(out, ref):
    """Bit for bit: T + 0.0 (NaN equal to NaN) and every other field."""
    a = out.T.numpy() + 0.0
    b = np.asarray(ref.T) + 0.0
    assert a.shape == b.shape
    nan = np.isnan(a)
    assert np.array_equal(nan, np.isnan(b))
    assert np.array_equal(np.where(nan, 0.0, a).view(np.int64),
                          np.where(nan, 0.0, b).view(np.int64))
    for name in FIELDS:
        x = getattr(out, name).numpy()
        y = np.asarray(getattr(ref, name))
        assert np.array_equal(x, y, equal_nan=x.dtype.kind == "f"), name


def _jax_loop(step, opts, stall_limit, max_iters):
    """tpulp's lane loop: ``lax.while_loop`` of one step, vmapped."""
    def one(s):
        return lax.while_loop(
            lambda s: (s.status == Status.RUNNING) & (s.niter < max_iters),
            lambda s: step(s, opts, stall_limit), s)
    return jax.jit(jax.vmap(one))


def _opts(**kw):
    return (JOptions.for_dtype(jnp.float64, **kw),
            SolverOptions.for_dtype(torch.float64, **kw))


# ---------------------------------------------------------------------------
# cold phase-1 batches: the primal loop
# ---------------------------------------------------------------------------

def _cold_leaves(seed, lanes=6, m0=6, n0=8):
    """Batched phase-1 states of small integer LPs (every row artificial):
    ties in pricing and ratios, a redundant row (its artificial stays basic
    at zero and is retired in phase 2), an infeasible lane, an unbounded
    lane, and from lane 3 on mixed-sign rows at a sparse vertex, where
    phase 2 starts with artificials basic at zero that the clean-up pivots
    out."""
    rng = np.random.default_rng(seed)
    rows = []
    for lane in range(lanes):
        mixed = lane >= 3
        A = rng.integers(-2 if mixed else 0, 4, size=(m0, n0)).astype(float)
        x0 = rng.integers(0, 3, size=n0).astype(float)
        if mixed:
            x0[rng.random(n0) < 0.5] = 0.0
            A[A @ x0 < 0] *= -1.0
        else:
            A[-1] = A[0] + A[1]
        b = A @ x0
        c = rng.integers(-5, 5, size=n0).astype(float)
        if lane == 1:          # inconsistent rows: phase 1 ends above 0
            A[1] = 2 * A[0]
            b[1] = 2 * b[0] + 1
            A[-1] = A[0] + A[1]
            b[-1] = b[0] + b[1]
        if lane == 2:          # an improving column with no positive entry
            A[:, 3] = 0.0
            c[3] = -1.0
        T, basis, act, art, phase = _numpy_state(c, A, b, [-1] * m0, 0)
        rows.append((T, basis, act, art, phase, Status.RUNNING, 0, 0,
                     False, np.inf))
    return [np.stack([r[k] for r in rows]) for k in range(10)]


PRIMAL_CASES = {
    "dantzig": dict(rule=RULE_DANTZIG),
    "bland": dict(rule=RULE_BLAND),
    "max_increase": dict(rule=RULE_MAX_INCREASE),
    "max_increase_maxpiv": dict(rule=RULE_MAX_INCREASE, tie_break=TIE_MAXPIV),
    "dantzig_maxpiv": dict(rule=RULE_DANTZIG, tie_break=TIE_MAXPIV),
    "devex": dict(rule=RULE_DEVEX, tie_break=TIE_FIRST),
    "stall_bland_switch": dict(stall_limit=2, degen_tol=1e300),
    "stall_maxpiv": dict(stall_limit=1, degen_tol=1e300,
                         tie_break=TIE_MAXPIV),
    "budget": dict(max_iters=3),
}


@pytest.mark.parametrize("case", PRIMAL_CASES)
def test_primal_lanes_match_tpulp(case):
    kw = dict(max_iters=200)
    kw.update(PRIMAL_CASES[case])
    jo, to = _opts(**kw)
    js, ts = _pair(_cold_leaves(10))
    stall = to.resolved_stall_limit(ts.T.shape[1] - 2, ts.T.shape[2] - 1)
    ref = _jax_loop(j_simplex_step, jo, stall, to.max_iters)(js)
    out = lanes.primal_lanes(ts, to, stall, to.max_iters)
    _same(out, ref)
    st = set(out.status.tolist())
    if case == "budget":
        assert Status.RUNNING in st and int(out.niter.max()) == 3
    else:
        # lanes end at different steps, with different verdicts
        assert {Status.OPTIMAL, Status.INFEASIBLE, Status.UNBOUNDED} <= st
        assert len(set(out.niter.tolist())) > 2
    if case.startswith("stall"):
        assert bool(out.bland.any())


def test_cold_batch_cleans_up_and_retires():
    """The cold batch exercises the phase-2 clean-up: stepping each lane
    alone, some steps pivot a basic artificial out and some retire one
    (its row has no eligible entry); the batched loop agrees with
    tpulp's."""
    jo, to = _opts(max_iters=200)
    js, ts = _pair(_cold_leaves(10))
    stall = to.resolved_stall_limit(ts.T.shape[1] - 2, ts.T.shape[2] - 1)
    out = lanes.primal_lanes(ts, to, stall, to.max_iters)
    _same(out, _jax_loop(j_simplex_step, jo, stall, to.max_iters)(js))
    pivots = retires = 0
    for lane in range(ts.T.shape[0]):
        s = SimplexState(*(x[lane] for x in ts))
        while int(s.status) == Status.RUNNING:
            cleanup = bool(s.art_cols[s.basis.long()].any()) \
                and int(s.phase) == 2
            nxt = one_step(s, to, stall)
            pivots += cleanup and int(nxt.niter) > int(s.niter)
            retires += cleanup and bool((s.art_cols & ~nxt.art_cols).any())
            s = nxt
        assert torch.equal(s.niter, out.niter[lane])
    assert pivots > 0 and retires > 0


def test_primal_lanes_numeric_lanes():
    """A NaN in one lane's b and an overflowing |b| sum in another: both
    NUMERIC at once; the other lanes walk on."""
    leaves = _cold_leaves(5)
    T = leaves[0]
    T[0, 3, -1] = np.nan
    T[0, 1, -1] = np.nan   # the phase-1 row sums b
    T[4, 3:5, -1] = 1.5e308
    T[4, 1, -1] = -np.inf
    jo, to = _opts(max_iters=200)
    js, ts = _pair(leaves)
    stall = to.resolved_stall_limit(T.shape[1] - 2, T.shape[2] - 1)
    out = lanes.primal_lanes(ts, to, stall, to.max_iters)
    _same(out, _jax_loop(j_simplex_step, jo, stall, to.max_iters)(js))
    assert int(out.status[0]) == int(out.status[4]) == Status.NUMERIC
    assert int(out.status[3]) != Status.NUMERIC


def test_run_simplex_batch_goes_through_primal_lanes():
    jo, to = _opts(max_iters=200, rule=RULE_MAX_INCREASE)
    js, ts = _pair(_cold_leaves(7))
    stall = to.resolved_stall_limit(ts.T.shape[1] - 2, ts.T.shape[2] - 1)
    ref = _jax_loop(j_simplex_step, jo, stall, to.max_iters)(js)
    ref = ref._replace(status=jnp.where(ref.status == Status.RUNNING,
                                        Status.ITERATION_LIMIT, ref.status))
    _same(run_simplex_batch(ts, to), ref)


# ---------------------------------------------------------------------------
# warm frames: the dual loop
# ---------------------------------------------------------------------------

def _dual_leaves(numeric=False):
    """Eight lanes of one root's warm frames for different tightened RHS
    (some lanes already optimal, some infeasible); with ``numeric`` lane 6
    gets a NaN in b and lane 7 an |b| sum that overflows."""
    A, b, basis, jf, _ = _root(2, m=14, n=12)
    lanes_ = []
    for k in range(8):
        b2 = b if k == 0 else _tightened(A, b, basis, 10 + k, rows=1 + k % 5)
        if k == 5:
            b2 = b2.copy()
            b2[:] = b2 - 50.0 * np.abs(b2)     # far past the region
        st = jdual.warm_state_from_basis(*jf, basis, jnp.asarray(b2))
        lanes_.append([np.asarray(x) for x in st])
    leaves = [np.stack([ln[k] for ln in lanes_]) for k in range(10)]
    if numeric:
        leaves[0][6, 4, -1] = np.nan
        leaves[0][7, 3:5, -1] = 1.5e308
    return leaves


DUAL_CASES = {
    "plain": dict(),
    "stall_bland_switch": dict(stall_limit=1, degen_tol=1e300),
    "budget": dict(max_iters=2),
}


@pytest.mark.parametrize("case", DUAL_CASES)
def test_dual_lanes_match_tpulp(case):
    kw = dict(max_iters=300)
    kw.update(DUAL_CASES[case])
    jo, to = _opts(**kw)
    js, ts = _pair(_dual_leaves())
    stall = to.resolved_stall_limit(ts.T.shape[1] - 2, ts.T.shape[2] - 1)
    ref = _jax_loop(jdual.dual_simplex_step, jo, stall, to.max_iters)(js)
    out = lanes.dual_lanes(ts, to, stall, to.max_iters)
    _same(out, ref)
    st = out.status.tolist()
    if case == "budget":
        assert Status.RUNNING in st
    else:
        assert Status.OPTIMAL in st and Status.INFEASIBLE in st
        assert int(out.niter[0]) == 0 and int(out.niter.max()) > 2
    if case.startswith("stall"):
        assert bool(out.bland.any())


def test_dual_lanes_numeric_lanes():
    jo, to = _opts(max_iters=300)
    js, ts = _pair(_dual_leaves(numeric=True))
    stall = to.resolved_stall_limit(ts.T.shape[1] - 2, ts.T.shape[2] - 1)
    out = lanes.dual_lanes(ts, to, stall, to.max_iters)
    _same(out, _jax_loop(jdual.dual_simplex_step, jo, stall,
                         to.max_iters)(js))
    assert out.status[6:].tolist() == [Status.NUMERIC] * 2
    assert Status.NUMERIC not in out.status[:6].tolist()


def test_broadcast_masks_equal_contiguous_masks():
    """The waves' masks are one row broadcast to every lane (lane stride
    0); the loops give the same lanes as with contiguous copies."""
    _, to = _opts(max_iters=300)
    _, ts = _pair(_dual_leaves())
    wide = ts._replace(col_active=ts.col_active[0].expand(8, -1),
                       art_cols=ts.art_cols[0].expand(8, -1))
    assert wide.col_active.stride(0) == 0
    stall = to.resolved_stall_limit(ts.T.shape[1] - 2, ts.T.shape[2] - 1)
    for fn in (lanes.dual_lanes, lanes.primal_lanes):
        a = fn(wide, to, stall, to.max_iters)
        b = fn(ts, to, stall, to.max_iters)
        _same(a, SimplexState(*(x.numpy() for x in b)))


def test_run_warm_batch_bit_for_bit():
    """``run_warm_batch``: the frames of six bases' RHS, then the dual loop
    and the primal clean-up (``_dual_then_primal``)."""
    A, b, basis, jf, tf = _root(2, m=14, n=12)
    b_mat = np.stack([_tightened(A, b, basis, 20 + k, rows=1 + k % 4)
                      for k in range(6)])
    basis_mat = np.stack([basis] * 6)
    jo, to = _opts(max_iters=300)
    ref = jdual.run_warm_batch(*jf, basis_mat, b_mat, jo)
    out = dual.run_warm_batch(*tf, basis_mat, b_mat, to)
    # the frames' linear solve is each package's LAPACK: the walks are the
    # same, the tableaus agree to rounding
    for name in ("basis", "status", "niter"):
        assert np.array_equal(getattr(out, name).numpy(),
                              np.asarray(getattr(ref, name))), name
    np.testing.assert_allclose(out.T.numpy(), np.asarray(ref.T), rtol=0,
                               atol=1e-12 * np.abs(np.asarray(ref.T)).max())
    assert int(out.niter.sum()) > 0
    # the loops bit for bit, from tpulp's own frames
    frames = jax.jit(jax.vmap(lambda bs, bv: jdual._reconstruct(
        *jf, bs, bv)))(jnp.asarray(basis_mat, jnp.int32), jnp.asarray(b_mat))
    _, ts = _pair([np.asarray(x) for x in frames])
    m, n = ts.T.shape[1] - 2, ts.T.shape[2] - 1
    loops = dual._dual_then_primal(ts, to, to.resolved_stall_limit(m, n),
                                   to.max_iters)
    _same(loops, ref)


def test_dual_then_primal_matches_tpulp():
    """The waves' two loops on the numeric lanes too: the dual loop, the
    OPTIMAL lanes reopened, the primal clean-up, RUNNING to
    ITERATION_LIMIT."""
    jo, to = _opts(max_iters=2)
    js, ts = _pair(_dual_leaves(numeric=True))
    stall = to.resolved_stall_limit(ts.T.shape[1] - 2, ts.T.shape[2] - 1)
    ref = _jax_loop(jdual.dual_simplex_step, jo, stall, to.max_iters)(js)
    ref = ref._replace(status=jnp.where(ref.status == Status.OPTIMAL,
                                        Status.RUNNING, ref.status))
    ref = _jax_loop(j_simplex_step, jo, stall, to.max_iters)(ref)
    ref = ref._replace(status=jnp.where(
        ref.status == Status.RUNNING, Status.ITERATION_LIMIT, ref.status))
    out = dual._dual_then_primal(ts, to, stall, to.max_iters)
    _same(out, ref)
    assert Status.ITERATION_LIMIT in out.status.tolist()


# ---------------------------------------------------------------------------
# the wave entries and the ("batch",) mesh's loops
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def wave():
    return _Wave()


def test_cold_wave_bit_for_bit(wave):
    _same(wave.tcold, wave.jcold)


def test_run_warm_carry_batch_bit_for_bit(wave):
    jp, tp = wave.pools()
    idx, cols, deltas = wave.child_packs()
    ref = jdual.run_warm_carry_batch(*jp, *wave.jmasks, idx, cols, deltas,
                                     wave.jopts)
    out = dual.run_warm_carry_batch(*tp, *wave.tmasks, idx, cols, deltas,
                                    wave.topts)
    _same(out, ref)
    assert len(set(out.niter.tolist())) > 1


def test_run_warm_wave_bit_for_bit(wave):
    jp, tp = wave.pools()
    idx, cols, deltas = wave.child_packs()
    ipack = np.zeros((B, 5), np.int32)
    ipack[:, 2] = CAP
    ipack[:CAP, 0], ipack[:CAP, 1], ipack[:CAP, 4] = idx, cols, deltas
    ipack[CAP:, 0], ipack[CAP:, 1], ipack[CAP:, 4] = idx[0], cols[0], \
        deltas[0]
    ref = jdual.run_warm_wave(*jp, *wave.jmasks, wave.jcold.T,
                              wave.jcold.basis, ipack, wave.jR, wave.jc,
                              jnp.asarray(4, jnp.int32), wave.jopts)
    out = dual.run_warm_wave(*tp, *wave.tmasks, wave.tcold.T,
                             wave.tcold.basis, ipack, wave.tR, wave.tc, 4,
                             wave.topts)
    _same(out[2], ref[2])
    assert np.array_equal(out[3].numpy(), np.asarray(ref[3]))


@pytest.mark.parametrize("max_iters", [500, 1])
def test_run_expand_generation_bit_for_bit(wave, max_iters):
    n_int = len(wave.names)
    lbm = np.zeros((B, n_int))
    ubm = np.ones((B, n_int))
    le_c, le_s, ge_c, ge_s = _gen_meta(wave)
    active = np.ones(B, bool)
    ref = jdual.run_expand_generation(
        wave.jcold.T, wave.jcold.basis, wave.jsum, jnp.asarray(active),
        jnp.asarray(lbm), jnp.asarray(ubm), *wave.jmasks,
        jnp.asarray(le_c, jnp.int32), jnp.asarray(le_s),
        jnp.asarray(ge_c, jnp.int32), jnp.asarray(ge_s),
        jnp.asarray(-np.inf), jnp.asarray(1e-6),
        jnp.asarray(max_iters, jnp.int32), wave.jR, wave.jc,
        opts=wave.jopts)
    out = dual.run_expand_generation(
        wave.tcold.T, wave.tcold.basis, wave.tsum, torch.as_tensor(active),
        torch.as_tensor(lbm), torch.as_tensor(ubm), *wave.tmasks,
        torch.tensor(le_c), torch.tensor(le_s), torch.tensor(ge_c),
        torch.tensor(ge_s), torch.tensor(-np.inf, dtype=torch.float64),
        torch.tensor(1e-6, dtype=torch.float64), max_iters, wave.tR,
        wave.tc, opts=wave.topts)
    _same(out[0], ref[0])
    assert np.array_equal(out[1].numpy(), np.asarray(ref[1]),
                          equal_nan=True)
    if max_iters == 1:
        assert Status.ITERATION_LIMIT in out[0].status.tolist()


def test_batch_mesh_lane_loops_bit_for_bit(wave):
    """``LaneMesh.dual_then_primal`` on a mesh without a ``cols`` axis (the
    ``("batch",)`` mesh's lanes, here with the batch axis left out) runs
    ``dual_lanes`` / ``primal_lanes`` on whole frames."""
    jp, tp = wave.pools()
    idx, cols, deltas = wave.child_packs()
    ref = jdual.run_warm_carry_batch(*jp, *wave.jmasks, idx, cols, deltas,
                                     wave.jopts)
    lm = LaneMesh(types.SimpleNamespace(mesh_dim_names=("batch",)),
                  batch_axis=None)
    T = dual._rhs_rewrite(tp[0][torch.as_tensor(idx).long()],
                          torch.as_tensor(cols).long(),
                          torch.as_tensor(deltas, dtype=torch.float64))
    fr = dual._lanes(T, tp[1][torch.as_tensor(idx).long()], *wave.tmasks)
    m, n = T.shape[1] - 2, T.shape[2] - 1
    out = lm.dual_then_primal(fr, wave.topts,
                              wave.topts.resolved_stall_limit(m, n),
                              wave.topts.max_iters)
    _same(out, ref)


# ---------------------------------------------------------------------------
# the launch plan and the wrapper's refusals
# ---------------------------------------------------------------------------

PLAN_CASES = {
    # the bench knapsack's frames, phase 7c's and 10a's scenarios, and the
    # streamed case of chip_smoke.py's phase 7d: lane_primal's layout (the
    # frame's n columns at an odd pitch, the RHS and the basis twice) and
    # its block from the frame's width
    "knapsack_f64": ((59, 114, torch.float64), (True, 256, 55_520)),
    "knapsack_f32": ((59, 114, torch.float32), (True, 256, 28_128)),
    "scenarios_f64": ((66, 193, torch.float64), (True, 192, 104_384)),
    "streamed_f64": ((258, 513, torch.float64), (False, 256, 9_264)),
    "streamed_f32": ((258, 513, torch.float32), (False, 256, 6_192)),
    "small_f64": ((14, 23, torch.float64), (True, 32, 3_072)),
}

# lane_dual's plan: lane_primal's layout and block (the kernels share one
# layout)
DUAL_PLAN_CASES = {
    "knapsack_f64": ((59, 114, torch.float64), (True, 256, 55_520)),
    "knapsack_f32": ((59, 114, torch.float32), (True, 256, 28_128)),
    "scenarios_f64": ((66, 193, torch.float64), (True, 192, 104_384)),
    "streamed_f64": ((258, 513, torch.float64), (False, 256, 9_264)),
    "streamed_f32": ((258, 513, torch.float32), (False, 256, 6_192)),
    "small_f64": ((14, 23, torch.float64), (True, 32, 3_072)),
}


@pytest.mark.parametrize("case", PLAN_CASES)
def test_lane_plan(case):
    (M, N, dt), want = PLAN_CASES[case]
    assert tuple(lane_plan(M, N, dt)) == want


@pytest.mark.parametrize("case", DUAL_PLAN_CASES)
def test_lane_dual_plan(case):
    (M, N, dt), want = DUAL_PLAN_CASES[case]
    assert tuple(lane_dual_plan(M, N, dt)) == want


def test_lane_plan_resident_up_to_the_limit():
    """Resident while the frame and vectors fit LANE_SMEM_LIMIT, streamed
    one row past it; a frame whose vectors alone overflow is refused."""
    M = 100
    N = max(n for n in range(2, 400)
            if lane_plan(M, n, torch.float64).resident)
    assert lane_plan(M, N, torch.float64).smem <= LANE_SMEM_LIMIT
    assert not lane_plan(M, N + 1, torch.float64).resident
    assert not lane_plan(M + 1, N, torch.float64).resident
    with pytest.raises(ValueError, match="shared memory"):
        lane_plan(3, 20_000_00, torch.float64)
    with pytest.raises(ValueError, match="float32 or float64"):
        lane_plan(59, 114, torch.float16)
    with pytest.raises(ValueError, match="outside"):
        lane_plan(2, 114, torch.float64)


def test_lane_kernel_refuses_cpu_tensors():
    reset_launches()
    _, to = _opts(max_iters=10)
    _, ts = _pair(_dual_leaves())
    with pytest.raises(ValueError, match="CUDA"):
        lane_dual(ts, to, 10, 10)
    lanes.dual_lanes(ts, to, 10, 10)
    assert LAUNCHES["lane_dual"] == LAUNCHES["lane_primal"] == 0
