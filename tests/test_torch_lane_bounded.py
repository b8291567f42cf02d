"""The bounded lanes' loop (``tpulp_torch.solve.lanes.bounded_lanes``)
against tpulp's vmapped bounded driver at float64, bit for bit.

On CPU tensors ``bounded_lanes`` runs the plain loop,
``bounded_lanes_reference`` (``bounded_simplex_step`` vmapped over the
lanes); the kernel ``lane_bounded`` of ``kernels/lanes.py`` runs on the
card only (tests/test_torch_lanes_card.py, and chip_smoke.py's phase
8b). Every
comparison is exact: ``T + 0.0`` (the plain loop steps finished lanes
with the redirected no-op pivot, which may turn a -0.0 into +0.0), the
basis, the masks, the at-upper flags, the devex weights and every scalar,
NaN equal to NaN, against tpulp's ``run_simplex_bounded_batch`` (a
``lax.while_loop`` vmapped over the lanes) on the same numpy inputs. The
cases: box LPs of different shapes with an infeasible and an unbounded
lane, under Dantzig and devex; lanes that exit at different steps with
entering flips and flips after an upper hit; a budget that stops lanes
mid-walk; a stall limit of 1 (the Bland switch); phase-1 lanes that clean
up basic artificials and retire one; a NaN lane and an overflowing lane
(NUMERIC); a wave of span-encoded knapsack nodes. Then the route
(``run_simplex_bounded_batch`` reaches the kernel on CUDA tensors only),
the launch plan and the wrapper's refusals."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulp.core.state import SimplexState as JState
from tpulp.core.state import SolverOptions as JOptions
from tpulp.solve.bounded import BoundedState as JBounded
from tpulp.solve.bounded import run_simplex_bounded_batch as j_run_batch
from tpulp_torch.batch import make_batched_bounded_states
from tpulp_torch.core import SolverOptions, Status
from tpulp_torch.core.state import (RULE_BLAND, RULE_DANTZIG, RULE_DEVEX,
                                    SimplexState)
from tpulp_torch.kernels import (LAUNCHES, lane_bounded, lane_bounded_plan,
                                 lane_plan, reset_launches)
from tpulp_torch.kernels.lanes import LANE_SMEM_LIMIT
from tpulp_torch.solve import bounded as tbounded
from tpulp_torch.solve import lanes
from tpulp_torch.solve.bounded import BoundedState, bounded_simplex_step

from test_torch_batch import _box_lp, _box_mix
from test_torch_lanes import KINDS, TKINDS, _cold_leaves
from test_torch_milp import knapsack
from test_torch_model import to_port

torch.set_num_threads(1)
pytestmark = pytest.mark.filterwarnings(
    "error:There is a performance drop")

MAX_ITERS = 500


def _leaves(bs: BoundedState) -> list:
    """A port BoundedState as numpy leaves: the ten state fields, the spans
    and the at-upper flags."""
    return [x.numpy() for x in bs.s] + [bs.upper.numpy(),
                                        bs.at_upper.numpy()]


def _pair(leaves):
    """The same batched bounded state (numpy leaves as ``_leaves`` gives
    them) in both packages, with no devex weights."""
    st = [np.asarray(x, dtype=k) for x, k in zip(leaves[:10], KINDS)]
    upper = np.asarray(leaves[10], dtype=np.float64)
    at = np.asarray(leaves[11], dtype=bool)
    j = JBounded(s=JState(*(jnp.asarray(x) for x in st)),
                 upper=jnp.asarray(upper), at_upper=jnp.asarray(at))
    t = BoundedState(s=SimplexState(*(torch.tensor(x, dtype=k)
                                      for x, k in zip(st, TKINDS))),
                     upper=torch.tensor(upper), at_upper=torch.tensor(at))
    return j, t


def _forms_leaves(sfs):
    """The leaves of the port's batched bounded state of StandardForms."""
    return _leaves(make_batched_bounded_states(sfs, device="cpu"))


def _equal(a, b, name):
    a = np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, name
    if a.dtype.kind == "f":
        ints = np.int64 if a.dtype == np.float64 else np.int32
        a, b = a + a.dtype.type(0), b + b.dtype.type(0)
        nan = np.isnan(a)
        assert np.array_equal(nan, np.isnan(b)), name
        a = np.where(nan, 0, a).astype(a.dtype).view(ints)
        b = np.where(nan, 0, b).astype(b.dtype).view(ints)
    assert np.array_equal(a, b), name


def _same(out: BoundedState, ref) -> None:
    """Bit for bit: every state field (floats as x + 0.0, NaN equal to
    NaN), the spans, the at-upper flags and the devex weights."""
    for name in SimplexState._fields:
        _equal(getattr(out.s, name).numpy(), getattr(ref.s, name), name)
    _equal(out.upper.numpy(), ref.upper, "upper")
    _equal(out.at_upper.numpy(), ref.at_upper, "at_upper")
    assert (out.gamma is None) == (ref.gamma is None)
    if out.gamma is not None:
        _equal(out.gamma.numpy(), ref.gamma, "gamma")


def _opts(**kw):
    return (JOptions.for_dtype(jnp.float64, **kw),
            SolverOptions.for_dtype(torch.float64, **kw))


def _walk(leaves, **kw):
    """The plain loop on the port's state and tpulp's vmapped driver on the
    same leaves, held bit for bit; returns (input, output) of the port."""
    kw.setdefault("max_iters", MAX_ITERS)
    jo, to = _opts(**kw)
    jbs, tbs = _pair(leaves)
    if to.rule == RULE_DEVEX:
        tbs = tbs._replace(gamma=torch.ones_like(tbs.upper))
    m, n = tbs.s.T.shape[1] - 2, tbs.s.T.shape[2] - 1
    stall = to.resolved_stall_limit(m, n)
    out = lanes.bounded_lanes_reference(tbs, to, stall, to.max_iters)
    out = out._replace(s=out.s._replace(status=torch.where(
        out.s.status == Status.RUNNING, Status.ITERATION_LIMIT,
        out.s.status)))
    _same(out, j_run_batch(jbs, jo))
    return tbs, out


def _box_leaves(seeds, nv=9, mc=6):
    return _forms_leaves(to_port([_box_lp(s, nv=nv, mc=mc).lower(
        simple_bounds=True) for s in seeds]))


# ---------------------------------------------------------------------------
# the plain loop against tpulp's vmapped driver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rule", [RULE_DANTZIG, RULE_DEVEX])
def test_box_mix_matches_tpulp(rule):
    leaves = _forms_leaves(to_port([lp.lower(simple_bounds=True)
                                    for lp in _box_mix()]))
    _, out = _walk(leaves, rule=rule)
    st = out.s.status.tolist()
    assert Status.INFEASIBLE in st and Status.UNBOUNDED in st
    assert st.count(Status.OPTIMAL) >= 7


def _events(bs: BoundedState, opts, stall: int) -> dict:
    """Each lane stepped alone with the plain step, its events counted over
    all lanes: entering flips, flips after an upper hit, clean-up pivots
    (a basic artificial leaves in phase 2) and retires."""
    ev = dict(enter=0, uphit=0, cleanup=0, retire=0)
    for k in range(bs.s.T.shape[0]):
        c = BoundedState(s=SimplexState(*(x[k] for x in bs.s)),
                         upper=bs.upper[k], at_upper=bs.at_upper[k],
                         gamma=None if bs.gamma is None else bs.gamma[k])
        while int(c.s.status) == Status.RUNNING and \
                int(c.s.niter) < opts.max_iters:
            nxt = bounded_simplex_step(c, opts, stall, opts.max_iters)
            flipped = bool((nxt.at_upper != c.at_upper).any())
            moved = bool((nxt.s.basis != c.s.basis).any())
            ev["enter"] += flipped and not moved
            ev["uphit"] += flipped and moved
            art_basic = int(c.s.art_cols[c.s.basis.long()].sum())
            ev["cleanup"] += (int(c.s.phase) == 2 and moved and int(
                nxt.s.art_cols[nxt.s.basis.long()].sum()) < art_basic)
            ev["retire"] += int((c.s.art_cols & ~nxt.s.art_cols).sum())
            c = nxt
    return ev


def _walk_events(leaves, **kw):
    """``_walk`` and the lanes' ``_events``."""
    tbs, out = _walk(leaves, **kw)
    kw.setdefault("max_iters", MAX_ITERS)
    _, to = _opts(**kw)
    return tbs, out, _events(tbs, to, to.resolved_stall_limit(
        tbs.s.T.shape[1] - 2, tbs.s.T.shape[2] - 1))


@pytest.mark.parametrize("rule", [RULE_DANTZIG, RULE_DEVEX])
def test_flips_and_staggered_exits(rule):
    """Box LPs whose walks flip entering variables and leaving ones after
    an upper hit, each lane ending at its own step."""
    tbs, out, ev = _walk_events(_box_leaves(range(20, 28)), rule=rule)
    dn = (out.s.niter - tbs.s.niter).tolist()
    assert len(set(dn)) > 2
    assert bool(out.at_upper.any())
    assert ev["enter"] > 0 and ev["uphit"] > 0


@pytest.mark.parametrize("max_iters", [1, 3])
def test_budget_stops_lanes_mid_walk(max_iters):
    tbs, out = _walk(_box_leaves(range(20, 28)), max_iters=max_iters)
    st = out.s.status.tolist()
    assert Status.ITERATION_LIMIT in st
    assert int(out.s.niter.max()) == max_iters


@pytest.mark.parametrize("rule", [RULE_DANTZIG, RULE_DEVEX, RULE_BLAND])
def test_stall_limit_one_switches_to_bland(rule):
    """A stall limit of 1 with a degeneracy tolerance no step beats: every
    lane switches to Bland's rule after its first pricing pivot (RULE_BLAND
    itself prices as Dantzig, as the plain step does)."""
    tbs, out = _walk(_box_leaves(range(30, 38)), rule=rule, stall_limit=1,
                     degen_tol=1e300)
    moved = (out.s.niter > 0).numpy()
    assert moved.any() and out.s.bland.numpy()[moved].all()


def _phase1_leaves(seed):
    """``_cold_leaves``' phase-1 lanes (every row artificial: a redundant
    row retired in phase 2, mixed-sign rows whose phase 2 starts with basic
    artificials at zero, an infeasible lane, an unbounded lane) with seeded
    spans on the structural columns, none below the point the rows were
    built from (lane 2's unbounded column unbounded), and none on the
    artificials."""
    leaves = _cold_leaves(seed)
    rng = np.random.default_rng(seed)
    B, _, N = leaves[0].shape
    n, n0 = N - 1, 8
    upper = np.full((B, n), np.inf)
    upper[:, :n0] = rng.integers(2, 6, size=(B, n0))
    upper[:, :n0][rng.random((B, n0)) < 0.25] = np.inf
    upper[2, 3] = np.inf
    return leaves + [upper, np.zeros((B, n), dtype=bool)]


@pytest.mark.parametrize("rule", [RULE_DANTZIG, RULE_DEVEX])
def test_phase1_cleanup_and_retire(rule):
    tbs, out, ev = _walk_events(_phase1_leaves(5), rule=rule)
    st = out.s.status.tolist()
    assert st[1] == Status.INFEASIBLE and st[2] == Status.UNBOUNDED
    assert ev["cleanup"] > 0 and ev["retire"] > 0
    assert bool((tbs.s.art_cols & ~out.s.art_cols).any())
    ph2 = out.s.phase == 2
    assert not bool((out.s.col_active & out.s.art_cols)[ph2].any())


def test_numeric_lanes():
    """A NaN in one lane's b and an |b| sum that overflows in another: both
    end NUMERIC, the others walk on."""
    leaves = _box_leaves(range(40, 46))
    T = leaves[0]
    T[0, 4, -1] = np.nan
    T[3, 3:5, -1] = 1.5e308
    _, out = _walk(leaves, rule=RULE_DEVEX)
    st = out.s.status.tolist()
    assert st[0] == st[3] == Status.NUMERIC
    assert Status.OPTIMAL in st


def _span_leaves(n_items=12, lanes_=10, seed=4):
    """A wave of span-encoded knapsack nodes (10c's recipe at a small
    size): the root's spans with seeded fixings of three items."""
    from tpulp_torch.milp.spans import _int_columns, _node_sf
    from tpulp_torch.model.lower import lower_to_standard_form

    lp, _, _, _ = knapsack(n_items, seed)
    port = to_port(lp)
    root = lower_to_standard_form(port, simple_bounds=True)
    names = [f"x{i}" for i in range(n_items)]
    cols = _int_columns(root, names)
    bounds0 = {nm: (port.vars[nm].lb, port.vars[nm].ub) for nm in names}
    rng = np.random.default_rng(seed)
    sfs = []
    for _ in range(lanes_):
        node = dict(bounds0)
        for i in rng.choice(n_items, size=3, replace=False):
            v = int(rng.integers(0, 2))
            node[names[i]] = (v, v)
        sfs.append(_node_sf(root, cols, bounds0, node))
    return _forms_leaves(sfs)


def test_span_nodes():
    tbs, out = _walk(_span_leaves())
    assert tbs.s.T.shape[1] == 3
    assert set(out.s.status.tolist()) <= {Status.OPTIMAL, Status.INFEASIBLE}


# ---------------------------------------------------------------------------
# the route: the kernel on CUDA tensors, the plain loop on CPU tensors
# ---------------------------------------------------------------------------

def test_batch_goes_through_bounded_lanes(monkeypatch):
    """``run_simplex_bounded_batch`` hands the kernel a state it takes as
    on the card (``on_cpu`` patched False), one call with the plain loop's
    arguments; CPU tensors never reach it."""
    leaves = _box_leaves(range(50, 54))
    _, to = _opts(max_iters=MAX_ITERS, rule=RULE_DEVEX)
    calls = []

    def spy(bs, opts, stall_limit, max_iters):
        calls.append((bs, opts, stall_limit, max_iters))
        return lanes.bounded_lanes_reference(bs, opts, stall_limit,
                                             max_iters)

    monkeypatch.setattr(lanes, "lane_bounded", spy)
    _, tbs = _pair(leaves)
    ref = tbounded.run_simplex_bounded_batch(tbs, to)
    assert calls == []
    monkeypatch.setattr(lanes, "on_cpu", lambda *xs: False)
    out = tbounded.run_simplex_bounded_batch(tbs, to)
    assert len(calls) == 1
    bs, opts, stall, max_iters = calls[0]
    assert opts is to and max_iters == to.max_iters
    assert stall == to.resolved_stall_limit(bs.s.T.shape[1] - 2,
                                            bs.s.T.shape[2] - 1)
    assert torch.equal(bs.gamma, torch.ones_like(tbs.upper))
    _same(out, ref)


# ---------------------------------------------------------------------------
# the launch plan and the wrapper's refusals
# ---------------------------------------------------------------------------

PLAN_CASES = {
    # 8b's box LPs, 10c's span nodes and 8b's streamed lanes in
    # chip_smoke.py: the block from the frame's width (one warp at 3 x 30)
    "box_f64": ((66, 193, torch.float64), (True, 192, 108_704)),
    "box_f32": ((66, 193, torch.float32), (True, 192, 54_944)),
    "spans_f64": ((3, 30, torch.float64), (True, 32, 1_472)),
    "streamed_f64": ((258, 513, torch.float64), (False, 256, 22_096)),
    "streamed_f32": ((258, 513, torch.float32), (False, 256, 12_880)),
}


@pytest.mark.parametrize("case", PLAN_CASES)
def test_lane_bounded_plan(case):
    (M, N, dt), want = PLAN_CASES[case]
    assert tuple(lane_bounded_plan(M, N, dt)) == want


def test_lane_bounded_plan_counts_the_bounded_vectors():
    """lane_primal's layout plus the spans and weights in the tableau's
    type, the at-upper flags in bytes and two snapshot columns of M, each
    16-byte aligned."""
    for M, N, dt, es in ((66, 193, torch.float64, 8),
                         (9, 17, torch.float32, 4), (3, 30, torch.float64, 8)):
        n = N - 1
        extra = 2 * ((n * es + 15) // 16 * 16) + (n + 15) // 16 * 16 \
            + 2 * ((M * es + 15) // 16 * 16)
        assert lane_bounded_plan(M, N, dt).smem == \
            lane_plan(M, N, dt).smem + extra


def test_lane_bounded_plan_resident_up_to_the_limit():
    """Resident while the frame and the vectors fit LANE_SMEM_LIMIT,
    streamed one column or row past it; refused where the vectors alone do
    not fit."""
    M = 100
    N = max(n for n in range(2, 400)
            if lane_bounded_plan(M, n, torch.float64).resident)
    assert lane_bounded_plan(M, N, torch.float64).smem <= LANE_SMEM_LIMIT
    assert not lane_bounded_plan(M, N + 1, torch.float64).resident
    assert not lane_bounded_plan(M + 1, N, torch.float64).resident
    # the bounded vectors take room from the frame
    assert lane_plan(M, N + 1, torch.float64).resident
    with pytest.raises(ValueError, match="shared memory"):
        lane_bounded_plan(3, 1_000_000, torch.float64)
    with pytest.raises(ValueError, match="float32 or float64"):
        lane_bounded_plan(66, 193, torch.float16)
    with pytest.raises(ValueError, match="outside"):
        lane_bounded_plan(2, 193, torch.float64)


def _small_state():
    _, tbs = _pair(_box_leaves(range(60, 62)))
    _, to = _opts(max_iters=10)
    return tbs, to


def test_lane_bounded_refusals():
    reset_launches()
    tbs, to = _small_state()
    with pytest.raises(ValueError, match="CUDA"):
        lane_bounded(tbs, to, 10, 10)
    # a device other than one CUDA device, mixed in
    meta = tbs._replace(upper=torch.empty_like(tbs.upper, device="meta"))
    with pytest.raises(ValueError, match="one CUDA device"):
        lane_bounded(meta, to, 10, 10)
    half = tbs._replace(s=tbs.s._replace(T=tbs.s.T.half()))
    with pytest.raises(ValueError, match="float32 or float64"):
        lane_bounded(half, to, 10, 10)
    strided = tbs._replace(s=tbs.s._replace(
        T=tbs.s.T.transpose(1, 2).contiguous().transpose(1, 2)))
    with pytest.raises(ValueError, match="contiguous"):
        lane_bounded(strided, to, 10, 10)
    devex = dataclasses.replace(to, rule=RULE_DEVEX)
    with pytest.raises(ValueError, match="gamma"):
        lane_bounded(tbs, devex, 10, 10)
    wide = tbs._replace(upper=tbs.upper[:, :-1])
    with pytest.raises(ValueError, match="upper"):
        lane_bounded(wide, to, 10, 10)
    flags = tbs._replace(at_upper=tbs.at_upper.to(torch.int32))
    with pytest.raises(ValueError, match="at_upper"):
        lane_bounded(flags, to, 10, 10)
    # CPU tensors go the plain way and never reach the kernel
    lanes.bounded_lanes(tbs, to, 10, 10)
    assert LAUNCHES["lane_bounded"] == 0
