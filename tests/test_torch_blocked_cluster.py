"""A block of K eta-pivot slots of the solo blocked engine in one
thread-block-cluster launch (``tpulp_torch/kernels/blocked_cluster.py``),
held on the CPU through its plain version ``blocked_cluster_reference``:
at f64 it ends where tpulp's ``run_simplex_blocked`` does (status, pivots,
basis, objective), and at f32 and f64 it equals ``kernels.blocked``'s
plain-stage walk ``blocked_walk_reference`` in every field (``T + 0.0``,
NaN equal, the devex weights too) under Dantzig, Bland, devex and
largest-pivot ties, for clusters of 1, 2, 4, 8 and 16 blocks, through a
budget stop inside a block, a slot past the budget that still ends the
walk, the clean-up pivots and the retire, the phase change with devex's
reset, the 1e8 reset and inf / NaN entries; a block of it equals the plain
stages' block in every field of the carry. The kernel's finiteness sums
are taken in its order (``rank1_cluster.slab_sum``), the only place
where the two plain versions could part (an overflow at the edge). The
plan's arithmetic and refusals, the route
(``solve.blocked.blocked_route``), the wrapper's refusals and the CPU
dispatch are held here too. The kernel itself runs on
the card only (tests/test_torch_blocked_card.py; chip_smoke.py's phase 5d
holds it at full size)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpulp_torch
import tpulp_torch.kernels.blocked as kb
import tpulp_torch.kernels.blocked_cluster as kbc
import tpulp_torch.kernels.rank1_cluster as kc
from tpulp.core import make_state as tpulp_make_state
from tpulp.core.state import SolverOptions as TpulpOptions
from tpulp.solve import run_simplex_blocked as tpulp_blocked
from tpulp_torch.core import Status
from tpulp_torch.kernels import LAUNCHES, reset_launches
from tpulp_torch.solve import blocked as pb

from test_torch_blocked_kernel import (INSTANCES, K, RULES, Events, options,
                                       port_state)
from test_torch_bounded_kernel import as_bits
from test_torch_rank1_cluster import _emulated_block_sum
from test_torch_rank1_kernel import _wyndor

torch.set_num_threads(1)

SIZES = kbc.BLOCKED_CLUSTER_SIZES
# the rules of the parity tests: Dantzig, Bland, devex, largest-pivot
# ties; the stall switch to Bland rides along
EQ_RULES = ("dantzig", "bland", "devex", "maxpiv", "stall_bland")


def assert_walks_equal(a, b, ga, gb):
    """Every field of two walks' states and their devex weights equal, the
    floats as ``T + 0.0`` with NaN equal."""
    for name in a._fields:
        assert torch.equal(as_bits(getattr(a, name)),
                           as_bits(getattr(b, name))), name
    assert torch.equal(as_bits(ga), as_bits(gb))


_STAGE_WALKS = {}


def walks(instance, rule, dtype, C, max_iters=None):
    """(cluster walk, stage walk): ``blocked_cluster_reference`` on C blocks
    and ``blocked_walk_reference`` (computed once a case), each (state,
    weights)."""
    state = port_state(instance, dtype)
    opts = options(rule, dtype)
    stall = opts.resolved_stall_limit(state.m, state.n)
    mi = opts.max_iters if max_iters is None else max_iters
    key = (instance, rule, dtype, mi)
    if key not in _STAGE_WALKS:
        _STAGE_WALKS[key] = kb.blocked_walk_reference(state, opts, stall, mi,
                                                      K)
    return (kbc.blocked_cluster_reference(state, opts, stall, mi, K, C),
            _STAGE_WALKS[key])


# ---------------------------------------------------------------------------
# against tpulp and against the plain stages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rule", ["dantzig", "bland", "devex"])
@pytest.mark.parametrize("instance", ["random0", "bounded1", "beale",
                                      "cleanup"])
def test_plain_cluster_walk_matches_tpulp_f64(instance, rule):
    """As test_torch_blocked_kernel.py holds the plain-stage walk: the
    cluster walk (C = 8) ends with tpulp's status, pivots and basis, the
    objective within 1e-9."""
    c, A, b, hint = INSTANCES[instance]()
    js = tpulp_make_state(c, A, b, hint, dtype=jnp.float64)
    ref = tpulp_blocked(js, TpulpOptions.for_dtype(
        jnp.float64, max_iters=2000, **RULES[rule]), block=8)
    state = port_state(instance, torch.float64)
    opts = options(rule, torch.float64, max_iters=2000)
    stall = opts.resolved_stall_limit(state.m, state.n)
    out, _ = kbc.blocked_cluster_reference(state, opts, stall,
                                           opts.max_iters, 8, 8)
    out = pb.finish(out)
    assert int(out.status) == int(ref.status)
    assert int(out.niter) == int(ref.niter)
    assert np.array_equal(out.basis.numpy(), np.asarray(ref.basis))
    if int(ref.status) == Status.OPTIMAL:
        assert abs(float(out.objective()) - float(ref.objective())) < 1e-9


@pytest.mark.parametrize("C", SIZES)
@pytest.mark.parametrize("rule", EQ_RULES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_plain_cluster_walk_equals_the_stages(dtype, rule, C):
    """On the longer instance (phase 2 from a slack basis, a walk of a few
    dozen pivots over many blocks) and on the equality LP (phase 1, the
    clean-up pivots, a retire, the phase change): every field equal."""
    for instance in ("long", "equalities"):
        (out, g), (ref, gr) = walks(instance, rule, dtype, C)
        assert_walks_equal(out, ref, g, gr)
        assert int(out.status) != Status.RUNNING


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("instance", list(INSTANCES))
def test_plain_cluster_walk_equals_the_stages_on_every_instance(instance,
                                                                dtype):
    """Every instance of the stage tests (the unbounded, infeasible, NUMERIC
    and exposed-ray walks, Beale's cycling LP, the pivot on 1e-5) under
    Dantzig and devex, on clusters of 2 and 16."""
    for rule in ("dantzig", "devex"):
        for C in (2, 16):
            (out, g), (ref, gr) = walks(instance, rule, dtype, C)
            assert_walks_equal(out, ref, g, gr)


@pytest.mark.parametrize("rule", ["dantzig", "devex", "maxpiv"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_a_block_equals_the_plain_stages_block(dtype, rule):
    """One block of the cluster's plain version against K plain slots on
    the same record, block after block: every field of the carry (the
    factors, the running vectors, the weights, the basis, the masks, the
    walk's scalars and t, last_z) equal."""
    state = port_state("equalities", dtype)
    opts = options(rule, dtype)
    stall = opts.resolved_stall_limit(state.m, state.n)
    mi = opts.max_iters
    rec = kb.make_record(state, K)
    carry = ("U", "V", "row0", "row1", "bvec", "gamma", "basis",
             "col_active", "art_cols")
    for _ in range(40):
        if not kb._running(rec.ints.tolist()):
            return
        a, b = kb.clone_record(rec), kb.clone_record(rec)
        kbc.blocked_cluster_block_reference(a, opts, stall, mi, 4)
        for _ in range(K):
            kb.blocked_pivot_reference(b, opts, stall, mi)
        for name in carry:
            assert torch.equal(as_bits(getattr(a, name)),
                               as_bits(getattr(b, name))), name
        assert torch.equal(a.ints[:kb.ART_ROW + 1], b.ints[:kb.ART_ROW + 1])
        assert torch.equal(as_bits(a.vals[:1]), as_bits(b.vals[:1]))
        _, scan = kb.fused_flush_reference(*kb.flush_inputs(b),
                                           float(opts.opt_tol),
                                           float(opts.piv_tol))
        kb.blocked_ray_reference(b, scan, opts)
        rec = b
    raise AssertionError("no exit in 40 blocks")


# ---------------------------------------------------------------------------
# the edge cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("budget", [1, 5, 6, 13])
@pytest.mark.parametrize("rule", ["dantzig", "devex"])
def test_budget_stops_inside_a_block(rule, budget):
    """A budget that is not a multiple of K ends the walk inside a block:
    the slots past it pivot nowhere; the walk equals the stages' in every
    field, and its exit is tpulp's (status, pivots, basis)."""
    (out, g), (ref, gr) = walks("long", rule, torch.float64, 8, budget)
    assert_walks_equal(out, ref, g, gr)
    assert int(out.niter) == budget
    c, A, b, hint = INSTANCES["long"]()
    tp = tpulp_blocked(
        tpulp_make_state(c, A, b, hint, dtype=jnp.float64),
        TpulpOptions.for_dtype(jnp.float64, max_iters=budget,
                               **RULES[rule]), block=K)
    out = pb.finish(out)
    assert int(out.status) == int(tp.status) == Status.ITERATION_LIMIT
    assert np.array_equal(out.basis.numpy(), np.asarray(tp.basis))


def test_a_slot_past_the_budget_still_ends_the_walk():
    """A budget reached by the walk's last pivot inside a block: the next
    slot pivots nowhere but finds the optimum; the walk ends OPTIMAL, as
    the stages' and the eager engine's do."""
    state = port_state("long", torch.float64)
    opts = options("dantzig", torch.float64)
    full = pb.run_simplex_blocked_reference(state, opts, K)
    budget = int(full.niter)
    assert int(full.status) == Status.OPTIMAL and budget % K != 0
    (out, g), (ref, gr) = walks("long", "dantzig", torch.float64, 8, budget)
    assert_walks_equal(out, ref, g, gr)
    assert int(out.status) == Status.OPTIMAL and int(out.niter) == budget


def test_every_edge_event_is_covered(monkeypatch):
    """The cluster's plain walks go through every kind of slot and block
    end (a spy on the plain finish and ray stages): the clean-up pivot and
    the retire, the phase change with devex's reset, the 1e8 reset, the
    stall switch to Bland, a budget stop inside a block, the exposed ray
    and the optimal, unbounded, infeasible and NUMERIC exits; each walk
    equals the stages' in every field."""
    ev = Events()
    finish, ray = kb.blocked_finish_reference, kb.blocked_ray_reference
    devex = [False]

    def finish_spy(rec, *args):
        before = kb.clone_record(rec)
        finish(rec, *args)
        ev.slot(before, rec, devex[0])

    def ray_spy(rec, scan, opts):
        ray(rec, scan, opts)
        ev.block(rec)

    cases = [(i, r, None) for i in INSTANCES
             for r in ("dantzig", "devex", "stall_bland")]
    cases.append(("long", "dantzig", 6))
    for instance, rule, budget in cases:
        devex[0] = rule == "devex"
        monkeypatch.setattr(kb, "blocked_finish_reference", finish_spy)
        monkeypatch.setattr(kb, "blocked_ray_reference", ray_spy)
        state = port_state(instance, torch.float64)
        opts = options(rule, torch.float64)
        stall = opts.resolved_stall_limit(state.m, state.n)
        mi = opts.max_iters if budget is None else budget
        out, g = kbc.blocked_cluster_reference(state, opts, stall, mi, K, 4)
        monkeypatch.undo()
        ref, gr = kb.blocked_walk_reference(state, opts, stall, mi, K)
        assert_walks_equal(out, ref, g, gr)
    missing = [k for k, v in ev.seen.items() if not v]
    assert not missing, (missing, ev.seen)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_inf_and_nan_entries(dtype):
    """Entries that are not finite: an infinite RHS (NUMERIC at once), a
    NaN in a column the walk prices (NaN-first picks), an infinite cost;
    every field equal to the stages' walk, NaN included."""
    base = port_state("long", dtype)
    cases = {"inf_rhs": (5, -1, math.inf), "nan_entry": (4, 3, math.nan),
             "inf_cost": (0, 2, -math.inf)}
    for name, (i, j, v) in cases.items():
        T = base.T.clone()
        T[i, j] = v
        state = base._replace(T=T)
        for rule in ("dantzig", "devex", "maxpiv"):
            opts = options(rule, dtype)
            stall = opts.resolved_stall_limit(state.m, state.n)
            for C in (1, 8):
                out, g = kbc.blocked_cluster_reference(
                    state, opts, stall, opts.max_iters, K, C)
                ref, gr = kb.blocked_walk_reference(state, opts, stall,
                                                    opts.max_iters, K)
                assert_walks_equal(out, ref, g, gr)


@pytest.mark.parametrize("length", [1, 65, 600, 1537])
def test_slab_sum_is_the_kernel_order(length):
    """``slab_sum`` (the blocked cluster's finiteness sums) adds each
    block's slab as the kernel's block reduction does, then the blocks'
    sums in rank order, bit for bit on values whose order changes the
    sum."""
    rng = np.random.default_rng(length)
    vals = (rng.standard_normal(length)
            * 10.0 ** rng.integers(-8, 9, length)).tolist()
    x = torch.tensor(vals, dtype=torch.float64)
    for C in (1, 2, 8, 16):
        W = -(-length // C)
        want = None
        for b in range(C):
            part = _emulated_block_sum(vals[b * W:(b + 1) * W],
                                       kbc.BLOCKED_CLUSTER_THREADS)
            want = part if want is None else want + part
        assert float(kc.slab_sum(x, W, C)) == want
    # a sum that overflows only as a whole reads as not finite
    big = torch.full((20,), 1.7e308, dtype=torch.float64)
    assert not math.isfinite(float(kc.slab_sum(big, 2, 10)))


def test_the_callers_state_is_never_written():
    state = port_state("equalities", torch.float64)
    before = [x.clone() for x in state]
    opts = options("devex", torch.float64)
    stall = opts.resolved_stall_limit(state.m, state.n)
    out, _ = kbc.blocked_cluster_reference(state, opts, stall,
                                           opts.max_iters, K, 8)
    assert int(out.status) == Status.OPTIMAL
    for x, y in zip(state, before):
        assert torch.equal(as_bits(x), as_bits(y))


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

def _bytes(M, N, K, C, es):
    """The kernel's layout, each segment rounded up to 16 bytes: V's and
    U's slabs; row0, row1, the weights (W each); bvec, colj, the pending w
    (H each); U's rows 0 and 1, V's column N - 1, the peer's coefficients
    (K each); the basis; the slab's active mask; the artificial mask."""
    up = lambda x: -(-x // 16) * 16  # noqa: E731
    W, H = -(-N // C), -(-M // C)
    return (up(K * W * es) + up(K * H * es) + 3 * up(W * es)
            + 3 * up(H * es) + 4 * up(K * es) + up(4 * (M - 2)) + up(W)
            + up(N - 1))


@pytest.mark.parametrize("shape", [
    # 5d (a) and (b): 8 blocks at f64 and f32
    (514, 1537, torch.float64, 8), (514, 1537, torch.float32, 8),
    (514, 1281, torch.float64, 8), (518, 1285, torch.float64, 8),
    (514, 1281, torch.float32, 8),
    # bench.py's recipe at 1024 x 1024 (5d (e), (f)): 8 blocks still hold it
    (1026, 2049, torch.float64, 8),
    # the top of auto's blocked range (4M elements): 16 blocks
    (1538, 2600, torch.float64, 16), (2002, 1998, torch.float64, 16),
    # phase 5's 1538 x 3073 (4.7M elements, the kernel engine's by auto)
    (1538, 3073, torch.float64, 16),
    (1538, 2600, torch.float32, 8),
    # the bottom of the range, and a tiny tableau: 8 blocks, some empty
    (258, 777, torch.float64, 8), (5, 8, torch.float64, 8),
], ids=lambda s: f"{s[0]}x{s[1]}-{str(s[2])[6:]}")
def test_blocked_cluster_plan(shape):
    """C is 8 where 8 blocks hold the block of 64 slots, else 16: the bytes
    are the kernel's layout, within the limit; where C is 16, 8 would not
    do."""
    M, N, dtype, C = shape
    es = 8 if dtype == torch.float64 else 4
    plan = kbc.blocked_cluster_plan(M, N, 64, dtype)
    assert plan == kbc.BlockedClusterPlan(C, -(-N // C), -(-M // C), 512,
                                          _bytes(M, N, 64, C, es))
    assert plan.smem <= kbc.BLOCKED_CLUSTER_SMEM_LIMIT == 228_352
    if C == 16:
        assert _bytes(M, N, 64, 8, es) > kbc.BLOCKED_CLUSTER_SMEM_LIMIT


def test_blocked_cluster_plan_worked_check():
    """514 x 1537 at f64, K = 64, on 8 blocks: 193 columns and 65 rows a
    block, 98,816 bytes of V's slab, 33,280 of U's, 144,176 in all."""
    plan = kbc.blocked_cluster_plan(514, 1537, 64, torch.float64)
    assert (plan.blocks, plan.width, plan.height) == (8, 193, 65)
    assert 64 * 193 * 8 == 98_816 and 64 * 65 * 8 == 33_280
    assert plan.smem == 144_176
    # forced sizes: 16 holds 1026 x 2049 too, 4 does not hold 514 x 1537
    assert kbc.blocked_cluster_plan(1026, 2049, 64, torch.float64,
                                    16).blocks == 16
    with pytest.raises(ValueError, match="cluster of 4"):
        kbc.blocked_cluster_plan(514, 1537, 64, torch.float64, 4)
    assert kbc.blocked_cluster_plan(5, 8, 4, torch.float64, 1) == \
        kbc.BlockedClusterPlan(1, 8, 5, 512, _bytes(5, 8, 4, 1, 8))


@pytest.mark.parametrize("case", [
    # a wide LP: 16 blocks of 938 columns
    (258, 15000, 64, torch.float64, "cluster of 16"),
    (258, 15000, 64, torch.float32, "cluster of 16"),
    # bench.py's shape at f64 (33.6M elements)
    (4098, 8193, 64, torch.float64, "cluster of 16"),
    # K past the plan
    (514, 1537, 1024, torch.float64, "cluster of 16"),
    (514, 1537, 256, torch.float64, "cluster of 16"),
    (514, 1537, 2048, torch.float64, "outside"),
    (514, 1537, 0, torch.float64, "outside"),
], ids=lambda c: f"{c[0]}x{c[1]}-K{c[2]}-{str(c[3])[6:]}")
def test_blocked_cluster_plan_refuses(case):
    M, N, Kb, dtype, msg = case
    with pytest.raises(ValueError, match=msg):
        kbc.blocked_cluster_plan(M, N, Kb, dtype)


def test_blocked_cluster_plan_refusals():
    with pytest.raises(ValueError, match="float32 or float64"):
        kbc.blocked_cluster_plan(514, 1537, 64, torch.float16)
    with pytest.raises(ValueError, match="outside"):
        kbc.blocked_cluster_plan(2, 1537, 64, torch.float64)
    with pytest.raises(ValueError, match="expected one of"):
        kbc.blocked_cluster_plan(514, 1537, 64, torch.float64, 3)
    with pytest.raises(ValueError, match="expected one of"):
        kbc.blocked_cluster_plan(514, 1537, 64, torch.float64, 32)


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    (514, 1537, 64, torch.float64, 15, "blocked_cluster"),
    (514, 1537, 64, torch.float32, 15, "blocked_cluster"),
    (1538, 2600, 64, torch.float64, 7, "blocked_cluster"),
    (514, 1537, 64, torch.float64, 0, RuntimeError),
    (258, 15000, 64, torch.float64, 15, "blocked_grid"),
    (514, 1537, 1024, torch.float64, 15, "blocked_grid"),
    (4098, 8193, 64, torch.float32, 15, "blocked_grid"),
], ids=lambda c: f"{c[0]}x{c[1]}-K{c[2]}-{str(c[3])[6:]}-occ{c[4]}")
def test_blocked_route(monkeypatch, case):
    """The cluster where its plan fits and the card holds one cluster
    (occupancy patched), else the grid where the card holds it (the same
    occupancy, 132 SMs), else a RuntimeError (nothing else runs the walk);
    the cluster's occupancy is asked only of a plan that fits."""
    M, N, Kb, dtype, occ, want = case
    asked = []

    def occupancy(*args):
        asked.append(args)
        return occ

    monkeypatch.setattr(pb, "blocked_cluster_occupancy", occupancy)
    monkeypatch.setattr(pb, "blocked_grid_occupancy", lambda *a: occ)
    monkeypatch.setattr(pb, "sm_count", lambda device: 132)
    if want is RuntimeError:
        with pytest.raises(RuntimeError, match="blocked_grid"):
            pb.blocked_route(M, N, Kb, dtype, torch.device("cuda", 0))
    else:
        assert pb.blocked_route(M, N, Kb, dtype,
                                torch.device("cuda", 0)) == want
    fits = True
    try:
        kbc.blocked_cluster_plan(M, N, Kb, dtype)
    except ValueError:
        fits = False
    assert len(asked) == int(fits)


def test_cuda_dispatch_takes_the_route_with_no_fallback(monkeypatch):
    """``run_simplex_blocked`` on a state it must treat as on the card
    (``on_cpu`` and the occupancy patched): the cluster route gets a
    contiguous tableau and the options, the grid and the eager loop are
    never entered, and the cluster's launch failure raises; with no
    cluster on the card the same state goes to ``blocked_grid``, and with
    neither a cluster nor the grid the walk raises."""
    def refuse(*args, **kw):
        raise AssertionError("another route ran")

    seen = []

    def spy(name):
        def run(state, opts, stall_limit, max_iters, block):
            seen.append((name, state.T.is_contiguous(), stall_limit,
                         max_iters, block))
            return state, None
        return run

    occ = {"cluster": 15, "grid": 15}
    monkeypatch.setattr(pb, "on_cpu", lambda *t: False)
    monkeypatch.setattr(pb, "blocked_cluster_occupancy",
                        lambda *a: occ["cluster"])
    monkeypatch.setattr(pb, "blocked_grid_occupancy",
                        lambda *a: occ["grid"])
    monkeypatch.setattr(pb, "sm_count", lambda device: 132)
    monkeypatch.setattr(pb, "blocked_grid", refuse)
    monkeypatch.setattr(pb, "run_simplex_blocked_reference", refuse)
    monkeypatch.setattr(pb, "_blocked_pivot", refuse)
    monkeypatch.setattr(pb, "blocked_cluster", spy("blocked_cluster"))
    state = port_state("bounded1", torch.float64)
    strided = state._replace(T=state.T.t().contiguous().t())
    out = pb.run_simplex_blocked(strided, options(
        "dantzig", torch.float64, max_iters=77), block=16)
    assert seen == [("blocked_cluster", True, state.m + state.n, 77, 16)]
    assert int(out.status) == Status.ITERATION_LIMIT

    def fail(*args, **kw):
        raise RuntimeError("tpulp_torch blocked_cluster: CUDA error 1")

    monkeypatch.setattr(pb, "blocked_cluster", fail)
    with pytest.raises(RuntimeError, match="blocked_cluster"):
        pb.run_simplex_blocked(state)
    occ["cluster"] = 0
    monkeypatch.setattr(pb, "blocked_cluster", refuse)
    monkeypatch.setattr(pb, "blocked_grid", spy("blocked_grid"))
    pb.run_simplex_blocked(state, block=16)
    assert seen[-1][0] == "blocked_grid"
    occ["grid"] = 0
    monkeypatch.setattr(pb, "blocked_grid", refuse)
    with pytest.raises(RuntimeError, match="not a grid of"):
        pb.run_simplex_blocked(state, block=16)


def test_cpu_walks_never_reach_a_kernel(monkeypatch):
    """On CPU tensors ``run_simplex_blocked`` is the eager loop, with no
    route asked and no launch counted; the solve_lp paths through it
    too."""
    def refuse(*args, **kw):
        raise AssertionError("a kernel route was taken on the CPU")

    for name in ("blocked_cluster", "blocked_grid", "blocked_route",
                 "blocked_cluster_occupancy"):
        monkeypatch.setattr(pb, name, refuse)
    monkeypatch.setattr(kbc, "blocked_cluster", refuse)
    reset_launches()
    for rule in ("dantzig", "devex"):
        state = port_state("long", torch.float64)
        opts = options(rule, torch.float64)
        out = pb.run_simplex_blocked(state, opts, block=K)
        ref = pb.run_simplex_blocked_reference(state, opts, block=K)
        for name in out._fields:
            assert torch.equal(as_bits(getattr(out, name)),
                               as_bits(getattr(ref, name))), name
    for driver in ("blocked", "refreshed"):
        sol = tpulp_torch.solve_lp(_wyndor(12), device="cpu", driver=driver)
        assert sol.objective == 400
    assert all(v == 0 for v in LAUNCHES.values())


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def _small():
    return port_state("bounded1", torch.float64), \
        options("dantzig", torch.float64)


def test_blocked_cluster_raises_on_cpu_tensors():
    state, opts = _small()
    reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        kbc.blocked_cluster(state, opts, 10, 10, K)
    with pytest.raises(ValueError, match="CUDA"):
        kbc.blocked_cluster_block(kb.make_record(state, K), opts, 10, 10)
    assert LAUNCHES["blocked_cluster"] == 0


def test_blocked_cluster_raises_on_mixed_devices():
    state, opts = _small()
    with pytest.raises(ValueError, match="CUDA"):
        kbc.blocked_cluster(state._replace(basis=state.basis.to("meta")),
                            opts, 10, 10, K)


def test_blocked_cluster_raises_on_float16():
    state, opts = _small()
    half = state._replace(T=state.T.half(), last_z=state.last_z.half())
    with pytest.raises(ValueError, match="float32 or float64"):
        kbc.blocked_cluster(half, opts, 10, 10, K)


def test_blocked_cluster_raises_on_a_strided_tableau():
    state, opts = _small()
    strided = state._replace(T=state.T.t().contiguous().t())
    assert not strided.T.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        kbc.blocked_cluster(strided, opts, 10, 10, K)


def test_blocked_cluster_raises_when_the_card_holds_no_cluster(monkeypatch):
    """A plan whose cluster the card cannot hold (occupancy 0) raises
    before any launch."""
    state, opts = _small()
    asked = []

    def occupancy(M, N, Kb, dtype, device, blocks):
        asked.append((M, N, Kb, blocks))
        return 0

    monkeypatch.setattr(kb, "_check", lambda *a: None)
    monkeypatch.setattr(kbc, "blocked_cluster_occupancy", occupancy)
    reset_launches()
    with pytest.raises(RuntimeError, match="holds no cluster"):
        kbc.blocked_cluster(state, opts, 10, 10, K, blocks=2)
    assert asked == [(*state.T.shape, K, 2)]
    assert LAUNCHES["blocked_cluster"] == 0
