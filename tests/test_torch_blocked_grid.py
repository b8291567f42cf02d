"""A block of K eta-pivot slots of the solo blocked engine in one
cooperative grid launch (``tpulp_torch/kernels/blocked_grid.py``), held on
the CPU through its plain version ``blocked_grid_reference``: at f64 it
ends where tpulp's ``run_simplex_blocked`` does (status, pivots, basis,
objective); at f32 within the stated tolerance of tpulp's f32 walk; and at
f32 and f64 it equals ``kernels.blocked``'s plain-stage walk
``blocked_walk_reference`` and the cluster's plain version
``blocked_cluster_reference`` in every field (``T + 0.0``, NaN equal, the
devex weights too) under Dantzig, Bland, devex and largest-pivot ties, on
grids of 1, 2, 3 and 7 blocks (uneven slabs, blocks with no row or no
column), through a budget stop inside a block, a slot past the budget that
still ends the walk, the clean-up pivots and the retire, the phase change
with devex's reset, the 1e8 reset, the exposed ray and inf / NaN entries.
The kernel's finiteness sums are taken in its order (``sums.grid_sum``),
the only place where the plain versions could part. The plan's arithmetic
and refusals, the three-way route (``solve.blocked.blocked_route``), the
solo and batch dispatch with no fallback and the wrapper's refusals are
held here too. The kernel itself runs on the card only (the ``cuda`` test;
chip_smoke.py's phase 5d holds it at full size)."""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpulp_torch.kernels.blocked as kb
import tpulp_torch.kernels.blocked_cluster as kbc
import tpulp_torch.kernels.blocked_grid as kg
import tpulp_torch.kernels.bounded_grid as kbg
import tpulp_torch.kernels.rank1_cluster as kc
from tpulp.core import make_state as tpulp_make_state
from tpulp.core.state import SolverOptions as TpulpOptions
from tpulp.solve import run_simplex_blocked as tpulp_blocked
from tpulp_torch.core import SimplexState, Status
from tpulp_torch.kernels import LAUNCHES, reset_launches, sums
from tpulp_torch.solve import blocked as pb

from test_torch_blocked_kernel import (INSTANCES, K, RULES, Events, options,
                                       port_state)
from test_torch_bounded_kernel import as_bits
from test_torch_rank1_cluster import _emulated_block_sum

torch.set_num_threads(1)

GRIDS = (1, 2, 3, 7)
# f32 against tpulp's f32 walk: the objective, relative (the eta sums'
# order differs, ~1e-7 a product, over a few dozen pivots of values ~1e2)
F32_OBJ_TOL = 1e-4


def assert_walks_equal(a, b, ga, gb):
    """Every field of two walks' states and their devex weights equal, the
    floats as ``T + 0.0`` with NaN equal."""
    for name in a._fields:
        assert torch.equal(as_bits(getattr(a, name)),
                           as_bits(getattr(b, name))), name
    assert torch.equal(as_bits(ga), as_bits(gb))


_STAGE_WALKS = {}


def walks(instance, rule, dtype, G, max_iters=None):
    """(grid walk, stage walk): ``blocked_grid_reference`` on G blocks and
    ``blocked_walk_reference`` (computed once a case), each (state,
    weights)."""
    state = port_state(instance, dtype)
    opts = options(rule, dtype)
    stall = opts.resolved_stall_limit(state.m, state.n)
    mi = opts.max_iters if max_iters is None else max_iters
    key = (instance, rule, dtype, mi)
    if key not in _STAGE_WALKS:
        _STAGE_WALKS[key] = kb.blocked_walk_reference(state, opts, stall, mi,
                                                      K)
    return (kg.blocked_grid_reference(state, opts, stall, mi, K, G),
            _STAGE_WALKS[key])


@functools.lru_cache(maxsize=None)
def _tpulp(instance, rule, jdtype, max_iters=2000, block=8):
    c, A, b, hint = INSTANCES[instance]()
    js = tpulp_make_state(c, A, b, hint, dtype=jdtype)
    return tpulp_blocked(js, TpulpOptions.for_dtype(
        jdtype, max_iters=max_iters, **RULES[rule]), block=block)


# ---------------------------------------------------------------------------
# against tpulp, the plain stages and the cluster's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("G", GRIDS)
@pytest.mark.parametrize("rule", ["dantzig", "bland", "devex"])
@pytest.mark.parametrize("instance", ["random0", "bounded1", "beale",
                                      "cleanup", "ray"])
def test_plain_grid_walk_matches_tpulp_f64(instance, rule, G):
    """As test_torch_blocked_kernel.py holds the plain-stage walk: the grid
    walk ends with tpulp's status, pivots and basis, the objective within
    1e-9, on every grid (the clean-up LP's dependent row and retire, the
    ray the per-block scan exposes)."""
    ref = _tpulp(instance, rule, jnp.float64)
    state = port_state(instance, torch.float64)
    opts = options(rule, torch.float64, max_iters=2000)
    stall = opts.resolved_stall_limit(state.m, state.n)
    out, _ = kg.blocked_grid_reference(state, opts, stall, opts.max_iters, 8,
                                       G)
    out = pb.finish(out)
    assert int(out.status) == int(ref.status)
    assert int(out.niter) == int(ref.niter)
    assert np.array_equal(out.basis.numpy(), np.asarray(ref.basis))
    if int(ref.status) == Status.OPTIMAL:
        assert abs(float(out.objective()) - float(ref.objective())) < 1e-9


@pytest.mark.parametrize("rule", ["dantzig", "devex"])
@pytest.mark.parametrize("instance", ["random0", "bounded1", "long"])
def test_plain_grid_walk_matches_tpulp_f32(instance, rule):
    """At f32 the walk ends with tpulp's f32 status, and an optimum within
    F32_OBJ_TOL (relative) of tpulp's f32 objective."""
    ref = _tpulp(instance, rule, jnp.float32)
    state = port_state(instance, torch.float32)
    opts = options(rule, torch.float32, max_iters=2000)
    stall = opts.resolved_stall_limit(state.m, state.n)
    out, _ = kg.blocked_grid_reference(state, opts, stall, opts.max_iters, 8,
                                       3)
    out = pb.finish(out)
    assert int(out.status) == int(ref.status)
    if int(ref.status) == Status.OPTIMAL:
        a, b = float(out.objective()), float(ref.objective())
        assert abs(a - b) <= F32_OBJ_TOL * max(1.0, abs(b))


@pytest.mark.parametrize("G", GRIDS)
@pytest.mark.parametrize("rule", ["dantzig", "bland", "devex", "maxpiv",
                                  "stall_bland"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_plain_grid_walk_equals_the_stages_and_the_cluster(dtype, rule, G):
    """On the longer instance (phase 2 from a slack basis, many blocks) and
    on the equality LP (phase 1, the clean-up pivots, a retire, the phase
    change): every field equal to the plain-stage walk and to the
    cluster's plain version on a cluster of G blocks."""
    for instance in ("long", "equalities"):
        (out, g), (ref, gr) = walks(instance, rule, dtype, G)
        assert_walks_equal(out, ref, g, gr)
        assert int(out.status) != Status.RUNNING
        state = port_state(instance, dtype)
        opts = options(rule, dtype)
        stall = opts.resolved_stall_limit(state.m, state.n)
        cl, gc = kbc.blocked_cluster_reference(state, opts, stall,
                                               opts.max_iters, K, G)
        assert_walks_equal(out, cl, g, gc)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("instance", list(INSTANCES))
def test_plain_grid_walk_equals_the_stages_on_every_instance(instance,
                                                             dtype):
    """Every instance of the stage tests (the unbounded, infeasible, NUMERIC
    and exposed-ray walks, Beale's cycling LP, the pivot on 1e-5) under
    Dantzig and devex, on grids of 3 and 7."""
    for rule in ("dantzig", "devex"):
        for G in (3, 7):
            (out, g), (ref, gr) = walks(instance, rule, dtype, G)
            assert_walks_equal(out, ref, g, gr)


@pytest.mark.parametrize("rule", ["dantzig", "devex", "maxpiv"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_a_block_equals_the_plain_stages_block(dtype, rule):
    """One block of the grid's plain version against K plain slots on the
    same record, block after block: every field of the carry (the factors,
    the running vectors, the weights, the basis, the masks, the walk's
    scalars and t, last_z) equal."""
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
        kg.blocked_grid_block_reference(a, opts, stall, mi, 7)
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

@pytest.mark.parametrize("budget", [1, 6, 13])
@pytest.mark.parametrize("rule", ["dantzig", "devex"])
def test_budget_stops_inside_a_block(rule, budget):
    """A budget that is not a multiple of K ends the walk inside a block:
    the slots past it pivot nowhere; the walk equals the stages' in every
    field, and its exit is tpulp's (status, pivots, basis)."""
    (out, g), (ref, gr) = walks("long", rule, torch.float64, 7, budget)
    assert_walks_equal(out, ref, g, gr)
    assert int(out.niter) == budget
    tp = _tpulp("long", rule, jnp.float64, max_iters=budget, block=K)
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
    (out, g), (ref, gr) = walks("long", "dantzig", torch.float64, 3, budget)
    assert_walks_equal(out, ref, g, gr)
    assert int(out.status) == Status.OPTIMAL and int(out.niter) == budget


def test_every_edge_event_is_covered(monkeypatch):
    """The grid's plain walks go through every kind of slot and block end
    (a spy on the plain finish and ray stages): the clean-up pivot and the
    retire, the phase change with devex's reset, the 1e8 reset, the stall
    switch to Bland, a budget stop inside a block, the exposed ray and the
    optimal, unbounded, infeasible and NUMERIC exits; each walk equals the
    stages' in every field."""
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
    for q, (instance, rule, budget) in enumerate(cases):
        devex[0] = rule == "devex"
        monkeypatch.setattr(kb, "blocked_finish_reference", finish_spy)
        monkeypatch.setattr(kb, "blocked_ray_reference", ray_spy)
        state = port_state(instance, torch.float64)
        opts = options(rule, torch.float64)
        stall = opts.resolved_stall_limit(state.m, state.n)
        mi = opts.max_iters if budget is None else budget
        out, g = kg.blocked_grid_reference(state, opts, stall, mi, K,
                                           GRIDS[q % len(GRIDS)])
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
            ref, gr = kb.blocked_walk_reference(state, opts, stall,
                                                opts.max_iters, K)
            for G in (1, 7):
                out, g = kg.blocked_grid_reference(
                    state, opts, stall, opts.max_iters, K, G)
                assert_walks_equal(out, ref, g, gr)


def test_the_callers_state_is_never_written():
    state = port_state("equalities", torch.float64)
    before = [x.clone() for x in state]
    opts = options("devex", torch.float64)
    stall = opts.resolved_stall_limit(state.m, state.n)
    out, _ = kg.blocked_grid_reference(state, opts, stall, opts.max_iters,
                                       K, 3)
    assert int(out.status) == Status.OPTIMAL
    for x, y in zip(state, before):
        assert torch.equal(as_bits(x), as_bits(y))


# ---------------------------------------------------------------------------
# the sums, in the kernels' order, from one helper
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("length", [1, 65, 600, 1537])
def test_grid_sum_over_row_slabs_is_the_kernel_order(length):
    """The |bvec[2:]| sum of the grid: each block's H rows as one block of
    512 threads adds them, then lane l adds blocks l, l + 32, ... and the
    shuffle tree the lanes; bit for bit on values whose order changes the
    sum, with slabs that run past the vector."""
    rng = np.random.default_rng(length)
    vals = (rng.standard_normal(length)
            * 10.0 ** rng.integers(-8, 9, length)).tolist()
    x = torch.tensor(vals, dtype=torch.float64)
    for G in (1, 3, 7, 40):
        H = -(-length // G)
        parts = [_emulated_block_sum(vals[g * H:(g + 1) * H], 512)
                 if g * H < length else 0.0 for g in range(G)]
        lanes = [0.0] * 32
        for g, p in enumerate(parts):
            lanes[g % 32] = lanes[g % 32] + p
        span = 32
        while span > 1:
            span //= 2
            lanes = [lanes[i] + lanes[i + span] for i in range(span)]
        assert float(sums.grid_sum(x, H, G)) == lanes[0]


def test_one_helper_serves_every_plain_version():
    """The blocked launches' block sums, the cluster walks' slab sums and
    the grid walks' sums are ``sums``'s, one code path: each module's name
    is the helper itself or a call of ``block_sums``."""
    assert kc.block_sums is sums.block_sums and kc.slab_sum is sums.slab_sum
    assert kc.block_sum is sums.block_sum and kbg.grid_sum is sums.grid_sum
    assert kbc.slab_sum is sums.slab_sum and kg.grid_sum is sums.grid_sum
    x = torch.rand((3, kb.GRID_THREADS), dtype=torch.float64)
    assert torch.equal(kb._block_sum(x), sums.block_sums(
        x.reshape(-1), kb.GRID_THREADS, 3, kb.GRID_THREADS))


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

def _bytes(M, N, K, G, es):
    """The kernel's layout, each segment rounded up to 16 bytes: V's and
    U's slabs; row0, row1, the weights (W each); bvec, colj (H each); U's
    rows 0 and 1, V's column N - 1, the fetched V and U columns and the
    clean-up row's (K each); the basis; the slab's active mask; the
    artificial mask, a bit a column in 32-bit words; the G 64-byte mailbox
    headers a combine brings."""
    up = lambda x: -(-x // 16) * 16  # noqa: E731
    W, H = -(-N // G), -(-M // G)
    return (up(K * W * es) + up(K * H * es) + 3 * up(W * es)
            + 2 * up(H * es) + 6 * up(K * es) + up(4 * (M - 2)) + up(W)
            + up(4 * -(-(N - 1) // 32)) + up(64 * G))


def _mail(G, K, es):
    """The mailboxes: G 64-byte price headers, G 32-byte ratio headers, G
    blocks' two V columns and 32-byte tail, their two U columns and tail,
    the clean-up column."""
    vec = -(-K * es // 16) * 16
    return G * (64 + 2 * vec + 32) + G * (32 + 2 * vec + 32) + vec


@pytest.mark.parametrize("shape", [
    # 5d (g): the wide LP at f64 and f32
    (258, 14257, 64, torch.float64, 131),
    (258, 14257, 64, torch.float32, 131),
    (258, 14257, 128, torch.float64, 131),
    # past the cluster at the top of auto's range, and a tall LP
    (1538, 2600, 64, torch.float64, 130),
    (4098, 8193, 64, torch.float32, 131),
    (514, 1537, 1024, torch.float64, 129),
    # a tiny tableau: one block a column
    (5, 8, 4, torch.float64, 8),
], ids=lambda s: f"{s[0]}x{s[1]}-K{s[2]}-{str(s[3])[6:]}")
def test_blocked_grid_plan(shape):
    """G = ceil(N / ceil(N / 132)), W = ceil(N / G), H = ceil(M / G); the
    bytes are the kernel's layout, within the limit; the mailboxes'
    bytes."""
    M, N, Kb, dtype, G = shape
    es = 8 if dtype == torch.float64 else 4
    plan = kg.blocked_grid_plan(M, N, Kb, dtype, 132)
    assert plan == kg.BlockedGridPlan(G, -(-N // G), -(-M // G), 512,
                                      _bytes(M, N, Kb, G, es),
                                      _mail(G, Kb, es))
    assert plan.smem <= kg.BLOCKED_GRID_SMEM_LIMIT == 229_376


def test_blocked_grid_plan_worked_check():
    """258 x 14,257 at f64, K = 64, on 132 SMs: 131 blocks of 109 columns
    and 2 rows, 55,808 bytes of V's slab, 1,024 of U's, 8,384 of headers,
    73,888 in all; a forced grid of 7 on a tiny tableau leaves blocks with
    no column and no row."""
    plan = kg.blocked_grid_plan(258, 14257, 64, torch.float64)
    assert (plan.blocks, plan.width, plan.height) == (131, 109, 2)
    assert 64 * 109 * 8 == 55_808 and 64 * 2 * 8 == 1_024
    assert 64 * 131 == 8_384 and plan.smem == 73_888
    tiny = kg.blocked_grid_plan(5, 10, 4, torch.float64, 132, blocks=7)
    assert (tiny.blocks, tiny.width, tiny.height) == (7, 2, 1)
    assert 5 * tiny.width == 10 and 5 * tiny.height == 5  # blocks 5, 6 idle


@pytest.mark.parametrize("case", [
    # (g)'s LP in blocks of 1024 (and 256): past a block's shared memory
    (258, 14257, 1024, torch.float64),
    (258, 14257, 256, torch.float64),
    (258, 14257, 1024, torch.float32),
    # M + N past ~56,000 at K 64, f64
    (20002, 40001, 64, torch.float64),
], ids=lambda c: f"{c[0]}x{c[1]}-K{c[2]}-{str(c[3])[6:]}")
def test_blocked_grid_plan_refuses_past_the_shared_memory(case):
    M, N, Kb, dtype = case
    with pytest.raises(kg.GridPlanTooLarge, match="shared memory"):
        kg.blocked_grid_plan(M, N, Kb, dtype)


def test_blocked_grid_plan_refusals():
    with pytest.raises(ValueError, match="float32 or float64"):
        kg.blocked_grid_plan(514, 1537, 64, torch.float16)
    with pytest.raises(ValueError, match="outside"):
        kg.blocked_grid_plan(2, 1537, 64, torch.float64)
    with pytest.raises(ValueError, match="outside"):
        kg.blocked_grid_plan(514, 1537, 0, torch.float64)
    with pytest.raises(ValueError, match="outside"):
        kg.blocked_grid_plan(514, 1537, 2048, torch.float64)
    with pytest.raises(ValueError, match="expected 1 to 132"):
        kg.blocked_grid_plan(514, 1537, 64, torch.float64, 132, blocks=133)
    with pytest.raises(ValueError, match="expected 1 to 132"):
        kg.blocked_grid_plan(514, 1537, 64, torch.float64, 132, blocks=0)


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    # a cluster holds the block: the cluster, whatever the grid
    (514, 1537, 64, torch.float64, 15, 1, "blocked_cluster"),
    # past the cluster: the grid where the card holds it
    (258, 14257, 64, torch.float64, 15, 1, "blocked_grid"),
    (258, 14257, 64, torch.float32, 15, 1, "blocked_grid"),
    (1026, 8193, 64, torch.float64, 15, 2, "blocked_grid"),
    # the card holds no cluster: the grid
    (514, 1537, 64, torch.float64, 0, 1, "blocked_grid"),
    # the card holds no grid: blocked_step
    (258, 14257, 64, torch.float64, 15, 0, "blocked_step"),
    # past the grid's plan: blocked_step
    (258, 14257, 1024, torch.float64, 15, 1, "blocked_step"),
    (20002, 40001, 64, torch.float64, 15, 1, "blocked_step"),
], ids=lambda c: f"{c[0]}x{c[1]}-K{c[2]}-{str(c[3])[6:]}-{c[6]}")
def test_blocked_route_has_three_ways(monkeypatch, case):
    """The cluster where its plan fits and the card holds one cluster; else
    the grid where its plan fits and the card holds the whole grid at once
    (occupancy patched, 132 SMs); else ``blocked_step``. The grid's
    occupancy is asked only of a plan that fits."""
    M, N, Kb, dtype, occ_c, occ_g, want = case
    asked = []

    def grid_occupancy(*args):
        asked.append(args)
        return occ_g

    monkeypatch.setattr(pb, "blocked_cluster_occupancy", lambda *a: occ_c)
    monkeypatch.setattr(pb, "blocked_grid_occupancy", grid_occupancy)
    monkeypatch.setattr(pb, "sm_count", lambda device: 132)
    assert pb.blocked_route(M, N, Kb, dtype,
                            torch.device("cuda", 0)) == want
    fits = True
    try:
        kg.blocked_grid_plan(M, N, Kb, dtype, 132)
    except ValueError:
        fits = False
    assert len(asked) == int(fits and want != "blocked_cluster")


def test_blocked_route_needs_the_whole_grid(monkeypatch):
    """On a card of 100 SMs the plan takes 100 blocks of 143 columns: a
    card that holds one block an SM holds the grid; one that holds none
    does not, and the walk takes ``blocked_step``."""
    monkeypatch.setattr(pb, "blocked_cluster_occupancy", lambda *a: 15)
    monkeypatch.setattr(pb, "sm_count", lambda device: 100)
    occ = [1]
    monkeypatch.setattr(pb, "blocked_grid_occupancy", lambda *a: occ[0])
    dev = torch.device("cuda", 0)
    assert pb.blocked_route(258, 14257, 64, torch.float64, dev) == \
        "blocked_grid"
    occ[0] = 0
    assert pb.blocked_route(258, 14257, 64, torch.float64, dev) == \
        "blocked_step"


def _grid_route(monkeypatch, grid):
    """Patch the route's questions so that a solve takes the grid, with
    ``grid`` in place of ``blocked_grid``; the other kernels refuse."""
    def refuse(*args, **kw):
        raise AssertionError("another route ran")

    monkeypatch.setattr(pb, "on_cpu", lambda *t: False)
    monkeypatch.setattr(pb, "blocked_cluster_occupancy", lambda *a: 0)
    monkeypatch.setattr(pb, "blocked_grid_occupancy", lambda *a: 1)
    monkeypatch.setattr(pb, "sm_count", lambda device: 132)
    for name in ("run_simplex_blocked_reference",
                 "run_simplex_blocked_batch_reference", "_blocked_pivot",
                 "blocked_steps", "blocked_cluster", "blocked_cluster_batch"):
        monkeypatch.setattr(pb, name, refuse)
    monkeypatch.setattr(pb, "blocked_grid", grid)


def test_cuda_dispatch_takes_the_grid_with_no_fallback(monkeypatch):
    """``run_simplex_blocked`` on a state it must treat as on the card, on
    the grid route: ``blocked_grid`` gets a contiguous tableau, the stall
    limit, the budget and the block; no other kernel and no eager loop
    runs; its launch failure raises."""
    seen = []

    def spy(state, opts, stall_limit, max_iters, block):
        seen.append((state.T.is_contiguous(), stall_limit, max_iters, block))
        return state, None

    _grid_route(monkeypatch, spy)
    state = port_state("bounded1", torch.float64)
    strided = state._replace(T=state.T.t().contiguous().t())
    out = pb.run_simplex_blocked(strided, options(
        "dantzig", torch.float64, max_iters=77), block=16)
    assert seen == [(True, state.m + state.n, 77, 16)]
    assert int(out.status) == Status.ITERATION_LIMIT

    def fail(*args, **kw):
        raise RuntimeError("tpulp_torch blocked_grid: CUDA error 720")

    monkeypatch.setattr(pb, "blocked_grid", fail)
    with pytest.raises(RuntimeError, match="blocked_grid"):
        pb.run_simplex_blocked(state)


def _batch():
    """Three lanes of the long LP: as it is, already OPTIMAL (a lane that is
    not running at the first block's start) and with its costs scaled."""
    s = port_state("long", torch.float64)
    T = s.T.clone()
    T[0, :-1] *= 1.5
    lanes = [s, s._replace(status=torch.tensor(Status.OPTIMAL,
                                               dtype=torch.int32)),
             s._replace(T=T)]
    return SimplexState(*(torch.stack(xs) for xs in zip(*lanes)))


def test_batch_past_the_cluster_walks_each_lane_on_the_grid(monkeypatch):
    """``run_simplex_blocked_batch`` past the cluster's plan, on the grid
    route: each lane's solo walk in turn (``blocked_grid``, here its plain
    version on 3 blocks), stacked in lane order; every lane equals its solo
    walk bit for bit, and the lane that was not running keeps its state
    whole."""
    calls = []

    def grid(state, opts, stall_limit, max_iters, block):
        calls.append(int(state.status))
        return kg.blocked_grid_reference(state, opts, stall_limit,
                                         max_iters, block, 3)

    _grid_route(monkeypatch, grid)
    batched = _batch()
    opts = options("devex", torch.float64)
    out = pb.run_simplex_blocked_batch(batched, opts, block=K)
    assert len(calls) == batched.T.shape[0]
    stall = opts.resolved_stall_limit(batched.T.shape[1] - 2,
                                      batched.T.shape[2] - 1)
    for k in range(batched.T.shape[0]):
        lane = SimplexState(*(x[k] for x in batched))
        solo, _ = kg.blocked_grid_reference(lane, opts, stall,
                                            opts.max_iters, K, 3)
        solo = pb.finish(solo)
        for name, a, b in zip(out._fields, out, solo):
            assert torch.equal(as_bits(a[k]), as_bits(b)), (k, name)
    frozen = SimplexState(*(x[1] for x in batched))
    for name, a, b in zip(out._fields, out, frozen):
        assert torch.equal(as_bits(a[1]), as_bits(b)), name
    assert int(out.status[0]) == int(out.status[2]) == Status.OPTIMAL


def test_cpu_walks_never_reach_the_grid(monkeypatch):
    """On CPU tensors the solo and batch walks are the eager loops: no
    route asked, no grid launched, no launch counted."""
    def refuse(*args, **kw):
        raise AssertionError("a kernel route was taken on the CPU")

    for name in ("blocked_grid", "blocked_route", "blocked_grid_occupancy",
                 "blocked_steps"):
        monkeypatch.setattr(pb, name, refuse)
    monkeypatch.setattr(kg, "blocked_grid_block", refuse)
    reset_launches()
    state = port_state("long", torch.float64)
    opts = options("devex", torch.float64)
    out = pb.run_simplex_blocked(state, opts, block=K)
    ref = pb.run_simplex_blocked_reference(state, opts, block=K)
    for name in out._fields:
        assert torch.equal(as_bits(getattr(out, name)),
                           as_bits(getattr(ref, name))), name
    pb.run_simplex_blocked_batch(_batch(), opts, block=K)
    assert all(v == 0 for v in LAUNCHES.values())


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def _small():
    return port_state("bounded1", torch.float64), \
        options("dantzig", torch.float64)


def test_blocked_grid_raises_on_cpu_tensors():
    state, opts = _small()
    reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        kg.blocked_grid(state, opts, 10, 10, K)
    with pytest.raises(ValueError, match="CUDA"):
        kg.blocked_grid_block(kb.make_record(state, K), opts, 10, 10)
    assert LAUNCHES["blocked_grid"] == 0


def test_blocked_grid_raises_on_mixed_devices():
    state, opts = _small()
    with pytest.raises(ValueError, match="CUDA"):
        kg.blocked_grid(state._replace(basis=state.basis.to("meta")), opts,
                        10, 10, K)


def test_blocked_grid_raises_on_float16_and_a_strided_tableau():
    state, opts = _small()
    half = state._replace(T=state.T.half(), last_z=state.last_z.half())
    with pytest.raises(ValueError, match="float32 or float64"):
        kg.blocked_grid(half, opts, 10, 10, K)
    strided = state._replace(T=state.T.t().contiguous().t())
    with pytest.raises(ValueError, match="contiguous"):
        kg.blocked_grid(strided, opts, 10, 10, K)


def test_blocked_grid_raises_on_a_block_past_the_plan(monkeypatch):
    """(g)'s LP in blocks of 1024 slots: the plan refuses it before any
    launch."""
    state = port_state("bounded1", torch.float64)
    wide = state._replace(T=torch.zeros((258, 14257), dtype=torch.float64))
    monkeypatch.setattr(kb, "_check", lambda *a: None)
    monkeypatch.setattr(kg, "sm_count", lambda device: 132)
    reset_launches()
    with pytest.raises(kg.GridPlanTooLarge):
        kg.blocked_grid(wide, options("dantzig", torch.float64), 10, 10,
                        1024)
    assert LAUNCHES["blocked_grid"] == 0


def test_blocked_grid_raises_when_the_card_holds_no_grid(monkeypatch):
    """A grid the card cannot hold at once (its occupancy times the SMs
    below G) raises before any launch."""
    state, opts = _small()
    asked = []

    def occupancy(M, N, Kb, dtype, device, blocks):
        asked.append((M, N, Kb, blocks))
        return 0

    monkeypatch.setattr(kb, "_check", lambda *a: None)
    monkeypatch.setattr(kg, "sm_count", lambda device: 132)
    monkeypatch.setattr(kg, "blocked_grid_occupancy", occupancy)
    reset_launches()
    with pytest.raises(RuntimeError, match="not a grid of 3"):
        kg.blocked_grid(state, opts, 10, 10, K, blocks=3)
    assert asked == [(*state.T.shape, K, 3)]
    assert LAUNCHES["blocked_grid"] == 0


def test_blocked_grid_block_refuses_a_batched_record(monkeypatch):
    """The launch takes a solo record: a batched one (past the record's
    own checks, patched here) is refused before any launch."""
    state, opts = _small()
    batched = SimplexState(*(torch.stack([x, x]) for x in state))
    monkeypatch.setattr(kb, "_entry", lambda *a: (None, None, [0] * 8, None))
    reset_launches()
    with pytest.raises(ValueError, match="solo record"):
        kg.blocked_grid_block(kb.make_batch_record(batched, K), opts, 10, 10)
    assert LAUNCHES["blocked_grid"] == 0


# ---------------------------------------------------------------------------
# on a card only: the kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cuda_blocked_grid_matches_its_plain_version(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py's phase 5d runs these "
                    "checks at full size)")
    from tpulp_torch.kernels.block import fused_flush

    tt = getattr(torch, dtype)
    for instance in INSTANCES:
        for rule in RULES:
            state = port_state(instance, tt)
            state = type(state)(*(x.cuda() for x in state))
            opts = options(rule, tt, max_iters=500)
            stall = opts.resolved_stall_limit(state.m, state.n)
            for G in GRIDS:
                for budget in (opts.max_iters, 5):
                    out, g = kg.blocked_grid(state, opts, stall, budget, K,
                                             blocks=G)
                    ref, gr = kg.blocked_grid_reference(
                        state, opts, stall, budget, K, G, flush=fused_flush)
                    torch.cuda.synchronize()
                    assert_walks_equal(type(out)(*(x.cpu() for x in out)),
                                       type(ref)(*(x.cpu() for x in ref)),
                                       g.cpu(), gr.cpu())
