"""The solo bounded walk in one cooperative launch
(``tpulp_torch/kernels/bounded_grid.py``), held on the CPU through its
plain version ``bounded_grid_reference``: on 1, 2, 3 and 7 slabs, at f64
and f32, under Dantzig, devex and a stall limit of 1 (Bland), it equals
``bounded_simplex_step`` walked step by step in every field (the tableau as
``T + 0.0``, the devex weights, the entering flips and upper hits), through
phase 1 with a retire, a phase-2 clean-up, upper hits, entering flips, a
devex reset, the redirected pivot both skipped and run, and budgets of 1
and 7 steps; at f64 it ends where tpulp's jitted bounded walk does
(status, pivots, basis, objective), also on the grid of a streamed plan
(the slabs' rows split between shared and device memory).
``bounded_grid_plan``'s arithmetic (resident and streamed plans, forced
splits, the shared-memory refusal), ``bounded_route``, the wrapper's
refusals and the CPU dispatch are held here too. The kernel itself runs
on the card only (the ``cuda`` tests; chip_smoke.py's phase 8a holds it at
full size)."""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpulp_torch
import tpulp_torch.kernels.bounded as kb
import tpulp_torch.kernels.bounded_grid as kg
import tpulp_torch.solve.bounded as pbounded
from tpulp.core.state import SolverOptions as TpulpOptions
from tpulp.solve.api import state_from_standard_form as tpulp_state
from tpulp.solve.bounded import make_bounded_state as tpulp_bounded
from tpulp.solve.bounded import run_simplex_bounded as tpulp_run
from tpulp_torch.core import SolverOptions, Status
from tpulp_torch.core.state import RULE_DEVEX
from tpulp_torch.kernels import LAUNCHES, reset_launches
from tpulp_torch.kernels.rank1_cluster import block_sum
from tpulp_torch.solve.bounded import (bounded_route, bounded_simplex_step,
                                       run_simplex_bounded,
                                       run_simplex_bounded_reference)

from test_torch_bounded import RULES
from test_torch_bounded_kernel import (CASE_IDS, CASES, Events,
                                       assert_same_state, case_lp, in_phase2,
                                       port_state)
from test_torch_model import to_port

torch.set_num_threads(1)

SLABS = (1, 2, 3, 7)


def plain_walk(bs, opts, stall, max_iters):
    """``bounded_simplex_step`` to the walk's exit or the budget, with the
    events it went through."""
    ev = Events()
    for _ in range(10_000):
        nxt = bounded_simplex_step(bs, opts, stall, max_iters)
        ev.see(bs, nxt)
        if int(nxt.s.status) != Status.RUNNING or (
                int(nxt.s.niter) == int(bs.s.niter) == max_iters):
            return nxt, ev
        bs = nxt
    raise AssertionError("the plain walk did not end")


def assert_walks_equal(bs, opts, stall, max_iters, blocks):
    out, counts = kg.bounded_grid_reference(bs, opts, stall, max_iters,
                                            blocks)
    ref, ev = plain_walk(bs, opts, stall, max_iters)
    assert_same_state(out, ref)
    assert counts == {"entering_flips": ev.entering_flips,
                      "upper_hits": ev.upper_hits}
    return out, ev


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("rule", list(RULES))
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_reference_equals_the_step(case, rule, dtype):
    """Every slab count gives the plain step's walk, bit for bit."""
    bs, opts = port_state(case, getattr(torch, dtype), RULES[rule])
    stall = opts.resolved_stall_limit(bs.s.m, bs.s.n)
    for blocks in SLABS:
        out, ev = assert_walks_equal(bs, opts, stall, 400, blocks)
    assert int(out.s.status) != Status.RUNNING
    if case[0] == "redundant":
        assert ev.phase_changes == 1 and ev.retires >= 1
    elif case[0] == "cleanup":
        assert ev.cleanups > 0 and ev.retires >= 1
    else:
        assert ev.upper_hits + ev.entering_flips > 0
    if rule == "bland":
        assert bool(out.s.bland)


@pytest.mark.parametrize("budget", [1, 7])
@pytest.mark.parametrize("rule", ["dantzig", "devex"])
def test_reference_holds_the_budget(rule, budget):
    bs, opts = port_state(CASES[1], torch.float64, RULES[rule])
    stall = opts.resolved_stall_limit(bs.s.m, bs.s.n)
    for blocks in SLABS:
        out, _ = assert_walks_equal(bs, opts, stall, budget, blocks)
        assert int(out.s.niter) == budget
        assert int(out.s.status) == Status.RUNNING


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_reference_resets_devex_weights_past_the_threshold(dtype):
    """Weights above DEVEX_RESET_ABOVE at the start: the plain step resets
    them all after its first step (the kernel, at the next step's combine or
    after its last step), also on a walk cut after one step."""
    bs, opts = port_state(CASES[0], getattr(torch, dtype), RULES["devex"])
    gamma = bs.gamma.clone()
    gamma[::3] = 3e8
    bs = bs._replace(gamma=gamma)
    stall = opts.resolved_stall_limit(bs.s.m, bs.s.n)
    for budget in (1, 400):
        for blocks in SLABS:
            out, _ = assert_walks_equal(bs, opts, stall, budget, blocks)
            assert float(out.gamma.max()) < kb.DEVEX_RESET_ABOVE


def test_redirected_pivot_skipped_and_run():
    """A step that pivots nowhere skips the redirected pivot on (row 2,
    basis[0]) where that is an exact no-op, and runs it where column
    basis[0] is not the unit vector (an entry of 1e-300 in the objective
    row): both walks equal the plain step's."""
    bs, opts = port_state(CASES[0], torch.float64, RULES["dantzig"])
    stall = opts.resolved_stall_limit(bs.s.m, bs.s.n)
    T = bs.s.T.clone()
    T[0, int(bs.s.basis[0])] = 1e-300
    bent = bs._replace(s=bs.s._replace(T=T))
    for state, want_noop in ((bs, True), (bent, False)):
        seen = set()
        cur = state
        for _ in range(400):
            nxt = bounded_simplex_step(cur, opts, stall)
            if bool((nxt.s.basis == cur.s.basis).all()):
                seen.add(kb.noop_exact(cur.s.T, int(cur.s.basis[0])))
            if int(nxt.s.status) != Status.RUNNING:
                break
            cur = nxt
        assert want_noop in seen
        for blocks in SLABS:
            assert_walks_equal(state, opts, stall, 400, blocks)


def test_numeric_walks_equal_the_step():
    """A NaN in the RHS and an overflowing |b| sum end NUMERIC as the
    plain step does."""
    for dtype in (torch.float64, torch.float32):
        bs, opts = port_state(CASES[2], dtype, RULES["devex"])
        stall = opts.resolved_stall_limit(bs.s.m, bs.s.n)
        for row, val in ((4, float("nan")),
                         (slice(3, 5), torch.finfo(dtype).max / 1.5)):
            T = bs.s.T.clone()
            T[row, -1] = val
            state = bs._replace(s=bs.s._replace(T=T))
            for blocks in (1, 3):
                out, _ = assert_walks_equal(state, opts, stall, 400, blocks)
                assert int(out.s.status) == Status.NUMERIC


@pytest.mark.parametrize("rule", list(RULES))
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_reference_ends_where_tpulp_does(case, rule):
    """At f64 the walk on 3 slabs ends where tpulp's jitted bounded walk
    does: status, pivots, basis and objective."""
    sf = case_lp(case).lower(simple_bounds=True)
    jo = TpulpOptions.for_dtype(jnp.float64, **RULES[rule])
    js = tpulp_bounded(tpulp_state(sf), sf.upper)
    if case[0] == "cleanup":
        js = js._replace(s=in_phase2(js.s, lambda v: jnp.int32(v)))
    ref = tpulp_run(js, jo)
    bs, opts = port_state(case, torch.float64, RULES[rule])
    stall = opts.resolved_stall_limit(bs.s.m, bs.s.n)
    out, _ = kg.bounded_grid_reference(bs, opts, stall, opts.max_iters, 3)
    out = pbounded._finish(out)
    for name in ("status", "niter", "basis"):
        assert np.array_equal(getattr(out.s, name).numpy(),
                              np.asarray(getattr(ref.s, name))), name
    assert float(out.s.objective()) == float(ref.s.objective())


@pytest.mark.parametrize("rule", list(RULES))
def test_reference_at_a_forced_split_ends_where_tpulp_does(rule):
    """On the grid of a streamed plan (rows 0-2 in shared memory, the rest
    streamed) the plain walk ends where tpulp's jitted bounded walk does at
    f64: status, pivots, basis and the tableau itself."""
    case = CASES[1]
    sf = case_lp(case).lower(simple_bounds=True)
    jo = TpulpOptions.for_dtype(jnp.float64, **RULES[rule])
    ref = tpulp_run(tpulp_bounded(tpulp_state(sf), sf.upper), jo)
    bs, opts = port_state(case, torch.float64, RULES[rule])
    plan = kg.bounded_grid_plan(*bs.s.T.shape, torch.float64, 132, blocks=3,
                                rows=3)
    assert plan.rows == 3 and plan.scratch > 0
    stall = opts.resolved_stall_limit(bs.s.m, bs.s.n)
    out, _ = kg.bounded_grid_reference(bs, opts, stall, opts.max_iters,
                                       plan.blocks)
    out = pbounded._finish(out)
    for name in ("status", "niter", "basis"):
        assert np.array_equal(getattr(out.s, name).numpy(),
                              np.asarray(getattr(ref.s, name))), name
    assert np.array_equal(out.s.T.numpy() + 0.0, np.asarray(ref.s.T) + 0.0)


@pytest.mark.parametrize("blocks", [7, 40, 100])
def test_grid_sum_is_the_kernel_order(blocks):
    """``grid_sum`` adds each slab as one block of GRID_THREADS threads
    does; then lane l adds the slabs l, l + 32, ... in turn, and the
    lanes' shuffle tree adds the 32 lanes."""
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.normal(size=1000) * 1e3, dtype=torch.float64)
    W, G = kg.grid_slabs(1000, blocks)
    parts = [float(block_sum(x[g * W:(g + 1) * W], kg.GRID_THREADS))
             for g in range(G)]
    lanes = [0.0] * 32
    for g, part in enumerate(parts):
        lanes[g % 32] += part
    while len(lanes) > 1:
        half = len(lanes) // 2
        lanes = [a + b for a, b in zip(lanes[:half], lanes[half:])]
    assert float(kg.grid_sum(x, W, G)) == lanes[0]
    big = torch.full((20,), torch.finfo(torch.float64).max / 4,
                     dtype=torch.float64)
    assert not math.isfinite(float(kg.grid_sum(big, 3, 7)))


# ---------------------------------------------------------------------------
# the plan and the route
# ---------------------------------------------------------------------------

def test_plan_at_8a_shape():
    """8a's 1026 x 3073 frame on 132 SMs: 24 columns a block, 128 blocks;
    the slab, the RHS, the row and weight segments, the basis and the
    masks within the shared memory a block may take."""
    for dtype, es in ((torch.float64, 8), (torch.float32, 4)):
        plan = kg.bounded_grid_plan(1026, 3073, dtype, 132)
        assert (plan.blocks, plan.width, plan.threads) == (128, 24, 512)
        assert plan.smem == (1026 * 24 * es + 2 * kg._align(1026 * es)
                             + 2 * kg._align(24 * es) + 1024 * es
                             + 4 * 1024 + 32 + 3072)
        assert plan.smem <= kg.GRID_SMEM_LIMIT
        assert plan.mail == 64 * (3 * 128 + 1)
    assert kg.bounded_grid_plan(1026, 3073, torch.float64).smem == 229_184


def test_plan_width_floor_on_small_frames():
    """9c's 130 x 385 frame takes 12 blocks of 32 columns, not 132 slabs
    of three; a 14 x 33 frame one block."""
    plan = kg.bounded_grid_plan(130, 385, torch.float64, 132)
    assert (plan.blocks, plan.width) == (12, 32)
    assert kg.bounded_grid_plan(14, 33, torch.float64).blocks == 1
    assert kg.bounded_grid_plan(66, 193, torch.float64, blocks=7)[:2] == \
        (7, 28)


# the last m (n = 2m: an (m + 2) x (2m + 1) frame) that a streamed plan
# takes on 132 SMs, by type (bounded_grid_plan's docstring)
STREAMED_LAST_M = {torch.float64: 6_282, torch.float32: 10_798}


def test_plan_refuses_frames_past_shared_memory():
    """The streamed plan's edge: the last frame it takes keeps rows 0-2 in
    shared memory, the next is refused with ``GridPlanTooLarge`` (a
    ValueError); another type and an out-of-range grid are refused with
    plain ValueErrors."""
    for dtype, m in STREAMED_LAST_M.items():
        plan = kg.bounded_grid_plan(m + 2, 2 * m + 1, dtype, 132)
        assert plan.rows == 3 and plan.stages == kg.GRID_RING_STAGES
        with pytest.raises(kg.GridPlanTooLarge, match="shared memory"):
            kg.bounded_grid_plan(m + 3, 2 * m + 3, dtype, 132)
    # 2050 x 6145 f64 (slabs of 47 columns) streams; 8,000 rows of a
    # narrow frame do not fit their replicated vectors
    assert kg.bounded_grid_plan(2050, 6145, torch.float64, 132).rows < 2050
    with pytest.raises(kg.GridPlanTooLarge):
        kg.bounded_grid_plan(8000, 3, torch.float64, 132)
    with pytest.raises(ValueError, match="float32 or float64") as err:
        kg.bounded_grid_plan(130, 385, torch.float16)
    assert not isinstance(err.value, kg.GridPlanTooLarge)
    with pytest.raises(ValueError, match="blocks") as err:
        kg.bounded_grid_plan(130, 385, torch.float64, 132, blocks=200)
    assert not isinstance(err.value, kg.GridPlanTooLarge)


def test_route_on_each_side_of_the_plan():
    """Every frame the plan takes, resident or streamed, routes to the
    grid; past the streamed plan's edge, to the four-launch step."""
    for M, N, dtype, sms in ((1026, 3073, torch.float64, 132),
                             (1026, 3073, torch.float32, 132),
                             (130, 385, torch.float64, 132),
                             (1026, 4097, torch.float32, 132),
                             (1026, 4097, torch.float64, 132),
                             (2050, 4097, torch.float64, 132),
                             (2050, 4097, torch.float32, 132),
                             # fewer SMs (an H100 PCIe has 114): wider slabs
                             (1026, 3073, torch.float64, 100),
                             (1026, 3073, torch.float64, 114)):
        assert bounded_route(M, N, dtype, sms=sms) == "bounded_grid"
    for dtype, m in STREAMED_LAST_M.items():
        assert bounded_route(m + 2, 2 * m + 1, dtype) == "bounded_grid"
        assert bounded_route(m + 3, 2 * m + 3, dtype) == "bounded_step"


def test_route_raises_on_other_refusals():
    """Only the plan's shared-memory refusal routes to the four-launch
    step: a float16 frame or one outside 2^24 raises."""
    with pytest.raises(ValueError, match="float32 or float64"):
        bounded_route(130, 385, torch.float16)
    with pytest.raises(ValueError, match="outside"):
        bounded_route(2, 385, torch.float64)
    with pytest.raises(ValueError, match="outside"):
        bounded_route(130, 2 ** 24, torch.float64)


@pytest.mark.parametrize("M,N,dtype,rows,tile_rows,scratch", [
    (2050, 4097, torch.float64, 461, 64, 52_428_800),
    (2050, 4097, torch.float32, 1117, 128, 16_777_216),
    (1026, 4097, torch.float64, 573, 64, 16_777_216),
], ids=["w_f64", "w_f32", "1026x4097_f64"])
def test_plan_streams_past_shared_memory(M, N, dtype, rows, tile_rows,
                                         scratch):
    """Past the resident slab: W and G as the resident plan would take
    them; R the most rows that fit beside the ring of GRID_RING_STAGES
    tiles and the replicated vectors (``_smem``'s arithmetic: one row more
    does not fit); tiles of TR rows (a power of two, about
    GRID_TILE_BYTES); the scratch G regions of ceil((M - R) / TR)
    tiles."""
    es = torch.tensor([], dtype=dtype).element_size()
    plan = kg.bounded_grid_plan(M, N, dtype, 132)
    n = N - 1
    W = max(-(-n // 132), -(-kg.GRID_MIN_ENTRIES // M))
    assert (plan.blocks, plan.width) == (-(-n // W), W)
    S = kg.GRID_RING_STAGES
    tile = kg._align(plan.tile_rows * W * es)
    assert (plan.rows, plan.stages, plan.tile_rows, plan.scratch) == \
        (rows, S, tile_rows, scratch)
    assert tile_rows * W * es == kg.GRID_TILE_BYTES
    assert plan.smem == kg._smem(M, N, W, es, rows, S, tile) <= \
        kg.GRID_SMEM_LIMIT
    assert kg._smem(M, N, W, es, rows + 1, S, tile) > kg.GRID_SMEM_LIMIT
    # the replicated vectors: 62,016 bytes at (w) f64
    if (M, N, dtype) == (2050, 4097, torch.float64):
        assert kg._smem(M, N, W, es, 0) == 62_016
    assert plan.scratch == plan.blocks * -(-(M - rows) // tile_rows) * tile


def test_plan_rows_forced():
    """``rows=`` forces R: 3 to M - 1 give streamed plans of that R (the
    tiles no taller than the streamed rows need), M the resident plan;
    below 3, above M and above the most that fit are refused."""
    M, N = 66, 193
    resident = kg.bounded_grid_plan(M, N, torch.float64, 132)
    assert (resident.rows, resident.stages, resident.scratch) == (M, 0, 0)
    assert kg.bounded_grid_plan(M, N, torch.float64, 132, rows=M) == resident
    for rows in (3, M // 2, M - 1):
        for blocks in (None, 1, 3, 7):
            plan = kg.bounded_grid_plan(M, N, torch.float64, 132,
                                        blocks=blocks, rows=rows)
            assert plan.rows == rows and plan.stages == kg.GRID_RING_STAGES
            assert plan[:2] == kg.bounded_grid_plan(
                M, N, torch.float64, 132, blocks=blocks)[:2]
            assert plan.tile_rows <= 2 * (M - rows)
            tiles = -(-(M - rows) // plan.tile_rows)
            assert plan.scratch == plan.blocks * tiles * kg._align(
                plan.tile_rows * plan.width * 8)
    for rows in (2, M + 1):
        with pytest.raises(ValueError, match="rows") as err:
            kg.bounded_grid_plan(M, N, torch.float64, 132, rows=rows)
        assert not isinstance(err.value, kg.GridPlanTooLarge)
    with pytest.raises(kg.GridPlanTooLarge, match="rows=462"):
        kg.bounded_grid_plan(2050, 4097, torch.float64, 132, rows=462)
    with pytest.raises(kg.GridPlanTooLarge, match="resident"):
        kg.bounded_grid_plan(2050, 4097, torch.float64, 132, rows=2050)


# ---------------------------------------------------------------------------
# the wrapper and the dispatch
# ---------------------------------------------------------------------------

def _small():
    return port_state(CASES[0], torch.float64, {})


def test_bounded_grid_raises_on_cpu_tensors():
    bs, opts = _small()
    with pytest.raises(ValueError, match="CUDA"):
        kg.bounded_grid(bs, opts, 10, 10)


def test_bounded_grid_raises_on_mixed_devices():
    bs, opts = _small()
    with pytest.raises(ValueError, match="CUDA"):
        kg.bounded_grid(bs._replace(upper=bs.upper.to("meta")), opts, 10,
                        10)


def test_bounded_grid_raises_on_float16():
    bs, opts = _small()
    half = bs._replace(s=bs.s._replace(T=bs.s.T.half()),
                       upper=bs.upper.half())
    with pytest.raises(ValueError, match="float32 or float64"):
        kg.bounded_grid(half, opts, 10, 10)


def test_bounded_grid_raises_on_a_strided_tableau():
    bs, opts = _small()
    T = bs.s.T
    wide = torch.zeros((T.shape[0], 2 * T.shape[1]), dtype=T.dtype)
    wide[:, ::2] = T
    with pytest.raises(ValueError, match="contiguous"):
        kg.bounded_grid(bs._replace(s=bs.s._replace(T=wide[:, ::2])), opts,
                        10, 10)


def test_bounded_grid_raises_on_devex_without_gamma():
    bs, _ = _small()
    opts = SolverOptions.for_dtype(torch.float64, rule=RULE_DEVEX)
    with pytest.raises(ValueError, match="gamma"):
        kg.bounded_grid(bs, opts, 10, 10)
    with pytest.raises(ValueError, match="gamma"):
        kg.bounded_grid_reference(bs, opts, 10, 10)


def test_dispatch_takes_the_route(monkeypatch):
    """On the card ``run_simplex_bounded`` hands ``bounded_route``'s kernel
    a contiguous tableau: ``bounded_grid`` within the plan, resident or
    streamed, ``bounded_steps`` past it (the CUDA dispatch, ``on_cpu``
    patched)."""
    seen = []

    def spy(name):
        def run(bs, opts, stall_limit, max_iters):
            seen.append((name, bs.s.T))
            return bs
        return run

    monkeypatch.setattr(pbounded, "on_cpu", lambda *tensors: False)
    monkeypatch.setattr(pbounded, "sm_count", lambda device: 132)
    monkeypatch.setattr(pbounded, "bounded_grid", spy("bounded_grid"))
    monkeypatch.setattr(pbounded, "bounded_steps", spy("bounded_steps"))
    bs, opts = _small()
    strided = bs._replace(s=bs.s._replace(T=bs.s.T.t().contiguous().t()))
    assert not strided.s.T.is_contiguous()
    run_simplex_bounded(strided, opts)
    ((name, T),) = seen
    assert name == "bounded_grid"
    assert T.is_contiguous() and torch.equal(T, bs.s.T)
    seen.clear()
    # a frame past the resident plan (2050 x 4097 at f64): streamed; one
    # past the streamed plan too (8,000 rows whose vectors do not fit)
    monkeypatch.setattr(pbounded, "_finish", lambda b: b)
    for shape in ((2050, 4097), (8000, 3)):
        run_simplex_bounded(bs._replace(s=bs.s._replace(
            T=torch.zeros(shape, dtype=torch.float64))), opts)
    assert [name for name, _ in seen] == ["bounded_grid", "bounded_steps"]


def test_cpu_walk_never_reaches_the_kernels(monkeypatch):
    """On CPU tensors ``run_simplex_bounded`` is the plain loop: neither
    kernel wrapper is called and no launch is counted."""
    def refuse(*args, **kw):
        raise AssertionError("a bounded kernel was called on the CPU")

    for name in ("bounded_grid", "bounded_steps"):
        monkeypatch.setattr(pbounded, name, refuse)
    monkeypatch.setattr(kg, "bounded_grid", refuse)
    reset_launches()
    bs, opts = port_state(CASES[3], torch.float64, {"rule": RULE_DEVEX})
    out = run_simplex_bounded(bs._replace(gamma=None), opts)
    ref = run_simplex_bounded_reference(bs._replace(gamma=None), opts)
    assert_same_state(out, ref)
    assert int(out.s.status) == Status.OPTIMAL
    sol = tpulp_torch.solve_lp(to_port(case_lp(CASES[3])),
                               simple_bounds=True, device="cpu")
    assert sol.status == "optimal"
    assert LAUNCHES["bounded_grid"] == LAUNCHES["bounded_step"] == 0


# ---------------------------------------------------------------------------
# on a card only: the kernel against its plain version
# ---------------------------------------------------------------------------

def _on_card(bs):
    return type(bs)(*(None if x is None else x.cuda() for x in bs))


def _on_cpu(bs):
    return type(bs)(*(None if x is None else x.cpu() for x in bs))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cuda_bounded_grid_matches_its_plain_version(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py's phase 8a runs these "
                    "checks at full size)")
    tt = getattr(torch, dtype)
    for case in CASES:
        for rule in RULES:
            bs, opts = port_state(case, tt, RULES[rule])
            stall = opts.resolved_stall_limit(bs.s.m, bs.s.n)
            for blocks in SLABS:
                for budget in (400, 7):
                    before = dict(kb.FLIPS)
                    out = kg.bounded_grid(_on_card(bs), opts, stall, budget,
                                          blocks=blocks)
                    ref, counts = kg.bounded_grid_reference(
                        bs, opts, stall, budget, blocks)
                    torch.cuda.synchronize()
                    assert_same_state(_on_cpu(out), ref)
                    assert {k: kb.FLIPS[k] - before[k]
                            for k in kb.FLIPS} == counts
            out = run_simplex_bounded(_on_card(bs),
                                      dataclasses.replace(opts,
                                                          max_iters=400))
            ref = run_simplex_bounded_reference(
                bs, dataclasses.replace(opts, max_iters=400))
            assert_same_state(_on_cpu(out), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cuda_streamed_grid_matches_its_plain_version(dtype):
    """The streamed kernel at forced splits (rows 3, M // 2 and M - 1 in
    shared memory), on 1, 3 and 7 blocks, Dantzig and devex, to the exit
    and to a budget: every field equal to ``bounded_grid_reference``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py's phase 8a runs these "
                    "checks at full size)")
    tt = getattr(torch, dtype)
    for case in CASES:
        for rule in ("dantzig", "devex"):
            bs, opts = port_state(case, tt, RULES[rule])
            stall = opts.resolved_stall_limit(bs.s.m, bs.s.n)
            M = bs.s.T.shape[0]
            for rows in (3, M // 2, M - 1):
                for blocks in (1, 3, 7):
                    for budget in (400, 7):
                        before = dict(kb.FLIPS)
                        out = kg.bounded_grid(_on_card(bs), opts, stall,
                                              budget, blocks=blocks,
                                              rows=rows)
                        ref, counts = kg.bounded_grid_reference(
                            bs, opts, stall, budget, blocks)
                        torch.cuda.synchronize()
                        assert_same_state(_on_cpu(out), ref)
                        assert {k: kb.FLIPS[k] - before[k]
                                for k in kb.FLIPS} == counts
