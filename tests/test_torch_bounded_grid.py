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
(the slabs' rows split between shared and device memory) and of the
device-vector plan (the per-row vectors in device memory, the |b| sum in
its order), which equals the plain loop bit for bit at f64 and f32 and
tpulp's solve at f32. ``bounded_grid_plan``'s arithmetic (resident,
streamed and device-vector plans, forced splits and kinds, the edges),
``bounded_route``, the wrapper's refusals and the CPU dispatch are held
here too. The kernel itself runs on the card only
(``tests/test_torch_bounded_grid_card.py``, which chip_smoke.py's phase 8a
runs there; 8a also holds it at full size)."""

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
    shared memory beside the replicated vectors; the next gets the
    device-vector plan, and the shared-vector plan forced there is refused
    with ``GridPlanTooLarge`` (a ValueError); another type and an
    out-of-range grid are refused with plain ValueErrors."""
    for dtype, m in STREAMED_LAST_M.items():
        plan = kg.bounded_grid_plan(m + 2, 2 * m + 1, dtype, 132)
        assert plan.rows == 3 and plan.stages == kg.GRID_RING_STAGES
        assert plan.vectors == "shared"
        past = kg.bounded_grid_plan(m + 3, 2 * m + 3, dtype, 132)
        assert past.vectors == "device" and past.rows > 3
        with pytest.raises(kg.GridPlanTooLarge, match="shared memory"):
            kg.bounded_grid_plan(m + 3, 2 * m + 3, dtype, 132,
                                 vectors="shared")
    # 2050 x 6145 f64 (slabs of 47 columns) streams; 8,000 rows of a
    # narrow frame do not fit their replicated vectors: the device-vector
    # plan keeps all but one row of its two one-column slabs
    assert kg.bounded_grid_plan(2050, 6145, torch.float64, 132).rows < 2050
    narrow = kg.bounded_grid_plan(8000, 3, torch.float64, 132)
    assert (narrow.vectors, narrow.blocks, narrow.rows) == ("device", 2, 7999)
    with pytest.raises(kg.GridPlanTooLarge):
        kg.bounded_grid_plan(8000, 3, torch.float64, 132, vectors="shared")
    with pytest.raises(ValueError, match="float32 or float64") as err:
        kg.bounded_grid_plan(130, 385, torch.float16)
    assert not isinstance(err.value, kg.GridPlanTooLarge)
    with pytest.raises(ValueError, match="blocks") as err:
        kg.bounded_grid_plan(130, 385, torch.float64, 132, blocks=200)
    assert not isinstance(err.value, kg.GridPlanTooLarge)


def test_route_on_each_side_of_the_plan():
    """Every frame routes to the grid: resident, streamed, and past the
    streamed plan's edge on the device-vector plan."""
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
        assert bounded_route(m + 3, 2 * m + 3, dtype) == "bounded_grid"
    assert bounded_route(8000, 3, torch.float64) == "bounded_grid"


def test_route_raises_on_other_refusals():
    """Only a frame too wide for every plan routes to the four-launch step
    (``test_route_past_the_device_vector_plan``): a float16 frame or one
    outside 2^24 raises."""
    with pytest.raises(ValueError, match="float32 or float64"):
        bounded_route(130, 385, torch.float16)
    with pytest.raises(ValueError, match="outside"):
        bounded_route(2, 385, torch.float64)
    with pytest.raises(ValueError, match="outside"):
        bounded_route(130, 2 ** 24, torch.float64)


# the device-vector plan's width edge on 132 SMs, by type: the widest slab
# (W) whose rows 0-2, ring of GRID_DEVICE_STAGES one-row tiles, row and
# weight segments and masks fit a block, and its frame's structural
# columns (n = 132 W)
DEVICE_LAST_W = {torch.float64: 3_098, torch.float32: 6_032}


@pytest.mark.parametrize("M", [102, 1002])
@pytest.mark.parametrize("dtype,smem,scratch_row", [
    (torch.float64, 229_312, 24_784),
    (torch.float32, 229_264, 24_128),
], ids=["f64", "f32"])
def test_device_vector_plan_width_edge(M, dtype, smem, scratch_row):
    """The device-vector plan's last frame keeps rows 0-2 of a slab of
    DEVICE_LAST_W columns (one-row tiles); a column more widens every slab
    by one and is refused with ``GridPlanTooLarge``, whatever the rows."""
    W = DEVICE_LAST_W[dtype]
    plan = kg.bounded_grid_plan(M, 132 * W + 1, dtype, 132)
    assert (plan.vectors, plan.blocks, plan.width, plan.rows, plan.stages,
            plan.tile_rows, plan.smem) == ("device", 132, W, 3,
                                           kg.GRID_DEVICE_STAGES, 1, smem)
    assert plan.smem <= kg.GRID_SMEM_LIMIT
    assert plan.scratch == 132 * (M - 3) * scratch_row
    with pytest.raises(kg.GridPlanTooLarge, match="device memory"):
        kg.bounded_grid_plan(M, 132 * W + 2, dtype, 132)
    with pytest.raises(kg.GridPlanTooLarge, match="device memory"):
        kg.bounded_grid_plan(M, 132 * W + 2, dtype, 132, vectors="device")


def test_route_past_the_device_vector_plan(monkeypatch):
    """At the device-vector plan's width edge the route is the grid; a
    column past it, the four-launch step, on the card too, where the
    grid's occupancy is not asked for a frame it has no plan for."""
    asked = []

    def occupancy(M, N, dtype, devex, device):
        asked.append((M, N))
        return 1

    monkeypatch.setattr(pbounded, "bounded_grid_occupancy", occupancy)
    cuda = torch.device("cuda", 0)
    for dtype, W in DEVICE_LAST_W.items():
        for M in (102, 1002):
            last, past = 132 * W + 1, 132 * W + 2
            assert bounded_route(M, last, dtype) == "bounded_grid"
            assert bounded_route(M, past, dtype) == "bounded_step"
            assert bounded_route(M, last, dtype, 132,
                                 device=cuda) == "bounded_grid"
            assert bounded_route(M, past, dtype, 132,
                                 device=cuda) == "bounded_step"
    assert asked == [(M, 132 * W + 1) for W in DEVICE_LAST_W.values()
                     for M in (102, 1002)]


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


@pytest.mark.parametrize("M,N,dtype,blocks,width,smem,rows,tile_rows,scratch", [
    (7002, 7065, torch.float64, 131, 54, 229_200, 399, 32, 374_865_408),
    (12_002, 12_065, torch.float32, 132, 92, 229_376, 492, 32, 559_595_520),
], ids=["x_f64", "y_f32"])
def test_device_vector_plan_past_the_streamed_plan(M, N, dtype, blocks, width,
                                                   smem, rows, tile_rows,
                                                   scratch):
    """chip_smoke.py's (x) and (y), past the streamed plan: W and G as the
    other plans take them; the per-row vectors in device memory, so a
    block holds its R resident rows, the ring, the row and weight
    segments, column j's entries of two tiles and its W mask entries
    beside a ring of GRID_DEVICE_STAGES tiles (``_smem_device``'s
    arithmetic: one row more does not fit); the scratch G regions of
    ceil((M - R) / TR) tiles."""
    es = torch.tensor([], dtype=dtype).element_size()
    plan = kg.bounded_grid_plan(M, N, dtype, 132)
    n = N - 1
    W = max(-(-n // 132), -(-kg.GRID_MIN_ENTRIES // M))
    assert (plan.blocks, plan.width, plan.threads) == (blocks, width, 512)
    assert W == width and blocks == -(-n // W)
    S = kg.GRID_DEVICE_STAGES
    assert (plan.vectors, plan.smem, plan.rows, plan.stages,
            plan.tile_rows, plan.scratch) == ("device", smem, rows, S,
                                              tile_rows, scratch)
    tile = kg._align(tile_rows * W * es)
    assert plan.smem == kg._smem_device(W, es, rows, S, tile, tile_rows) <= \
        kg.GRID_SMEM_LIMIT
    assert kg._smem_device(W, es, rows + 1, S, tile, tile_rows) > \
        kg.GRID_SMEM_LIMIT
    assert plan.scratch == blocks * -(-(M - rows) // tile_rows) * tile
    assert plan.mail == 64 * (3 * blocks + 1)
    with pytest.raises(kg.GridPlanTooLarge, match="shared memory"):
        kg.bounded_grid_plan(M, N, dtype, 132, vectors="shared")


def test_device_vector_plan_forced():
    """``vectors="device"`` forces the device-vector plan at any frame: R
    the most rows that fit (at most M - 1, at least one row streamed), or
    ``rows`` 3 to M - 1; M, and a kind the kernel does not have, are
    refused; the shared-vector plans and rank1_grid's stay as they
    were."""
    M, N = 66, 193
    plan = kg.bounded_grid_plan(M, N, torch.float64, 132, vectors="device")
    assert (plan.vectors, plan.rows) == ("device", M - 1)
    assert plan[:2] == kg.bounded_grid_plan(M, N, torch.float64, 132)[:2]
    for rows in (3, M // 2, M - 1):
        for blocks in (None, 1, 3, 7):
            forced = kg.bounded_grid_plan(M, N, torch.float64, 132,
                                          blocks=blocks, rows=rows,
                                          vectors="device")
            assert (forced.vectors, forced.rows) == ("device", rows)
            assert forced.stages == kg.GRID_DEVICE_STAGES
            assert forced.tile_rows <= 2 * (M - rows)
            assert forced.scratch == forced.blocks * -(
                -(M - rows) // forced.tile_rows) * kg._align(
                forced.tile_rows * forced.width * 8)
    with pytest.raises(ValueError, match="streams"):
        kg.bounded_grid_plan(M, N, torch.float64, 132, rows=M,
                             vectors="device")
    with pytest.raises(ValueError, match="vectors"):
        kg.bounded_grid_plan(M, N, torch.float64, 132, vectors="host")
    assert kg.bounded_grid_plan(M, N, torch.float64, 132,
                                vectors="shared").vectors == "shared"
    with pytest.raises(ValueError, match="vectors"):
        kg.plan_grid(M, N, torch.float64, 132, None, None, kg._smem,
                     "rank1_grid", None, "device")
    with pytest.raises(ValueError, match="vectors"):
        kg.bounded_grid_reference(*_small(), 10, 10, vectors="host")


def test_stage_names_are_each_plans_own():
    """``stage_cycles`` has one counter layout, named by the plan: the
    device-vector plan's spans that differ from the other plans' take
    names of their own, so that a name means one span on every plan."""
    shared = kg.bounded_grid_plan(2050, 4097, torch.float64, 132)
    device = kg.bounded_grid_plan(7002, 7065, torch.float64, 132)
    assert kg.grid_stages(shared) == kg.GRID_STAGES
    assert kg.grid_stages(device) == kg.GRID_DEVICE_VECTOR_STAGES
    assert len(kg.GRID_STAGES) == len(kg.GRID_DEVICE_VECTOR_STAGES) == 14
    same = {a for a, b in zip(kg.GRID_STAGES, kg.GRID_DEVICE_VECTOR_STAGES)
            if a == b}
    assert same == {"load", "price", "barrier_a", "barrier_c", "stream",
                    "barrier_d", "store"}
    assert not (set(kg.GRID_STAGES) - same) & set(
        kg.GRID_DEVICE_VECTOR_STAGES)


def test_route_raises_where_the_card_holds_no_grid(monkeypatch):
    """Given a CUDA device, ``bounded_route`` asks the grid's occupancy
    there (for the walk's instantiation); an occupancy of 0 raises
    RuntimeError (the step is no fallback), on every plan; a frame past
    every plan takes the step, with no occupancy asked."""
    asked = []

    def occupancy(M, N, dtype, devex, device):
        asked.append((M, N, devex))
        return 0

    monkeypatch.setattr(pbounded, "bounded_grid_occupancy", occupancy)
    cuda = torch.device("cuda", 0)
    for M, N, dtype in ((1026, 3073, torch.float64),
                        (2050, 4097, torch.float64),
                        (7002, 7065, torch.float64),
                        (12_002, 12_065, torch.float32)):
        with pytest.raises(RuntimeError, match="holds no block"):
            bounded_route(M, N, dtype, 132, device=cuda, devex=False)
    assert asked[-1] == (12_002, 12_065, False)
    # a frame past every plan takes the step, with no occupancy asked
    assert bounded_route(102, 408_938, torch.float64, 132,
                         device=cuda) == "bounded_step"
    assert asked[-1] == (12_002, 12_065, False)
    monkeypatch.setattr(pbounded, "bounded_grid_occupancy",
                        lambda *args: 1)
    assert bounded_route(7002, 7065, torch.float64, 132,
                         device=cuda) == "bounded_grid"
    # no occupancy is asked off the card
    assert bounded_route(7002, 7065, torch.float64, 132,
                         device=torch.device("cpu")) == "bounded_grid"


# the device-vector plan forced at a small frame: rows 0-4 resident
DEVICE_ROWS = 5


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("rule", list(RULES))
def test_device_vector_plan_walks_equal_the_plain_loop(rule, dtype):
    """On the device-vector plan forced at a small frame (phase 1, the
    retire, upper hits; rows 0-4 resident) on grids of 1, 3 and 7 blocks,
    and with an RHS whose |b| sum overflows: ``bounded_grid_reference``
    (the |b| sum in that plan's order) equals
    ``run_simplex_bounded_reference`` in every field, bit for bit."""
    tt = getattr(torch, dtype)
    bs, opts = port_state(CASES[4], tt, RULES[rule])
    stall = opts.resolved_stall_limit(bs.s.m, bs.s.n)
    M, N = bs.s.T.shape
    T = bs.s.T.clone()
    T[3:5, -1] = torch.finfo(tt).max / 1.5
    numeric = bs._replace(s=bs.s._replace(T=T))
    for state in (bs, numeric):
        want = run_simplex_bounded_reference(state, opts)
        for blocks in (1, 3, 7):
            plan = kg.bounded_grid_plan(M, N, tt, 132, blocks=blocks,
                                        rows=DEVICE_ROWS, vectors="device")
            assert plan.vectors == "device" and plan.scratch > 0
            out, _ = kg.bounded_grid_reference(state, opts, stall,
                                               opts.max_iters, plan.blocks,
                                               vectors="device")
            assert_same_state(pbounded._finish(out), want)
    assert int(want.s.status) == Status.NUMERIC


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("rule", list(RULES))
def test_device_vector_plan_ends_where_tpulp_does(rule, dtype):
    """The device-vector plan's walk (3 slabs) ends where tpulp's jitted
    bounded walk on the JAX CPU backend does, at f64 and at f32: status,
    pivots, basis and objective, exactly (the tolerance
    tests/test_torch_bounded.py states for both types: none)."""
    case = CASES[4]
    sf = case_lp(case).lower(simple_bounds=True)
    jt = getattr(jnp, dtype)
    jo = TpulpOptions.for_dtype(jt, **RULES[rule])
    ref = tpulp_run(tpulp_bounded(tpulp_state(sf, dtype=jt), sf.upper), jo)
    bs, opts = port_state(case, getattr(torch, dtype), RULES[rule])
    stall = opts.resolved_stall_limit(bs.s.m, bs.s.n)
    out, _ = kg.bounded_grid_reference(bs, opts, stall, opts.max_iters, 3,
                                       vectors="device")
    out = pbounded._finish(out)
    for name in ("status", "niter", "basis"):
        assert np.array_equal(getattr(out.s, name).numpy(),
                              np.asarray(getattr(ref.s, name))), name
    assert float(out.s.objective()) == float(ref.s.objective())


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
    a contiguous tableau: ``bounded_grid`` on every plan, resident,
    streamed or with the vectors in device memory; ``bounded_steps`` only
    past them, for a frame too wide for the device-vector plan (the CUDA
    dispatch, ``on_cpu`` patched)."""
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
    # past the streamed plan too (8,000 rows whose vectors do not fit):
    # the device-vector plan; one whose slabs are too wide for that (W
    # 3,099 at f64): the step
    monkeypatch.setattr(pbounded, "_finish", lambda b: b)
    for shape in ((2050, 4097), (8000, 3), (4, 132 * 3_099 + 1)):
        run_simplex_bounded(bs._replace(s=bs.s._replace(
            T=torch.zeros(shape, dtype=torch.float64))), opts)
    assert [name for name, _ in seen] == ["bounded_grid", "bounded_grid",
                                          "bounded_steps"]


def test_cpu_walk_never_reaches_the_kernels(monkeypatch):
    """On CPU tensors ``run_simplex_bounded`` is the plain loop: neither
    kernel wrapper is called and no launch is counted."""
    def refuse(*args, **kw):
        raise AssertionError("a bounded kernel was called on the CPU")

    monkeypatch.setattr(pbounded, "bounded_grid", refuse)
    monkeypatch.setattr(kg, "bounded_grid", refuse)
    monkeypatch.setattr(pbounded, "bounded_steps", refuse)
    monkeypatch.setattr(kb, "bounded_steps", refuse)
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
