"""The solo rank-1, devex and dual walks of a frame that no cluster holds,
in one cooperative launch on the whole card
(``tpulp_torch/kernels/rank1_grid.py``), held on the CPU through the plain
version ``rank1_grid_reference``: on G = 1, 2, 3 and 7 slabs it equals the
port's plain stages composed (``rank1_step_reference``) in every field
(``T + 0.0``, the devex weights) at f32 and f64 under Dantzig, Bland, the
greatest increase, largest-pivot ties, the stall switch, devex (its ray
scan, probe, phase change and a reset of weights above 1e8), a budget of
7, a NaN in the RHS and the dual walk on warm frames (Bland's too); at f64
it ends where tpulp's jitted ``lax.while_loop`` over ``simplex_step`` /
``devex_simplex_step`` / ``dual_simplex_step`` does (status, pivots,
basis, ``T + 0.0``); with the device-vector and wide plans' |b| sum order
too. ``rank1_grid_plan``'s resident, streamed, device-vector and wide
plans, their edges, its forced splits and kinds and its refusals, the
three-way route rule at its edges, the wrapper's refusals and the CPU
dispatch are held here too. The kernel itself runs on the card only
(``tests/test_torch_rank1_grid_card.py``; chip_smoke.py's phase 5c holds
it at full size)."""

import numpy as np
import pytest
import torch

import tpulp_torch
import tpulp_torch.kernels.rank1_grid as kg
from tpulp_torch.core import Status
from tpulp_torch.kernels import LAUNCHES, reset_launches
from tpulp_torch.kernels.bounded_grid import (GRID_DEVICE_STAGES,
                                              GRID_RING_STAGES,
                                              GRID_SMEM_LIMIT,
                                              GRID_TILE_BYTES,
                                              GRID_WIDE_CHUNK,
                                              GRID_WIDE_SLOTS,
                                              GridPlanTooLarge,
                                              bounded_grid_plan)
from tpulp_torch.kernels.rank1_cluster import cluster_plan
from tpulp_torch.solve import devex as pdevex
from tpulp_torch.solve import driver as pdriver
from tpulp_torch.solve import dual as pdual
from tpulp_torch.solve.driver import finish, solo_route

from test_torch_bounded_kernel import as_bits
from test_torch_dual import _root, _tightened
from test_torch_rank1_cluster import (case_inputs, plain_stage_walk,
                                      tpulp_walk)
from test_torch_rank1_kernel import _small, _wyndor, assert_same

torch.set_num_threads(1)
pytestmark = pytest.mark.filterwarnings(
    "error:There is a performance drop")

# (walk, instance, rule) of test_torch_rank1_kernel.py's instances: Dantzig
# past a phase change, Bland, the greatest increase, largest-pivot ties,
# the stall switch (a stall limit of 1), devex past a ray-scan and a probe
# tick, devex through phase 1 with the clean-up and the phase change's
# reset, devex's exposed ray, a clean-up under Dantzig, NUMERIC; the dual
# walk on warm frames, its stall switch to Bland and a NaN in b
CASES = [("primal", "equalities", "dantzig"), ("primal", "bounded1", "bland"),
         ("primal", "long", "max_increase"), ("primal", "bounded1", "maxpiv"),
         ("primal", "beale", "stall_bland"), ("primal", "long", "devex"),
         ("primal", "equalities", "devex"), ("primal", "ray", "devex"),
         ("primal", "cleanup", "dantzig"), ("primal", "numeric", "dantzig"),
         ("dual", "warm3", "dantzig"), ("dual", "deep", "stall_bland"),
         ("dual", "nan_b", "dantzig")]
CASE_IDS = ["-".join(c) for c in CASES]
SLABS = [1, 2, 3, 7]


def _reference(case, dtype, G, budget=None, edit=None, vectors="shared"):
    state, opts, stall, gamma, dual = case_inputs(*case, dtype)
    if edit is not None:
        state, gamma = edit(state, gamma)
    budget = opts.max_iters if budget is None else budget
    out, g = kg.rank1_grid_reference(state, opts, stall, budget, gamma,
                                     dual, G, vectors)
    ref, rg = plain_stage_walk(state, opts, stall, budget, gamma, dual)
    return out, g, ref, rg


@pytest.mark.parametrize("G", SLABS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_grid_reference_equals_the_plain_stages(case, dtype, G):
    """On any number of slabs the grid's plain walk is the plain stages'
    walk in every field: its sums feed finiteness checks only."""
    out, g, ref, rg = _reference(case, dtype, G)
    assert_same(out, ref, g, rg)
    assert int(out.status) != Status.RUNNING


@pytest.mark.parametrize("vectors", ["device", "wide"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_device_vector_reference_equals_the_plain_stages(case, dtype,
                                                          vectors):
    """With the device-vector and wide plans' |b| sum (the grid's order over
    slabs of ceil(m / G) rows) the plain walk on 7 slabs is still the plain
    stages' walk in every field."""
    out, g, ref, rg = _reference(case, dtype, 7, vectors=vectors)
    assert_same(out, ref, g, rg)
    assert int(out.status) != Status.RUNNING


def test_reference_takes_a_kind_of_plan():
    state, opts, stall, gamma, dual = case_inputs("primal", "long", "dantzig",
                                                  torch.float64)
    with pytest.raises(ValueError, match="vectors"):
        kg.rank1_grid_reference(state, opts, stall, 10, gamma, dual, 3,
                                "streamed")


def _nan_rhs(state, gamma):
    T = state.T.clone()
    T[4, -1] = float("nan")
    return state._replace(T=T), gamma


def _big_weights(state, gamma):
    g = gamma.clone()
    g[::3] = 3e8
    return state, g


@pytest.mark.parametrize("vectors", ["shared", "device"])
@pytest.mark.parametrize("G", [2, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("edit", [
    (("primal", "long", "dantzig"), None, 7),
    (("primal", "long", "devex"), None, 7),
    (("dual", "deep", "dantzig"), None, 7),
    (("primal", "long", "dantzig"), _nan_rhs, None),
    (("primal", "long", "devex"), _nan_rhs, None),
    (("primal", "long", "devex"), _big_weights, None),
    (("primal", "long", "devex"), _big_weights, 1),
], ids=["budget7", "devex-budget7", "dual-budget7", "nan_rhs",
        "devex-nan_rhs", "devex-weights_past_1e8", "devex-weights-budget1"])
def test_grid_reference_edges(edit, dtype, G, vectors):
    """A budget of 7 (the walk stops RUNNING at 7 pivots, or ends before
    them), a NaN in the RHS (NUMERIC), devex weights above 1e8 (the reset
    after the first step, or at a budget of 1 at the walk's end); with
    either order of the |b| sum."""
    case, fn, budget = edit
    out, g, ref, rg = _reference(case, dtype, G, budget, fn, vectors)
    assert_same(out, ref, g, rg)
    if fn is _nan_rhs:
        assert int(out.status) == Status.NUMERIC
    if budget == 7:
        free, _, _, _ = _reference(case, dtype, G, None, fn)
        if int(free.niter) > 7:
            assert int(out.niter) == 7 and int(out.status) == Status.RUNNING
        else:
            assert_same(out, free)
    if fn is _big_weights:
        assert float(g.max()) <= 1e8


@pytest.mark.parametrize("case", [
    ("primal", "equalities", "dantzig"), ("primal", "bounded1", "bland"),
    ("primal", "long", "max_increase"), ("primal", "bounded1", "maxpiv"),
    ("primal", "long", "devex"), ("primal", "ray", "devex"),
    ("primal", "beale", "dantzig"), ("dual", "warm3", "dantzig"),
    ("dual", "deep", "stall_bland"), ("dual", "infeasible", "dantzig")],
    ids=lambda c: "-".join(c))
def test_grid_reference_equals_tpulp(case):
    """At f64 the grid's plain walk on 3 slabs ends where tpulp's compiled
    walk does: status, pivots, basis, phase, masks, ``T + 0.0`` and the
    devex weights."""
    state, opts, stall, gamma, dual = case_inputs(*case, torch.float64)
    out, g = kg.rank1_grid_reference(state, opts, stall, opts.max_iters,
                                     gamma, dual, 3)
    out = finish(out)
    want, wg = tpulp_walk(*case)
    assert torch.equal(as_bits(out.T), as_bits(torch.from_numpy(want["T"])))
    for name in ("basis", "status", "niter", "phase", "stuck", "bland",
                 "col_active", "art_cols"):
        assert np.array_equal(getattr(out, name).numpy(), want[name]), name
    assert (g is None) == (wg is None)
    if g is not None:
        assert torch.equal(as_bits(g), as_bits(torch.from_numpy(wg)))


def test_grid_reference_leaves_its_inputs():
    state, opts, stall, gamma, _ = case_inputs("primal", "long", "devex",
                                               torch.float64)
    before = [x.clone() for x in state] + [gamma.clone()]
    out, _ = kg.rank1_grid_reference(state, opts, stall, opts.max_iters,
                                     gamma, False, 3)
    assert int(out.niter) > 0
    for x, y in zip([*state, gamma], before):
        assert torch.equal(as_bits(x), as_bits(y))


def test_grid_reference_reads_the_c_sum_in_the_grid_order():
    """The pricing row's |c| sum overflows on the grid only as a whole: a
    row of 1.7e308 entries over 7 slabs reads as not finite (NUMERIC),
    as the plain stage's torch sum does."""
    state, opts, stall, _, _ = case_inputs("primal", "long", "dantzig",
                                           torch.float64)
    T = state.T.clone()
    T[0, :3] = 1.7e308
    state = state._replace(T=T)
    out, _ = kg.rank1_grid_reference(state, opts, stall, opts.max_iters,
                                     None, False, 7)
    ref, _ = plain_stage_walk(state, opts, stall, opts.max_iters, None,
                              False)
    assert int(out.status) == int(ref.status) == Status.NUMERIC
    assert_same(out, ref)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

def _bytes(M, N, W, es, R=None, S=0, tile=0):
    """The kernel's layout: the slab's R resident rows, the ring, the RHS
    and the pivot's column, the pivot row's and the weights' segments, the
    basis, the segment's active mask, the artificial mask, the mbarriers;
    each rounded up to 16 bytes."""
    up = lambda x: -(-x // 16) * 16  # noqa: E731
    m, n = M - 2, N - 1
    R = M if R is None else R
    return (up(R * W * es) + S * tile + 2 * up(M * es) + 2 * up(W * es)
            + up(4 * m) + up(W) + up(n) + up(8 * S))


@pytest.mark.parametrize("frame", [
    (1538, 3073, torch.float32, 128, 24),
    (1026, 2049, torch.float64, 128, 16),
    (514, 1537, torch.float64, 128, 12),
    (2000, 100, torch.float64, 33, 3),
    (130, 385, torch.float64, 12, 32),
], ids=lambda f: f"{f[0]}x{f[1]}-{str(f[2])[6:]}")
def test_resident_plan(frame):
    """W = max(ceil(n / 132), ceil(4096 / M)), G = ceil(n / W), the whole
    slab in the kernel's layout within the limit."""
    M, N, dtype, G, W = frame
    es = 8 if dtype == torch.float64 else 4
    plan = kg.rank1_grid_plan(M, N, dtype, 132)
    assert (plan.blocks, plan.width, plan.threads) == (G, W, 512)
    assert plan.rows == M and plan.stages == plan.tile_rows == 0
    assert plan.scratch == 0
    assert plan.smem == _bytes(M, N, W, es) <= GRID_SMEM_LIMIT
    assert plan.mail == 64 * (3 * G + 1)


def test_streamed_plan_at_the_main_shape():
    """1538 x 3073 at f64: 128 blocks of 24 columns, R 824 rows resident
    (the most beside the ring of 3 tiles of 64 rows), the other 714 rows
    of each slab streamed: 18.9 MB."""
    M, N, es = 1538, 3073, 8
    plan = kg.rank1_grid_plan(M, N, torch.float64, 132)
    assert (plan.blocks, plan.width) == (128, 24)
    assert (plan.rows, plan.stages, plan.tile_rows) == (824,
                                                        GRID_RING_STAGES, 64)
    tile = 64 * 24 * es
    assert tile <= GRID_TILE_BYTES < 2 * tile
    assert plan.smem == _bytes(M, N, 24, es, 824, 3, tile) <= GRID_SMEM_LIMIT
    assert _bytes(M, N, 24, es, 825, 3, tile) > GRID_SMEM_LIMIT
    assert plan.scratch == 128 * -(-(M - 824) // 64) * tile == 18_874_368
    # the bounded grid's layout holds the spans too: fewer rows resident
    assert bounded_grid_plan(M, N, torch.float64, 132).rows < plan.rows


def test_forced_plans():
    """``rows`` forces R (3 to M; M is the resident plan), ``blocks`` the
    grid, as the edge walks use them."""
    M, N = 66, 193
    resident = kg.rank1_grid_plan(M, N, torch.float64, 132)
    assert resident.rows == M
    assert kg.rank1_grid_plan(M, N, torch.float64, 132, rows=M) == resident
    for rows in (3, M // 2, M - 1):
        for blocks in (None, 1, 3, 7):
            plan = kg.rank1_grid_plan(M, N, torch.float64, 132,
                                      blocks=blocks, rows=rows)
            assert plan.rows == rows and plan.stages == GRID_RING_STAGES
            assert plan.tile_rows & (plan.tile_rows - 1) == 0
            assert plan.tile_rows <= M - rows
            assert plan.scratch == plan.blocks * -(
                -(M - rows) // plan.tile_rows) * -(
                -(plan.tile_rows * plan.width * 8) // 16) * 16
    assert kg.rank1_grid_plan(M, N, torch.float64, 132, blocks=7)[:2] == \
        (7, 28)


def _device_bytes(W, es, R, S, tile, tr):
    """The device-vector plan's layout: the slab's R resident rows, the
    ring, the pivot row's and the weights' segments, column j's entries of
    two tiles, the active and artificial masks, the mbarriers."""
    up = lambda x: -(-x // 16) * 16  # noqa: E731
    return (up(R * W * es) + S * tile + 2 * up(W * es) + up(2 * tr * es)
            + 2 * up(W) + up(8 * S))


@pytest.mark.parametrize("dtype,m", [(torch.float64, 8976),
                                     (torch.float32, 13304)])
def test_plan_edge(dtype, m):
    """With n = 2m the streamed plan holds rows 0-2 up to m = 8,976 at f64
    and 13,304 at f32 on 132 SMs; one row more takes the device-vector
    plan (the vectors in device memory), which the shared-vector plan
    forced refuses."""
    plan = kg.rank1_grid_plan(m + 2, 2 * m + 1, dtype, 132)
    assert plan.rows == 3 and plan.vectors == "shared"
    past = kg.rank1_grid_plan(m + 3, 2 * m + 3, dtype, 132)
    assert past.vectors == "device" and past.stages == GRID_DEVICE_STAGES
    assert 3 < past.rows < m + 3
    with pytest.raises(GridPlanTooLarge, match="shared memory"):
        kg.rank1_grid_plan(m + 3, 2 * m + 3, dtype, 132, vectors="shared")


@pytest.mark.parametrize("frame", [
    (10002, 10513, torch.float64, 132, 80, 291, 16),
    (16002, 16513, torch.float32, 132, 126, 324, 32),
    (18, 200017, torch.float64, 132, 1516, 12, 1),
], ids=["x-f64", "x32-f32", "zs-f64"])
def test_device_vector_plan(frame):
    """Past the streamed plan: the same W and G, the ring of
    GRID_DEVICE_STAGES tiles, R the most rows beside it in the
    device-vector layout, the other rows of each slab streamed."""
    M, N, dtype, G, W, R, tr = frame
    es = 8 if dtype == torch.float64 else 4
    plan = kg.rank1_grid_plan(M, N, dtype, 132)
    assert plan.vectors == "device" and plan.chunk == 0
    assert (plan.blocks, plan.width, plan.rows, plan.tile_rows) == \
        (G, W, R, tr)
    tile = -(-(tr * W * es) // 16) * 16
    S = GRID_DEVICE_STAGES
    assert plan.smem == _device_bytes(W, es, R, S, tile, tr) \
        <= GRID_SMEM_LIMIT < _device_bytes(W, es, R + 1, S, tile, tr)
    assert plan.scratch == G * -(-(M - R) // tr) * tile
    # the device-vector layout is bounded_grid's
    assert plan == bounded_grid_plan(M, N, dtype, 132)


@pytest.mark.parametrize("dtype,n", [(torch.float64, 153_384),
                                     (torch.float32, 170_808)])
def test_device_vector_plan_edge_on_a_shallow_frame(dtype, n):
    """At M = 18 the streamed plan holds n = 153,384 at f64 and 170,808 at
    f32 (W = 1,163 and 1,294 columns a block); one column more takes the
    device-vector plan."""
    assert kg.rank1_grid_plan(18, n + 1, dtype, 132).vectors == "shared"
    assert kg.rank1_grid_plan(18, n + 2, dtype, 132).vectors == "device"


@pytest.mark.parametrize("dtype,n,tr", [(torch.float64, 408_936, 8),
                                        (torch.float32, 796_224, 16)])
def test_wide_plan_edge(dtype, n, tr):
    """At M = 18 the device-vector plan holds slabs up to 3,098 columns at
    f64 and 6,032 at f32 (n = 408,936 and 796,224 on 132 SMs); past them
    the wide plan: no row in shared memory, chunks of GRID_WIDE_CHUNK
    columns, tiles of TR rows x a chunk through GRID_WIDE_SLOTS slots."""
    es = 8 if dtype == torch.float64 else 4
    assert kg.rank1_grid_plan(18, n + 1, dtype, 132).vectors == "device"
    plan = kg.rank1_grid_plan(18, n + 2, dtype, 132)
    assert plan.vectors == "wide" and plan.rows == 0
    assert (plan.chunk, plan.stages, plan.tile_rows) == (GRID_WIDE_CHUNK,
                                                         GRID_WIDE_SLOTS, tr)
    W = plan.width
    assert plan.scratch == plan.blocks * 18 * -(-W // GRID_WIDE_CHUNK) * \
        GRID_WIDE_CHUNK * es
    # (zr): 18 x 1,048,593
    zr = kg.rank1_grid_plan(18, 1_048_593, dtype, 132)
    assert zr.vectors == "wide" and (zr.blocks, zr.width) == (132, 7944)
    assert zr == bounded_grid_plan(18, 1_048_593, dtype, 132)


def test_forced_kinds_of_plan():
    """``vectors`` forces the kind at any frame: "device" with R from 3 to
    M - 1 (``rows``), "wide" with no ``rows``; "shared" is the resident
    and streamed plans."""
    M, N = 66, 193
    assert kg.rank1_grid_plan(M, N, torch.float64, 132,
                              vectors="shared").rows == M
    for blocks in (None, 1, 3, 7):
        d = kg.rank1_grid_plan(M, N, torch.float64, 132, blocks=blocks,
                               vectors="device")
        assert d.vectors == "device" and d.rows == M - 1
        for rows in (3, M // 2, M - 1):
            assert kg.rank1_grid_plan(M, N, torch.float64, 132,
                                      blocks=blocks, rows=rows,
                                      vectors="device").rows == rows
        w = kg.rank1_grid_plan(M, N, torch.float64, 132, blocks=blocks,
                               vectors="wide")
        assert w.vectors == "wide" and w.rows == 0
        assert w.chunk == GRID_WIDE_CHUNK and w.blocks == d.blocks


@pytest.mark.parametrize("kw,error,match", [
    ({"rows": 3, "vectors": "wide"}, ValueError, "wide plan"),
    ({"rows": 66, "vectors": "device"}, ValueError, "streams at least"),
    ({"vectors": "streamed"}, ValueError, "vectors"),
], ids=["wide-rows", "device-resident", "unknown-kind"])
def test_forced_kinds_refused(kw, error, match):
    with pytest.raises(error, match=match) as err:
        kg.rank1_grid_plan(66, 193, torch.float64, 132, **kw)
    assert not isinstance(err.value, GridPlanTooLarge)


def test_forced_device_vector_plan_past_its_edge():
    """A forced device-vector plan whose rows 0-2 and ring pass a block
    (a slab of 4,000 columns at f64), and a forced R past what fits."""
    with pytest.raises(GridPlanTooLarge, match="device memory"):
        kg.rank1_grid_plan(18, 528_001, torch.float64, 132,
                           vectors="device")
    with pytest.raises(GridPlanTooLarge, match="rows=9000"):
        kg.rank1_grid_plan(10002, 10513, torch.float64, 132, rows=9000,
                           vectors="device")


def test_stage_names_by_plan():
    """``stage_cycles``' counters are named for the plan's kind; each
    tuple has the kernel's 15 counters, the owner's clock last."""
    names = {kg.rank1_grid_stages(kg.rank1_grid_plan(M, N, torch.float64,
                                                     132))
             for M, N in ((130, 385), (1538, 3073), (10002, 10513),
                          (18, 1_048_593))}
    assert names == {kg.RANK1_GRID_STAGES, kg.RANK1_GRID_DEVICE_STAGES,
                     kg.RANK1_GRID_WIDE_STAGES}
    assert {len(t) for t in names} == {15}
    assert {t[-1][:5] for t in names} == {"owner"}


def test_plan_refusals():
    """A wrong type, side, grid or split is a plain ValueError, not a plan
    past the shared memory."""
    for call, match in (
            (lambda: kg.rank1_grid_plan(130, 385, torch.float16),
             "float32 or float64"),
            (lambda: kg.rank1_grid_plan(2, 385, torch.float64), "outside"),
            (lambda: kg.rank1_grid_plan(130, 1 << 24, torch.float64),
             "outside"),
            (lambda: kg.rank1_grid_plan(130, 385, torch.float64, 132,
                                        blocks=200), "blocks"),
            (lambda: kg.rank1_grid_plan(130, 385, torch.float64, 132,
                                        rows=2), "rows"),
            (lambda: kg.rank1_grid_plan(130, 385, torch.float64, 132,
                                        rows=131), "rows")):
        with pytest.raises(ValueError, match=match) as err:
            call()
        assert not isinstance(err.value, GridPlanTooLarge)
    # a forced resident plan past the shared memory
    with pytest.raises(GridPlanTooLarge, match="resident"):
        kg.rank1_grid_plan(1538, 3073, torch.float64, 132, rows=1538)


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------

def _cluster_fits(M, N, dtype):
    try:
        cluster_plan(M, N, dtype)
    except ValueError:
        return False
    return True


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_route_at_the_cluster_edge(dtype):
    """The widest frame of 258 rows that a cluster holds takes
    ``rank1_cluster``; one column more takes ``rank1_grid``, devex and the
    dual walk alike."""
    N = 500
    while _cluster_fits(258, N + 1, dtype):
        N += 1
    for walk in ("primal", "devex", "dual"):
        assert solo_route(walk, 258, N, dtype) == "rank1_cluster"
        assert solo_route(walk, 258, N + 1, dtype) == "rank1_grid"


@pytest.mark.parametrize("dtype,m", [(torch.float64, 8976),
                                     (torch.float32, 13304)])
def test_route_at_the_grid_edge(dtype, m):
    """Past the grid's streamed plan the grid still takes every walk, on
    the device-vector plan: nothing returns ``rank1_step``."""
    for walk in ("primal", "devex", "dual"):
        assert solo_route(walk, m + 2, 2 * m + 1, dtype) == "rank1_grid"
        assert solo_route(walk, m + 3, 2 * m + 3, dtype) == "rank1_grid"
    assert kg.rank1_grid_plan(m + 3, 2 * m + 3, dtype).vectors == "device"


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("n", [153_385, 200_000, 408_937, 1_048_576])
def test_route_on_shallow_frames(dtype, n):
    """At M = 18, past the streamed plan (n past 153,384 at f64, 170,808 at
    f32) and past the device-vector plan's slabs (n past 408,936 at f64,
    796,224 at f32), every walk takes ``rank1_grid``."""
    for walk in ("primal", "devex", "dual"):
        assert solo_route(walk, 18, n + 1, dtype) == "rank1_grid"


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_route_rule(dtype):
    """The lane kernels where one block holds the primal or dual frame, else
    the cluster where 8 blocks hold it, else the grid, on any of its plans
    (``rank1_grid_plan`` refuses no f32 or f64 frame)."""
    for M, N in ((40, 300), (258, 769), (514, 1537), (1538, 3073),
                 (3000, 60), (8002, 24001), (9002, 18001), (14002, 28001),
                 (18, 1_048_593)):
        resident = pdriver._resident(M, N, dtype)
        kg.rank1_grid_plan(M, N, dtype)
        big = "rank1_cluster" if _cluster_fits(M, N, dtype) \
            else "rank1_grid"
        for walk, lane in (("primal", "lane_primal"), ("dual", "lane_dual"),
                           ("devex", None)):
            want = lane if resident and lane else big
            assert solo_route(walk, M, N, dtype) == want, (walk, M, N)
    assert solo_route("primal", 1538, 3073, dtype) == "rank1_grid"


def test_route_asks_the_occupancy_on_a_card(monkeypatch):
    """With a device the route asks the grid's occupancy: at least one block
    an SM takes the grid; none raises (no fallback), on every plan."""
    asked = []

    def occupancy(value):
        def ask(M, N, dtype, walk, device):
            asked.append((M, N, walk))
            return value
        return ask

    dev = torch.device("cuda", 0)
    monkeypatch.setattr(pdriver, "rank1_grid_occupancy", occupancy(1))
    assert solo_route("dual", 1538, 3073, torch.float64, 132, dev) == \
        "rank1_grid"
    monkeypatch.setattr(pdriver, "rank1_grid_occupancy", occupancy(0))
    with pytest.raises(RuntimeError, match="holds no block"):
        solo_route("devex", 1538, 3073, torch.float64, 132, dev)
    # the other routes ask nothing
    assert solo_route("primal", 258, 769, torch.float64, 132, dev) == \
        "rank1_cluster"
    with pytest.raises(RuntimeError, match="holds no block"):
        solo_route("primal", 9002, 18001, torch.float64, 132, dev)
    monkeypatch.setattr(pdriver, "rank1_grid_occupancy", occupancy(1))
    assert solo_route("dual", 18, 1_048_593, torch.float32, 132, dev) == \
        "rank1_grid"
    assert asked == [(1538, 3073, "dual"), (1538, 3073, "devex"),
                     (9002, 18001, "primal"), (18, 1_048_593, "dual")]
    with pytest.raises(ValueError, match="float32 or float64"):
        solo_route("primal", 1538, 3073, torch.float16)


# ---------------------------------------------------------------------------
# the wrapper and the dispatch
# ---------------------------------------------------------------------------

def _half(state):
    return state._replace(T=state.T.half(), last_z=state.last_z.half())


# (the call on _small()'s state and options, the message): the state on
# the CPU (the primal and dual walks), on mixed devices, at float16, a
# strided tableau, weights of the wrong length, weights on the dual walk
REFUSALS = {
    "cpu": (lambda s, o: kg.rank1_grid(s, o, 10, 10), "CUDA"),
    "cpu-dual": (lambda s, o: kg.rank1_grid(s, o, 10, 10, dual=True),
                 "CUDA"),
    "cpu-device-plan": (lambda s, o: kg.rank1_grid(s, o, 10, 10,
                                                   vectors="device"),
                        "CUDA"),
    "cpu-wide-plan": (lambda s, o: kg.rank1_grid(s, o, 10, 10,
                                                 vectors="wide"), "CUDA"),
    "mixed-devices": (lambda s, o: kg.rank1_grid(
        s._replace(basis=s.basis.to("meta")), o, 10, 10), "CUDA"),
    "float16": (lambda s, o: kg.rank1_grid(_half(s), o, 10, 10),
                "float32 or float64"),
    "strided": (lambda s, o: kg.rank1_grid(
        s._replace(T=s.T.t().contiguous().t()), o, 10, 10), "contiguous"),
    "weights-length": (lambda s, o: kg.rank1_grid(
        s, o, 10, 10, torch.ones(s.n + 1, dtype=torch.float64)), "gamma"),
    "dual-weights": (lambda s, o: kg.rank1_grid(
        s, o, 10, 10, torch.ones(s.n, dtype=torch.float64), dual=True),
        "dual"),
    "unknown-walk": (lambda s, o: kg.rank1_grid_occupancy(
        130, 385, torch.float64, "bounded"), "unknown walk"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_rank1_grid_refuses(case):
    """The wrapper refuses a state it cannot take before any launch."""
    call, match = REFUSALS[case]
    state, opts = _small()
    reset_launches()
    with pytest.raises(ValueError, match=match):
        call(state, opts)
    assert LAUNCHES["rank1_grid"] == 0


def test_cpu_walks_never_reach_a_kernel(monkeypatch):
    """On CPU tensors the solo walks are the plain loops: no kernel wrapper
    is called, and no launch is counted."""
    def refuse(*args, **kw):
        raise AssertionError("a kernel route was taken on the CPU")

    for name in ("rank1_cluster", "rank1_grid", "lane_primal",
                 "lane_dual", "rank1_grid_occupancy", "solo_route"):
        monkeypatch.setattr(pdriver, name, refuse)
    monkeypatch.setattr(kg, "rank1_grid", refuse)
    reset_launches()
    state, opts = _small()
    assert int(pdriver.run_simplex(state, opts).status) == Status.OPTIMAL
    assert int(pdevex.run_simplex_devex(state, opts).status) == \
        Status.OPTIMAL
    A, b, basis, _, tf = _root(0)
    frame = pdual.warm_state_from_basis(*tf, basis,
                                        _tightened(A, b, basis, 0))
    assert int(pdual.run_dual_simplex(frame, opts).status) == \
        Status.OPTIMAL
    sol = tpulp_torch.solve_lp(_wyndor(12), pricing="devex", device="cpu")
    assert sol.objective == 400
    assert not any(LAUNCHES.values())
