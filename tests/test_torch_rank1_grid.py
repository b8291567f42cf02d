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
basis, ``T + 0.0``). ``rank1_grid_plan``'s resident and streamed plans,
its forced splits and refusals, the four-way route rule at its edges, the
wrapper's refusals and the CPU dispatch are held here too. The kernel
itself runs on the card only (the ``cuda`` test; chip_smoke.py's phase 5c
holds it at full size)."""

import numpy as np
import pytest
import torch

import tpulp_torch
import tpulp_torch.kernels.rank1_grid as kg
from tpulp_torch.core import Status
from tpulp_torch.kernels import LAUNCHES, reset_launches
from tpulp_torch.kernels.bounded_grid import (GRID_RING_STAGES,
                                              GRID_SMEM_LIMIT,
                                              GRID_TILE_BYTES,
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


def _reference(case, dtype, G, budget=None, edit=None):
    state, opts, stall, gamma, dual = case_inputs(*case, dtype)
    if edit is not None:
        state, gamma = edit(state, gamma)
    budget = opts.max_iters if budget is None else budget
    out, g = kg.rank1_grid_reference(state, opts, stall, budget, gamma,
                                     dual, G)
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


def _nan_rhs(state, gamma):
    T = state.T.clone()
    T[4, -1] = float("nan")
    return state._replace(T=T), gamma


def _big_weights(state, gamma):
    g = gamma.clone()
    g[::3] = 3e8
    return state, g


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
def test_grid_reference_edges(edit, dtype, G):
    """A budget of 7 (the walk stops RUNNING at 7 pivots, or ends before
    them), a NaN in the RHS (NUMERIC), devex weights above 1e8 (the reset
    after the first step, or at a budget of 1 at the walk's end)."""
    case, fn, budget = edit
    out, g, ref, rg = _reference(case, dtype, G, budget, fn)
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


@pytest.mark.parametrize("dtype,m", [(torch.float64, 8976),
                                     (torch.float32, 13304)])
def test_plan_edge(dtype, m):
    """With n = 2m the streamed plan holds rows 0-2 up to m = 8,976 at f64
    and 13,304 at f32 on 132 SMs; one row more is GridPlanTooLarge."""
    plan = kg.rank1_grid_plan(m + 2, 2 * m + 1, dtype, 132)
    assert plan.rows == 3
    with pytest.raises(GridPlanTooLarge, match="shared memory"):
        kg.rank1_grid_plan(m + 3, 2 * m + 3, dtype, 132)


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
    """``rank1_step`` only past the grid's streamed plan."""
    for walk in ("primal", "devex", "dual"):
        assert solo_route(walk, m + 2, 2 * m + 1, dtype) == "rank1_grid"
        assert solo_route(walk, m + 3, 2 * m + 3, dtype) == "rank1_step"


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_route_rule(dtype):
    """The lane kernels where one block holds the primal or dual frame, else
    the cluster where 8 blocks hold it, else the grid where its plan holds,
    else ``rank1_step``."""
    for M, N in ((40, 300), (258, 769), (514, 1537), (1538, 3073),
                 (3000, 60), (8002, 24001), (9002, 18001), (14002, 28001)):
        resident = pdriver._resident(M, N, dtype)
        try:
            kg.rank1_grid_plan(M, N, dtype)
            grid = "rank1_grid"
        except GridPlanTooLarge:
            grid = "rank1_step"
        big = "rank1_cluster" if _cluster_fits(M, N, dtype) else grid
        for walk, lane in (("primal", "lane_primal"), ("dual", "lane_dual"),
                           ("devex", None)):
            want = lane if resident and lane else big
            assert solo_route(walk, M, N, dtype) == want, (walk, M, N)
    assert solo_route("primal", 1538, 3073, dtype) == "rank1_grid"


def test_route_asks_the_occupancy_on_a_card(monkeypatch):
    """With a device the route asks the grid's occupancy: at least one block
    an SM takes the grid; none raises (no fallback to ``rank1_step``)."""
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
    assert solo_route("primal", 9002, 18001, torch.float64, 132, dev) == \
        "rank1_step"
    assert asked == [(1538, 3073, "dual"), (1538, 3073, "devex")]
    with pytest.raises(ValueError, match="float32 or float64"):
        solo_route("primal", 1538, 3073, torch.float16)


# ---------------------------------------------------------------------------
# the wrapper and the dispatch
# ---------------------------------------------------------------------------

def test_rank1_grid_raises_on_cpu_tensors():
    state, opts = _small()
    reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        kg.rank1_grid(state, opts, 10, 10)
    with pytest.raises(ValueError, match="CUDA"):
        kg.rank1_grid(state, opts, 10, 10, dual=True)
    assert LAUNCHES["rank1_grid"] == 0


def test_rank1_grid_raises_on_bad_inputs():
    state, opts = _small()
    with pytest.raises(ValueError, match="CUDA"):
        kg.rank1_grid(state._replace(basis=state.basis.to("meta")), opts,
                      10, 10)
    with pytest.raises(ValueError, match="contiguous"):
        kg.rank1_grid(state._replace(T=state.T.t().contiguous().t()), opts,
                      10, 10)
    half = state._replace(T=state.T.half(), last_z=state.last_z.half())
    with pytest.raises(ValueError, match="float32 or float64"):
        kg.rank1_grid(half, opts, 10, 10)
    with pytest.raises(ValueError, match="gamma"):
        kg.rank1_grid(state, opts, 10, 10,
                      torch.ones(state.n + 1, dtype=torch.float64))
    with pytest.raises(ValueError, match="dual"):
        kg.rank1_grid(state, opts, 10, 10,
                      torch.ones(state.n, dtype=torch.float64), dual=True)
    with pytest.raises(ValueError, match="unknown walk"):
        kg.rank1_grid_occupancy(130, 385, torch.float64, "bounded")


def test_cpu_walks_never_reach_a_kernel(monkeypatch):
    """On CPU tensors the solo walks are the plain loops: no kernel wrapper
    is called, and no launch is counted."""
    def refuse(*args, **kw):
        raise AssertionError("a kernel route was taken on the CPU")

    for name in ("rank1_cluster", "rank1_grid", "rank1_steps", "lane_primal",
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


# ---------------------------------------------------------------------------
# on a card only: the kernel against its plain version
# ---------------------------------------------------------------------------

def _on_card(x):
    return None if x is None else x.cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cuda_rank1_grid_matches_its_plain_version(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py's phase 5c runs these "
                    "checks at full size)")
    tt = getattr(torch, dtype)
    for case in CASES:
        state, opts, stall, gamma, dual = case_inputs(*case, tt)
        M = state.T.shape[0]
        for blocks, rows in ((None, None), (3, None), (1, 3), (3, M // 2),
                             (7, M - 1)):
            plan = kg.rank1_grid_plan(*state.T.shape, tt,
                                      torch.cuda.get_device_properties(
                                          0).multi_processor_count,
                                      blocks=blocks, rows=rows)
            out, g = kg.rank1_grid(
                type(state)(*(x.cuda() for x in state)), opts, stall,
                opts.max_iters, _on_card(gamma), dual, blocks=blocks,
                rows=rows)
            ref, rg = kg.rank1_grid_reference(state, opts, stall,
                                              opts.max_iters, gamma, dual,
                                              plan.blocks)
            torch.cuda.synchronize()
            assert_same(type(out)(*(x.cpu() for x in out)), ref,
                        None if g is None else g.cpu(), rg)
