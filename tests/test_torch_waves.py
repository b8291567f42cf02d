"""The port's branch-and-bound wave machinery against tpulp's on the same
pools and packs, at float64: the cold wave on the refreshed template, the
packed summaries, pool writes (dropped slots included), the warm carry and
warm waves, and the device-built generation (children past the batch
dropped). Statuses, pivot counts and bases are equal; float fields agree
within 1e-12 of the largest entry."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulp import LinExpr, LinProg
from tpulp.batch import make_batched_states as j_make_batched
from tpulp.batch import run_simplex_batch as j_run_batch
from tpulp.milp import bnb as jbnb
from tpulp.model.lower import lower_to_standard_form
from tpulp.solve import dual as jdual
from tpulp_torch.batch import make_batched_states, run_simplex_batch
from tpulp_torch.core import Status
from tpulp_torch.milp import bnb
from tpulp_torch.solve import dual

from test_torch_model import to_port

torch.set_num_threads(1)
pytestmark = pytest.mark.filterwarnings(
    "error:There is a performance drop")

B = 8
CAP = 6


def _knapsack(n_items, seed):
    """tests/test_device_gen.py's knapsack."""
    rng = np.random.default_rng(seed)
    values = rng.integers(10, 60, size=n_items)
    weights = rng.integers(5, 25, size=n_items)
    lp = LinProg(f"kn_{seed}")
    obj = LinExpr()
    wexpr = LinExpr()
    for i in range(n_items):
        lp.addVar(f"x{i}", integral=True, lb=0, ub=1)
        obj += LinExpr(int(values[i]), f"x{i}")
        wexpr += LinExpr(int(weights[i]), f"x{i}")
    lp.maximize(obj)
    lp.addConstraint(wexpr.constraintLeq(int(weights.sum() * 0.4)))
    return lp


def _close(a, b, rtol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.array_equal(np.isfinite(a), np.isfinite(b))
    fin = np.isfinite(b)
    scale = max(float(np.abs(b[fin]).max(initial=1.0)), 1.0)
    assert np.abs(a[fin] - b[fin]).max(initial=0.0) <= rtol * scale


def _same_states(out, ref):
    for name in ("status", "niter", "basis", "phase", "stuck", "bland",
                 "col_active", "art_cols"):
        assert np.array_equal(getattr(out, name).numpy(),
                              np.asarray(getattr(ref, name))), name
    _close(out.T.numpy(), np.asarray(ref.T))


def _same_summaries(out, ref, m):
    out, ref = out.numpy(), np.asarray(ref)
    ints = [3, 4, 5] + list(range(6, 6 + m))
    assert np.array_equal(out[:, ints], ref[:, ints])
    _close(out, ref)


class _Wave:
    """One root (a 12-item knapsack with bound rows), B node lanes with
    random fixings, the template of both packages, and the cold wave's
    terminal states and summaries."""

    def __init__(self):
        sf = lower_to_standard_form(_knapsack(12, 1),
                                    integer_bound_rows=True)
        self.sf = sf
        self.names = [n for n in sf.int_bound_rows]
        rng = np.random.default_rng(4)
        self.bounds = []
        for _ in range(B):
            bd = {}
            for nm in rng.choice(self.names, size=2, replace=False):
                v = int(rng.integers(0, 2))
                bd[str(nm)] = (v, v)
            self.bounds.append(bd)
        self.b_mat = np.array([[float(v) for v in
                                bnb._node_standard_form(sf, bd).b]
                               for bd in self.bounds])
        self.mask = np.array([1.0 if h < 0 else 0.0 for h in sf.basis_hint])
        self.jt = j_make_batched([sf] * B, dtype=jnp.float64)
        self.tt = make_batched_states(to_port([sf] * B), device="cpu")
        n_batched = self.jt.T.shape[2] - 1
        R, const = bnb._int_recover_matrix(sf, self.names, n_batched,
                                           np.float64)
        self.jR, self.jc = jnp.asarray(R), jnp.asarray(const)
        self.tR, self.tc = torch.as_tensor(R), torch.as_tensor(const)
        self.jopts = jbnb.SolverOptions.for_dtype(jnp.float64)
        self.topts = bnb.SolverOptions.for_dtype(torch.float64)
        self.jcold = j_run_batch(jbnb._refresh_template(
            self.jt, jnp.asarray(self.b_mat), jnp.asarray(self.mask)),
            self.jopts)
        self.tcold = run_simplex_batch(bnb._refresh_template(
            self.tt, torch.as_tensor(self.b_mat),
            torch.as_tensor(self.mask)), self.topts)
        self.jsum = jdual.pack_wave_summary(self.jcold, self.jR, self.jc)
        self.tsum = dual.pack_wave_summary(self.tcold, self.tR, self.tc)
        art0j = self.jt.art_cols[0]
        self.jmasks = (self.jt.col_active[0] & ~art0j, art0j)
        art0t = self.tt.art_cols[0]
        self.tmasks = (self.tt.col_active[0] & ~art0t, art0t)
        self.row_adj = {}
        for j, nm in enumerate(sf.col_names):
            if j >= sf.n_struct and nm[:2] in ("_s", "_e"):
                self.row_adj[int(nm[2:])] = (j, 1 if nm[1] == "s" else -1)

    def pools(self):
        """A (CAP)-slot pool of both packages holding lanes 0..5."""
        jp = (jnp.zeros((CAP,) + self.jt.T.shape[1:]),
              jnp.zeros((CAP, self.sf.m), jnp.int32))
        tp = dual.new_pool(CAP, self.tt.T.shape[1:], self.sf.m,
                           torch.float64, "cpu")
        slots = np.arange(B, dtype=np.int32)
        slots[CAP:] = CAP
        lanes = np.arange(B, dtype=np.int32)
        jp = jdual.pool_write(*jp, jnp.asarray(slots), self.jcold.T,
                              self.jcold.basis, jnp.asarray(lanes))
        tp = dual.pool_write(*tp, slots, self.tcold.T, self.tcold.basis,
                             lanes)
        return jp, tp

    def child_packs(self):
        """(idx, cols, deltas) of the down child of each optimal lane's most
        fractional variable, parents in pool slots 0..5."""
        summ = np.asarray(self.jsum)
        idx, cols, deltas = [], [], []
        for lane in range(CAP):
            nm = self.names[int(summ[lane, 5])]
            le_row, _ = self.sf.int_bound_rows[nm]
            ub = self.bounds[lane].get(nm, (0, 1))[1]
            f = int(np.floor(summ[lane, 2]))
            col, sign = self.row_adj[le_row]
            idx.append(lane)
            cols.append(col)
            deltas.append(sign * (f - ub))
        return (np.array(idx, np.int32), np.array(cols, np.int32),
                np.array(deltas, np.int32))


@pytest.fixture(scope="module")
def wave():
    return _Wave()


def test_cold_wave_matches_tpulp(wave):
    _same_states(wave.tcold, wave.jcold)
    statuses = set(wave.tcold.status.tolist())
    assert Status.OPTIMAL in statuses


def test_refresh_template_matches_tpulp(wave):
    ref = jbnb._refresh_template(wave.jt, jnp.asarray(wave.b_mat),
                                 jnp.asarray(wave.mask))
    out = bnb._refresh_template(wave.tt, torch.as_tensor(wave.b_mat),
                                torch.as_tensor(wave.mask))
    assert np.array_equal(out.T.numpy(), np.asarray(ref.T))
    assert not torch.equal(out.T, wave.tt.T)  # the template is unchanged


def test_pack_wave_summary_matches_tpulp(wave):
    _same_summaries(wave.tsum, wave.jsum, wave.sf.m)
    assert float(wave.tsum[:, 1].max()) > 1e-6  # fractional lanes present


@pytest.mark.parametrize("slots", [
    [3, 0, CAP, 5, CAP, CAP, CAP, 1],       # padded: the dropped slot
    [CAP + 2, 2, 4, CAP + 9, CAP, 1, 0, 5],  # past the capacity
], ids=["padded", "overflow"])
def test_pool_write_matches_tpulp(wave, slots):
    jp, tp = wave.pools()
    slots = np.array(slots, np.int32)
    lanes = np.array([7, 6, 5, 4, 3, 2, 1, 0], np.int32)
    jp = jdual.pool_write(*jp, jnp.asarray(slots), wave.jcold.T,
                          wave.jcold.basis, jnp.asarray(lanes))
    out = dual.pool_write(*tp, slots, wave.tcold.T, wave.tcold.basis, lanes)
    assert out[0] is tp[0] and out[1] is tp[1]  # written in place
    assert np.array_equal(tp[0][:CAP].numpy(), np.asarray(jp[0]))
    assert np.array_equal(tp[1][:CAP].numpy(), np.asarray(jp[1]))


def test_run_warm_carry_batch_matches_tpulp(wave):
    jp, tp = wave.pools()
    idx, cols, deltas = wave.child_packs()
    ref = jdual.run_warm_carry_batch(*jp, *wave.jmasks, idx, cols, deltas,
                                     wave.jopts)
    out = dual.run_warm_carry_batch(*tp, *wave.tmasks, idx, cols, deltas,
                                    wave.topts)
    _same_states(out, ref)
    assert int(out.niter.sum()) > 0


def test_run_warm_wave_matches_tpulp(wave):
    """The warm wave with deferred writes (two real, the rest dropped) into
    slots the gather then reads."""
    jp, tp = wave.pools()
    idx, cols, deltas = wave.child_packs()
    ipack = np.zeros((B, 5), np.int32)
    ipack[:, 2] = CAP
    ipack[:CAP, 0], ipack[:CAP, 1], ipack[:CAP, 4] = idx[::-1], cols[::-1], \
        deltas[::-1]
    ipack[CAP:, 0], ipack[CAP:, 1], ipack[CAP:, 4] = idx[-1], cols[-1], \
        deltas[-1]
    ipack[:2, 2] = [0, 5]     # deferred writes over two parents' slots
    ipack[:2, 3] = [7, 6]
    ref = jdual.run_warm_wave(*jp, *wave.jmasks, wave.jcold.T,
                              wave.jcold.basis, ipack, wave.jR, wave.jc,
                              jnp.asarray(500, jnp.int32), wave.jopts)
    out = dual.run_warm_wave(*tp, *wave.tmasks, wave.tcold.T,
                             wave.tcold.basis, ipack, wave.tR, wave.tc, 500,
                             wave.topts)
    assert np.array_equal(out[0][:CAP].numpy(), np.asarray(ref[0]))
    assert np.array_equal(out[1][:CAP].numpy(), np.asarray(ref[1]))
    _same_states(out[2], ref[2])
    _same_summaries(out[3], ref[3], wave.sf.m)


def _gen_meta(wave):
    le_c, le_s, ge_c, ge_s = [], [], [], []
    for nm in wave.names:
        le_row, ge_row = wave.sf.int_bound_rows[nm]
        le_c.append(wave.row_adj[le_row][0])
        le_s.append(float(wave.row_adj[le_row][1]))
        ge_c.append(wave.row_adj[ge_row][0])
        ge_s.append(float(wave.row_adj[ge_row][1]))
    return le_c, le_s, ge_c, ge_s


@pytest.mark.parametrize("case", ["all", "cut"])
def test_run_expand_generation_matches_tpulp(wave, case):
    """All lanes active under no cut (more than B/2 expand: children past B
    are dropped), then a partial active mask under a real cut."""
    n_int = len(wave.names)
    lbm = np.zeros((B, n_int))
    ubm = np.ones((B, n_int))
    for lane, bd in enumerate(wave.bounds):
        for jj, nm in enumerate(wave.names):
            lbm[lane, jj], ubm[lane, jj] = bd.get(nm, (0, 1))
    active = np.ones(B, bool)
    cut = -np.inf
    if case == "cut":
        active[::3] = False
        corners = np.asarray(wave.jsum)[:, 0]
        cut = float(np.median(corners[np.isfinite(corners)]))
    le_c, le_s, ge_c, ge_s = _gen_meta(wave)
    ref = jdual.run_expand_generation(
        wave.jcold.T, wave.jcold.basis, wave.jsum, jnp.asarray(active),
        jnp.asarray(lbm), jnp.asarray(ubm), *wave.jmasks,
        jnp.asarray(le_c, jnp.int32), jnp.asarray(le_s),
        jnp.asarray(ge_c, jnp.int32), jnp.asarray(ge_s), jnp.asarray(cut),
        jnp.asarray(1e-6), jnp.asarray(500, jnp.int32), wave.jR, wave.jc,
        opts=wave.jopts)
    out = dual.run_expand_generation(
        wave.tcold.T, wave.tcold.basis, wave.tsum, torch.as_tensor(active),
        torch.as_tensor(lbm), torch.as_tensor(ubm), *wave.tmasks,
        torch.tensor(le_c), torch.tensor(le_s), torch.tensor(ge_c),
        torch.tensor(ge_s), torch.tensor(cut, dtype=torch.float64),
        torch.tensor(1e-6, dtype=torch.float64), 500, wave.tR, wave.tc,
        opts=wave.topts)
    _same_states(out[0], ref[0])
    _same_summaries(out[1][:, :-2], ref[1][:, :-2], wave.sf.m)
    assert np.array_equal(out[1][:, -2:].numpy(), np.asarray(ref[1][:, -2:]))
    for o, r in zip(out[2:], ref[2:]):
        assert np.array_equal(o.numpy(), np.asarray(r))
    expanded = int(out[5].sum())
    if case == "all":
        assert 2 * expanded > B  # some children were dropped
    assert int(out[2].sum()) == min(2 * expanded, B)


def test_grouped_writes_keep_sources_apart(wave):
    """solve_milp groups pool writes by ``id(out.T)`` while each group holds
    its state: two states with equal but distinct tableaus form two
    groups, and the pool receives each group's own lanes."""
    a = wave.tcold
    b = a._replace(T=a.T.clone())
    groups = {}
    for out, lane, slot in ((a, 0, 1), (b, 1, 2), (a, 2, 3)):
        g = groups.setdefault(id(out.T), (out, [], []))
        g[1].append(slot)
        g[2].append(lane)
    assert len(groups) == 2
    pool = dual.new_pool(CAP, a.T.shape[1:], wave.sf.m, torch.float64,
                         "cpu")
    for out, slots, lanes in groups.values():
        dual.pool_write(*pool, slots, out.T, out.basis, lanes)
    for slot, lane in ((1, 0), (2, 1), (3, 2)):
        assert torch.equal(pool[0][slot], a.T[lane])
