"""tpulp_torch.solve_milp's early exits, checkpoints and surface against
tpulp's: ``node_limit`` / ``time_limit`` / ``gap_tol`` statuses and
``mip_gap``, resume across the two packages in both directions, the state
checkpoint, and the options that raise."""

import json

import numpy as np
import pytest
import torch

import tpulp.milp.bnb as jbnb
import tpulp_torch
from tpulp_torch.io import (load_bnb_frontier, load_state, save_bnb_frontier,
                            save_state)

from test_torch_milp import COUNTERS, dp_oracle, knapsack

from test_torch_model import to_port

torch.set_num_threads(1)
pytestmark = pytest.mark.filterwarnings(
    "error:There is a performance drop")


def test_node_limit_gap_equals_tpulps():
    lp = knapsack(16, 5)[0]
    ref = jbnb.solve_milp(lp, batch_size=4, max_nodes=6)
    out = tpulp_torch.solve_milp(to_port(lp), batch_size=4, max_nodes=6,
                                 device="cpu")
    assert out.status == ref.status == "node_limit"
    assert out.objective == ref.objective is not None
    assert out.mip_gap == ref.mip_gap and out.mip_gap > 0.0


def test_time_limit_zero_stops_before_a_wave():
    lp = knapsack(12, 7)[0]
    ref = jbnb.solve_milp(lp, time_limit=0.0)
    out = tpulp_torch.solve_milp(to_port(lp), time_limit=0.0, device="cpu")
    assert out.status == ref.status == "time_limit"
    assert out.x is None and out.mip_gap is None


def test_gap_tol_returns_an_incumbent_within_the_gap():
    lp, values, weights, cap = knapsack(18, 7)
    ref = jbnb.solve_milp(lp, gap_tol=0.5, batch_size=4)
    out = tpulp_torch.solve_milp(to_port(lp), gap_tol=0.5, batch_size=4,
                                 device="cpu")
    assert out.status == ref.status
    assert out.objective == ref.objective
    if out.status == "gap_limit":
        assert 0.0 <= out.mip_gap <= 0.5 and 0.0 <= ref.mip_gap <= 0.5
        assert sum(w for i, w in enumerate(weights)
                   if out.x[f"x{i}"] == 1) <= cap
    else:
        assert out.objective == dp_oracle(values, weights, cap)


def test_generous_time_limit_proves_optimal():
    lp, values, weights, cap = knapsack(12, 7)
    out = tpulp_torch.solve_milp(to_port(lp), time_limit=600.0, device="cpu")
    assert out.status == "optimal" and out.mip_gap == 0.0
    assert out.objective == dp_oracle(values, weights, cap)


@pytest.mark.parametrize("writer", ["tpulp", "port"])
def test_resume_across_packages(tmp_path, writer):
    """A checkpoint written mid-solve by one package resumes in the other
    to the optimum; the resumed first wave warm-starts from the
    checkpointed parent bases."""
    lp, values, weights, cap = knapsack(18, 11)
    ck = str(tmp_path / "bnb.json")
    kw = dict(batch_size=8, max_nodes=20, checkpoint_path=ck,
              checkpoint_every=1)
    if writer == "tpulp":
        part = jbnb.solve_milp(lp, **kw)
        sol, stats = tpulp_torch.solve_milp(to_port(lp), batch_size=16,
                                            resume_from=ck,
                                            return_stats=True, device="cpu")
    else:
        part = tpulp_torch.solve_milp(to_port(lp), device="cpu", **kw)
        sol, stats = jbnb.solve_milp(lp, batch_size=16, resume_from=ck,
                                     return_stats=True)
    assert part.status == "node_limit"
    nodes = json.load(open(ck))["nodes"]
    assert any(nd.get("basis") for nd in nodes)
    assert sol.status == "optimal"
    assert sol.objective == dp_oracle(values, weights, cap)
    assert stats.warm_nodes > 0


def test_both_packages_write_the_same_checkpoint(tmp_path):
    lp = knapsack(18, 11)[0]
    paths = {k: str(tmp_path / f"{k}.json") for k in ("tpulp", "port")}
    kw = dict(batch_size=8, max_nodes=20, checkpoint_every=1)
    jbnb.solve_milp(lp, checkpoint_path=paths["tpulp"], **kw)
    tpulp_torch.solve_milp(to_port(lp), checkpoint_path=paths["port"],
                           device="cpu", **kw)
    ref, out = (json.load(open(paths[k])) for k in ("tpulp", "port"))
    assert out == ref


def test_frontier_round_trip(tmp_path):
    from fractions import Fraction as F

    path = str(tmp_path / "f.json")
    entries = [(F(-7, 3), 4, {"x": (F(0), F(1))}, np.array([3, 1, 2])),
               (F(5), 9, {"y": (F(1, 2), F(2))}, None)]
    save_bnb_frontier(path, entries, F(-2), meta={"k": 1})
    loaded, inc, meta = load_bnb_frontier(path)
    assert inc == F(-2) and meta == {"k": 1}
    assert loaded[0][:3] == entries[0][:3] and loaded[1][:3] == entries[1][:3]
    assert list(loaded[0][3]) == [3, 1, 2] and loaded[1][3] is None


def test_state_checkpoint_round_trip(tmp_path):
    from tpulp_torch.solve.api import state_from_standard_form

    s = state_from_standard_form(to_port(knapsack(6, 0)[0].lower()),
                                 device="cpu")
    path = str(tmp_path / "s.npz")
    save_state(path, s)
    back = load_state(path, device="cpu")
    for x, y in zip(s, back):
        assert x.dtype == y.dtype and torch.equal(x, y)
    f32 = load_state(path, dtype=torch.float32, device="cpu")
    assert f32.T.dtype == f32.last_z.dtype == torch.float32


@pytest.mark.parametrize("option", [
    {"mesh": object()}, {"node_encoding": "spans"},
], ids=["mesh", "spans"])
def test_options_not_ported_raise(option):
    """The two options once refused here: ``mesh=`` takes a DeviceMesh and
    nothing else, and ``node_encoding='spans'`` runs tpulp's tree."""
    lp = knapsack(4, 0)[0]
    if "mesh" in option:
        with pytest.raises(TypeError, match="DeviceMesh"):
            tpulp_torch.solve_milp(to_port(lp), device="cpu", **option)
        return
    ref, rst = jbnb.solve_milp(lp, return_stats=True, **option)
    out, ost = tpulp_torch.solve_milp(to_port(lp), return_stats=True,
                                      device="cpu", **option)
    assert (out.status, out.objective, out.x) == \
        (ref.status, ref.objective, ref.x)
    assert {k: getattr(ost, k) for k in COUNTERS} == \
        {k: getattr(rst, k) for k in COUNTERS}


def test_bad_arguments_raise_like_tpulp():
    lp = knapsack(4, 0)[0]
    with pytest.raises(TypeError):
        tpulp_torch.solve_milp(to_port(lp.lower()), device="cpu")
    with pytest.raises(ValueError, match="branching"):
        tpulp_torch.solve_milp(to_port(lp), branching="strongest",
                               device="cpu")


def test_milp_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tpulp_torch.solve_milp(to_port(knapsack(4, 0)[0]))
