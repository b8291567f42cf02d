"""tpulp_torch's comm layer and the sharded drivers' collective structure.

``init_distributed``'s argument resolution and idempotence (with
``init_process_group`` stubbed), the meshes of ``global_device_mesh`` and
``process_local_lanes`` on 4 gloo ranks as 2 hosts, the collectives'
results on every dtype the drivers use, the pins of
tests/test_scaling_analysis.py on ``collective_profile`` /
``assert_fused_psum`` at P = 1, 2 and 4, and the P = 1 overhead guard of
``tools/torch_scaling_overhead.py``. The ranks are tests/test_torch_shard.py
run as a script, with this module's ``HANDLERS``; top-level imports are
torch-only for that reason.
"""

from __future__ import annotations

import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from test_torch_shard import REPO, InProcessGroup, replicated, start_group

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# init_distributed: resolution order, backend, idempotence
# ---------------------------------------------------------------------------

ENV_NAMES = ("TPULP_COORDINATOR", "TPULP_NUM_PROCESSES", "TPULP_PROCESS_ID",
             "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
             "LOCAL_WORLD_SIZE")


@pytest.fixture
def fake_group(monkeypatch):
    """``init_process_group`` recorded instead of run; the group counts as
    up once it was called."""
    from tpulp_torch.comm import distributed

    for name in ENV_NAMES:
        monkeypatch.delenv(name, raising=False)
    calls = []
    monkeypatch.setattr(distributed, "_initialized", False)
    monkeypatch.setattr(dist, "is_initialized", lambda: bool(calls))
    monkeypatch.setattr(dist, "get_rank",
                        lambda group=None: calls[-1][1]["rank"])
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    return calls


CASES = {
    "explicit_over_env": (
        ("h1:1", 4, 2), {"TPULP_COORDINATOR": "h2:2",
                         "TPULP_NUM_PROCESSES": "8", "TPULP_PROCESS_ID": "5",
                         "MASTER_ADDR": "h3", "WORLD_SIZE": "16",
                         "RANK": "9"},
        ("tcp://h1:1", 4, 2)),
    "tpulp_env_over_torchrun": (
        (None, None, None), {"TPULP_COORDINATOR": "h2:2",
                             "TPULP_NUM_PROCESSES": "8",
                             "TPULP_PROCESS_ID": "5", "MASTER_ADDR": "h3",
                             "MASTER_PORT": "3", "WORLD_SIZE": "16",
                             "RANK": "9"},
        ("tcp://h2:2", 8, 5)),
    "torchrun_env": (
        (None, None, None), {"MASTER_ADDR": "h3", "MASTER_PORT": "3",
                             "WORLD_SIZE": "16", "RANK": "9"},
        ("tcp://h3:3", 16, 9)),
    "mixed": (
        (None, 6, None), {"MASTER_ADDR": "h3", "MASTER_PORT": "3",
                          "WORLD_SIZE": "16", "TPULP_PROCESS_ID": "1",
                          "RANK": "9"},
        ("tcp://h3:3", 6, 1)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_init_distributed_resolves_in_order(fake_group, monkeypatch, case):
    from tpulp_torch.comm import init_distributed, is_distributed

    args, env, (method, world, rank) = CASES[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert init_distributed(*args, device="cpu") == rank
    assert fake_group == [("gloo", {"init_method": method,
                                    "world_size": world, "rank": rank})]
    assert is_distributed()
    # idempotent while the group is up
    assert init_distributed("elsewhere:9", 99, 0, device="cpu") == rank
    assert len(fake_group) == 1


def test_init_distributed_single_process_is_a_noop(fake_group):
    from tpulp_torch.comm import init_distributed, is_distributed

    assert init_distributed(device="cpu") == 0
    assert init_distributed(None, 1, None, device="cpu") == 0
    assert fake_group == [] and is_distributed()


def test_init_distributed_nccl_on_cuda(fake_group, monkeypatch):
    from tpulp_torch.comm import init_distributed

    chosen = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", chosen.append)
    monkeypatch.setenv("LOCAL_RANK", "3")
    init_distributed("h:1", 8, 7, device="cuda")
    backend, kw = fake_group[0]
    assert backend == "nccl" and chosen == [3]
    assert kw["device_id"] == torch.device("cuda", 3)


def test_init_distributed_needs_every_field(fake_group):
    from tpulp_torch.comm import init_distributed

    with pytest.raises(ValueError, match="coordinator"):
        init_distributed("h:1", 2, None, device="cpu")


# ---------------------------------------------------------------------------
# the ranks' handlers (run by tests/test_torch_shard.py as a script)
# ---------------------------------------------------------------------------

def _h_layout(task, meshes):
    from tpulp_torch.comm import global_device_mesh, process_local_lanes

    mesh = global_device_mesh(device="cpu")
    names = list(mesh.mesh_dim_names)
    return {"names": names, "mesh": mesh.mesh.tolist(),
            "lanes": {a: list(process_local_lanes(mesh, a)) for a in names},
            "rank": dist.get_rank()}


def _h_collectives(task, meshes):
    """Each collective on each dtype, over ``cols`` and the tuple axis."""
    from tpulp_torch.comm.collectives import MeshAxis

    out = {}
    for key, mesh in meshes.items():
        axis = tuple(mesh.mesh_dim_names) if key == "hybrid" else "cols"
        lay = MeshAxis(mesh, axis)
        me = lay.index
        for dt in (torch.float32, torch.float64, torch.int32):
            x = torch.tensor([me + 1, -me, 3 * me], dtype=dt)
            name = f"{key}-{str(dt)[6:]}"
            out[name] = {
                "psum": lay.psum(x).tolist(),
                "pmin": lay.pmin(x).tolist(),
                "pmax": lay.pmax(x).tolist(),
                "gather": lay.all_gather(x).tolist(),
                "scalar": lay.all_gather(x[0]).tolist(),
                "psum0": lay.psum(x.sum()).item()}
        flag = torch.tensor([me % 2 == 0, True])
        out[f"{key}-bool"] = lay.all_gather(flag).tolist()
        out[f"{key}-index"] = me
    return out


def _h_profile(task, meshes):
    from tpulp_torch.core import RULE_DEVEX
    from tpulp_torch.shard.analysis import (assert_fused_psum,
                                            collective_profile)

    mesh = meshes["cols"]
    dantzig = assert_fused_psum(mesh, m=6, n=10, block=8)
    devex = assert_fused_psum(mesh, m=6, n=10, block=8, rule=RULE_DEVEX)
    rank1 = collective_profile(mesh, m=6, n=10, driver="rank1", steps=8)
    return {"dantzig": dantzig, "devex": devex,
            "rank1": {f"{k}:{d}x{e}": c
                      for (k, d, e), c in rank1["calls"].items()}}


def _h_overhead(task, meshes):
    """tests/test_scaling_analysis.py's walk at fixed size: the niter of
    a 100-pivot budget, which every shard count must reach alike."""
    import numpy as np

    from tpulp_torch.core import SolverOptions, make_state
    from tpulp_torch.shard import (run_simplex_sharded_blocked,
                                   to_sharded_state)

    rng = np.random.default_rng(0)
    m, n = 64, 447
    A = rng.normal(size=(m, n))
    x0 = np.abs(rng.normal(size=n))
    b = np.abs(A @ x0) + np.abs(rng.normal(size=m))
    c = rng.normal(size=n)
    A[-1] = 1.0
    b[-1] = 2.0 * x0.sum()
    st = make_state(np.concatenate([c, np.zeros(m)]),
                    np.concatenate([A, np.eye(m)], axis=1), b,
                    list(range(n, n + m)), dtype=torch.float32, device="cpu")
    mesh = meshes["cols"]
    out = run_simplex_sharded_blocked(
        to_sharded_state(st, mesh), mesh,
        SolverOptions.for_dtype(torch.float32, max_iters=100), block=16)
    return {"niter": int(out.niter), "status": int(out.status),
            "basis": out.basis.tolist()}


HANDLERS = {"layout": _h_layout, "collectives": _h_collectives,
            "profile": _h_profile, "overhead": _h_overhead}
TASKS = [{"id": k, "kind": k} for k in HANDLERS]


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """{P: every rank's results}: P = 1 in this process, P = 2 flat, P = 4
    as 2 hosts x 2 cards."""
    import test_torch_shard

    tmp = str(tmp_path_factory.mktemp("comm"))
    waits = {2: start_group(TASKS, 2, tmp, handlers="test_torch_comm"),
             4: start_group(TASKS, 4, tmp, handlers="test_torch_comm",
                            local_world=2)}
    test_torch_shard.HANDLERS.update(HANDLERS)
    with InProcessGroup() as g:
        res = {1: [test_torch_shard.run_group(TASKS, 0, 1, g.meshes)]}
    res.update({p: wait() for p, wait in waits.items()})
    return res


def test_global_device_mesh_two_hosts(groups):
    ranks = groups[4]
    for r, res in enumerate(ranks):
        lay = res["layout"]
        assert lay["rank"] == r
        assert lay["names"] == ["hosts", "cols"]
        assert lay["mesh"] == [[0, 1], [2, 3]]
        # host-major: ranks 0, 1 on host 0, ranks 2, 3 on host 1
        assert lay["lanes"] == {"hosts": [r // 2, r // 2 + 1],
                                "cols": [r % 2, r % 2 + 1]}


@pytest.mark.parametrize("p", [1, 2])
def test_global_device_mesh_one_host(groups, p):
    for r, res in enumerate(groups[p]):
        assert res["layout"]["names"] == ["cols"]
        assert res["layout"]["mesh"] == list(range(p))
        assert res["layout"]["lanes"] == {"cols": [r, r + 1]}


@pytest.mark.parametrize("p", [1, 2, 4])
def test_collectives_on_every_dtype(groups, p):
    ranks = [res["collectives"] for res in groups[p]]
    keys = [k for k in ranks[0] if not k.endswith(("-bool", "-index"))]
    assert keys
    for key in keys:
        got = replicated(ranks, key)
        idx = range(p)
        rows = [[i + 1, -i, 3 * i] for i in idx]
        assert got["psum"] == [sum(col) for col in zip(*rows)]
        assert got["pmin"] == [min(col) for col in zip(*rows)]
        assert got["pmax"] == [max(col) for col in zip(*rows)]
        assert got["gather"] == rows
        assert got["scalar"] == [i + 1 for i in idx]
        assert got["psum0"] == sum(sum(r) for r in rows)
    for key in [k for k in ranks[0] if k.endswith("-bool")]:
        assert replicated(ranks, key) == [[i % 2 == 0, True] for i in
                                          range(p)]
    # shard indices: the flat index along the axis, host-major for tuples
    for key in [k for k in ranks[0] if k.endswith("-index")]:
        assert [r[key] for r in ranks] == list(range(p))


@pytest.mark.parametrize("p", [1, 2, 4])
def test_blocked_one_fused_psum(groups, p):
    """tests/test_scaling_analysis.py's pins, on counted calls: ONE fused
    (m+2+K+1) psum a pivot, two dependent rounds (the packed pricing
    gather, then the fetch), the per-block seeds and (ray, guard) psum."""
    prof = replicated([res["profile"] for res in groups[p]], "dantzig")
    assert prof["n_fused"] == 1
    assert prof["fused_psum_elems"] == 6 + 2 + 8 + 1
    assert prof["dependent_rounds_per_pivot"] == 2
    assert prof["collectives_per_pivot"] == {"all_gather:float64x4": 1,
                                             "psum:float32x17": 1}
    assert prof["collectives_per_block"] == {"psum:int32x6": 2,
                                             "psum:int32x2": 1}
    # a rank's bytes a pivot: the 17 float32 lanes and 4 float64 candidates
    assert prof["bytes_per_pivot"] == 4 * 17 + 8 * 4


@pytest.mark.parametrize("p", [1, 2, 4])
def test_devex_adds_one_lane_and_one_scalar_pmax(groups, p):
    prof = replicated([res["profile"] for res in groups[p]], "devex")
    assert prof["fused_psum_elems"] == 6 + 2 + 8 + 2
    assert prof["collectives_per_pivot"] == {"all_gather:float64x4": 1,
                                             "psum:float32x18": 1,
                                             "pmax:float32x1": 1}


@pytest.mark.parametrize("p", [1, 2, 4])
def test_rank1_fetches_one_column_a_pivot(groups, p):
    """tpulp's rank-1 driver compiles TWO (m+2) column psums (the idle
    step's second fetch under lax.cond); the port builds the idle column
    locally, so a step makes ONE, and no fused one. Its pricing and
    cleanup candidates ride one packed gather, as the blocked driver's
    (tpulp: two scalar all_gathers and two pmins)."""
    calls = replicated([res["profile"] for res in groups[p]], "rank1")
    assert calls == {"psum:int32x6": 8,     # cleanup scan
                     "all_gather:float64x4": 8,  # pricing, Bland, cleanup
                     "psum:float32x8": 8,   # the entering column
                     "psum:float32x1": 8}   # the pricing row's guard


def test_overhead_walk_equal_across_shard_counts(groups):
    walks = [replicated([res["overhead"] for res in groups[p]], "niter")
             for p in (1, 2, 4)]
    assert walks[0] == walks[1] == walks[2] >= 50
    bases = [replicated([res["overhead"] for res in groups[p]], "basis")
             for p in (1, 2, 4)]
    assert bases[0] == bases[1] == bases[2]


def test_scaling_overhead_guard_passes():
    """tools/torch_scaling_overhead.py --guard --device cpu: the P = 1
    sharded blocked driver within 4x the solo driver a pivot."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "WORLD_SIZE", "RANK")}
    env.update(OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools",
                                      "torch_scaling_overhead.py"),
         "--guard", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "ratio" in res.stdout and "ok" in res.stdout
