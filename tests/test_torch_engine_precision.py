"""Full-precision products in tpulp_torch's engines: tpulp pins every eta
product and flush to ``Precision.HIGHEST``; the port's engines and plain
kernel versions pin float32 matrix products to "highest" for their own run
and give the caller back exactly the settings it had, also when they
raise, whichever of torch's precision APIs the caller used."""

import numpy as np
import pytest
import torch

import tpulp.solve as tpulp_solve
import tpulp_torch
from tpulp.corpus import get_case
from tpulp_torch.core import (SolverOptions, eta_scaled_options,
                              full_precision, make_state)
from tpulp_torch.kernels import (blocked_inner_block_reference,
                                 fused_flush_reference)
from tpulp_torch.solve import (run_simplex_blocked, run_simplex_blocked_kernel,
                               run_simplex_refreshed)
from tpulp_torch.solve.blocked_kernel import kernel_inputs

from test_torch_model import to_port

torch.set_num_threads(1)

BACKENDS = torch.backends
# a caller's lower precision, set through each of torch's APIs
CALLER = {
    "high": lambda: torch.set_float32_matmul_precision("high"),
    "medium": lambda: torch.set_float32_matmul_precision("medium"),
    "allow_tf32": lambda: setattr(BACKENDS.cuda.matmul, "allow_tf32", True),
    "backend_strings": lambda: (
        setattr(BACKENDS.cuda.matmul, "fp32_precision", "tf32"),
        setattr(BACKENDS.mkldnn.matmul, "fp32_precision", "bf16")),
}
HIGHEST = ("highest", "ieee", "ieee")


def settings():
    """Torch's float32 matmul settings: the legacy precision (None where
    torch refuses to report it) and the cuda and mkldnn matmul strings."""
    try:
        legacy = torch.get_float32_matmul_precision()
    except RuntimeError:
        legacy = None
    return (legacy, BACKENDS.cuda.matmul.fp32_precision,
            BACKENDS.mkldnn.matmul.fp32_precision)


@pytest.fixture(params=list(CALLER))
def caller(request):
    """Applies one caller setting for a test; returns torch's settings as
    the caller left them, and puts the process defaults back afterwards."""
    CALLER[request.param]()
    try:
        yield settings()
    finally:
        torch.set_float32_matmul_precision("highest")
        BACKENDS.cuda.matmul.fp32_precision = "none"
        BACKENDS.mkldnn.matmul.fp32_precision = "none"


@pytest.fixture
def matmul_probe(monkeypatch):
    """Records torch's float32 matmul settings at every ``@``."""
    seen = []
    real = torch.Tensor.__matmul__

    def probe(a, b):
        seen.append(settings())
        return real(a, b)

    monkeypatch.setattr(torch.Tensor, "__matmul__", probe)
    return seen


def _bounded(seed, m=12, n=20):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n))
    x0 = np.abs(rng.normal(size=n))
    b = A @ x0 + np.abs(rng.normal(size=m))
    c = rng.normal(size=n)
    A[-1] = 1.0
    b[-1] = 2.0 * x0.sum()
    return (np.concatenate([c, np.zeros(m)]),
            np.concatenate([A, np.eye(m)], axis=1), b,
            list(range(n, n + m)))


def _state(dtype=torch.float32):
    return make_state(*_bounded(0), dtype=dtype, device="cpu")


def _flush_args():
    rng = np.random.default_rng(4)
    M, N, K = 14, 33, 8
    return (torch.tensor(rng.normal(size=(M, N)), dtype=torch.float32),
            torch.tensor(rng.normal(size=(K, M)), dtype=torch.float32),
            torch.tensor(rng.normal(size=(K, N)), dtype=torch.float32),
            torch.ones((N,), dtype=torch.int32), 1e-5, 1e-5)


def _inner_args():
    s = _state()
    opts = eta_scaled_options(SolverOptions.for_dtype(torch.float32),
                              torch.float32)
    return (*kernel_inputs(s), opts, opts.resolved_stall_limit(s.m, s.n), 8)


def _refreshed():
    c, A, b, hint = _bounded(0)
    return run_simplex_refreshed(c, A, b, hint, dtype=torch.float32,
                                 engine="blocked", block=8, segment=16,
                                 device="cpu")


ENTRY_POINTS = {
    "run_simplex_blocked": lambda: run_simplex_blocked(_state(), block=8),
    "run_simplex_blocked_kernel": lambda: run_simplex_blocked_kernel(
        _state(), block=8),
    "run_simplex_refreshed": _refreshed,
    "fused_flush_reference": lambda: fused_flush_reference(*_flush_args()),
    "blocked_inner_block_reference": lambda: blocked_inner_block_reference(
        *_inner_args()),
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_products_run_at_highest(entry, caller, matmul_probe):
    ENTRY_POINTS[entry]()
    assert matmul_probe, "the entry point ran no matrix product"
    assert set(matmul_probe) == {HIGHEST}
    assert settings() == caller


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_caller_setting_restored_on_error(entry, caller, monkeypatch):
    def boom(a, b):
        raise RuntimeError("product failed")

    monkeypatch.setattr(torch.Tensor, "__matmul__", boom)
    with pytest.raises(RuntimeError, match="product failed"):
        ENTRY_POINTS[entry]()
    assert settings() == caller


def test_full_precision_context(caller):
    with full_precision():
        assert settings() == HIGHEST
        with full_precision():
            assert settings() == HIGHEST
        assert settings() == HIGHEST
    assert settings() == caller
    with pytest.raises(KeyError):
        with full_precision():
            raise KeyError("x")
    assert settings() == caller


def test_caller_can_switch_tf32_off_afterwards():
    """allow_tf32 = True, an engine, then allow_tf32 = False: torch still
    reports the matmul precision (a restore through
    set_float32_matmul_precision alone left mkldnn at tf32, and torch then
    raised here)."""
    try:
        BACKENDS.cuda.matmul.allow_tf32 = True
        fused_flush_reference(*_flush_args())
        assert BACKENDS.cuda.matmul.allow_tf32
        BACKENDS.cuda.matmul.allow_tf32 = False
        assert torch.get_float32_matmul_precision() == "highest"
    finally:
        torch.set_float32_matmul_precision("highest")
        BACKENDS.cuda.matmul.fp32_precision = "none"
        BACKENDS.mkldnn.matmul.fp32_precision = "none"


def _walk(sol):
    return sol.status, sol.niter, sol.basis, sol.objective


@pytest.mark.parametrize("driver", ["blocked", "kernel", "refreshed"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_solve_lp_walk_ignores_caller_setting(driver, dtype, caller):
    """The walk under the caller's lower setting is the walk at "highest"
    (what the engines ran before the repair under torch's default); at f64
    the answer is tpulp's."""
    sf = get_case("equality_heavy_24").lp().lower()
    kw = dict(device="cpu", driver=driver, dtype=getattr(torch, dtype),
              block=8)
    out = tpulp_torch.solve_lp(to_port(sf), **kw)
    assert settings() == caller
    torch.set_float32_matmul_precision("highest")
    ref = tpulp_torch.solve_lp(to_port(sf), **kw)
    assert _walk(out) == _walk(ref)
    if dtype == "float64":
        tp = tpulp_solve.solve_lp(sf)
        assert (out.status, out.objective) == (tp.status, tp.objective)
