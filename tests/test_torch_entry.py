"""tpulp_torch's entry module against ``__graft_entry__.py``: ``entry()``'s
simplex step equals tpulp's bit for bit at float64 and within 1e-6 at
float32 (the order of a sum may differ), and ``dryrun_multichip`` passes
over gloo processes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from tpulp_torch import entry as port_entry

torch.set_num_threads(1)


def _steps(dtype):
    """(tpulp's stepped state, the port's) from each package's entry();
    tpulp's step jitted, as its entry is meant to run (XLA contracts the
    pivot's multiply-add, as the port's ``fused_fma`` does)."""
    fn, (state,) = graft.entry()
    fn = jax.jit(fn)
    if dtype == "float64":
        state = graft._tiny_state(dtype=jnp.float64)
    pfn, (pstate,) = port_entry.entry(dtype=getattr(torch, dtype),
                                      device="cpu")
    assert np.array_equal(np.asarray(state.T), pstate.T.numpy())
    return fn(state), pfn(pstate)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_entry_step_equals_tpulps(dtype):
    tp, port = _steps(dtype)
    for name in ("basis", "col_active", "art_cols", "phase", "status",
                 "niter", "stuck", "bland"):
        assert np.array_equal(np.asarray(getattr(tp, name)),
                              getattr(port, name).numpy()), name
    assert int(port.niter) == 1
    T_tp, T_port = np.asarray(tp.T), port.T.numpy()
    assert T_port.dtype == T_tp.dtype
    if dtype == "float64":
        assert np.array_equal(T_port, T_tp)
        assert float(port.last_z) == float(tp.last_z)
    else:
        np.testing.assert_allclose(T_port, T_tp, rtol=0, atol=1e-6)


def test_entry_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        port_entry.entry()


def test_dryrun_multichip_two_gloo_processes(capfd):
    port_entry.dryrun_multichip(2, device="cpu")
    out = capfd.readouterr().out
    assert "dryrun_multichip(2) on cpu" in out
    assert "bit for bit" in out and "17-element psum" in out
