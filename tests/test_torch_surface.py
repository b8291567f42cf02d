"""The port's public surface holds tpulp's: every name in the ``__all__``
of tpulp's top level and of each of its subpackages is in the
counterpart's ``__all__`` and resolves there. The port may export more
names, never fewer, so a user switching the import finds every name."""

import importlib
import pkgutil

import pytest

import tpulp

PACKAGES = ["tpulp"] + sorted(
    f"tpulp.{m.name}" for m in pkgutil.iter_modules(tpulp.__path__)
    if m.ispkg)


@pytest.mark.parametrize("package", PACKAGES)
def test_port_exports_every_name_tpulp_does(package):
    ref = importlib.import_module(package)
    port = importlib.import_module(package.replace("tpulp", "tpulp_torch",
                                                   1))
    wanted = set(getattr(ref, "__all__", ()))
    assert wanted, f"{package} names no public surface"
    assert wanted <= set(port.__all__), sorted(wanted - set(port.__all__))
    assert all(hasattr(port, name) for name in wanted)


def test_the_names_this_slice_added():
    import tpulp_torch
    import tpulp_torch.io as io
    import tpulp_torch.shard as shard

    for name in ("MIN", "MAX", "Tableau", "Simplex", "SolveStatus",
                 "read_mps", "write_mps"):
        assert name in tpulp_torch.__all__
    for name in ("render_grid", "render_text", "render_latex", "render_csv",
                 "read_mps", "read_mps_string", "write_mps",
                 "write_mps_string"):
        assert name in io.__all__
    assert "run_simplex_gspmd" in shard.__all__
    assert tpulp_torch.MAX == tpulp.MAX and tpulp_torch.MIN == tpulp.MIN
