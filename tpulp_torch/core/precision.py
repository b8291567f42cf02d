"""Full-precision float32 products for the engines.

tpulp pins every eta product and the rank-K flush to
``lax.Precision.HIGHEST``. PyTorch instead reads process-global settings,
under which a caller's ``allow_tf32 = True`` or matmul precision "high" or
"medium" turns float32 products into TF32 or bf16 ones, and lower-precision
flushes break simplex walks. ``full_precision`` pins "highest" for the code
it wraps and then gives the caller back exactly the settings it had,
exceptions included.

Torch keeps three settings for float32 matrix products: the legacy
precision (``set_float32_matmul_precision``, ``allow_tf32``) and one
string per backend (``torch.backends.cuda.matmul.fp32_precision`` and
``torch.backends.mkldnn.matmul.fp32_precision``). The legacy setter writes
all three; the backend strings write only themselves; and torch refuses to
read the legacy getters once the three disagree. So the pin goes through
the legacy setter, which leaves them agreeing, and the restore writes the
legacy value first and then both strings: restoring through
``set_float32_matmul_precision`` alone would change a string the caller
never set (after ``allow_tf32 = True``, "high" also moves mkldnn to tf32),
and the caller's next ``allow_tf32 = False`` would leave
``torch.get_float32_matmul_precision()`` raising.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["full_precision"]


def _legacy_precision() -> str:
    try:
        return torch.get_float32_matmul_precision()
    except RuntimeError:
        # the caller set the backend strings so that they disagree with the
        # legacy value, which torch then refuses to report; a caller of the
        # backend strings alone left the legacy value at its default
        return "highest"


@contextlib.contextmanager
def full_precision():
    """Context manager (and, called, a decorator) that runs float32
    matrix products at "highest" precision and restores the caller's
    settings afterwards."""
    backends = torch.backends
    saved = (_legacy_precision(), backends.cuda.matmul.fp32_precision,
             backends.mkldnn.matmul.fp32_precision)
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        legacy, cuda, mkldnn = saved
        torch.set_float32_matmul_precision(legacy)
        backends.cuda.matmul.fp32_precision = cuda
        backends.mkldnn.matmul.fp32_precision = mkldnn
