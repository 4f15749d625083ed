"""Numerical configuration of temfpy_torch.

Counterpart of :mod:`temfpy_tpu.config`.  The working dtypes are
float64/complex128 (the algorithms certify fidelities of 1e-10 and better),
and the tolerance defaults match the reference library.

Not ported (TPU workarounds): ``compute_context`` and ``_cpu_reroute`` (the
small-problem reroute to XLA:CPU), ``complex_on_device`` (the H100 holds
complex128 natively), the persistent compilation cache and ``set_dtype``.
"""

from __future__ import annotations

import torch

real_dtype = torch.float64
complex_dtype = torch.complex128

# Default tolerances, matching the reference defaults
# (schmidt_utils.py:14-15, testing.py:15 in the reference).
DEFAULT_SVD_MIN = 1e-6
DEFAULT_DEG_TOL = 1e-12
DIAG_TOL = 1e-8


def default_device() -> torch.device:
    """``cuda`` when a card is present, else ``cpu``."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")
