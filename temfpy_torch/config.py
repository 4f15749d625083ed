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
UNITARY_TOL = 1e-6
SCHMIDT_TOL = 1e-6
NUMERICAL_TOL = 1e-14


def default_device() -> torch.device:
    """The device of an entry point called with ``device=None`` on host
    (numpy) input: ``cuda``.  Raises :class:`RuntimeError` where torch sees
    no card; the CPU runs only when the caller passes ``device="cpu"``."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "temfpy_torch runs on an NVIDIA GPU by default, and torch sees none "
            "(torch.cuda.is_available() is False); pass device=\"cpu\" to run on the CPU"
        )
    return torch.device("cuda")


def resolve_device(x, device) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else the
    device of a tensor argument ``x``, else :func:`default_device`."""
    if device is not None:
        return torch.device(device)
    if isinstance(x, torch.Tensor):
        return x.device
    return default_device()
