"""Numerical configuration of temfpy_torch.

Counterpart of :mod:`temfpy_tpu.config`.  The working dtypes are
float64/complex128 (the algorithms certify fidelities of 1e-10 and better),
and the tolerance defaults match the reference library.

Not ported (TPU workarounds): ``compute_context``, ``cpu_device``,
``prefer_cpu_now`` and ``_cpu_reroute`` (the small-problem reroute to
XLA:CPU), ``complex_on_device`` (the switch of the split planes: the H100
holds complex128 natively), the persistent compilation cache and
``set_dtype``.
"""

from __future__ import annotations

import os

import numpy as np
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

CHI_SHARD_MIN = int(os.environ.get("TEMFPY_TORCH_CHI_SHARD_MIN", "2048"))
"""Under an active mesh, a Slater fill whose bucketed bond reaches this
splits its buffer's bond rows over the mesh's "cuts" axis, and its site
tensors stay bond-sharded (``temfpy_tpu.config.CHI_SHARD_MIN``, read from
``TEMFPY_TORCH_CHI_SHARD_MIN``): tensors of chi >= 2048 must not be held
whole by every device; smaller ones stay whole, where splitting costs more
than it saves."""


def as_complex(x) -> torch.Tensor:
    """``x`` as a tensor of the working complex dtype."""
    return torch.as_tensor(x).to(complex_dtype)


def as_real(x) -> torch.Tensor:
    """``x`` as a tensor of the working real dtype."""
    return torch.as_tensor(x).to(real_dtype)


def np_real_dtype() -> np.dtype:
    return np.dtype(np.float64)


def np_complex_dtype() -> np.dtype:
    return np.dtype(np.complex128)


def default_device() -> torch.device:
    """The device of an entry point called with ``device=None`` on host
    (numpy) input: the first device of the active mesh
    (:class:`temfpy_torch.parallel.mesh.use_mesh`), else ``cuda``.  Raises
    :class:`RuntimeError` where torch sees no card; the CPU runs only when
    the caller passes ``device="cpu"`` or a mesh of CPU shards is active."""
    from .parallel.mesh import active_mesh

    mesh = active_mesh()
    if mesh is not None:
        return mesh.first
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
