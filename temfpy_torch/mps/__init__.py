"""Charge-labelled dense MPS engine (counterpart of :mod:`temfpy_tpu.mps`).

Tensors are dense torch tensors of shape (chiL, d, chiR) on one device;
each bond carries host integer charge labels (``q_bond``), and charge
conservation is a property of the data (entries violating it are zero).
"""

from .charges import ChargeInfo  # noqa: F401
from .site import FermionSite, SpinHalfSite, Site  # noqa: F401
from .mps import MPS  # noqa: F401
from .charged_linalg import charged_eigh, charged_svd, charged_qr  # noqa: F401
from .io import mps_from_arrays  # noqa: F401
