"""Moving MPS data between packages and devices.

:func:`mps_from_arrays` builds a :class:`~temfpy_torch.mps.mps.MPS` from
plain arrays, e.g. the fields of a ``temfpy_tpu`` MPS (finite or infinite)
taken through ``np.asarray``; :meth:`MPS.to_numpy` gives them back.  The
``.npz`` checkpoint functions ``save_mps`` / ``load_mps`` of
:mod:`temfpy_tpu.mps.io` are not ported yet (ROADMAP queue 1 item 5).
"""

from __future__ import annotations

import torch

from ..config import default_device
from .mps import MPS
from .site import FermionSite


def mps_from_arrays(tensors, lams, q_bonds, qtotals, form, bc="finite",
                    unit_cell_width=None, device=None, sites=None) -> MPS:
    """A port MPS on ``device`` from per-site tensors (numpy or torch),
    Schmidt values, bond charges, tensor charges and forms.  ``device``
    defaults to the tensors' own device for torch input and to ``cuda``
    (:func:`~temfpy_torch.config.default_device`) for numpy input.
    ``sites`` defaults to number-conserving fermion sites (the Slater path);
    a Pfaffian state takes ``[FermionSite(conserve="parity")] * L``, a
    Gutzwiller output ``[SpinHalfSite(...)] * L`` (``GroupedSite`` lists
    carry over as they are).  ``bc="infinite"`` takes the L or L+1 Schmidt
    vectors of a unit cell."""
    if device is None and tensors and not isinstance(tensors[0], torch.Tensor):
        device = default_device()
    if sites is None:
        sites = [FermionSite(conserve="N")] * len(tensors)
    return MPS(sites, tensors, lams, form=form, bc=bc, unit_cell_width=unit_cell_width,
               q_bonds=q_bonds, qtotals=qtotals, device=device)
