"""Moving MPS data between packages and devices.

:func:`mps_from_arrays` builds a :class:`~temfpy_torch.mps.mps.MPS` from
plain arrays, e.g. the fields of a ``temfpy_tpu`` MPS taken through
``np.asarray``; :meth:`MPS.to_numpy` gives them back.  The ``.npz``
checkpoint functions of :mod:`temfpy_tpu.mps.io` are not ported yet.
"""

from __future__ import annotations

from .mps import MPS
from .site import FermionSite


def mps_from_arrays(tensors, lams, q_bonds, qtotals, form, bc="finite",
                    unit_cell_width=None, device=None, sites=None) -> MPS:
    """A port MPS on ``device`` from per-site tensors (numpy or torch),
    Schmidt values, bond charges, tensor charges and forms.  ``sites``
    defaults to number-conserving fermion sites (the Slater path)."""
    if sites is None:
        sites = [FermionSite(conserve="N")] * len(tensors)
    return MPS(sites, tensors, lams, form=form, bc=bc, unit_cell_width=unit_cell_width,
               q_bonds=q_bonds, qtotals=qtotals, device=device)
