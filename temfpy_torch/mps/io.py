"""Moving MPS data between packages, devices and files.

:func:`mps_from_arrays` builds a :class:`~temfpy_torch.mps.mps.MPS` from
plain arrays, e.g. the fields of a ``temfpy_tpu`` MPS (finite or infinite)
taken through ``np.asarray``; :meth:`MPS.to_numpy` gives them back.
:func:`save_mps` / :func:`load_mps` write and read one ``.npz`` checkpoint
in the layout of :mod:`temfpy_tpu.mps.io` (a ``__meta__`` JSON record, the
arrays ``B{i}``, ``S{i}``, ``q{i}`` and ``qtotal``, the sites as tags such
as ``"fermion:N"``), so each package loads the other's files.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..config import default_device
from .charges import ChargeInfo
from .mps import MPS
from .site import FermionSite, GroupedSite, Site, SpinHalfSite


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


def _site_tag(site: Site) -> str:
    """The JAX package's tag of a site; a :class:`GroupedSite` (or any other
    kind) has none, and raises."""
    if isinstance(site, FermionSite):
        return f"fermion:{site.conserve}"
    if isinstance(site, SpinHalfSite):
        return f"spinhalf:{site.conserve or 'none'}"
    kind = "grouped sites (MPS.group_sites)" if isinstance(site, GroupedSite) else repr(site)
    raise TypeError(f"cannot save {kind}: the checkpoint layout names only fermion and "
                    "spin-1/2 sites")


def _site_from_tag(tag: str) -> Site:
    kind, conserve = tag.split(":")
    if kind == "fermion":
        return FermionSite(conserve=conserve)
    if kind == "spinhalf":
        return SpinHalfSite(None if conserve == "none" else conserve)
    raise ValueError(f"unknown site tag {tag!r}")


def save_mps(path, mps: MPS) -> None:
    """Saves ``mps`` to ``path`` (.npz) in the JAX package's layout; a
    bond-sharded tensor is saved gathered."""
    meta = {
        "bc": mps.bc,
        "unit_cell_width": mps.unit_cell_width,
        "form": [f if f is not None else "" for f in mps.form],
        "sites": [_site_tag(s) for s in mps.sites],
        "norm": mps.norm,
        "chinfo_mod": mps.chinfo.mod,
        "chinfo_name": mps.chinfo.name,
    }
    arrays = {"__meta__": np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)}
    for i in range(mps.L):
        arrays[f"B{i}"] = mps._tensor(i).detach().cpu().numpy()
    for i, S in enumerate(mps._S):
        arrays[f"S{i}"] = np.asarray(S) if S is not None else np.zeros(0)
    for i, q in enumerate(mps.q_bond):
        arrays[f"q{i}"] = np.asarray(q)
    arrays["qtotal"] = np.asarray(mps.qtotal)
    np.savez_compressed(path, **arrays)


def load_mps(path, device=None) -> MPS:
    """Loads an MPS saved by :func:`save_mps` or by
    ``temfpy_tpu.mps.io.save_mps`` onto ``device`` (default: ``cuda``, as
    :func:`mps_from_arrays`)."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        L = len(meta["sites"])
        Bs = [data[f"B{i}"] for i in range(L)]
        SVs = [(data[f"S{i}"] if data[f"S{i}"].size else None) for i in range(L + 1)]
        q_bonds = [data[f"q{i}"] for i in range(L + 1)]
        qtotal = data["qtotal"]
    mps = MPS([_site_from_tag(t) for t in meta["sites"]], Bs, SVs,
              form=[f if f else None for f in meta["form"]], bc=meta["bc"],
              unit_cell_width=meta["unit_cell_width"], q_bonds=q_bonds, qtotals=qtotal,
              norm=meta["norm"], device=default_device() if device is None else device)
    mps.chinfo = ChargeInfo(mod=meta["chinfo_mod"], name=meta["chinfo_name"])
    return mps
