r"""Gutzwiller projection: Abrikosov-fermion MPS -> spin-1/2 MPS, on PyTorch.

Counterpart of :mod:`temfpy_tpu.gutzwiller` (reference
``temfpy/gutzwiller.py``): pairs of fermionic sites (2i, 2i+1) are
projected onto a spin-1/2 Hilbert space, either in the plain Abrikosov
convention (single occupation: f_up -> up, f_down -> down; reference
gutzwiller.py:95-281) or the particle-hole rotated one (empty -> down,
doubly occupied -> up; reference gutzwiller.py:284-486).

Each pair of dense site tensors is contracted into a two-site tensor on the
tensors' own device, the physical indices are selected, the virtual bonds
are masked by their charge labels, and the result is brought back into
canonical form by the charge-aware sweeps of
:class:`temfpy_torch.mps.MPS` (finite or infinite).  One pair is the working
set: the chain is never gathered, and under an active mesh
(:mod:`temfpy_torch.parallel.mesh`) each projected pair is stored
bond-sharded.

Not ported (a TPU workaround of the JAX package): the numpy/device switch
of ``_project``.
"""

from __future__ import annotations

import logging
from typing import Literal
from warnings import warn

import numpy as np
import torch

from .mps import MPS, FermionSite, SpinHalfSite
from .parallel import mesh as _pmesh

logger = logging.getLogger(__name__)


def parity_mask(leg: np.ndarray, parity: int = 0) -> np.ndarray:
    """Boolean mask of the bond indices whose charge has the given parity
    (reference gutzwiller.py:22-48; ``leg`` is the bond's charge labels)."""
    return np.asarray(leg) % 2 == parity % 2


def number_mask(leg: np.ndarray, n: int) -> np.ndarray:
    """Boolean mask of the bond indices with charge exactly ``n``
    (reference gutzwiller.py:51-70)."""
    return np.asarray(leg) == n


def _validate(mps: MPS, unit_cell_width: int | None, group: int = 2) -> int:
    if mps.L % 2:
        raise ValueError("Odd-length MPS cannot represent an Abrikosov fermion Hilbert space")
    for i, site in enumerate(mps.sites):
        if not isinstance(site, FermionSite):
            raise ValueError(f"All sites must be fermionic, found: {site} at site {i}")
    if unit_cell_width is None:
        unit_cell_width = mps.unit_cell_width
        if (mps.L // group) % unit_cell_width != 0:
            warn(f"Input MPS {unit_cell_width = } does not divide new MPS size "
                 f"{mps.L // group}\nDefault to chain geometry")
            unit_cell_width = mps.L // group
    elif (mps.L // group) % unit_cell_width != 0:
        raise ValueError(f"{unit_cell_width = } does not divide new MPS size {mps.L // group}")
    return unit_cell_width


def _exact_cell_tensor(mps: MPS):
    """Site i of the tensors whose plain contraction is the state (the
    exact tensors of a finite MPS, the B-form tensors of an infinite one),
    as a function of i that reads one site."""
    if mps.finite:
        c = mps._junction()
        return lambda i: mps._exact_tensor(i, c)
    return lambda i: mps.get_B(i, "B")


def _total_physical_charge(mps: MPS) -> int:
    """Total (finite) or per-cell (infinite) physical charge of the state."""
    return int(mps.q_bond[-1][0]) - int(mps.q_bond[0][0]) + int(mps.qtotal.sum())


def _project(mps: MPS, keep, bond_mask, spin_site: SpinHalfSite, new_q_bond) -> MPS:
    """The projected spin MPS (no canonical form yet).  ``keep`` gives the
    pair occupations (n_up, n_down) of spin up (index 0) and down (1);
    ``bond_mask(q, i)`` the kept indices of new bond i from the fermionic
    labels q; ``new_q_bond(q, i, mask)`` their new labels."""
    site = _exact_cell_tensor(mps)
    L2 = mps.L // 2
    # an infinite MPS's wrap bond reuses bond 0's mask (reference
    # gutzwiller.py:237)
    last = L2 if mps.finite else 0
    masks = ([bond_mask(mps.q_bond[2 * i], i) for i in range(L2)]
             + [bond_mask(mps.q_bond[2 * L2], last)])
    tensors, q_bonds, qts = [], [], []
    for i in range(L2):
        if not masks[i].any() or not masks[i + 1].any():
            raise ValueError(
                f"Gutzwiller projection kills the state: empty bond sector at pair {i} (check "
                "q_left/parity/offset and the input charges)")
        # one pair is the working set, read and held in locals; under a
        # mesh the projected pair keeps its bond axis sharded
        # (temfpy_tpu/gutzwiller.py:107-125)
        A, B = site(2 * i), site(2 * i + 1)
        dev = A.device
        T = torch.einsum("anb,bmc->anmc", A, B)
        P = torch.stack([T[:, n, m, :] for (n, m) in keep], dim=1)
        rows = torch.as_tensor(np.nonzero(masks[i])[0], device=dev)
        cols = torch.as_tensor(np.nonzero(masks[i + 1])[0], device=dev)
        tensors.append(_pmesh.bond_shard_put(P[rows][:, :, cols]))
        q_bonds.append(new_q_bond(mps.q_bond[2 * i], i, masks[i]))
        # the pair keeps the pair's tensor charge: the relabeling shifts
        # cancel between the two bond ends (qL' - qR' moves by +1, the
        # physical 2Sz = N_pair - 1 by -1), e.g. the per-cell charge offset
        # an iMPS carries on its last tensor
        qts.append(int(mps.qtotal[2 * i] + mps.qtotal[2 * i + 1]))
    q_bonds.append(new_q_bond(mps.q_bond[2 * L2], L2, masks[L2]))
    if not any(np.any(q != 0) for q in q_bonds):
        qts = [0] * L2  # charges dropped: no rule to satisfy
    svs = [None] * (L2 + 1)
    svs[0] = np.ones(int(masks[0].sum()))
    svs[-1] = np.ones(int(masks[-1].sum()))
    return MPS([spin_site] * L2, tensors, svs, form=[None] * L2, bc=mps.bc,
               q_bonds=q_bonds, qtotals=qts)


def abrikosov(mps: MPS, *, inplace: bool = False, return_canonical: bool = True,
              cutoff: float = 1e-12, q_left: None | int = None,
              unit_cell_width: int | None = None) -> None | MPS:
    r"""Projection from Abrikosov fermions to spin-1/2: sites (2i, 2i+1) are
    (f_up, f_down); single occupation of f_up -> up, of f_down -> down;
    empty and double occupation are dropped (reference
    gutzwiller.py:95-281).  No spin quantum number survives (the input
    conserves only N or parity), so the output carries no charge.  An
    infinite MPS needs ``q_left``, a charge sector of its leftmost bond."""
    unit_cell_width = _validate(mps, unit_cell_width)
    conserve = mps.sites[0].conserve
    q_total = _total_physical_charge(mps)
    target = mps.L // 2
    if mps.finite:
        if conserve == "N":
            if q_total != target:
                raise ValueError(f"Total charge must match number of spin sites. Got {q_total}, "
                                 f"expected {target}")
        elif conserve == "parity":
            if q_total % 2 != target % 2:
                raise ValueError(f"Total parity must match number of spin sites mod 2. Got "
                                 f"{q_total}, expected {target} (mod 2)")
        else:
            raise ValueError(f"FermionSite must conserve 'N' or 'parity', found {conserve!r}")
        if q_left not in (None, 0):
            warn(f"`q_left` must be 0 for finite MPS, got {q_left = }, setting it to 0.")
        q_left = 0
    else:
        if q_left is None:
            raise ValueError("Must specify `q_left` for infinite MPS.")
        if q_left not in set(mps.q_bond[0].tolist()):
            raise ValueError(f"`q_left` must be a charge sector of the leftmost virtual leg, "
                             f"got {q_left = }, valid sectors are {np.unique(mps.q_bond[0])}")

    if conserve == "N":
        bond_mask = lambda q, i: number_mask(q, q_left + i)  # noqa: E731
    else:
        bond_mask = lambda q, i: parity_mask(q, q_left + i)  # noqa: E731
    out = _project(mps, [(1, 0), (0, 1)], bond_mask, SpinHalfSite(None),
                   new_q_bond=lambda q, i, m: np.zeros(int(m.sum()), np.int64))
    out.unit_cell_width = unit_cell_width
    logger.info("Completed projection to spin-1/2 space. No conserved charges left.")
    out = _finish(out, mps, inplace, return_canonical, cutoff)
    if not inplace:
        return out


def abrikosov_ph(mps: MPS, *, inplace: bool = False, return_canonical: bool = True,
                 cutoff: float = 1e-12, offset: int = 0, parity: Literal[0, 1] = 0,
                 unit_cell_width: int | None = None) -> None | MPS:
    r"""Projection from particle-hole rotated Abrikosov fermions to spin-1/2:
    sites (2i, 2i+1) are (f_up, f_down^dagger); empty pair -> down, doubly
    occupied -> up; single occupation is dropped (reference
    gutzwiller.py:284-486).  An N-conserving input gives an Sz-conserving
    output with bond labels 2 Sz_left = N_left - offset - bond index; a
    parity-conserving input gives an uncharged spin MPS."""
    unit_cell_width = _validate(mps, unit_cell_width)
    conserve = mps.sites[0].conserve
    if conserve == "N":
        conserved_spin = "Sz"
    elif conserve == "parity":
        conserved_spin = None
    else:
        raise ValueError(f"FermionSite must conserve 'N' or 'parity', found {conserve!r}")
    q_total = _total_physical_charge(mps)
    if q_total % 2:
        raise ValueError(f"Total fermion parity of MPS must be even, got {q_total}")
    if mps.finite:
        if parity != 0:
            warn(f"Must use even parity sector in finite MPS, ignoring {parity = }")
        if offset != 0 and conserve == "N":
            warn(f"Cannot offset charge of finite MPS, ignoring {offset = }")
        offset = parity = 0

    if conserved_spin == "Sz":
        new_q = lambda q, i, m: (q[m] - offset - i).astype(np.int64)  # noqa: E731
    else:
        new_q = lambda q, i, m: np.zeros(int(m.sum()), np.int64)  # noqa: E731
    out = _project(mps, [(1, 1), (0, 0)], lambda q, i: parity_mask(q, parity),
                   SpinHalfSite(conserved_spin), new_q_bond=new_q)
    out.unit_cell_width = unit_cell_width
    logger.info("Completed projection to spin-1/2 space. Conserved charge is now %s",
                conserved_spin)
    out = _finish(out, mps, inplace, return_canonical, cutoff)
    if not inplace:
        return out


def _finish(out: MPS, mps: MPS, inplace: bool, return_canonical: bool, cutoff: float) -> MPS:
    if return_canonical:
        if out.finite:
            out.canonical_form_finite(cutoff=cutoff)
        else:
            out.canonical_form_infinite(cutoff=cutoff)
        logger.info("Transformed MPS to right canonical form")
    else:
        warn("The MPS is not in canonical form after Gutzwiller projection.\n"
             "Consider setting 'return_canonical=True'")
    if inplace:
        mps.__dict__.update(out.__dict__)
        return mps
    return out
