r"""Slater determinants -> matrix product states, on PyTorch.

Counterpart of :mod:`temfpy_tpu.slater` (the SchmidtModes ->
SchmidtVectors -> MPSTensorData pipeline, ``correlation_matrix``,
``C_to_MPS``, ``H_to_MPS``), with the same function names.  "reference
slater.py:N" in a docstring cites the original TeMFpy source, as the JAX
package's docstrings do.  The path:

1. ``correlation_matrix``: one ``eigh`` of the single-particle Hamiltonian.
2. Per cut, the eigendecomposition of the leading or trailing block of C,
   as slabs of one batched padded ``eigh``
   (:func:`temfpy_torch.ops.linalg.eigh_blocks`), or, for a real C where
   :func:`temfpy_torch.ops.spectral.use_rsf` says so, the randomized
   frontend (:func:`temfpy_torch.ops.spectral.rsf_sweep_frames`: banded
   subspace iteration on the resident C through the ``rsf_*`` kernels,
   compact frames; the cuts its self-check sends back take
   ``eigh_blocks``), or else, where :func:`temfpy_torch.ops.fw.use_fw`
   says so, the Fishman-White frontend
   (:func:`temfpy_torch.ops.fw.fw_frames`: one host sweep, compact frames
   built on the device by the ``fw_frame_slab`` kernel); then the Schmidt
   modes (:class:`SchmidtModes`) and the enumeration of the chi leading
   Schmidt states on the host (:class:`SchmidtVectors`).  The centre cut
   always takes the exact frontend.
3. Per site, host planning (:func:`_plan_site`,
   :meth:`MPSTensorData._plan_fill`, numpy) and the device entry points,
   each launched once per group of sites (or classes) sharing a shape
   bucket: :func:`temfpy_torch.ops.kernels.site_overlap_schur` (orbital
   overlap + Schur complement of the always-occupied block) and
   :func:`temfpy_torch.ops.kernels.det_fill` (the determinant of every
   charge-matching (bra, ket) pair, scattered into the dense site tensor).
   Where :func:`_use_det_updates` says so (by default on the CPU, not on
   the card), the near-base pairs of large excitation classes take the
   rank-update path instead: per class a base factorization
   (:func:`temfpy_torch.ops.kernels.swap_tables`), a checked-subset probe
   (:func:`temfpy_torch.ops.kernels.swap_fill` in values mode against
   :func:`temfpy_torch.ops.kernels.det_rows`), and the bordered
   determinants of the whole class (``swap_fill`` in scatter mode); a class
   that fails the pre-screen or the probe goes through ``det_fill``.  The
   fills of a site write disjoint entries, so each writes them in place
   into the site's slot of one zeroed buffer per shape bucket, where the
   JAX package sums a partial tensor per plan.
4. The tensors land in :class:`temfpy_torch.mps.MPS`.

Every device array lives on the device of the correlation matrix: the
``device`` argument of the entry points, else the device of a tensor
argument, else ``cuda`` (:func:`temfpy_torch.config.default_device`, which
raises where there is no card: the CPU runs only on ``device="cpu"``).  On
the CPU the two device entry points run their plain PyTorch twins.

Not ported (TPU workarounds of the JAX package): ``_take_frame``,
``_slice_flat``/``_slice_flat_group``, ``_unstack`` and the fused
single-upload plan buffer (a Python slice or ``torch.unbind`` does their
work); the ``_chi_shard_*`` helpers and the mesh branch of
``build_site_tensors``; the compact host frontend
(``_compact_sweep_frames``: exact-frontend frames are full (L, L) eigh
outputs); the stream lookahead thread;
the small-problem CPU reroute; the pair-axis chunking that bounded the
TPU's one-hot temporaries.  Of the rank-update path: ``_swap_collapse`` /
``TEMFPY_TPU_SWAP_COLLAPSE`` and the fixed width-8 swap tables, single
s_b = 8 bucket and site-level table rows it drives (they bounded the TPU's
remote cold compiles; the port plans the tight per-class widths of the
JAX package's CPU layout, which gives the same tensors), the ``GB = 8``
chunk padding and the ``*_group`` vmaps of the grouped swap stages (each
kernel takes a whole group), the 4x pair-batch grid (pair batches pad to
powers of two, as the direct plans do) and the per-class dispatch
``dispatch_fill`` (``_fill_sites`` launches a site's fills, singly or in
groups).

``C_to_iMPS`` / ``H_to_iMPS`` build an iMPS cell from two chains that
differ by one unit cell: the cell's site tensors through
:func:`build_site_tensors`, the gauge overlap of the two chains' left
Schmidt bases through the single-site API
(:meth:`MPSTensorData.from_schmidt_vectors`,
:meth:`MPSTensorData.to_dense_tensor`), whose bra and ket may come from
chains of different length.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
from collections import Counter
from dataclasses import dataclass
from typing import Literal, Type

import numpy as np
import torch

from . import profiling
from .config import DIAG_TOL as _DIAG_TOL
from .config import resolve_device
from .mps import MPS, FermionSite
from .ops.fw import fw_frames, use_fw
from .ops.kernels import det_fill, det_rows, site_overlap_schur, swap_fill, swap_tables
from .ops.linalg import block_svd, eigh_blocks
from .ops.spectral import reset_rsf_stats, rsf_sweep_frames, use_rsf
from .schmidt_utils import lowest_sums, to_stopping_condition
from .testing import assert_allclose, check_schmidt_decomposition
from .utils import HT, n_slice, normalize_SV

logger = logging.getLogger(__name__)

fermion_site = FermionSite(conserve="N")
"""Lattice site prototype for the number-conserving fermion MPS
(reference slater.py:30)."""

fermion_leg = fermion_site.charges
"""Physical-leg charge labels (reference slater.py:32)."""

chinfo = fermion_site.chinfo
"""Charge info of the fermion site (reference slater.py:35)."""


#### SCHMIDT ORBITALS ####
#### ---------------- ####


def _idx(a, device) -> torch.Tensor:
    """Host index array (any strides) as an int64 tensor on ``device``."""
    return torch.as_tensor(np.array(a, np.int64), device=device)


def _classify_spectrum(e: np.ndarray, cutoff: float, order: str, window=None):
    """Splits an ascending eigenvalue array into empty/entangled/filled and
    returns the canonical column permutation plus slice map (semantics of
    reference slater.py:324-375).

    order "L": descending -> filled, entangled (descending), empty.
    order "R": ascending with the entangled run reversed -> empty,
    entangled (descending), filled.  ``window`` overrides the (x0, x1)
    entangled window.
    """
    n = e.size
    if window is None:
        x0, x1 = np.searchsorted(e, [cutoff, 1 - cutoff])
    else:
        x0, x1 = window
    k = x1 - x0
    idx = np.arange(n)
    if order == "L":
        idx = idx[::-1]
        ix = {
            "filled": slice(0, n - x1),
            "entangled": slice(n - x1, n - x0),
            "empty": slice(n - x0, n),
        }
    elif order == "R":
        idx = idx.copy()
        idx[x0:x1] = idx[x0:x1][::-1]
        ix = {
            "empty": slice(0, x0),
            "entangled": slice(x0, x1),
            "filled": slice(x1, n),
        }
    else:
        raise ValueError(f"order must be 'L' or 'R', got {order!r}")
    return idx, ix, k


def _widen_window(e: np.ndarray, cutoff: float, k_target: int):
    """Entangled window (x0, x1) of the ascending spectrum ``e`` widened or
    narrowed to exactly ``k_target`` entries, preferring the eigenvalues
    closest to the cutoff boundaries (reconciles borderline
    classifications between the two sides of a cut)."""
    n = e.size
    x0, x1 = (int(v) for v in np.searchsorted(e, [cutoff, 1 - cutoff]))
    while x1 - x0 < k_target:
        lo_gap = cutoff - e[x0 - 1] if x0 > 0 else np.inf
        hi_gap = e[x1] - (1 - cutoff) if x1 < n else np.inf
        if lo_gap <= hi_gap:
            x0 -= 1
        else:
            x1 += 1
    while x1 - x0 > k_target:
        lo_gap = e[x0] - cutoff
        hi_gap = (1 - cutoff) - e[x1 - 1]
        if lo_gap <= hi_gap:
            x0 += 1
        else:
            x1 -= 1
    return x0, x1


@dataclass
class SchmidtModes:
    """Mean-field orbitals generating the Schmidt vectors of a Slater
    determinant (reference slater.py:41-489).

    The eigenvectors are kept in their frame form, the (L, W) output of the
    frontend (block vectors in the leading (side L) or trailing (side R)
    coordinates), plus a host map from the canonical column order (filled,
    entangled desc, empty for L; empty, entangled desc, filled for R) to
    full ascending eigencolumn indices.  A full frame (W = L, the exact
    frontend) holds every eigencolumn; a compact frame (the randomized and
    the Fishman-White frontends) holds only the occupied ones, and ``col0L``/``col0R`` give the
    full index of its column 0 (0 for full frames).  ``vL``/``vR``
    materialise the reference's canonical (n, n) matrices on demand, with
    the dropped empty columns (never occupied by any Schmidt vector) as
    zero vectors.
    """

    e: np.ndarray
    frameL: torch.Tensor | None
    colL: np.ndarray | None
    frameR: torch.Tensor | None
    colR: np.ndarray | None
    ixL: dict | None
    ixR: dict | None
    nL: int
    nR: int
    n_fermion: int
    L: int
    col0L: int = 0
    col0R: int = 0

    def __post_init__(self):
        assert (self.frameL is None) == (self.ixL is None)
        assert (self.frameR is None) == (self.ixR is None)
        assert (self.frameL is not None) or (self.frameR is not None)

    @staticmethod
    def _materialise(frame, col, col0, rows):
        cols = np.asarray(col, np.int64) - col0
        V = frame[rows][:, _idx(np.maximum(cols, 0), frame.device)]
        if (cols >= 0).all():
            return V
        return V * torch.as_tensor(cols >= 0, device=frame.device).to(V.dtype)[None, :]

    @property
    def vL(self):
        """Canonical (nL, nL) left eigenvector matrix (materialised)."""
        if self.frameL is None:
            return None
        return self._materialise(self.frameL, self.colL, self.col0L, slice(None, self.nL))

    @property
    def vR(self):
        """Canonical (nR, nR) right eigenvector matrix (materialised)."""
        if self.frameR is None:
            return None
        return self._materialise(self.frameR, self.colR, self.col0R,
                                 slice(self.L - self.nR, None))

    @property
    def n_entangled(self) -> int:
        return self.e.size

    def size(self, which: str = "T") -> int:
        w = which[0].upper()
        if w == "L":
            return self.nL
        if w == "R":
            return self.nR
        if w == "T":
            return self.nL + self.nR
        raise ValueError("`which` must start with L, R, or T, got " + repr(which))

    def n_filled(self, which: str) -> int:
        w = which[0].upper()
        if w == "L":
            if self.ixL is not None:
                return n_slice(self.ixL["filled"])
            return self.n_fermion - self.n_entangled - n_slice(self.ixR["filled"])
        if w == "R":
            if self.ixR is not None:
                return n_slice(self.ixR["filled"])
            return self.n_fermion - self.n_entangled - n_slice(self.ixL["filled"])
        raise ValueError("`which` must start with L or R, got " + repr(which))

    @property
    def vL_entangled(self):
        return None if self.frameL is None else self.vL[:, self.ixL["entangled"]]

    @property
    def vR_entangled(self):
        return None if self.frameR is None else self.vR[:, self.ixR["entangled"]]

    def mode_vectors(self, which: str, entangled: bool = False):
        w = which[0].upper()
        if w == "L":
            return self.vL_entangled if entangled else self.vL
        if w == "R":
            return self.vR_entangled if entangled else self.vR
        raise ValueError("`which` must start with L or R, got " + which)

    def eigenvalues(self, which: str, entangled: bool = False):
        w = which[0].upper()
        if w == "L":
            if self.frameL is None:
                return None
            if entangled:
                return self.e
            E = np.zeros(self.nL)
            E[self.ixL["filled"]] = 1
            E[self.ixL["entangled"]] = self.e
            return E
        if w == "R":
            if self.frameR is None:
                return None
            e = 1 - self.e[::-1]
            if entangled:
                return e
            E = np.zeros(self.nR)
            E[self.ixR["filled"]] = 1
            E[self.ixR["entangled"]] = e
            return E
        raise ValueError("`which` must start with L or R, got " + repr(which))

    @property
    def singular_values(self):
        """SVD values of C_LR incl. the (-1)^i anticommutation signs on the
        right singular vectors (reference slater.py:252-268)."""
        if (self.frameL is None) or (self.frameR is None):
            return None
        SV = (self.e * (1 - self.e)) ** 0.5
        sign = (-1.0) ** (np.arange(SV.size)[::-1])
        return SV * sign

    @property
    def e_ratio(self) -> np.ndarray:
        r""":math:`\log((1-\lambda)/\lambda)` per entangled eigenvalue
        (+/- inf for borderline modes at exactly 0 or 1)."""
        with np.errstate(divide="ignore"):
            return np.log((1 - self.e) / self.e)

    def embed_subsets(self, sets: np.ndarray):
        """Extends subsets over entangled orbitals to occupations of all
        orbitals on each side (reference slater.py:430-470)."""
        left_sets = right_sets = None
        if self.frameL is not None:
            left_sets = np.zeros((len(sets), self.nL), dtype=bool)
            left_sets[:, self.ixL["entangled"]] = sets
            left_sets[:, self.ixL["filled"]] = True
        if self.frameR is not None:
            right_sets = np.zeros((len(sets), self.nR), dtype=bool)
            right_sets[:, self.ixR["entangled"]] = np.logical_not(sets[:, ::-1])
            right_sets[:, self.ixR["filled"]] = True
        return left_sets, right_sets

    def schmidt_values(self, sets: np.ndarray) -> np.ndarray:
        return np.where(sets, self.e, 1 - self.e).prod(axis=1) ** 0.5

    @classmethod
    def from_eigh(cls: Type["SchmidtModes"], C: torch.Tensor, x: int, trunc_par, *,
                  eL=None, vL_raw=None, eR=None, vR_raw=None,
                  diag_tol: float = _DIAG_TOL, n_fermion: int | None = None,
                  col0L: int = 0, col0R: int = 0) -> "SchmidtModes":
        """Builds SchmidtModes from block eigendecompositions: host
        eigenvalues ``eL``/``eR`` (ascending, the whole block) and frames
        ``vL_raw``/``vR_raw``: (L, L) as returned by :func:`eigh_blocks`, or
        compact (L, W) frames whose column 0 is eigencolumn ``col0L`` /
        ``col0R`` (:func:`temfpy_torch.ops.fw.fw_frames`).  A two-sided cut
        needs full frames (the LR pairing writes into them)."""
        trunc_par = to_stopping_condition(trunc_par)
        cutoff = trunc_par.svd_min**2
        L = C.shape[0]
        nR = L - x

        frameL = colL = ixL = frameR = colR = ixR = None
        kL = kR = None
        if eL is not None:
            colL, ixL, kL = _classify_spectrum(eL, cutoff, "L")
            frameL = vL_raw
            eL_can = eL[colL[ixL["entangled"]]]
        if eR is not None:
            colR, ixR, kR = _classify_spectrum(eR, cutoff, "R")
            frameR = vR_raw
            eR_can = eR[colR[ixR["entangled"]]]
        if eL is None and eR is None:
            raise ValueError("need at least one of the L/R eigendecompositions")

        if eL is not None and eR is not None:
            if kL != kR:
                # an eigenvalue sits at the cutoff within solver noise on one
                # side only: widen the smaller side's window to the common count
                logger.info("reconciling entangled-mode counts: kL=%d kR=%d", kL, kR)
                k_common = max(kL, kR)
                if kL < k_common:
                    win = _widen_window(eL, cutoff, k_common)
                    colL, ixL, kL = _classify_spectrum(eL, cutoff, "L", window=win)
                    eL_can = eL[colL[ixL["entangled"]]]
                if kR < k_common:
                    win = _widen_window(eR, cutoff, k_common)
                    colR, ixR, kR = _classify_spectrum(eR, cutoff, "R", window=win)
                    eR_can = eR[colR[ixR["entangled"]]]
            assert kL == kR, "number of entangled modes must match"
            if col0L or col0R:
                raise ValueError("a two-sided cut needs full frames (col0L = col0R = 0)")
            k = kL
            deg_tol = trunc_par.degeneracy_tol
            assert_allclose(eL_can + eR_can[::-1], 1.0, rtol=0, atol=deg_tol,
                            err_msg="Eigenvalues of C_LL and C_RR do not match")
            e = eL_can
            # complete the SVD pairing of C_LR inside degenerate blocks and
            # write the rotated columns back into (copies of) the frames
            dev = frameL.device
            fcL = _idx(colL[ixL["entangled"]], dev)
            fcR_rev = _idx(colR[ixR["entangled"]][::-1], dev)
            vLE, vRE_rev = block_svd(C[:x, x:], frameL[:x][:, fcL], frameR[x:][:, fcR_rev],
                                     e, deg_tol)
            frameL = frameL.clone()
            frameR = frameR.clone()
            frameL[:x, fcL] = vLE
            frameR[x:, fcR_rev] = vRE_rev
            # extra anticommutation signs on odd entangled right modes
            sign = np.ones(k)
            sign[1::2] = -1
            fcR = _idx(colR[ixR["entangled"]], dev)
            frameR[x:, fcR] *= torch.as_tensor(sign, device=dev).to(frameR.dtype)[None, :]
        elif eL is not None:
            e, k = eL_can, kL
        else:
            e, k = 1.0 - eR_can[::-1], kR

        logger.info("%d Schmidt modes found", k)
        if n_fermion is None:
            n_fermion = int(np.round(float(torch.trace(C).real)))
        # borderline (widened) modes may sit at/below 0 or at/above 1 within
        # solver noise; clip so Schmidt weights stay valid
        e = np.clip(np.asarray(e, float), 0.0, 1.0)
        modes = cls(e=e, frameL=frameL, colL=colL, frameR=frameR, colR=colR, ixL=ixL,
                    ixR=ixR, nL=x, nR=nR, n_fermion=n_fermion, L=L, col0L=col0L, col0R=col0R)
        if (frameL is not None) and (frameR is not None):
            check_schmidt_decomposition(modes, C, diag_tol)
        return modes

    @classmethod
    def from_correlation_matrix(cls: Type["SchmidtModes"], C: torch.Tensor, x: int, trunc_par,
                                *, which: str = "LR",
                                diag_tol: float = _DIAG_TOL) -> "SchmidtModes":
        """Schmidt modes for a cut between sites x-1 and x
        (reference slater.py:270-423)."""
        which = which.upper()
        if "L" not in which and "R" not in which:
            raise ValueError("`which` must specify at least one of (L)eft or (R)ight")
        L = C.shape[0]
        eL = vL_raw = eR = vR_raw = None
        if "L" in which:
            e_all, v_all = eigh_blocks(C, [x], "L")
            eL = e_all[0, :x].cpu().numpy()
            vL_raw = v_all[0]
        if "R" in which:
            e_all, v_all = eigh_blocks(C, [L - x], "R")
            eR = e_all[0, : L - x].cpu().numpy()
            vR_raw = v_all[0]
        return cls.from_eigh(C, x, trunc_par, eL=eL, vL_raw=vL_raw, eR=eR, vR_raw=vR_raw,
                             diag_tol=diag_tol)


#### SCHMIDT VECTORS ####
#### --------------- ####


@dataclass(frozen=True)
class SchmidtVectors:
    """The chi most significant Schmidt vectors as occupation sets of
    Schmidt-mode orbitals (reference slater.py:494-755)."""

    modes: SchmidtModes
    left_sets: np.ndarray | None
    right_sets: np.ndarray | None
    schmidt_values: np.ndarray
    idx_L: dict  # charge (particles left of cut) -> slice

    @property
    def n_schmidt(self) -> int:
        return len(self.schmidt_values)

    @property
    def n_entangled(self) -> int:
        return self.modes.n_entangled

    @property
    def nL(self) -> int:
        return self.modes.nL

    @property
    def nR(self) -> int:
        return self.modes.nR

    @property
    def n_fermion(self) -> int:
        return self.modes.n_fermion

    def size(self, which: str = "T") -> int:
        return self.modes.size(which)

    @property
    def vL(self):
        return self.modes.vL

    @property
    def vR(self):
        return self.modes.vR

    def mode_vectors(self, which: str, entangled: bool = False):
        return self.modes.mode_vectors(which, entangled)

    def sets(self, which: str):
        w = which[0].upper()
        if w == "L":
            return self.left_sets
        if w == "R":
            return self.right_sets
        raise ValueError("`which` must start with L or R, got " + which)

    @property
    def q_left(self) -> np.ndarray:
        """Per-Schmidt-vector charge label: particle number left of the cut."""
        q = np.empty(self.n_schmidt, dtype=np.int64)
        for n, sl in self.idx_L.items():
            q[sl] = n
        return q

    @classmethod
    def from_schmidt_modes(cls: Type["SchmidtVectors"], modes: SchmidtModes,
                           trunc_par) -> "SchmidtVectors":
        trunc_par = to_stopping_condition(trunc_par)
        _, sets = lowest_sums(
            modes.e_ratio / 2,  # svd_min applies to Schmidt values, not squares
            trunc_par,
            filled_left=modes.n_filled("L"),
            filled_right=modes.n_filled("R"),
        )
        if len(sets) == 0:
            raise ValueError("No Schmidt vectors left after filtering by `trunc_par.sectors`!")
        n_L = modes.n_filled("L") + sets.sum(axis=1)
        order = np.argsort(n_L, kind="stable")
        n_L = n_L[order]
        sets = sets[order]
        uniq, starts = np.unique(n_L, return_index=True)
        bounds = np.concatenate((starts, [len(sets)]))
        idx_L = {int(n): slice(bounds[i], bounds[i + 1]) for i, n in enumerate(uniq)}
        left_sets, right_sets = modes.embed_subsets(sets)
        lam = modes.schmidt_values(sets)
        logger.info("%d Schmidt vectors generated", len(lam))
        return cls(modes=modes, left_sets=left_sets, right_sets=right_sets,
                   schmidt_values=lam, idx_L=idx_L)

    @classmethod
    def from_correlation_matrix(cls: Type["SchmidtVectors"], C: torch.Tensor, x: int,
                                trunc_par, *, which: str = "LR",
                                diag_tol: float = _DIAG_TOL) -> "SchmidtVectors":
        trunc_par = to_stopping_condition(trunc_par)
        modes = SchmidtModes.from_correlation_matrix(C, x, trunc_par, which=which,
                                                     diag_tol=diag_tol)
        return cls.from_schmidt_modes(modes, trunc_par)


#### MPS TENSORS FROM SCHMIDT VECTORS ####
#### -------------------------------- ####


def _select_orbitals(sets: np.ndarray, mode: str):
    """Splits orbital columns into always/sometimes occupied and computes the
    anticommutation signs for moving the "sometimes" orbitals past the
    "always" block (semantics of reference slater.py:760-825).

    Returns (trimmed sets, column gather order, per-column signs, k_always).
    """
    always = np.all(sets, axis=0)
    never = ~np.any(sets, axis=0)
    sometimes = ~(always | never)
    (always,) = np.nonzero(always)
    (sometimes,) = np.nonzero(sometimes)
    k = len(always)
    if mode == "left":
        order = np.concatenate((always, sometimes))
        sign = (-1.0) ** (k - np.searchsorted(always, sometimes))
        sign = np.concatenate((np.ones(k), sign))
    elif mode == "right":
        order = np.concatenate((sometimes, always))
        sign = (-1.0) ** np.searchsorted(always, sometimes)
        sign = np.concatenate((sign, np.ones(k)))
    else:
        raise ValueError('mode needs to be either "left" or "right"')
    return sets[:, order], order, sign, k


def _occupation_indices(sets: np.ndarray, width: int, sentinel_base: int):
    """Boolean occupation rows -> padded position-index rows: row r's True
    positions first (increasing), then sentinels ``sentinel_base + s`` in
    the remaining slots s (the identity extension)."""
    ns, m = sets.shape
    counts = sets.sum(axis=1)
    assert counts.max(initial=0) <= width
    order = np.argsort(~sets, axis=1, kind="stable")[:, :width]
    if order.shape[1] < width:  # fewer orbitals than slots: all-pad columns
        extra = np.zeros((ns, width - order.shape[1]), dtype=order.dtype)
        order = np.concatenate([order, extra], axis=1)
    slot = np.arange(width)[None, :]
    pad = slot >= counts[:, None]
    idx = np.where(pad, sentinel_base + slot, order)
    return idx.astype(np.int32), counts


def _bucket_shape(shape: tuple) -> tuple:
    """Rounds the chi dimensions of a site-tensor shape up to powers of two
    >= 64 (physical dims <= 4 kept), so that sites of similar size share
    one fill group (one kernel launch)."""

    def b(d):
        if d <= 4:
            return d
        n = 64
        while n < d:
            n *= 2
        return n

    return tuple(b(d) for d in shape)


def _pow2(n: int, lo: int) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _unique_small_ints(x, n):
    """``np.unique(x, return_inverse=True)`` for ints in [0, n), in
    O(len(x) + n) through a flag array and a lookup table."""
    present = np.zeros(n, bool)
    present[x] = True
    u = np.flatnonzero(present)
    lut = np.empty(n, np.int64)
    lut[u] = np.arange(len(u))
    return u, lut[x]


_N_CHECK = 32
"""Pairs per swap bucket checked against the direct determinants before
the bucket's class commits to the rank-update path (the probe).  Only
these strided pairs are verified, with the tolerance scaled by the
largest |det| of the checked subset, so a base that is well-conditioned on
them but marginal elsewhere can pass (as in the JAX package); the
pre-screen and the probe bound the risk."""

_SWAP_GMAX = 1e6
"""Conditioning pre-screen of rank-update bases: a class whose base
inverse G = A^-1, or one of whose tables P, T2, T3, has an entry above this
skips the swap fill and goes through the direct path.  max|G| ~
1/sigma_min caps the float64 error amplification of every swap entry at
~1e-16 * _SWAP_GMAX = 1e-10, inside the probe's 1e-8 tolerance (the JAX
package's screen).  The tables' bound is the port's addition: next to a
nearly singular always block the sometimes matrix holds entries to ~1e13
outside the base block, P and T3 reach ~1e14, and the bordered matrix S is
their difference, so a few pairs the probe does not check lose all their
digits (the pi-flux cylinder of tests/test_det_updates.py, with the port's
eigensolver gauge: 2.6e-3 where the determinant is 1e-15)."""


def _use_det_updates(device) -> bool:
    """Whether the fill plans the rank-update (swap) path for a site whose
    tensors live on ``device``.

    ``TEMFPY_TORCH_DET_UPDATES``: "0" off, "1" on (unconditionally, as the
    JAX package's "1"), "auto" (default) on for the CPU, where it replaces
    each near-base pair's O(w^3) LU by an O((2 s_b)^3) one, and off on CUDA,
    as the JAX package is off on accelerators: the swap machinery's per-class
    tables, host planning and probe download buy fewer flops than the card
    spends on them (the JAX package measured 87.9 s against 21.9 s direct
    on the TPU).  Under "auto" the per-conversion stop rule
    :func:`_swap_paying_off` also applies."""
    mode = os.environ.get("TEMFPY_TORCH_DET_UPDATES", "auto")
    if mode == "0":
        return False
    if mode == "1":
        return True
    return torch.device(device).type == "cpu" and _swap_paying_off()


# Running swap-class statistics of the current conversion.  Highly
# symmetric states (the Gutzwiller pi-flux ansatz) have degenerate Schmidt
# spectra whose majority bases are singular, so most classes fall back to
# the direct path and the swap work is overhead; once fallbacks dominate,
# later sites of the same conversion stop planning swap classes.
# Thread-local and reset per conversion.
_swap_tls = threading.local()


def _swap_stats() -> dict:
    if not hasattr(_swap_tls, "stats"):
        _reset_swap_stats()
    return _swap_tls.stats


def _reset_swap_stats():
    # "wasted" counts swap fills of a class found bad afterwards, which the
    # JAX package can dispatch before its cross-check resolves; here the
    # probe decides before any swap fill, so it stays 0 (kept so that the
    # two packages' statistics compare)
    _swap_tls.stats = {"classes": 0, "fallbacks": 0, "wasted": 0}


def _swap_paying_off() -> bool:
    st = _swap_stats()
    c, f = st["classes"], st["fallbacks"]
    return not (c >= 8 and 2 * f > c)


def _bucket_swaps(a):
    """Shape bucket s_b in {1, 2, 4, 8} of swap counts ``a`` (an int or an
    int array), 99 past 8: such a pair is cheaper through the direct
    path."""
    a = np.asarray(a)
    return np.select([a <= 1, a <= 2, a <= 4, a <= 8], [1, 2, 4, 8], 99)


@dataclass(frozen=True)
class MPSTensorData:
    """Implicit description of one MPS tensor (or Schmidt-vector overlap
    matrix) of a Slater determinant (reference slater.py:872-1143).

    The identity ``det[[A, B], [C, D]] = det(A) det(D - C A^-1 B)`` factors
    the overlap of the always-occupied orbitals out once
    (``det_always``); each remaining entry is a small determinant over the
    "sometimes" orbitals of ``sometimes_matrix``.

    :func:`build_site_tensors` evaluates many sites in groups;
    :meth:`from_schmidt_vectors` and :meth:`to_dense_tensor` one site,
    through the same kernels.  The plans are packed: per-unique-bond index
    tables and scatter tables (``_direct_plan_packed``, ``_scatter_tables``)
    take the place of the JAX package's unpacked per-pair arrays
    (``_direct_arrays``, ``_scatter_ix``), and a failed rank-update class is
    recomputed through a packed direct plan and ``det_fill``, the function
    of the JAX package's ``_det_direct_vals_impl`` and
    ``scatter_vals_kernel``.
    """

    mode: str
    physical_leg: bool
    det_always: torch.Tensor  # 0-d device tensor
    sometimes_matrix: torch.Tensor  # (m, m) device tensor
    sets_bra: np.ndarray  # host bool, trimmed to sometimes slots
    sets_ket: np.ndarray
    bra_beta: np.ndarray  # bond index per bra row
    bra_phys: np.ndarray | None  # physical occupation per bra row (if leg)
    q_bra: np.ndarray  # charge labels (N left) per bra bond index
    q_ket: np.ndarray
    qtotal: int

    @classmethod
    def from_schmidt_vectors(cls: Type["MPSTensorData"], Schmidt_bra: SchmidtVectors,
                             Schmidt_ket: SchmidtVectors, mode: str) -> "MPSTensorData":
        """One site's (or one overlap matrix's) data: host planning and one
        ``site_overlap_schur`` launch on the frames' device.  Bra and ket
        may come from chains of different length (the iMPS cell and its
        gauge overlap)."""
        plan = _plan_site(Schmidt_bra, Schmidt_ket, mode)
        det, som = _overlap_group([plan])
        return cls(det_always=det[0], sometimes_matrix=som[0], **plan["fields"])

    def to_dense_tensor(self):
        """The dense (chiL, d, chiR) tensor, or the (bra, ket) matrix without
        a physical leg, with host bond labels: (T, q_l, q_r, qtotal)
        (reference ``to_npc_array``, slater.py:1106-1143)."""
        return _fill_sites([self])[0]

    def _plan_fill(self):
        """Host planning of the tensor fill: returns (shape, q_l, q_r,
        plans).

        - kind "direct": one plan per determinant width bucket (pairs of
          excitation class c only need c x c determinants; widths are
          padded to 4 or to multiples of 8).
        - kind "swap_class": where :func:`_use_det_updates` says so, a
          class with c > 4 and at least 64 pairs takes the rank-update
          path (:meth:`_plan_swap_class`); its pairs too far from the
          class base go back to the direct width buckets.

        Plans scatter into disjoint entries."""
        nb = len(self.q_bra)
        nk = len(self.q_ket)
        if self.mode == "left" or not self.physical_leg:
            q_l, q_r = self.q_bra, self.q_ket
        else:
            q_l, q_r = self.q_ket, self.q_bra
        cnt_bra = self.sets_bra.sum(axis=1)
        cnt_ket = self.sets_ket.sum(axis=1)
        m = self.sets_bra.shape[1]
        if self.physical_leg:
            shape = (nb, 2, nk) if self.mode == "left" else (nk, 2, nb)
        else:
            shape = (nb, nk)
        use_swap = _use_det_updates(self.sometimes_matrix.device)

        direct: dict[int, tuple[list, list]] = {}
        plans = []
        for c in np.unique(cnt_bra):
            rows = np.nonzero(cnt_bra == c)[0]
            cols = np.nonzero(cnt_ket == c)[0]
            if not (rows.size and cols.size):
                continue
            c = int(c)
            w_b = 4 if c <= 4 else -(-c // 8) * 8
            if use_swap and c > 4 and rows.size * cols.size >= 64:
                swap_plan, far = self._plan_swap_class(c, w_b, rows, cols, m, shape)
                if swap_plan is not None:
                    plans.append(swap_plan)
            else:
                far = (np.repeat(rows, cols.size), np.tile(cols, rows.size))
            if far is not None:
                r_l, c_l = direct.setdefault(w_b, ([], []))
                r_l.append(far[0])
                c_l.append(far[1])
        plans += [
            self._direct_plan_packed(np.concatenate(direct[w_b][0]),
                                     np.concatenate(direct[w_b][1]), w_b, m, shape)
            for w_b in sorted(direct)
        ]
        return shape, q_l, q_r, plans

    def _scatter_tables(self, rows, cols, n_r, n_k, shape):
        """Scatter value tables over the plan-local bra ids (``rows``, padded
        to ``n_r``) and ket ids (``cols``, padded to ``n_k``) with their
        ``spec``: the bond and physical index of each id; pad ids route to
        the trash slot at the bucketed leading dimension."""
        sb0 = _bucket_shape(shape)[0]
        beta = np.zeros(n_r, np.int32)
        beta[: len(rows)] = self.bra_beta[rows]
        col = np.zeros(n_k, np.int32)
        col[: len(cols)] = cols
        if not self.physical_leg:
            beta[len(rows):] = sb0
            return "rc", (beta, col, np.zeros(1, np.int32))
        phys = np.zeros(n_r, np.int32)
        phys[: len(rows)] = self.bra_phys[rows]
        if self.mode == "left":
            beta[len(rows):] = sb0
            return "rrc", (beta, phys, col)
        col[len(cols):] = sb0
        return "crr", (col, phys, beta)

    def _plan_swap_class(self, c, w_b, rows, cols, m, shape):
        """Rank-update plan of one excitation class
        (``temfpy_tpu/slater.py:MPSTensorData._plan_swap_class``, its CPU
        layout: tight per-class widths).  Returns (plan or None, far pairs
        (rows, cols) or None).

        The base is the class's common majority: the c positions most often
        occupied over the bra and the ket rows together (bra and ket modes
        of consecutive cuts are aligned, so the base overlap is near
        diagonal).  Each side's rows become swap arrays of width W =
        min(8, c): the base positions the row lost, in ascending order,
        then self-swaps at kept base positions, with the permutation sign of
        the in-place replacement.  A pair's bucket is s_b = bucket(max(a_row,
        b_col)) in {1, 2, 4, 8} up to W; farther pairs go direct.  Each
        bucket is a sub-plan with (P_b,) pair ids into per-side tables that
        end in a self-swap pad row, scatter tables, and ``_N_CHECK`` strided
        checked pairs with their direct index rows (the probe)."""
        sets_b = self.sets_bra[rows]
        sets_k = self.sets_ket[cols]
        freq = (sets_b.sum(axis=0) / max(len(sets_b), 1)
                + sets_k.sum(axis=0) / max(len(sets_k), 1))
        base = np.sort(np.argsort(freq)[::-1][:c])
        base_mask = np.zeros(m, bool)
        base_mask[base] = True
        W = min(8, c)

        def side_arrays(sets):
            n = len(sets)
            out_mask = ~sets[:, base]  # (n, c): base positions the row lost
            in_mask = sets & ~base_mask  # (n, m): positions gained
            a_real = in_mask.sum(axis=1)
            locs = np.argsort(~out_mask, axis=1, kind="stable")[:, :W]
            rpos = locs.astype(np.int32)
            rout = base[locs].astype(np.int32)
            ins = np.argsort(~in_mask, axis=1, kind="stable")[:, :W]
            slot = np.arange(W)[None, :]
            rin = np.where(slot < a_real[:, None], ins, rout).astype(np.int32)
            arr = np.broadcast_to(base, (n, c)).copy()
            np.put_along_axis(arr, locs, rin, axis=1)
            inv = np.sum((arr[:, :, None] > arr[:, None, :])
                         & (np.arange(c)[:, None] < np.arange(c)[None, :]), axis=(1, 2))
            sign = np.where(inv % 2 == 1, -1.0, 1.0)
            return a_real <= W, a_real, rin, rout, rpos, sign

        ok_r, a_r, rin_r, rout_r, rpos_r, sign_r = side_arrays(sets_b)
        ok_c, a_c, rin_c, rout_c, rpos_c, sign_c = side_arrays(sets_k)
        ab_r = np.where(ok_r, _bucket_swaps(a_r), 99)
        ab_c = np.where(ok_c, _bucket_swaps(a_c), 99)
        sq = np.maximum(ab_r[:, None], ab_c[None, :])  # (R, C)
        sq = np.where(sq > W, 99, sq)
        far = None
        if (sq >= 99).any():
            fr, fc = np.nonzero(sq >= 99)
            far = (rows[fr], cols[fc])

        def side_tables(rin_s, rout_s, rpos_s, sign_s):
            n = len(rin_s)
            n_b = _pow2(n + 1, 32)
            Rin = np.broadcast_to(base[:W].astype(np.int32), (n_b, W)).copy()
            Rout = Rin.copy()
            Rpos = np.broadcast_to(np.arange(W, dtype=np.int32), (n_b, W)).copy()
            sg = np.ones(n_b)
            Rin[:n], Rout[:n], Rpos[:n], sg[:n] = rin_s, rout_s, rpos_s, sign_s
            return Rin, Rout, Rpos, sg, n_b

        Rin_t, Rout_t, Rpos_t, sgr_t, R_b = side_tables(rin_r, rout_r, rpos_r, sign_r)
        Cin_t, Cout_t, Cpos_t, sgc_t, K_b = side_tables(rin_c, rout_c, rpos_c, sign_c)
        spec, tabs = self._scatter_tables(rows, cols, R_b, K_b, shape)

        # pair-axis cap of the JAX package's plan (same sub-plans, same
        # checked subsets)
        per_pair = W * (w_b * 4 + 128 * 8)
        P_cap = 1024
        while P_cap * 4 <= int(1.5e8 / max(per_pair, 1)) and P_cap < 262144:
            P_cap *= 4
        sub_plans = []
        for s_b in np.unique(sq[sq < 99]):
            ri_all, ci_all = np.nonzero(sq == s_b)
            for p0 in range(0, len(ri_all), P_cap):
                ri = ri_all[p0 : p0 + P_cap]
                ci = ci_all[p0 : p0 + P_cap]
                P = len(ri)
                P_b = _pow2(P, 256)
                pr = np.full(P_b, R_b - 1, np.int32)
                pr[:P] = ri
                pc = np.full(P_b, K_b - 1, np.int32)
                pc[:P] = ci
                chk = np.linspace(0, P - 1, _N_CHECK).astype(np.int32)
                g_rows, g_cols = rows[ri], cols[ci]
                sub_plans.append({
                    "s_b": int(s_b), "pr": pr, "pc": pc,
                    "Rin": Rin_t, "Rout": Rout_t, "Rpos": Rpos_t, "sgr": sgr_t,
                    "Cin": Cin_t, "Cout": Cout_t, "Cpos": Cpos_t, "sgc": sgc_t,
                    "tabs": tabs, "spec": spec, "rows": g_rows, "cols": g_cols,
                    "check_sel": chk,
                    "check_idx_b": _occupation_indices(self.sets_bra[g_rows[chk]], w_b, m)[0],
                    "check_idx_k": _occupation_indices(self.sets_ket[g_cols[chk]], w_b, m)[0],
                })
        if not sub_plans:
            return None, far
        r0 = np.concatenate([base, m + np.arange(w_b - c)]).astype(np.int32)
        return {"kind": "swap_class", "w_b": w_b, "r0": r0, "c0": r0.copy(),
                "sub": sub_plans, "m": m}, far

    def _direct_plan_packed(self, rows, cols, w_b, m, shape):
        """One direct fill plan: per-unique-bond occupation tables
        (``occ_b``/``occ_k``, sentinel-padded, the last row all-sentinel),
        (P_b,) pair ids ``pr``/``pc`` (pad pairs point at the sentinel
        rows) and per-axis scatter tables ``tabs`` (pad rows route to the
        trash slot at the bucketed leading dimension), as consumed by
        :func:`temfpy_torch.ops.kernels.det_fill`."""
        P = len(rows)
        P_b = _pow2(P, 256)
        ub, inv_r = _unique_small_ints(rows, len(self.sets_bra))
        uk, inv_c = _unique_small_ints(cols, len(self.sets_ket))
        occ_b_u, _ = _occupation_indices(self.sets_bra[ub], w_b, m)
        occ_k_u, _ = _occupation_indices(self.sets_ket[uk], w_b, m)
        pad_row = m + np.arange(w_b, dtype=np.int32)
        R_b = _pow2(len(ub) + 1, 32)
        K_b = _pow2(len(uk) + 1, 32)
        occ_b = np.broadcast_to(pad_row, (R_b, w_b)).copy()
        occ_b[: len(ub)] = occ_b_u
        occ_k = np.broadcast_to(pad_row, (K_b, w_b)).copy()
        occ_k[: len(uk)] = occ_k_u
        pr = np.full(P_b, R_b - 1, np.int32)
        pr[:P] = inv_r
        pc = np.full(P_b, K_b - 1, np.int32)
        pc[:P] = inv_c

        spec, tabs = self._scatter_tables(ub, uk, R_b, K_b, shape)
        return {"kind": "direct", "occ_b": occ_b, "occ_k": occ_k, "pr": pr, "pc": pc,
                "tabs": tabs, "spec": spec}

    def resolve_fill(self, shape, buf, slot, classes=()):
        """The site tensor from slot ``slot`` of the bucketed buffer ``buf``
        (:func:`temfpy_torch.ops.kernels.fill_buffer`), into which the
        direct fill and the rank-update classes that passed have written
        their disjoint entries, and this site's class entries ``classes``.

        A class entry is ``forced`` where the pre-screen or the probe turned
        it away, before any swap fill (the probe held the checked subset at
        the 1e-8 tolerance); its pairs are then recomputed through a packed
        direct plan and ``det_fill``, into the same slot.  The conversion's
        swap statistics count classes and fallbacks.  Returns the tensor
        sliced to the true shape."""
        st = _swap_stats()
        for ce in classes:
            st["classes"] += 1
            if not ce["forced"]:
                continue
            st["fallbacks"] += 1
            plan = ce["plan"]
            fr = np.concatenate([sub["rows"] for sub in plan["sub"]])
            fc = np.concatenate([sub["cols"] for sub in plan["sub"]])
            dplan = self._direct_plan_packed(fr, fc, plan["w_b"], plan["m"], shape)
            _fill_group([self.sometimes_matrix], [self.det_always], [dplan],
                        _bucket_shape(shape), buf, [slot])
        return buf[slot][tuple(slice(0, d) for d in shape)]


def _plan_site(Schmidt_bra: SchmidtVectors, Schmidt_ket: SchmidtVectors, mode: str):
    """Host planning of one site's overlap/Schur step.

    Returns a dict with the bra/ket frames, the column descriptors
    ``desc`` = (colb, kindb, rowb, signb, colk, kindk, rowk, signk) of width
    mb = kb + sb (kind 0 = frame column, 1 = one-hot(row), 2 = zero; int32
    and float64 numpy), the bucketed always-block width ``kb`` and the
    :class:`MPSTensorData` fields.  Column layout of the overlap matrix:
    left mode [always(k), padA(one-hots) | rest..., padS(zeros)], right mode
    [rest..., padS(zeros) | always(k), padA(one-hots)], with rest = (extra
    always beyond the common k) + sometimes.
    """
    mode = mode.lower()
    if mode not in ("left", "right"):
        raise ValueError("mode must be either 'left' or 'right', got " + repr(mode))
    side = "L" if mode == "left" else "R"
    modes_bra = Schmidt_bra.modes
    modes_ket = Schmidt_ket.modes
    frame_bra = modes_bra.frameL if side == "L" else modes_bra.frameR
    col_bra = modes_bra.colL if side == "L" else modes_bra.colR
    col0_bra = modes_bra.col0L if side == "L" else modes_bra.col0R
    frame_ket = modes_ket.frameL if side == "L" else modes_ket.frameR
    col_ket = modes_ket.colL if side == "L" else modes_ket.colR
    col0_ket = modes_ket.col0L if side == "L" else modes_ket.col0R
    if frame_bra is None or frame_ket is None:
        raise ValueError(f"Schmidt vectors contain no {mode} Schmidt vectors")
    sets_bra = Schmidt_bra.sets(mode)
    sets_ket = Schmidt_ket.sets(mode)
    L, Lk = modes_bra.L, modes_ket.L
    if Lk != L:
        # two chains of different length (the iMPS cell and gauge overlaps):
        # every orbital of a cut lives in its side's rows, so both frames
        # keep the common span of rows next to the cut; the row bookkeeping
        # below (physical row, pad pools) is relative to that span
        Lc = min(L, Lk)
        if side == "L":
            frame_bra, frame_ket = frame_bra[:Lc], frame_ket[:Lc]
        else:
            frame_bra, frame_ket = frame_bra[L - Lc :], frame_ket[Lk - Lc :]
        L = Lc

    ns_bra, n_bra = sets_bra.shape
    n_ket = sets_ket.shape[1]
    bra_beta = np.arange(ns_bra)
    bra_phys = None
    phys_pos = None  # canonical position of the physical orbital (bra)
    if n_bra == n_ket:
        physical = False
    elif n_bra + 1 == n_ket:
        physical = True
        if mode == "left":
            # physical orbital appended as the LAST bra orbital; its frame
            # row is the site itself (an unused frame coordinate)
            phys_pos = n_bra
            phys_row = Schmidt_bra.nL
            sets_bra = np.block([[sets_bra, np.zeros((ns_bra, 1), bool)],
                                 [sets_bra, np.ones((ns_bra, 1), bool)]])
        else:
            # physical orbital prepended as the FIRST bra orbital
            phys_pos = 0
            phys_row = L - 1 - Schmidt_bra.nR
            sets_bra = np.block([[np.zeros((ns_bra, 1), bool), sets_bra],
                                 [np.ones((ns_bra, 1), bool), sets_bra]])
        bra_beta = np.concatenate([np.arange(ns_bra), np.arange(ns_bra)])
        bra_phys = np.concatenate([np.zeros(ns_bra, int), np.ones(ns_bra, int)])
    else:
        raise ValueError(
            f"{mode.capitalize()} sides `Schmidt_bra` and `Schmidt_ket` must match or "
            f"`Schmidt_bra` must be one bond to the {mode} of `Schmidt_ket`, got lengths "
            f"{n_bra} and {n_ket}.")

    sets_bra, order_b, sign_b, k_bra = _select_orbitals(sets_bra, mode)
    sets_ket, order_k, sign_k, k_ket = _select_orbitals(sets_ket, mode)
    k = min(k_bra, k_ket)  # square "always" block

    # bucketed layout (few distinct (mb, kb) per conversion -> few groups)
    qk = 1 if L < 32 else min(32, max(8, L // 8))
    qs = 1 if L < 32 else 8
    kb = -(-k // qk) * qk if k else 0
    sb = max(1, -(-max(len(order_b) - k, len(order_k) - k) // qs) * qs)

    # shared one-hot rows for the identity padding of the always block:
    # frame coordinates unused by both frames' blocks
    n_padA = kb - k
    if mode == "left":
        pool = np.arange(L - 1, -1, -1)  # take from the far (right) end
        lo = max(Schmidt_bra.nL, Schmidt_ket.nL) + (1 if physical else 0)
        pool = pool[pool >= lo]
    else:
        pool = np.arange(L)
        hi = min(L - Schmidt_bra.nR, L - Schmidt_ket.nR) - (1 if physical else 0)
        pool = pool[pool < hi]
    if physical:
        pool = pool[pool != phys_row]
    assert len(pool) >= n_padA, "not enough free frame rows for padding"
    padA_rows = pool[:n_padA]

    def descriptors(order, sign, col_map, col0, is_bra):
        mb = kb + sb
        col = np.zeros(mb, np.int32)
        kind = np.full(mb, 2, np.int32)
        row = np.zeros(mb, np.int32)
        sgn = np.ones(mb, np.float64)
        if mode == "left":
            always, rest = order[:k], order[k:]
            sign_always, sign_rest = sign[:k], sign[k:]
            apos = np.arange(k)
            ppos = np.arange(k, kb)
            rpos = np.arange(kb, kb + len(rest))
        else:
            # the LAST k always orbitals form the square block
            # (reference slater.py:1084)
            always = order[len(order) - k :] if k else order[:0]
            rest = order[: len(order) - k]
            sign_always = sign[len(sign) - k :] if k else sign[:0]
            sign_rest = sign[: len(sign) - k]
            rpos = np.arange(len(rest))
            apos = np.arange(sb, sb + k)
            ppos = np.arange(sb + k, sb + kb)

        def to_frame_col(c):
            """Canonical sets-column index -> (kind, frame col, row).
            ``col0`` shifts full eigencolumn indices into a compact frame;
            referenced columns are occupied, hence never below it."""
            if physical and is_bra:
                if c == phys_pos:
                    return 1, 0, phys_row
                if mode == "right":
                    c = c - 1  # phys occupies sets column 0
            fc = int(col_map[c]) - col0
            if fc < 0:
                raise RuntimeError("a Schmidt vector occupies an empty (dropped) frame column")
            return 0, fc, 0

        for p, c, s in zip(apos, always, sign_always):
            kind[p], col[p], row[p] = to_frame_col(int(c))
            sgn[p] = s
        for p, c, s in zip(rpos, rest, sign_rest):
            kind[p], col[p], row[p] = to_frame_col(int(c))
            sgn[p] = s
        kind[ppos] = 1
        row[ppos] = padA_rows
        return col, kind, row, sgn

    desc = (*descriptors(order_b, sign_b, col_bra, col0_bra, True),
            *descriptors(order_k, sign_k, col_ket, col0_ket, False))

    def region_sets(sets):
        """Sets over the sometimes region: [rest..., padS(False)]."""
        rest = sets[:, k:] if mode == "left" else sets[:, : sets.shape[1] - k]
        pad = np.zeros((len(rest), sb - rest.shape[1]), bool)
        return np.concatenate([rest, pad], axis=1)

    qtotal = 0 if mode == "left" else Schmidt_ket.n_fermion - Schmidt_bra.n_fermion
    return {
        "frame_bra": frame_bra,
        "frame_ket": frame_ket,
        "desc": desc,
        "kb": int(kb),
        "fields": dict(
            mode=mode,
            physical_leg=physical,
            sets_bra=region_sets(sets_bra),
            sets_ket=region_sets(sets_ket),
            bra_beta=bra_beta,
            bra_phys=bra_phys,
            q_bra=Schmidt_bra.q_left,
            q_ket=Schmidt_ket.q_left,
            qtotal=int(qtotal),
        ),
    }


def _overlap_group(plans):
    """One ``site_overlap_schur`` launch for sites sharing (frame shapes,
    mb, kb, mode); returns (det (G,), sometimes (G, sb, sb))."""
    dev = plans[0]["frame_bra"].device
    fb = torch.stack([p["frame_bra"] for p in plans])
    fk = torch.stack([p["frame_ket"] for p in plans])
    desc = [torch.as_tensor(np.stack([p["desc"][d] for p in plans]), device=dev)
            for d in range(8)]
    return site_overlap_schur(fb, fk, *desc, kb=plans[0]["kb"],
                              mode=plans[0]["fields"]["mode"])


def _fill_group(Ms, dets, plans, shape_b, buf, slots):
    """One ``det_fill`` launch for fill plans sharing (bucketed shape, P_b,
    table shapes, spec, sometimes shape), each writing into its site's slot
    ``slots[g]`` of the bucketed buffer ``buf`` in place."""
    dev = Ms[0].device

    def up(key):
        return torch.as_tensor(np.stack([p[key] for p in plans]), device=dev)

    tabs = tuple(torch.as_tensor(np.stack([p["tabs"][t] for p in plans]), device=dev)
                 for t in range(3))
    det_fill(torch.stack(Ms), torch.stack(dets), up("occ_b"), up("occ_k"), up("pr"), up("pc"),
             tabs, spec=plans[0]["spec"], shape=shape_b, out=buf, slot=slots)


def build_site_tensors(pairs):
    """Evaluates the MPS tensors of many sites with grouped device work.

    ``pairs`` is a list of (Schmidt_bra, Schmidt_ket, mode).  Sites sharing
    a shape bucket are stacked: the overlap/Schur step and each width
    bucket of the fill launch one kernel per group, not one per site.
    Returns [(T, q_l, q_r, qtotal)] aligned with ``pairs``.
    """
    n = len(pairs)
    if not n:
        return []
    with profiling.stage("fill/plan"):
        plans = [_plan_site(b, k, m) for (b, k, m) in pairs]

    # ---- stage 1: grouped overlap/Schur (kernel K2) ----
    overlap_groups: dict = {}
    for i, p in enumerate(plans):
        key = (tuple(p["frame_bra"].shape), tuple(p["frame_ket"].shape),
               len(p["desc"][0]), p["kb"], p["fields"]["mode"])
        overlap_groups.setdefault(key, []).append(i)
    det_of = [None] * n
    som_of = [None] * n
    with profiling.stage("fill/overlap_groups"):
        for idxs in overlap_groups.values():
            det_s, som_s = _overlap_group([plans[i] for i in idxs])
            for g, i in enumerate(idxs):
                det_of[i], som_of[i] = det_s[g], som_s[g]

    return _fill_sites([MPSTensorData(det_always=det_of[i], sometimes_matrix=som_of[i],
                                      **plans[i]["fields"]) for i in range(n)])


def _fill_sites(datas):
    """The fill of many sites' data, grouped by shape bucket: the direct
    fill (kernel K1), then the rank-update classes (K6a, K6b, K5).  Returns
    [(T, q_l, q_r, qtotal)] aligned with ``datas``."""
    # ---- stage 2: grouped fill (kernel K1) ----
    with profiling.stage("fill/plan_fill"):
        fill_plans = [d._plan_fill() for d in datas]
    # one zeroed buffer per bucketed shape holds its sites' tensors, a slot
    # each; every fill writes its site's (disjoint) entries there in place
    slot_of, n_of = [], Counter()
    for shape, *_ in fill_plans:
        slot_of.append(n_of[_bucket_shape(shape)])
        n_of[_bucket_shape(shape)] += 1
    som = datas[0].sometimes_matrix
    bufs = {sb: torch.zeros((k, sb[0] + 1) + sb[1:], dtype=som.dtype, device=som.device)
            for sb, k in n_of.items()}
    fill_groups: dict = {}
    for i, (shape, _ql, _qr, fplans) in enumerate(fill_plans):
        for plan in fplans:
            if plan["kind"] != "direct":
                continue
            key = (_bucket_shape(shape), plan["pr"].shape[0], plan["occ_b"].shape,
                   plan["occ_k"].shape, plan["spec"], tuple(datas[i].sometimes_matrix.shape))
            fill_groups.setdefault(key, []).append((i, plan))
    with profiling.stage("fill/det_groups"):
        for key, entries in fill_groups.items():
            _fill_group([datas[i].sometimes_matrix for i, _ in entries],
                        [datas[i].det_always for i, _ in entries], [p for _, p in entries],
                        key[0], bufs[key[0]], [slot_of[i] for i, _ in entries])

    # ---- stage 3: rank-update classes (kernels K6a, K6b, K5) ----
    site_classes = _swap_stages(datas, fill_plans, bufs, slot_of)
    with profiling.stage("fill/resolve"):
        out = []
        for i, (shape, q_l, q_r, _plans) in enumerate(fill_plans):
            out.append((datas[i].resolve_fill(shape, bufs[_bucket_shape(shape)], slot_of[i],
                                              site_classes.get(i, ())),
                        q_l, q_r, datas[i].qtotal))
    return out


def _probe_ok(pairs) -> bool:
    """The probe's verdict on one class from its sub-plans' checked values,
    a list of (swap values, direct values) host arrays: every swap value
    within 1e-8 x the class's largest checked |det| + 1e-8 |det| of its
    direct value (``temfpy_tpu/slater.py``'s cross-check tolerance)."""
    scale = max([1e-300] + [float(np.abs(dr).max()) for _sw, dr in pairs])
    return all(np.all(np.abs(sw - dr) <= 1e-8 * scale + 1e-8 * np.abs(dr)) for sw, dr in pairs)


def _swap_units(datas, units, dev):
    """The stacked arguments of ``swap_fill`` for a group of (class entry,
    sub-plan) units, up to the pair ids: the sites' sometimes matrices and
    det_always, the classes' tables and the per-side swap tables."""
    def host(name):
        return torch.as_tensor(np.stack([sub[name] for _, sub in units]), device=dev)

    return (torch.stack([datas[e["i"]].sometimes_matrix for e, _ in units]),
            torch.stack([datas[e["i"]].det_always for e, _ in units]),
            *(torch.stack([e["tables"][k] for e, _ in units]) for k in range(5)),
            *(host(n) for n in ("Rin", "Rout", "Rpos", "sgr", "Cin", "Cout", "Cpos", "sgc")))


def _swap_stages(datas, fill_plans, bufs, slot_of):
    """The grouped rank-update stages of :func:`build_site_tensors`
    (``temfpy_tpu/slater.py:build_site_tensors``, its swap half).

    - ``fill/swap_tables``: one ``swap_tables`` launch per (sometimes shape,
      w_b) group of (site, class) entries; then the pre-screen (|D0| < 1e-12,
      or max|G| or the largest table entry > ``_SWAP_GMAX``), with one
      download for all entries.
    - ``fill/swap_probe``: for every sub-plan of a surviving class, the swap
      values (``swap_fill``, values mode) and the direct determinants
      (``det_rows``) of its ``_N_CHECK`` checked pairs, one launch of each
      per shape group and one download; a class whose subset parts by more
      than 1e-8 x its largest checked |det| + 1e-8 |det| is forced direct.
    - ``fill/swap_dets``: the full swap fill (``swap_fill``, scatter mode)
      of the classes that passed, one launch per shape group, into site
      i's slot ``slot_of[i]`` of the buffer ``bufs`` holds for its bucketed
      shape.

    Returns {site: [class entry]}, each entry with its ``plan`` and
    ``forced`` flag, for :meth:`MPSTensorData.resolve_fill`."""
    entries = [{"i": i, "plan": plan, "forced": False}
               for i, fp in enumerate(fill_plans) for plan in fp[3] if plan["kind"] == "swap_class"]
    if not entries:
        return {}
    dev = datas[0].sometimes_matrix.device

    def up(a):
        return torch.as_tensor(a, device=dev)

    with profiling.stage("fill/swap_tables"):
        groups: dict = {}
        for e in entries:
            key = (tuple(datas[e["i"]].sometimes_matrix.shape), e["plan"]["w_b"])
            groups.setdefault(key, []).append(e)
        order, screen = [], []
        for es in groups.values():
            D0, G, P, T2, T3, gmax, tmax = swap_tables(
                torch.stack([datas[e["i"]].sometimes_matrix for e in es]),
                up(np.stack([e["plan"]["r0"] for e in es])),
                up(np.stack([e["plan"]["c0"] for e in es])))
            for t, e in enumerate(es):
                e["tables"] = (D0[t], G[t], P[t], T2[t], T3[t])
            order += es
            screen.append(torch.stack([D0.abs().to(torch.float64), torch.maximum(gmax, tmax)]))
        d0_gm = torch.cat(screen, dim=1).cpu().numpy()
        for e, d0, gm in zip(order, d0_gm[0], d0_gm[1]):
            e["forced"] = bool(d0 < 1e-12 or gm > _SWAP_GMAX)

    with profiling.stage("fill/swap_probe"):
        units = [(e, sub) for e in entries if not e["forced"] for sub in e["plan"]["sub"]]
        pgroups: dict = {}
        for e, sub in units:
            key = (tuple(datas[e["i"]].sometimes_matrix.shape), e["plan"]["w_b"],
                   sub["Rin"].shape, sub["Cin"].shape, sub["check_sel"].shape, sub["s_b"])
            pgroups.setdefault(key, []).append((e, sub))
        probed, vals = [], []
        for key, us in pgroups.items():
            args = _swap_units(datas, us, dev)
            sw = swap_fill(*args, up(np.stack([sub["pr"][sub["check_sel"]] for _, sub in us])),
                           up(np.stack([sub["pc"][sub["check_sel"]] for _, sub in us])),
                           s_b=key[5])
            dr = det_rows(args[0], up(np.stack([sub["check_idx_b"] for _, sub in us])),
                          up(np.stack([sub["check_idx_k"] for _, sub in us])), args[1])
            probed += us
            vals.append(torch.stack([sw, dr]))
        if vals:
            sw_dr = torch.cat(vals, dim=1).cpu().numpy()
            checks: dict = {}
            for t, (e, _sub) in enumerate(probed):
                checks.setdefault(id(e), (e, []))[1].append((sw_dr[0, t], sw_dr[1, t]))
            for e, pl in checks.values():
                if not _probe_ok(pl):
                    e["forced"] = True
                    logger.info("rank-update probe failed (class w=%d): near-singular "
                                "intermediate swap; direct path", e["plan"]["w_b"])

    with profiling.stage("fill/swap_dets"):
        sgroups: dict = {}
        for e, sub in units:
            if e["forced"]:
                continue
            shape_b = _bucket_shape(fill_plans[e["i"]][0])
            key = (tuple(datas[e["i"]].sometimes_matrix.shape), e["plan"]["w_b"],
                   sub["Rin"].shape, sub["Cin"].shape, sub["pr"].shape, sub["s_b"], sub["spec"],
                   shape_b)
            sgroups.setdefault(key, []).append((e, sub))
        for key, us in sgroups.items():
            swap_fill(*_swap_units(datas, us, dev), up(np.stack([sub["pr"] for _, sub in us])),
                      up(np.stack([sub["pc"] for _, sub in us])),
                      tuple(up(np.stack([sub["tabs"][k] for _, sub in us])) for k in range(3)),
                      s_b=key[5], spec=key[6], shape=key[7], out=bufs[key[7]],
                      slot=[slot_of[e["i"]] for e, _ in us])

    site_classes: dict = {}
    for e in entries:
        site_classes.setdefault(e["i"], []).append(e)
    return site_classes


#### ENTRY POINTS ####
#### ------------ ####


def _to_device(x, device) -> torch.Tensor:
    dev = resolve_device(x, device)
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return torch.as_tensor(np.asarray(x), device=dev)


def correlation_matrix(H, N: int | None = None, *, device=None):
    r"""Ground-state correlation matrix C_ij = <c_j^dagger c_i> of a
    mean-field Hamiltonian (reference slater.py:1150-1180): one ``eigh``
    on ``device`` (default: H's device for a tensor, else ``cuda``,
    :func:`~temfpy_torch.config.default_device`).  Returns (C, N); a
    complex C whose imaginary part is below 1e-14 becomes real."""
    H = _to_device(H, device)
    e, v = torch.linalg.eigh(H)
    if N is None:
        N = int((e < 0).sum().item())
    v = v[:, :N]
    C = v @ HT(v)
    if C.is_complex() and float(C.imag.abs().max()) < 1e-14:
        C = C.real.contiguous()
    return C, N


def spinful_correlation_matrix(C, ph: bool = True):
    r"""Doubles a correlation matrix for spin-1/2 fermions: even/odd sites
    are up/down orbitals; ``ph`` particle-hole transforms the down sector
    (reference slater.py:1183-1213).  numpy in, numpy out; tensor in,
    tensor out."""
    if not isinstance(C, torch.Tensor):
        return spinful_correlation_matrix(torch.as_tensor(np.asarray(C)), ph).numpy()
    n, m = C.shape
    if n != m:
        raise ValueError(f"Got non-square {tuple(C.shape)} correlation matrix")
    C2 = torch.zeros((2 * n, 2 * n), dtype=C.dtype, device=C.device)
    C2[::2, ::2] = C
    C2[1::2, 1::2] = torch.eye(n, dtype=C.dtype, device=C.device) - C if ph else C
    return C2


def _exact_frames(C, sizes, which, chunk, e_list, col0_list, frame_list, todo):
    """Full frames of the exact device frontend (one batched eigh) for the
    cuts ``todo``, written into the three lists."""
    e_all, v_all = eigh_blocks(C, [sizes[j] for j in todo], which, chunk=chunk)
    e_host = e_all.cpu().numpy()
    for t, j in enumerate(todo):
        e_list[j], col0_list[j], frame_list[j] = e_host[t, : sizes[j]], 0, v_all[t]


def _schmidt_vectors_batched(C: torch.Tensor, cuts, which: str, trunc_par,
                             diag_tol: float, chunk: int, n_fermion: int, C_host=None):
    """Schmidt vectors for many cuts; ``which`` is "L" or "R".  For a real C
    where :func:`temfpy_torch.ops.spectral.use_rsf` says so, the randomized
    frontend builds the frames on C's device
    (:func:`temfpy_torch.ops.spectral.rsf_sweep_frames`), and the cuts it
    sends back take the exact frontend (its self-check, counted in
    ``spectral.rsf_stats``).  Else, with a host copy ``C_host`` of C, the
    Fishman-White frontend does (:func:`temfpy_torch.ops.fw.fw_frames`);
    without one, or where its sweep fails (gapless C), one batched eigh on
    C's device.  Returns the SchmidtVectors per cut, in order."""
    trunc_par = to_stopping_condition(trunc_par)
    L = C.shape[0]
    sizes = [x if which == "L" else L - x for x in cuts]
    n = len(cuts)
    rsf = use_rsf(C)
    res = None
    if C_host is not None and not rsf:
        with profiling.stage("eigh_batch"):
            res = fw_frames(C_host, sizes, which, trunc_par.svd_min**2, C.device)
    if res is not None:
        e_list, col0_list, frame_list = res
    else:
        with profiling.stage("eigh_batch"):
            if rsf:
                e_list, col0_list, frame_list, todo = rsf_sweep_frames(C, sizes, which,
                                                                       trunc_par.svd_min**2)
            else:
                e_list, col0_list, frame_list, todo = [None] * n, [0] * n, [None] * n, range(n)
            if len(todo):
                with profiling.stage("rsf/reroute") if rsf else contextlib.nullcontext():
                    _exact_frames(C, sizes, which, chunk, e_list, col0_list, frame_list, todo)
    out = []
    for i, x in enumerate(cuts):
        kw = ({"eL": e_list[i], "vL_raw": frame_list[i], "col0L": col0_list[i]}
              if which == "L" else
              {"eR": e_list[i], "vR_raw": frame_list[i], "col0R": col0_list[i]})
        with profiling.stage("schmidt_modes"):
            modes = SchmidtModes.from_eigh(C, x, trunc_par, diag_tol=diag_tol,
                                           n_fermion=n_fermion, **kw)
        with profiling.stage("schmidt_enumeration"):
            out.append(SchmidtVectors.from_schmidt_modes(modes, trunc_par))
    return out


def C_to_MPS(C, trunc_par, *, diag_tol: float = _DIAG_TOL, ortho_center: int | None = None,
             spinful: Literal["simple", "PH", None] = None,
             unit_cell_width: int | None = None, eigh_chunk: int = 64, device=None) -> MPS:
    r"""MPS representation of a Slater determinant from its correlation
    matrix (reference slater.py:1216-1353).

    ``C`` (numpy or tensor) moves to ``device`` (default: C's device for a
    tensor, else ``cuda``; ``device="cpu"`` runs the kernels' twins).  The center cut is
    decomposed first; then each half is streamed in blocks of
    ``eigh_chunk`` cuts: the block's frames (one batched eigh, or the
    randomized frontend where :func:`temfpy_torch.ops.spectral.use_rsf` says
    so, else the Fishman-White frontend where
    :func:`temfpy_torch.ops.fw.use_fw` does), the Schmidt enumeration on the
    host, and the grouped site kernels.
    The result is in mixed canonical form 'A' * c + 'B' * (L - c) with
    c = ``ortho_center`` (default L // 2).
    """
    trunc_par = to_stopping_condition(trunc_par)
    if spinful == "simple":
        C = spinful_correlation_matrix(C, False)
    elif spinful == "PH":
        C = spinful_correlation_matrix(C, True)
    elif spinful is not None:
        raise ValueError(f"`spinful` must be 'simple', 'PH', or `None`, got {spinful!r}")
    C = _to_device(C, device)
    L = C.shape[0]
    if C.shape != (L, L):
        raise ValueError(f"Got non-square {tuple(C.shape)} correlation matrix")
    if unit_cell_width is None:
        unit_cell_width = L
    elif L % unit_cell_width != 0:
        raise ValueError(f"{unit_cell_width = } does not divide system size {L}")
    n_fermion = int(np.round(float(torch.trace(C).real)))
    _reset_swap_stats()
    reset_rsf_stats()
    # one host copy of C serves the FW sweep of every block of both
    # half-streams (the sweep is cached by the matrix's values); the
    # randomized frontend, where on, comes first and needs none
    C_host = C.cpu().numpy() if use_fw(C, L) and not use_rsf(C) else None

    tensors = [None] * L
    lams = [None] * (L + 1)
    q_bonds = [None] * (L + 1)
    c = ortho_center or L // 2
    Schmidt_center = SchmidtVectors.from_correlation_matrix(C, c, trunc_par, diag_tol=diag_tol)
    lams[c] = normalize_SV(Schmidt_center.schmidt_values, logger)
    q_bonds[c] = Schmidt_center.q_left

    def stream_half(cuts, which, sites, bond_of_site):
        Schmidt = Schmidt_center
        sites = list(sites)
        pos = 0
        for j0 in range(0, len(cuts), eigh_chunk):
            block = cuts[j0 : j0 + eigh_chunk]
            sv_block = _schmidt_vectors_batched(C, block, which, trunc_par, diag_tol,
                                                eigh_chunk, n_fermion, C_host)
            pairs, block_sites = [], []
            for Schmidt_new in sv_block:
                i = sites[pos]
                pos += 1
                b = bond_of_site(i)
                lams[b] = normalize_SV(Schmidt_new.schmidt_values, logger)
                q_bonds[b] = Schmidt_new.q_left
                pairs.append((Schmidt_new, Schmidt, "right" if which == "R" else "left"))
                block_sites.append(i)
                Schmidt = Schmidt_new
            with profiling.stage("tensor_fill"):
                results = build_site_tensors(pairs)
            for i, (T, _ql, _qr, qt) in zip(block_sites, results):
                tensors[i] = (T, qt)

    # right half: cuts c+1 .. L, right Schmidt vectors
    stream_half(list(range(c + 1, L + 1)), "R", range(c, L), lambda i: i + 1)
    # left half: cuts c-1 .. 0, left Schmidt vectors
    stream_half(list(range(c - 1, -1, -1)), "L", range(c - 1, -1, -1), lambda i: i)

    return MPS([fermion_site] * L, [t for t, _ in tensors], lams,
               form=["A"] * c + ["B"] * (L - c), bc="finite",
               unit_cell_width=unit_cell_width, q_bonds=q_bonds,
               qtotals=[qt for _, qt in tensors])


def C_to_iMPS(C_short, C_long, trunc_par, sites_per_cell: int, cut: int, *,
              diag_tol: float = _DIAG_TOL, unitary_tol: float | None = None,
              schmidt_tol: float | None = None,
              spinful: Literal["simple", "PH", None] = None, offset="auto",
              unit_cell_width: int | None = None, device=None):
    r"""iMPS of a Slater determinant from two correlation matrices that
    differ by one repeating unit cell (reference slater.py:1356-1565), on
    ``device`` (default: C_short's device for a tensor, else ``cuda``).

    No environment is contracted: the cell tensors are the long chain's
    right-canonical tensors from cut to cut + sites_per_cell, the last one
    closing onto the short chain's right Schmidt vectors (so the right-side
    errors are zero), and the gauge overlap of the two chains' left Schmidt
    bases comes from the Slater overlap formulas (one
    :class:`MPSTensorData` across the two chains).  Returns (iMPS,
    :class:`temfpy_torch.iMPS.iMPSError`)."""
    from . import iMPS as imps_mod

    trunc_par = to_stopping_condition(trunc_par)
    unitary_tol = imps_mod._UNITARY_TOL if unitary_tol is None else unitary_tol
    schmidt_tol = imps_mod._SCHMIDT_TOL if schmidt_tol is None else schmidt_tol
    if unit_cell_width is None:
        unit_cell_width = sites_per_cell
    elif sites_per_cell % unit_cell_width != 0:
        raise ValueError(f"{unit_cell_width = } does not divide {sites_per_cell = }")
    C_short = _to_device(C_short, device)
    C_long = _to_device(C_long, C_short.device)
    if spinful in ("simple", "PH"):
        if spinful == "simple":
            if offset == "auto":
                offset = 2 * round(float(torch.trace(C_short[:cut, :cut]).real))
                logger.info("Using total offset %s for conserved fermion number", offset)
            else:
                offset *= 2
        C_short = spinful_correlation_matrix(C_short, spinful == "PH")
        C_long = spinful_correlation_matrix(C_long, spinful == "PH")
        sites_per_cell *= 2
        cut *= 2
    elif spinful is not None:
        raise ValueError(f"`spinful` must be 'simple', 'PH', or `None`, got {spinful!r}")

    L_short, L_long = C_short.shape[0], C_long.shape[0]
    if C_short.shape != (L_short, L_short) or C_long.shape != (L_long, L_long):
        raise ValueError("Got a non-square correlation matrix")
    if L_short + sites_per_cell != L_long:
        raise ValueError("The given two systems must differ by one unit cell, got "
                         f"{L_long} - {L_short} != {sites_per_cell}")
    if offset == "auto":
        offset = round(float(torch.trace(C_short[:cut, :cut]).real))
        logger.info("Using offset %s for conserved fermion number", offset)
    offset = int(offset)
    _reset_swap_stats()
    reset_rsf_stats()

    Schmidt_short = SchmidtVectors.from_correlation_matrix(C_short, cut, trunc_par,
                                                           diag_tol=diag_tol)
    Schmidt_long = SchmidtVectors.from_correlation_matrix(C_long, cut, trunc_par,
                                                          diag_tol=diag_tol)
    lams = [normalize_SV(Schmidt_short.schmidt_values, logger)]
    q_bonds = [Schmidt_short.q_left - offset]
    # right-canonical cell tensors of the long chain; the last one closes
    # onto the short chain's right Schmidt vectors
    n_long = int(np.round(float(torch.trace(C_long).real)))
    mid_sv = _schmidt_vectors_batched(C_long, list(range(cut + 1, cut + sites_per_cell)), "R",
                                      trunc_par, diag_tol, 32, n_long)
    pairs = []
    Schmidt = Schmidt_long
    for i in range(sites_per_cell):
        if i == sites_per_cell - 1:
            Schmidt_new = Schmidt_short
            lams.append(lams[0])
            q_bonds.append(q_bonds[0])
        else:
            Schmidt_new = mid_sv[i]
            lams.append(normalize_SV(Schmidt_new.schmidt_values, logger))
            q_bonds.append(Schmidt_new.q_left - offset)
        pairs.append((Schmidt_new, Schmidt, "right"))
        Schmidt = Schmidt_new
    with profiling.stage("tensor_fill"):
        results = build_site_tensors(pairs)
    tensors = [T for T, _ql, _qr, _qt in results]
    qts = [qt for _T, _ql, _qr, qt in results]

    # gauge-fix the first tensor through the Slater overlap of the two
    # chains' left Schmidt bases
    with profiling.stage("tensor_fill"):
        Cmat, q_bra, q_ket, qt_c = MPSTensorData.from_schmidt_vectors(
            Schmidt_short, Schmidt_long, "left").to_dense_tensor()
    Cmat, left_unitary, left_schmidt = imps_mod.basis_rotation(
        Cmat, normalize_SV(Schmidt_short.schmidt_values), normalize_SV(Schmidt_long.schmidt_values),
        mode="left", q_bra=q_bra, q_ket=q_ket, chinfo=chinfo, qtotal=qt_c,
        unitary_tol=unitary_tol, schmidt_tol=schmidt_tol)
    tensors[0] = torch.einsum("ab,bnc->anc", Cmat, tensors[0])
    qts[0] += qt_c
    imps = MPS([fermion_site] * sites_per_cell, tensors, lams, form="B", bc="infinite",
               unit_cell_width=unit_cell_width, q_bonds=q_bonds, qtotals=qts)
    return imps, imps_mod.iMPSError(left_unitary, left_schmidt, 0.0, 0.0)


def H_to_iMPS(H_short, H_long, trunc_par, sites_per_cell: int, cut: int, *,
              diag_tol: float = _DIAG_TOL, unitary_tol: float | None = None,
              schmidt_tol: float | None = None,
              spinful: Literal["simple", "PH", None] = None, offset="auto",
              unit_cell_width: int | None = None, device=None):
    r"""iMPS of a Slater determinant from two single-particle Hamiltonians
    that differ by one unit cell (reference slater.py:1630-1735), on
    ``device`` (see :func:`C_to_iMPS`)."""
    dev = resolve_device(H_short, device)
    C_short, _ = correlation_matrix(H_short, device=dev)
    C_long, _ = correlation_matrix(H_long, device=dev)
    return C_to_iMPS(C_short, C_long, trunc_par, sites_per_cell, cut, diag_tol=diag_tol,
                     unitary_tol=unitary_tol, schmidt_tol=schmidt_tol, spinful=spinful,
                     offset=offset, unit_cell_width=unit_cell_width, device=dev)


def H_to_MPS(H, trunc_par, *, diag_tol: float = _DIAG_TOL, ortho_center: int | None = None,
             spinful: Literal["simple", "PH", None] = None, unit_cell_width: int | None = None,
             device=None) -> MPS:
    r"""MPS representation of the ground state of a single-body Hamiltonian
    (reference slater.py:1568-1627), on ``device`` (see :func:`C_to_MPS`)."""
    C, _ = correlation_matrix(H, device=device)
    return C_to_MPS(C, trunc_par, diag_tol=diag_tol, ortho_center=ortho_center,
                    spinful=spinful, unit_cell_width=unit_cell_width, device=device)
