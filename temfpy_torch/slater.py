r"""Slater determinants -> matrix product states, on PyTorch.

Counterpart of :mod:`temfpy_tpu.slater` (the SchmidtModes ->
SchmidtVectors -> MPSTensorData pipeline, ``correlation_matrix``,
``C_to_MPS``, ``H_to_MPS``), with the same function names.  "reference
slater.py:N" in a docstring cites the original TeMFpy source, as the JAX
package's docstrings do.  The path:

1. ``correlation_matrix``: one ``eigh`` of the single-particle Hamiltonian.
2. Per cut, the eigendecomposition of the leading or trailing block of C,
   as slabs of one batched padded ``eigh``
   (:func:`temfpy_torch.ops.linalg.eigh_blocks`), then the Schmidt modes
   (:class:`SchmidtModes`) and the enumeration of the chi leading Schmidt
   states on the host (:class:`SchmidtVectors`).
3. Per site, host planning (:func:`_plan_site`,
   :meth:`MPSTensorData._plan_fill`, numpy) and exactly two device entry
   points, each launched once per group of sites sharing a shape bucket:
   :func:`temfpy_torch.ops.kernels.site_overlap_schur` (orbital overlap +
   Schur complement of the always-occupied block) and
   :func:`temfpy_torch.ops.kernels.det_fill` (the determinant of every
   charge-matching (bra, ket) pair, scattered into the dense site tensor).
4. The tensors land in :class:`temfpy_torch.mps.MPS`.

Every device array lives on the device of the correlation matrix (the
``device`` argument of the entry points: ``cuda`` if present, else ``cpu``).
On the CPU the two device entry points run their plain PyTorch twins.

Not ported (TPU workarounds of the JAX package): ``_take_frame``,
``_slice_flat``/``_slice_flat_group``, ``_unstack`` and the fused
single-upload plan buffer (a Python slice or ``torch.unbind`` does their
work); the ``_chi_shard_*`` helpers and the mesh branch of
``build_site_tensors``; the compact host frontend
(``_compact_sweep_frames``, so every frame is a full (L, L) eigh output);
the randomized and Fishman-White frontends; the stream lookahead thread;
the small-problem CPU reroute; the pair-axis chunking that bounded the
TPU's one-hot temporaries.  Not yet ported: the rank-update (swap)
determinant path, and ``C_to_iMPS``/``H_to_iMPS``.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Literal, Type

import numpy as np
import torch

from . import profiling
from .config import DIAG_TOL as _DIAG_TOL
from .config import default_device
from .mps import MPS, FermionSite
from .ops.kernels import det_fill, site_overlap_schur
from .ops.linalg import block_svd, eigh_blocks
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

    The eigenvectors are kept in their full-frame form, the (L, L) output of
    the padded batched eigh (block vectors in the leading (side L) or
    trailing (side R) coordinates), plus a host map from the canonical
    column order (filled, entangled desc, empty for L; empty, entangled
    desc, filled for R) to frame columns.  ``vL``/``vR`` materialise the
    reference's canonical (n, n) matrices on demand.
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

    def __post_init__(self):
        assert (self.frameL is None) == (self.ixL is None)
        assert (self.frameR is None) == (self.ixR is None)
        assert (self.frameL is not None) or (self.frameR is not None)

    @staticmethod
    def _materialise(frame, col, rows):
        return frame[rows][:, _idx(col, frame.device)]

    @property
    def vL(self):
        """Canonical (nL, nL) left eigenvector matrix (materialised)."""
        if self.frameL is None:
            return None
        return self._materialise(self.frameL, self.colL, slice(None, self.nL))

    @property
    def vR(self):
        """Canonical (nR, nR) right eigenvector matrix (materialised)."""
        if self.frameR is None:
            return None
        return self._materialise(self.frameR, self.colR, slice(self.L - self.nR, None))

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
                  diag_tol: float = _DIAG_TOL, n_fermion: int | None = None) -> "SchmidtModes":
        """Builds SchmidtModes from block eigendecompositions: host
        eigenvalues ``eL``/``eR`` (ascending) and (L, L) frames
        ``vL_raw``/``vR_raw`` as returned by :func:`eigh_blocks`."""
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
                    ixR=ixR, nL=x, nR=nR, n_fermion=n_fermion, L=L)
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


@dataclass(frozen=True)
class MPSTensorData:
    """Implicit description of one MPS tensor (or Schmidt-vector overlap
    matrix) of a Slater determinant (reference slater.py:872-1143).

    The identity ``det[[A, B], [C, D]] = det(A) det(D - C A^-1 B)`` factors
    the overlap of the always-occupied orbitals out once
    (``det_always``); each remaining entry is a small determinant over the
    "sometimes" orbitals of ``sometimes_matrix``.

    Only what :func:`build_site_tensors` runs is ported: the packed direct
    plan and the slice to the true shape.  The single-site API
    (``from_schmidt_vectors``, ``to_dense_tensor``, ``dispatch_fill``) and
    the unpacked plan (``_direct_arrays``, ``_scatter_ix``) are not.
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

    def _plan_fill(self):
        """Host planning of the tensor fill: returns (shape, q_l, q_r,
        plans), one direct plan per determinant width bucket (pairs of
        excitation class c only need c x c determinants; widths are padded
        to 4 or to multiples of 8).  Plans scatter into disjoint entries."""
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

        direct: dict[int, tuple[list, list]] = {}
        for c in np.unique(cnt_bra):
            rows = np.nonzero(cnt_bra == c)[0]
            cols = np.nonzero(cnt_ket == c)[0]
            if not (rows.size and cols.size):
                continue
            c = int(c)
            w_b = 4 if c <= 4 else -(-c // 8) * 8
            r_l, c_l = direct.setdefault(w_b, ([], []))
            r_l.append(np.repeat(rows, cols.size))
            c_l.append(np.tile(cols, rows.size))
        plans = [
            self._direct_plan_packed(np.concatenate(direct[w_b][0]),
                                     np.concatenate(direct[w_b][1]), w_b, m, shape)
            for w_b in sorted(direct)
        ]
        return shape, q_l, q_r, plans

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

        sb0 = _bucket_shape(shape)[0]
        beta = np.zeros(R_b, np.int32)
        beta[: len(ub)] = self.bra_beta[ub]
        col = np.zeros(K_b, np.int32)
        col[: len(uk)] = uk
        dummy = np.zeros(1, np.int32)
        if not self.physical_leg:
            beta[len(ub):] = sb0  # trash routing on the leading axis
            spec, tabs = "rc", (beta, col, dummy)
        elif self.mode == "left":
            phys = np.zeros(R_b, np.int32)
            phys[: len(ub)] = self.bra_phys[ub]
            beta[len(ub):] = sb0
            spec, tabs = "rrc", (beta, phys, col)
        else:
            phys = np.zeros(R_b, np.int32)
            phys[: len(ub)] = self.bra_phys[ub]
            col[len(uk):] = sb0
            spec, tabs = "crr", (col, phys, beta)
        return {"kind": "direct", "occ_b": occ_b, "occ_k": occ_k, "pr": pr, "pc": pc,
                "tabs": tabs, "spec": spec}

    def resolve_fill(self, shape, T):
        """The summed bucketed fill ``T`` sliced to the true shape (zeros
        where ``T`` is None: no charge-matching pair)."""
        if T is None:
            return torch.zeros(shape, dtype=self.sometimes_matrix.dtype,
                               device=self.sometimes_matrix.device)
        return T[tuple(slice(0, d) for d in shape)]


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
    frame_ket = modes_ket.frameL if side == "L" else modes_ket.frameR
    col_ket = modes_ket.colL if side == "L" else modes_ket.colR
    if frame_bra is None or frame_ket is None:
        raise ValueError(f"Schmidt vectors contain no {mode} Schmidt vectors")
    if modes_ket.L != modes_bra.L:
        raise NotImplementedError("overlaps between chains of different length "
                                  "(iMPS gauge fixing) are not ported yet")
    sets_bra = Schmidt_bra.sets(mode)
    sets_ket = Schmidt_ket.sets(mode)
    L = modes_bra.L

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

    def descriptors(order, sign, col_map, is_bra):
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
            """Canonical sets-column index -> (kind, frame col, row)."""
            if physical and is_bra:
                if c == phys_pos:
                    return 1, 0, phys_row
                if mode == "right":
                    c = c - 1  # phys occupies sets column 0
            return 0, int(col_map[c]), 0

        for p, c, s in zip(apos, always, sign_always):
            kind[p], col[p], row[p] = to_frame_col(int(c))
            sgn[p] = s
        for p, c, s in zip(rpos, rest, sign_rest):
            kind[p], col[p], row[p] = to_frame_col(int(c))
            sgn[p] = s
        kind[ppos] = 1
        row[ppos] = padA_rows
        return col, kind, row, sgn

    desc = (*descriptors(order_b, sign_b, col_bra, True),
            *descriptors(order_k, sign_k, col_ket, False))

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


def _fill_group(Ms, dets, plans, shape_b):
    """One ``det_fill`` launch for fill plans sharing (bucketed shape, P_b,
    table shapes, spec, sometimes shape); returns (G, *shape_b)."""
    dev = Ms[0].device

    def up(key):
        return torch.as_tensor(np.stack([p[key] for p in plans]), device=dev)

    tabs = tuple(torch.as_tensor(np.stack([p["tabs"][t] for p in plans]), device=dev)
                 for t in range(3))
    return det_fill(torch.stack(Ms), torch.stack(dets), up("occ_b"), up("occ_k"),
                    up("pr"), up("pc"), tabs, spec=plans[0]["spec"], shape=shape_b)


def build_site_tensors(pairs):
    """Evaluates the MPS tensors of many sites with grouped device work.

    ``pairs`` is a list of (Schmidt_bra, Schmidt_ket, mode).  Sites sharing
    a shape bucket are stacked: the overlap/Schur step and each width
    bucket of the fill launch one kernel per group, not one per site.
    Returns [(T, q_l, q_r, qtotal)] aligned with ``pairs``.
    """
    n = len(pairs)
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

    # ---- stage 2: grouped fill (kernel K1) ----
    datas = [MPSTensorData(det_always=det_of[i], sometimes_matrix=som_of[i],
                           **plans[i]["fields"]) for i in range(n)]
    with profiling.stage("fill/plan_fill"):
        fill_plans = [d._plan_fill() for d in datas]
    fill_groups: dict = {}
    for i, (shape, _ql, _qr, fplans) in enumerate(fill_plans):
        for plan in fplans:
            key = (_bucket_shape(shape), plan["pr"].shape[0], plan["occ_b"].shape,
                   plan["occ_k"].shape, plan["spec"], tuple(datas[i].sometimes_matrix.shape))
            fill_groups.setdefault(key, []).append((i, plan))
    acc: dict = {}
    with profiling.stage("fill/det_groups"):
        for key, entries in fill_groups.items():
            T_s = _fill_group([datas[i].sometimes_matrix for i, _ in entries],
                              [datas[i].det_always for i, _ in entries],
                              [p for _, p in entries], key[0])
            for T, (i, _p) in zip(torch.unbind(T_s), entries):
                acc[i] = T if i not in acc else acc[i] + T

    with profiling.stage("fill/resolve"):
        out = []
        for i, (shape, q_l, q_r, _plans) in enumerate(fill_plans):
            out.append((datas[i].resolve_fill(shape, acc.get(i)), q_l, q_r, datas[i].qtotal))
    return out


#### ENTRY POINTS ####
#### ------------ ####


def _to_device(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    return torch.as_tensor(np.asarray(x), device=device if device is not None
                           else default_device())


def correlation_matrix(H, N: int | None = None, *, device=None):
    r"""Ground-state correlation matrix C_ij = <c_j^dagger c_i> of a
    mean-field Hamiltonian (reference slater.py:1150-1180): one ``eigh``
    on ``device`` (default: H's device for a tensor, else
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


def _schmidt_vectors_batched(C: torch.Tensor, cuts, which: str, trunc_par,
                             diag_tol: float, chunk: int, n_fermion: int):
    """Schmidt vectors for many cuts from one batched eigh; ``which`` is
    "L" or "R".  Returns the SchmidtVectors per cut, in order."""
    trunc_par = to_stopping_condition(trunc_par)
    L = C.shape[0]
    sizes = [x if which == "L" else L - x for x in cuts]
    with profiling.stage("eigh_batch"):
        e_all, v_all = eigh_blocks(C, sizes, which, chunk=chunk)
        e_host = e_all.cpu().numpy()
    out = []
    for i, x in enumerate(cuts):
        kw = {"eL": e_host[i, : sizes[i]], "vL_raw": v_all[i]} if which == "L" else {
            "eR": e_host[i, : sizes[i]], "vR_raw": v_all[i]}
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
    tensor, else ``cuda`` if present, else ``cpu``).  The center cut is
    decomposed first; then each half is streamed in blocks of
    ``eigh_chunk`` cuts: one batched eigh, the Schmidt enumeration on the
    host, and the grouped site kernels.  The result is in mixed canonical
    form 'A' * c + 'B' * (L - c) with c = ``ortho_center`` (default L // 2).
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
                                                eigh_chunk, n_fermion)
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


def H_to_MPS(H, trunc_par, *, diag_tol: float = _DIAG_TOL, ortho_center: int | None = None,
             spinful: Literal["simple", "PH", None] = None, unit_cell_width: int | None = None,
             device=None) -> MPS:
    r"""MPS representation of the ground state of a single-body Hamiltonian
    (reference slater.py:1568-1627), on ``device`` (see :func:`C_to_MPS`)."""
    C, _ = correlation_matrix(H, device=device)
    return C_to_MPS(C, trunc_par, diag_tol=diag_tol, ortho_center=ortho_center,
                    spinful=spinful, unit_cell_width=unit_cell_width)
