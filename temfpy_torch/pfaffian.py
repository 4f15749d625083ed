r"""BdG / Pfaffian (Nambu mean-field) states -> matrix product states, on PyTorch.

Counterpart of :mod:`temfpy_tpu.pfaffian` (basis and Nambu utilities,
``correlation_matrix``, ``parity``, the Bogoliubov Schmidt modes with the
lambda=1/2 machinery, Schmidt vectors, Pfaffian-overlap MPS tensors,
``C_to_MPS`` / ``H_to_MPS``), with the same function names.  "reference
pfaffian.py:N" in a docstring cites the original TeMFpy source, as the JAX
package's docstrings do.  The path:

1. ``correlation_matrix``: one ``eigh`` of the BdG Hamiltonian.
2. Per cut, the eigendecomposition of the leading or trailing block of the
   Majorana correlation matrix, as slabs of one batched padded ``eigh``
   (:func:`temfpy_torch.ops.linalg.eigh_blocks`), then the Schmidt modes
   (:class:`SchmidtModes`, host numpy) and the enumeration of the chi
   leading Schmidt states (:class:`SchmidtVectors`).
3. Per site, host planning (:func:`_plan_site`,
   :meth:`MPSTensorData._plan_fill`, numpy) and exactly two device entry
   points, each launched once per group of sites sharing a shape bucket:
   :func:`temfpy_torch.ops.kernels.bdg_overlap` (basis change, U*^-1, the
   antisymmetric overlap matrix N and the Onishi norm) and
   :func:`temfpy_torch.ops.kernels.pf_fill` (the Pfaffian of every
   parity-matching (bra, ket) pair, scattered into the dense site tensor).
4. The tensors land in :class:`temfpy_torch.mps.MPS` with Z2 parity labels.

Basis conventions (as the reference): the complex-fermion layout
interleaves (c^dag_i, c_i) per site; the Majorana basis is
gamma_{2n} = (c^dag_n + c_n)/sqrt(2), gamma_{2n+1} = i (c^dag_n - c_n)/sqrt(2).

Device: the entry points take ``device``; ``None`` means the device of a
tensor argument, else ``cuda`` (:func:`temfpy_torch.config.default_device`
raises where there is no card; under an active mesh, its first device).  On
the CPU the two device entry points run their plain PyTorch twins.  The
complex128 working dtype is native on the card.  Under
:class:`temfpy_torch.parallel.mesh.use_mesh` the eighs' cuts, the K4 sites
and the K3 pairs split over the mesh.

Not ported (TPU workarounds of the JAX package): the split-plane overlap
path (``complex_on_device``, ``splitc`` frames, the deferred overlap
preparations), ``queue`` / ``materialise_queued`` and the fused downloads,
``compute_context`` and the ``dtype=`` cast, the host-LAPACK eigh branch of
``modes_batched``.

``C_to_iMPS`` / ``H_to_iMPS`` build an iMPS cell from two chains that
differ by one unit cell, through the same kernels.
"""

from __future__ import annotations

import logging
import warnings
from dataclasses import dataclass
from functools import partial
from typing import Type

import numpy as np
import torch
from scipy.stats import ortho_group

from . import profiling, testing
from .config import DIAG_TOL as _DIAG_TOL
from .config import resolve_device
from .mps import MPS, FermionSite
from .ops.kernels import bdg_overlap, fill_buffer, pf_fill
from .ops.linalg import block_svd, eigh_blocks
from .parallel import mesh as _pmesh
from .schmidt_utils import lowest_sums, to_stopping_condition
from .testing import assert_allclose, assert_array_less, check_schmidt_decomposition
from .utils import HT, normalize_SV

logger = logging.getLogger(__name__)

fermion_site = FermionSite(conserve="parity")
"""Lattice site prototype for the parity-conserving fermion MPS
(reference pfaffian.py:63)."""

fermion_leg = fermion_site.charges
"""Physical-leg charge labels."""

chinfo = fermion_site.chinfo
"""Charge info of the parity-conserving fermion site."""


#### BASIS TRANSFORMATIONS ####
#### --------------------- ####

_C2M = np.array([[1, 1], [1j, -1j]]) / 2**0.5
_M2C = np.array([[1, -1j], [1, 1j]]) / 2**0.5


def _apply_site_unitary(v, M):
    """Applies a 2x2 unitary on the per-site Nambu index of the row space."""
    v = np.asarray(v)
    n = v.shape[0]
    assert n % 2 == 0, "Got vector(s) of odd size (cannot be Nambu)"
    v = v.reshape(n // 2, 2, *v.shape[1:])
    v = np.einsum("xa...,ca->xc...", v, np.asarray(M, complex))
    return v.reshape(n, *v.shape[2:])


def vector_C2M(v):
    """Mode vectors complex-fermion -> Majorana (reference pfaffian.py:75-100)."""
    return _apply_site_unitary(v, _C2M)


def vector_M2C(v):
    """Mode vectors Majorana -> complex-fermion (reference pfaffian.py:103-128)."""
    return _apply_site_unitary(v, _M2C)


def _apply_matrix_unitary(H, M):
    H = np.asarray(H)
    n, m = H.shape
    assert n % 2 == 0 and m % 2 == 0, "Matrix sides must be even (Nambu)"
    H = H.reshape(n // 2, 2, m // 2, 2)
    Mc = np.asarray(M, complex)
    H = np.einsum("xayb,ca,db->xcyd", H, Mc, Mc.conj())
    return H.reshape(n, m)


def matrix_C2M(H):
    """Hamiltonian/correlation matrix complex-fermion -> Majorana
    (reference pfaffian.py:131-156)."""
    return _apply_matrix_unitary(H, _C2M)


def matrix_M2C(H):
    """Hamiltonian/correlation matrix Majorana -> complex-fermion
    (reference pfaffian.py:159-184)."""
    return _apply_matrix_unitary(H, _M2C)


#### NAMBU UTILITIES ####
#### --------------- ####


def assert_nambu(C, basis: str | None = None, offset: float | None = None, name: str = "",
                 rtol: float = 0, atol: float = 1e-10):
    r"""Checks (and regularises) Nambu symmetry of a matrix
    (reference pfaffian.py:189-286).

    In the Majorana basis a Nambu matrix is imaginary and antisymmetric up to
    ``offset/2`` on the diagonal; in the complex-fermion basis the 2x2 blocks
    obey C11 + C22* = offset*I, C12 = -C21*.
    """
    C = np.asarray(C)
    n, m = C.shape
    assert n == m > 0, f"Got non-square {name}"
    assert n % 2 == 0, f"Got {name} with odd side length (cannot be Nambu)"
    n //= 2

    tol = dict(atol=atol, rtol=rtol)
    assert_allclose(C, HT(C), **tol, err_msg=f"{name} is not Hermitian")
    C = (C + HT(C)) / 2

    if basis == "M":
        err = "Unexpected real parts in Majorana basis"
        real = np.eye(2 * n) * (offset or 0) / 2
        assert_allclose(C.real, real, **tol, err_msg=err)
        C = real + 1j * C.imag
    elif basis == "C":
        err = f"{name.capitalize()} is not Nambu symmetric"
        assert_allclose(C[::2, ::2], (offset or 0) * np.eye(n) - C[1::2, 1::2].conj(), **tol,
                        err_msg=err)
        assert_allclose(C[1::2, ::2], -C[::2, 1::2].conj(), **tol, err_msg=err)
        if np.allclose(C.imag, 0, **tol):
            C = C.real
    elif basis is not None:
        raise ValueError("Invalid `basis` " + repr(basis))
    return C


assert_nambu_hamiltonian = partial(assert_nambu, offset=0, name="Hamiltonian")
assert_nambu_correlation = partial(assert_nambu, offset=1, name="correlation matrix")


@profiling.entry_point
def correlation_matrix(H, basis: str | None = None, *, rtol: float = 0, atol: float = 1e-10,
                       device=None) -> np.ndarray:
    r"""Ground-state Nambu correlation matrix of a BdG Hamiltonian
    (reference pfaffian.py:302-393), as host numpy.

    ``basis`` is "X->Y" with X, Y in {M, C} selecting input/output bases.
    The ``eigh`` runs on ``device`` (default: H's device for a tensor, else
    ``cuda``)."""
    basis_error = f"Invalid basis spec {basis!r}, should be of form '[MC]->[MC]'"
    assert basis in [None, "M->M", "M->C", "C->M", "C->C"], basis_error
    tol = dict(rtol=rtol, atol=atol)
    dev = resolve_device(H, device)

    with profiling.stage("correlation_matrix"):
        with profiling.stage("checks/nambu"):
            H = assert_nambu_hamiltonian(profiling.to_host(H), None if basis is None else basis[0],
                                         **tol)
        n = len(H) // 2
        e, v = torch.linalg.eigh(profiling.to_device(np.ascontiguousarray(H), dev))
        e_host = profiling.to_host(e)
        assert_allclose(e_host + e_host[::-1], 0, **tol)
        if np.any(abs(e_host) < atol):
            raise RuntimeError(
                "Some energy eigenvalues are zero. You need to construct\n"
                "your own correlation matrix!\n"
                f"Middle 10 eigenvalues:\n{e_host[n - 5 : n + 5, None]}"
            )
        assert_array_less(e_host[:n], 0, "Lower half of eigenvalues is not all negative")
        v = profiling.to_host(v[:, :n])
        if basis == "C->M":
            v = vector_C2M(v)
        elif basis == "M->C":
            v = vector_M2C(v)
        C = v @ HT(v)
        with profiling.stage("checks/nambu"):
            return assert_nambu_correlation(C, None if basis is None else basis[3], **tol)


def parity(V, *, tol: float = 1e-12) -> int:
    r"""Fermion parity of a Bogoliubov vacuum via Bloch-Messiah: the parity
    of the number of unit singular values of the pairing block V
    (reference pfaffian.py:396-456)."""
    V = np.asarray(V)
    if len(V) == 0:
        return 0
    if len(V) == 1:
        val = V.item()
        if np.isclose(val, 0.0, rtol=0, atol=tol):
            return 0
        if np.isclose(abs(val), 1.0, rtol=0, atol=tol):
            return 1
        raise RuntimeError("Invalid 1x1 V")
    s = np.linalg.svd(V, compute_uv=False)
    if np.all(s < tol):
        return 0  # no pairing at all: the vacuum is the bare vacuum (even)
    if len(V) > 2:
        # SVs strictly between 0 and 1 come in pairs; the ones above the
        # largest gap share the parity of the exact 1s
        n = int(np.argmax(-np.diff(s)))
        return (n + 1) % 2
    if np.allclose(s, [1.0, 0.0], rtol=0, atol=tol):
        return 1
    if np.isclose(s[0], s[1], rtol=0, atol=tol):
        return 0
    raise ValueError("Invalid 2x2 V")


#### SCHMIDT MODES ####
#### ------------- ####


@dataclass(frozen=True)
class SchmidtModes:
    """Bogoliubov excitations generating the Schmidt vectors of a Nambu
    mean-field state (reference pfaffian.py:461-979).

    ``vL``/``vR`` are (2n, 2n) host numpy arrays in the complex-fermion
    basis with the column layout of the reference (entangled modes at the
    end/start of the first half; second half = Nambu conjugates)."""

    nL: int
    nR: int
    e: np.ndarray  # entangled eigenvalues in (0, 1/2], ascending
    vL: np.ndarray | None
    vR: np.ndarray | None
    pL: int | None
    pR: int | None

    def __post_init__(self):
        if self.vL is not None:
            assert self.pL is not None, "`pL` must be specified with `vL`"
        if self.vR is not None:
            assert self.pR is not None, "`pR` must be specified with `vR`"
        assert (self.vL is not None) or (self.vR is not None)

    def parity(self, which: str = "T") -> int | None:
        w = which[0].upper()
        if w == "L":
            return self.pL
        if w == "R":
            return self.pR
        if w == "T":
            if (self.pL is None) or (self.pR is None):
                return None
            return (self.pL + self.pR) % 2
        raise ValueError("`which` must start with L, R, or T, got " + repr(which))

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

    @property
    def vL_entangled(self):
        if self.vL is None:
            return None
        k = self.n_entangled
        ix = np.arange(self.nL - k, self.nL)
        return self.vL[:, np.concatenate((ix, ix + self.nL))]

    @property
    def vR_entangled(self):
        if self.vR is None:
            return None
        ix = np.arange(self.n_entangled)
        return self.vR[:, np.concatenate((ix, ix + self.nR))]

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
            if self.vL is None:
                return None
            e = self.e
            if not entangled:
                e = np.concatenate((np.zeros(self.nL - self.n_entangled), e))
        elif w == "R":
            if self.vR is None:
                return None
            e = self.e[::-1]
            if not entangled:
                e = np.concatenate((e, np.zeros(self.nR - self.n_entangled)))
        else:
            raise ValueError("`which` must start with L or R, got " + repr(which))
        return np.concatenate((e, 1 - e))

    @property
    def singular_values(self):
        if (self.vL is None) or (self.vR is None):
            return None
        SV = (self.e * (1 - self.e)) ** 0.5
        SV = SV * (-1 if self.pL == 1 else 1)  # anticommutation sign
        return np.concatenate((SV, -SV))  # Nambu sign

    @property
    def e_ratio(self) -> np.ndarray:
        return np.log((1 - self.e) / self.e)

    def embed_subsets(self, sets: np.ndarray):
        left_sets = sets if self.vL is not None else None
        right_sets = sets[:, ::-1] if self.vR is not None else None
        return left_sets, right_sets

    def schmidt_values(self, sets: np.ndarray) -> np.ndarray:
        return np.where(sets, self.e, 1 - self.e).prod(axis=1) ** 0.5

    @classmethod
    def from_eigh_majorana(cls: Type["SchmidtModes"], C_M, x: int, trunc_par, *, eL=None,
                           vL_raw=None, eR=None, vR_raw=None, diag_tol: float = _DIAG_TOL,
                           total_parity: int | None = None) -> "SchmidtModes":
        """Builds SchmidtModes from Majorana-block eigendecompositions
        (ascending, as from :func:`eigh_blocks`; host numpy or tensors):
        the pairing, lambda=1/2 and Nambu machinery of reference
        pfaffian.py:685-920.  Host numpy throughout: control-flow heavy and
        O(L^2 k) per cut."""
        trunc_par = to_stopping_condition(trunc_par)
        cutoff = trunc_par.svd_min**2
        deg_tol = trunc_par.degeneracy_tol
        C_M = profiling.to_host(C_M)
        L = C_M.shape[0] // 2
        y = L - x

        def analyse(e_host, n):
            """Classify the ascending Majorana-block spectrum: clip,
            symmetry check, count the 1/2 modes (kh) and entangled modes
            (ke) from the lower half (mirrored by Nambu symmetry)."""
            if n == 0:
                return np.zeros(0), 0, 0
            err = "Invalid correlation matrix eigenvalues (should be in [0,1])"
            assert_array_less(-deg_tol, e_host, err_msg=err)
            assert_array_less(e_host, 1 + deg_tol, err_msg=err)
            e_host = np.clip(e_host, 0.0, 1.0)
            err = "Eigenvalues break Nambu symmetry"
            assert_allclose(e_host, 1 - e_host[::-1], rtol=0, atol=deg_tol, err_msg=err)
            kh = n - int(np.searchsorted(e_host, 0.5 - deg_tol))
            ke = n - int(np.searchsorted(e_host, cutoff))
            return e_host, ke, kh

        def realify_half_modes(v, n, kh):
            """Rotate the 2*kh eigenvectors at lambda=1/2 to a real basis
            (reference pfaffian.py:802-816)."""
            if kh == 0 or not np.iscomplexobj(v):
                return v
            sl = np.arange(n - kh, n + kh)
            block = v[:, sl]
            w = np.concatenate([block.real, block.imag], axis=1)
            w, s_host, _ = np.linalg.svd(w, full_matrices=False)
            s_exp = np.concatenate([np.ones(2 * kh), np.zeros(s_host.size - 2 * kh)])
            assert_allclose(s_host, s_exp, rtol=0, atol=diag_tol,
                            err_msg="1/2 eigenvectors cannot be made real")
            v = v.copy()
            v[:, sl] = w[:, : 2 * kh].astype(v.dtype)
            return v

        eL_a = keL = khL = eR_a = keR = khR = None
        vL = vR = None
        if eL is not None:
            eL_a, keL, khL = analyse(profiling.to_host(eL), x)
            vL = np.array(profiling.to_host(vL_raw), dtype=complex)
        if eR is not None:
            eR_a, keR, khR = analyse(profiling.to_host(eR), y)
            vR = np.array(profiling.to_host(vR_raw), dtype=complex)
        if eL_a is None and eR_a is None:
            raise ValueError("need at least one of the L/R eigendecompositions")

        if (eL_a is not None) and (eR_a is not None):
            if keL != keR or khL != khR:
                # borderline eigenvalues classified differently on the two
                # sides: take the common (larger) counts
                logger.info("reconciling mode counts: ke %d/%d, kh %d/%d", keL, keR, khL, khR)
                keL = keR = max(keL, keR)
                khL = khR = max(khL, khR)
            k, kh = keL, khL
            vL = realify_half_modes(vL, x, kh)
            vR = realify_half_modes(vR, y, kh)
            e = eL_a[x - k : x]
            assert_allclose(e, eR_a[y - k : y], rtol=0, atol=deg_tol,
                            err_msg="Eigenvalues of C_LL and C_RR do not match")
            CLR = C_M[: 2 * x, 2 * x :]
            # SVD-pair the 0 < lambda < 1/2 modes
            if k > kh:
                slL = np.arange(x - k, x - kh)
                slR = np.arange(y + kh, y + k)[::-1]
                vLE, vRE = block_svd(torch.as_tensor(CLR), torch.as_tensor(vL[:, slL]),
                                     torch.as_tensor(vR[:, slR]), eL_a[x - k : x - kh], deg_tol)
                vL[:, slL] = vLE.numpy()
                vR[:, slR] = vRE.numpy()
            # SVD-pair the lambda=1/2 modes via the imaginary part of C_LR
            if kh > 0:
                ixL = np.arange(x - kh, x + kh)
                ixR = np.arange(y - kh, y + kh)
                s_block = vL[:, ixL].real.T @ CLR.imag @ vR[:, ixR].real
                U, _, Vh = np.linalg.svd(s_block)
                vL[:, ixL] = vL[:, ixL] @ U.astype(vL.dtype)
                vR[:, ixR] = vR[:, ixR] @ Vh.T.astype(vR.dtype)
        elif eL_a is not None:
            k, kh = keL, khL
            e = eL_a[x - k : x]
            vL = realify_half_modes(vL, x, kh)
        else:
            k, kh = keR, khR
            e = eR_a[y - k : y]
            vR = realify_half_modes(vR, y, kh)

        # fixed-seed quasirandom orthogonal shuffle of the 1/2 modes: breaks
        # the exact degeneracy reproducibly (reference pfaffian.py:867-874)
        if kh > 0:
            O = ortho_group.rvs(2 * kh, random_state=1234)
            if vL is not None:
                ixL = np.arange(x - kh, x + kh)
                vL[:, ixL] = vL[:, ixL] @ O.astype(vL.dtype)
            if vR is not None:
                ixR = np.arange(y - kh, y + kh)
                vR[:, ixR] = vR[:, ixR] @ O.astype(vR.dtype)

        logger.info("2 * %d entangled Schmidt modes found", k)
        logger.debug("2 * %d Schmidt modes with eigenvalue 1/2", kh)

        def nambu(v, n, kh, LR):
            """Restore the conjugate-pair structure, convert to the
            complex-fermion basis, compute the vacuum parity (reference
            pfaffian.py:879-897)."""
            v = v.copy()
            if LR == "L":
                if kh > 0:
                    a = np.arange(n - kh, n)
                    b = np.arange(n, n + kh)
                    v[:, a] = (v[:, a] + 1j * v[:, b]) / 2**0.5
                v[:, n:] = v[:, :n].conj()
            else:
                if kh > 0:
                    a = np.arange(n - kh, n)
                    b = np.arange(n, n + kh)
                    v[:, b] = ((-1j * v[:, a] + v[:, b]) / 2**0.5)[:, ::-1]
                v[:, :n] = v[:, n:].conj()
            v = vector_M2C(v)
            return v, parity(v[1::2, :n])

        pL = pR = None
        if vL is not None:
            vL, pL = nambu(vL, x, kh, "L")
            logger.info("Parity of left Bogoliubov vacuum: %s", pL)
            if vR is None and total_parity is not None:
                pR = (total_parity + pL) % 2
        if vR is not None:
            vR, pR = nambu(vR, y, kh, "R")
            logger.info("Parity of right Bogoliubov vacuum: %s", pR)
            if vL is None and total_parity is not None:
                pL = (total_parity + pR) % 2

        # commuting the right vectors through an odd left vacuum flips signs
        if (vL is not None) and (vR is not None) and (pL == 1):
            vR = -vR

        modes = cls(e=np.asarray(e, float), vL=vL, vR=vR, pL=pL, pR=pR, nL=x, nR=y)
        if (vL is not None) and (vR is not None):
            check_schmidt_decomposition(modes, matrix_M2C(C_M), diag_tol)
        return modes

    @classmethod
    def from_correlation_matrix(cls: Type["SchmidtModes"], C, x: int, trunc_par, *, basis: str,
                                which: str = "LR", diag_tol: float = _DIAG_TOL,
                                total_parity: int | None = None, device=None) -> "SchmidtModes":
        """Single-cut convenience wrapper (reference pfaffian.py:685-920);
        the block eigendecompositions run on ``device`` (default: C's
        device for a tensor, else ``cuda``)."""
        trunc_par = to_stopping_condition(trunc_par)
        dev = resolve_device(C, device)
        C = profiling.to_host(C)
        if basis == "C":
            C = matrix_C2M(C)
        elif basis != "M":
            raise ValueError(f"Argument `basis` must be 'M' or 'C', got {basis!r}")
        with profiling.stage("checks/nambu"):
            C = assert_nambu_correlation(C, "M", atol=trunc_par.svd_min**2)
        L = C.shape[0] // 2
        assert 0 <= x <= L, f"Invalid entanglement cut {x}, must be between 0 and {L}"
        which = which.upper()
        assert ("L" in which) or ("R" in which), \
            "`which` must specify at least one of (L)eft or (R)ight"

        C_dev = profiling.to_device(np.ascontiguousarray(C), dev)
        eL = vL_raw = eR = vR_raw = None
        if "L" in which:
            e_all, v_all = eigh_blocks(C_dev, [2 * x], "L")
            eL = profiling.to_host(e_all[0, : 2 * x])
            vL_raw = profiling.to_host(v_all[0, : 2 * x, : 2 * x])
        if "R" in which:
            e_all, v_all = eigh_blocks(C_dev, [2 * (L - x)], "R")
            eR = profiling.to_host(e_all[0, : 2 * (L - x)])
            vR_raw = profiling.to_host(v_all[0, 2 * x :, : 2 * (L - x)])
        return cls.from_eigh_majorana(C, x, trunc_par, eL=eL, vL_raw=vL_raw, eR=eR,
                                      vR_raw=vR_raw, diag_tol=diag_tol,
                                      total_parity=total_parity)


#### SCHMIDT VECTORS ####
#### --------------- ####


def _parity_n_argsort(x: np.ndarray):
    """Stable sort by (parity, value); returns (order, value->slice map,
    parity->slice map) (reference pfaffian.py:986-997)."""
    x = x.ravel()
    idx = np.lexsort((np.arange(len(x)), x, x % 2))
    xs = x[idx]
    return idx, _bunched_slices(xs), _bunched_slices(xs % 2)


def _bunched_slices(x: np.ndarray) -> dict[int, slice]:
    """Maps each value of a sorted int array to its slice
    (reference pfaffian.py:1000-1005)."""
    (jumps,) = np.nonzero(x[1:] != x[:-1])
    bounds = np.concatenate(([0], jumps + 1, [len(x)]))
    return {int(x[bounds[i]]): slice(int(bounds[i]), int(bounds[i + 1]))
            for i in range(len(bounds) - 1)}


@dataclass(frozen=True)
class SchmidtVectors:
    """Schmidt vectors of a Nambu mean-field state: subsets of Bogoliubov
    excitations over the vacua, collated by parity and excitation number
    (reference pfaffian.py:1008-1248)."""

    modes: SchmidtModes
    left_sets: np.ndarray | None
    right_sets: np.ndarray | None
    schmidt_values: np.ndarray
    idx_n: dict[int, slice]
    idx_parity: dict[int, slice]

    @property
    def n_schmidt(self) -> int:
        return self.schmidt_values.size

    @property
    def n_entangled(self) -> int:
        return self.modes.n_entangled

    @property
    def nL(self) -> int:
        return self.modes.nL

    @property
    def nR(self) -> int:
        return self.modes.nR

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

    @property
    def pL(self):
        return self.modes.pL

    @property
    def pR(self):
        return self.modes.pR

    def parity(self, which: str = "T"):
        return self.modes.parity(which)

    def sets(self, which: str):
        w = which[0].upper()
        if w == "L":
            return self.left_sets
        if w == "R":
            return self.right_sets
        raise ValueError("`which` must start with L or R, got " + repr(which))

    def q_parity(self, p_ref: int) -> np.ndarray:
        """Per-Schmidt-vector Z2 label: excitation parity offset by the
        reference vacuum parity (reference pfaffian.py:1485-1489)."""
        exc = (self.left_sets if self.left_sets is not None else self.right_sets).sum(1)
        return (exc + p_ref) % 2

    @classmethod
    def from_schmidt_modes(cls: Type["SchmidtVectors"], modes: SchmidtModes,
                           trunc_par) -> "SchmidtVectors":
        trunc_par = to_stopping_condition(trunc_par)
        _, sets = lowest_sums(modes.e_ratio / 2, trunc_par)
        if len(sets) == 0:
            raise ValueError("No Schmidt vectors left after filtering by `trunc_par.sectors`!")
        idx, idx_n, idx_parity = _parity_n_argsort(sets.sum(axis=1))
        sets = sets[idx]
        left_sets, right_sets = modes.embed_subsets(sets)
        lam = modes.schmidt_values(sets)
        logger.info("%d Schmidt vectors generated", len(lam))
        return cls(modes=modes, left_sets=left_sets, right_sets=right_sets, schmidt_values=lam,
                   idx_n=idx_n, idx_parity=idx_parity)

    @classmethod
    def from_correlation_matrix(cls: Type["SchmidtVectors"], C, x: int, trunc_par, *,
                                basis: str, which: str = "LR", diag_tol: float = _DIAG_TOL,
                                total_parity: int | None = None,
                                device=None) -> "SchmidtVectors":
        trunc_par = to_stopping_condition(trunc_par)
        modes = SchmidtModes.from_correlation_matrix(
            C, x, trunc_par, basis=basis, which=which, diag_tol=diag_tol,
            total_parity=total_parity, device=device)
        return cls.from_schmidt_modes(modes, trunc_par)


#### PFAFFIAN OVERLAPS AND MPS TENSORS ####
#### --------------------------------- ####


def _bucket(n: int, step: int = 32) -> int:
    """Rounds a size up to its shape bucket (sites whose sizes share a
    bucket share one kernel launch)."""
    if n <= 8:
        return 8
    return -(-n // step) * step


def _pad_nambu_modes(V: np.ndarray, n_b: int) -> np.ndarray:
    """Vacuum-pads a (2n, 2n) Nambu mode matrix to (2n_b, 2n_b): the extra
    modes are annihilators/creators of empty fake sites, so the padded matrix
    stays unitary and Nambu, original mode positions within each half are
    unchanged, and (for two identically padded matrices) the basis change
    V1^H V2 gains exact identity blocks: unit Onishi singular values and an
    identity extension of U*^-1 that the active-mode indices never touch."""
    n = V.shape[0] // 2
    p = n_b - n
    if p == 0:
        return V
    out = np.zeros((2 * n_b, 2 * n_b), dtype=V.dtype)
    out[: 2 * n, :n] = V[:, :n]
    out[: 2 * n, n_b : n_b + n] = V[:, n:]
    rows = 2 * n + 2 * np.arange(p)
    out[rows + 1, n + np.arange(p)] = 1.0  # annihilator of the fake site
    out[rows, n_b + n + np.arange(p)] = 1.0  # its conjugate (creator)
    return out


def _site_modes(Schmidt_bra: SchmidtVectors, Schmidt_ket: SchmidtVectors, mode: str):
    """Bra/ket mode matrices and sets of one site, with the physical-leg
    extension and the vacuum-parity flip (reference pfaffian.py:1492-1719).
    Returns (v_bra, v_ket, sets_bra, sets_ket, fields)."""
    v_bra = Schmidt_bra.mode_vectors(mode)
    assert v_bra is not None, f"`Schmidt_bra` contains no {mode} Schmidt vectors"
    sets_bra = Schmidt_bra.sets(mode)
    v_ket = Schmidt_ket.mode_vectors(mode)
    assert v_ket is not None, f"`Schmidt_ket` contains no {mode} Schmidt vectors"

    p_bra, p_ket = Schmidt_bra.pL, Schmidt_ket.pL
    if (p_bra is None) or (p_ket is None):  # only for mode == "right"
        warnings.warn("\nParity to the left is unknown.\n"
                      "Virtual legs will carry parity to the right!")
        p_bra, p_ket = Schmidt_bra.pR, Schmidt_ket.pR
        qtotal = 0
    elif mode == "right":
        qtotal = (Schmidt_bra.parity() + Schmidt_ket.parity()) % 2
    else:
        qtotal = 0
    q_bra = Schmidt_bra.q_parity(p_bra)
    q_ket = Schmidt_ket.q_parity(p_ket)

    ns_bra = len(sets_bra)
    bra_beta = np.arange(ns_bra)
    bra_phys = None
    v_bra, v_ket = np.asarray(v_bra), np.asarray(v_ket)
    if len(v_bra) + 2 == len(v_ket):
        physical = True
        n = len(v_bra) // 2
        z_col = np.zeros((2 * n, 1), dtype=v_bra.dtype)
        z_row = np.zeros((1, n), dtype=v_bra.dtype)
        one = np.ones((1, 1), dtype=v_bra.dtype)
        zero = np.zeros((1, 1), dtype=v_bra.dtype)
        if mode == "left":
            # bra vacuum parity odd -> sign flip on the physical mode
            up = (-1.0 if Schmidt_bra.parity(mode) % 2 == 1 else 1.0) * one
            v_bra = np.block([[v_bra[:, :n], z_col, v_bra[:, n:], z_col],
                              [z_row, up, z_row, zero],
                              [z_row, zero, z_row, up]])
            sets_bra = np.block([[sets_bra, np.zeros((ns_bra, 1), bool)],
                                 [sets_bra, np.ones((ns_bra, 1), bool)]])
        else:
            v_bra = np.block([[one, z_row, zero, z_row],
                              [zero, z_row, one, z_row],
                              [z_col, v_bra[:, :n], z_col, v_bra[:, n:]]])
            sets_bra = np.block([[np.zeros((ns_bra, 1), bool), sets_bra],
                                 [np.ones((ns_bra, 1), bool), sets_bra]])
        bra_beta = np.concatenate([np.arange(ns_bra), np.arange(ns_bra)])
        bra_phys = np.concatenate([np.zeros(ns_bra, int), np.ones(ns_bra, int)])
    elif len(v_bra) == len(v_ket):
        physical = False
    else:
        raise ValueError(
            f"{mode.capitalize()} sides `Schmidt_bra` and `Schmidt_ket` must match or "
            f"`Schmidt_bra` must be one bond to the {mode} of `Schmidt_ket`, got lengths "
            f"{len(v_bra) // 2} and {len(v_ket) // 2}.")

    # vacua must share parity: if not, particle-hole flip the most entangled
    # bra mode (reference pfaffian.py:1707-1719)
    if Schmidt_bra.parity(mode) % 2 != Schmidt_ket.parity(mode) % 2:
        n = len(v_bra) // 2
        sets_bra = sets_bra.copy()
        if mode == "left":
            perm = np.arange(2 * n)
            perm[[n - 1, 2 * n - 1]] = perm[[2 * n - 1, n - 1]]
            v_bra = v_bra[:, perm]
            sets_bra[:, -1] = ~sets_bra[:, -1]
        else:
            # negate every other Bogoliubov operator and swap the most
            # entangled mode's gamma <-> gamma^dagger
            c0, cn = v_bra[:, n].copy(), v_bra[:, 0].copy()
            v_bra = -v_bra
            v_bra[:, 0], v_bra[:, n] = c0, cn
            sets_bra[:, 0] = ~sets_bra[:, 0]
    fields = dict(mode=mode, physical_leg=physical, bra_beta=bra_beta, bra_phys=bra_phys,
                  q_bra=q_bra, q_ket=q_ket, qtotal=int(qtotal))
    return v_bra, v_ket, sets_bra, Schmidt_ket.sets(mode), fields


def _plan_site(Schmidt_bra: SchmidtVectors, Schmidt_ket: SchmidtVectors, mode: str, *,
               nambu_tolerance: float = 1e-8, min_SV: float = 1e-6) -> dict:
    """Host planning of one site's Bogoliubov overlap (the host half of
    reference pfaffian.py:1258-1410, bucketed as the JAX package's split
    path buckets it).

    Returns a dict with the vacuum-padded annihilator halves ``frames``
    (two (2n_b, n_b) arrays), the active-mode indices ``j1`` (bra
    annihilators, k1_b) and ``j2`` (ket creators, reversed, k2_b), both
    zero-padded to their buckets, the norm guard ``thresh`` =
    max(min_SV^x, 1e-300) with the true half size x, and the
    :class:`MPSTensorData` fields, whose sets now index N's slots
    [ket (k2_b) | bra (k1_b)].  In the checked mode
    (``testing.TEST_ACTION != "pass"``) it also runs the host Nambu checks
    and gives the SVD-based norm ``norm_checked``."""
    mode = mode.lower()
    if mode not in ("left", "right"):
        raise ValueError("mode must be either 'left' or 'right', got " + repr(mode))
    V1, V2, sets1, sets2, fields = _site_modes(Schmidt_bra, Schmidt_ket, mode)
    n, m = V1.shape
    assert n == m > 0 and n % 2 == 0 and V2.shape == (n, m)
    x = n // 2

    def prune(sets, reverse):
        (idx,) = np.nonzero(np.any(sets, axis=0))
        if reverse:
            idx = idx[::-1]
        return sets[:, idx], idx

    active1, active2 = sets1.shape[1], sets2.shape[1]
    sets1, idx1 = prune(sets1, False)  # a modes (bra annihilators)
    sets2, idx2 = prune(sets2, True)  # b-dagger modes (ket creators)
    if mode == "left":  # active modes at the end of the half-basis
        idx1 = idx1 + (x - active1)
        idx2 = idx2 + (x - active2)

    n_b = _bucket(x)
    k1, k2 = len(idx1), len(idx2)
    k1_b, k2_b = _bucket(k1, 8), _bucket(k2, 8)
    j1 = np.zeros(k1_b, np.int32)
    j1[:k1] = idx1
    j2 = np.zeros(k2_b, np.int32)
    j2[:k2] = idx2
    fields["sets_bra"] = np.concatenate(
        (np.zeros((len(sets1), k2_b), bool), sets1, np.zeros((len(sets1), k1_b - k1), bool)),
        axis=1)
    fields["sets_ket"] = np.concatenate(
        (sets2, np.zeros((len(sets2), k2_b - k2), bool), np.zeros((len(sets2), k1_b), bool)),
        axis=1)
    plan = {
        "frames": (np.ascontiguousarray(_pad_nambu_modes(V1, n_b)[:, :n_b]),
                   np.ascontiguousarray(_pad_nambu_modes(V2, n_b)[:, :n_b])),
        "j1": j1,
        "j2": j2,
        "thresh": max(float(min_SV) ** x, 1e-300),
        "fields": fields,
    }
    if testing.TEST_ACTION != "pass":
        with profiling.stage("checks/overlap"):
            plan["norm_checked"] = _check_overlap(V1, V2, idx1, idx2, nambu_tolerance, min_SV)
    return plan


def _check_overlap(V1, V2, idx1, idx2, tolerance, min_SV) -> float:
    """The checked mode's host contracts of reference pfaffian.py:1339-1400:
    Nambu structure of Vr = V1^H V2, the vacuum overlap (all singular values
    of U above ``min_SV``) and the antisymmetry of AA and BB.  Returns the
    Onishi norm from U's singular values."""
    x = V1.shape[0] // 2
    err = "Nambu symmetry violated"
    Vr = HT(V1) @ V2
    assert_allclose(Vr[:x, :x].conj(), Vr[x:, x:], rtol=0, atol=tolerance, err_msg=err)
    assert_allclose(Vr[:x, x:].conj(), Vr[x:, :x], rtol=0, atol=tolerance, err_msg=err)
    s = np.linalg.svd(Vr[:x, :x], compute_uv=False)
    logger.info("Bogoliubov vacuum overlap: %.3e", s.prod())
    assert_array_less(min_SV, s, err_msg="Bogoliubov vacua do not overlap (U nearly singular)")
    Uxinv = np.linalg.inv(Vr[x:, x:])
    AA = Vr[idx1, x:] @ Uxinv[:, idx1]
    BB = Uxinv[idx2, :] @ Vr[x:, idx2]
    assert_allclose(AA, -AA.T, rtol=0, atol=tolerance, err_msg=err)
    assert_allclose(BB, -BB.T, rtol=0, atol=tolerance, err_msg=err)
    return float(s.prod() ** 0.5)


def _overlap_group(plans, device):
    """One ``bdg_overlap`` launch for sites sharing (n_b, k1_b, k2_b);
    returns (N (G, m, m), norm (G,)) on ``device``."""
    def up(a, dtype=None):
        return profiling.to_device(np.stack(a), device, dtype)

    # under a mesh the sites split over its "pairs" axis
    N, norm = _pmesh.map_shards(lambda *a: bdg_overlap(*a),
                                (up([p["frames"][0] for p in plans]),
                                 up([p["frames"][1] for p in plans]),
                                 up([p["j1"] for p in plans]), up([p["j2"] for p in plans]),
                                 up([p["thresh"] for p in plans], torch.float64)))
    if "norm_checked" in plans[0]:
        norm = up([p["norm_checked"] for p in plans], torch.float64)
    return N, norm


def _bucket_shape(shape: tuple) -> tuple:
    """Rounds the chi dimensions of a site-tensor shape up to powers of two
    >= 64 (physical dims <= 4 kept), so that sites of similar size share
    one fill group (one kernel launch)."""
    def b(d):
        return d if d <= 4 else max(64, 1 << (d - 1).bit_length())

    return tuple(b(d) for d in shape)


def _pow2(n: int, lo: int) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


@dataclass(frozen=True)
class MPSTensorData:
    """Implicit description of one MPS tensor of a Pfaffian state
    (reference pfaffian.py:1492-1778): the antisymmetric overlap matrix N
    and the Onishi norm of the site (device tensors), and the host sets
    whose parity-allowed (bra, ket) pairs select the principal
    submatrices of N; each tensor entry is norm * Pf(N[ix, ix]) with
    ix = [ket excitations, bra excitations]."""

    mode: str
    physical_leg: bool
    norm: torch.Tensor  # 0-d float64 device tensor (NaN: vacua do not overlap)
    pfaffian_matrix: torch.Tensor  # (m, m) complex128, antisymmetric
    sets_bra: np.ndarray  # (rows, m) bool incl. leading ket zeros
    sets_ket: np.ndarray  # (cols, m) bool incl. trailing bra zeros
    bra_beta: np.ndarray
    bra_phys: np.ndarray | None
    q_bra: np.ndarray  # Z2 labels per bra bond index
    q_ket: np.ndarray
    qtotal: int

    @classmethod
    def from_schmidt_vectors(cls: Type["MPSTensorData"], Schmidt_bra: SchmidtVectors,
                             Schmidt_ket: SchmidtVectors, mode: str, *,
                             nambu_tolerance: float = 1e-8, min_SV: float = 1e-6,
                             device=None) -> "MPSTensorData":
        """One site's tensor data (reference pfaffian.py:1492-1719): host
        planning, then one ``bdg_overlap`` launch on ``device`` (default
        ``cuda``)."""
        plan = _plan_site(Schmidt_bra, Schmidt_ket, mode, nambu_tolerance=nambu_tolerance,
                          min_SV=min_SV)
        N, norm = _overlap_group([plan], resolve_device(None, device))
        return cls(norm=norm[0], pfaffian_matrix=N[0], **plan["fields"])

    def _plan_fill(self):
        """Host planning of the tensor fill (the host half of reference
        pfaffian.py:1413-1479; the JAX package's ``_pair_values`` packed
        plan).  Returns (shape, q_l, q_r, plan), plan None when no pair
        matches in parity.  The plan holds per-bond excitation position
        tables ``pos_b``/``pos_k`` (R_b rows, the last an all-pad count-0
        row), counts ``cnt_b``/``cnt_k``, (P_b,) pair ids ``pr``/``pc``
        (pad pairs point at the pad rows), the index-row ``width`` and the
        scatter tables ``tabs`` of layout ``spec`` (the pad row routes to
        the trash slot at the bucketed leading dimension), as consumed by
        :func:`temfpy_torch.ops.kernels.pf_fill`."""
        nb, nk = len(self.q_bra), len(self.q_ket)
        if not self.physical_leg:
            shape, q_l, q_r = (nb, nk), self.q_bra, self.q_ket
        elif self.mode == "left":
            shape, q_l, q_r = (nb, 2, nk), self.q_bra, self.q_ket
        else:
            shape, q_l, q_r = (nk, 2, nb), self.q_ket, self.q_bra
        cnt_bra = self.sets_bra.sum(axis=1)
        cnt_ket = self.sets_ket.sum(axis=1)
        rows, cols = [], []
        for p in (0, 1):
            r = np.nonzero(cnt_bra % 2 == p)[0]
            c = np.nonzero(cnt_ket % 2 == p)[0]
            if r.size and c.size:
                rows.append(np.repeat(r, c.size))
                cols.append(np.tile(c, r.size))
        if not rows:
            return shape, q_l, q_r, None
        rows, cols = np.concatenate(rows), np.concatenate(cols)
        P = len(rows)
        P_b = max(256, 1 << int(np.ceil(np.log2(P))))
        width = int(cnt_bra.max() + cnt_ket.max())
        width = max(4, -(-width // 4) * 4)  # bucketed, even

        n_r, n_c = len(cnt_bra), len(cnt_ket)
        R_b = _pow2(max(n_r, n_c) + 1, 32)
        wt = max(1, min(self.sets_bra.shape[1], width))

        def table(sets, cnt):
            pos = np.zeros((R_b, wt), np.int32)
            pos[: len(sets)] = np.argsort(~sets, axis=1, kind="stable")[:, :wt]
            count = np.zeros(R_b, np.int32)
            count[: len(cnt)] = cnt
            return pos, count

        pos_b, cnt_b = table(self.sets_bra, cnt_bra)
        pos_k, cnt_k = table(self.sets_ket, cnt_ket)
        pr = np.full(P_b, R_b - 1, np.int32)
        pr[:P] = rows
        pc = np.full(P_b, R_b - 1, np.int32)
        pc[:P] = cols

        trash = _bucket_shape(shape)[0]
        beta = np.zeros(R_b, np.int32)
        beta[:n_r] = self.bra_beta
        phys = np.zeros(R_b, np.int32)
        if self.physical_leg:
            phys[:n_r] = self.bra_phys
        col = np.zeros(R_b, np.int32)
        col[:n_c] = np.arange(n_c)
        if not self.physical_leg:
            beta[-1] = trash
            spec, tabs = "rc", (beta, col, np.zeros(1, np.int32))
        elif self.mode == "left":
            beta[-1] = trash
            spec, tabs = "rrc", (beta, phys, col)
        else:
            col[-1] = trash
            spec, tabs = "crr", (col, phys, beta)
        plan = {"pos_b": pos_b, "pos_k": pos_k, "cnt_b": cnt_b, "cnt_k": cnt_k, "pr": pr,
                "pc": pc, "width": width, "spec": spec, "tabs": tabs}
        return shape, q_l, q_r, plan

    def resolve_fill(self, shape, T):
        """The bucketed fill ``T`` sliced to the true shape (zeros where
        ``T`` is None: no parity-matching pair)."""
        if T is None:
            return torch.zeros(shape, dtype=self.pfaffian_matrix.dtype,
                               device=self.pfaffian_matrix.device)
        return T[tuple(slice(0, d) for d in shape)]

    def to_dense_tensor(self):
        """The MPS tensor as a dense (chiL, d, chiR) device tensor with Z2
        bond labels: (T, q_l, q_r, qtotal) (reference ``to_npc_array``,
        pfaffian.py:1750-1778)."""
        shape, q_l, q_r, plan = self._plan_fill()
        T = None if plan is None else _fill_group([self], [plan], _bucket_shape(shape))[0]
        return self.resolve_fill(shape, T), q_l, q_r, self.qtotal

    def to_npc_array(self):
        """Reference-named alias of :meth:`to_dense_tensor` (reference
        pfaffian.py:1750-1778 returned a TeNPy npc.Array)."""
        return self.to_dense_tensor()


def _fill_group(datas, plans, shape_b):
    """One ``pf_fill`` launch for sites sharing (width, P_b, table shapes,
    N's size, spec, bucketed shape), site g into slot g of one zeroed
    buffer; returns (G, *shape_b).  Under a mesh the pairs split over its
    "pairs" axis, a launch per shard, each writing its (disjoint) entries
    into the buffer (:func:`temfpy_torch.parallel.mesh.fill_into`)."""
    dev = datas[0].pfaffian_matrix.device

    def up(key):
        return profiling.to_device(np.stack([p[key] for p in plans]), dev)

    tabs = tuple(profiling.to_device(np.stack([p["tabs"][t] for p in plans]), dev)
                 for t in range(3))
    N = torch.stack([d.pfaffian_matrix for d in datas])
    buf = fill_buffer(None, None, len(datas), shape_b, N.dtype, dev)[0]
    _pmesh.fill_into(pf_fill, (N, torch.stack([d.norm for d in datas]), up("pos_b"),
                               up("pos_k"), up("cnt_b"), up("cnt_k"), up("pr"), up("pc"), tabs),
                     (6, 7), buf, range(len(datas)), width=plans[0]["width"],
                     spec=plans[0]["spec"], shape=shape_b)
    return buf[:, : shape_b[0]]


def build_site_tensors(pairs, *, device, nambu_tolerance: float = 1e-8, min_SV: float = 1e-6):
    """Evaluates the MPS tensors of many sites with grouped device work.

    ``pairs`` is a list of (Schmidt_bra, Schmidt_ket, mode).  Sites sharing
    a shape bucket are stacked: the overlap step and the fill each launch
    one kernel per group, not one per site.  Returns [(T, q_l, q_r,
    qtotal)] aligned with ``pairs``."""
    n = len(pairs)
    with profiling.stage("fill/plan"):
        plans = [_plan_site(b, k, m, nambu_tolerance=nambu_tolerance, min_SV=min_SV)
                 for (b, k, m) in pairs]

    # ---- stage 1: grouped Bogoliubov overlap (kernel K4) ----
    groups: dict = {}
    for i, p in enumerate(plans):
        key = (p["frames"][0].shape, len(p["j1"]), len(p["j2"]))
        groups.setdefault(key, []).append(i)
    datas = [None] * n
    with profiling.stage("fill/overlap_groups"):
        for idxs in groups.values():
            N_s, norm_s = _overlap_group([plans[i] for i in idxs], device)
            for g, i in enumerate(idxs):
                datas[i] = MPSTensorData(norm=norm_s[g], pfaffian_matrix=N_s[g],
                                         **plans[i]["fields"])

    # ---- stage 2: grouped pair-Pfaffian fill (kernel K3) ----
    with profiling.stage("fill/plan_fill"):
        fill_plans = [d._plan_fill() for d in datas]
    groups = {}
    for i, (shape, _ql, _qr, plan) in enumerate(fill_plans):
        if plan is None:
            continue
        key = (_bucket_shape(shape), plan["width"], plan["pr"].shape[0], plan["pos_b"].shape,
               plan["spec"], datas[i].pfaffian_matrix.shape[0])
        groups.setdefault(key, []).append(i)
    filled: dict = {}
    with profiling.stage("fill/pf_groups"):
        for key, idxs in groups.items():
            T_s = _fill_group([datas[i] for i in idxs], [fill_plans[i][3] for i in idxs], key[0])
            for T, i in zip(torch.unbind(T_s), idxs):
                filled[i] = T
    out = []
    for i, (shape, q_l, q_r, _plan) in enumerate(fill_plans):
        out.append((datas[i].resolve_fill(shape, filled.get(i)), q_l, q_r, datas[i].qtotal))
    return out


#### ENTRY POINTS ####
#### ------------ ####


@profiling.entry_point
def C_to_MPS(C, trunc_par, *, basis: str, diag_tol: float = _DIAG_TOL,
             ortho_center: int | None = None, unit_cell_width: int | None = None,
             eigh_chunk: int = 32, device=None) -> MPS:
    r"""MPS representation of a Nambu mean-field ground state from its
    correlation matrix (reference pfaffian.py:1785-1921).

    ``C`` (numpy or tensor, basis "M" or "C") runs on ``device`` (default:
    C's device for a tensor, else ``cuda``; ``device="cpu"`` runs the
    kernels' twins).  The centre cut is decomposed first; then each half is
    streamed in blocks of ``eigh_chunk`` cuts: one batched eigh, the
    Schmidt modes and enumeration on the host, and the grouped site
    kernels.  The result is in mixed canonical form 'A' * c + 'B' * (L - c)
    with c = ``ortho_center`` (default L // 2)."""
    with profiling.stage("prepare"):
        trunc_par = to_stopping_condition(trunc_par)
        dev = resolve_device(C, device)
        C = profiling.to_host(C)
        if basis == "C":
            C = matrix_C2M(C)
        elif basis != "M":
            raise ValueError(f"Argument `basis` must be 'M' or 'C', got {basis!r}")
        with profiling.stage("checks/nambu"):
            C = assert_nambu_correlation(C, "M", atol=trunc_par.svd_min**2)
        C_dev = profiling.to_device(np.ascontiguousarray(C), dev)
        L = C.shape[0] // 2
        if unit_cell_width is None:
            unit_cell_width = L
        elif L % unit_cell_width != 0:
            raise ValueError(f"{unit_cell_width = } does not divide system size {L}")

    tensors = [None] * L
    lams = [None] * (L + 1)
    q_bonds = [None] * (L + 1)
    c = ortho_center or L // 2
    logger.info("Central bond %d", c)
    with profiling.stage("centre_cut"):
        Schmidt_center = SchmidtVectors.from_correlation_matrix(C_dev, c, trunc_par, basis="M",
                                                                diag_tol=diag_tol)
        lams[c] = normalize_SV(Schmidt_center.schmidt_values, logger)
        q_bonds[c] = Schmidt_center.q_parity(Schmidt_center.pL)
        total_parity = Schmidt_center.parity()

    def stream_half(cuts, which, sites, bond_of_site):
        Schmidt = Schmidt_center
        sites = list(sites)
        mode = "right" if which == "R" else "left"
        for j0 in range(0, len(cuts), eigh_chunk):
            block = cuts[j0 : j0 + eigh_chunk]
            sizes = [2 * x if which == "L" else 2 * (L - x) for x in block]
            with profiling.stage("eigh_batch"):
                e_all, v_all = eigh_blocks(C_dev, sizes, which)
                e_host = profiling.to_host(e_all)
                v_host = profiling.to_host(v_all)
            pairs = []
            for i, x in enumerate(block):
                s = sizes[i]
                kw = dict(diag_tol=diag_tol, total_parity=total_parity)
                with profiling.stage("schmidt_modes"):
                    if which == "L":
                        modes = SchmidtModes.from_eigh_majorana(
                            C, x, trunc_par, eL=e_host[i, :s], vL_raw=v_host[i, :s, :s], **kw)
                    else:
                        modes = SchmidtModes.from_eigh_majorana(
                            C, x, trunc_par, eR=e_host[i, :s], vR_raw=v_host[i, 2 * x :, :s],
                            **kw)
                with profiling.stage("schmidt_enumeration"):
                    Schmidt_new = SchmidtVectors.from_schmidt_modes(modes, trunc_par)
                b = bond_of_site(sites[j0 + i])
                lams[b] = normalize_SV(Schmidt_new.schmidt_values, logger)
                q_bonds[b] = Schmidt_new.q_parity(Schmidt_new.pL)
                pairs.append((Schmidt_new, Schmidt, mode))
                Schmidt = Schmidt_new
            with profiling.stage("tensor_fill"):
                results = build_site_tensors(pairs, device=dev)
            for i, (T, _ql, _qr, qt) in zip(sites[j0 : j0 + len(block)], results):
                tensors[i] = (T, qt)

    # right half: cuts c+1 .. L, right Schmidt vectors
    stream_half(list(range(c + 1, L + 1)), "R", range(c, L), lambda i: i + 1)
    # left half: cuts c-1 .. 0, left Schmidt vectors
    stream_half(list(range(c - 1, -1, -1)), "L", range(c - 1, -1, -1), lambda i: i)

    # under a mesh over several cards, a tensor the fill left whole is held
    # by every card (:func:`temfpy_torch.parallel.mesh.replicate_site`)
    with profiling.stage("assembly"):
        return MPS([fermion_site] * L, [_pmesh.replicate_site(t) for t, _ in tensors], lams,
                   form=["A"] * c + ["B"] * (L - c), bc="finite",
                   unit_cell_width=unit_cell_width, q_bonds=q_bonds,
                   qtotals=[qt for _, qt in tensors])


def C_to_iMPS(C_short, C_long, trunc_par, sites_per_cell: int, cut: int, *, basis: str,
              diag_tol: float = _DIAG_TOL, unitary_tol: float | None = None,
              schmidt_tol: float | None = None, unit_cell_width: int | None = None,
              device=None):
    r"""iMPS of a Nambu mean-field state from two correlation matrices that
    differ by one repeating unit cell (reference pfaffian.py:1924-2091), on
    ``device`` (default: C_short's device for a tensor, else ``cuda``).

    The cell tensors are the long chain's right-canonical tensors from cut
    to cut + sites_per_cell, the last one closing onto the short chain's
    right Schmidt vectors (so the right-side errors are zero); the gauge
    overlap of the two chains' left Schmidt bases comes from the Pfaffian
    overlap formulas (one :class:`MPSTensorData` across the two chains).
    Returns (iMPS, :class:`temfpy_torch.iMPS.iMPSError`)."""
    from . import iMPS as imps_mod

    trunc_par = to_stopping_condition(trunc_par)
    unitary_tol = imps_mod._UNITARY_TOL if unitary_tol is None else unitary_tol
    schmidt_tol = imps_mod._SCHMIDT_TOL if schmidt_tol is None else schmidt_tol
    dev = resolve_device(C_short, device)
    C_short, C_long = profiling.to_host(C_short), profiling.to_host(C_long)
    if basis == "C":
        C_short, C_long = matrix_C2M(C_short), matrix_C2M(C_long)
    elif basis != "M":
        raise ValueError(f"Argument `basis` must be 'M' or 'C', got {basis!r}")
    tol = trunc_par.svd_min**2
    C_short = assert_nambu_correlation(C_short, "M", atol=tol)
    C_long = assert_nambu_correlation(C_long, "M", atol=tol)
    L_short, L_long = C_short.shape[0] // 2, C_long.shape[0] // 2
    if L_short + sites_per_cell != L_long:
        raise ValueError("The given two systems must differ by one unit cell, got "
                         f"{L_long} - {L_short} != {sites_per_cell}")
    if unit_cell_width is None:
        unit_cell_width = sites_per_cell
    elif sites_per_cell % unit_cell_width != 0:
        raise ValueError(f"{unit_cell_width = } does not divide {sites_per_cell = }")
    C_short = profiling.to_device(np.ascontiguousarray(C_short), dev)
    C_long = profiling.to_device(np.ascontiguousarray(C_long), dev)

    Schmidt_short = SchmidtVectors.from_correlation_matrix(C_short, cut, trunc_par, basis="M",
                                                           diag_tol=diag_tol)
    Schmidt_long = SchmidtVectors.from_correlation_matrix(C_long, cut, trunc_par, basis="M",
                                                          diag_tol=diag_tol)
    total_parity = Schmidt_long.parity()
    lams = [normalize_SV(Schmidt_short.schmidt_values, logger)]
    q_bonds = [Schmidt_short.q_parity(Schmidt_short.pL)]
    pairs = []
    Schmidt = Schmidt_long
    for i in range(sites_per_cell):
        if i == sites_per_cell - 1:
            Schmidt_new = Schmidt_short
            lams.append(lams[0])
            q_bonds.append(q_bonds[0])
        else:
            Schmidt_new = SchmidtVectors.from_correlation_matrix(
                C_long, cut + i + 1, trunc_par, which="R", basis="M", diag_tol=diag_tol,
                total_parity=total_parity)
            lams.append(normalize_SV(Schmidt_new.schmidt_values, logger))
            q_bonds.append(Schmidt_new.q_parity(Schmidt_new.pL))
        pairs.append((Schmidt_new, Schmidt, "right"))
        Schmidt = Schmidt_new
    with profiling.stage("tensor_fill"):
        results = build_site_tensors(pairs, device=dev)
    tensors = [T for T, _ql, _qr, _qt in results]
    qts = [qt for _T, _ql, _qr, qt in results]

    # gauge-fix the first tensor
    with profiling.stage("tensor_fill"):
        Cmat, q_bra, q_ket, _qt = MPSTensorData.from_schmidt_vectors(
            Schmidt_short, Schmidt_long, "left", device=dev).to_dense_tensor()
    Cmat, left_unitary, left_schmidt = imps_mod.basis_rotation(
        Cmat, normalize_SV(Schmidt_short.schmidt_values), normalize_SV(Schmidt_long.schmidt_values),
        mode="left", q_bra=q_bra, q_ket=q_ket, chinfo=fermion_site.chinfo,
        unitary_tol=unitary_tol, schmidt_tol=schmidt_tol)
    tensors[0] = torch.einsum("ab,bnc->anc", Cmat, tensors[0])
    imps = MPS([fermion_site] * sites_per_cell, tensors, lams, form="B", bc="infinite",
               unit_cell_width=unit_cell_width, q_bonds=q_bonds, qtotals=qts)
    return imps, imps_mod.iMPSError(left_unitary, left_schmidt, 0.0, 0.0)


def H_to_iMPS(H_short, H_long, trunc_par, sites_per_cell: int, cut: int, *, basis: str,
              diag_tol: float = _DIAG_TOL, unitary_tol: float | None = None,
              schmidt_tol: float | None = None, unit_cell_width: int | None = None,
              device=None):
    r"""iMPS of a Nambu mean-field state from two BdG Hamiltonians that
    differ by one unit cell (reference pfaffian.py:2151-2243), on
    ``device`` (see :func:`C_to_iMPS`)."""
    dev = resolve_device(H_short, device)
    C_short = correlation_matrix(H_short, basis=f"{basis}->{basis}", device=dev)
    C_long = correlation_matrix(H_long, basis=f"{basis}->{basis}", device=dev)
    return C_to_iMPS(C_short, C_long, trunc_par, sites_per_cell, cut, basis=basis,
                     diag_tol=diag_tol, unitary_tol=unitary_tol, schmidt_tol=schmidt_tol,
                     unit_cell_width=unit_cell_width, device=dev)


@profiling.entry_point
def H_to_MPS(H, trunc_par, *, basis: str, diag_tol: float = _DIAG_TOL,
             ortho_center: int | None = None, unit_cell_width: int | None = None,
             eigh_chunk: int = 32, device=None) -> MPS:
    r"""MPS of the ground state of a BdG single-particle Hamiltonian
    (reference pfaffian.py:2094-2148), on ``device`` (see
    :func:`C_to_MPS`)."""
    dev = resolve_device(H, device)
    C = correlation_matrix(H, basis=f"{basis}->{basis}", device=dev)
    return C_to_MPS(C, trunc_par, basis=basis, diag_tol=diag_tol, ortho_center=ortho_center,
                    unit_cell_width=unit_cell_width, eigh_chunk=eigh_chunk, device=dev)
