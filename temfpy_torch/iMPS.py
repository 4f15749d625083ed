r"""Finite -> infinite MPS conversion and gauge fixing, on PyTorch.

Counterpart of :mod:`temfpy_tpu.iMPS` (reference ``temfpy/iMPS.py``):
Schmidt-vector overlaps between two chains that differ by one unit cell,
orthogonal-Procrustes gauge rotations with their unitarity and
Schmidt-mixing errors, and the ``MPS_to_iMPS`` conversion.

Conventions: overlap matrices are dense tensors on the bra's device with
rows = bra (shorter chain) and columns = ket (longer chain) Schmidt bases,
for the left and the right environment alike; the caller transposes for a
right-side application (the reference keeps the same information in npc leg
labels, iMPS.py:21-62).
"""

from __future__ import annotations

import logging
import warnings
from typing import NamedTuple

import numpy as np
import torch

from .config import NUMERICAL_TOL as _NUMERICAL_TOL
from .config import SCHMIDT_TOL as _SCHMIDT_TOL
from .config import UNITARY_TOL as _UNITARY_TOL
from .mps import MPS
from .mps.charged_linalg import charged_svd
from .ops.linalg import robust_svd
from .testing import assert_array_less

logger = logging.getLogger(__name__)


def overlap_schmidt(bra: MPS, ket: MPS, mode: str, n_sites: int | None = None) -> torch.Tensor:
    r"""Overlap matrix of the left (right) Schmidt vectors of two finite MPS
    (reference iMPS.py:21-62), on the bra's device.

    mode "left": the first ``n_sites`` sites in left-canonical form; returns
    C with C[a, b] = <L'_a | L_b> (bra rows).  mode "right": the last
    ``n_sites`` sites in right-canonical form; returns D with
    D[a, b] = <R'_a | R_b> (bra rows)."""
    mode = mode.lower()
    if mode not in ("left", "right"):
        raise ValueError("`mode` must be either 'left' or 'right', got " + repr(mode))
    n = n_sites if n_sites is not None else min(bra.L, ket.L)
    dev = bra.device
    dtype = torch.promote_types(bra._B[0].dtype, ket._B[0].dtype)
    E = torch.ones((1, 1), dtype=dtype, device=dev)
    for step in range(n):
        if mode == "left":
            Tb, Tk = bra.get_B(step, "A"), ket.get_B(step, "A")
            E = torch.einsum("ab,anc,bnd->cd", E, Tb.conj().to(dtype), Tk.to(dev, dtype))
        else:
            Tb, Tk = bra.get_B(bra.L - 1 - step, "B"), ket.get_B(ket.L - 1 - step, "B")
            E = torch.einsum("cd,anc,bnd->ab", E, Tb.conj().to(dtype), Tk.to(dev, dtype))
    return E


def infer_qtotal(M, q_row, q_col, chinfo) -> int:
    """Tensor charge of a charge-conserving matrix, read off at its largest
    entry: qtotal = q_row - q_col there (rule: q_row == q_col + qtotal)."""
    A = M.abs() if isinstance(M, torch.Tensor) else np.abs(np.asarray(M))
    i, j = np.unravel_index(int(A.argmax()), tuple(A.shape))
    return int(chinfo.make_valid(int(q_row[i]) - int(q_col[j])))


def basis_rotation(overlap, Schmidt_bra: np.ndarray, Schmidt_ket: np.ndarray, mode: str, *,
                   form: str = "B", q_bra=None, q_ket=None, chinfo=None,
                   qtotal: int | None = None, numerical_tol: float = _NUMERICAL_TOL,
                   unitary_tol: float = _UNITARY_TOL, schmidt_tol: float = _SCHMIDT_TOL):
    r"""Optimal unitary gauge rotation between two Schmidt bases
    (reference iMPS.py:65-192).

    ``overlap`` (a tensor or an array) has bra rows and ket columns, on
    either environment side.  Returns (rotation, unitary_error,
    schmidt_error); the rotation is a tensor on the overlap's device with
    the input's row/column meaning.  With charge labels (``q_bra``,
    ``q_ket``, ``chinfo``) the Procrustes SVD runs sector by sector, which
    keeps the block structure exact."""
    mode = mode.lower()
    if mode not in ("left", "right"):
        raise ValueError(f"`mode` must be 'left' or 'right', got {mode!r}")
    form = form.upper()
    if form not in ("A", "B"):
        raise ValueError(f"`form` must be 'A' or 'B', got {form!r}")
    C = overlap if isinstance(overlap, torch.Tensor) else torch.as_tensor(np.asarray(overlap))
    S_bra = torch.as_tensor(np.asarray(Schmidt_bra, float), device=C.device)
    S_ket = torch.as_tensor(np.asarray(Schmidt_ket, float), device=C.device)

    C_Sk = C * S_ket[None, :]
    unitary_error_sq = float((S_ket**2).sum()) - float((C_Sk.conj() * C_Sk).real.sum())
    if unitary_error_sq < 0:
        err_msg = (f"{mode.capitalize()} deviation from unitary: the square of the unitary "
                   f"error {unitary_error_sq} is negative and exceeds the numerical tolerance "
                   f"{numerical_tol:.1e}.")
        assert_array_less(abs(unitary_error_sq), numerical_tol, err_msg)
        unitary_error = 0.0
    else:
        unitary_error = float(np.sqrt(unitary_error_sq))
    logger.info("%s deviation from unitary: %.4e", mode.capitalize(), unitary_error)
    if unitary_error > unitary_tol:
        warnings.warn(f"\n{mode.capitalize()} overlap matrix deviates from unitarity by "
                      f"{unitary_error}.\nIncreasing the bond dimension may be useful.")

    # orthogonal Procrustes: the closest unitary
    bra_side = (mode, form) in (("left", "A"), ("right", "B"))
    M = S_bra[:, None] * C_Sk if bra_side else C_Sk * S_ket[None, :]
    if q_bra is not None and q_ket is not None and chinfo is not None:
        if qtotal is None:
            qtotal = infer_qtotal(M, q_bra, q_ket, chinfo)
        U, _S, Vh, _q, _err = charged_svd(M, q_bra, q_ket, chinfo, qtotal=qtotal)
    else:
        U, _S, Vh = robust_svd(M)
    rotation = U @ Vh

    Sb_C = S_bra[:, None] * rotation if bra_side else rotation * S_ket[None, :]
    schmidt_error = float(torch.linalg.norm(Sb_C - C_Sk))
    logger.info("%s Schmidt value mixing:   %.4e", mode.capitalize(), schmidt_error)
    if schmidt_error > schmidt_tol:
        warnings.warn(f"\nMixing between unequal Schmidt value sectors on the {mode} side is\n"
                      f"{schmidt_error}. Increasing the number of sites may help.")
    return rotation, unitary_error, schmidt_error


class iMPSError(NamedTuple):
    """Approximation errors of a finite -> infinite MPS conversion
    (reference iMPS.py:195-230)."""

    left_unitary: float
    left_schmidt: float
    right_unitary: float
    right_schmidt: float

    @property
    def left_total(self) -> float:
        return (self.left_schmidt**2 + self.left_unitary**2) ** 0.5

    @property
    def right_total(self) -> float:
        return (self.right_schmidt**2 + self.right_unitary**2) ** 0.5

    @property
    def total_error(self) -> float:
        return float(np.linalg.norm(self))

    def __repr__(self) -> str:
        fields = [f"    {f}={x:.8e}" for f, x in zip(self._fields, self) if x != 0]
        if not fields:
            return "iMPSError()"
        return "iMPSError(\n" + ",\n".join(fields) + "\n)"


def _guess_offsets(mps_short: MPS, cut: int, offset) -> int:
    """Charge offset: 0 for Z_N charges, the rounded S^2-weighted mean of
    the bond labels for U(1) (reference iMPS.py:359-381)."""
    if isinstance(offset, (int, np.integer)):
        return int(offset)
    if offset == "auto":
        if mps_short.chinfo.mod != 1:
            return 0
        S0 = mps_short.get_SL(cut)
        return int(round(float((S0**2) @ mps_short.q_bond[cut])))
    raise TypeError(f"Expected integer or 'auto' as offset, got {offset!r}")


def MPS_to_iMPS(mps_short: MPS, mps_long: MPS, sites_per_cell: int, cut: int,
                unitary_tol: float = _UNITARY_TOL, schmidt_tol: float = _SCHMIDT_TOL,
                offset="auto", unit_cell_width: int | None = None) -> tuple[MPS, iMPSError]:
    r"""An iMPS from two finite MPS that differ by one repeating unit cell
    (reference iMPS.py:233-441), on the short chain's device.

    The cell is taken from the longer chain; its gauge is fixed by matching
    its left and right environments to the Schmidt bases of the shorter
    chain (Procrustes)."""
    L_short, L_long = mps_short.L, mps_long.L
    if L_short + sites_per_cell != L_long:
        raise ValueError("The given two MPS must differ by one unit cell, got "
                         f"{L_long} - {L_short} != {sites_per_cell}")
    if mps_short.chinfo != mps_long.chinfo:
        raise ValueError("Incompatible ChargeInfo in the two MPS")
    for name, m in (("mps_short", mps_short), ("mps_long", mps_long)):
        if any(f is None for f in m.form):
            raise ValueError(f"{name} is not canonical")

    # cylinder-width bookkeeping (reference iMPS.py:322-352)
    if unit_cell_width is None:
        cyl1 = mps_short.L // mps_short.unit_cell_width
        cyl2 = mps_long.L // mps_long.unit_cell_width
        if cyl1 != cyl2:
            warnings.warn(f"Unequal cylinder circumferences {cyl1}, {cyl2},\n"
                          "discard `unit_cell_width` of input MPS")
            cyl1 = 1
        if cut % max(cyl1, 1) != 0:
            warnings.warn(f"{cut = } not divisible into cylinder circumference {cyl1},\n"
                          "discard `unit_cell_width` of input MPS")
            cyl1 = 1
        unit_cell_width = sites_per_cell // cyl1
    else:
        if sites_per_cell % unit_cell_width:
            raise ValueError(f"{unit_cell_width = } does not divide {sites_per_cell = }")
        if cut % (sites_per_cell // unit_cell_width):
            raise ValueError(f"{cut = } not divisible into requested cylinder circumference "
                             f"{sites_per_cell // unit_cell_width}")

    chinfo = mps_short.chinfo
    S0 = mps_short.get_SL(cut)
    offset = _guess_offsets(mps_short, cut, offset)
    logger.info("Using charge offset %s", offset)

    # ---- left gauge rotation ----
    C = overlap_schmidt(mps_short, mps_long, "left", n_sites=cut)
    C, left_unitary, left_schmidt = basis_rotation(
        C, S0, mps_long.get_SL(cut), mode="left", q_bra=mps_short.q_bond[cut],
        q_ket=mps_long.q_bond[cut], chinfo=chinfo, unitary_tol=unitary_tol,
        schmidt_tol=schmidt_tol)

    # ---- right gauge rotation ----
    D = overlap_schmidt(mps_short, mps_long, "right", n_sites=L_short - cut)
    # per-cell charge: the two right bases describe the same states, but
    # their "charge to the left" labels differ by one unit cell's charge
    q_cell = -infer_qtotal(D, mps_short.q_bond[cut], mps_long.q_bond[cut + sites_per_cell],
                           chinfo)
    D, right_unitary, right_schmidt = basis_rotation(
        D, S0, mps_long.get_SL(cut + sites_per_cell), mode="right",
        q_bra=mps_short.q_bond[cut], q_ket=mps_long.q_bond[cut + sites_per_cell],
        chinfo=chinfo, unitary_tol=unitary_tol, schmidt_tol=schmidt_tol)

    # ---- the unit cell in right-canonical form, gauge-fixed at its edges ----
    dev = mps_short.device
    tensors = [mps_long.get_B(cut + i, "B").to(dev) for i in range(sites_per_cell)]
    tensors[0] = torch.einsum("ab,bnc->anc", C, tensors[0].to(C.dtype))
    # new right coefficient: T'[.., a] = sum_b T[.., b] <R'_a | R_b>
    tensors[-1] = torch.einsum("anb,cb->anc", tensors[-1].to(D.dtype), D)
    svs = [S0] + [mps_long._S[cut + i] for i in range(1, sites_per_cell)] + [S0]
    qts = list(mps_long.qtotal[cut : cut + sites_per_cell])

    # outer bonds take the short chain's labels, interior ones the long
    # chain's, all less the offset; the per-cell charge goes to the last
    # tensor's qtotal, so the wrap bond has the same labels at both ends
    q0 = chinfo.make_valid(mps_short.q_bond[cut] - offset)
    q_bonds = ([q0] + [chinfo.make_valid(mps_long.q_bond[cut + i] - offset)
                       for i in range(1, sites_per_cell)] + [q0])
    qts[-1] = int(chinfo.make_valid(qts[-1] + q_cell))
    imps = MPS(mps_long.sites[cut : cut + sites_per_cell], tensors, svs, form="B",
               bc="infinite", unit_cell_width=unit_cell_width, q_bonds=q_bonds, qtotals=qts)
    return imps, iMPSError(left_unitary, left_schmidt, right_unitary, right_schmidt)
