"""Charge-resolved factorizations of dense charge-labelled matrices
(counterpart of :mod:`temfpy_tpu.mps.charged_linalg`).

A matrix whose rows carry charges ``q_row`` and columns ``q_col`` and whose
nonzeros satisfy ``q_row == q_col + qtotal`` is block diagonal after
grouping indices by charge.  These helpers factor it sector by sector on
the matrix's device and reassemble the factors with
charge labels on the new bond.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.linalg import robust_eigh, robust_qr, robust_svd
from .charges import ChargeInfo


def _common_sectors(chinfo: ChargeInfo, q_row, q_col, qtotal: int):
    """(charge, rows, cols) of every sector linked by q_row == q_col + qtotal."""
    q_row = chinfo.make_valid(q_row)
    q_col_eff = chinfo.make_valid(np.asarray(q_col, np.int64) + qtotal)
    sectors = []
    for q in np.unique(np.concatenate([q_row, q_col_eff])):
        rows = np.nonzero(q_row == q)[0]
        cols = np.nonzero(q_col_eff == q)[0]
        if rows.size and cols.size:
            sectors.append((int(q), rows, cols))
    return sectors


def _block(M: torch.Tensor, rows: np.ndarray, cols: np.ndarray) -> torch.Tensor:
    r = torch.as_tensor(rows, device=M.device)
    c = torch.as_tensor(cols, device=M.device)
    return M[r[:, None], c[None, :]]


def charged_svd(M: torch.Tensor, q_row, q_col, chinfo: ChargeInfo, qtotal: int = 0, *,
                cutoff: float | None = None, chi_max: int | None = None,
                normalize: bool = False):
    """Charge-resolved SVD ``M = U diag(S) Vh`` with optional truncation.

    ``cutoff`` discards singular values below ``cutoff * max(S)``;
    ``chi_max`` keeps at most that many (globally, largest first; ties at
    the threshold are all kept); ``normalize`` rescales the kept values to
    unit norm.  Returns ``(U, S, Vh, q_mid, err)``: ``S`` host numpy sorted
    by (charge, descending value), ``q_mid`` the new bond's labels in
    column-charge convention, ``err`` the discarded weight sum(S^2).
    """
    m, n = M.shape
    sectors = _common_sectors(chinfo, q_row, q_col, qtotal)
    if not sectors:
        raise ValueError("Matrix has no charge-compatible sectors (all zero?)")
    q_col_valid = chinfo.make_valid(np.asarray(q_col))
    blocks = []
    for _q, rows, cols in sectors:
        Ub, Sb, Vhb = robust_svd(_block(M, rows, cols))
        blocks.append((int(q_col_valid[cols[0]]), rows, cols, Ub, Sb.cpu().numpy(), Vhb))
    svals = np.concatenate([b[4] for b in blocks])
    keep_thresh = 0.0
    if cutoff is not None and svals.size:
        keep_thresh = cutoff * svals.max()
    if chi_max is not None and svals.size > chi_max:
        keep_thresh = max(keep_thresh, float(np.sort(svals)[::-1][chi_max - 1]))
    # no truncation requested: keep every triplet (square inputs stay square)
    keep_all = cutoff is None and chi_max is None

    parts, S_parts, q_mid = [], [], []
    err = 0.0
    for qc, rows, cols, Ub, Sb, Vhb in blocks:
        keep = np.ones(Sb.shape, bool) if keep_all else Sb >= max(keep_thresh, 1e-300)
        err += float((Sb[~keep] ** 2).sum())
        k = int(keep.sum())
        if k == 0:
            continue
        parts.append((rows, cols, Ub[:, :k], Vhb[:k, :], k))
        S_parts.append(Sb[:k])
        q_mid.append(np.full(k, qc, dtype=np.int64))
    if not S_parts:
        raise ValueError("All singular values truncated away")
    S = np.concatenate(S_parts)
    q_mid = np.concatenate(q_mid)
    if normalize and S.size:
        S = S / np.linalg.norm(S)
    ktot = len(S)
    U = torch.zeros((m, ktot), dtype=M.dtype, device=M.device)
    Vh = torch.zeros((ktot, n), dtype=M.dtype, device=M.device)
    off = 0
    for rows, cols, Ub, Vhb, k in parts:
        ks = np.arange(off, off + k)
        U[torch.as_tensor(rows, device=M.device)[:, None],
          torch.as_tensor(ks, device=M.device)[None, :]] = Ub
        Vh[torch.as_tensor(ks, device=M.device)[:, None],
           torch.as_tensor(cols, device=M.device)[None, :]] = Vhb
        off += k
    return U, S, Vh, q_mid, err


def charged_qr(M: torch.Tensor, q_row, q_col, chinfo: ChargeInfo, qtotal: int = 0):
    """Charge-resolved thin QR ``M = Q R``; returns ``(Q, R, q_mid)`` with
    the conventions of :func:`charged_svd`."""
    m, n = M.shape
    sectors = _common_sectors(chinfo, q_row, q_col, qtotal)
    if not sectors:
        raise ValueError("Matrix has no charge-compatible sectors (all zero?)")
    q_col_valid = chinfo.make_valid(np.asarray(q_col))
    parts = []
    for _q, rows, cols in sectors:
        Qb, Rb = robust_qr(_block(M, rows, cols))
        parts.append((rows, cols, Qb, Rb, int(q_col_valid[cols[0]])))
    ktot = sum(p[2].shape[1] for p in parts)
    Q = torch.zeros((m, ktot), dtype=M.dtype, device=M.device)
    R = torch.zeros((ktot, n), dtype=M.dtype, device=M.device)
    q_mid = np.empty(ktot, dtype=np.int64)
    off = 0
    for rows, cols, Qb, Rb, qc in parts:
        k = Qb.shape[1]
        ks = torch.arange(off, off + k, device=M.device)
        Q[torch.as_tensor(rows, device=M.device)[:, None], ks[None, :]] = Qb
        R[ks[:, None], torch.as_tensor(cols, device=M.device)[None, :]] = Rb
        q_mid[off : off + k] = qc
        off += k
    return Q, R, q_mid


def charged_eigh(rho: torch.Tensor, q, chinfo: ChargeInfo):
    """Hermitian eigendecomposition of a charge-block-diagonal matrix, sector
    by sector on ``rho``'s device.

    Returns ``(e, U, q_cols)``: host eigenvalues ascending within each
    sector, sectors in ascending charge order; ``U`` (a tensor like
    ``rho``) has its columns labelled by ``q_cols``.
    """
    q = chinfo.make_valid(q)
    n = rho.shape[0]
    e = np.empty(n, dtype=float)
    U = torch.zeros_like(rho)
    q_cols = np.empty(n, dtype=np.int64)
    off = 0
    for qv in np.unique(q):
        idx = np.nonzero(q == qv)[0]
        eb, ub = robust_eigh(_block(rho, idx, idx))
        k = len(idx)
        e[off : off + k] = eb.cpu().numpy()
        U[torch.as_tensor(idx, device=rho.device)[:, None],
          torch.arange(off, off + k, device=rho.device)[None, :]] = ub
        q_cols[off : off + k] = qv
        off += k
    return e, U, q_cols

