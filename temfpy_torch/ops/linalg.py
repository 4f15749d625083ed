"""Batched dense linear algebra of the Slater -> MPS path, in plain PyTorch.

Counterpart of the main-path subset of :mod:`temfpy_tpu.ops.linalg`:

- :func:`eigh_blocks`: eigendecompositions of many leading/trailing
  principal blocks of a Hermitian matrix in one batched, padded ``eigh``;
- :func:`block_svd`: completion of an SVD known up to rotations inside
  degenerate blocks;
- :func:`lu_det` and :func:`gauss_solve_det`: LU / Gauss-Jordan with partial
  pivoting, written out step by step.  They are the plain twins of the CUDA
  kernels in :mod:`temfpy_torch.ops.kernels` and follow the JAX package's
  batch-first bodies (``_lu_det_body``, the explicit branch of
  ``gauss_solve_det``) pivot for pivot.

Not ported (TPU workarounds): the host-eigh routing (``_eigh_blocks_host``,
``_use_host_eigh``, ``_back_like``), the batch-last layouts with implicit
pivoting (``_lu_det_batch_last``, ``_gauss_solve_det_implicit``), the
one-hot MXU selection (``_onehot_select``, ``_split_f32``) and the mesh
branch of ``eigh_blocks``.
"""

from __future__ import annotations

import numpy as np
import torch

_PAD_EIGENVALUE = 2.0  # outside [0, 1], the spectrum of any correlation block


# --------------------------------------------------------------------------
# Padded batched eigendecomposition of principal blocks
# --------------------------------------------------------------------------


def _eigh_blocks_impl(C: torch.Tensor, sizes: torch.Tensor, side: str):
    L = C.shape[-1]
    idx = torch.arange(L, device=C.device)
    row = idx.view(1, L, 1)
    col = idx.view(1, 1, L)
    x = sizes.view(-1, 1, 1)
    if side == "L":
        keep = (row < x) & (col < x)
        pad_diag = idx.view(1, L) >= sizes.view(-1, 1)
    else:  # trailing blocks C[L-size:, L-size:]
        keep = (row >= L - x) & (col >= L - x)
        pad_diag = idx.view(1, L) < (L - sizes.view(-1, 1))
    P = torch.where(keep, C.unsqueeze(0), torch.zeros((), dtype=C.dtype, device=C.device))
    diag = torch.where(pad_diag, _PAD_EIGENVALUE, 0.0).to(C.dtype)
    P = P + torch.diag_embed(diag)
    return torch.linalg.eigh(P)


def eigh_blocks(C: torch.Tensor, sizes, side: str = "L", chunk: int | None = None):
    """Eigendecompositions of many principal blocks of a Hermitian matrix.

    ``C`` is an (L, L) Hermitian tensor (a correlation matrix: spectrum in
    [0, 1]).  ``sizes`` lists block sizes ``x``; ``side`` "L" takes the
    leading blocks ``C[:x, :x]``, "R" the trailing ``C[-x:, -x:]``.  Each
    block is embedded in an (L, L) matrix whose other diagonal entries are
    2.0, so one batched ``torch.linalg.eigh`` serves every cut.

    Returns ``e`` (ncuts, L) ascending eigenvalues (the first ``x`` per row
    belong to the block, the rest are 2.0) and ``v`` (ncuts, L, L)
    eigenvector columns, whose block vectors live in coordinates 0..x-1
    (side "L") or L-x..L-1 (side "R").  ``chunk`` bounds the batch per
    ``eigh`` call.
    """
    if side not in ("L", "R"):
        raise ValueError(f"side must be 'L' or 'R', got {side!r}")
    sizes = torch.as_tensor(np.asarray(sizes, np.int64), device=C.device)
    n = sizes.shape[0]
    if chunk is None or n <= chunk:
        return _eigh_blocks_impl(C, sizes, side)
    es, vs = [], []
    for i in range(0, n, chunk):
        e, v = _eigh_blocks_impl(C, sizes[i : i + chunk], side)
        es.append(e)
        vs.append(v)
    return torch.cat(es), torch.cat(vs)


def robust_eigh(A: torch.Tensor):
    """``torch.linalg.eigh`` (the JAX package routes this to host LAPACK on
    the TPU, whose eigh is inaccurate on degenerate spectra)."""
    return torch.linalg.eigh(A)


def robust_svd(A: torch.Tensor, full_matrices: bool = False):
    """``torch.linalg.svd`` (reduced by default)."""
    return torch.linalg.svd(A, full_matrices=full_matrices)


def robust_qr(A: torch.Tensor):
    """Reduced ``torch.linalg.qr``."""
    return torch.linalg.qr(A, mode="reduced")


# --------------------------------------------------------------------------
# LU / Gauss-Jordan with partial pivoting (plain twins of the CUDA kernels)
# --------------------------------------------------------------------------


def lu_det(A: torch.Tensor) -> torch.Tensor:
    """Determinants of a (..., n, n) batch by LU with partial pivoting.

    Step k picks the first row of maximal ``|A[i, k]|`` among i >= k, swaps
    it into place, multiplies the running determinant by the pivot (and by
    -1 for a swap) and eliminates below it; a zero pivot gives det 0 without
    dividing by it.  This is ``temfpy_tpu.ops.linalg._lu_det_body``
    vectorised over the batch, and the arithmetic the ``det_fill`` kernel
    runs per pair.
    """
    *batch, n, m = A.shape
    if n != m:
        raise ValueError(f"lu_det needs square matrices, got {tuple(A.shape)}")
    if n == 0:
        return torch.ones(tuple(batch), dtype=A.dtype, device=A.device)
    F = A.reshape(-1, n, n).clone()
    P = F.shape[0]
    ar = torch.arange(P, device=A.device)
    det = torch.ones(P, dtype=A.dtype, device=A.device)
    one = torch.ones((), dtype=A.dtype, device=A.device)
    for k in range(n):
        p = k + torch.argmax(F[:, k:, k].abs(), dim=1)
        row_k = F[:, k, :].clone()
        F[:, k, :] = F[ar, p, :]
        F[ar, p, :] = row_k
        det = torch.where(p != k, -det, det)
        piv = F[:, k, k]
        det = det * piv
        safe = torch.where(piv == 0, one, piv)
        f = F[:, k + 1 :, k] / safe[:, None]
        F[:, k + 1 :, :] -= f[:, :, None] * F[:, k : k + 1, :]
    return det.reshape(tuple(batch))


def gauss_solve_det(A: torch.Tensor, B: torch.Tensor):
    """``(det(A), A^{-1} B)`` for (..., n, n) ``A`` and (..., n, r) ``B`` by
    Gauss-Jordan with partial pivoting (``temfpy_tpu.ops.linalg.
    gauss_solve_det``, explicit-swap branch, vectorised over the batch).
    A zero pivot gives det 0 and leaves its row unscaled."""
    *batch, n, _ = A.shape
    if n == 0:
        return torch.ones(tuple(batch), dtype=A.dtype, device=A.device), B
    r = B.shape[-1]
    M = torch.cat([A, B.to(A.dtype)], dim=-1).reshape(-1, n, n + r).clone()
    P = M.shape[0]
    ar = torch.arange(P, device=A.device)
    det = torch.ones(P, dtype=A.dtype, device=A.device)
    one = torch.ones((), dtype=A.dtype, device=A.device)
    notk = torch.ones(n, dtype=torch.bool, device=A.device)
    for k in range(n):
        p = k + torch.argmax(M[:, k:, k].abs(), dim=1)
        row_k = M[:, k, :].clone()
        M[:, k, :] = M[ar, p, :]
        M[ar, p, :] = row_k
        det = torch.where(p != k, -det, det)
        piv = M[:, k, k]
        det = det * piv
        safe = torch.where(piv == 0, one, piv)
        row = M[:, k, :] / safe[:, None]
        notk[:] = True
        notk[k] = False
        factors = M[:, :, k] * notk.to(M.dtype)
        M -= factors[:, :, None] * row[:, None, :]
        M[:, k, :] = row
    return det.reshape(tuple(batch)), M[:, :, n:].reshape(*batch, n, r)


# --------------------------------------------------------------------------
# Identity padding and submatrix gathers
# --------------------------------------------------------------------------


def block_diag_identity_pad(M: torch.Tensor, pad: int) -> torch.Tensor:
    """``block_diag(M, I_pad)`` over the trailing two axes: the identity
    extension that embeds k x k determinant problems into larger ones
    without changing the determinant."""
    m = M.shape[-1]
    out = torch.zeros(M.shape[:-2] + (m + pad, m + pad), dtype=M.dtype, device=M.device)
    out[..., :m, :m] = M
    out[..., m:, m:] = torch.eye(pad, dtype=M.dtype, device=M.device)
    return out


def gather_submatrices(M: torch.Tensor, idx_b: torch.Tensor, idx_k: torch.Tensor,
                       cross: bool = False) -> torch.Tensor:
    """``M[idx_b[..., :, None], idx_k[..., None, :]]``: paired rows giving
    (P, w, w) (``cross=False``), or all row/col-list pairs giving
    (nb, nk, w, w) (``cross=True``)."""
    idx_b = idx_b.long()
    idx_k = idx_k.long()
    if cross:
        return M[idx_b[:, None, :, None], idx_k[None, :, None, :]]
    return M[idx_b[:, :, None], idx_k[:, None, :]]


# --------------------------------------------------------------------------
# Degenerate-block SVD completion
# --------------------------------------------------------------------------


def block_svd(CLR: torch.Tensor, vL: torch.Tensor, vR: torch.Tensor, e,
              degeneracy_tol: float = 1e-12):
    r"""Completes an SVD of ``CLR`` whose singular vectors ``vL``/``vR`` are
    known only up to rotations within degenerate blocks of ``e``
    (reference utils.py:19-96; :func:`temfpy_tpu.ops.linalg.block_svd`).

    ``vL^H CLR vR`` is block diagonal with blocks delimited by runs of
    approximately equal entries of ``e``; the blocks of each multiplicity
    are SVD'd as one batch and the rotations applied.  Returns new
    ``(vL, vR)``; the inputs are not modified.
    """
    e = np.asarray(e)
    if not (vL.shape[1] == vR.shape[1] == e.size):
        raise ValueError("eigenvalue/vector count mismatch")
    dtype = torch.promote_types(torch.promote_types(CLR.dtype, vL.dtype), vR.dtype)
    CLR = CLR.to(dtype)
    vL = vL.to(dtype).clone()
    vR = vR.to(dtype).clone()
    if e.size == 0:
        return vL, vR
    (split,) = np.nonzero(np.abs(np.diff(e)) > degeneracy_tol)
    starts = np.concatenate(([0], split + 1))
    ends = np.concatenate((split + 1, [e.size]))
    mult = ends - starts
    for m in np.unique(mult):
        sel = starts[mult == m]
        idx = torch.as_tensor(sel[:, None] + np.arange(m)[None, :], device=vL.device)
        vL_blk = vL[:, idx]  # (K, d, m)
        vR_blk = vR[:, idx]
        s_blk = torch.einsum("kdi,km,mdj->dij", vL_blk.conj(), CLR, vR_blk)
        U, _, Vh = torch.linalg.svd(s_blk)
        vL[:, idx] = torch.einsum("idk,dkj->idj", vL_blk, U)
        vR[:, idx] = torch.einsum("idk,djk->idj", vR_blk, Vh.conj())
    return vL, vR
