"""Batched dense linear algebra of the Slater -> MPS path, in plain PyTorch.

Counterpart of the main-path subset of :mod:`temfpy_tpu.ops.linalg`:

- :func:`eigh_blocks`: eigendecompositions of many leading/trailing
  principal blocks of a Hermitian matrix in one batched, padded ``eigh``;
- :func:`block_svd`: completion of an SVD known up to rotations inside
  degenerate blocks;
- :func:`lu_det`, :func:`gauss_solve_det` and :func:`gauss_inverse`: LU /
  Gauss-Jordan with partial pivoting, written out step by step.  They are
  the plain twins of the CUDA kernels in :mod:`temfpy_torch.ops.kernels`
  and follow the JAX package's batch-first bodies (``_lu_det_body``, the
  explicit branch of ``gauss_solve_det``) pivot for pivot;
- :func:`batched_det_pairs` and :func:`batched_det_gather`: determinants of
  index-row submatrices, paired or all-pairs (on a CUDA tensor the
  ``det_rows`` kernel), and :func:`scatter_padded`;
- the rank-update determinants: :func:`det_swap_tables` (a class base's
  factorization and gather tables), :func:`det_swaps_body` (the bordered
  determinants of the near-base pairs) and the host sign helper
  :func:`perm_parity_rows`; the first two are the arithmetic of the
  ``swap_tables`` and ``swap_fill`` kernels' twins.

Not ported (TPU workarounds): the host-eigh routing (``_eigh_blocks_host``,
``_use_host_eigh``, ``_back_like``), the batch-last layouts with implicit
pivoting (``_lu_det_batch_last``, ``_gauss_solve_det_implicit``), the
one-hot MXU selection (``_onehot_select``, ``_split_f32``); the per-class vmaps (``det_swap_tables_group``,
``_det_swaps_group``, ``_det_check_group``, ``_swap_probe_group``: each
kernel takes a whole group) and ``_bmm_small`` (an emulated-float64
matmul).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import profiling

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
    ``eigh`` call.  Under an active mesh
    (:class:`temfpy_torch.parallel.mesh.use_mesh`) the cut batch splits over
    its "cuts" axis (:func:`temfpy_torch.parallel.mesh.sharded_schmidt_spectra`)
    and the results come back to C's device.
    """
    if side not in ("L", "R"):
        raise ValueError(f"side must be 'L' or 'R', got {side!r}")
    from ..parallel import mesh as _pmesh

    mesh = _pmesh.active_mesh()
    if mesh is not None:
        return _pmesh.sharded_schmidt_spectra(C, sizes, side, mesh, chunk=chunk,
                                              device=C.device)
    sizes = profiling.to_device(np.asarray(sizes, np.int64), C.device)
    return _eigh_blocks_chunked(C, sizes, side, chunk)


def _eigh_blocks_chunked(C: torch.Tensor, sizes: torch.Tensor, side: str, chunk: int | None):
    """:func:`eigh_blocks` on C's device, ``chunk`` cuts per ``eigh``."""
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


def gauss_inverse(A: torch.Tensor) -> torch.Tensor:
    """Inverses of a (..., n, n) batch by Gauss-Jordan with partial
    pivoting: :func:`gauss_solve_det` against the identity
    (``temfpy_tpu.ops.linalg.gauss_inverse``)."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)
    return gauss_solve_det(A, eye)[1]


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


def scatter_padded(vals: torch.Tensor, shape, indices, n_real: int, dtype=None):
    """Scatters a padded value batch into a dense tensor
    (``temfpy_tpu.ops.linalg.scatter_padded``).

    ``vals`` (P_b,) has P_b >= ``n_real`` entries; those past ``n_real`` go
    to a trash row appended on axis 0 and cut off.  ``indices`` holds one
    host int array of length ``n_real`` per axis of ``shape``."""
    P_b = vals.shape[0]
    padded = []
    for ax, ix in enumerate(indices):
        full = np.full(P_b, shape[0] if ax == 0 else 0, np.int64)
        full[:n_real] = ix
        padded.append(torch.as_tensor(full, device=vals.device))
    T = torch.zeros((shape[0] + 1,) + tuple(shape[1:]), dtype=dtype or vals.dtype,
                    device=vals.device)
    T[tuple(padded)] = vals.to(T.dtype)
    return T[: shape[0]]


def _as_index(idx, device) -> torch.Tensor:
    """Index rows (numpy, nested lists or a tensor) as a contiguous int32
    tensor on ``device``."""
    return torch.as_tensor(np.asarray(idx) if not torch.is_tensor(idx) else idx,
                           device=device).to(torch.int32).contiguous()


def batched_det_pairs(M: torch.Tensor, row_idx, col_idx, chunk: int | None = None):
    """Determinants ``det(M_aug[row_idx[p]][:, col_idx[p]])`` for a flat list
    of (row-list, col-list) pairs (``temfpy_tpu.ops.linalg.
    batched_det_pairs``).

    Index rows share a width k; a slot ``s`` holding the sentinel
    ``M.shape[0] + s`` addresses the identity extension ``M_aug =
    block_diag(M, I_k)``, so an all-sentinel row gives 1.  On a CUDA tensor
    ``M`` this launches the ``det_rows`` kernel (a lane segment per
    determinant, k <= 64), on a CPU tensor its twin; ``chunk`` bounds the
    pairs per launch; under an active mesh the pairs split over its "pairs"
    axis.  Returns (P,) values on M's device."""
    from ..parallel.mesh import map_shards
    from .kernels import det_rows

    row_idx, col_idx = _as_index(row_idx, M.device), _as_index(col_idx, M.device)
    if row_idx.shape != col_idx.shape:
        raise ValueError(f"row and column index shapes differ: {tuple(row_idx.shape)}, "
                         f"{tuple(col_idx.shape)}")
    P, k = row_idx.shape
    if k == 0:
        return torch.ones(P, dtype=M.dtype, device=M.device)

    def local(r, c, M_d):
        M_d = M_d.contiguous()[None]
        n = r.shape[0]
        step = n if chunk is None or n <= chunk else chunk
        outs = [det_rows(M_d, r[None, i : i + step], c[None, i : i + step])[0]
                for i in range(0, n, max(step, 1))]
        return torch.cat(outs) if outs else M_d.new_ones(0)

    return map_shards(local, (row_idx, col_idx), (M,))


def batched_det_gather(M: torch.Tensor, bra_idx, ket_idx, chunk: int | None = None):
    """Determinants ``det(M_aug[bra_idx[i]][:, ket_idx[j]])`` for all pairs
    (i, j) (``temfpy_tpu.ops.linalg.batched_det_gather``); sentinels as in
    :func:`batched_det_pairs`, whose kernel (or twin) this launches in its
    all-pairs form.  ``chunk`` bounds the bra rows per launch; under an
    active mesh the bra rows split over its "pairs" axis.  Returns (nb, nk)
    values on M's device."""
    from ..parallel.mesh import map_shards
    from .kernels import det_rows

    bra_idx, ket_idx = _as_index(bra_idx, M.device), _as_index(ket_idx, M.device)
    k = bra_idx.shape[1]
    if ket_idx.shape[1] != k:
        raise ValueError("bra and ket index widths must match")
    nb, nk = bra_idx.shape[0], ket_idx.shape[0]
    if k == 0:
        return torch.ones((nb, nk), dtype=M.dtype, device=M.device)

    def local(b, k_idx, M_d):
        M_d = M_d.contiguous()[None]
        n = b.shape[0]
        step = n if chunk is None or n <= chunk else chunk
        outs = [det_rows(M_d, b[None, i : i + step], k_idx[None], cross=True)[0]
                for i in range(0, n, max(step, 1))]
        return torch.cat(outs) if outs else M_d.new_ones((0, nk))

    return map_shards(local, (bra_idx,), (ket_idx, M))


# --------------------------------------------------------------------------
# Rank-update determinants
#
# Within one excitation class every (bra, ket) pair selects a w-row/column
# submatrix of the parent M that differs from a per-class BASE pair (R0, C0)
# by a few swapped rows/columns.  With A = M[R0, C0], G = A^-1 and the tables
# P = M[:, C0] G, T2 = G M[R0, :], T3 = P M[R0, :], every pair's determinant
# is +-det(A) det(S), S an (a+b) x (a+b) matrix assembled from gathers:
#
#   S = [[ K,                U G V'' ],
#        [ E_c^T G E_r,  I_b + E_c^T G V'' ]]
#
#   K            = I_a + (P[Rin] - P[Rout])[:, rpos]
#   E_c^T G E_r  = G[cpos, rpos]
#   E_c^T G V''  = T2[cpos, Cin] - T2[cpos, Cout] + G[cpos, rpos] @ D12
#   U G V''      = (T3 diffs over {Rin, Rout} x {Cin, Cout}) + (K - I) @ D12
#   D12          = M[Rin, Cin] - M[Rout, Cin] - M[Rin, Cout] + M[Rout, Cout]
#
# (temfpy_tpu/ops/linalg.py, the same derivation).  a/b are padded to shape
# buckets by SELF-swaps (Rin = Rout), which leave det(S) unchanged.
# --------------------------------------------------------------------------


def det_swap_tables(M_aug: torch.Tensor, r0: torch.Tensor, c0: torch.Tensor):
    """Per-class base factorization and gather tables
    (``temfpy_tpu.ops.linalg.det_swap_tables``), batched over leading
    entries: ``M_aug`` (E, m_aug, m_aug) identity-extended parents, ``r0`` /
    ``c0`` (E, w) base row/column positions (sentinel-padded, so A =
    block_diag(A_true, I)).  Unbatched 2-d / 1-d inputs are taken too.

    Returns (D0 (E,), G (E, w, w), P (E, m_aug, w), T2 (E, w, m_aug),
    T3 (E, m_aug, m_aug)), without the leading axis for unbatched input."""
    single = M_aug.dim() == 2
    if single:
        M_aug, r0, c0 = M_aug[None], r0[None], c0[None]
    E, m_aug, _ = M_aug.shape
    w = r0.shape[-1]
    r0, c0 = r0.long(), c0.long()
    Mc = torch.gather(M_aug, 2, c0[:, None, :].expand(E, m_aug, w))  # (E, m_aug, w)
    Mr = torch.gather(M_aug, 1, r0[:, :, None].expand(E, w, m_aug))  # (E, w, m_aug)
    A = torch.gather(Mr, 2, c0[:, None, :].expand(E, w, w))
    eye = torch.eye(w, dtype=M_aug.dtype, device=M_aug.device).expand(E, w, w)
    D0, G = gauss_solve_det(A, eye)
    P = Mc @ G
    T2 = G @ Mr
    T3 = P @ Mr
    out = (D0, G, P, T2, T3)
    return tuple(t[0] for t in out) if single else out


def det_swaps_body(M_aug, G, P, T2, T3, D0, sign, rin, rout, rpos, cin, cout, cpos):
    """Rank-update determinants of a batch of near-base pairs
    (``temfpy_tpu.ops.linalg._det_swaps_body``): for pair p, its (a, a)
    row-swap and (b, b) column-swap index rows ``rin``/``rout``/``rpos`` and
    ``cin``/``cout``/``cpos`` (int tensors (P, a) and (P, b)), the class
    tables of :func:`det_swap_tables` and the permutation ``sign`` (P,),
    returns ``lu_det(S) * D0 * sign`` (P,) with S of
    :func:`swap_bordered`."""
    S = swap_bordered(M_aug, G, P, T2, T3, rin, rout, rpos, cin, cout, cpos)
    return lu_det(S) * D0 * sign


def swap_bordered(M_aug, G, P, T2, T3, rin, rout, rpos, cin, cout, cpos):
    """The (P, a+b, a+b) bordered matrices S of :func:`det_swaps_body`,
    assembled from gathers of M_aug and the class tables."""
    a, b = rin.shape[1], cin.shape[1]
    gs = gather_submatrices
    eye_a = torch.eye(a, dtype=M_aug.dtype, device=M_aug.device)[None]
    eye_b = torch.eye(b, dtype=M_aug.dtype, device=M_aug.device)[None]
    K = eye_a + gs(P, rin, rpos) - gs(P, rout, rpos)  # (P, a, a)
    Gcr = gs(G, cpos, rpos)  # (P, b, a)
    D12 = (gs(M_aug, rin, cin) - gs(M_aug, rout, cin)
           - gs(M_aug, rin, cout) + gs(M_aug, rout, cout))  # (P, a, b)
    X = gs(T2, cpos, cin) - gs(T2, cpos, cout) + Gcr @ D12
    Z = (gs(T3, rin, cin) - gs(T3, rout, cin) - gs(T3, rin, cout) + gs(T3, rout, cout)
         ) + (K - eye_a) @ D12
    return torch.cat([torch.cat([K, Z], dim=2), torch.cat([Gcr, eye_b + X], dim=2)], dim=1)


def perm_parity_rows(base: np.ndarray, rpos: np.ndarray, rin: np.ndarray) -> np.ndarray:
    """Host: parity signs of in-place row replacement against sorted order
    (``temfpy_tpu.ops.linalg.perm_parity_rows``).

    ``base`` is the sorted (w,) base position array; row r of ``rpos`` /
    ``rin`` replaces base[rpos[r, j]] by rin[r, j] (self-swaps allowed).
    Returns (n,) float signs."""
    n = rin.shape[0]
    signs = np.ones(n)
    for r in range(n):
        arr = base.copy()
        arr[rpos[r]] = rin[r]
        order = np.argsort(arr, kind="stable")
        seen = np.zeros(len(arr), bool)
        sign = 1
        for i in range(len(arr)):
            if seen[i]:
                continue
            j, clen = i, 0
            while not seen[j]:
                seen[j] = True
                j = order[j]
                clen += 1
            if clen % 2 == 0:
                sign = -sign
        signs[r] = sign
    return signs


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
        idx = profiling.to_device(sel[:, None] + np.arange(m)[None, :], vL.device)
        vL_blk = vL[:, idx]  # (K, d, m)
        vR_blk = vR[:, idx]
        s_blk = torch.einsum("kdi,km,mdj->dij", vL_blk.conj(), CLR, vR_blk)
        U, _, Vh = torch.linalg.svd(s_blk)
        vL[:, idx] = torch.einsum("idk,dkj->idj", vL_blk, U)
        vR[:, idx] = torch.einsum("idk,djk->idj", vR_blk, Vh.conj())
    return vL, vR
