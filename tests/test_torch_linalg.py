"""temfpy_torch.ops.linalg against temfpy_tpu.ops.linalg on the same seeded
numpy inputs (JAX on the CPU, torch on the CPU).

Tolerance: 1e-12 relative to the largest entry.  Both sides run the same
float64 algorithm with the same pivoting; what remains is summation order
(a few ulps, ~1e-15) times the modest growth of these well-conditioned
random inputs, so 1e-12 leaves three orders of margin and still fails on
any wrong sign, pivot or index.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from temfpy_tpu.ops import linalg as jl
from temfpy_torch.ops import linalg as tl

RTOL = 1e-12


def close(a, b, rtol=RTOL):
    a = np.asarray(a)
    b = np.asarray(b)
    scale = max(np.abs(b).max(initial=0.0), 1e-300)
    assert np.abs(a - b).max(initial=0.0) <= rtol * scale, np.abs(a - b).max() / scale


def rand(rng, shape, cplx=False):
    x = rng.normal(size=shape)
    if cplx:
        x = x + 1j * rng.normal(size=shape)
    return x


@pytest.mark.parametrize("cplx", [False, True])
def test_lu_det_matches_jax(cplx):
    rng = np.random.default_rng(0)
    A = rand(rng, (50, 7, 7), cplx)
    A[3, :, 2] = 0.0  # a singular matrix: zero pivot path
    A[4] = np.eye(7)[[1, 0, 2, 3, 4, 5, 6]]  # pure permutation: sign only
    ref = np.asarray(jl.lu_det(jnp.asarray(A)))
    ref_bl = np.asarray(jl._lu_det_batch_last(jnp.asarray(np.transpose(A, (1, 2, 0)))))
    got = tl.lu_det(torch.as_tensor(A)).numpy()
    close(got, ref)
    close(got, ref_bl)
    assert got[3] == 0 and got[4] == -1


def test_lu_det_sentinel_padding():
    """Identity-extension sentinels (index >= m) leave determinants
    unchanged, as in the fill plans."""
    rng = np.random.default_rng(1)
    m, w = 9, 6
    M = rand(rng, (m, m))
    idx_b = np.array([[0, 3, 5, 9 + 3, 9 + 4, 9 + 5], [1, 2, 4, 6, 8, 9 + 5]])
    idx_k = np.array([[2, 4, 7, 9 + 3, 9 + 4, 9 + 5], [0, 1, 3, 5, 6, 9 + 5]])
    M_aug_t = tl.block_diag_identity_pad(torch.as_tensor(M), w)
    M_aug_j = jl.block_diag_identity_pad(jnp.asarray(M), w)
    sub_t = tl.gather_submatrices(M_aug_t, torch.as_tensor(idx_b), torch.as_tensor(idx_k))
    sub_j = jl.gather_submatrices(M_aug_j, jnp.asarray(idx_b), jnp.asarray(idx_k))
    close(sub_t.numpy(), sub_j)
    got = tl.lu_det(sub_t).numpy()
    close(got, np.asarray(jl.lu_det(sub_j)))
    close(got[0], np.linalg.det(M[np.ix_([0, 3, 5], [2, 4, 7])]))


def test_gather_submatrices_cross_matches_jax():
    rng = np.random.default_rng(2)
    M = rand(rng, (10, 10))
    ib = rng.integers(0, 10, size=(4, 3))
    ik = rng.integers(0, 10, size=(5, 3))
    got = tl.gather_submatrices(torch.as_tensor(M), torch.as_tensor(ib), torch.as_tensor(ik),
                                cross=True)
    ref = jl.gather_submatrices(jnp.asarray(M), jnp.asarray(ib), jnp.asarray(ik), cross=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("cplx", [False, True])
def test_gauss_solve_det_matches_jax(cplx):
    rng = np.random.default_rng(3)
    A = rand(rng, (8, 8), cplx)
    B = rand(rng, (8, 5), cplx)
    d_ref, X_ref = jl.gauss_solve_det(jnp.asarray(A), jnp.asarray(B))
    n = 8
    d_imp, X_imp = jl._gauss_solve_det_implicit(jnp.concatenate(
        [jnp.asarray(A), jnp.asarray(B)], axis=1), n)
    d, X = tl.gauss_solve_det(torch.as_tensor(A), torch.as_tensor(B))
    close(d.numpy(), np.asarray(d_ref))
    close(X.numpy(), np.asarray(X_ref))
    close(d.numpy(), np.asarray(d_imp))
    close(X.numpy(), np.asarray(X_imp))
    # batched form: each matrix of the batch as on its own
    db, Xb = tl.gauss_solve_det(torch.as_tensor(np.stack([A, 2 * A])),
                                torch.as_tensor(np.stack([B, B])))
    close(db.numpy(), [d.item(), 2**n * d.item()])
    close(Xb[1].numpy(), X.numpy() / 2)


def _corr(L, seed):
    rng = np.random.default_rng(seed)
    H = rng.normal(size=(L, L))
    H = H + H.T
    e, v = np.linalg.eigh(H)
    v = v[:, e < 0]
    return v @ v.T


@pytest.mark.parametrize("side", ["L", "R"])
def test_eigh_blocks_matches_jax(side):
    """Eigenvalues agree; eigenvectors agree up to the gauge of each
    eigenspace, so the reconstruction v diag(e) v^H (the padded block
    matrix) is compared instead."""
    C = _corr(16, 4)
    sizes = [0, 1, 5, 9, 16]
    e_j, v_j = jl.eigh_blocks(jnp.asarray(C), sizes, side)
    e_t, v_t = tl.eigh_blocks(torch.as_tensor(C), sizes, side, chunk=2)
    close(e_t.numpy(), np.asarray(e_j))
    v_t, v_j = v_t.numpy(), np.asarray(v_j)
    rec_t = np.einsum("bik,bk,bjk->bij", v_t, e_t.numpy(), v_t)
    rec_j = np.einsum("bik,bk,bjk->bij", v_j, np.asarray(e_j), v_j)
    close(rec_t, rec_j)
    for b, x in enumerate(sizes):
        blk = slice(0, x) if side == "L" else slice(16 - x, 16)
        close(rec_t[b][blk, blk], C[blk, blk])


@pytest.mark.parametrize("cplx", [False, True])
def test_block_svd_matches_jax(cplx):
    """With degenerate singular values the input vectors are rotated inside
    each block; after block_svd both packages must give vL^H CLR vR =
    diag(s)."""
    rng = np.random.default_rng(5)
    n = 12
    s = np.array([0.5, 0.5, 0.5, 0.3, 0.2, 0.2])
    e = s.copy()
    U = np.linalg.qr(rand(rng, (n, n), cplx))[0][:, :6]
    V = np.linalg.qr(rand(rng, (n, n), cplx))[0][:, :6]
    CLR = (U * s) @ V.conj().T
    R = np.eye(6, dtype=U.dtype)
    R[:3, :3] = np.linalg.qr(rand(rng, (3, 3), cplx))[0]
    R[4:, 4:] = np.linalg.qr(rand(rng, (2, 2), cplx))[0]
    vL, vR = U @ R, V
    jL, jR = jl.block_svd(jnp.asarray(CLR), jnp.asarray(vL), jnp.asarray(vR), e, 1e-10)
    tL, tR = tl.block_svd(torch.as_tensor(CLR), torch.as_tensor(vL), torch.as_tensor(vR), e,
                          1e-10)
    S_j = np.asarray(jL).conj().T @ CLR @ np.asarray(jR)
    S_t = tL.numpy().conj().T @ CLR @ tR.numpy()
    close(S_t, S_j)
    close(S_t, np.diag(s))
