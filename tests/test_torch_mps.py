"""temfpy_torch.mps.charged_linalg against temfpy_tpu.mps.charged_linalg on
the same seeded charge-block matrices (JAX on the CPU, torch on the CPU).

Tolerance 1e-12 relative to the largest entry: both sides hand the same
sector blocks to LAPACK.  Singular values, eigenvalues, charge labels and
truncation errors are gauge-free and compared directly; the factors are
compared through the products they form (U S Vh, Q R, U diag(e) U^H),
because the phase of each column is a free gauge.
"""

import numpy as np
import pytest
import torch

from temfpy_tpu.mps import charged_linalg as jcl
from temfpy_torch.mps import ChargeInfo, charged_eigh, charged_qr, charged_svd

RTOL = 1e-12


def close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(np.abs(b).max(initial=0.0), 1e-300)
    assert np.abs(a - b).max(initial=0.0) <= rtol * scale, np.abs(a - b).max() / scale


def charged_matrix(rng, q_row, q_col, chinfo, qtotal=0, hermitian=False):
    """Random complex matrix obeying q_row == q_col + qtotal."""
    ok = chinfo.equal(np.asarray(q_row)[:, None], np.asarray(q_col)[None, :] + qtotal)
    M = rng.normal(size=ok.shape) + 1j * rng.normal(size=ok.shape)
    M = np.where(ok, M, 0.0)
    return M + M.conj().T if hermitian else M


@pytest.mark.parametrize("cutoff,chi_max,normalize", [(None, None, False), (None, 5, True),
                                                      (0.3, None, False)])
def test_charged_svd_matches_jax(cutoff, chi_max, normalize):
    chinfo = ChargeInfo(1, "N")
    rng = np.random.default_rng(0)
    q_row = rng.integers(0, 4, size=14)
    q_col = rng.integers(0, 4, size=11)
    M = charged_matrix(rng, q_row, q_col, chinfo, qtotal=1)
    kw = dict(cutoff=cutoff, chi_max=chi_max, normalize=normalize)
    U, S, Vh, q_mid, err = charged_svd(torch.as_tensor(M), q_row, q_col, chinfo, 1, **kw)
    Uj, Sj, Vhj, q_mid_j, err_j = jcl.charged_svd(M, q_row, q_col, chinfo, 1, **kw)
    close(S, Sj)
    np.testing.assert_array_equal(q_mid, q_mid_j)
    assert abs(err - err_j) <= RTOL * max(err_j, 1.0)
    close((U * torch.as_tensor(S)) @ Vh, (np.asarray(Uj) * Sj) @ np.asarray(Vhj))
    if cutoff is None and chi_max is None:
        close((U * torch.as_tensor(S)) @ Vh, M)


def test_charged_qr_matches_jax():
    chinfo = ChargeInfo(2, "parity")
    rng = np.random.default_rng(1)
    q_row = rng.integers(0, 2, size=9)
    q_col = rng.integers(0, 2, size=6)
    M = charged_matrix(rng, q_row, q_col, chinfo, qtotal=1)
    Q, R, q_mid = charged_qr(torch.as_tensor(M), q_row, q_col, chinfo, qtotal=1)
    Qj, Rj, q_mid_j = jcl.charged_qr(M, q_row, q_col, chinfo, qtotal=1)
    np.testing.assert_array_equal(q_mid, q_mid_j)
    close(Q @ R, M)
    close(Q @ R, np.asarray(Qj) @ np.asarray(Rj))
    g = (Q.conj().T @ Q).numpy()
    close(g, np.eye(len(g)))


def test_charged_eigh_matches_jax():
    chinfo = ChargeInfo(1, "N")
    rng = np.random.default_rng(2)
    q = rng.integers(-2, 3, size=13)
    rho = charged_matrix(rng, q, q, chinfo, hermitian=True)
    e, U, q_cols = charged_eigh(torch.as_tensor(rho), q, chinfo)
    ej, _Uj, q_cols_j = jcl.charged_eigh(rho, q, chinfo)
    close(e, ej)
    np.testing.assert_array_equal(q_cols, q_cols_j)
    assert isinstance(U, torch.Tensor) and U.dtype == torch.complex128
    close((U * torch.as_tensor(e)) @ U.conj().T, rho)
    close(U.conj().T @ U, np.eye(len(q)))
    # every column lies in its own charge sector
    off_sector = q[:, None] != q_cols[None, :]
    assert float(U.abs().numpy()[off_sector].max(initial=0.0)) == 0.0
