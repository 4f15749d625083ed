"""The port's index-row determinant and Pfaffian batches
(``temfpy_torch.ops.linalg.batched_det_pairs`` / ``batched_det_gather``,
``temfpy_torch.ops.pfaffian.batched_pfaffian_gather``) against
``temfpy_tpu.ops`` on the same numpy inputs, on the CPU (the kernels'
plain twins).  Tolerance 1e-12 absolute on determinants and Pfaffians of
O(1) entries: both packages run the same pivoted elimination and differ
only in rounding."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from temfpy_torch import testing
from temfpy_torch.ops import kernels
from temfpy_torch.ops import linalg as tlin
from temfpy_torch.ops import pfaffian as tpf
from temfpy_tpu.ops import linalg as jlin
from temfpy_tpu.ops import pfaffian as jpf

TOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU twins run many small tensor operations; one intra-op
    thread keeps them from spinning the pool's idle threads, which under a
    parallel test run costs far more than it gains."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(rng, n, w, m, counts):
    out = np.empty((n, w), np.int32)
    for r, c in enumerate(counts):
        out[r, :c] = np.sort(rng.choice(m, size=c, replace=False))
        out[r, c:] = m + np.arange(c, w)
    return out


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("chunk", [None, 7])
def test_batched_det_pairs_matches_jax(dtype, chunk):
    """Paired rows of width 6 with 6, 5 or 4 real slots (sentinel tails) and
    an all-sentinel row (det 1); ``chunk`` splits the pairs."""
    rng = np.random.default_rng(11)
    m, w, P = 12, 6, 40
    M = rng.normal(size=(m, m))
    if dtype is np.complex128:
        M = M + 1j * rng.normal(size=(m, m))
    cnt = w - np.arange(P) % 3
    cnt[-1] = 0
    rb, rk = _rows(rng, P, w, m, cnt), _rows(rng, P, w, m, cnt)
    want = np.asarray(jlin.batched_det_pairs(jnp.asarray(M), rb, rk, chunk=chunk))
    got = tlin.batched_det_pairs(torch.as_tensor(M), rb, rk, chunk=chunk)
    assert got.dtype == torch.as_tensor(M).dtype and tuple(got.shape) == (P,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    assert got[-1].item() == 1
    for p in (0, 1, 2):
        c = cnt[p]
        np.testing.assert_allclose(got[p].item(), np.linalg.det(M[np.ix_(rb[p, :c], rk[p, :c])]),
                                   rtol=0, atol=TOL)


@pytest.mark.parametrize("chunk", [None, 1])
def test_batched_det_gather_mixed_sizes_matches_jax(chunk):
    """tests/test_ops.py:test_batched_det_gather_mixed_sizes's input."""
    rng = np.random.default_rng(42)
    m = 7
    M = rng.normal(size=(m, m)) + 1j * rng.normal(size=(m, m))
    bra = np.array([[0, 1, 2], [3, 4, m + 2]], dtype=np.int32)
    ket = np.array([[2, 3, 4], [5, 6, m + 2]], dtype=np.int32)
    want = np.asarray(jlin.batched_det_gather(jnp.asarray(M), bra, ket, chunk=chunk))
    got = tlin.batched_det_gather(torch.as_tensor(M), bra, ket, chunk=chunk).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(got[0, 0], np.linalg.det(M[np.ix_([0, 1, 2], [2, 3, 4])]),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(got[1, 1], np.linalg.det(M[np.ix_([3, 4], [5, 6])]), rtol=0,
                               atol=TOL)


def test_batched_det_gather_seeded_and_empty_width():
    (M, ib, ik, _scale), _kw = testing.random_det_rows_case(4, G=1, w=8, m=20, n=30, nk=17,
                                                            cross=True)
    want = np.asarray(jlin.batched_det_gather(jnp.asarray(M[0]), ib[0], ik[0], chunk=8))
    got = tlin.batched_det_gather(torch.as_tensor(M[0]), ib[0], ik[0], chunk=8).numpy()
    assert got.shape == (30, 17)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    empty = tlin.batched_det_gather(torch.as_tensor(M[0]), np.zeros((2, 0), np.int32),
                                    np.zeros((3, 0), np.int32))
    np.testing.assert_array_equal(empty.numpy(), np.ones((2, 3)))
    np.testing.assert_array_equal(
        tlin.batched_det_pairs(torch.as_tensor(M[0]), np.zeros((4, 0), np.int32),
                               np.zeros((4, 0), np.int32)).numpy(), np.ones(4))


def test_det_rows_scale_and_groups():
    """The det_rows twin over G = 3 matrices with scales, paired and all
    pairs, against per-matrix batched_det_pairs / batched_det_gather."""
    for cross in (False, True):
        (M, ib, ik, sc), kw = testing.random_det_rows_case(6, G=3, w=5, m=12, n=9, nk=4,
                                                           cross=cross, dtype=np.complex128)
        got = kernels.det_rows(*(torch.as_tensor(a) for a in (M, ib, ik, sc)), **kw).numpy()
        for g in range(3):
            f = jlin.batched_det_gather if cross else jlin.batched_det_pairs
            want = np.asarray(f(jnp.asarray(M[g]), ib[g], ik[g])) * sc[g]
            np.testing.assert_allclose(got[g], want, rtol=0, atol=TOL)


def test_pfaffian_gather_matches_jax():
    """tests/test_ops.py:test_pfaffian_gather's input (bra tail padding)."""
    rng = np.random.default_rng(42)
    m = 8
    N = rng.normal(size=(m, m)) + 1j * rng.normal(size=(m, m))
    N = N - N.T
    ket = np.array([[0, 1], [2, 3]], dtype=np.int32)
    bra = np.array([[4, 5], [6, 7], [m, m + 1]], dtype=np.int32)
    want = np.asarray(jpf.batched_pfaffian_gather(jnp.asarray(N), bra, ket, pad_slots=2))
    got = tpf.batched_pfaffian_gather(torch.as_tensor(N), bra, ket, pad_slots=2).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    for i, b in enumerate([[4, 5], [6, 7], None]):
        for j, k in enumerate([[0, 1], [2, 3]]):
            ix = list(k) + (list(b) if b else [])
            np.testing.assert_allclose(got[i, j], jpf.pfaffian_numpy(N[np.ix_(ix, ix)]),
                                       rtol=0, atol=1e-10)


@pytest.mark.parametrize("dtype,kb,kk,chunk", [(np.complex128, 6, 4, None),
                                               (np.float64, 10, 6, 3),
                                               (np.complex128, 3, 1, None)])
def test_pfaffian_gather_seeded_matches_jax(dtype, kb, kk, chunk):
    N, bra, ket, pad = testing.random_pf_gather_case(2, m=24, nb=7, nk=5, kb=kb, kk=kk,
                                                     dtype=dtype)
    want = np.asarray(jpf.batched_pfaffian_gather(jnp.asarray(N), bra, ket, pad_slots=pad,
                                                  chunk=chunk))
    got = tpf.batched_pfaffian_gather(torch.as_tensor(N), bra, ket, pad, chunk=chunk).numpy()
    assert got.shape == (7, 5)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert np.abs(got).max() > 1e-3


@pytest.mark.parametrize("dtype,kb,kk,chunk", [(np.float64, 1, 1, None),
                                               (np.complex128, 12, 8, None),
                                               (np.float64, 20, 12, None),
                                               (np.complex128, 16, 16, 4)])
def test_pfaffian_gather_edge_widths_match_jax(dtype, kb, kk, chunk):
    """Widths 2, 20 and 32 (the kernel's narrowest tier, and past 16, where
    complex128 keeps its rows in shared memory): against the JAX package
    within 1e-12 of the largest |Pf| (at k = 32 the Pfaffians of these
    O(m^-1/2) entries are ~1e-9, so the absolute TOL says nothing)."""
    N, bra, ket, pad = testing.random_pf_gather_case(kb + kk, m=64, nb=6, nk=5, kb=kb, kk=kk,
                                                     dtype=dtype)
    want = np.asarray(jpf.batched_pfaffian_gather(jnp.asarray(N), bra, ket, pad_slots=pad,
                                                  chunk=chunk))
    got = tpf.batched_pfaffian_gather(torch.as_tensor(N), bra, ket, pad, chunk=chunk).numpy()
    assert got.shape == (6, 5)
    scale = np.abs(want).max()
    assert scale > 0 and np.abs(got - want).max() <= TOL * scale
    assert len(np.unique(np.round(np.abs(got) / scale, 6))) > 10


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_pfaffian_gather_zero_column_and_split_run_match_jax(dtype):
    """A ket row holding an index whose row and column of N are zero (Pf = 0
    exactly) and a sentinel run split across the ket/bra border (ket ends
    in m, bra begins with m + 1): against the JAX package and numpy."""
    N, bra, ket, _pad = testing.random_pf_gather_case(9, m=32, nb=4, nk=3, kb=5, kk=3,
                                                      dtype=dtype)
    m = N.shape[0]
    N[3, :] = 0
    N[:, 3] = 0
    ket[0, 0] = 3
    ket[2, 2] = m
    bra[:, 0] = m + 1
    bra[:, 1:] = np.sort(bra[:, 1:], axis=1)
    bra[bra >= m + 2] = 20  # the generator's tail sentinels: real rows here
    want = np.asarray(jpf.batched_pfaffian_gather(jnp.asarray(N), bra, ket, pad_slots=2))
    got = tpf.batched_pfaffian_gather(torch.as_tensor(N), bra, ket, 2).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert not got[:, 0].any()
    for i in range(4):
        ix = list(ket[2]) + list(bra[i])
        Na = np.zeros((m + 2, m + 2), dtype=N.dtype)
        Na[:m, :m] = N
        Na[m, m + 1], Na[m + 1, m] = 1, -1
        np.testing.assert_allclose(got[i, 2], jpf.pfaffian_numpy(Na[np.ix_(ix, ix)]), rtol=0,
                                   atol=1e-10)


def test_pfaffian_gather_empty_and_odd():
    N = torch.zeros((4, 4), dtype=torch.complex128)
    np.testing.assert_array_equal(
        tpf.batched_pfaffian_gather(N, np.zeros((2, 0), np.int32), np.zeros((3, 0), np.int32),
                                    0).numpy(), np.ones((2, 3)))
    with pytest.raises(ValueError):
        tpf.batched_pfaffian_gather(N, np.zeros((2, 1), np.int32), np.zeros((3, 0), np.int32), 0)


def test_scatter_padded_matches_jax():
    rng = np.random.default_rng(5)
    vals = rng.normal(size=16)
    idx = (np.array([0, 2, 1, 3, 2]), np.array([1, 0, 1, 2, 2]))
    want = np.asarray(jlin.scatter_padded(jnp.asarray(vals), (4, 3), idx, 5))
    got = tlin.scatter_padded(torch.as_tensor(vals), (4, 3), idx, 5).numpy()
    np.testing.assert_array_equal(got, want)
