"""temfpy_torch.slater.H_to_MPS against exact diagonalization and against
temfpy_tpu.slater.H_to_MPS on the same Hamiltonians (both on the CPU; the
port runs the plain twins of its CUDA kernels there).

Tolerances:
- fidelities >= 1 - 1e-10 and <c^dag c> within 1e-8 of C where nothing
  is truncated (ED sizes): the conversion is exact up to the svd_min=1e-6
  cut of Schmidt values, whose discarded weight is ~1e-12 here;
- L=64/chi=128 cross-package: 1e-10 on fidelity and Schmidt spectra (the
  two packages' LAPACK eigensolvers round differently at ~1e-15, and a
  Schmidt value is a product of up to ~10 mode weights); charges exactly;
- the canonical form is checked with bench.py's Schmidt-weighted residual
  (bench.py:351-367): the unweighted residual of a site next to a bond cut
  at svd_min is O(1e-2) by construction (the JAX package gives the same),
  while the weighted one measures the discarded weight (~1e-13 here);
- <c^dag c> off the diagonal within 1e-6 of C at L=64: the discarded
  Schmidt weight moves it by ~1.5e-7 in both packages.
"""

import os

import numpy as np
import pytest
import torch

import temfpy_torch.testing as ttst
from temfpy_torch import slater
from temfpy_torch.mps.io import mps_from_arrays
from temfpy_tpu import slater as jslater

import oracles


@pytest.fixture(autouse=True)
def _raise_on_failed_checks():
    old = ttst.TEST_ACTION
    ttst.TEST_ACTION = "raise"
    yield
    ttst.TEST_ACTION = old


def random_H(L, seed, cplx=True):
    rng = np.random.default_rng(seed)
    x, y = np.meshgrid(np.arange(L), np.arange(L), indexing="ij")
    M = rng.normal(size=(2, L, L), scale=np.exp(-abs(x - y) / 3.0))
    M = M[0] + 1j * M[1] if cplx else M[0]
    return M + M.conj().T


def dimerized_cylinder(W, L, t2=-0.2):
    """bench.py's W-leg cylinder with axis hoppings -1.0/t2; t2=-0.2 keeps
    chi=128 from binding at W=4, L=64 (at most 120 Schmidt states)."""
    H = np.zeros((L, L))
    idx = lambda x, y: x * W + y % W  # noqa: E731
    for x in range(L // W):
        for y in range(W):
            if x + 1 < L // W:
                H[idx(x, y), idx(x + 1, y)] = H[idx(x + 1, y), idx(x, y)] = (
                    -1.0 if x % 2 == 0 else t2)
            H[idx(x, y), idx(x, y + 1)] = H[idx(x, y + 1), idx(x, y)] = -1.0
    return H - 0.05 * np.eye(L)


def ed_state(C):
    e, v = np.linalg.eigh(C)
    return oracles.slater_statevector(v[:, e > 0.5])


@pytest.mark.parametrize("L,seed,cplx", [(10, 0, True), (11, 1, False)])
def test_H_to_MPS_matches_ed(L, seed, cplx):
    H = random_H(L, seed, cplx)
    mps = slater.H_to_MPS(H, {"chi_max": 256}, device="cpu")
    e, v = np.linalg.eigh(H)
    f = oracles.fidelity(oracles.slater_statevector(v[:, e < 0]), mps.to_statevector())
    assert f >= 1 - 1e-10, f
    assert abs(mps.norm_squared() - 1) < 1e-10
    C, _ = slater.correlation_matrix(H, device="cpu")
    CdC = mps.correlation_function("Cd", "C").T
    assert np.abs(CdC - C.numpy()).max() < 1e-8


def test_spinful_ph_matches_ed_and_jax():
    H = random_H(5, 3)
    mps = slater.H_to_MPS(H, {"chi_max": 256}, spinful="PH", device="cpu")
    assert mps.L == 10
    C, _ = slater.correlation_matrix(H, device="cpu")
    C2 = slater.spinful_correlation_matrix(C.numpy(), ph=True)
    f = oracles.fidelity(ed_state(C2), mps.to_statevector())
    assert f >= 1 - 1e-10, f
    ref = _jax_H_to_MPS(H, {"chi_max": 256}, spinful="PH")
    for a, b in zip(mps.q_bond, ref.q_bond):
        np.testing.assert_array_equal(a, b)
    ref_t = _from_jax(ref)
    assert abs(mps.overlap(ref_t)) >= 1 - 1e-10


def test_ortho_center_and_complex_cross_package():
    H = random_H(9, 4)
    mps = slater.H_to_MPS(H, {"chi_max": 64}, ortho_center=3, device="cpu")
    assert mps.form == ["A"] * 3 + ["B"] * 6
    ref = _from_jax(_jax_H_to_MPS(H, {"chi_max": 64}, ortho_center=3))
    assert abs(mps.overlap(ref)) >= 1 - 1e-10


def test_get_B_and_entanglement_spectrum_cross_package():
    """get_B's form conversions at the orthogonality centre and the
    charge-resolved entanglement spectrum against the JAX package.  Nothing
    is truncated at L=9, so the centre's theta tensor has unit norm to
    rounding (1e-12); spectra are compared as Schmidt values (1e-10, as for
    the L=64 spectra) because -2 log S amplifies the error of small S."""
    H = random_H(9, 8)
    mps = slater.H_to_MPS(H, {"chi_max": 64}, ortho_center=4, device="cpu")
    for i in range(mps.L):
        assert mps.get_B(i, mps.form[i]) is mps._B[i]
    for i, form in ((3, "A"), (4, "B")):
        th = mps.get_B(i, "Th")
        assert abs(float(torch.linalg.norm(th)) - 1) < 1e-12
        assert mps.form[i] == form
    # A -> B -> A round trip through the Schmidt values
    back = mps.get_B(2, "B") * torch.as_tensor(mps.get_SL(2))[:, None, None]
    back = back / torch.as_tensor(mps.get_SR(2))[None, None, :]
    assert float((back - mps._B[2]).abs().max()) < 1e-12
    ref = _jax_H_to_MPS(H, {"chi_max": 64}, ortho_center=4)
    es, es_ref = mps.entanglement_spectrum(by_charge=True), ref.entanglement_spectrum(by_charge=True)
    assert len(es) == len(es_ref) == mps.L - 1
    for bond, bond_ref in zip(es, es_ref):
        assert [q for q, _ in bond] == [q for q, _ in bond_ref]
        for (_q, x), (_qr, xr) in zip(bond, bond_ref):
            np.testing.assert_allclose(np.sort(np.exp(-x / 2)), np.sort(np.exp(-np.asarray(xr) / 2)),
                                       rtol=0, atol=1e-10)


def _jax_H_to_MPS(H, tp, **kw):
    """The reference conversion through its direct determinant path (the
    rank-update path gives the same state but compiles many more shapes on
    the CPU)."""
    old = os.environ.get("TEMFPY_TPU_DET_UPDATES")
    os.environ["TEMFPY_TPU_DET_UPDATES"] = "0"
    try:
        return jslater.H_to_MPS(H, tp, **kw)
    finally:
        if old is None:
            os.environ.pop("TEMFPY_TPU_DET_UPDATES")
        else:
            os.environ["TEMFPY_TPU_DET_UPDATES"] = old


def _from_jax(m):
    return mps_from_arrays([np.array(B) for B in m._B], m._S, m.q_bond, m.qtotal, m.form,
                           device="cpu")


@pytest.fixture(scope="module")
def cylinder64():
    H = dimerized_cylinder(4, 64)
    tp = {"chi_max": 128}
    ref = _jax_H_to_MPS(H, tp)
    mps = slater.H_to_MPS(H, tp, device="cpu")
    C, _ = slater.correlation_matrix(H, device="cpu")
    return mps, ref, C.numpy()


def test_cylinder64_charges_and_spectra(cylinder64):
    mps, ref, _C = cylinder64
    assert mps.chi_max == ref.chi_max
    worst = 0.0
    for b in range(mps.L + 1):
        np.testing.assert_array_equal(mps.q_bond[b], np.asarray(ref.q_bond[b]))
        q = mps.q_bond[b]
        for qv in np.unique(q):
            a = np.sort(mps.get_SL(b)[q == qv])
            r = np.sort(np.asarray(ref.get_SL(b))[q == qv])
            worst = max(worst, np.abs(a - r).max())
    assert worst <= 1e-10, worst
    np.testing.assert_array_equal(mps.qtotal, np.asarray(ref.qtotal))


def test_cylinder64_fidelity_across_packages(cylinder64):
    mps, ref, _C = cylinder64
    ref_t = _from_jax(ref)
    f = abs(mps.overlap(ref_t)) / np.sqrt(mps.norm_squared() * ref_t.norm_squared())
    assert f >= 1 - 1e-10, 1 - f
    # the port's own round trip through plain arrays is exact
    back = mps_from_arrays(**mps.to_numpy(), device="cpu")
    assert abs(abs(mps.overlap(back)) / mps.norm_squared() - 1) < 1e-14


def test_cylinder64_correlations(cylinder64):
    mps, _ref, C = cylinder64
    n = mps.expectation_value("N").real / mps.norm_squared()
    assert np.abs(n - np.diag(C)).max() < 1e-10
    CdC = mps.correlation_function("Cd", "C", sites2=range(0, 64, 5)).T
    assert np.abs(CdC - C[::5, :]).max() < 1e-6


def test_cylinder64_canonical_form(cylinder64):
    mps, _ref, _C = cylinder64
    c = mps.form.index("B")
    worst = 0.0
    for i in range(mps.L):
        T = mps._B[i]
        if i < c:
            g = torch.einsum("anb,anc->bc", T.conj(), T)
            w = torch.as_tensor(mps.get_SR(i))
        else:
            g = torch.einsum("anb,cnb->ac", T, T.conj())
            w = torch.as_tensor(mps.get_SL(i))
        r = g - torch.eye(g.shape[0], dtype=g.dtype)
        worst = max(worst, float(torch.linalg.norm(w[:, None] * r * w[None, :])))
    assert worst <= 1e-10, worst


def test_canonical_form_finite_keeps_the_state():
    H = random_H(10, 5, cplx=False)
    mps = slater.H_to_MPS(H, {"chi_max": 64}, device="cpu")
    psi = mps.to_statevector()
    mps.canonical_form_finite()
    assert mps.form == ["B"] * 10
    assert oracles.fidelity(psi, mps.to_statevector()) >= 1 - 1e-12
    for i in range(10):
        T = mps._B[i]
        g = torch.einsum("anb,cnb->ac", T, T.conj())
        assert float((g - torch.eye(g.shape[0], dtype=g.dtype)).abs().max()) < 1e-10


def test_single_site_tensor_matches_grouped_build():
    """build_site_tensors gives each site the same tensor whether the site
    runs alone (a group of one per kernel launch) or grouped with others
    of its shape bucket; the same-cut overlap (no physical leg) is the
    identity on the kept Schmidt vectors to rounding (1e-12)."""
    H = random_H(12, 6, cplx=False)
    C, _ = slater.correlation_matrix(H, device="cpu")
    svs = slater._schmidt_vectors_batched(C, [6, 7, 8, 9], "R", {"chi_max": 32}, 1e-8, 8, 6)
    pairs = [(svs[j + 1], svs[j], "right") for j in range(3)]
    grouped = slater.build_site_tensors(pairs)
    for pair, (T_grp, ql2, qr2, qt2) in zip(pairs, grouped):
        (T_one, ql, qr, qt), = slater.build_site_tensors([pair])
        assert torch.equal(T_one, T_grp) and qt == qt2
        np.testing.assert_array_equal(ql, ql2)
        np.testing.assert_array_equal(qr, qr2)
    (ov, *_), = slater.build_site_tensors([(svs[0], svs[0], "right")])
    assert float((ov - torch.eye(ov.shape[0], dtype=ov.dtype)).abs().max()) < 1e-12


@pytest.mark.parametrize("sectors", [None, [3, 4]])
def test_lowest_sums_batched_matches_heap(monkeypatch, sectors):
    """The port's vectorised schmidt_utils.lowest_sums gives the sums,
    subsets and truncation of the JAX package's heap enumeration (its
    ``_USE_BATCHED = False``).  Sums to 1e-12: the two add the same costs
    in different orders; subsets compared as sets of rows, since exact ties
    may come out in another order."""
    from temfpy_torch import schmidt_utils as su
    from temfpy_tpu import schmidt_utils as jsu

    rng = np.random.default_rng(7)
    a = rng.normal(size=14) * 3
    s_fast, sets_fast = su.lowest_sums(a, su.StoppingCondition(chi_max=40, sectors=sectors),
                                       filled_left=2)
    monkeypatch.setattr(jsu, "_USE_BATCHED", False)
    s_heap, sets_heap = jsu.lowest_sums(a, jsu.StoppingCondition(chi_max=40, sectors=sectors),
                                        filled_left=2)
    np.testing.assert_allclose(s_fast, s_heap, rtol=0, atol=1e-12)
    assert sets_fast.shape == sets_heap.shape
    np.testing.assert_array_equal(np.unique(sets_fast, axis=0), np.unique(sets_heap, axis=0))
