"""temfpy_torch.pfaffian.H_to_MPS against exact diagonalization and against
temfpy_tpu.pfaffian.H_to_MPS on the same BdG Hamiltonians (both on the CPU;
the port runs the plain twins of its CUDA kernels there), and the device
rules of the entry points.

Tolerances:
- fidelities >= 1 - 1e-10, entanglement spectra (the reduced density
  matrix's eigenvalues, the squared Schmidt values) within 1e-10, bond
  parities identical: the two packages run different eigensolvers (torch
  and JAX eigh), whose eigenvectors differ within degenerate blocks and
  whose eigenvalues round differently at ~1e-16 absolute; a fidelity is a
  sum over chi^2 entries.  The Schmidt values themselves are not compared
  to 1e-10: one near the svd_min=1e-6 cut is ~sqrt(lambda) of a mode
  weight lambda ~1e-12, so the solvers' 1e-16 rounding of lambda moves it
  by ~1e-16 / (2e-6), and the two packages part by up to 3.4e-10 there;
- ED fidelity >= 1 - 1e-10 where chi does not bind (the svd_min=1e-6 cut of
  Schmidt values discards a weight of ~1e-12);
- <c^dag c> and <c c> within 1e-8 of C where nothing is truncated (the
  JAX package's own test bound, tests/test_pfaffian.py:151).

The Kitaev chain runs at mu=1.2 (the reference test's mu=0.5 puts L=10 in
the topological phase, whose edge modes are degenerate to 1e-5 and leave
the correlation matrix Nambu-symmetric only to 8e-10 in either package).
"""

import numpy as np
import pytest
import torch

import temfpy_torch.testing as ttst
import temfpy_tpu.testing as jtst
from temfpy_torch import config, pfaffian
from temfpy_torch.mps.io import mps_from_arrays
from temfpy_tpu import pfaffian as jpf

import oracles
import test_pfaffian as jtests

TOL = 1e-10


@pytest.fixture(autouse=True)
def _raise_on_failed_checks():
    old = ttst.TEST_ACTION, jtst.TEST_ACTION
    ttst.TEST_ACTION = jtst.TEST_ACTION = "raise"
    yield
    ttst.TEST_ACTION, jtst.TEST_ACTION = old


def from_jax(m):
    """A JAX Pfaffian MPS as a port MPS: plain arrays and parity sites."""
    return mps_from_arrays([np.asarray(B) for B in m._B], m._S, m.q_bond, m.qtotal, m.form,
                           device="cpu", sites=[pfaffian.fermion_site] * len(m._B))


def fidelity(a, b):
    return abs(a.overlap(b)) / np.sqrt(a.norm_squared() * b.norm_squared())


def assert_same_state(mps, ref, label_gauge=False):
    """Same bond parities, entanglement spectra per parity and state.
    With ``label_gauge``, a bond's parity labels may differ by a global
    flip (the vacuum parity of a cut with exactly degenerate lambda=1/2
    modes depends on the eigensolver's gauge inside the degenerate block);
    the spectra are then compared per label after the flip."""
    assert mps.chi_max == ref.chi_max
    worst = 0.0
    for b in range(mps.L + 1):
        q_ref = np.asarray(ref.q_bond[b])
        if label_gauge and not np.array_equal(mps.q_bond[b], q_ref):
            q_ref = 1 - q_ref
        np.testing.assert_array_equal(np.sort(mps.q_bond[b]), np.sort(q_ref))
        for q in (0, 1):
            sel = mps.q_bond[b] == q
            a = np.sort(mps.get_SL(b)[sel] ** 2)
            r = np.sort(np.asarray(ref.get_SL(b))[q_ref == q] ** 2)
            worst = max(worst, np.abs(a - r).max(initial=0.0))
    assert worst <= TOL, worst
    if not label_gauge:
        for b in range(mps.L + 1):
            np.testing.assert_array_equal(mps.q_bond[b], np.asarray(ref.q_bond[b]))
        np.testing.assert_array_equal(mps.qtotal, np.asarray(ref.qtotal))
    assert fidelity(mps, from_jax(ref)) >= 1 - TOL


@pytest.mark.parametrize("basis", ["C", "M"])
def test_kitaev_matches_jax_and_ed(basis):
    L = 10
    H, h, D = jtests.kitaev_H_C(L, mu=1.2)
    if basis == "M":
        H = pfaffian.matrix_C2M(H)
    mps = pfaffian.H_to_MPS(H, {"chi_max": 64}, basis=basis, device="cpu")
    ref = jpf.H_to_MPS(H, {"chi_max": 64}, basis=basis)
    assert_same_state(mps, ref)
    psi = oracles.ground_state(oracles.quadratic_hamiltonian(L, h, D))
    assert oracles.fidelity(psi, mps.to_statevector()) >= 1 - TOL
    assert abs(mps.norm_squared() - 1) < TOL


def test_pip_cylinder_matches_jax():
    """bench.py config 5's p+ip model at W=4, Lx=4 (L=16), chi=32 (binds)."""
    H = ttst.pip_hamiltonian(4, 4)
    mps = pfaffian.H_to_MPS(H, {"chi_max": 32}, basis="C", device="cpu")
    ref = jpf.H_to_MPS(H, {"chi_max": 32}, basis="C")
    assert mps.chi_max == 32
    assert_same_state(mps, ref)


def test_random_majorana_correlators_and_jax():
    """The reference example's check (tests/test_pfaffian.py:138) at L=8."""
    L = 8
    H = jtests.majorana_random_H(L, seed=5)
    mps = pfaffian.H_to_MPS(H, {"chi_max": 128}, basis="M", device="cpu")
    C = pfaffian.correlation_matrix(H, basis="M->C", device="cpu")
    assert np.abs(mps.correlation_function("Cd", "C").T - C[::2, ::2]).max() < 1e-8
    assert np.abs(mps.correlation_function("C", "C").T - C[::2, 1::2]).max() < 1e-8
    assert_same_state(mps, jpf.H_to_MPS(H, {"chi_max": 128}, basis="M"))
    # every tensor conserves parity
    for i in range(L):
        T = mps._B[i].numpy()
        qL = mps.q_bond[i][:, None, None]
        qp = mps.sites[i].charges[None, :, None]
        qR = mps.q_bond[i + 1][None, None, :]
        bad = (qL + qp - qR - mps.qtotal[i]) % 2 != 0
        assert np.abs(T[bad]).max(initial=0.0) < 1e-12


def test_half_modes_ring_matches_ed():
    """The lambda=1/2 machinery (realification, SVD pairing, the fixed-seed
    orthogonal shuffle) on the reference test's sweet-spot ring."""
    L = 6
    h = np.zeros((L, L))
    D = np.zeros((L, L))
    for i in range(L):
        j = (i + 1) % L
        h[i, j] = h[j, i] = -1.0
        D[i, j] += 1.0
        D[j, i] += -1.0
    H = jtests.nambu_from_quadratic(h, D)
    C_M = pfaffian.correlation_matrix(H, basis="C->M", device="cpu")
    modes = pfaffian.SchmidtModes.from_correlation_matrix(C_M, 3, {"chi_max": 64}, basis="M",
                                                          device="cpu")
    assert np.isclose(modes.e[-1], 0.5, atol=1e-10)
    mps = pfaffian.H_to_MPS(H, {"chi_max": 64}, basis="C", device="cpu")
    psi = oracles.ground_state(oracles.quadratic_hamiltonian(L, h, D))
    assert oracles.fidelity(psi, mps.to_statevector()) >= 1 - TOL
    assert_same_state(mps, jpf.H_to_MPS(H, {"chi_max": 64}, basis="C"), label_gauge=True)


def test_check_schmidt_decomposition_accepts_pfaffian_modes():
    """The port's contract check takes Pfaffian modes (both sides) and
    catches a corrupted mode matrix."""
    H = jtests.majorana_random_H(6, seed=9)
    C = pfaffian.correlation_matrix(H, basis="M->M", device="cpu")
    modes = pfaffian.SchmidtModes.from_correlation_matrix(C, 3, {"chi_max": 64}, basis="M",
                                                          device="cpu")
    C_C = pfaffian.matrix_M2C(C)
    ttst.check_schmidt_decomposition(modes, C_C)
    vL = modes.vL.copy()
    vL[:, 0] *= 1.1
    bad = pfaffian.SchmidtModes(nL=modes.nL, nR=modes.nR, e=modes.e, vL=vL, vR=modes.vR,
                                pL=modes.pL, pR=modes.pR)
    with pytest.raises(AssertionError, match="unitary"):
        ttst.check_schmidt_decomposition(bad, C_C)


def test_unchecked_mode_matches_checked(monkeypatch):
    """TEST_ACTION='pass' (the kernels' det-guarded norm) and the checked
    mode (host SVD norm, Nambu contracts) give the same tensors."""
    H = jtests.majorana_random_H(6, seed=21)
    checked = pfaffian.H_to_MPS(H, {"chi_max": 64}, basis="M", device="cpu")
    monkeypatch.setattr(ttst, "TEST_ACTION", "pass")
    fast = pfaffian.H_to_MPS(H, {"chi_max": 64}, basis="M", device="cpu")
    for a, b in zip(checked._B, fast._B):
        assert float((a - b).abs().max()) < TOL


def test_jax_pfaffian_mps_carries_across():
    """mps_from_arrays with parity sites keeps a JAX Pfaffian MPS's labels
    and statevector."""
    H, _h, _D = jtests.kitaev_H_C(6, mu=2.0)
    ref = jpf.H_to_MPS(H, {"chi_max": 64}, basis="C")
    m = from_jax(ref)
    assert m.chinfo.mod == 2
    for a, b in zip(m.q_bond, ref.q_bond):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_allclose(m.to_statevector(), np.asarray(ref.to_statevector()),
                               rtol=0, atol=1e-14)


def test_default_device_needs_a_card():
    """Where torch sees no card the entry points do not fall back to the CPU
    unasked: device=None raises, device="cpu" runs."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        config.default_device()
    H, _h, _D = jtests.kitaev_H_C(4, mu=2.0)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        pfaffian.H_to_MPS(H, {"chi_max": 8}, basis="C")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        pfaffian.correlation_matrix(H, basis="C->C")
    from temfpy_torch import slater

    with pytest.raises(RuntimeError, match='device="cpu"'):
        slater.H_to_MPS(np.eye(4) - np.eye(4, k=1) - np.eye(4, k=-1), {"chi_max": 8})
    # a tensor argument keeps its own device
    C, _ = slater.correlation_matrix(torch.as_tensor(-np.eye(4, k=1) - np.eye(4, k=-1)))
    assert C.device.type == "cpu"
