"""temfpy_torch.gutzwiller against temfpy_tpu.gutzwiller and the exact
diagonalization oracle of tests/oracles.py (through
tests/test_gutzwiller.py's ``exact_projected_spin_state``), on the CPU.

Every case of tests/test_gutzwiller.py, with both packages projecting the
same fermionic MPS (the port's conversion, its fields handed to the JAX
constructor), each with its own canonical form (what
``return_canonical=True`` runs; the JAX package's on host numpy tensors, so
that its numpy branch runs); and the infinite branch on a JAX iMPS carried
across with ``mps_from_arrays``: a pi-flux cylinder's cell, which the
projection makes reducible, so that both canonical forms take the ARPACK
branch and repeat the gauge pass.  Tolerances:
- against the oracle: fidelity 1 - 1e-9 and <Sz Sz> to 1e-8, as the JAX
  test asks;
- against the JAX package: fidelity 1 - 1e-10, squared Schmidt values per
  Sz sector to 1e-10, bond labels and tensor charges equal, entropies to
  1e-9.
"""

import functools
import warnings

import numpy as np
import pytest
import torch

import temfpy_torch.testing as ttst
import temfpy_tpu.testing as jtst
from temfpy_torch import gutzwiller, pfaffian, slater
from temfpy_torch.mps import mps_from_arrays
from temfpy_tpu import gutzwiller as jgutzwiller
from temfpy_tpu import iMPS as jiMPS
from temfpy_tpu.mps import MPS as JMPS
from temfpy_tpu.mps import FermionSite as JFermionSite

from test_det_updates import _piflux_model
from test_gutzwiller import exact_projected_spin_state, hopping_H
from torch_parity import charge_rule_violation, host, squared_spectra_diff

PARITY_TOL = 1e-10


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small tensor operations: one intra-op thread keeps them from
    spinning the pool's idle threads under a parallel test run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _test_action():
    old = ttst.TEST_ACTION, jtst.TEST_ACTION
    ttst.TEST_ACTION = jtst.TEST_ACTION = "warn"
    yield
    ttst.TEST_ACTION, jtst.TEST_ACTION = old


def jax_projection(fermions, ph=True):
    """The JAX package's projection of a JAX MPS and its canonical form
    (``gutzwiller._finish`` with ``return_canonical=True``), both on host
    numpy tensors."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        proj = (jgutzwiller.abrikosov_ph if ph else jgutzwiller.abrikosov)(
            host(fermions), return_canonical=False)
    host(proj)
    if proj.finite:
        return proj.canonical_form_finite(cutoff=1e-12)
    return proj.canonical_form_infinite(cutoff=1e-12)


def to_jax(m, conserve="N"):
    """The JAX package's MPS on the port MPS's arrays."""
    return JMPS([JFermionSite(conserve)] * m.L, [B.numpy() for B in m._B], m._S, form=m.form,
                bc=m.bc, unit_cell_width=m.unit_cell_width, q_bonds=m.q_bond,
                qtotals=m.qtotal)


def fidelity(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return abs(np.vdot(a, b)) / (np.linalg.norm(a) * np.linalg.norm(b))


@functools.lru_cache
def exact_state(L, ph):
    C, _ = slater.correlation_matrix(hopping_H(L), device="cpu")
    C2 = slater.spinful_correlation_matrix(C.numpy(), ph=ph)
    return exact_projected_spin_state(C2, keep=[(1, 1), (0, 0)] if ph else [(1, 0), (0, 1)])


@pytest.fixture(scope="module")
def ph_pairs():
    """Per L: the port's and the JAX package's abrikosov_ph of the same
    spinful PH conversion of the hopping chain (chi=128)."""
    out = {}
    for L in (4, 6):
        fermions = slater.H_to_MPS(hopping_H(L), {"chi_max": 128}, spinful="PH", device="cpu")
        out[L] = (gutzwiller.abrikosov_ph(fermions, inplace=False, return_canonical=True),
                  jax_projection(to_jax(fermions)))
    return out


@pytest.mark.parametrize("L", [4, 6])
def test_abrikosov_ph_vs_exact(L, ph_pairs):
    spin, ref = ph_pairs[L]
    psi = spin.to_statevector()
    assert fidelity(exact_state(L, True), psi) > 1 - 1e-9
    assert abs(spin.norm_squared() - 1) < 1e-9
    assert fidelity(np.asarray(ref.to_statevector()), psi) >= 1 - PARITY_TOL
    assert squared_spectra_diff(spin, ref) <= PARITY_TOL
    assert spin.L == L and spin.sites[0].conserve == "Sz"


def test_abrikosov_vs_exact():
    L = 4
    fermions = slater.H_to_MPS(hopping_H(L), {"chi_max": 128}, spinful="simple", device="cpu")
    spin = gutzwiller.abrikosov(fermions, inplace=False, return_canonical=True)
    ref = jax_projection(to_jax(fermions), ph=False)
    psi = spin.to_statevector()
    assert fidelity(exact_state(L, False), psi) > 1 - 1e-9
    assert fidelity(np.asarray(ref.to_statevector()), psi) >= 1 - PARITY_TOL
    assert squared_spectra_diff(spin, ref) <= PARITY_TOL


def test_abrikosov_ph_spin_correlations(ph_pairs):
    """<Sz_i Sz_j> of the projected MPS against the exact state's and the
    JAX package's; total Sz = 0."""
    L = 6
    spin, ref = ph_pairs[L]
    psi = exact_state(L, True)
    conf = np.arange(1 << L)
    sz = 0.5 - ((conf[:, None] >> (L - 1 - np.arange(L))[None, :]) & 1)
    zz_exact = np.einsum("c,ci,cj->ij", np.abs(psi) ** 2, sz, sz)
    zz = spin.correlation_function("Sz", "Sz")
    np.testing.assert_allclose(zz.real, zz_exact, atol=1e-8)
    np.testing.assert_allclose(zz, np.asarray(ref.correlation_function("Sz", "Sz")),
                               atol=PARITY_TOL)
    assert abs(spin.expectation_value("Sz").sum()) < 1e-8


def test_abrikosov_ph_entanglement_by_charge(ph_pairs):
    L = 6
    spin, ref = ph_pairs[L]
    spec, spec_ref = (m.entanglement_spectrum(by_charge=True) for m in (spin, ref))
    assert len(spec) == L - 1
    assert len([q for (q,), _s in spec[L // 2 - 1]]) >= 2
    for bond, bond_ref in zip(spec, spec_ref):
        assert [q for q, _ in bond] == [q for q, _ in bond_ref]
        for (_q, s), (_, s_ref) in zip(bond, bond_ref):
            np.testing.assert_allclose(np.sort(np.exp(-s)), np.sort(np.exp(-s_ref)),
                                       atol=PARITY_TOL)


def test_abrikosov_ph_parity_conserving_input():
    """A parity-conserving (Pfaffian) fermion MPS projects to an uncharged
    spin MPS."""
    L = 6
    h = hopping_H(L) - 0.5 * np.eye(L)  # N = 4 (even parity), gapped
    H = np.zeros((2 * L, 2 * L), complex)
    H[::2, ::2] = h
    H[1::2, 1::2] = -h.T
    fermions = pfaffian.H_to_MPS(H, {"chi_max": 64}, basis="C", device="cpu")
    spin = gutzwiller.abrikosov_ph(fermions, inplace=False)
    ref = jax_projection(to_jax(fermions, "parity"))
    assert spin.L == L // 2 and spin.sites[0].conserve is None
    assert abs(spin.norm_squared() - 1) < 1e-8
    assert fidelity(np.asarray(ref.to_statevector()), spin.to_statevector()) >= 1 - PARITY_TOL


def test_charge_checks():
    """Inputs the projection cannot take raise (the JAX package asserts)."""
    L = 4
    fermions = slater.H_to_MPS(hopping_H(L) - 1.0 * np.eye(L), {"chi_max": 32}, device="cpu")
    with pytest.raises(ValueError, match="Total charge"):
        gutzwiller.abrikosov(fermions)
    with pytest.raises(AssertionError):
        jgutzwiller.abrikosov(to_jax(fermions))
    with pytest.raises(ValueError, match="Odd-length"):
        gutzwiller.abrikosov(slater.H_to_MPS(hopping_H(3), {"chi_max": 8}, device="cpu"))
    spin = gutzwiller.abrikosov_ph(slater.H_to_MPS(hopping_H(L), {"chi_max": 32}, spinful="PH",
                                                   device="cpu"))
    with pytest.raises(ValueError, match="fermionic"):
        gutzwiller.abrikosov_ph(spin)


def test_infinite_branch_on_a_jax_imps():
    """A JAX iMPS (the JAX package's MPS_to_iMPS of two spinful PH
    conversions of the pi-flux cylinder W=4, one ring a cell, chi=24)
    carried across with mps_from_arrays.  Its projection is reducible: the
    port's projection and canonical form against the JAX package's on the
    same cell, both through the ARPACK branch, and the JAX spinful-iMPS
    test's checks (tests/test_spinful_imps.py:42-86)."""
    chains = [to_jax(slater.H_to_MPS(_piflux_model(4, Lx), {"chi_max": 24}, spinful="PH",
                                     device="cpu")) for Lx in (4, 5)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jimps, _err = jiMPS.MPS_to_iMPS(*chains, 8, 16)
    f = {"tensors": [np.asarray(B) for B in jimps._B], "lams": jimps._S,
         "q_bonds": jimps.q_bond, "qtotals": jimps.qtotal, "form": jimps.form}
    imps = mps_from_arrays(**f, bc="infinite", unit_cell_width=jimps.unit_cell_width,
                           device="cpu")
    with pytest.raises(ValueError, match="q_left"):
        gutzwiller.abrikosov(imps)
    spin = gutzwiller.abrikosov_ph(imps, inplace=False, return_canonical=True)
    ref = jax_projection(jimps)
    assert spin.L == 4 and not spin.finite
    stats = spin.transfer_stats
    assert stats["fallbacks"] > 0 and stats["matvecs"] > 0 and stats["arpack_failures"] == 0
    assert squared_spectra_diff(spin, ref) <= PARITY_TOL
    for B in spin._B:
        g = torch.einsum("anb,cnb->ac", B, B.conj())
        np.testing.assert_allclose(g.numpy(), np.eye(len(g)), atol=1e-5)
    for S in spin._S:
        assert abs(np.linalg.norm(S) - 1) < 1e-8
    ent = spin.entanglement_entropy()
    np.testing.assert_allclose(ent, ref.entanglement_entropy(), atol=1e-9)
    assert np.all(np.isfinite(ent)) and ent.max() > 1e-3
    assert any(len(np.unique(q)) > 1 for q in spin.q_bond)
    dq = spin.q_bond[spin.L] - spin.q_bond[0]
    assert dq.size and np.all(dq == dq[0])
    assert charge_rule_violation(spin) < 1e-10
