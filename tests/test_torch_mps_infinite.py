"""The infinite-chain half of temfpy_torch.mps.MPS against temfpy_tpu.mps.MPS
on the same seeded numpy arrays, both on the CPU.

Both packages get the same cell arrays: a random cell (seeded numpy) and the
charged iMPS cell of a dimerized chain (the port's conversion, its fields
handed to the JAX constructor).  Tolerances:
- canonical forms: the fixed points come from power iterations (stopped at
  1e-13) and LAPACK eighs and SVDs of gauge-free matrices; squared Schmidt
  values to 1e-10, charge labels equal, right-canonicality to 1e-8 (the
  JAX test's bound, tests/test_mps_engine.py:121);
- observables on the same arrays (expectation values, correlation
  functions, entropies): the same contractions in another order, 1e-12;
- reshapes and relabelings (group_sites, extract_segment, splice,
  gauge_total_charge, copy): states compared through overlaps or
  statevectors, |fidelity - 1| <= 1e-12, labels equal.

A third cell is reducible: the Gutzwiller projection of a pi-flux cylinder's
spinful iMPS (one ring a cell) splits into superselection sectors, so the
power iteration does not converge and both packages take the ARPACK branch
and repeat the gauge pass; its canonical form is held at the same bounds
(squared Schmidt values 1e-10, right-canonicality 1e-8).
"""

import numpy as np
import pytest
import torch

from temfpy_torch import gutzwiller, slater
from temfpy_torch.mps import MPS, SpinHalfSite, mps_from_arrays
from temfpy_tpu.mps import MPS as JMPS
from temfpy_tpu.mps import FermionSite as JFermionSite
from temfpy_tpu.mps import SpinHalfSite as JSpinHalfSite

from test_det_updates import _piflux_model
from torch_parity import (charge_rule_violation, host, right_canonical_residual,
                          squared_spectra_diff)

OBS_TOL = 1e-12
SPECTRUM_TOL = 1e-10


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small tensor operations: one intra-op thread keeps them from
    spinning the pool's idle threads under a parallel test run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def dimer_H(L, t1=-1.0, t2=-2.5):
    M = t1 * np.ones(L - 1)
    M[1::2] = t2
    M = np.diag(M, 1)
    return M + M.T


@pytest.fixture(scope="module")
def cell():
    """The fields of a charged two-site iMPS cell (dimerized chain)."""
    imps, _err = slater.H_to_iMPS(dimer_H(16), dimer_H(18), {"chi_max": 16}, 2, 8, device="cpu")
    return imps.to_numpy()


def port_imps(f):
    return mps_from_arrays(f["tensors"], f["lams"], f["q_bonds"], f["qtotals"], f["form"],
                           bc="infinite", device="cpu")


def jax_imps(f):
    return host(JMPS([JFermionSite("N")] * len(f["tensors"]), f["tensors"], f["lams"],
                     form=f["form"], bc="infinite", q_bonds=f["q_bonds"], qtotals=f["qtotals"]))


def test_canonical_form_infinite_random_gauge():
    """tests/test_mps_engine.py:99: a random cell, canonicalised, then
    gauge-scrambled and canonicalised again, in both packages."""
    r = np.random.default_rng(5)
    chi, d = 4, 2
    T = [r.normal(size=(chi, d, chi)) for _ in range(2)]
    ours = MPS([SpinHalfSite(None)] * 2, [torch.as_tensor(t) for t in T], [None] * 3,
               form=[None] * 2, bc="infinite").canonical_form_infinite()
    ref = host(JMPS([JSpinHalfSite(None)] * 2, T, [None] * 3, form=[None] * 2,
                    bc="infinite")).canonical_form_infinite()
    assert squared_spectra_diff(ours, ref) <= SPECTRUM_TOL
    assert right_canonical_residual(ours) <= 1e-8
    assert ours.transfer_stats == {"fallbacks": 0, "matvecs": 0, "arpack_failures": 0}
    # the left fixed point of the cell transfer matrix is diag(S^2)
    S0 = ours.get_SL(0)
    E = torch.diag(torch.as_tensor(S0**2))
    for B in ours._B:
        E = torch.einsum("ab,anc,bnd->cd", E, B, B.conj())
    np.testing.assert_allclose(E.numpy(), np.diag(S0**2), atol=1e-8)

    G = r.normal(size=(chi, chi)) + 0.1 * np.eye(chi)
    T2 = [np.einsum("ab,bnc->anc", G, ours._B[0].numpy()),
          np.einsum("anb,bc->anc", ours._B[1].numpy(), np.linalg.inv(G))]
    again = MPS([SpinHalfSite(None)] * 2, T2, [None] * 3, form=[None] * 2,
                bc="infinite").canonical_form_infinite()
    ref2 = host(JMPS([JSpinHalfSite(None)] * 2, T2, [None] * 3, form=[None] * 2,
                     bc="infinite")).canonical_form_infinite()
    assert squared_spectra_diff(again, ref2) <= SPECTRUM_TOL
    np.testing.assert_allclose(np.sort(again.get_SL(0)**2), np.sort(S0**2), atol=SPECTRUM_TOL)
    np.testing.assert_allclose(again.entanglement_entropy(), ref2.entanglement_entropy(),
                               atol=OBS_TOL)


def test_canonical_form_infinite_charged(cell):
    """A charged cell keeps its labels through the canonical form: the
    same squared Schmidt values, bond labels and tensor charges as the JAX
    package's, a consistent wrap bond and the charge rule on every tensor."""
    ours = port_imps(cell).canonical_form_infinite()
    ref = jax_imps(cell).canonical_form_infinite()
    assert squared_spectra_diff(ours, ref) <= SPECTRUM_TOL
    assert right_canonical_residual(ours) <= 1e-8
    assert charge_rule_violation(ours) < 1e-12
    np.testing.assert_allclose(ours.entanglement_entropy(), ref.entanglement_entropy(),
                               atol=1e-10)
    spec = ours.entanglement_spectrum(by_charge=True)
    assert len(spec) == ours.L and [q for q, _ in spec[0]] == [q for q, _ in
                                                               ref.entanglement_spectrum(True)[0]]


def test_canonical_form_infinite_reducible():
    """A reducible cell: the Gutzwiller projection (without its canonical
    form) of a pi-flux cylinder's spinful PH iMPS, W=4, one ring a cell,
    chi=24, its Sz labels dropped.  Both packages take the ARPACK branch on
    the same arrays; the same Schmidt values, right-canonical tensors and
    entropies, and no ARPACK failure."""
    imps, _err = slater.H_to_iMPS(_piflux_model(4, 4), _piflux_model(4, 5), {"chi_max": 24}, 4,
                                  8, spinful="PH", device="cpu")
    proj = gutzwiller.abrikosov_ph(imps, inplace=False, return_canonical=False)
    T = [B.numpy() for B in proj._B]
    L = len(T)
    ours = MPS([SpinHalfSite(None)] * L, [torch.as_tensor(t) for t in T], [None] * (L + 1),
               form=[None] * L, bc="infinite").canonical_form_infinite()
    ref = host(JMPS([JSpinHalfSite(None)] * L, T, [None] * (L + 1), form=[None] * L,
                    bc="infinite")).canonical_form_infinite()
    assert ours.transfer_stats["fallbacks"] > 0 and ours.transfer_stats["matvecs"] > 0
    assert ours.transfer_stats["arpack_failures"] == 0
    assert squared_spectra_diff(ours, ref) <= SPECTRUM_TOL
    assert right_canonical_residual(ours) <= 1e-8
    for S in ours._S:
        assert abs(np.linalg.norm(S) - 1) < 1e-12
    np.testing.assert_allclose(ours.entanglement_entropy(), ref.entanglement_entropy(),
                               atol=1e-10)


def test_infinite_observables(cell):
    """<n_i>, <cd_i c_j> over general pairs (beyond the cell, both
    triangles) and the max_range variant, on the same cell arrays."""
    ours, ref = port_imps(cell), jax_imps(cell)
    np.testing.assert_allclose(ours.expectation_value("N"), ref.expectation_value("N"),
                               atol=OBS_TOL)
    np.testing.assert_allclose(ours.expectation_value("N", sites=[1, 4]),
                               ref.expectation_value("N", sites=[1, 4]), atol=OBS_TOL)
    sites1, sites2 = [0, 1, 4], [0, 2, 5]
    for names in (("Cd", "C"), ("N", "N")):
        np.testing.assert_allclose(ours.correlation_function(*names, sites1, sites2),
                                   ref.correlation_function(*names, sites1, sites2),
                                   atol=OBS_TOL)
        np.testing.assert_allclose(ours.correlation_function_infinite(*names, 5),
                                   ref.correlation_function_infinite(*names, 5), atol=OBS_TOL)
    rng = ours.correlation_function_infinite("Cd", "C", max_range=6)
    np.testing.assert_allclose(ours.correlation_function("Cd", "C", [0], range(1, 7))[0],
                               rng[0], atol=OBS_TOL)
    with pytest.raises(ValueError):
        ours.correlation_function("C", "N")
    np.testing.assert_allclose(ours.entanglement_entropy(), ref.entanglement_entropy(),
                               atol=OBS_TOL)


def test_group_sites(cell):
    """Grouping pairs of sites: the same grouped charges, Schmidt values and
    observables as the JAX package's, finite (the same state) and
    infinite."""
    ours, ref = port_imps(cell).group_sites(2), jax_imps(cell).group_sites(2)
    assert ours.L == 1 and ours.sites[0].d == 4 and ours.grouped == 2
    np.testing.assert_array_equal(ours.sites[0].charges, ref.sites[0].charges)
    assert squared_spectra_diff(ours, ref) <= 1e-14
    np.testing.assert_allclose(ours.expectation_value("N Id"), ref.expectation_value("N Id"),
                               atol=OBS_TOL)

    fin = slater.H_to_MPS(dimer_H(8), {"chi_max": 32}, device="cpu")
    g = fin.group_sites(2)
    assert g.L == 4 and g.sites[0].get_op("N Id").shape == (4, 4)
    assert abs(abs(np.vdot(fin.to_statevector(), g.to_statevector())) - 1) <= OBS_TOL


def test_extract_segment_and_splice(cell):
    """A segment past the unit cell (wrapped labels shifted by the cell's
    drift) and a splice of three cells into a finite chain, against the
    JAX package's on the same arrays."""
    ours, ref = port_imps(cell), jax_imps(cell)
    seg, seg_ref = ours.extract_segment(1, 5), ref.extract_segment(1, 5)
    assert seg.L == 5 and seg.finite
    for q, q_ref in zip(seg.q_bond, seg_ref.q_bond):
        np.testing.assert_array_equal(q, q_ref)
    np.testing.assert_array_equal(seg.qtotal, seg_ref.qtotal)
    np.testing.assert_allclose(seg._B[0].numpy(), ours.get_B(1, "B").numpy(), atol=0)
    a, b = seg.to_statevector(), np.asarray(seg_ref.to_statevector())
    assert abs(abs(np.vdot(a, b)) / (np.linalg.norm(a) * np.linalg.norm(b)) - 1) <= OBS_TOL

    fin = slater.H_to_MPS(dimer_H(16), {"chi_max": 16}, device="cpu")
    fin_ref = JMPS([JFermionSite("N")] * fin.L, [B.numpy() for B in fin._B], fin._S,
                   form=fin.form, q_bonds=fin.q_bond, qtotals=fin.qtotal)
    spliced = fin.splice(ours, 8, 3)
    spliced_ref = fin_ref.splice(ref, 8, 3)
    assert spliced.L == 22 and spliced.form[8:14] == ["B"] * 6
    back = mps_from_arrays([np.asarray(B) for B in spliced_ref._B], spliced_ref._S,
                           spliced_ref.q_bond, spliced_ref.qtotal, spliced_ref.form,
                           device="cpu")
    f = abs(spliced.overlap(back)) / np.sqrt(spliced.norm_squared() * back.norm_squared())
    assert abs(f - 1) <= OBS_TOL
    with pytest.raises(ValueError):
        ours.splice(fin, 2, 1)


def test_gauge_total_charge_and_copy():
    """Relabeling the gauge charge keeps the physical charge and every
    charge rule, as in the JAX package; a copy's labels are its own."""
    fin = slater.H_to_MPS(dimer_H(8), {"chi_max": 32}, device="cpu")
    ref = JMPS([JFermionSite("N")] * fin.L, [B.numpy() for B in fin._B], fin._S,
               form=fin.form, q_bonds=fin.q_bond, qtotals=fin.qtotal)
    dup = fin.copy()
    phys = fin.get_total_charge(only_physical=True)
    assert phys == ref.get_total_charge(only_physical=True) == 4
    fin.gauge_total_charge(3, site=2)
    ref.gauge_total_charge(3, site=2)
    assert fin.get_total_charge() == ref.get_total_charge() == 3
    assert fin.get_total_charge(only_physical=True) == phys
    for q, q_ref in zip(fin.q_bond, ref.q_bond):
        np.testing.assert_array_equal(q, q_ref)
    np.testing.assert_array_equal(fin.qtotal, ref.qtotal)
    assert charge_rule_violation(fin) < 1e-12
    assert dup.get_total_charge() == 0 and dup.qtotal[2] == 0
    assert abs(abs(dup.overlap(fin)) - 1) <= OBS_TOL


def test_infinite_constructor_and_arrays(cell):
    """An infinite MPS takes L or L+1 Schmidt vectors, raises on a wrap bond
    that differs from bond 0 (naming it), and carries its fields through
    ``to_numpy`` / ``mps_from_arrays``; spin sites carry over too."""
    m = port_imps(cell)
    assert not m.finite and m.N_sites_per_hor_spacing == 2 and m.dims == [2, 2]
    short = MPS(m.sites, m._B, m._S[:2], form="B", bc="infinite", q_bonds=m.q_bond,
                qtotals=m.qtotal)
    np.testing.assert_array_equal(short.get_SL(2), m.get_SL(0))
    bad = [s.copy() for s in m._S]
    bad[2] = bad[2][::-1].copy()
    with pytest.raises(ValueError, match="wrap bond 2"):
        MPS(m.sites, m._B, bad, form="B", bc="infinite", q_bonds=m.q_bond, qtotals=m.qtotal)
    with pytest.raises(ValueError):
        MPS(m.sites, m._B, m._S, bc="periodic")
    f = m.to_numpy()
    assert f["bc"] == "infinite"
    spin = mps_from_arrays(f["tensors"], f["lams"], f["q_bonds"], f["qtotals"], f["form"],
                           bc="infinite", device="cpu", sites=[SpinHalfSite("Sz")] * 2)
    assert isinstance(spin.sites[0], SpinHalfSite) and not spin.finite
    with pytest.raises(ValueError):
        m.exact_tensors()
