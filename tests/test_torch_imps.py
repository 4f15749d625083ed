"""temfpy_torch.iMPS and the iMPS entry points of temfpy_torch.slater and
temfpy_torch.pfaffian against temfpy_tpu on the same seeded numpy inputs,
both on the CPU (the port runs its kernels' twins there).

Templates: tests/test_imps.py and tests/test_spinful_imps.py.  Compared:
iMPSError fields, squared Schmidt values, bond labels and tensor charges or
parities, and the splice reconstruction (n cells spliced into the short
chain against the conversion of the longer one), never tensors entry by
entry.  Tolerances:
- ``MPS_to_iMPS`` on the same finite MPS arrays in both packages: the same
  overlaps and Procrustes SVDs in another summation order; squared
  Schmidt values to 1e-12 and the squared iMPSError fields to 1e-12 (each
  field is the root of a difference of O(1) sums, so at rounding level
  the root itself amplifies the summation order);
- the conversions, each package with its own eighs: squared Schmidt values
  to 1e-10 and squared iMPSError fields to 1e-10;
- the splice: |overlap| within 1e-6 of 1, as the JAX test asks.
"""

import warnings

import numpy as np
import pytest
import torch

import temfpy_torch.testing as ttst
import temfpy_tpu.testing as jtst
from temfpy_torch import iMPS, pfaffian, slater
from temfpy_tpu import iMPS as jiMPS
from temfpy_tpu import pfaffian as jpfaffian
from temfpy_tpu import slater as jslater
from temfpy_tpu.mps import MPS as JMPS
from temfpy_tpu.mps import FermionSite as JFermionSite

from test_imps import dimer_H, kitaev_H_C
from torch_parity import error_diff, squared_spectra_diff

SAME_ARRAYS_TOL = 1e-12
CONVERSION_TOL = 1e-10
SPLICE_TOL = 1e-6


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
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield
    ttst.TEST_ACTION, jtst.TEST_ACTION = old


def splice_overlaps(short, imps, cut, longer):
    """|<longer(n)|short with n cells spliced at cut>| per n in ``longer``."""
    return {n: abs(m.overlap(short.splice(imps, cut, n))) for n, m in longer.items()}


def test_MPS_to_iMPS_offset_auto():
    """The same two finite MPS (the port's conversions) in both packages;
    the auto offset keeps the labels small; splices of 1 and 3 cells
    reconstruct the longer chains."""
    tp = {"chi_max": 48}
    short = slater.H_to_MPS(dimer_H(32), tp, device="cpu")
    long_ = slater.H_to_MPS(dimer_H(34), tp, device="cpu")
    imps, err = iMPS.MPS_to_iMPS(short, long_, 2, 16, offset="auto")
    jax = [JMPS([JFermionSite("N")] * m.L, [B.numpy() for B in m._B], m._S, form=m.form,
                q_bonds=m.q_bond, qtotals=m.qtotal) for m in (short, long_)]
    ref, err_ref = jiMPS.MPS_to_iMPS(*jax, 2, 16, offset="auto")
    assert squared_spectra_diff(imps, ref) <= SAME_ARRAYS_TOL
    assert error_diff(err, err_ref) <= SAME_ARRAYS_TOL
    assert err.total_error < 1e-4 and np.abs(imps.q_bond[0]).max() <= 2
    assert imps.unit_cell_width == ref.unit_cell_width and not imps.finite
    longer = {n: slater.H_to_MPS(dimer_H(32 + 2 * n), tp, device="cpu") for n in (1, 3)}
    for n, ov in splice_overlaps(short, imps, 16, longer).items():
        assert abs(ov - 1) < SPLICE_TOL, (n, ov)


@pytest.fixture(scope="module")
def slater_pair():
    tp = {"chi_max": 48}
    ours = slater.H_to_iMPS(dimer_H(32), dimer_H(34), tp, 2, 16, device="cpu")
    ref = jslater.H_to_iMPS(dimer_H(32), dimer_H(34), tp, 2, 16)
    return ours, ref


@pytest.mark.parametrize("n_cell", [1, 3])
def test_slater_H_to_iMPS(slater_pair, n_cell):
    (imps, err), (ref, err_ref) = slater_pair
    assert squared_spectra_diff(imps, ref) <= CONVERSION_TOL
    assert error_diff(err, err_ref) <= CONVERSION_TOL
    assert err.right_unitary == err.right_schmidt == 0.0 and err.total_error < 1e-4
    tp = {"chi_max": 48}
    short = slater.H_to_MPS(dimer_H(32), tp, device="cpu")
    longer = {n_cell: slater.H_to_MPS(dimer_H(32 + 2 * n_cell), tp, device="cpu")}
    assert abs(splice_overlaps(short, imps, 16, longer)[n_cell] - 1) < SPLICE_TOL


def test_slater_H_to_iMPS_PH():
    """spinful="PH" doubles the cell (tests/test_spinful_imps.py:42)."""
    def dimer(L):
        return dimer_H(L, t2=-2.5)

    tp = {"chi_max": 256}
    imps, err = slater.H_to_iMPS(dimer(4), dimer(6), tp, 2, 2, spinful="PH", device="cpu")
    ref, err_ref = jslater.H_to_iMPS(dimer(4), dimer(6), tp, 2, 2, spinful="PH")
    assert imps.L == 4 and not imps.finite
    assert squared_spectra_diff(imps, ref) <= CONVERSION_TOL
    assert error_diff(err, err_ref) <= CONVERSION_TOL
    with pytest.raises(ValueError, match="spinful"):
        slater.H_to_iMPS(dimer(4), dimer(6), tp, 2, 2, spinful="up", device="cpu")


def test_pfaffian_H_to_iMPS():
    tp = {"chi_max": 48}
    imps, err = pfaffian.H_to_iMPS(kitaev_H_C(24), kitaev_H_C(25), tp, 1, 12, basis="C",
                                   device="cpu")
    ref, err_ref = jpfaffian.H_to_iMPS(kitaev_H_C(24), kitaev_H_C(25), tp, 1, 12, basis="C")
    assert squared_spectra_diff(imps, ref) <= CONVERSION_TOL
    assert error_diff(err, err_ref) <= CONVERSION_TOL
    assert err.total_error < 1e-4
    short = pfaffian.H_to_MPS(kitaev_H_C(24), tp, basis="C", device="cpu")
    longer = {n: pfaffian.H_to_MPS(kitaev_H_C(24 + n), tp, basis="C", device="cpu")
              for n in (1, 3)}
    for n, ov in splice_overlaps(short, imps, 12, longer).items():
        assert abs(ov - 1) < SPLICE_TOL, (n, ov)


def test_imps_error_repr():
    e = iMPS.iMPSError(0.0, 0.0, 0.0, 0.0)
    assert repr(e) == repr(jiMPS.iMPSError(0.0, 0.0, 0.0, 0.0)) == "iMPSError()"
    e = iMPS.iMPSError(1e-8, 0.0, 0.0, 0.0)
    assert repr(e) == repr(jiMPS.iMPSError(1e-8, 0.0, 0.0, 0.0)) and "left_unitary" in repr(e)
    assert e.total_error == pytest.approx(1e-8) and e.left_total == pytest.approx(1e-8)


def test_length_mismatch_raises():
    tp = {"chi_max": 16}
    m1 = slater.H_to_MPS(dimer_H(8), tp, device="cpu")
    m2 = slater.H_to_MPS(dimer_H(12), tp, device="cpu")
    with pytest.raises(ValueError, match="one unit cell"):
        iMPS.MPS_to_iMPS(m1, m2, 2, 4)
    with pytest.raises(ValueError, match="one unit cell"):
        slater.H_to_iMPS(dimer_H(8), dimer_H(12), tp, 2, 4, device="cpu")
    with pytest.raises(ValueError, match="one unit cell"):
        pfaffian.H_to_iMPS(kitaev_H_C(8), kitaev_H_C(10), tp, 1, 4, basis="C", device="cpu")


def test_infinite_observables_match_finite_bulk():
    """<n_i> and <cd_i c_j> of the port's iMPS match the bulk of a long
    finite conversion (tests/test_imps.py:141)."""
    L, cell = 32, 2
    imps, _err = slater.H_to_iMPS(dimer_H(L, t2=-2.5), dimer_H(L + cell, t2=-2.5),
                                  {"chi_max": 48}, cell, L // 2, device="cpu")
    fin = slater.H_to_MPS(dimer_H(L, t2=-2.5), {"chi_max": 48}, device="cpu")
    mid = L // 2
    np.testing.assert_allclose(imps.expectation_value("N").real[mid % cell],
                               fin.expectation_value("N").real[mid], atol=2e-6)
    corr_inf = imps.correlation_function_infinite("Cd", "C", max_range=4)
    corr_fin = fin.correlation_function("Cd", "C")
    for r in range(1, 5):
        np.testing.assert_allclose(corr_inf[mid % cell, r - 1], corr_fin[mid, mid + r],
                                   atol=5e-6)
