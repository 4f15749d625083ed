"""temfpy_torch.ops.fw (the Fishman-White frontend) against
temfpy_tpu.ops.fw on the same numpy inputs, both on the CPU (the port runs
the plain twin of its ``fw_frame_slab`` kernel there), and the size
dispatch of the two overlap kernels.

Tolerances:
- the sweep is the same host numpy arithmetic in both packages: V, n, P
  to 1e-12;
- per-cut spectra and frames: the Gram eighs are the same numpy calls and
  the frames the same float64 products in another summation order, so
  spectra to 1e-12 and frames as weighted projectors (column gauge free)
  to 1e-12;
- the frame slab alone: one product of O(1) entries summed over <= 32
  terms, 1e-13;
- whole conversions: the two packages' exact centre-cut eighs round
  differently at ~1e-15, and Schmidt values are products of up to ~10 mode
  weights, so squared Schmidt values to 1e-12 and <c^dag c> to 1e-10; the
  port's FW against its exact frontend within the JAX package's contract,
  2 fw_total_tol (tests/test_fw.py).
"""

import numpy as np
import pytest
import torch

import temfpy_torch.testing as ttst
from temfpy_torch import slater
from temfpy_torch.mps.io import mps_from_arrays
from temfpy_torch.ops import fw, kernels
from temfpy_tpu import slater as jslater
from temfpy_tpu.ops import fw as jfw
from test_fw import cylinder_H, ground_C


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU twins run many small tensor operations; one intra-op
    thread keeps them from spinning the pool's idle threads, which under a
    parallel test run costs far more than it gains."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for name in ("FW", "FW_MIN_L", "FW_W0", "FW_WMAX", "FW_TOL", "FW_ATOL", "FW_TTOL",
                 "FW_STOL", "FW_SLAB"):
        monkeypatch.delenv(f"TEMFPY_TORCH_{name}", raising=False)
        monkeypatch.delenv(f"TEMFPY_TPU_{name}", raising=False)
    old = ttst.TEST_ACTION
    ttst.TEST_ACTION = "raise"
    fw.fw_clear_cache()
    jfw.fw_clear_cache()
    yield
    fw.fw_clear_cache()
    jfw.fw_clear_cache()
    ttst.TEST_ACTION = old


def test_fw_disentangle_matches_jax():
    C = ground_C(cylinder_H(48, W=4))
    got, ref = fw.fw_disentangle(C), jfw.fw_disentangle(C)
    assert got is not None and ref is not None
    for a in ("V", "n", "P"):
        np.testing.assert_allclose(getattr(got, a), getattr(ref, a), rtol=0, atol=1e-12)
    assert got.max_err == pytest.approx(ref.max_err, abs=1e-15)


def test_both_packages_fall_back_on_delocalized(monkeypatch):
    """tests/test_fw.py:167-179: a Haar-random occupied subspace has no
    localized modes, so both sweeps return None."""
    for pkg in ("TORCH", "TPU"):
        monkeypatch.setenv(f"TEMFPY_{pkg}_FW_W0", "8")
        monkeypatch.setenv(f"TEMFPY_{pkg}_FW_WMAX", "16")
    L = 48
    Q, _ = np.linalg.qr(np.random.default_rng(5).normal(size=(L, L)))
    C = Q[:, : L // 2] @ Q[:, : L // 2].T
    assert fw.fw_frames(C, [L // 2], "L", 1e-12, "cpu") is None
    assert jfw.fw_frames(C, [L // 2], "L", 1e-12) is None


@pytest.mark.parametrize("side", ["L", "R"])
def test_fw_frames_match_jax(side, monkeypatch):
    """Every cut of an L=48 cylinder, in slabs of 16 cuts so that a short
    last slab and per-slab widths occur."""
    monkeypatch.setenv("TEMFPY_TORCH_FW_SLAB", "16")
    monkeypatch.setenv("TEMFPY_TPU_FW_SLAB", "16")
    L = 48
    C = ground_C(cylinder_H(L, W=4))
    sizes = list(range(L + 1))
    got = fw.fw_frames(C, sizes, side, 1e-12, "cpu")
    ref = jfw.fw_frames(C, sizes, side, 1e-12)
    assert got is not None and ref is not None
    for i, x in enumerate(sizes):
        e, e0 = got[0][i], np.asarray(ref[0][i])
        np.testing.assert_allclose(e, e0, rtol=0, atol=1e-12, err_msg=f"{side} cut {x}")
        assert got[1][i] == ref[1][i]
        assert tuple(got[2][i].shape) == tuple(np.asarray(ref[2][i]).shape)
        w = x - got[1][i]
        Ff, Fj = got[2][i].numpy()[:, :w], np.asarray(ref[2][i])[:, :w]
        ew = e[got[1][i]:]
        dev = np.abs((Ff * ew) @ Ff.T - (Fj * ew) @ Fj.T).max() if w else 0.0
        assert dev <= 1e-12, f"{side} cut {x}: projector dev {dev:.3e}"
        np.testing.assert_array_equal(got[2][i].numpy()[:, w:], 0.0)


@pytest.mark.parametrize("side", ["L", "R"])
def test_fw_frame_slab_plain_matches_jax(side):
    """Seeded V, Cmat and flat with every kind of pad: Xidx pads (zero Cmat
    rows), Fidx = -1 columns, colmap pads, pad cuts (xs = 0), and colmap
    orders that are not the packing's identity."""
    L, B, kb, keb, fb, Wb = 40, 8, 16, 8, 8, 24
    VT, flat, Cmat = ttst.random_fw_slab_case(11 if side == "L" else 12, L=L, B=B, kb=kb,
                                              keb=keb, fb=fb, Wb=Wb, n_cuts=B - 2)
    got = kernels.fw_frame_slab(torch.as_tensor(VT), torch.as_tensor(flat),
                                torch.as_tensor(Cmat), side=side, L=L, kb=kb, fb=fb, Wb=Wb)
    ref = np.asarray(jfw._fw_frame_slab(VT.T, flat, Cmat, side=side, L=L, B=B, kb=kb, fb=fb,
                                        Wb=Wb))
    assert got.shape == (B, L, Wb)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-13)
    np.testing.assert_array_equal(got.numpy()[B - 2:], 0.0)


def _conversion_case():
    """tests/test_fw.py:93-122: L=48 ladder, seeded 1e-3 disorder."""
    L = 48
    H = cylinder_H(L, W=2)
    H += np.diag(1e-3 * np.random.default_rng(7).normal(size=L))
    return H, {"chi_max": 64, "svd_min": 1e-5}


def test_fw_conversion_matches_jax_and_exact_frontend(monkeypatch):
    """Both packages convert the same numpy C: the sweep's window widening
    compares each site's error with fw_tol = 1e-11, so two correlation
    matrices that differ at 1e-15 (two eighs of H) may freeze different
    but equally valid modes, and the two states then differ at the frozen
    error (4e-11 in squared Schmidt values at this shape), not at rounding."""
    H, tp = _conversion_case()
    L = H.shape[0]
    C = slater.correlation_matrix(H, device="cpu")[0].numpy()
    monkeypatch.setenv("TEMFPY_TORCH_FW_W0", "16")
    monkeypatch.setenv("TEMFPY_TPU_FW_W0", "16")
    monkeypatch.setenv("TEMFPY_TPU_FW", "1")
    monkeypatch.setenv("TEMFPY_TPU_DET_UPDATES", "0")
    ref = jslater.C_to_MPS(C, tp)
    monkeypatch.setenv("TEMFPY_TORCH_FW", "1")
    calls = []
    cut_data = fw._cut_data_batch
    monkeypatch.setattr(fw, "_cut_data_batch",
                        lambda *a, **k: calls.append(a[2]) or cut_data(*a, **k))
    got = slater.C_to_MPS(C, tp, device="cpu")
    assert sorted(set(calls)) == ["L", "R"], "the FW frontend did not run"
    monkeypatch.setenv("TEMFPY_TORCH_FW", "0")
    exact = slater.C_to_MPS(C, tp, device="cpu")
    # the JAX state's <c^dag c> through the port's engine (compiling the JAX
    # package's correlation kernels would double this test's time)
    ref_t = mps_from_arrays([np.array(B) for B in ref._B], ref._S, ref.q_bond, ref.qtotal,
                            ref.form, device="cpu")
    C = np.asarray(ref_t.correlation_function("Cd", "C"))
    np.testing.assert_allclose(got.correlation_function("Cd", "C"), C, rtol=0, atol=1e-10)
    budget = 2 * fw.fw_total_tol(L)
    for b in range(L + 1):
        np.testing.assert_array_equal(got.q_bond[b], np.asarray(ref.q_bond[b]))
        s, s0 = np.sort(got.get_SL(b)), np.sort(np.asarray(ref._S[b]))
        np.testing.assert_allclose(s**2, s0**2, rtol=0, atol=1e-12, err_msg=f"bond {b}")
        se = np.sort(exact.get_SL(b))
        assert se.shape == s.shape, f"bond {b} dimension"
        np.testing.assert_allclose(s, se, rtol=0, atol=budget)
    CdC = np.asarray(got.correlation_function("Cd", "C"))
    assert np.abs(CdC - np.asarray(exact.correlation_function("Cd", "C"))).max() < 20 * (
        fw.fw_total_tol(L))


def test_use_fw_modes(monkeypatch):
    """auto: off on every device and at every L (the exact frontend is the
    faster and more exact one on the card); "1" forces it on; "0" and a
    complex C turn it off."""
    C = torch.zeros((800, 800), dtype=torch.float64)
    assert fw.fw_mode() == "auto" and not fw.use_fw(C, 800) and not fw.use_fw(C.numpy(), 4096)
    assert not hasattr(fw, "fw_min_L")
    monkeypatch.setenv("TEMFPY_TORCH_FW", "1")
    assert fw.use_fw(C, 800) and fw.use_fw(C.numpy(), 8)
    assert not fw.use_fw(C.to(torch.complex128), 800)
    monkeypatch.setenv("TEMFPY_TORCH_FW", "0")
    assert not fw.use_fw(C, 800)


@pytest.mark.parametrize("dtype,limit", [(torch.float64, 169), (torch.complex128, 120)])
def test_site_overlap_picks_gmem_above_shared_memory(dtype, limit):
    """The largest mb whose mb x mb matrix (+ pivot column, determinant)
    fits in 227 KB runs the shared-memory kernel; one more runs the
    global-memory one."""
    assert kernels.site_overlap_fits_smem(limit, dtype)
    assert not kernels.site_overlap_fits_smem(limit + 1, dtype)
    assert not kernels.site_overlap_fits_smem(320, dtype)


@pytest.mark.parametrize("k", [8, 24, 48])
def test_bdg_overlap_picks_gmem_above_shared_memory(k):
    """The global-memory elimination takes exactly the half sizes whose U*
    no cluster of 8 blocks holds in registers (nb > 256), at every active
    count k (the layout depends on nb alone); the per-site workspace grows
    with k."""
    assert kernels.bdg_overlap_layout(64)[0] == 1
    assert kernels.bdg_overlap_layout(96)[0] == 2
    nb = max(n for n in range(1, 400) if kernels.bdg_overlap_layout(n)[0] > 0)
    assert nb == 256 and kernels.bdg_overlap_layout(nb + 1) == (0, 0, 0)
    assert kernels.bdg_overlap_workspace(nb, k, k) == 2 * nb * nb + 2 * k * nb + 2 * k * k


def test_sweep_cache_keyed_by_values():
    """One sweep per matrix: a second copy of the same values reuses it, the
    same array changed in place gets a new one."""
    C = ground_C(cylinder_H(32, W=4))
    first = fw._cached_sweep(C)
    assert fw._cached_sweep(C.copy()) is first
    C[0, 0] += 1e-3
    assert fw._cached_sweep(C) is not first
