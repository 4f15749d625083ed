"""The CUDA kernels against their plain PyTorch twins, on the card.

Marked ``cuda``: skipped where torch sees no GPU (the decision is taken in
a fixture, at run time).  Run on a machine with a card with

    PYTHONPATH=.:tests python -m pytest tests/test_torch_cuda.py -q

Tolerance 1e-12 relative to the largest entry: kernel and twin run the
same float64 / complex128 pivoted elimination and differ only in summation
order.
"""

import numpy as np
import pytest
import torch

from temfpy_torch import pfaffian, slater, testing
from temfpy_torch.ops import kernels

pytestmark = pytest.mark.cuda
RTOL = 1e-12


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)


@pytest.mark.parametrize("w", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("spec", ["rc", "rrc", "crr"])
@pytest.mark.parametrize("dtype", ["float64", "complex128"])
def test_det_fill_kernel_matches_twin(cuda, w, spec, dtype):
    args, kw = testing.random_det_fill_case(w, G=3, w=w, m=max(w, 24), P=5000, spec=spec,
                                            n_rows=256, dtype=dtype)
    a = [torch.as_tensor(x, device=cuda) for x in args[:6]]
    a.append(tuple(torch.as_tensor(t, device=cuda) for t in args[6]))
    before = kernels.det_fill.launches
    got = kernels.det_fill(*a, **kw)
    assert kernels.det_fill.launches == before + 1
    assert _rel(got, kernels.det_fill_plain(*a, **kw)) <= RTOL


@pytest.mark.parametrize("mode", ["left", "right"])
@pytest.mark.parametrize("kb,sb", [(64, 16), (64, 24), (32, 16), (32, 24), (32, 32), (8, 16),
                                   (0, 12)])
@pytest.mark.parametrize("dtype", ["float64", "complex128"])
def test_site_overlap_kernel_matches_twin(cuda, mode, kb, sb, dtype):
    """(kb, sb) as the L=256 conversion buckets them, and smaller ones."""
    args, kw = testing.random_site_overlap_case(kb + sb, G=5, L=256, kb=kb, sb=sb,
                                                mode=mode, dtype=dtype)
    a = [torch.as_tensor(x, device=cuda) for x in args]
    for i in (2, 3, 4, 6, 7, 8):
        a[i] = a[i].to(torch.int32)
    d1, s1 = kernels.site_overlap_schur(*a, **kw)
    d0, s0 = kernels.site_overlap_schur_plain(*a, **kw)
    assert _rel(d1, d0) <= RTOL
    assert _rel(d1[:, None, None] * s1, d0[:, None, None] * s0) <= RTOL


def test_kernels_reject_what_they_do_not_take(cuda):
    args, kw = testing.random_det_fill_case(0, G=1, w=8, m=16, P=300, n_rows=64)
    a = [torch.as_tensor(x, device=cuda) for x in args[:6]]
    tabs = tuple(torch.as_tensor(t, device=cuda) for t in args[6])
    with pytest.raises(TypeError):
        kernels.det_fill(a[0], a[1], a[2].long(), *a[3:], tabs, **kw)
    with pytest.raises(ValueError):
        kernels.det_fill(a[0], a[1], a[2].cpu(), *a[3:], tabs, **kw)
    wide = torch.zeros((1, 4, 65), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="width"):
        kernels.det_fill(a[0], a[1], wide, wide, *a[4:], tabs, **kw)


def test_conversion_on_cuda_matches_cpu(cuda):
    rng = np.random.default_rng(0)
    H = rng.normal(size=(40, 40))
    H = H + H.T
    tp = {"chi_max": 64}
    kernels.det_fill.launches = kernels.site_overlap_schur.launches = 0
    gpu = slater.H_to_MPS(H, tp, device=cuda)
    assert kernels.det_fill.launches > 0 and kernels.site_overlap_schur.launches > 0
    cpu = slater.H_to_MPS(H, tp, device="cpu")
    f = abs(gpu.overlap(cpu)) / np.sqrt(gpu.norm_squared() * cpu.norm_squared())
    assert f >= 1 - 1e-10


@pytest.mark.parametrize("w", [4, 8, 12, 16, 32])
@pytest.mark.parametrize("spec", ["rc", "rrc", "crr"])
def test_pf_fill_kernel_matches_twin(cuda, w, spec):
    """Widths of the main path and 32; fewer real pairs than P_b, so pad
    pairs reach the trash row."""
    args, kw = testing.random_pf_fill_case(w, G=3, w=w, m=max(2 * w, 24), P=3000, spec=spec,
                                           n_rows=128)
    a = [torch.as_tensor(x, device=cuda) for x in args[:8]]
    a.append(tuple(torch.as_tensor(t, device=cuda) for t in args[8]))
    before = kernels.pf_fill.launches
    got = kernels.pf_fill(*a, **kw)
    assert kernels.pf_fill.launches == before + 1
    assert _rel(got, kernels.pf_fill_plain(*a, **kw)) <= RTOL


@pytest.mark.parametrize("nb,k1,k2,x", [(8, 8, 8, 5), (32, 16, 8, 30), (32, 24, 24, 17),
                                        (64, 24, 24, 61), (64, 16, 24, 40)])
def test_bdg_overlap_kernel_matches_twin(cuda, nb, k1, k2, x):
    c = [torch.as_tensor(a, device=cuda)
         for a in testing.random_bdg_overlap_case(nb, G=5, nb=nb, k1=k1, k2=k2, x=x)]
    before = kernels.bdg_overlap.launches
    N, norm = kernels.bdg_overlap(*c)
    assert kernels.bdg_overlap.launches == before + 1
    N0, norm0 = kernels.bdg_overlap_plain(*c)
    assert _rel(N, N0) <= RTOL and _rel(norm, norm0) <= RTOL


def test_bdg_overlap_guard_poisons_the_norm(cuda):
    """A threshold above |det U| gives NaN, as the twin does."""
    c = [torch.as_tensor(a, device=cuda)
         for a in testing.random_bdg_overlap_case(1, G=2, nb=8, k1=8, k2=8)]
    c[4] = torch.tensor([2.0, 0.0], dtype=torch.float64, device=cuda)
    _N, norm = kernels.bdg_overlap(*c)
    assert bool(torch.isnan(norm[0])) and bool(torch.isfinite(norm[1]))
    assert bool(torch.isnan(kernels.bdg_overlap_plain(*c)[1][0]))


def test_pfaffian_conversion_on_cuda_matches_cpu(cuda):
    H = testing.pip_hamiltonian(4, 4)
    tp = {"chi_max": 32}
    kernels.pf_fill.launches = kernels.bdg_overlap.launches = 0
    gpu = pfaffian.H_to_MPS(H, tp, basis="C", device=cuda)
    assert kernels.pf_fill.launches > 0 and kernels.bdg_overlap.launches > 0
    cpu = pfaffian.H_to_MPS(H, tp, basis="C", device="cpu")
    f = abs(gpu.overlap(cpu)) / np.sqrt(gpu.norm_squared() * cpu.norm_squared())
    assert f >= 1 - 1e-10
    for b in range(gpu.L + 1):
        np.testing.assert_array_equal(gpu.q_bond[b], cpu.q_bond[b])


@pytest.mark.parametrize("side", ["L", "R"])
@pytest.mark.parametrize("kb,keb", [(64, 32), (256, 128)])
def test_fw_frame_slab_kernel_matches_twin(cuda, side, kb, keb):
    """One slab with Xidx, Fidx = -1 and colmap pads and a short last slab
    (pad cuts), at L = 256."""
    L, B, fb, Wb = 256, 16, 32, 128
    VT, flat, Cmat = testing.random_fw_slab_case(kb + keb, L=L, B=B, kb=kb, keb=keb, fb=fb,
                                                 Wb=Wb)
    a = [torch.as_tensor(x, device=cuda) for x in (VT, flat, Cmat)]
    kw = {"side": side, "L": L, "kb": kb, "fb": fb, "Wb": Wb}
    before = kernels.fw_frame_slab.launches
    got = kernels.fw_frame_slab(*a, **kw)
    assert kernels.fw_frame_slab.launches == before + 1
    assert _rel(got, kernels.fw_frame_slab_plain(*a, **kw)) <= RTOL
    assert float(got[-5:].abs().max()) == 0.0 < float(got.abs().max())


@pytest.mark.parametrize("mode", ["left", "right"])
@pytest.mark.parametrize("kb,sb,dtype", [(160, 32, "float64"), (96, 32, "complex128")])
def test_site_overlap_gmem_kernel_matches_twin(cuda, mode, kb, sb, dtype):
    """mb = 192 (float64) and 128 (complex128), above the shared-memory
    kernel's limit: the wrapper takes the global-memory kernel."""
    args, kw = testing.random_site_overlap_case(kb + sb, G=5, L=256, kb=kb, sb=sb,
                                                mode=mode, dtype=dtype)
    a = [torch.as_tensor(x, device=cuda) for x in args]
    for i in (2, 3, 4, 6, 7, 8):
        a[i] = a[i].to(torch.int32)
    smem, gmem = kernels.site_overlap_schur.launches, kernels.site_overlap_schur_gmem.launches
    d1, s1 = kernels.site_overlap_schur(*a, **kw)
    assert kernels.site_overlap_schur_gmem.launches == gmem + 1
    assert kernels.site_overlap_schur.launches == smem
    d0, s0 = kernels.site_overlap_schur_plain(*a, **kw)
    assert _rel(d1, d0) <= RTOL
    assert _rel(d1[:, None, None] * s1, d0[:, None, None] * s0) <= RTOL


@pytest.mark.parametrize("nb,k1,k2,x", [(96, 24, 24, 80), (128, 32, 24, 120)])
def test_bdg_overlap_gmem_kernel_matches_twin(cuda, nb, k1, k2, x):
    c = [torch.as_tensor(a, device=cuda)
         for a in testing.random_bdg_overlap_case(nb, G=4, nb=nb, k1=k1, k2=k2, x=x)]
    smem, gmem = kernels.bdg_overlap.launches, kernels.bdg_overlap_gmem.launches
    N, norm = kernels.bdg_overlap(*c)
    assert kernels.bdg_overlap_gmem.launches == gmem + 1
    assert kernels.bdg_overlap.launches == smem
    N0, norm0 = kernels.bdg_overlap_plain(*c)
    assert _rel(N, N0) <= RTOL and _rel(norm, norm0) <= RTOL
