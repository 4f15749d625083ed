"""The CUDA kernels against their plain PyTorch twins, on the card.

Marked ``cuda``: skipped where torch sees no GPU (the decision is taken in
a fixture, at run time).  Run on a machine with a card with

    PYTHONPATH=.:tests python -m pytest tests/test_torch_cuda.py -q

Tolerance 1e-12 relative to the largest entry: kernel and twin run the
same float64 pivoted elimination and differ only in summation order.
"""

import numpy as np
import pytest
import torch

from temfpy_torch import slater, testing
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
