"""The frozen cost arithmetic gives chip_smoke's figures on one synthetic
launch of each kernel."""

import sys

import pytest
import torch

import manifest
from costs import peaks


def _torch(a):
    """The seeded cases come as numpy (nested tuples allowed)."""
    if isinstance(a, (tuple, list)):
        return tuple(_torch(x) for x in a)
    return torch.as_tensor(a)


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, str(manifest.ROOT))
    import chip_smoke as cs

    return cs


def test_peaks_and_bound_equal_chip_smoke(chip_smoke):
    assert (peaks.FP64_PEAK, peaks.HBM_RATE, peaks.CMA_FLOP) == (
        chip_smoke.FP64_PEAK, chip_smoke.HBM_RATE, chip_smoke.CMA_FLOP)
    for flops, nbyte in ((1e9, 1e6), (1e6, 1e9), (0.0, 0.0)):
        assert peaks.bound_ms(flops, nbyte) == chip_smoke.bound_ms(flops, nbyte)


def test_det_fill_cost_equals_chip_smoke(chip_smoke):
    from temfpy_torch import testing

    from costs import det_fill

    args, kw = testing.random_det_fill_case(5, G=3, w=8, m=12, P=40)
    args = _torch(args)
    mine = det_fill.cost(torch, args, kw, None)
    theirs = chip_smoke.det_fill_cost(torch, args, kw, None)
    assert float(mine[0]) == float(theirs[0]) > 0
    assert float(mine[1]) == float(theirs[1]) > 0


def test_pf_fill_cost_equals_chip_smoke(chip_smoke):
    from temfpy_torch import testing

    from costs import pf_fill

    args, kw = testing.random_pf_fill_case(7, G=3, w=8, m=16, P=40)
    args = _torch(args)
    mine = pf_fill.cost(torch, args, kw, None)
    theirs = chip_smoke.pf_fill_cost(torch, args, kw, None)
    assert isinstance(mine[0], torch.Tensor)  # no synchronisation per launch
    assert float(mine[0]) == pytest.approx(theirs[0], rel=1e-15) and theirs[0] > 0
    assert float(mine[1]) == float(theirs[1]) > 0
