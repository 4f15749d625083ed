"""On the card: a short run of each cell at a test's size through the
kernels (the CPU runs their twins), correct and with the device's
numbers; and the traced run's device metrics."""

import time

import pytest

import harness
from pb_helpers import cells, tiny_cell


@pytest.mark.cuda
@pytest.mark.parametrize("name", cells())
def test_a_short_run_on_the_card(name, card, capsys):
    out = harness.run(tiny_cell(name), 2**31 + 17, 2.0, False, time.perf_counter())
    assert out is not None and out["correct"] is True
    assert out["device"]["platform"] == "gpu" and out["device"]["memory_peak_bytes"] > 0


@pytest.mark.cuda
def test_a_traced_run_on_the_card(card, capsys):
    out = harness.run(tiny_cell(cells()[0]), 2**31 + 19, 2.0, True, time.perf_counter())
    assert out["correct"] is True
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    assert 0 <= out["metrics"]["device.idle_pct"]["value"] < 100
    assert out["breakdown"]["device_ops"] and out["breakdown"]["idle_gaps"]
