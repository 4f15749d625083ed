"""The per-layer metrics that read the program's own stages and counters:
a traced CPU run reports them beside the stage metrics, and against a
program without those stages and counters each reader returns nothing and
does not raise."""

import time
from types import SimpleNamespace

import pytest

import harness
import manifest
from pb_helpers import tiny_cell

NEW = ("driver.host_s", "checks.host_s", "transfer.d2h_mb", "transfer.h2d_mb", "transfer.syncs",
       "fill.launches")
STAGE_METRICS = ("frontend.eigh_s", "schmidt.host_s", "plan.host_s", "fill.groups_s")
"""The accepted metrics a CPU run can read (the device trace's three have
no card to read)."""


def test_a_traced_run_reports_the_program_span_metrics(capsys):
    out = harness.run(tiny_cell("pfaffian_pip8.Lx16_chi256"), 2**33 + 3, 1.0, True,
                      time.perf_counter(), device="cpu", require_card=False)
    capsys.readouterr()
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(NEW) | set(STAGE_METRICS) <= set(m) and out["correct"] is True
    assert m["driver.host_s"] > 0 and m["checks.host_s"] > 0 and m["fill.launches"] > 0
    # on the CPU nothing crosses to a device
    assert m["transfer.d2h_mb"] == m["transfer.h2d_mb"] == m["transfer.syncs"] == 0
    units = {x["name"]: x["unit"] for x in manifest.benchmark()["per_layer"]}
    assert all(out["metrics"][k]["unit"] == units[k] for k in NEW)


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_them_reads_nothing(name, monkeypatch):
    from temfpy_torch import profiling

    monkeypatch.delattr(profiling, "last_profile")
    rec = SimpleNamespace(host_states=3, host_self={"eigh_batch": 0.1, "fill/plan": 0.2})
    assert manifest.reader(name).read(rec) is None
