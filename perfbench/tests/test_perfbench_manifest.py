"""Every cell's files are found by name from BENCHMARK.json, and the
manifest keeps the contract's shape."""

import json
import re

import pytest

import manifest
from pb_helpers import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_manifest_shape():
    b = manifest.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["perfbench"] and b["command"][1] == "perfbench/run.py"
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[key]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in b["end_to_end"]}
    assert {"time_per_state_s", "setup_s"} <= e2e
    assert all(m["moves"] in e2e for m in b["per_layer"])
    assert all(w["chips"] == 1 for w in b["workloads"])
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("name", cells())
def test_cell_files_found_by_name(name):
    cell = manifest.Cell(name)
    assert cell.spec["config"] == cell.entry["config"]
    assert cell.spec["traffic"] == cell.entry["traffic"]
    for kind in ("hamiltonians", "entries", "references"):
        assert cell.module(kind) is not None
    for key in ("spectrum_gap", "structure_errors"):
        assert key in cell.spec["limits"]
    assert cell.spec["limits"]["structure_errors"] == 0
    per_layer = cell.per_layer()
    assert per_layer, "every cell reports at least one per-layer metric"
    for m in per_layer:
        assert callable(manifest.reader(m["name"]).read)


def test_cost_modules_found():
    costs = manifest.cost_modules()
    assert set(costs) >= {"det_fill", "pf_fill"}
    for mod in costs.values():
        assert mod.DEVICE_NAME.endswith("_kernel") and mod.PATCH


def test_inputs_do_not_depend_on_how_many_are_made():
    import harness
    from pb_helpers import tiny_cell

    cell = tiny_cell("pfaffian_pip8.Lx16_chi256")
    few, many = harness.inputs(cell, 2**31 + 9, [1, 2]), harness.inputs(cell, 2**31 + 9, range(6))
    assert all((a == b).all() for a, b in zip(few, many[1:3]))
    assert not (many[1] == many[2]).all()


@pytest.mark.parametrize("seconds,warmup_s,keep,n", [(45, 1.5, 2, 121), (45, 100.0, 2, 3),
                                                     (1, 0.0, 2, 4001)])
def test_the_pool_follows_the_warm_up(seconds, warmup_s, keep, n):
    import harness

    assert harness.pool_size(seconds, warmup_s, keep) == n
