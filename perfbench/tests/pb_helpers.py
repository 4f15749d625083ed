"""Helpers of the benchmark's tests: cells shrunk to a test's size."""

import manifest

TINY = {"slater": {"W": 4, "Lx": 6, "chi_max": 32},
        "pfaffian": {"W": 4, "Lx": 4, "chi_max": 16}}
"""Test sizes: the published widths cut to what a CPU test holds."""


def tiny_cell(name: str, **spec) -> "manifest.Cell":
    """The cell with the test sizes of its family (and ``spec`` on top)."""
    cell = manifest.Cell(name)
    t = TINY[name.split("_")[0]]
    cell.config["params"]["W"] = t["W"]
    cell.spec.update({"Lx": t["Lx"], "chi_max": t["chi_max"], "check_sites": 4,
                      **spec})
    return cell


def cells():
    return [w["name"] for w in manifest.benchmark()["workloads"]]
