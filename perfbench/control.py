"""Readings that the limits of a cell are set from, at the cell's own size
(on the card; ``--device cpu`` at a test's size).

    python3 perfbench/control.py --workload <cell> --seeds 1 2 3 ... [--control 3]

For each seed: the program converts the window's first input as the window
does, and the plain reference judges it (the lower readings); for the
first ``--control`` seeds the reference in the next lower precision
(float32 for the float64 Slater path, complex64 for complex128) stands in
the program's place (the upper readings).  One JSON line per reading;
with ``--per-site``, a line more per compared site with the program's
``tensor_gap`` there, to find where a reading comes from.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import checks  # noqa: E402
import harness  # noqa: E402
import manifest  # noqa: E402


def per_site(prog, ref):
    """The program's ``tensor_gap`` site by site."""
    return {i: checks.compare({**prog, "tensors": {i: T}}, {**ref, "tensors": {i: R}})["tensor_gap"]
            for (i, T), R in zip(prog["tensors"].items(), ref["tensors"].values())}


def readings(cell, seeds, n_control, device, sites_per_site=False, out=sys.stdout):
    entry, ref = cell.module("entries"), cell.module("references")
    spec = cell.spec
    for k, seed in enumerate(seeds):
        H = harness.inputs(cell, seed, [1])[0]
        t0 = time.perf_counter()
        mps = entry.convert(H, spec["chi_max"], None if device != "cpu" else device)
        L = len(mps._B)
        sites = harness.check_sites(L, spec["check_sites"], seed)
        prog = entry.extract(mps, sites)
        del mps
        t1 = time.perf_counter()
        r64 = ref.state(H, spec["chi_max"], sites, device)
        t2 = time.perf_counter()
        row = {"seed": seed, "program": checks.compare(prog, r64),
               "convert_s": t1 - t0, "reference_s": t2 - t1}
        if k < n_control:
            low = ref.state(H, spec["chi_max"], sites, device, ref.CONTROL)
            row["control"] = checks.compare(low, r64)
            row["control_s"] = time.perf_counter() - t2
        print(json.dumps(row), file=out, flush=True)
        if sites_per_site:
            for i, gap in per_site(prog, r64).items():
                print(json.dumps({"seed": seed, "site": int(i), "tensor_gap": gap}), file=out,
                      flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--per-site", action="store_true")
    a = ap.parse_args()
    readings(manifest.Cell(a.workload), a.seeds, a.control, a.device, a.per_site)


if __name__ == "__main__":
    main()
