"""The runs that a cell's bounds are set from: two sets of runs on the same
seeds, one process at a time, then each end-to-end metric's median and
spread (the first-to-third quartile distance over the median, as
``statistics.quantiles`` gives them) per set.

    python3 perfbench/sets.py --workload <cell> --seeds 1 2 3 4 5 6 [--sets 2] [--trace 0]

Each run's result line goes to standard output as it ends, with its set and
seed; the summary follows, one JSON line per set.  A run's first run in a
fresh checkout builds the kernel library: its ``setup_s`` is the build's.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def spread(values: list[float]) -> float:
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def run(workload: str, seed: int, seconds: int, trace: int) -> dict:
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", workload, "--seed",
                        str(seed), "--seconds", str(seconds), "--trace", str(trace)],
                       capture_output=True, text=True, cwd=HERE.parent)
    lines = p.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if p.returncode == 0 and lines else None
    return {"rc": p.returncode, "wall_s": time.perf_counter() - t0, "result": result,
            "err_tail": p.stderr[-600:]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", type=int,
                    default=json.loads((HERE.parent / "BENCHMARK.json").read_text())["run_seconds"])
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args()
    for k in range(a.sets):
        values: dict[str, list[float]] = {}
        for seed in a.seeds:
            r = run(a.workload, seed, a.seconds, a.trace)
            print(json.dumps({"set": k, "seed": seed, **r}), flush=True)
            for name, m in ((r["result"] or {}).get("metrics") or {}).items():
                values.setdefault(name, []).append(m["value"])
        print(json.dumps({"set": k, "summary": {
            name: {"median": statistics.median(v), "spread": spread(v) if len(v) > 1 else None,
                   "n": len(v)} for name, v in values.items()}}), flush=True)


if __name__ == "__main__":
    main()
