"""One run of one cell: set-up, the measured window, the traced window's
per-layer metrics, and the comparison with the plain reference.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A state is one conversion of one Hamiltonian of the cell's pool (the clean
model plus a seeded on-site field), run back to back in a closed loop with
one client, each ending in ``torch.cuda.synchronize()``.  Set-up (timed as
``setup_s`` from the start of the process) imports the program, loads its
kernel library, runs one conversion at the cell's shape and builds the
pool on the host, sized from that conversion's time.  The untraced run
reports the end-to-end metrics.  The traced run splits its window in two
halves: the first under ``torch.profiler`` (the port's stages marked as
profiler ranges, the kernels with a cost module metered), the second under
the port's stage collector, which synchronises at every stage end; each
half is normalised by the states it completed.  After the window, a sample of the finished states drawn from
the seed is compared with the plain reference (``checks.py``).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import resource
import sys
import time
import traceback
from types import SimpleNamespace

import numpy as np

import checks
import manifest
import spans
import timeline

FORBIDDEN = ("jax", "jaxlib", "flax", "temfpy_tpu")
"""Top-level module names that may not be loaded in a run."""
POOL_MARGIN = 4
"""The pool holds this many times the states the window would finish at
the warm-up's pace (a cold state is slower than a warm one)."""


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def inputs(cell, seed: int, ks) -> list:
    """The cell's inputs ``ks`` from the seed, each the clean model plus an
    on-site field of its own (input 0 is the warm-up's): the same seed
    gives the same inputs, however many are made."""
    ham = cell.module("hamiltonians")
    spec, params = cell.spec, cell.config["params"]
    H0 = ham.build(params, spec["Lx"])
    n_sites = ham.n_sites(params, spec["Lx"])
    return [ham.with_field(H0, spec["disorder"] * np.random.default_rng(
        [seed % 2**64, 0, k]).standard_normal(n_sites)) for k in ks]


def pool_size(seconds: float, warmup_s: float, keep: int) -> int:
    """Inputs for the window after the warm-up's: ``POOL_MARGIN`` times
    what the window finishes at the warm-up's pace, at least ``keep`` + 1."""
    return max(keep + 1, int(math.ceil(POOL_MARGIN * seconds / max(warmup_s, 1e-3))) + 1)


class GcClock:
    """The interpreter's garbage collections and the seconds they took,
    while registered in ``gc.callbacks``."""

    def __init__(self):
        self.seconds, self.count, self._t = 0.0, 0, None

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.seconds += time.perf_counter() - self._t
            self.count += 1
            self._t = None


class Loop:
    """The closed loop over the pool, across one or two windows, with a
    reservoir sample (from the seed) of the finished states kept for the
    check."""

    def __init__(self, convert, pool, sync, keep: int, seed: int):
        self.convert, self.pool, self.sync = convert, pool, sync
        self.keep, self.rng = keep, np.random.default_rng([seed % 2**64, 1])
        self.j = 0
        self.kept: list[tuple[int, object]] = []
        self.attempted = self.failed = 0
        self.per_state: list[float] = []

    def window(self, seconds: float, state_span=contextlib.nullcontext) -> dict:
        t0 = time.perf_counter()
        ends = []
        while time.perf_counter() - t0 < seconds:
            j, H = self.j, self.pool[self.pool_index(self.j)]
            self.j += 1
            self.attempted += 1
            ts = time.perf_counter()
            try:
                with state_span():
                    out = self.convert(H)
                    self.sync()
            except Exception:  # a state that fails is counted, the loop goes on
                traceback.print_exc()
                self.failed += 1
                continue
            te = time.perf_counter()
            ends.append(te)
            self.per_state.append(te - ts)
            self._sample(j, out)
        return {"t0": t0, "ends": ends}

    def _sample(self, j, out):
        n = self.attempted - self.failed
        if len(self.kept) < self.keep:
            self.kept.append((j, out))
        else:
            r = int(self.rng.integers(0, n))
            if r < self.keep:
                self.kept[r] = (j, out)

    def pool_index(self, j: int) -> int:
        """State j's input: the pool, wrapping round only where the window
        outruns ``POOL_MARGIN`` times the warm-up's pace."""
        return j % len(self.pool)


def check_sites(L: int, n, seed: int) -> list[int]:
    """The sites whose tensors are compared: every site for ``n`` "all",
    else the two at the centre and ``n`` more drawn from the seed."""
    if n == "all":
        return list(range(L))
    rng = np.random.default_rng([seed % 2**64, 2])
    rest = [i for i in range(L) if i not in (L // 2 - 1, L // 2)]
    return sorted({L // 2 - 1, L // 2, *rng.choice(rest, size=min(n, len(rest)), replace=False)})


def judge(cell, loop, seed, device):
    """The compared numbers (worst over the sampled states) and ``correct``."""
    entry, reference = cell.module("entries"), cell.module("references")
    spec = cell.spec
    progs = []
    for j, mps in loop.kept:
        L = len(mps._B)
        sites = check_sites(L, spec["check_sites"], seed)
        progs.append((j, sites, entry.extract(mps, sites)))
    loop.kept.clear()
    gc.collect()
    if device != "cpu":
        import torch
        torch.cuda.empty_cache()
    readings = []
    for j, sites, prog in progs:
        ref = reference.state(loop.pool[loop.pool_index(j)], spec["chi_max"], sites, device)
        readings.append(checks.compare(prog, ref))
    limits = spec["limits"]
    if not readings:
        return {k: float("inf") for k in limits}, limits, False
    numbers = checks.worst(readings)
    return numbers, limits, checks.verdict(numbers, limits) and loop.failed == 0


def run(cell, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", require_card: bool = True, out=None, err=None):
    """One run of ``cell`` (a name, or a :class:`manifest.Cell`); prints the
    result line and returns it (None where the run could not measure).
    ``device`` "cpu" and ``require_card`` False are for the CPU tests."""
    out, err = out or sys.stdout, err or sys.stderr
    if isinstance(cell, str):
        cell = manifest.Cell(cell)
    import torch

    if require_card and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < cell.chips):
        print(f"perfbench: the cell needs {cell.chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=err)
        return None
    entry = cell.module("entries")
    from temfpy_torch import profiling

    on_card = device != "cpu"
    if on_card:
        from temfpy_torch.ops import _build
        _build.load()
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    spec = cell.spec

    def convert(H):
        return entry.convert(H, spec["chi_max"], None if on_card else device)

    t_warm = time.perf_counter()
    convert(inputs(cell, seed, [0])[0])  # warm-up at the cell's shape
    sync()
    n = pool_size(seconds, time.perf_counter() - t_warm, spec["check_states"])
    pool = inputs(cell, seed, range(1, n + 1))
    setup_s = time.perf_counter() - t_start

    loop = Loop(convert, pool, sync, spec["check_states"], seed)
    gc_clock = GcClock()
    gc.callbacks.append(gc_clock)
    if not trace:
        w = loop.window(seconds)
        done = len(w["ends"])
        metrics = {}
        if done:
            metrics["time_per_state_s"] = {"value": timeline.time_per_state(w["t0"], w["ends"]),
                                           "unit": "s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        dev_extra = {}
        breakdown = None
    else:
        metrics, dev_extra, breakdown = traced(torch, profiling, cell, loop, seconds, on_card)
    gc.callbacks.remove(gc_clock)

    peak = torch.cuda.max_memory_allocated() if on_card else 0
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: forbidden modules loaded: {', '.join(bad)}", file=err)
        return None
    print(json.dumps({"per_state_s": loop.per_state, "attempted": loop.attempted,
                      "failed": loop.failed, "pool": len(pool), "gc_s": gc_clock.seconds,
                      "gc_collections": gc_clock.count,
                      "host_maxrss_kb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss}),
          file=out)
    numbers, limits, correct = judge(cell, loop, seed, device)
    for k in limits:
        print(f"check {k} {numbers[k]!r} limit {limits[k]!r}", file=err)
    result = {
        "correct": bool(correct),
        "attempted": loop.attempted,
        "failed": loop.failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": cell.chips if on_card else 0,
                   "memory_peak_bytes": int(peak), **dev_extra},
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return result


def traced(torch, profiling, cell, loop, seconds, on_card):
    """The traced window: a device half under ``torch.profiler`` and a host
    half under the stage collector.  Returns (per-layer metrics, the
    device's busy_s and window_s, the breakdown)."""
    from torch.profiler import ProfilerActivity, profile

    half = seconds / 2
    costs = manifest.cost_modules()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with spans.KernelMeter(torch, costs) as meter, spans.profiler_labels(profiling, torch):
        with profile(activities=activities) as prof:
            dev_win = loop.window(half, lambda: torch.profiler.record_function(spans.STATE_SPAN))
    device = spans.device_record(prof, torch)
    del prof
    launches = meter.totals()
    with spans.stage_collector(profiling) as hp:
        host_win = loop.window(half)
    kernels = {}
    for name, (n, least) in launches.items():
        dev_s = sum(s for op, s in device["device_ops"].items() if costs[name].DEVICE_NAME in op)
        kernels[name] = {"launches": n, "least_s": least, "device_s": dev_s}
    rec = SimpleNamespace(cell=cell, device=device, kernels=kernels,
                          dev_states=len(dev_win["ends"]), host_states=len(host_win["ends"]),
                          host_self=timeline.self_times(hp.spans))
    metrics = {}
    for m in cell.per_layer():
        value = manifest.reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    top = sorted(device["device_ops"].items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(device["idle_by_stage"].items(), key=lambda kv: -kv[1])[:10]
    breakdown = {"device_ops": [[k[:160], v] for k, v in top],
                 "idle_gaps": [[k, v] for k, v in idle]}
    return metrics, {"busy_s": device["busy_s"], "window_s": device["window_s"]}, breakdown


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    result = run(a.workload, a.seed, a.seconds, bool(a.trace), t_start)
    return 0 if result is not None else 1
