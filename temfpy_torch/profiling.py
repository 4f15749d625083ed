"""Per-stage wall-clock timers (counterpart of :mod:`temfpy_tpu.profiling`).

Usage::

    from temfpy_torch import profiling
    with profiling.collect() as prof:
        mps = slater.H_to_MPS(H, {"chi_max": 256})
    print(prof.report())

CUDA work is asynchronous: while a collector is active, every stage
synchronises the current CUDA device when it ends, so that a stage's time
includes the device work it launched.  Without a collector a stage costs
nothing and synchronises nothing.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

_active: list["Profile"] = []


class Profile:
    """Accumulates wall-clock per pipeline stage."""

    def __init__(self):
        self.seconds: dict[str, float] = defaultdict(float)
        self.calls: dict[str, int] = defaultdict(int)

    def add(self, name: str, dt: float):
        self.seconds[name] += dt
        self.calls[name] += 1

    def report(self) -> str:
        total = sum(self.seconds.values())
        lines = [f"{'stage':<24} {'calls':>6} {'seconds':>10} {'share':>7}"]
        for name, sec in sorted(self.seconds.items(), key=lambda kv: -kv[1]):
            share = sec / total if total else 0.0
            lines.append(f"{name:<24} {self.calls[name]:>6} {sec:>10.3f} {share:>6.1%}")
        lines.append(f"{'TOTAL':<24} {'':>6} {total:>10.3f}")
        return "\n".join(lines)


@contextlib.contextmanager
def collect():
    """Collects per-stage timings of everything run inside the context."""
    prof = Profile()
    _active.append(prof)
    try:
        yield prof
    finally:
        _active.remove(prof)


@contextlib.contextmanager
def stage(name: str):
    """Times one pipeline stage into every active collector."""
    if not _active:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        for prof in _active:
            prof.add(name, dt)
