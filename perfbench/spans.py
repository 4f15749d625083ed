"""What the traced run records: the port's stage spans as intervals, the
launches of the kernels with a cost module, and the profiler's device
timeline, reduced in memory.

The program is not changed: the harness records around its public
``temfpy_torch.profiling`` hooks and wraps kernel entry points by name
for the traced run only.
"""

from __future__ import annotations

import contextlib
import importlib
import time

import timeline

STATE_SPAN = "state"
"""The harness's own span around one conversion."""
_STAGE_PREFIX = "stage:"
_PROFILER_NOISE = ("Buffer Flush", "Activity Buffer Request")


def interval_profile_class(profiling):
    """A ``profiling.Profile`` that also keeps each stage's interval
    (name, start, end) on the host clock: ``add`` is called as the stage
    ends, after the collector's synchronisation."""

    class IntervalProfile(profiling.Profile):
        def __init__(self):
            super().__init__()
            self.spans: list[tuple[str, float, float]] = []

        def add(self, name, dt):
            super().add(name, dt)
            end = time.perf_counter()
            self.spans.append((name, end - dt, end))

    return IntervalProfile


@contextlib.contextmanager
def stage_collector(profiling):
    """The port's stage collector (it synchronises the card at the end of
    every stage), collecting into an interval profile."""
    saved = profiling.Profile
    profiling.Profile = interval_profile_class(profiling)
    try:
        with profiling.collect() as prof:
            yield prof
    finally:
        profiling.Profile = saved


@contextlib.contextmanager
def profiler_labels(profiling, torch):
    """Marks every port stage as a ``torch.profiler`` range named
    "stage:<name>", without a collector and without synchronising, so the
    device timeline keeps its overlap and idle gaps can be labelled."""
    saved = profiling.stage

    @contextlib.contextmanager
    def stage(name):
        with torch.profiler.record_function(_STAGE_PREFIX + name):
            yield

    profiling.stage = stage
    try:
        yield
    finally:
        profiling.stage = saved


class KernelMeter:
    """Wraps the entry points that each cost module names (PATCH,
    "module:attribute") and keeps every launch's (operations, bytes), as
    device tensors, until :meth:`totals`."""

    def __init__(self, torch, cost_modules):
        self.torch = torch
        self.costs = cost_modules
        self.work = {name: [] for name in cost_modules}
        self._saved = []

    def __enter__(self):
        for name, mod in self.costs.items():
            for target in mod.PATCH:
                modname, attr = target.split(":")
                owner = importlib.import_module(modname)
                fn = getattr(owner, attr)
                self._saved.append((owner, attr, fn))
                setattr(owner, attr, self._wrap(name, mod, fn))
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved.clear()

    def _wrap(self, name, mod, fn):
        def launch(*args, **kw):
            out = fn(*args, **kw)
            self.work[name].append(mod.cost(self.torch, args, kw, out))
            return out
        return launch

    def totals(self):
        """Per kernel: (launches, least seconds summed over launches)."""
        from costs.peaks import bound_ms

        out = {}
        for name, work in self.work.items():
            least = 0.0
            for flops, nbyte in work:
                least += bound_ms(float(flops), float(nbyte))[0] / 1e3
            out[name] = (len(work), least)
        return out


def _is_host_range(name: str) -> bool:
    return name == STATE_SPAN or name.startswith(_STAGE_PREFIX)


def device_record(prof, torch):
    """Reduces a finished ``torch.profiler`` run in memory, from its raw
    activity records (parsing them into ``prof.events()`` takes minutes on
    a conversion's trace): the device intervals (kernels, copies, memsets)
    merged over streams, device seconds by operation name, and the time the
    device idled in the window, by the host span open at the time.  The
    window runs from the first state's start to the last state's end."""
    dev, by_name, host = [], {}, []
    for ev in prof.profiler.kineto_results.events():
        name, s, e = ev.name(), ev.start_ns(), ev.end_ns()
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            # the device-side copies of the host ranges below are no device work
            if name in _PROFILER_NOISE or _is_host_range(name):
                continue
            dev.append((s, e))
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
        elif name.startswith(_STAGE_PREFIX):
            host.append((name[len(_STAGE_PREFIX):], s, e))
        elif name == STATE_SPAN:
            host.append((STATE_SPAN, s, e))
    states = [h for h in host if h[0] == STATE_SPAN]
    lo, hi = min(h[1] for h in states), max(h[2] for h in states)
    busy = timeline.merge(timeline.clip(dev, lo, hi))
    idle = timeline.label_gaps(timeline.gaps(busy, lo, hi), host, "between states")
    return {"window_s": (hi - lo) / 1e9,
            "busy_s": sum(e - s for s, e in busy) / 1e9,
            "device_ops": by_name, "idle_by_stage": {k: v / 1e9 for k, v in idle.items()}}
