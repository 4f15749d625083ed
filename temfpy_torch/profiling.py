"""Stages, records, counters and profiler ranges of the port's own work
(counterpart of :mod:`temfpy_tpu.profiling`).

Usage::

    from temfpy_torch import profiling
    with profiling.collect() as prof:
        mps = slater.H_to_MPS(H, {"chi_max": 256})
    print(prof.report())
    prof.total("d2h_bytes"), prof.records[:3]

    with profiling.trace("traces/run1"):   # a TensorBoard device trace
        mps = slater.H_to_MPS(H, {"chi_max": 256})

- **Stages.** ``with profiling.stage(name):`` marks one pipeline stage.
  While a collector is active, the stage's wall time goes into it
  (:meth:`Profile.add`: sums and calls by name), and so does a
  :class:`Record`: its id, its parent's and its root's, its name, and its
  start and end on :func:`time.time_ns`, the clock on which torch's
  profiler stamps its events (the two stamps give ``add`` its seconds
  too).  CUDA work is asynchronous: under a collector
  every stage synchronises the current CUDA device when it ends, so that
  its time includes the device work it launched.
- **Roots.** A record's parent is the innermost enclosing stage, its root
  the outermost open stage or entry-point call (:func:`entry_point`): the
  stages of one conversion share its root.
- **Counters.** :func:`count` adds into every active collector, keyed by
  the innermost open stage.  The converters count the bytes of
  host <-> device copies where :func:`to_host` and :func:`to_device` make
  them (``d2h_bytes``, ``h2d_bytes``), host waits on the card (``syncs``:
  each download and each :func:`item` of a device tensor), and the calls
  of the fill kernels K1-K4 of :mod:`temfpy_torch.ops.kernels`
  (``launch/<wrapper>``, the CPU twins' calls included).
- **Profiler ranges.** While torch's profiler records, every stage is also
  a ``torch.profiler.record_function`` range named ``"stage:<name>"``.
  Without a collector the range does not synchronise.

Without a collector and without the profiler, a stage, a count or an
entry-point call costs a check of a module global and records nothing.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import time
from collections import defaultdict
from typing import NamedTuple

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

STAGE_PREFIX = "stage:"
"""Prefix of a stage's profiler range."""

_active: list["Profile"] = []
_open: list[tuple[int, str, bool]] = []
"""(id, name, is a stage) of the open stages and entry-point calls,
outermost first, kept while a collector is active."""
_ids = itertools.count(1)
_last: "Profile | None" = None
_OFF = contextlib.nullcontext()


class Record(NamedTuple):
    """One closed stage.  ``parent`` is None for a stage that no stage
    encloses; ``root`` may name an entry-point call, which keeps no record."""

    id: int
    parent: int | None
    root: int
    name: str
    start_ns: int
    end_ns: int

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class Profile:
    """What one collector saw: wall-clock sums and calls per stage name
    (``seconds``, ``calls``), the closed stages (``records``), the name of
    each root id (``roots``) and the counters by (stage, counter)
    (``counts``)."""

    def __init__(self):
        self.seconds: dict[str, float] = defaultdict(float)
        self.calls: dict[str, int] = defaultdict(int)
        self.records: list[Record] = []
        self.roots: dict[int, str] = {}
        self.counts: dict[tuple[str, str], int] = defaultdict(int)

    def add(self, name: str, dt: float):
        self.seconds[name] += dt
        self.calls[name] += 1

    def total(self, counter: str) -> int:
        """A counter summed over the stages it was counted in."""
        return sum(n for (_stage, c), n in self.counts.items() if c == counter)

    def self_seconds(self) -> dict[str, float]:
        """Per stage name, its records' durations less those of their child
        stages."""
        by_id = {r.id: r for r in self.records}
        out: dict[str, float] = defaultdict(float)
        for r in self.records:
            out[r.name] += r.seconds
            if r.parent in by_id:
                out[by_id[r.parent].name] -= r.seconds
        return dict(out)

    def report(self) -> str:
        """Calls, total and self seconds per stage, each stage's share of
        the total (the top-level stages' time, nested stages counted once),
        then each counter's total."""
        by_id = {r.id: r for r in self.records}
        own = self.self_seconds()
        top = sum(r.seconds for r in self.records if r.parent not in by_id)
        lines = [f"{'stage':<24} {'calls':>6} {'seconds':>10} {'self':>10} {'share':>7}"]
        for name in sorted(self.seconds, key=lambda k: -own[k]):
            share = own[name] / top if top else 0.0
            lines.append(f"{name:<24} {self.calls[name]:>6} {self.seconds[name]:>10.3f} "
                         f"{own[name]:>10.3f} {share:>6.1%}")
        lines.append(f"{'TOTAL':<24} {'':>6} {top:>10.3f}")
        for counter in sorted({c for _stage, c in self.counts}):
            lines.append(f"{counter:<24} {self.total(counter):>17}")
        return "\n".join(lines)


def last_profile() -> Profile | None:
    """The profile of the collector that closed most recently."""
    return _last


@contextlib.contextmanager
def collect():
    """Collects the stages and counters of everything run inside the
    context."""
    global _last
    prof = Profile()
    _active.append(prof)
    try:
        yield prof
    finally:
        _active.remove(prof)
        _last = prof


def _innermost_stage() -> tuple[int, str] | None:
    return next(((i, n) for i, n, is_stage in reversed(_open) if is_stage), None)


def _push(name: str, is_stage: bool) -> tuple[int, int | None, int]:
    """Opens a frame: returns (its id, its parent stage's, its root's)."""
    ident = next(_ids)
    if not _open:
        for prof in _active:
            prof.roots[ident] = name
    parent = _innermost_stage()
    root = _open[0][0] if _open else ident
    _open.append((ident, name, is_stage))
    return ident, parent and parent[0], root


class _Stage:
    """One stage under a collector, torch's profiler, or both."""

    __slots__ = ("name", "frame", "range", "t0_ns")

    def __init__(self, name: str):
        self.name = name
        self.frame = self.range = None

    def __enter__(self):
        # the record's stamps lie just inside its range
        if _autograd_profiler._is_profiler_enabled:
            self.range = torch.profiler.record_function(STAGE_PREFIX + self.name)
            self.range.__enter__()
        if _active:
            self.frame = _push(self.name, True)
            self.t0_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        try:
            if self.frame is not None and torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()
        finally:
            end_ns = time.time_ns()
            if self.range is not None:
                self.range.__exit__(*exc)
            if self.frame is not None:
                _open.pop()
        if self.frame is not None:
            # add first: a subclass may read the clock in it, and nothing
            # that allocates (and so may collect garbage) comes between
            for prof in _active:
                prof.add(self.name, (end_ns - self.t0_ns) / 1e9)
            record = Record(*self.frame, self.name, self.t0_ns, end_ns)
            for prof in _active:
                prof.records.append(record)
        return False


def stage(name: str):
    """One pipeline stage, recorded into every active collector and marked
    as a profiler range while torch's profiler records."""
    if not _active and not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Stage(name)


def entry_point(fn):
    """Marks ``fn`` as an entry point: under a collector, a call opens a
    frame (no stage: it keeps no record and does not synchronise) that,
    where nothing encloses it, roots the stages it runs."""

    @functools.wraps(fn)
    def call(*args, **kwargs):
        if not _active:
            return fn(*args, **kwargs)
        _push(fn.__name__, False)
        try:
            return fn(*args, **kwargs)
        finally:
            _open.pop()

    return call


def count(name: str, n: int = 1):
    """Adds ``n`` to counter ``name`` of every active collector, under the
    innermost open stage ("" where none is open)."""
    if not _active:
        return
    inner = _innermost_stage()
    key = (inner[1] if inner else "", name)
    for prof in _active:
        prof.counts[key] += n


def to_host(x) -> np.ndarray:
    """``x`` as a host numpy array; a device tensor is downloaded, and the
    download counted (``d2h_bytes``, and ``syncs``: the host waits for
    it)."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    if _active and x.device.type != "cpu":
        count("d2h_bytes", x.numel() * x.element_size())
        count("syncs")
    return x.detach().cpu().numpy()


def to_device(x, device, dtype=None, *, non_blocking: bool = False) -> torch.Tensor:
    """``x`` (a host array or a tensor) as a tensor on ``device``; an upload
    from the host to a device is counted (``h2d_bytes``).
    ``non_blocking`` takes a tensor in pinned memory."""
    if isinstance(x, torch.Tensor):
        from_host = x.device.type == "cpu"
        t = x.to(device=device, dtype=dtype, non_blocking=non_blocking)
    else:
        from_host = True
        t = torch.as_tensor(x, dtype=dtype, device=device)
    if _active and from_host and t.device.type != "cpu":
        count("h2d_bytes", t.numel() * t.element_size())
    return t


def item(t: torch.Tensor):
    """``t.item()``, counting the host wait (``syncs``) where ``t`` is on a
    device."""
    if _active and t.device.type != "cpu":
        count("syncs")
    return t.item()


@contextlib.contextmanager
def trace(logdir: str):
    """A ``torch.profiler`` trace of everything run inside the context (the
    CPU, and the CUDA device where torch sees one), written to ``logdir``
    in TensorBoard's format (``temfpy_tpu.profiling.trace`` on
    ``jax.profiler``)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(logdir))):
        yield
