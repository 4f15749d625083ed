"""Arithmetic on timelines: time per state, unions of intervals, idle gaps,
self times of nested spans, and the spread of repeated runs.  Pure Python,
no torch, so the CPU tests hold it on synthetic timelines."""

from __future__ import annotations

import statistics


def time_per_state(t0: float, ends: list[float]) -> float:
    """Seconds per state of a closed loop that started at ``t0``: from the
    start to the end of the last state, over the states completed (the
    state in flight when the clock ran out is finished and counted)."""
    if not ends:
        raise ValueError("no state completed in the window")
    return (ends[-1] - t0) / len(ends)


def merge(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The parts of the intervals inside [lo, hi]."""
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def union_length(intervals) -> float:
    return sum(e - s for s, e in merge(intervals))


def gaps(busy, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no busy interval covers."""
    out, t = [], lo
    for s, e in merge(clip(busy, lo, hi)):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def self_times(spans) -> dict[str, float]:
    """Per name, the summed self time of (name, start, end) spans that nest
    strictly (a span of one thread): each span's duration less the parts
    its children cover."""
    out: dict[str, float] = {}
    stack: list[list] = []  # [name, start, end, covered by children]

    def close(top):
        out[top[0]] = out.get(top[0], 0.0) + (top[2] - top[1]) - top[3]
        if stack:
            stack[-1][3] += top[2] - top[1]

    for name, s, e in sorted(spans, key=lambda x: (x[1], -x[2])):
        while stack and stack[-1][2] <= s:
            close(stack.pop())
        stack.append([name, s, e, 0.0])
    while stack:
        close(stack.pop())
    return out


def segments(spans) -> list[tuple[float, float, str]]:
    """The host timeline of strictly nested (name, start, end) spans cut
    into disjoint (start, end, innermost name) segments."""
    out: list[tuple[float, float, str]] = []
    stack: list[tuple[str, float, float]] = []
    t = None

    def emit(upto):
        if stack and t is not None and upto > t:
            out.append((t, upto, stack[-1][0]))

    for name, s, e in sorted(spans, key=lambda x: (x[1], -x[2])):
        while stack and stack[-1][2] <= s:
            emit(stack[-1][2])
            t = stack.pop()[2]
        emit(s)
        stack.append((name, s, e))
        t = s
    while stack:
        emit(stack[-1][2])
        t = stack.pop()[2]
    return out


def label_gaps(idle, spans, outside: str) -> dict[str, float]:
    """Per innermost span name (``outside`` where none is open), the time
    of the ``idle`` intervals spent under it."""
    out: dict[str, float] = {}
    segs = segments(spans)
    k = 0
    for s, e in idle:
        t = s
        while k < len(segs) and segs[k][1] <= s:
            k += 1
        j = k
        while t < e:
            if j < len(segs) and segs[j][0] < e:
                a, b, name = segs[j]
                if a > t:
                    out[outside] = out.get(outside, 0.0) + (min(a, e) - t)
                    t = min(a, e)
                    continue
                end = min(b, e)
                out[name] = out.get(name, 0.0) + (end - t)
                t = end
                j += 1
            else:
                out[outside] = out.get(outside, 0.0) + (e - t)
                t = e
    return out


def spread(values) -> float:
    """Distance between the first and the third quartile over the median
    (``statistics.quantiles(values, n=4)``)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
