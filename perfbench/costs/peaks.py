"""The card's peaks and the least time of a launch (the roofline).

Frozen from ``chip_smoke.py:172-179`` (FP64_PEAK, HBM_RATE, CMA_FLOP) and
``chip_smoke.py:488-505`` (``nbytes``, ``bound_ms``, ``written_bytes``), so
that any later implementation of a kernel is read against the same work.
"""

FP64_PEAK = 67e12
"""FLOP/s: the H100 SXM data sheet's float64 tensor-core peak (dense), the
card's highest float64 rate, so a time derived from it is a lower bound."""
HBM_RATE = 3.35e12
"""bytes/s: the H100 SXM's device-memory rate (data sheet)."""
CMA_FLOP = 8
"""Real operations of one complex multiply-add (4 multiplies, 4 adds)."""


def nbytes(*ts):
    """Bytes of tensors (nested tuples allowed)."""
    return sum(nbytes(*t) if isinstance(t, (tuple, list)) else t.numel() * t.element_size()
               for t in ts)


def bound_ms(flops, nbyte):
    """(milliseconds, what bounds it): the least time the card could take to
    do ``flops`` float64 operations and move ``nbyte`` bytes."""
    t_op, t_by = flops / FP64_PEAK, nbyte / HBM_RATE
    return max(t_op, t_by) * 1e3, ("operations" if t_op >= t_by else "bytes")


def written_bytes(pr, pad_row, like):
    """Bytes of the values a fill writes: one per real pair (pad pairs, whose
    row id is ``pad_row``, land on the trash row), as a 0-d tensor."""
    return (pr != pad_row).sum() * like.element_size()
