"""Work of one ``pf_fill`` launch (kernel K3 of the Pfaffian fill).

Frozen from ``chip_smoke.py:1213-1232`` (``skew_update_entries``,
``pf_fill_cost``), with one change: the operation count stays a 0-d device
tensor (chip_smoke took ``float`` of it, which waits for the card at every
launch and would change the overlap the traced run measures).
"""

from costs.peaks import CMA_FLOP, nbytes, written_bytes

PATCH = ("temfpy_torch.pfaffian:pf_fill",)
DEVICE_NAME = "pf_fill_kernel"


def skew_update_entries(t):
    """Entries Parlett-Reid updates in a (2t x 2t) skew-symmetric matrix:
    step i (of t) updates the strict upper triangle of the trailing
    (2t - 2 - 2i)-wide block, sum_q (2q)(2q - 1)/2 = (t-1)t(2t-1)/3 -
    (t-1)t/2 (the lower triangle follows by skew symmetry), two
    multiply-adds each: about k^3/12 entries, k^3/3 real operations, for
    width k = 2t."""
    return (t - 1) * t * (2 * t - 1) / 3 - (t - 1) * t / 2


def cost(torch, args, kw, out):
    """(operations, bytes) of one pf_fill group: per pair of tot = nk + nb
    excitations, the Parlett-Reid updates of :func:`skew_update_entries`,
    two complex multiply-adds each; pad pairs need nothing.  Every input
    once and one value per real pair."""
    N, norm, pb, pk, cb, ck, pr, pc, tabs = args
    t = (torch.gather(cb, 1, pr.long()) + torch.gather(ck, 1, pc.long())).double() / 2
    return (skew_update_entries(t).sum() * 2 * CMA_FLOP,
            nbytes(*args) + written_bytes(pr, pb.shape[1] - 1, N))
