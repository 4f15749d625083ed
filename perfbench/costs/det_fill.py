"""Work of one ``det_fill`` launch (kernel K1 of the Slater fill).

Frozen from ``chip_smoke.py:508-520`` (``det_fill_cost``).  The harness
wraps the entry points named in PATCH in the traced run and sums this
work over the launches whose device kernels contain DEVICE_NAME.
"""

from costs.peaks import nbytes

PATCH = ("temfpy_torch.slater:det_fill",)
DEVICE_NAME = "det_fill_kernel"


def cost(torch, args, kw, out):
    """(operations, bytes) of one det_fill group: an LU of the c x c block
    each pair needs (c = its occupied orbitals; sentinels add nothing),
    2c^3/3 real operations (x4 complex); every input once and one value per
    real pair.  Both may be 0-d device tensors (no synchronisation here)."""
    M, det, ob, ok, pr, pc, tabs = args
    cnt = (ob < M.shape[-1]).sum(-1)
    c = torch.gather(cnt, 1, pr.long()).double()
    mult = 4 if M.is_complex() else 1
    real = (pr != ob.shape[1] - 1).sum() * M.element_size()
    return (2.0 / 3.0 * c**3).sum() * mult, nbytes(*args) + real
