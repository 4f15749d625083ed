"""K1 ``det_fill``'s share of its roofline, %: the least time of the
window's launches (``costs/det_fill.py``: the work these inputs need, at
67 TFLOP/s FP64 or 3.35 TB/s, whichever bounds) over their device time in
the profiler's trace, traced run, device half."""

KERNEL = "det_fill"


def read(rec):
    k = rec.kernels.get(KERNEL)
    if not k or not k["launches"] or k["device_s"] <= 0:
        return None
    return 100.0 * k["least_s"] / k["device_s"]
