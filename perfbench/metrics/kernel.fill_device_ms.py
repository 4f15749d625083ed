"""Device milliseconds per state of the fill kernels (Slater: K1
``det_fill`` and K2 ``site_overlap``/``site_schur``; Pfaffian: K3
``pf_fill`` and K4 ``bdg_products``/``bdg_eliminate``), summed by kernel
name from the profiler's trace, traced run, device half."""

NAMES = ("det_fill_kernel", "det_fill_wide_kernel", "site_overlap_kernel", "site_schur_kernel",
         "site_schur_gmem_kernel", "pf_fill_kernel", "bdg_products_kernel",
         "bdg_eliminate_kernel", "bdg_eliminate_gmem_kernel")


def read(rec):
    ms = sum(s for op, s in rec.device["device_ops"].items()
             if any(n in op for n in NAMES)) * 1e3
    if not rec.dev_states or ms == 0:
        return None
    return ms / rec.dev_states
