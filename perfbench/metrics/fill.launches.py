"""Calls per state of the fill kernels' wrappers: the program's counters
``launch/det_fill`` (K1), ``launch/site_overlap_schur`` and
``launch/site_overlap_schur_gmem`` (K2), ``launch/pf_fill`` (K3) and
``launch/bdg_overlap`` (K4) of the host half's
collector, over the states it completed, traced run, host half."""

COUNTERS = ("launch/det_fill", "launch/site_overlap_schur", "launch/site_overlap_schur_gmem",
            "launch/pf_fill", "launch/bdg_overlap")


def read(rec):
    from temfpy_torch import profiling

    last = getattr(profiling, "last_profile", None)
    prof = last() if last else None
    if prof is None or not rec.host_states:
        return None
    return sum(prof.total(c) for c in COUNTERS) / rec.host_states
