"""Megabytes per state downloaded from the card to the host: the
program's counter ``d2h_bytes`` (counted where ``profiling.to_host`` copies
a device tensor) of the host half's collector, over the states it
completed, / 1e6, traced run, host half."""

COUNTER = "d2h_bytes"


def read(rec):
    from temfpy_torch import profiling

    last = getattr(profiling, "last_profile", None)
    prof = last() if last else None
    if prof is None or not rec.host_states:
        return None
    return prof.total(COUNTER) / 1e6 / rec.host_states
