"""Megabytes per state uploaded from the host to the card: the program's
counter ``h2d_bytes`` (counted where ``profiling.to_device`` copies a host
array or tensor to a device) of the host half's collector, over the states
it completed, / 1e6, traced run, host half."""

COUNTER = "h2d_bytes"


def read(rec):
    from temfpy_torch import profiling

    last = getattr(profiling, "last_profile", None)
    prof = last() if last else None
    if prof is None or not rec.host_states:
        return None
    return prof.total(COUNTER) / 1e6 / rec.host_states
