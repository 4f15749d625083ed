"""Host waits on the card per state: the program's counter ``syncs`` (each
download and each ``profiling.item`` of a device tensor) of the host half's
collector, over the states it completed, traced run, host half."""

COUNTER = "syncs"


def read(rec):
    from temfpy_torch import profiling

    last = getattr(profiling, "last_profile", None)
    prof = last() if last else None
    if prof is None or not rec.host_states:
        return None
    return prof.total(COUNTER) / rec.host_states
