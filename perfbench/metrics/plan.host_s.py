"""Seconds per state planning the site fills on the host: the self times of
the port's stages ``fill/plan`` and ``fill/plan_fill``, traced run, host
half."""

STAGES = ("fill/plan", "fill/plan_fill")


def read(rec):
    if not rec.host_states or not any(s in rec.host_self for s in STAGES):
        return None
    return sum(rec.host_self.get(s, 0.0) for s in STAGES) / rec.host_states
