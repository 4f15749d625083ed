"""Seconds per state building the Schmidt modes and enumerating the kept
Schmidt states on the host: the self times of the port's stages
``schmidt_modes`` and ``schmidt_enumeration``, traced run, host half."""

STAGES = ("schmidt_modes", "schmidt_enumeration")


def read(rec):
    if not rec.host_states or not any(s in rec.host_self for s in STAGES):
        return None
    return sum(rec.host_self.get(s, 0.0) for s in STAGES) / rec.host_states
