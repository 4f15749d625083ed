"""Seconds per state in the grouped fill launches, uploads and their device
work included: the self times of the port's stages ``fill/overlap_groups``
with ``fill/det_groups`` and ``fill/resolve`` (Slater) or ``fill/pf_groups``
(Pfaffian), traced run, host half."""

STAGES = ("fill/overlap_groups", "fill/det_groups", "fill/resolve", "fill/pf_groups")


def read(rec):
    if not rec.host_states or not any(s in rec.host_self for s in STAGES):
        return None
    return sum(rec.host_self.get(s, 0.0) for s in STAGES) / rec.host_states
