"""Seconds per state of the converters' own host work outside the
streamed cuts: the self times of the port's stages ``correlation_matrix``
(the BdG or hopping eigh and its downloads), ``prepare`` (C's host copy,
basis change, checks and upload), ``centre_cut`` (the centre bond's
Schmidt vectors) and ``assembly`` (the MPS), traced run, host half."""

STAGES = ("correlation_matrix", "prepare", "centre_cut", "assembly")


def read(rec):
    if not rec.host_states or not any(s in rec.host_self for s in STAGES):
        return None
    return sum(rec.host_self.get(s, 0.0) for s in STAGES) / rec.host_states
