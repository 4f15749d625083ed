"""Seconds per state in the exact frontend: the self time of the port's
stage ``eigh_batch`` (the batched ``torch.linalg.eigh`` of the cuts'
blocks, device work included: the collector synchronises at the stage's
end), in the traced run's host half, over the states it completed."""

STAGES = ("eigh_batch",)


def read(rec):
    if not rec.host_states or not any(s in rec.host_self for s in STAGES):
        return None
    return sum(rec.host_self.get(s, 0.0) for s in STAGES) / rec.host_states
