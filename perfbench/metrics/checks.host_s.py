"""Seconds per state in the library's shipped self-checks: the self times
of the port's stages ``checks/*`` (``checks/overlap``, the host contracts of
each site's Bogoliubov overlap inside ``fill/plan``; ``checks/nambu``, the
Nambu symmetry checks of H and C), traced run, host half."""

PREFIX = "checks/"


def read(rec):
    found = [s for name, s in rec.host_self.items() if name.startswith(PREFIX)]
    if not rec.host_states or not found:
        return None
    return sum(found) / rec.host_states
