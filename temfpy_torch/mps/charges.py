"""Charge bookkeeping: a minimal, host-side replacement for TeNPy's
ChargeInfo/LegCharge machinery (cf. reference usage surveyed in SURVEY.md
section 2.2).

Only a single Abelian charge is ever needed by this library (fermion number
U(1), fermion parity Z2, or 2*Sz U(1)); we therefore store one integer label
per index instead of TeNPy's (index, n_charges) tables, and represent a
"leg" simply as a 1D numpy int array of per-index charges.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class ChargeInfo:
    """A single Abelian charge: U(1) if ``mod == 1``, else Z_mod.

    ``name`` is cosmetic ("N", "parity", "2Sz", or "" for no conservation).
    """

    mod: int = 1
    name: str = "N"

    def make_valid(self, q):
        """Canonical representative of charge(s) ``q``."""
        q = np.asarray(q, dtype=np.int64)
        return q if self.mod == 1 else np.mod(q, self.mod)

    def equal(self, q1, q2) -> np.ndarray:
        """Elementwise charge equality (mod-aware)."""
        d = np.asarray(q1, np.int64) - np.asarray(q2, np.int64)
        return d == 0 if self.mod == 1 else np.mod(d, self.mod) == 0

    def __repr__(self):
        kind = "U(1)" if self.mod == 1 else f"Z_{self.mod}"
        return f"ChargeInfo({kind}, {self.name!r})"


NO_CHARGE = ChargeInfo(mod=1, name="")
"""Trivial charge info used when nothing is conserved (all labels zero)."""


def fuse(qa: np.ndarray, qb: np.ndarray, chinfo: ChargeInfo) -> np.ndarray:
    """Outer-sum fusion of two charge label arrays: result[i*len(qb)+j] =
    qa[i] + qb[j] (the row-major convention used when two legs are reshaped
    into one)."""
    qa = np.asarray(qa, np.int64)
    qb = np.asarray(qb, np.int64)
    return chinfo.make_valid((qa[:, None] + qb[None, :]).reshape(-1))


def sectors_of(q: np.ndarray) -> dict[int, np.ndarray]:
    """Maps each distinct charge to the (sorted) indices carrying it."""
    q = np.asarray(q)
    out: dict[int, np.ndarray] = {}
    for val in np.unique(q):
        out[int(val)] = np.nonzero(q == val)[0]
    return out
