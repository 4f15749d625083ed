"""Local Hilbert spaces with their charge labels and on-site operators.

Replaces TeNPy's ``networks.site.FermionSite`` (used by reference
slater.py:30 with conserve="N" and pfaffian.py:63 with conserve="parity")
and ``networks.site.SpinHalfSite`` (reference gutzwiller.py:221,403).
Operators are plain dense (d, d) numpy matrices; fermionic sites carry a
Jordan-Wigner string operator ``JW`` and per-operator "needs JW" metadata so
that correlation functions thread anticommutation strings automatically.
"""

from __future__ import annotations

import numpy as np

from .charges import ChargeInfo, NO_CHARGE


class Site:
    """A local Hilbert space.

    Attributes
    ----------
    d: local dimension.
    chinfo: the conserved charge.
    charges: (d,) int labels of the basis states.
    ops: name -> (d, d) matrix.
    op_needs_JW: name -> bool, whether the operator is fermionic (odd).
    state_labels: name -> basis index.
    """

    def __init__(self, chinfo: ChargeInfo, charges, ops, op_needs_JW=None, state_labels=None):
        self.chinfo = chinfo
        self.charges = np.asarray(charges, dtype=np.int64)
        self.d = len(self.charges)
        self.ops = {name: np.asarray(op) for name, op in ops.items()}
        self.ops.setdefault("Id", np.eye(self.d))
        self.op_needs_JW = dict(op_needs_JW or {})
        self.state_labels = dict(state_labels or {})

    def get_op(self, name: str) -> np.ndarray:
        return self.ops[name]

    def __eq__(self, other):
        return (
            isinstance(other, Site)
            and self.d == other.d
            and self.chinfo == other.chinfo
            and np.array_equal(self.charges, other.charges)
        )

    def __repr__(self):
        return f"{type(self).__name__}(d={self.d}, {self.chinfo})"


class FermionSite(Site):
    """Spinless fermion site, basis (|0>, |1>) with |1> = c^dagger |0>.

    ``conserve``: "N" (particle number, U(1)) or "parity" (Z2).
    Operators: C (annihilation), Cd (creation), N, JW = 1 - 2N, dN = N - 1/2.
    """

    def __init__(self, conserve: str = "N"):
        if conserve == "N":
            chinfo = ChargeInfo(mod=1, name="N")
            charges = [0, 1]
        elif conserve == "parity":
            chinfo = ChargeInfo(mod=2, name="parity")
            charges = [0, 1]
        else:
            raise ValueError(f"conserve must be 'N' or 'parity', got {conserve!r}")
        C = np.array([[0.0, 1.0], [0.0, 0.0]])  # C |1> = |0>
        Cd = C.T.copy()
        N = np.diag([0.0, 1.0])
        JW = np.diag([1.0, -1.0])
        ops = {"C": C, "Cd": Cd, "N": N, "JW": JW, "dN": N - 0.5 * np.eye(2)}
        needs_jw = {"C": True, "Cd": True, "N": False, "JW": False, "Id": False, "dN": False}
        super().__init__(
            chinfo, charges, ops, needs_jw, state_labels={"empty": 0, "full": 1}
        )
        self.conserve = conserve


class SpinHalfSite(Site):
    """Spin-1/2 site, basis (|up>, |down>) with charge 2*Sz = (+1, -1).

    ``conserve``: "Sz" or None.  Operators: Sz, Sp, Sm, Sx, Sy, Sigmaz.
    """

    def __init__(self, conserve: str | None = "Sz"):
        if conserve == "Sz":
            chinfo = ChargeInfo(mod=1, name="2Sz")
            charges = [1, -1]
        elif conserve is None:
            chinfo = NO_CHARGE
            charges = [0, 0]
        else:
            raise ValueError(f"conserve must be 'Sz' or None, got {conserve!r}")
        Sz = np.diag([0.5, -0.5])
        Sp = np.array([[0.0, 1.0], [0.0, 0.0]])  # S+ |down> = |up>
        Sm = Sp.T.copy()
        ops = {
            "Sz": Sz,
            "Sp": Sp,
            "Sm": Sm,
            "Sx": 0.5 * (Sp + Sm),
            "Sy": -0.5j * (Sp - Sm),
            "Sigmaz": 2 * Sz,
        }
        needs_jw = {k: False for k in list(ops) + ["Id"]}
        super().__init__(chinfo, charges, ops, needs_jw, state_labels={"up": 0, "down": 1})
        self.conserve = conserve


class GroupedSite(Site):
    """Several sites fused into one (used by ``MPS.group_sites``): carries
    the Kronecker-fused charge labels; Kronecker products of the members'
    single-site operators are available as ``"name0 name1 ..."`` (one name
    per member, ``Id`` allowed)."""

    def __init__(self, members, charges, chinfo):
        self.members = list(members)
        super().__init__(chinfo, charges, ops={}, op_needs_JW={})

    def get_op(self, name: str):
        names = name.split()
        if len(names) != len(self.members):
            raise KeyError(
                f"GroupedSite operator {name!r}: need one name per member "
                f"({len(self.members)})"
            )
        op = None
        for site, nm in zip(self.members, names):
            o = site.get_op(nm)
            op = o if op is None else np.kron(op, o)
        return op
