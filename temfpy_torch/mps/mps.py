"""Finite matrix product states with dense torch tensors and host charge
labels (counterpart of :mod:`temfpy_tpu.mps.mps`).

Conventions (as in the JAX package):

- Site tensors have shape (chiL, d, chiR) and live on one torch device.
- ``form[i]`` is 'A' (left-canonical), 'B' (right-canonical) or None.
- Schmidt values ``S[i]`` (host numpy) sit on bond i, left of site i; a
  finite MPS stores L+1 of them with S[0] = S[L] = [1.].
- ``q_bond[i]`` holds one integer charge per bond index (the charge left
  of the bond); tensor i satisfies
  ``q_bond[i][a] + q_phys[n] == q_bond[i+1][b] + qtotal[i]`` on nonzeros.

Contractions run in torch on the tensors' device.  Not ported yet: the
infinite-MPS methods (``canonical_form_infinite``, the ``*_infinite``
observables), ``splice``, ``group_sites``, ``extract_segment``,
``gauge_total_charge``, ``get_total_charge``, ``copy`` and
``entanglement_entropy``.
"""

from __future__ import annotations

import logging
from typing import Sequence

import numpy as np
import torch

from .charges import ChargeInfo, NO_CHARGE, sectors_of
from .charged_linalg import charged_qr, charged_svd
from .site import Site

logger = logging.getLogger(__name__)


def _as_tensor(B, device) -> torch.Tensor:
    if isinstance(B, torch.Tensor):
        return B if device is None else B.to(device)
    return torch.as_tensor(np.asarray(B), device=device)


def _op(op, like: torch.Tensor) -> torch.Tensor:
    """A host (d, d) operator as a tensor matching ``like``'s device/dtype."""
    return torch.as_tensor(np.asarray(op), device=like.device).to(like.dtype)


class MPS:
    """A finite matrix product state."""

    def __init__(self, sites: Sequence[Site], Bs, SVs, *, form="B", bc: str = "finite",
                 unit_cell_width: int | None = None, q_bonds=None, qtotals=None,
                 norm: float = 1.0, device=None):
        self.sites = list(sites)
        L = len(self.sites)
        self._B = [_as_tensor(B, device) for B in Bs]
        if len(self._B) != L:
            raise ValueError("need one tensor per site")
        if isinstance(form, str):
            form = [form] * L
        self.form = list(form)
        if bc != "finite":
            raise NotImplementedError("temfpy_torch ports finite MPS only so far")
        self.bc = bc
        self.norm = norm
        SVs = [None if s is None else np.asarray(s, dtype=float) for s in SVs]
        if len(SVs) != L + 1:
            raise ValueError("need L+1 Schmidt-value vectors")
        self._S = SVs
        self.chinfo: ChargeInfo = self.sites[0].chinfo if self.sites else NO_CHARGE
        if q_bonds is None:
            q_bonds = [np.zeros(self.chi(i), dtype=np.int64) for i in range(L + 1)]
        self.q_bond = [np.asarray(q, dtype=np.int64) for q in q_bonds]
        self.qtotal = (np.zeros(L, dtype=np.int64) if qtotals is None
                       else np.asarray(qtotals, dtype=np.int64).copy())
        self.unit_cell_width = unit_cell_width if unit_cell_width is not None else L

    # ------------------------------------------------------------------
    # basic accessors
    # ------------------------------------------------------------------
    @property
    def L(self) -> int:
        return len(self.sites)

    @property
    def device(self) -> torch.device:
        return self._B[0].device

    def chi(self, bond: int) -> int:
        """Bond dimension at bond i (left of site i)."""
        if bond < self.L:
            return int(self._B[bond].shape[0])
        return int(self._B[self.L - 1].shape[2])

    @property
    def chi_max(self) -> int:
        return max(self.chi(i) for i in range(self.L + 1))

    def get_SL(self, i: int) -> np.ndarray:
        return self._S[i]

    def get_SR(self, i: int) -> np.ndarray:
        return self._S[i + 1]

    def to_numpy(self) -> dict:
        """The state's fields as host numpy: ``tensors``, ``lams``,
        ``q_bonds``, ``qtotals``, ``form``, ``bc``, ``unit_cell_width``
        (the arguments of :func:`temfpy_torch.mps.io.mps_from_arrays`)."""
        return {
            "tensors": [B.detach().cpu().numpy() for B in self._B],
            "lams": [None if s is None else s.copy() for s in self._S],
            "q_bonds": [q.copy() for q in self.q_bond],
            "qtotals": self.qtotal.copy(),
            "form": list(self.form),
            "bc": self.bc,
            "unit_cell_width": self.unit_cell_width,
        }

    # ------------------------------------------------------------------
    # form handling
    # ------------------------------------------------------------------
    def _dS(self, i: int, inverse: bool = False, cutoff: float = 1e-14) -> torch.Tensor:
        S = self._S[i]
        if S is None:
            raise ValueError(f"Schmidt values on bond {i} unknown")
        if inverse:
            S = np.where(S > cutoff, 1.0 / np.maximum(S, cutoff), 0.0)
        return torch.as_tensor(S, device=self.device)

    def get_B(self, i: int, form: str = "B") -> torch.Tensor:
        """Site tensor in the requested canonical form ('A', 'B', 'Th', 'G')."""
        T = self._B[i]
        have = self.form[i]
        if have is None:
            raise ValueError(f"tensor {i} has no canonical form")
        if form == have:
            return T
        expo = {"A": (1, 0), "B": (0, 1), "Th": (1, 1), "G": (0, 0)}
        (al, ar), (bl, br) = expo[have], expo[form]
        dl, dr = bl - al, br - ar
        if dl == 1:
            T = self._dS(i)[:, None, None] * T
        elif dl == -1:
            T = self._dS(i, inverse=True)[:, None, None] * T
        if dr == 1:
            T = T * self._dS(i + 1)[None, None, :]
        elif dr == -1:
            T = T * self._dS(i + 1, inverse=True)[None, None, :]
        return T

    def exact_tensors(self) -> list[torch.Tensor]:
        """Tensors whose plain contraction is the (normalised) state: the
        Schmidt values at the A|B junction are absorbed.  Needs every form
        'A' or 'B', all 'A's left of all 'B's."""
        forms = self.form
        if not all(f in ("A", "B") for f in forms):
            raise ValueError(f"non-canonical forms {forms}")
        c = forms.index("B") if "B" in forms else self.L
        if not (all(f == "A" for f in forms[:c]) and all(f == "B" for f in forms[c:])):
            raise ValueError(f"mixed-up forms {forms}")
        out = list(self._B)
        if c < self.L:
            out[c] = self._dS(c)[:, None, None] * out[c]
        else:
            out[-1] = out[-1] * self._dS(self.L)[None, None, :]
        return out

    # ------------------------------------------------------------------
    # contractions
    # ------------------------------------------------------------------
    @staticmethod
    def _env_update(E, Tb, Tk, op=None):
        """E' = Tb^dagger E Tk (legs (bra_chi, ket_chi)), with an optional
        on-site operator applied to the ket."""
        if op is not None:
            Tk = torch.einsum("mn,anb->amb", _op(op, Tk), Tk)
        tmp = torch.einsum("ab,bnc->anc", E, Tk)
        return torch.einsum("and,anc->dc", Tb.conj(), tmp)

    @staticmethod
    def _env_right(R, Tb, Tk):
        """Right environment one site further left, legs (bra, ket):
        R'[a, c] = sum conj(Tb[a, n, b]) Tk[c, n, d] R[b, d]."""
        tmp = torch.einsum("cnd,bd->cnb", Tk, R)
        return torch.einsum("anb,cnb->ac", Tb.conj(), tmp)

    def overlap(self, other: "MPS") -> complex:
        """<self|other> for finite MPS of equal length (other's tensors are
        moved to this state's device)."""
        if self.L != other.L:
            raise ValueError("overlap needs equal lengths")
        Gb = self.exact_tensors()
        Gk = [t.to(self.device) for t in other.exact_tensors()]
        dtype = torch.promote_types(Gb[0].dtype, Gk[0].dtype)
        E = torch.ones((1, 1), dtype=dtype, device=self.device)
        for Tb, Tk in zip(Gb, Gk):
            E = self._env_update(E, Tb.to(dtype), Tk.to(dtype))
        return complex(E[0, 0].item())

    def to_statevector(self) -> np.ndarray:
        """Dense state vector (site 0 is the most significant index); for
        small systems."""
        G = self.exact_tensors()
        psi = torch.ones((1, 1), dtype=G[0].dtype, device=self.device)
        for T in G:
            psi = torch.einsum("pa,anb->pnb", psi, T)
            psi = psi.reshape(psi.shape[0] * psi.shape[1], psi.shape[2])
        return psi[:, 0].cpu().numpy()

    def norm_squared(self) -> float:
        return float(np.real(self.overlap(self)))

    def _environments(self, G):
        L = self.L
        one = torch.ones((1, 1), dtype=G[0].dtype, device=self.device)
        Ls = [one]
        for T in G:
            Ls.append(self._env_update(Ls[-1], T, T))
        Rs = [None] * (L + 1)
        Rs[L] = one
        for i in reversed(range(L)):
            Rs[i] = self._env_right(Rs[i + 1], G[i], G[i])
        return Ls, Rs

    def expectation_value(self, op_name: str, sites=None) -> np.ndarray:
        """Per-site expectation values <op_i> (complex numpy array)."""
        G = self.exact_tensors()
        Ls, Rs = self._environments(G)
        out = []
        for i in (range(self.L) if sites is None else sites):
            E = self._env_update(Ls[i], G[i], G[i], op=self.sites[i].get_op(op_name))
            out.append(complex(torch.sum(E * Rs[i + 1]).item()))
        return np.asarray(out)

    def correlation_function(self, name1: str, name2: str, sites1=None, sites2=None) -> np.ndarray:
        r"""``result[k, l] = <op1_{sites1[k]} op2_{sites2[l]}>``, threading
        Jordan-Wigner strings for fermionic operators (defaults: all sites).
        Only the rows and columns asked for are contracted."""
        L = self.L
        s1 = list(range(L) if sites1 is None else sites1)
        s2 = list(range(L) if sites2 is None else sites2)
        G = self.exact_tensors()
        Ls, Rs = self._environments(G)
        needs_jw = []
        for i in range(L):
            jw1 = self.sites[i].op_needs_JW.get(name1, False)
            jw2 = self.sites[i].op_needs_JW.get(name2, False)
            if jw1 != jw2:
                raise ValueError(
                    f"correlation_function({name1!r}, {name2!r}): operators have mismatched "
                    "Jordan-Wigner requirements (parity-odd pair); not supported")
            needs_jw.append(jw1 and jw2)

        def close(E, i):
            return complex(torch.sum(E * Rs[i]).item())

        result = np.zeros((L, L), dtype=complex)
        want1, want2 = set(s1), set(s2)
        last1, last2 = max(s1, default=-1), max(s2, default=-1)
        for i in range(L):
            site_i = self.sites[i]
            op1, op2 = site_i.get_op(name1), site_i.get_op(name2)
            if i in want1 and i in want2:
                result[i, i] = close(self._env_update(Ls[i], G[i], G[i], op=op1 @ op2), i + 1)
            if i in want1:  # i < j: (op1 JW)_i, strings, op2_j
                opi = op1 @ site_i.get_op("JW") if needs_jw[i] else op1
                E = self._env_update(Ls[i], G[i], G[i], op=opi)
                for j in range(i + 1, last2 + 1):
                    site_j = self.sites[j]
                    if j in want2:
                        result[i, j] = close(
                            self._env_update(E, G[j], G[j], op=site_j.get_op(name2)), j + 1)
                    string = site_j.get_op("JW") if needs_jw[i] else None
                    E = self._env_update(E, G[j], G[j], op=string)
            if i in want2:  # k > i: (JW op2)_i, strings, op1_k
                opj = site_i.get_op("JW") @ op2 if needs_jw[i] else op2
                E = self._env_update(Ls[i], G[i], G[i], op=opj)
                for k in range(i + 1, last1 + 1):
                    site_k = self.sites[k]
                    if k in want1:
                        result[k, i] = close(
                            self._env_update(E, G[k], G[k], op=site_k.get_op(name1)), k + 1)
                    string = site_k.get_op("JW") if needs_jw[i] else None
                    E = self._env_update(E, G[k], G[k], op=string)
        return result[np.ix_(s1, s2)]

    # ------------------------------------------------------------------
    # entanglement
    # ------------------------------------------------------------------
    def entanglement_spectrum(self, by_charge: bool = False):
        """Per-bond entanglement spectrum -2 log S; with ``by_charge`` a list
        of (charge, spectrum) pairs per bond."""
        out = []
        for i in range(1, self.L):
            S = self._S[i]
            if not by_charge:
                out.append(-2 * np.log(S))
            else:
                out.append([((q,), -2 * np.log(S[idx]))
                            for q, idx in sectors_of(self.q_bond[i]).items()])
        return out

    # ------------------------------------------------------------------
    # canonicalisation
    # ------------------------------------------------------------------
    def canonical_form_finite(self, cutoff: float = 1e-12, chi_max: int | None = None):
        """Brings the MPS into right-canonical form with Schmidt values on
        every bond: a left-to-right charged QR sweep, then a right-to-left
        charged SVD sweep truncating singular values below ``cutoff``
        (relative) and beyond ``chi_max``."""
        L = self.L
        chinfo = self.chinfo
        try:
            G = self.exact_tensors()
        except ValueError:
            G = list(self._B)
        qt = self.qtotal.copy()
        dev = self.device
        carry = torch.ones((1, 1), dtype=G[0].dtype, device=dev)
        q_carry = self.q_bond[0].copy()
        A_list, q_bonds = [], [self.q_bond[0].copy()]
        for i in range(L):
            d = self.sites[i].d
            T = torch.einsum("ab,bnc->anc", carry, G[i])
            chiL, _, chiR = T.shape
            q_row = (q_carry[:, None] + self.sites[i].charges[None, :]).reshape(-1)
            Q, R, q_mid = charged_qr(T.reshape(chiL * d, chiR), q_row, self.q_bond[i + 1],
                                     chinfo, qtotal=int(qt[i]))
            A_list.append(Q.reshape(chiL, d, Q.shape[1]))
            carry = R
            q_carry = chinfo.make_valid(np.asarray(q_mid) + qt[i])
            q_bonds.append(q_carry.copy())
            qt[i] = 0
        norm = float(torch.linalg.norm(carry))
        A_list[-1] = torch.einsum("anb,bc->anc", A_list[-1], carry / norm)

        B_list = [None] * L
        S_list = [None] * (L + 1)
        S_list[L] = np.ones(1)
        q_bonds[L] = q_bonds[L][:1] if len(q_bonds[L]) else np.zeros(1, np.int64)
        carry = None
        for i in reversed(range(L)):
            T = A_list[i]
            if carry is not None:
                T = torch.einsum("anb,bc->anc", T, carry)
            chiL, d, chiR = T.shape
            q_col = (q_bonds[i + 1][None, :] - self.sites[i].charges[:, None]).reshape(-1)
            U, S, Vh, q_mid, _err = charged_svd(
                T.reshape(chiL, d * chiR), q_bonds[i], q_col, chinfo, qtotal=0,
                cutoff=cutoff, chi_max=chi_max, normalize=True)
            B_list[i] = Vh.reshape(Vh.shape[0], d, chiR)
            S_list[i] = S
            q_bonds[i] = chinfo.make_valid(np.asarray(q_mid))
            carry = U * torch.as_tensor(S, device=dev)[None, :]
        B_list[0] = torch.einsum("ab,bnc->anc", carry, B_list[0])
        S_list[0] = np.ones(1)

        self._B = B_list
        self._S = S_list
        self.form = ["B"] * L
        self.q_bond = q_bonds
        self.qtotal = qt
        self.norm = norm
        return self

    def __repr__(self):
        return (f"MPS(L={self.L}, bc={self.bc!r}, chi_max={self.chi_max}, "
                f"chinfo={self.chinfo}, device={self.device}, "
                f"forms={''.join(str(f)[0] for f in self.form)})")
