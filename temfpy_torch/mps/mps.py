"""Finite and infinite matrix product states with dense torch tensors and
host charge labels (counterpart of :mod:`temfpy_tpu.mps.mps`).

Conventions (as in the JAX package):

- Site tensors have shape (chiL, d, chiR) and live on one torch device.
- ``form[i]`` is 'A' (left-canonical), 'B' (right-canonical) or None.
- Schmidt values ``S[i]`` (host numpy) sit on bond i, left of site i; a
  finite MPS stores L+1 of them with S[0] = S[L] = [1.]; an infinite MPS
  stores L+1 with S[L] == S[0] (the wrap-around bond).
- ``q_bond[i]`` holds one integer charge per bond index (the charge left
  of the bond); tensor i satisfies
  ``q_bond[i][a] + q_phys[n] == q_bond[i+1][b] + qtotal[i]`` on nonzeros.
  An infinite cell may carry a constant charge drift per cell:
  ``q_bond[L] == q_bond[0] + delta``.

Contractions run in torch on the tensors' device.  Under an active mesh
(:mod:`temfpy_torch.parallel.mesh`) a site tensor may be held bond-sharded
over the mesh's shards; every reader of the site tensors goes through one
accessor (:meth:`MPS._tensor`), which gathers one site at a time, and
:meth:`MPS.canonical_form_finite` keeps the tensors it stores sharded.  Not
ported (a TPU workaround of the JAX package): ``device_context`` (the CPU
reroute).
"""

from __future__ import annotations

import logging
from typing import Sequence

import numpy as np
import torch

from ..ops.linalg import robust_eigh, robust_qr, robust_svd
from ..parallel import mesh as _pmesh
from .charged_linalg import charged_eigh, charged_qr, charged_svd
from .charges import ChargeInfo, NO_CHARGE, fuse, sectors_of
from .site import GroupedSite, Site

logger = logging.getLogger(__name__)


def _as_tensor(B, device) -> torch.Tensor:
    if _pmesh.is_bond_sharded(B):  # kept sharded; gathered where moved
        return B if device is None or torch.device(device) == B.device else B.gather(device)
    if isinstance(B, torch.Tensor):
        return B if device is None else B.to(device)
    return torch.as_tensor(np.asarray(B), device=device)


def _op(op, like: torch.Tensor) -> torch.Tensor:
    """A host (d, d) operator as a tensor matching ``like``'s device/dtype."""
    return torch.as_tensor(np.asarray(op), device=like.device).to(like.dtype)


def _idx(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)


class MPS:
    """A finite or infinite matrix product state."""

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
        if bc not in ("finite", "infinite"):
            raise ValueError(f"unsupported bc {bc!r}")
        self.bc = bc
        self.norm = norm
        SVs = [None if s is None else np.asarray(s, dtype=float) for s in SVs]
        if bc == "infinite" and len(SVs) == L:  # without the wrap bond
            SVs = SVs + [SVs[0]]
        if len(SVs) != L + 1:
            raise ValueError("need L+1 Schmidt-value vectors")
        if bc == "infinite":
            if SVs[L] is None:
                SVs[L] = SVs[0]
            elif SVs[0] is None:
                SVs[0] = SVs[L]
            elif SVs[0].shape != SVs[L].shape or not np.allclose(SVs[0], SVs[L], rtol=0,
                                                                  atol=1e-12):
                raise ValueError(f"infinite MPS: the Schmidt values of the wrap bond {L} "
                                 "differ from those of bond 0")
        self._S = SVs
        self.chinfo: ChargeInfo = self.sites[0].chinfo if self.sites else NO_CHARGE
        if q_bonds is None:
            q_bonds = [np.zeros(self.chi(i), dtype=np.int64) for i in range(L + 1)]
        self.q_bond = [np.asarray(q, dtype=np.int64) for q in q_bonds]
        self.qtotal = (np.zeros(L, dtype=np.int64) if qtotals is None
                       else np.asarray(qtotals, dtype=np.int64).copy())
        self.unit_cell_width = unit_cell_width if unit_cell_width is not None else L
        self.grouped = 1

    # ------------------------------------------------------------------
    # basic accessors
    # ------------------------------------------------------------------
    @property
    def L(self) -> int:
        return len(self.sites)

    @property
    def N_sites_per_hor_spacing(self) -> int:
        """Reference-named alias of :attr:`unit_cell_width` (TeNPy's
        cylinder bookkeeping, reference iMPS.py:322-352)."""
        return self.unit_cell_width

    @property
    def finite(self) -> bool:
        return self.bc == "finite"

    @property
    def dims(self):
        return [s.d for s in self.sites]

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
            "tensors": [self._tensor(i).detach().cpu().numpy() for i in range(self.L)],
            "lams": [None if s is None else s.copy() for s in self._S],
            "q_bonds": [q.copy() for q in self.q_bond],
            "qtotals": self.qtotal.copy(),
            "form": list(self.form),
            "bc": self.bc,
            "unit_cell_width": self.unit_cell_width,
        }

    def copy(self) -> "MPS":
        """A new MPS sharing the (immutable) site tensors, with its own
        Schmidt values, labels and forms."""
        out = MPS(self.sites, list(self._B), [None if s is None else s.copy() for s in self._S],
                  form=list(self.form), bc=self.bc, unit_cell_width=self.unit_cell_width,
                  q_bonds=[q.copy() for q in self.q_bond], qtotals=self.qtotal.copy(),
                  norm=self.norm)
        out.grouped = self.grouped
        return out

    def get_total_charge(self, only_physical: bool = False) -> int:
        """The gauge charge (sum of the tensor qtotals), or with
        ``only_physical`` the physical charge of the support
        (q_bond[L] - q_bond[0] + the gauge charge), which relabelings keep."""
        qt = int(self.qtotal.sum())
        if only_physical:
            qt += int(self.q_bond[-1][0]) - int(self.q_bond[0][0])
        return int(self.chinfo.make_valid(qt))

    def gauge_total_charge(self, qtotal_new: int = 0, site: int = 0) -> "MPS":
        """Relabels charges so that the gauge charge becomes ``qtotal_new``:
        tensor ``site``'s qtotal absorbs the difference and every bond right
        of it shifts the other way, so every charge rule and the physical
        charge stay (TeNPy ``MPS.gauge_total_charge``)."""
        d = int(qtotal_new) - self.get_total_charge()
        if d == 0:
            return self
        self.qtotal[site] += d
        for k in range(site + 1, self.L + 1):
            self.q_bond[k] = self.chinfo.make_valid(np.asarray(self.q_bond[k], np.int64) - d)
        return self

    def extract_segment(self, first: int, last: int) -> "MPS":
        """A finite MPS of the right-canonical tensors of sites ``first`` to
        ``last`` inclusive, with the surrounding Schmidt values on its
        boundary bonds (TeNPy ``MPS.extract_segment``).  On an infinite MPS
        the indices may pass L (the unit cell repeats, its wrapped labels
        shifted by the per-cell drift)."""
        idx = range(first, last + 1)
        L = self.L
        if self.finite:
            svs = [self._S[i] for i in idx] + [self._S[last + 1]]
            q_bonds = [self.q_bond[i] for i in idx] + [self.q_bond[last + 1]]
        else:
            delta = int(self.q_bond[L][0]) - int(self.q_bond[0][0])

            def q_at(i):
                return np.asarray(self.q_bond[i % L], np.int64) + (i // L) * delta

            svs = [self._S[i % L] for i in idx] + [self._S[(last + 1) % L]]
            q_bonds = [q_at(i) for i in idx] + [q_at(last + 1)]
        return MPS([self.sites[i % L] for i in idx], [self.get_B(i, "B") for i in idx], svs,
                   form="B", bc="finite", q_bonds=q_bonds,
                   qtotals=[self.qtotal[i % L] for i in idx], norm=self.norm)

    def splice(self, imps: "MPS", cut: int, n_cells: int) -> "MPS":
        """A finite MPS with ``n_cells`` copies of the infinite unit cell
        ``imps`` inserted at bond ``cut``: the check of an iMPS extraction
        (reference examples/iMPS*.py), whose overlap with a longer chain
        converted on its own approaches 1 as the cell converges.  The
        inserted tensors keep their right-canonical form; the tensors and
        Schmidt values around them are untouched."""
        if not self.finite or imps.finite:
            raise ValueError("splice inserts an infinite unit cell into a finite MPS")
        cell = imps.L
        cell_B = [imps._tensor(j).to(self.device) for j in range(imps.L)]
        return MPS(self.sites[:cut] + imps.sites * n_cells + self.sites[cut:],
                   list(self._B[:cut]) + cell_B * n_cells + list(self._B[cut:]),
                   list(self._S[:cut]) + [imps._S[j] for j in range(cell)] * n_cells
                   + list(self._S[cut:]),
                   form=self.form[:cut] + ["B"] * (cell * n_cells) + self.form[cut:],
                   bc="finite")

    def group_sites(self, n: int = 2) -> "MPS":
        """Fuses every ``n`` consecutive sites into one :class:`GroupedSite`
        with the fused charge labels (TeNPy ``MPS.group_sites``); its
        operators are Kronecker products of the members' named ones."""
        if self.L % n:
            raise ValueError(f"L = {self.L} is not divisible by the group size {n}")
        Bs, sites, q_bonds, qts, svs = [], [], [self.q_bond[0]], [], [self._S[0]]
        for g in range(self.L // n):
            T = self.get_B(n * g, "B")
            for j in range(1, n):
                Tj = self.get_B(n * g + j, "B")
                T = torch.einsum("anb,bmc->anmc", T, Tj).reshape(T.shape[0], -1, Tj.shape[2])
            Bs.append(T)
            members = [self.sites[n * g + j] for j in range(n)]
            q = members[0].charges
            for m in members[1:]:
                q = fuse(q, m.charges, self.chinfo)
            sites.append(GroupedSite(members, q, self.chinfo))
            q_bonds.append(self.q_bond[n * (g + 1)])
            qts.append(int(self.qtotal[n * g : n * (g + 1)].sum()))
            svs.append(self._S[n * (g + 1)])
        out = MPS(sites, Bs, svs, form="B", bc=self.bc, unit_cell_width=self.unit_cell_width,
                  q_bonds=q_bonds, qtotals=qts, norm=self.norm)
        out.grouped = self.grouped * n
        return out

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

    def _tensor(self, i: int) -> torch.Tensor:
        """Site tensor i as stored, as a plain tensor: the one reader of
        ``_B`` (a bond-sharded tensor of a mesh run is gathered onto its
        first shard's device, one site at a time)."""
        return _pmesh.gather_replicated(self._B[i])

    def get_B(self, i: int, form: str = "B") -> torch.Tensor:
        """Site tensor in the requested canonical form ('A', 'B', 'Th', 'G');
        on an infinite MPS ``i`` is taken modulo L."""
        if not self.finite:
            i = i % self.L
        T = self._tensor(i)
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
        Schmidt values at the A|B junction are absorbed.  Needs a finite MPS
        with every form 'A' or 'B', all 'A's left of all 'B's."""
        c = self._junction()
        return [self._exact_tensor(i, c) for i in range(self.L)]

    def _junction(self) -> int:
        """The first 'B' site of a finite MPS in mixed canonical form (L if
        none), where :meth:`exact_tensors` absorbs the Schmidt values;
        raises ValueError for any other state."""
        if not self.finite:
            raise ValueError("exact_tensors is for finite MPS")
        forms = self.form
        if not all(f in ("A", "B") for f in forms):
            raise ValueError(f"non-canonical forms {forms}")
        c = forms.index("B") if "B" in forms else self.L
        if not (all(f == "A" for f in forms[:c]) and all(f == "B" for f in forms[c:])):
            raise ValueError(f"mixed-up forms {forms}")
        return c

    def _exact_tensor(self, i: int, c: int) -> torch.Tensor:
        """Site i of :meth:`exact_tensors` for the junction ``c``."""
        T = self._tensor(i)
        if i == c:
            return self._dS(c)[:, None, None] * T
        if c == self.L and i == self.L - 1:
            return T * self._dS(self.L)[None, None, :]
        return T

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
        if not (self.finite and other.finite and self.L == other.L):
            raise ValueError("overlap needs two finite MPS of equal length")
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
        """Per-site expectation values <op_i> (complex numpy array), of a
        finite or infinite MPS."""
        if not self.finite:
            return self._expectation_value_infinite(op_name, sites)
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
        Only the rows and columns asked for are contracted.  On an infinite
        MPS the indices may pass the unit cell (site i lies in copy i // L of
        the cell), and the defaults are the unit cell."""
        if not self.finite:
            return self._correlation_function_infinite_pairs(name1, name2, sites1, sites2)
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

    def _jw_pair(self, name1: str, name2: str) -> bool:
        """Whether a two-point function of an infinite MPS threads
        Jordan-Wigner strings; a parity-odd pair raises."""
        jw1 = self.sites[0].op_needs_JW.get(name1, False)
        jw2 = self.sites[0].op_needs_JW.get(name2, False)
        if jw1 != jw2:
            raise ValueError(
                f"correlation_function({name1!r}, {name2!r}): operators have mismatched "
                "Jordan-Wigner requirements (parity-odd pair); not supported")
        return jw1

    def _left_env(self, i: int, op) -> torch.Tensor:
        """E[b, c] = sum S_i^2[a] conj(B_i[a, n, b]) op[n, m] B_i[a, m, c] of
        an infinite MPS in canonical form."""
        B = self.get_B(i, "B")
        S2 = torch.as_tensor(self._S[i % self.L] ** 2, device=B.device).to(B.dtype)
        return torch.einsum("a,anb,nm,amc->bc", S2, B.conj(), _op(op, B), B)

    def _env_step(self, E, j: int, op=None) -> torch.Tensor:
        """The environment carried over site j, with ``op`` (the string)
        between bra and ket."""
        B = self.get_B(j, "B")
        if op is None:
            return torch.einsum("bc,bnd,cne->de", E, B.conj(), B)
        return torch.einsum("bc,bnd,nm,cme->de", E, B.conj(), _op(op, B), B)

    def _env_close(self, E, j: int, op) -> complex:
        B = self.get_B(j, "B")
        return complex(torch.einsum("bc,bnd,nm,cmd->", E, B.conj(), _op(op, B), B).item())

    def _expectation_value_infinite(self, op_name: str, sites=None) -> np.ndarray:
        """<op_i> of an infinite MPS in canonical form: diag(S_i^2) against
        the right-canonical tensor with the operator inserted."""
        sites = range(self.L) if sites is None else sites
        return np.asarray([complex(torch.trace(self._left_env(
            i, self.sites[i % self.L].get_op(op_name))).item()) for i in sites])

    def correlation_function_infinite(self, name1: str, name2: str, max_range: int,
                                      sites1=None) -> np.ndarray:
        r"""Two-point functions <op1_i op2_{i+r}> of an infinite MPS for
        r = 1..max_range and i in ``sites1`` (default: the unit cell), shape
        (len(sites1), max_range); Jordan-Wigner strings as in
        :meth:`correlation_function`."""
        if self.finite:
            raise ValueError("correlation_function_infinite is for infinite MPS")
        L = self.L
        sites1 = range(L) if sites1 is None else sites1
        needs_jw = self._jw_pair(name1, name2)
        out = np.zeros((len(sites1), max_range), dtype=complex)
        for k, i in enumerate(sites1):
            i = i % L
            op1 = self.sites[i].get_op(name1)
            if needs_jw:
                op1 = op1 @ self.sites[i].get_op("JW")
            E = self._left_env(i, op1)
            for r in range(1, max_range + 1):
                site_j = self.sites[(i + r) % L]
                out[k, r - 1] = self._env_close(E, i + r, site_j.get_op(name2))
                E = self._env_step(E, i + r, site_j.get_op("JW") if needs_jw else None)
        return out

    def _correlation_function_infinite_pairs(self, name1: str, name2: str, sites1=None,
                                             sites2=None) -> np.ndarray:
        """<op1_i op2_j> of an infinite MPS in canonical form for every
        pair of ``sites1`` x ``sites2``; indices past the unit cell address
        its translated copies."""
        L = self.L
        sites1 = list(range(L) if sites1 is None else sites1)
        sites2 = list(range(L) if sites2 is None else sites2)
        needs_jw = self._jw_pair(name1, name2)

        def op_of(i, name):
            return self.sites[i % L].get_op(name)

        def pair_value(i, j):
            # the left operator acts first; the lower triangle takes
            # (JW op2)_j ... op1_i, as the finite path does
            if i == j:
                return complex(torch.trace(self._left_env(
                    i, op_of(i, name1) @ op_of(i, name2))).item())
            if i < j:
                a, b, op_right = i, j, op_of(j, name2)
                op_left = op_of(i, name1) @ op_of(i, "JW") if needs_jw else op_of(i, name1)
            else:
                a, b, op_right = j, i, op_of(i, name1)
                op_left = op_of(j, "JW") @ op_of(j, name2) if needs_jw else op_of(j, name2)
            E = self._left_env(a, op_left)
            for k in range(a + 1, b):
                E = self._env_step(E, k, op_of(k, "JW") if needs_jw else None)
            return self._env_close(E, b, op_right)

        out = np.zeros((len(sites1), len(sites2)), dtype=complex)
        for k, i in enumerate(sites1):
            for m, j in enumerate(sites2):
                out[k, m] = pair_value(int(i), int(j))
        return out

    # ------------------------------------------------------------------
    # entanglement
    # ------------------------------------------------------------------
    def entanglement_spectrum(self, by_charge: bool = False):
        """Per-bond entanglement spectrum -2 log S; with ``by_charge`` a list
        of (charge, spectrum) pairs per bond."""
        out = []
        for i in self._inner_bonds():
            S = self._S[i]
            if not by_charge:
                out.append(-2 * np.log(S))
            else:
                out.append([((q,), -2 * np.log(S[idx]))
                            for q, idx in sectors_of(self.q_bond[i]).items()])
        return out

    def _inner_bonds(self):
        """Bonds 1..L-1 of a finite MPS, 0..L-1 of an infinite one."""
        return range(1, self.L) if self.finite else range(self.L)

    def entanglement_entropy(self) -> np.ndarray:
        """Von Neumann entropy -sum S^2 log S^2 per bond (the bonds of
        :meth:`entanglement_spectrum`)."""
        out = []
        for i in self._inner_bonds():
            S2 = self._S[i] ** 2
            S2 = S2[S2 > 1e-30]
            out.append(float(-np.sum(S2 * np.log(S2))))
        return np.asarray(out)

    # ------------------------------------------------------------------
    # canonicalisation
    # ------------------------------------------------------------------
    def canonical_form_finite(self, cutoff: float = 1e-12, chi_max: int | None = None):
        """Brings the MPS into right-canonical form with Schmidt values on
        every bond: a left-to-right charged QR sweep, then a right-to-left
        charged SVD sweep truncating singular values below ``cutoff``
        (relative) and beyond ``chi_max``.

        Under an active mesh every tensor the sweeps store keeps its bond
        axis split over the shards (:func:`temfpy_torch.parallel.mesh.
        bond_shard_put`) and each step gathers one site: the working set is
        one site, the chain stays sharded (``temfpy_tpu/mps/mps.py:744-766``).
        The factorizations are those of the unsharded sweep, so the result
        is the same."""
        if not self.finite:
            raise ValueError("canonical_form_finite is for finite MPS")
        L = self.L
        chinfo = self.chinfo
        try:
            c = self._junction()
            site = lambda i: self._exact_tensor(i, c)  # noqa: E731
        except ValueError:
            site = self._tensor
        shard, gather = _pmesh.bond_shard_put, _pmesh.gather_replicated
        qt = self.qtotal.copy()
        dev = self.device
        carry = torch.ones((1, 1), dtype=self._B[0].dtype, device=dev)
        q_carry = self.q_bond[0].copy()
        A_list, q_bonds = [], [self.q_bond[0].copy()]
        for i in range(L):
            d = self.sites[i].d
            T = torch.einsum("ab,bnc->anc", carry, site(i))
            chiL, _, chiR = T.shape
            q_row = (q_carry[:, None] + self.sites[i].charges[None, :]).reshape(-1)
            Q, R, q_mid = charged_qr(T.reshape(chiL * d, chiR), q_row, self.q_bond[i + 1],
                                     chinfo, qtotal=int(qt[i]))
            A_list.append(shard(Q.reshape(chiL, d, Q.shape[1])))
            carry = R
            q_carry = chinfo.make_valid(np.asarray(q_mid) + qt[i])
            q_bonds.append(q_carry.copy())
            qt[i] = 0
        norm = float(torch.linalg.norm(carry))
        A_list[-1] = shard(torch.einsum("anb,bc->anc", gather(A_list[-1]), carry / norm))

        B_list = [None] * L
        S_list = [None] * (L + 1)
        S_list[L] = np.ones(1)
        q_bonds[L] = q_bonds[L][:1] if len(q_bonds[L]) else np.zeros(1, np.int64)
        carry = None
        for i in reversed(range(L)):
            T = gather(A_list[i])
            A_list[i] = None  # the sweep holds one site
            if carry is not None:
                T = torch.einsum("anb,bc->anc", T, carry)
            chiL, d, chiR = T.shape
            q_col = (q_bonds[i + 1][None, :] - self.sites[i].charges[:, None]).reshape(-1)
            U, S, Vh, q_mid, _err = charged_svd(
                T.reshape(chiL, d * chiR), q_bonds[i], q_col, chinfo, qtotal=0,
                cutoff=cutoff, chi_max=chi_max, normalize=True)
            B_list[i] = shard(Vh.reshape(Vh.shape[0], d, chiR))
            S_list[i] = S
            q_bonds[i] = chinfo.make_valid(np.asarray(q_mid))
            carry = U * torch.as_tensor(S, device=dev)[None, :]
        B_list[0] = shard(torch.einsum("ab,bnc->anc", carry, gather(B_list[0])))
        S_list[0] = np.ones(1)

        self._B = B_list
        self._S = S_list
        self.form = ["B"] * L
        self.q_bond = q_bonds
        self.qtotal = qt
        self.norm = norm
        return self

    def canonical_form_infinite(self, cutoff: float = 1e-10, tol: float = 1e-13,
                                max_iter: int = 5000):
        """Brings an infinite MPS into right-canonical form through the fixed
        points of the unit-cell transfer matrix (TeNPy's
        ``canonical_form_infinite1``, reference gutzwiller.py:473), on the
        tensors' device:

        1. the dominant right and left fixed points rho_R = X X^H and
           rho_L = Y^H Y of the cell transfer map, by power iteration; where
           that does not converge (a reducible cell, e.g. a Gutzwiller
           projection split into superselection sectors), by ARPACK on the
           chi^2 x chi^2 map, each matvec one transfer map on the device,
           one copy each way;
        2. the boundary gauge bond0' = V^H X^+ and bondL' = X V from
           U S V^H = svd(Y X), repeated up to four times while the cell is
           not right-canonical as a whole (a reducible cell);
        3. a right-to-left LQ sweep, then the left environment diagonalised
           at every interior bond, which gives the Schmidt values.

        With charge labels every factorization runs sector by sector, so the
        bond labels (and the per-cell drift of the wrap bond) survive.  The
        transfer-map work of the call is kept in ``transfer_stats``: the
        ARPACK fallbacks, their matvecs, and the fallbacks that failed
        (ARPACK raised, or found no positive fixed point: the unconverged
        power iterate is kept, with a warning).
        """
        if self.finite:
            raise ValueError("canonical_form_infinite is for infinite MPS")
        L = self.L
        T = [self._tensor(i) for i in range(L)]
        dev, dtype = self.device, T[0].dtype
        stats = {"fallbacks": 0, "matvecs": 0, "arpack_failures": 0}
        chinfo = self.chinfo
        qt = self.qtotal.copy()
        # the wrap bond may carry a constant drift delta per cell (q_bond[L] =
        # q_bond[0] + delta); the index partition is then the same on both
        # wrap labels, which is all the block structure needs
        delta = 0
        charged = (len(self.q_bond[L]) == len(self.q_bond[0])
                   and any(np.any(np.asarray(q) != 0) for q in self.q_bond))
        if charged:
            dq = np.asarray(self.q_bond[L], np.int64) - np.asarray(self.q_bond[0], np.int64)
            if dq.size and np.all(dq == dq[0]):
                delta = int(dq[0])
            else:
                charged = False
        q0_cur = np.asarray(self.q_bond[0]).copy()

        def transfer(side, X, Ts):
            # the environment first: contracting the two tensors first would
            # build a chi^4 intermediate
            if side == "right":
                for Ti in reversed(Ts):
                    X = torch.einsum("bd,anb,cnd->ac", X, Ti, Ti.conj())
            else:
                for Ti in Ts:
                    X = torch.einsum("ab,anc,bnd->cd", X, Ti, Ti.conj())
            return X

        def dominant(side, chi):
            """The dominant PSD fixed point of the cell transfer map and its
            eigenvalue: power iteration, else the positive part of the sum
            of ARPACK's top real eigenvectors."""
            X = torch.eye(chi, dtype=dtype, device=dev)
            lam = 1.0
            for _ in range(min(max_iter, 500)):
                Y = transfer(side, X, T)
                Y = (Y + Y.conj().T) / 2
                lam = float(torch.linalg.norm(Y))
                Y = Y / lam
                if float(torch.linalg.norm(Y - X)) < tol:
                    return Y, lam
                X = Y
            import scipy.sparse.linalg as spla

            stats["fallbacks"] += 1
            Tc = [Ti.to(torch.complex128) for Ti in T]

            def mv(x):
                stats["matvecs"] += 1
                Xm = torch.as_tensor(np.asarray(x, complex).reshape(chi, chi), device=dev)
                return transfer(side, Xm, Tc).cpu().numpy().ravel()

            n2 = chi * chi
            op = spla.LinearOperator((n2, n2), matvec=mv, dtype=complex)
            try:
                w, Vv = spla.eigs(op, k=min(6, n2 - 2), which="LM", tol=1e-12, maxiter=5000)
            except (spla.ArpackError, ValueError) as err:
                logger.warning("transfer-matrix Arnoldi failed (%s)", err)
                stats["arpack_failures"] += 1
                return X, lam
            lam = float(np.abs(w).max())
            rho = np.zeros((chi, chi), dtype=complex)
            for i in range(len(w)):
                # real positive eigenvalues at the top of the spectrum
                if abs(w[i].imag) < 1e-8 * lam and w[i].real > lam * (1 - 1e-6):
                    Hm = Vv[:, i].reshape(chi, chi)
                    Hm = (Hm + Hm.conj().T) / 2
                    rho += -Hm if np.trace(Hm).real < 0 else Hm
            if np.linalg.norm(rho) == 0:  # not for a completely positive map
                logger.warning("no positive dominant fixed point found")
                stats["arpack_failures"] += 1
                return X, lam
            e_r, U_r = np.linalg.eigh(rho)
            rho = (U_r * np.clip(e_r, 0.0, None)) @ U_r.conj().T
            rho /= np.linalg.norm(rho)
            if not dtype.is_complex:
                rho = rho.real
            return torch.as_tensor(rho, device=dev).to(dtype), lam

        def factor(rho):
            """(eigenvalues (host), eigenvectors, their charge labels)."""
            if charged:
                return charged_eigh(rho, q0_cur, chinfo)
            e, U = robust_eigh(rho)
            return e.cpu().numpy(), U, None

        # the gauge pass repeats while the cell is reducible: the SVD of Y X
        # is then rank-deficient and one pass only projects onto the common
        # invariant support
        S_host = None
        q_mid = q0_cur
        for _pass in range(4):
            chi = T[0].shape[0]
            rho_R, lam = dominant("right", chi)
            rho_L, _ = dominant("left", chi)
            if charged:
                # the fixed points are block diagonal; the mask removes
                # cross-sector power-iteration residue, which does not decay
                # between superselection sectors
                mask = torch.as_tensor(chinfo.equal(q0_cur[:, None], q0_cur[None, :]),
                                       device=dev)
                rho_R, rho_L = rho_R * mask, rho_L * mask
            # normalise so the cell transfer matrix has dominant eigenvalue 1
            scale = lam ** (-0.5 / L)
            T = [Ti * scale for Ti in T]

            eR, UR, qR_cols = factor(rho_R)
            keepR = np.nonzero(eR > max(cutoff * eR.max(), 0.0))[0]
            sR = torch.as_tensor(np.sqrt(eR[keepR]), device=dev).to(dtype)
            X = UR[:, _idx(keepR, dev)] * sR[None, :]  # (chi, kR)
            Xp = (1.0 / sR)[:, None] * UR[:, _idx(keepR, dev)].conj().T
            eL, UL, qL_cols = factor(rho_L)
            keepL = np.nonzero(eL > max(cutoff * eL.max(), 0.0))[0]
            sL = torch.as_tensor(np.sqrt(eL[keepL]), device=dev).to(dtype)
            Y = (UL[:, _idx(keepL, dev)] * sL[None, :]).conj().T  # (kL, chi)

            if charged:
                _U, S_host, Vh, q_mid, _err = charged_svd(Y @ X, qL_cols[keepL], qR_cols[keepR],
                                                          chinfo, qtotal=0, cutoff=cutoff,
                                                          normalize=True)
                V = Vh.conj().T  # (kR, r), columns labelled q_mid
            else:
                _U, S, Vh = robust_svd(Y @ X)
                S_host = S.cpu().numpy()
                r = int((S_host > cutoff * S_host.max()).sum())
                S_host = S_host[:r] / np.linalg.norm(S_host[:r])
                V = Vh[:r, :].conj().T  # (kR, r)

            T[0] = torch.einsum("ra,anb->rnb", V.conj().T @ Xp, T[0])
            T[-1] = torch.einsum("anb,br->anr", T[-1], X @ V)
            if charged:
                q0_cur = chinfo.make_valid(np.asarray(q_mid))
            # converged when the whole cell is right-canonical
            E = transfer("right", torch.eye(T[-1].shape[2], dtype=dtype, device=dev), T)
            resid = float((E - torch.eye(E.shape[0], dtype=dtype, device=dev)).abs().max())
            if resid < 1e-9:
                break
        else:
            logger.warning("canonical_form_infinite: boundary gauge residual %.2e after "
                           "4 passes (reducible MPS?)", resid)

        # right-to-left LQ sweep: each interior tensor right-canonical (the
        # whole cell already is, so T[0] ends up right-canonical too)
        q_cur = ([q0_cur] + [np.asarray(self.q_bond[i]).copy() for i in range(1, L)]
                 + [q0_cur + delta])
        for i in reversed(range(1, L)):
            a, d, b = T[i].shape
            M = T[i].reshape(a, d * b)
            if charged:
                qp = np.asarray(self.sites[i].charges, np.int64)
                q_colM = chinfo.make_valid(
                    (q_cur[i + 1][None, :] - qp[:, None] + qt[i]).reshape(-1))
                Q_t, R_t, q_mid_i = charged_qr(M.conj().T, q_colM, q_cur[i], chinfo, qtotal=0)
                q_cur[i] = chinfo.make_valid(np.asarray(q_mid_i))
            else:
                Q_t, R_t = robust_qr(M.conj().T)  # M = R^H Q^H
            T[i] = Q_t.conj().T.reshape(-1, d, b)
            T[i - 1] = torch.einsum("anb,bc->anc", T[i - 1], R_t.conj().T)

        # interior bonds: diagonalise the left environment
        S_list = [None] * (L + 1)
        S_list[0] = S_list[L] = S_host
        rho = torch.diag(torch.as_tensor(S_host**2, device=dev)).to(dtype)
        for i in range(L - 1):
            rho = torch.einsum("ab,anc,bnd->cd", rho, T[i], T[i].conj())
            rho = (rho + rho.conj().T) / 2
            if charged:
                e_h, W, qW = charged_eigh(rho, q_cur[i + 1], chinfo)
                e_h = np.clip(e_h, 0.0, None)
                # (charge ascending, value descending), as charged_svd orders
                order = np.lexsort((-e_h, qW))
                q_cur[i + 1] = qW[order]
            else:
                e, W = robust_eigh(rho)
                e_h = np.clip(e.cpu().numpy(), 0.0, None)
                order = np.argsort(e_h)[::-1].copy()
            W = W[:, _idx(order, dev)]
            e_h = e_h[order]
            T[i] = torch.einsum("anb,bc->anc", T[i], W)
            T[i + 1] = torch.einsum("ba,bnc->anc", W.conj(), T[i + 1])
            s = np.sqrt(e_h)
            nrm = np.linalg.norm(s)
            S_list[i + 1] = s / (nrm if nrm > 0 else 1.0)
            rho = torch.diag(torch.as_tensor(e_h, device=dev)).to(dtype)

        self._B = T
        self._S = S_list
        self.form = ["B"] * L
        if charged:
            self.q_bond = [np.asarray(q).copy() for q in q_cur]
            self.qtotal = qt
        else:
            self.q_bond = ([np.zeros(Ti.shape[0], np.int64) for Ti in T]
                           + [np.zeros(T[-1].shape[2], np.int64)])
            self.qtotal = np.zeros(L, np.int64)
        self.transfer_stats = stats
        return self

    def __repr__(self):
        return (f"MPS(L={self.L}, bc={self.bc!r}, chi_max={self.chi_max}, "
                f"chinfo={self.chinfo}, device={self.device}, "
                f"forms={''.join(str(f)[0] for f in self.form)})")
