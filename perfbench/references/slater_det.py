"""Plain reference of the Slater determinant -> MPS conversion.

Works out again, from the single-particle Hamiltonian alone, what the
program derives: the correlation matrix, the Schmidt spectrum and the
charges of every bond (one eigendecomposition of each leading block of
the correlation matrix and a best-first enumeration of the leading
Schmidt states), and the site tensors of chosen sites, each entry a
determinant of orbital overlaps.  NumPy on the host for the spectra,
plain ``torch.linalg.det`` for the determinants.  It imports nothing of
the program.

Conventions.  The left Schmidt state ``s`` of cut ``x`` (sites 0..x-1)
is the Slater determinant of the eigenvectors of ``C[:x, :x]`` whose
eigenvalue is near 1 ("filled") and of the entangled ones (eigenvalue in
(svd_min^2, 1 - svd_min^2)) that ``s`` occupies.  Its Schmidt value is the
product over entangled modes of sqrt(nu) (occupied) or sqrt(1 - nu)
(empty); its charge is its particle number.  The left-canonical tensor of
site i is A[a, n, b] = <L_a(i) n_i | L_b(i + 1)>, a determinant; the
right-canonical one follows from the Schmidt decomposition as
B[a, n, b] = A[a, n, b] lambda_b / lambda_a (unnormalised values).  Each
Schmidt state carries a sign of its own (the sign of an eigenvector, the
order of the orbitals), so tensors are compared up to one sign per bond
state (``perfbench/checks.py``).
"""

from __future__ import annotations

import heapq

import numpy as np
import torch

SVD_MIN = 1e-6
"""Smallest Schmidt value kept, relative to the largest (the program's
documented default)."""
DEG_TOL = 1e-12
"""No cut between Schmidt values whose logarithms differ by less."""
CONTROL = "float32"
"""The control: the reference in the next lower precision."""
DET_CHUNK_BYTES = 1 << 30
"""Largest batch of gathered overlap matrices per determinant call."""


def correlation_matrix(H: np.ndarray, dtype) -> np.ndarray:
    """C = V_occ V_occ^T over the negative-energy eigenvectors of H."""
    e, v = np.linalg.eigh(np.asarray(H, dtype))
    v = v[:, e < 0]
    return v @ v.conj().T


def _leading_subsets(a: np.ndarray, chi: int, max_log: float):
    """The subsets of ``a`` (non-negative flip costs) in increasing order of
    their sum, best first, until ``chi + 1`` of them or a sum above
    ``max_log``: [(sum, subset as a tuple of indices into ``a``)]."""
    order = np.argsort(a, kind="stable")
    c = a[order]
    out = [(0.0, ())]
    heap = [(float(c[0]), 0, (0,))] if len(c) else []
    while heap and len(out) < chi + 1:
        s, last, sub = heapq.heappop(heap)
        if s > max_log:
            break
        out.append((s, sub))
        if last + 1 < len(c):
            heapq.heappush(heap, (s + c[last + 1], last + 1, sub + (last + 1,)))
            heapq.heappush(heap, (s - c[last] + c[last + 1], last + 1, sub[:-1] + (last + 1,)))
    return [(s, tuple(sorted(order[list(sub)]))) for s, sub in out]


def _truncate(logvals: np.ndarray, chi: int) -> int:
    """How many of the ascending -log Schmidt values to keep: at most chi,
    none below SVD_MIN of the largest, and no cut inside a multiplet."""
    n = len(logvals)
    ok = np.arange(n) < chi
    ok &= (logvals - logvals[0]) < -np.log(SVD_MIN)
    gap = np.ones(n, bool)
    gap[:-1] = np.diff(logvals) > DEG_TOL
    ok &= gap
    idx = np.nonzero(ok)[0]
    return int(idx[-1]) + 1 if idx.size else n


class Cut:
    """The kept left Schmidt states of one cut, sorted by charge and, inside
    a charge, by decreasing Schmidt value: ``lam`` (unnormalised),
    ``q`` (particles left of the cut), ``occ`` (bool, occupied columns of
    ``U``) and ``U`` (the block's eigenvectors)."""

    def __init__(self, C: np.ndarray, x: int, chi: int, vectors: bool = True):
        if x == 0:
            self.U = np.zeros((0, 0), C.dtype)
            self.lam, self.q = np.ones(1), np.zeros(1, np.int64)
            self.occ = np.zeros((1, 0), bool)
            return
        if vectors:
            nu, U = np.linalg.eigh(C[:x, :x])
        else:  # the spectrum alone: the cut's tensors are not compared
            nu, U = np.linalg.eigvalsh(C[:x, :x]), None
        nu = np.clip(nu.real.astype(np.float64), 0.0, 1.0)
        cut = SVD_MIN**2
        filled = nu >= 1 - cut
        ent = np.nonzero((nu > cut) & ~filled)[0]
        e = nu[ent]
        with np.errstate(divide="ignore"):
            a = np.log((1 - e) / e) / 2  # -log(sqrt(nu/(1-nu))): cost of occupying
        base = a < 0  # the largest Schmidt value occupies every nu > 1/2
        base_log = -np.sum(np.where(base, np.log(e), np.log1p(-e))) / 2
        subs = _leading_subsets(np.abs(a), chi, -np.log(SVD_MIN) + DEG_TOL)
        logv = np.array([base_log + s for s, _ in subs])
        keep = _truncate(logv, chi)
        occ = np.zeros((keep, x), bool)
        occ[:, filled] = True
        for r, (_, flips) in enumerate(subs[:keep]):
            o = base.copy()
            o[list(flips)] ^= True
            occ[r, ent] = o
        lam = np.exp(-logv[:keep])
        q = occ.sum(1)
        order = np.lexsort((-lam, q))
        self.U, self.lam, self.q, self.occ = U, lam[order], q[order], occ[order]


def bond_spectra(H: np.ndarray, chi: int, dtype=np.float64, sites=()):
    """Per bond b = 0..L: (normalised Schmidt values, charges), and the
    cuts themselves (with eigenvectors where a site of ``sites`` needs
    them)."""
    C = correlation_matrix(H, dtype)
    L = C.shape[0]
    need = {b for i in sites for b in (i, i + 1)}
    cuts = [Cut(C, x, chi, x in need) for x in range(L + 1)]
    return [(c.lam / np.linalg.norm(c.lam), c.q) for c in cuts], cuts


def site_tensor(cuts, i: int, form: str, device, dtype=torch.float64) -> np.ndarray:
    """The (chi_i, 2, chi_{i+1}) tensor of site i in ``form`` "A" (left
    canonical) or "B" (right canonical), in the order of ``cuts``."""
    a, b = cuts[i], cuts[i + 1]
    # orbitals of <L_a n|: the cut-i modes padded to i + 1 sites, then site i
    Ua = np.zeros((i + 1, i + 1), a.U.dtype)
    Ua[:i, :i] = a.U
    Ua[i, i] = 1.0
    O = torch.as_tensor(Ua.T @ b.U, device=device).to(dtype)
    T = np.zeros((len(a.q), 2, len(b.q)))
    for n in (0, 1):
        rows = np.concatenate([a.occ, np.full((len(a.q), 1), bool(n))], 1)
        for qa in np.unique(a.q):
            ia = np.nonzero(a.q == qa)[0]
            ib = np.nonzero(b.q == qa + n)[0]
            if not ib.size:
                continue
            N = int(qa + n)  # orbitals on either side of every pair here
            if N == 0:
                T[np.ix_(ia, [n], ib)] = 1.0
                continue
            R = np.nonzero(rows[ia])[1].reshape(ia.size, N)
            K = np.nonzero(b.occ[ib])[1].reshape(ib.size, N)
            pa, pb = np.repeat(np.arange(ia.size), ib.size), np.tile(np.arange(ib.size), ia.size)
            step = max(1, DET_CHUNK_BYTES // (N * N * 8))
            vals = []
            for s in range(0, pa.size, step):
                r = torch.as_tensor(R[pa[s:s + step]], device=device)
                k = torch.as_tensor(K[pb[s:s + step]], device=device)
                vals.append(torch.linalg.det(O[r[:, :, None], k[:, None, :]]))
            T[ia[pa], n, ib[pb]] = torch.cat(vals).double().cpu().numpy()
    if form == "B":
        T *= b.lam[None, None, :] / a.lam[:, None, None]
    return T


def state(H: np.ndarray, chi: int, sites, device, precision: str = "float64") -> dict:
    """The reference's bond data and the tensors of ``sites`` (left
    canonical left of the centre L // 2, right canonical from it on), in
    ``precision`` ("float64"; "float32" is the control)."""
    np_dtype, t_dtype = {"float64": (np.float64, torch.float64),
                         "float32": (np.float32, torch.float32)}[precision]
    spectra, cuts = bond_spectra(H, chi, np_dtype, sites)
    L = len(cuts) - 1
    tensors = {i: site_tensor(cuts, i, "A" if i < L // 2 else "B", device, t_dtype)
               for i in sites}
    return {"lam": [s[0] for s in spectra], "q": [s[1] for s in spectra],
            "tensors": tensors, "structure_errors": 0}
