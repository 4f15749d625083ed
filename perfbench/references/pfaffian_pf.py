"""Plain reference of the BdG (Nambu mean-field) state -> MPS conversion.

Works out again, from the BdG Hamiltonian alone, what the program
derives: the Majorana correlation matrix, the Schmidt spectrum and the
parity labels of every bond, and the site tensors of chosen sites, signed,
up to one phase per bond state.  NumPy on the host for the correlation
matrix and the parities, plain PyTorch for each cut's eigenvectors, the
overlaps and the Pfaffians.  It imports nothing of the program.

Conventions.  The Hamiltonian is in the complex-fermion Nambu layout: the
many-body Hamiltonian is sum_ab Psi_a^dag H_ab Psi_b with Psi = (c_0,
c_0^dag, c_1, c_1^dag, ...).  The Majoranas are gamma_2i = (c^dag_i +
c_i)/sqrt 2, gamma_2i+1 = i (c^dag_i - c_i)/sqrt 2, with the Jordan-Wigner
string of sites 0..i-1 in c_i.  ``majorana_correlation`` gives
C_jk = <gamma_k gamma_j>, so an operator sum_j w_j gamma_j annihilates the
state where conj(w) lies in the null space of C.  The correlation block of
the first x sites (2x Majoranas) has eigenvalues in pairs (e, 1 - e),
e <= 1/2.  The unexcited left Schmidt state Omega_x of cut x is annihilated
by the x modes d_k whose coefficients are the conjugated eigenvectors of
eigenvalue e_k; the state of the excited set S is prod_{k in S, ascending}
d_k^dag Omega_x.  Its Schmidt value is the product of sqrt(e) (excited)
and sqrt(1 - e) (not), over the entangled modes (e > svd_min^2); its label
is its fermion parity: that of Omega_x (``vacuum_parities``) plus the
number of excitations, mod 2.

Site tensors.  A[a, n, b] = <L_a(i) n_i | L_b(i + 1)> in the occupation
basis (|L_a> x |1> = (-1)^q_a c_i^dag |L_a> x |0>), and B = A lambda_b /
lambda_a.  Each entry follows from Wick's theorem between the unexcited
states Phi = Omega_i x |p> and Psi = Omega_{i+1} (p makes their parities
equal): <Phi| O_1 ... O_m |Psi> = <Phi|Psi> Pf(M), where the O are the
bra's excitations (adjoint, reversed), the site's operator and the ket's
excitations, and M_rs = <Phi|O_r O_s|Psi> / <Phi|Psi> (r < s) is the
bilinear product of O_r's part that annihilates Psi with O_s's part that
annihilates the bra.  |<Phi|Psi>| = |det(W_Phi^H W_Psi)|^(1/2) (Onishi);
its phase, like every Schmidt state's, is a free phase per bond state,
which the comparison allows (``perfbench/checks.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from references.slater_det import DEG_TOL, SVD_MIN, _leading_subsets, _truncate

CONTROL = "complex64"
"""The control: the reference in the next lower precision."""
PF_CHUNK_BYTES = 1 << 30
"""Largest batch of contraction matrices per Pfaffian call (with room for
the elimination's copies)."""
_C2M = np.array([[1, 1], [1j, -1j]]) / 2**0.5


def majorana_correlation(H: np.ndarray, dtype) -> np.ndarray:
    """The ground state's correlation matrix in the Majorana basis, from
    the negative-energy eigenvectors of the Nambu Hamiltonian."""
    e, v = np.linalg.eigh(np.asarray(H, dtype))
    v = v[:, e < 0]
    L = len(H) // 2
    v = np.einsum("xa...,ca->xc...", v.reshape(L, 2, -1), _C2M.astype(dtype)).reshape(2 * L, -1)
    return v @ v.conj().T


def _empty_site_null(dtype) -> np.ndarray:
    """The coefficients of c over one site's two Majoranas: the conjugated
    null vector of the correlation matrix of H = c^dag c (whose ground
    state is empty)."""
    C = majorana_correlation(np.diag([0.5, -0.5]).astype(dtype), dtype)
    w, v = np.linalg.eigh(C)
    return v[:, 0].conj()


def vacuum_parities(CM: np.ndarray, site: np.ndarray) -> np.ndarray:
    """Per cut x = 0..L, the fermion parity (0 even, 1 odd) of the left
    block's unexcited Schmidt state.  The block's real covariance
    G_x = 2 Im C[:2x, :2x] has Pfaffian prod_k (1 - 2 e_k) times that
    state's parity sign (relative to the empty block's, whose Pfaffian is
    ``site``'s to the power x), and every e_k < 1/2; the sign of Pf(G_x)
    follows cut by cut from Pf([[A, B], [-B^T, D]]) = Pf(A) Pf(D + B^T A^-1 B)."""
    G = 2 * CM.imag.astype(np.float64)
    L = len(G) // 2
    g_site = 2 * site.imag.astype(np.float64)[0, 1]
    out = np.zeros(L + 1, np.int64)
    sign = 1.0
    for x in range(L):
        A, B = G[: 2 * x, : 2 * x], G[: 2 * x, 2 * x : 2 * x + 2]
        S = G[2 * x : 2 * x + 2, 2 * x : 2 * x + 2]
        if x:
            S = S + B.T @ np.linalg.solve(A, B)
        sign *= np.sign(S[0, 1]) * np.sign(g_site)
        out[x + 1] = 0 if sign > 0 else 1
    return out


class Cut:
    """The kept left Schmidt states of one cut, sorted by parity and, inside
    a parity, by decreasing Schmidt value: ``lam`` (unnormalised), ``q``
    (parity labels), ``p0`` (the parity of the unexcited state), ``W``
    (2x, x: the coefficients of the unexcited state's annihilators d_k;
    only where ``vectors``) and ``occ`` (bool (states, x): the modes a
    state leaves unexcited)."""

    def __init__(self, CM: np.ndarray, x: int, chi: int, p0: int, device,
                 vectors: bool = True):
        self.W, self.p0 = None, int(p0)
        if x == 0:
            self.W = np.zeros((0, 0), CM.dtype)
            self.lam, self.q = np.ones(1), np.zeros(1, np.int64)
            self.occ = np.zeros((1, 0), bool)
            return
        block = torch.as_tensor(np.ascontiguousarray(CM[: 2 * x, : 2 * x]), device=device)
        if vectors:
            mu, V = torch.linalg.eigh(block)
            # eigenvalues e <= 1/2, ascending: conjugated, the annihilators
            self.W = V[:, :x].conj().resolve_conj().cpu().numpy()
        else:  # the spectrum alone: the cut's tensors are not compared
            mu = torch.linalg.eigvalsh(block)
        e = np.clip(mu[:x].cpu().numpy().astype(np.float64), 0.0, 0.5)
        if np.any(np.abs(e - 0.5) < 1e-8):
            raise ValueError(f"cut {x}: an eigenvalue 1/2 (a zero mode) leaves the state open")
        ent = np.nonzero(e > SVD_MIN**2)[0]
        a = np.log((1 - e[ent]) / e[ent]) / 2  # cost of exciting
        base_log = -np.sum(np.log1p(-e[ent])) / 2
        subs = _leading_subsets(a, chi, -np.log(SVD_MIN) + DEG_TOL)
        logv = np.array([base_log + s for s, _ in subs])
        keep = _truncate(logv, chi)
        occ = np.ones((keep, x), bool)
        for r, (_, flips) in enumerate(subs[:keep]):
            occ[r, ent[list(flips)]] = False
        lam = np.exp(-logv[:keep])
        q = ((~occ).sum(1) + p0) % 2
        order = np.lexsort((-lam, q))
        self.lam, self.q, self.occ = lam[order], q[order], occ[order]


def bond_spectra(H: np.ndarray, chi: int, dtype=np.complex128, sites=(), device="cpu"):
    """Per bond b = 0..L: (normalised Schmidt values, parities), the cuts
    themselves (with vectors where a site of ``sites`` needs them) and the
    coefficients of an empty site's annihilator."""
    CM = majorana_correlation(H, dtype)
    empty = _empty_site_null(dtype)
    L = CM.shape[0] // 2
    C_site = majorana_correlation(np.diag([0.5, -0.5]).astype(dtype), dtype)
    p0 = vacuum_parities(CM, C_site)
    need = {b for i in sites for b in (i, i + 1)}
    cuts = [Cut(CM, x, chi, p0[x], device, x in need) for x in range(L + 1)]
    return [(c.lam / np.linalg.norm(c.lam), c.q) for c in cuts], cuts, empty


def pfaffian(A: torch.Tensor) -> torch.Tensor:
    """Pfaffians of a batch (B, m, m) of skew-symmetric matrices, m even:
    Parlett-Reid elimination with the largest pivot of each column."""
    A = A.clone()
    B, m, _ = A.shape
    pf = torch.ones(B, dtype=A.dtype, device=A.device)
    rows = torch.arange(B, device=A.device)
    for k in range(0, m - 1, 2):
        kp = k + 1 + A[:, k + 1:, k].abs().argmax(1)
        perm = torch.arange(m, device=A.device).repeat(B, 1)
        perm[rows, k + 1] = kp
        perm[rows, kp] = k + 1
        A = A[rows[:, None, None], perm[:, :, None], perm[:, None, :]]
        pf = torch.where(kp != k + 1, -pf, pf) * A[:, k, k + 1]
        if k + 2 < m:
            piv = A[:, k, k + 1]
            tau = A[:, k, k + 2:] / torch.where(piv == 0, torch.ones_like(piv), piv)[:, None]
            col = A[:, k + 2:, k + 1]
            A[:, k + 2:, k + 2:] += tau[:, :, None] * col[:, None, :] - col[:, :, None] * tau[:, None, :]
    return pf


def _excited(occ: np.ndarray) -> list[list[int]]:
    """Per Schmidt state, its excited modes in increasing order."""
    return [list(np.nonzero(~row)[0]) for row in occ]


def site_tensor(cuts, empty, i: int, form: str, device, dtype=torch.complex128) -> np.ndarray:
    """The (chi_i, 2, chi_{i+1}) tensor of site i in ``form`` "A" or "B",
    each entry <L_a(i) n_i | L_b(i + 1)> signed, by Wick's theorem between
    the two cuts' unexcited states (see the module docstring)."""
    a, b = cuts[i], cuts[i + 1]
    N = i + 1
    cdt = np.complex128 if dtype == torch.complex128 else np.complex64
    low_a = np.zeros((2 * N, i), cdt)
    low_a[: 2 * i] = a.W
    e = np.zeros(2 * N, cdt)
    e[2 * i:] = empty  # the site's annihilator c_i
    low_b = b.W
    p = (b.p0 - a.p0) % 2  # the site's occupation in the bra's unexcited state
    W_phi = np.concatenate([low_a, (e if p == 0 else e.conj())[:, None]], 1)
    W_psi = low_b
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=device).to(dtype)
    ov = torch.linalg.det(t(W_phi.conj().T @ W_psi)).abs().sqrt()  # |<Phi|Psi>| (Onishi)
    # operators: d_k (k < i), c_i (i), c_i^dag (i + 1), g_l^dag (i + 2 + l)
    X = np.concatenate([low_a, e[:, None], e.conj()[:, None], low_b.conj()], 1)
    coef = torch.linalg.solve(t(np.concatenate([W_psi, W_phi.conj()], 1)), t(X))
    # <Phi| g(x) g(y) |Psi> / <Phi|Psi> = (w_x . u_y), x = u_x + w_x, w in
    # span W_psi (annihilates the ket), u in span conj(W_phi) (the bra)
    M = coef[:N].T @ (t(W_psi).T @ t(W_phi.conj())) @ coef[N:]
    M = torch.nn.functional.pad(M, (0, 1, 0, 1))  # index -1: a pad
    sa, sb = _excited(a.occ), _excited(b.occ)
    na, nb = len(a.q), len(b.q)
    T = np.zeros((na, 2, nb), complex)
    for n in (0, 1):
        bra = [([i + 1] if p else []) + sorted(s, reverse=True) + ([i] if n else []) for s in sa]
        ket = [[i + 2 + l for l in s] for s in sb]
        ia, ib = np.nonzero((a.q[:, None] + n) % 2 == b.q[None, :] % 2)
        if not ia.size:
            continue
        ka, kb = max(map(len, bra)), max(map(len, ket))
        K = ka + kb + (ka + kb) % 2
        braI = np.full((na, ka), -1)
        for r, s in enumerate(bra):
            braI[r, : len(s)] = s
        ketI = np.full((nb, kb), -1)
        for r, s in enumerate(ket):
            ketI[r, : len(s)] = s
        step = max(1, PF_CHUNK_BYTES // (K * K * 16 * 4))
        vals = []
        for s0 in range(0, ia.size, step):
            idx = np.concatenate([braI[ia[s0:s0 + step]], ketI[ib[s0:s0 + step]]], 1)
            idx = np.pad(idx, ((0, 0), (0, K - idx.shape[1])), constant_values=-1)
            order = np.argsort(idx < 0, axis=1, kind="stable")  # the operators first, in order
            idx = np.take_along_axis(idx, order, 1)
            m = (idx >= 0).sum(1)
            assert not np.any(m % 2), "an odd number of operators between equal parities"
            I = torch.as_tensor(idx, device=device)
            C = torch.triu(M[I[:, :, None], I[:, None, :]], 1)
            j = np.arange(K - 1)
            pad = torch.as_tensor((j[None, :] >= m[:, None]) & ((j[None, :] - m[:, None]) % 2 == 0),
                                  device=device).to(dtype)
            C[:, j, j + 1] += pad  # unit 2 x 2 blocks on the pads: Pfaffian 1
            vals.append(pfaffian(C - C.transpose(1, 2)))
        v = (torch.cat(vals) * ov).to(torch.complex128).cpu().numpy()
        if n:  # |L_a> x |1> in the occupation basis is (-1)^q_a c_i^dag |L_a, 0>
            v = v * (1 - 2 * (a.q[ia] % 2))
        T[ia, n, ib] = v
    if form == "B":
        T *= b.lam[None, None, :] / a.lam[:, None, None]
    return T


def state(H: np.ndarray, chi: int, sites, device, precision: str = "complex128") -> dict:
    """The reference's bond data and the tensors of ``sites`` (left canonical
    left of the centre L // 2, right canonical from it on), in
    ``precision`` ("complex128"; "complex64" is the control)."""
    np_dtype, t_dtype = {"complex128": (np.complex128, torch.complex128),
                         "complex64": (np.complex64, torch.complex64)}[precision]
    spectra, cuts, empty = bond_spectra(H, chi, np_dtype, sites, device)
    L = len(cuts) - 1
    tensors = {i: site_tensor(cuts, empty, i, "A" if i < L // 2 else "B", device, t_dtype)
               for i in sites}
    return {"lam": [s[0] for s in spectra], "q": [s[1] for s in spectra],
            "tensors": tensors, "structure_errors": 0}
