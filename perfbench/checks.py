"""The comparison that decides ``correct``: a converted state against the
plain reference, on the same Hamiltonian.

A state is given as bond data, per bond b = 0..L the Schmidt values
``lam[b]`` and their charges ``q[b]``, and the site tensors ``tensors[i]``
(chi_i, d, chi_{i+1}) of sampled sites.  Bond states are matched by charge
and, inside a charge, by decreasing Schmidt value.  The compared numbers:

- ``spectrum_gap``: the largest gap between matched Schmidt values over all
  bonds; a state that one side keeps and the other does not counts with its
  whole value.  It covers the frontend's spectra, the enumeration and the
  charges.
- ``tensor_gap``: over the compared sites, the largest entry of
  |T - D R E| over the largest |R|, where R is the reference tensor and D,
  E are one phase per bond state (each Schmidt state's sign or phase is
  arbitrary), fixed along a maximum spanning tree of |R|.  Signs and
  phases are compared: only what a choice of phase per bond state can
  absorb is not.
- ``structure_errors`` (exact): site tensors whose shape does not match
  their bonds, and entries that break the charge rule, counted.
"""

from __future__ import annotations

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import breadth_first_order, connected_components, minimum_spanning_tree


def match_bond(lam_p, q_p, lam_r, q_r):
    """(gap, indices into the program's states, indices into the
    reference's) for one bond."""
    gap, ip, ir = 0.0, [], []
    for q in np.union1d(q_p, q_r):
        a = np.nonzero(q_p == q)[0]
        b = np.nonzero(q_r == q)[0]
        a = a[np.argsort(-lam_p[a], kind="stable")]
        b = b[np.argsort(-lam_r[b], kind="stable")]
        k = min(a.size, b.size)
        if k:
            gap = max(gap, float(np.abs(lam_p[a[:k]] - lam_r[b[:k]]).max()))
        for extra in (lam_p[a[k:]], lam_r[b[k:]]):
            if extra.size:
                gap = max(gap, float(np.abs(extra).max()))
        ip.append(a[:k])
        ir.append(b[:k])
    return gap, np.concatenate(ip).astype(int), np.concatenate(ir).astype(int)


def _unit(z):
    a = np.abs(z)
    return np.where(a > 0, z / np.where(a > 0, a, 1), 1)


def gauge_gap(T, R) -> float:
    """max |T - D R E| / max |R| over (a, n, b), with one unit-modulus
    factor per left state (D) and per right state (E) fixed along a maximum
    spanning tree of the entries of |R| (each pair (a, b) has at most one
    nonzero physical index under a conserved charge or parity)."""
    na, _, nb = R.shape
    scale = float(np.abs(R).max())
    if scale == 0:
        return float(np.abs(T).max())
    Rm = R[np.arange(na)[:, None], np.abs(R).argmax(1), np.arange(nb)[None, :]]
    Tm = T[np.arange(na)[:, None], np.abs(R).argmax(1), np.arange(nb)[None, :]]
    ia, ib = np.nonzero(np.abs(Rm) > scale * 1e-13)
    w = 1.0 + np.log(scale / np.abs(Rm[ia, ib]))
    G = coo_matrix((w, (ia, na + ib)), shape=(na + nb, na + nb)).tocsr()
    tree = minimum_spanning_tree(G)
    tree = (tree + tree.T).tocsr()
    rel = _unit(Tm * np.conj(Rm))  # d_a e_b on every edge
    phase = np.ones(na + nb, dtype=np.result_type(T, R, np.float64))
    _, label = connected_components(tree, directed=False)
    for comp in np.unique(label):
        root = int(np.nonzero(label == comp)[0][0])
        order, pred = breadth_first_order(tree, root, directed=False)
        for node in order[1:]:
            p = pred[node]
            if node >= na:  # right state b reached from left state a = p
                phase[node] = rel[p, node - na] * np.conj(phase[p])
            else:  # left state a reached from right state b = p
                phase[node] = rel[node, p - na] * np.conj(phase[p])
    D, E = phase[:na], phase[na:]
    return float(np.abs(T - D[:, None, None] * R * E[None, None, :]).max()) / scale


def compare(prog: dict, ref: dict) -> dict:
    """The compared numbers of one state (see the module docstring)."""
    spectrum_gap, perm_p, perm_r = 0.0, [], []
    for b in range(len(ref["lam"])):
        gap, ip, ir = match_bond(np.asarray(prog["lam"][b]), np.asarray(prog["q"][b]),
                                 np.asarray(ref["lam"][b]), np.asarray(ref["q"][b]))
        spectrum_gap = max(spectrum_gap, gap)
        perm_p.append(ip)
        perm_r.append(ir)
    tensor_gap = 0.0
    for i, R in ref["tensors"].items():
        T = prog["tensors"][i][perm_p[i]][:, :, perm_p[i + 1]]
        R = R[perm_r[i]][:, :, perm_r[i + 1]]
        tensor_gap = max(tensor_gap, gauge_gap(T, R))
    return {"spectrum_gap": spectrum_gap, "tensor_gap": tensor_gap,
            "structure_errors": int(prog["structure_errors"])}


def worst(readings: list[dict]) -> dict:
    """Per number, the worst reading over several states."""
    return {k: max(r[k] for r in readings) for k in readings[0]}


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number at or below its limit (an exact number's limit is 0)."""
    return all(numbers[k] <= limits[k] for k in limits)
