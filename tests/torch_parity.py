"""Comparisons shared by the parity tests of temfpy_torch's infinite chains,
Gutzwiller projection and iMPS against temfpy_tpu (invariants only, never
tensors entry by entry)."""

import numpy as np


def squared_spectra_diff(a, b):
    """Max squared-Schmidt difference per bond and charge of two MPS (either
    package's); the bond labels and the tensor charges must be equal."""
    worst = 0.0
    for bnd in range(a.L + 1):
        qa, qb = np.asarray(a.q_bond[bnd]), np.asarray(b.q_bond[bnd])
        np.testing.assert_array_equal(qa, qb, err_msg=f"bond {bnd}")
        for q in np.unique(qa):
            sa = np.sort(np.asarray(a.get_SL(bnd))[qa == q])
            sb = np.sort(np.asarray(b.get_SL(bnd))[qb == q])
            worst = max(worst, float(np.abs(sa**2 - sb**2).max()))
    np.testing.assert_array_equal(a.qtotal, b.qtotal)
    return worst


def error_diff(a, b):
    """Max difference of the squared iMPSError fields: each field is the
    root of a difference of O(1) sums, so at rounding level its root
    amplifies the summation order."""
    return max(abs(x * x - y * y) for x, y in zip(a, b))


def host(m):
    """A temfpy_tpu MPS with host numpy tensors: its methods then take their
    numpy branch (the one the JAX package runs for host tensors), the same
    algorithm without a compile per operation shape."""
    m._B = [np.asarray(B) for B in m._B]
    return m


def right_canonical_residual(m):
    """max |sum_n B B^H - I| over the tensors of a right-canonical MPS."""
    out = 0.0
    for B in m._B:
        B = np.asarray(B)
        g = np.einsum("anb,cnb->ac", B, B.conj())
        out = max(out, float(np.abs(g - np.eye(len(g))).max()))
    return out


def charge_rule_violation(m):
    """Largest entry of any tensor that breaks its charge rule
    q_left + q_phys - q_right == qtotal."""
    out = 0.0
    for i in range(m.L):
        B = np.asarray(m._B[i])
        bad = (np.asarray(m.q_bond[i])[:, None, None] + m.sites[i].charges[None, :, None]
               - np.asarray(m.q_bond[i + 1])[None, None, :] - m.qtotal[i]) != 0
        out = max(out, float(np.abs(B[bad]).max(initial=0.0)))
    return out
