r"""Numerical self-verification contracts with controllable strictness.

API parity with reference ``temfpy/testing.py``: a global switch
:data:`TEST_ACTION` decides whether failed checks raise, warn, or are skipped
entirely.  These checks run *inside* the library at every algorithmic
checkpoint (eigenvalue pairing, Nambu symmetry, Schmidt-decomposition
reconstruction), forming an always-on numerical contract.

Device note: all checks convert to host numpy.  Set ``TEST_ACTION = "pass"``
to skip them entirely (no device->host transfer happens in that case), which
is the recommended production mode on the GPU.
"""

from __future__ import annotations

import warnings
from typing import Literal

import numpy as np

from .utils import HT
from .config import DIAG_TOL as _DIAG_TOL  # noqa: F401  (re-export, ref testing.py:15)

TEST_ACTION: Literal["raise", "warn", "pass"] = "warn"
"""How library-internal checks behave: "raise" AssertionError, "warn" (default)
a :class:`ComparisonWarning`, or "pass" (skip, fastest)."""


def _host(x) -> np.ndarray:
    """numpy copy of a host array or a (device) torch tensor."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class ComparisonWarning(Warning):
    """Warning issued when a library-internal numerical check fails."""


def _shape_mismatch(x, y, strict: bool = False) -> bool:
    if np.ndim(x) == 0 and np.ndim(y) == 0:
        return False
    if np.ndim(x) == 0 or np.ndim(y) == 0:
        return strict
    return np.shape(x) != np.shape(y)


def _dispatch(check, err_msg: str):
    """Runs `check` (a thunk raising AssertionError) according to TEST_ACTION."""
    if TEST_ACTION == "raise":
        check()
    elif TEST_ACTION == "warn":
        try:
            check()
        except AssertionError as err:
            warnings.warn("\n" + err_msg + str(err), category=ComparisonWarning)
    elif TEST_ACTION != "pass":
        raise ValueError(
            f"Invalid value {TEST_ACTION!r} of `temfpy_torch.testing.TEST_ACTION`, "
            "must be one of 'raise', 'warn', 'pass'."
        )


def assert_allclose(
    actual,
    desired,
    rtol: float = 1e-7,
    atol: float = 0.0,
    equal_nan: bool = True,
    err_msg: str = "",
    verbose: bool = False,
    *,
    strict: bool = False,
):
    """Tolerance check honouring :data:`TEST_ACTION` (reference testing.py:54-93).

    Shape mismatches always raise, regardless of TEST_ACTION.
    """
    if TEST_ACTION == "pass":
        return
    actual = np.asarray(actual)
    desired = np.asarray(desired)
    if _shape_mismatch(actual, desired, strict):
        np.testing.assert_allclose(
            actual, desired, rtol, atol, equal_nan, err_msg, verbose, strict=strict
        )
        return
    _dispatch(
        lambda: np.testing.assert_allclose(
            actual, desired, rtol, atol, equal_nan, err_msg, verbose, strict=strict
        ),
        err_msg,
    )


def assert_array_less(x, y, err_msg: str = "", verbose: bool = False, *, strict: bool = False):
    """Elementwise-less check honouring :data:`TEST_ACTION`
    (reference testing.py:96-128)."""
    if TEST_ACTION == "pass":
        return
    x = np.asarray(x)
    y = np.asarray(y)
    if _shape_mismatch(x, y, strict):
        np.testing.assert_array_less(x, y, err_msg, verbose, strict=strict)
        return
    _dispatch(
        lambda: np.testing.assert_array_less(x, y, err_msg, verbose, strict=strict),
        err_msg,
    )


def check_schmidt_decomposition(modes, C, diag_tol: float = _DIAG_TOL):
    """Verifies that Schmidt modes are consistent with the correlation matrix
    (reference testing.py:131-177).

    Checks that vL/vR are unitary, that they diagonalise the diagonal blocks
    C_LL / C_RR, and that the entangled modes SVD the offdiagonal block C_LR.
    Works for both Slater (:class:`temfpy_torch.slater.SchmidtModes`) mode objects via
    their common interface (`vL`, `vR`, `eigenvalues`, `vL_entangled`,
    `vR_entangled`, `singular_values`).
    """
    if TEST_ACTION == "pass":  # skip all computation
        return

    C = _host(C)
    tol = dict(rtol=0, atol=diag_tol)

    vL = None if modes.vL is None else _host(modes.vL)
    vR = None if modes.vR is None else _host(modes.vR)

    if vL is not None:
        N = len(vL)
        assert_allclose(vL @ HT(vL), np.eye(N), **tol, err_msg="vL is not unitary")
        CLL = (np.asarray(modes.eigenvalues("L")) * vL) @ HT(vL)
        assert_allclose(CLL, C[:N, :N], **tol, err_msg="vL does not diagonalise C_LL")
    if vR is not None:
        M = len(vR)
        n = len(C) - M
        assert_allclose(vR @ HT(vR), np.eye(M), **tol, err_msg="vR is not unitary")
        CRR = (np.asarray(modes.eigenvalues("R")) * vR) @ HT(vR)
        assert_allclose(CRR, C[n:, n:], **tol, err_msg="vR does not diagonalise C_RR")
    if vL is not None and vR is not None:
        assert n == N, f"Inconsistent sizes ({N} + {M} != {len(C)})"
        SV = np.asarray(modes.singular_values)
        vLE = _host(modes.vL_entangled)
        vRE = _host(modes.vR_entangled)
        # projected contract: the entangled modes must SVD C_LR *within
        # their span*.  The full reconstruction (SV vLE) vRE^H = C_LR used
        # by the reference (testing.py:172-177) has an intrinsic residual
        # floor of sqrt(largest truncated eigenvalue) <= svd_min from the
        # sub-cutoff modes' weight in C_LR, which spuriously exceeds
        # diag_tol on e.g. PH-doubled spectra; the projected form checks
        # exactly what the modes claim.
        S_proj = HT(vLE) @ C[:N, N:] @ vRE[:, ::-1]
        assert_allclose(
            S_proj, np.diag(SV), **tol, err_msg="vL and vR do not SVD C_LR"
        )


def random_det_fill_case(seed: int, *, G: int, w: int, m: int, P: int, spec: str = "rrc",
                         n_rows: int = 1024, dtype=np.float64):
    """Seeded inputs of :func:`temfpy_torch.ops.kernels.det_fill` shaped like
    one fill group of the main path: ``G`` sites, sometimes matrices (m, m),
    occupation tables of ``n_rows`` bond rows of width ``w`` (each row
    occupies w, w-1 or w-2 orbitals, the rest sentinels; the last row all
    sentinels), ``P`` distinct charge-matching pairs padded to a power of
    two, and injective scatter tables.  Returns (args, kwargs) as numpy."""
    rng = np.random.default_rng(seed)
    R = K = n_rows
    cnt = w - (np.arange(R) % 3)
    cnt[-1] = 0

    def occ_table():
        t = np.empty((R, w), np.int32)
        for r in range(R):
            t[r, : cnt[r]] = np.sort(rng.choice(m, size=cnt[r], replace=False))
            t[r, cnt[r]:] = m + np.arange(cnt[r], w)
        return t

    occ_b, occ_k = occ_table(), occ_table()
    # distinct pairs (r, c) with equal occupation counts, i.e. r = c (mod 3)
    n3 = (R - 1) // 3
    flat = rng.choice(n3 * 3 * n3, size=P, replace=False)
    r = flat // n3
    c = 3 * (flat % n3) + r % 3
    P_b = 256
    while P_b < P:
        P_b *= 2
    pr = np.full(P_b, R - 1, np.int32)
    pc = np.full(P_b, K - 1, np.int32)
    pr[:P], pc[:P] = r, c
    half = R // 2
    row_a = np.arange(R, dtype=np.int32) // 2  # injective with row_b
    row_b = np.arange(R, dtype=np.int32) % 2
    col = np.arange(K, dtype=np.int32)
    if spec == "rrc":
        row_a[-1] = half
        tabs, shape = (row_a, row_b, col), (half, 2, K)
    elif spec == "crr":
        col[-1] = K - 1
        tabs, shape = (col, row_b, row_a), (K - 1, 2, half)
    elif spec == "rc":
        rows = np.arange(R, dtype=np.int32)
        tabs, shape = (rows, col, np.zeros(1, np.int32)), (R - 1, K)
    else:
        raise ValueError(spec)
    M = rng.normal(size=(G, m, m), scale=m**-0.5).astype(dtype)
    if np.iscomplexobj(M):
        M = M + 1j * rng.normal(size=(G, m, m), scale=m**-0.5)
    det = (1.0 + rng.random(G)).astype(dtype)
    stack = lambda a: np.stack([a] * G)  # noqa: E731
    args = (M, det, stack(occ_b), stack(occ_k), stack(pr), stack(pc),
            tuple(stack(t) for t in tabs))
    return args, {"spec": spec, "shape": shape}


def random_site_overlap_case(seed: int, *, G: int, L: int, kb: int, sb: int,
                             mode: str, dtype=np.float64):
    """Seeded inputs of :func:`temfpy_torch.ops.kernels.site_overlap_schur`
    shaped like one overlap group of the main path: (L, L) orthogonal bra
    frames, ket frames rotated slightly away from them, and descriptors
    of width mb = kb + sb with frame, one-hot and zero columns in the
    layout of ``slater._plan_site``.  Returns (args, kwargs) as numpy."""
    rng = np.random.default_rng(seed)
    mb = kb + sb

    def rand(*shape):
        x = rng.normal(size=shape)
        return x + 1j * rng.normal(size=shape) if np.issubdtype(dtype, np.complexfloating) else x

    fb = np.stack([np.linalg.qr(rand(L, L))[0] for _ in range(G)]).astype(dtype)
    rot = np.stack([np.linalg.qr(np.eye(L) + 0.1 * rand(L, L))[0] for _ in range(G)])
    fk = (fb @ rot).astype(dtype)
    col = np.zeros((G, mb), np.int32)
    kind = np.zeros((G, mb), np.int32)
    row = np.zeros((G, mb), np.int32)
    for g in range(G):
        col[g] = rng.choice(L, size=mb, replace=False)
        # always block: up to 4 one-hot padding columns; sometimes block: 2 zero
        # padding columns and one one-hot (physical) column
        a0 = 0 if mode == "left" else sb
        s0 = kb if mode == "left" else 0
        n_oh = min(4, kb // 2)
        kind[g, a0 + kb - n_oh : a0 + kb] = 1
        row[g, a0 + kb - n_oh : a0 + kb] = L - 1 - np.arange(n_oh)
        kind[g, s0 + sb - 2 : s0 + sb] = 2
        kind[g, s0] = 1
        row[g, s0] = L // 2 + 1
    signb = rng.choice([-1.0, 1.0], size=(G, mb))
    signk = rng.choice([-1.0, 1.0], size=(G, mb))
    args = (fb, fk, col, kind, row, signb, col.copy(), kind.copy(), row.copy(), signk)
    return args, {"kb": kb, "mode": mode}
