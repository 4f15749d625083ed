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

from . import profiling
from .utils import HT
from .config import DIAG_TOL as _DIAG_TOL  # noqa: F401  (re-export, ref testing.py:15)

TEST_ACTION: Literal["raise", "warn", "pass"] = "warn"
"""How library-internal checks behave: "raise" AssertionError, "warn" (default)
a :class:`ComparisonWarning`, or "pass" (skip, fastest)."""


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
    Works for both Slater (:class:`temfpy_torch.slater.SchmidtModes`) and
    Pfaffian (:class:`temfpy_torch.pfaffian.SchmidtModes`) mode objects via
    their common interface (`vL`, `vR`, `eigenvalues`, `vL_entangled`,
    `vR_entangled`, `singular_values`).
    """
    if TEST_ACTION == "pass":  # skip all computation
        return

    C = profiling.to_host(C)
    tol = dict(rtol=0, atol=diag_tol)

    vL = None if modes.vL is None else profiling.to_host(modes.vL)
    vR = None if modes.vR is None else profiling.to_host(modes.vR)

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
        vLE = profiling.to_host(modes.vL_entangled)
        vRE = profiling.to_host(modes.vR_entangled)
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
    occupies c, c-1 or c-2 orbitals, c = min(w, m), at least none, the rest
    sentinels; the last row all sentinels), ``P`` distinct charge-matching
    pairs padded to a power of two, and injective scatter tables.  Returns
    (args, kwargs) as numpy."""
    rng = np.random.default_rng(seed)
    R = K = n_rows
    cnt = np.maximum(min(w, m) - (np.arange(R) % 3), 0)
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


def random_fw_slab_case(seed: int, *, L: int, B: int, kb: int, keb: int, fb: int, Wb: int,
                        n_cuts: int | None = None, packed: bool = False):
    """Seeded inputs of :func:`temfpy_torch.ops.kernels.fw_frame_slab` shaped
    like one slab of the Fishman-White frontend: VT the transpose of an
    (L, L) orthogonal mode matrix; per real cut, between kb/2 and kb
    crossing modes (the rest pad 0 with zero Cmat rows), between keb/2 and
    keb Gram columns, up to fb one-sided modes (the rest -1 pads), a
    colmap that shuffles [Gram | one-sided slots, -1 pads included] and
    ends in at least three pad columns, a block size in [1, L] and the
    counts of real crossing modes and Gram columns; the last B - ``n_cuts``
    cuts (default B - 5: a short last slab) are pad cuts with block size
    and counts 0.  ``packed``: colmap in the order ``ops/fw.py`` packs
    (Gram columns in place, then the real one-sided slots, then pads)
    instead of shuffled.  Returns (VT, flat, Cmat) as numpy."""
    rng = np.random.default_rng(seed)
    n_cuts = B - 5 if n_cuts is None else n_cuts
    V = np.linalg.qr(rng.normal(size=(L, L)))[0]
    o = kb + fb + Wb
    flat = np.zeros((B, o + 3), np.int32)
    flat[:, kb : kb + fb] = -1
    flat[:, kb + fb : kb + fb + Wb] = keb + fb
    Cmat = np.zeros((B, kb, keb))
    for b in range(n_cuts):
        nk = int(rng.integers(max(1, kb // 2), kb + 1))
        m = int(rng.integers(max(1, keb // 2), keb + 1))
        f = int(rng.integers(0, fb + 1))
        flat[b, :nk] = rng.choice(L, nk, replace=False)
        Cmat[b, :nk, :m] = rng.normal(size=(nk, m), scale=nk**-0.5)
        flat[b, kb : kb + f] = rng.choice(L, f, replace=False)
        cols = rng.permutation(np.concatenate([np.arange(m), keb + np.arange(fb)]))
        if packed:
            cols = np.concatenate([np.arange(m), keb + np.arange(f)])
        cols = cols[: Wb - 3]
        flat[b, kb + fb : kb + fb + cols.size] = cols
        flat[b, o : o + 3] = (rng.integers(1, L + 1), nk, m)
    return np.ascontiguousarray(V.T), flat, Cmat


def pip_hamiltonian(W: int, Lx: int, t: float = 1.0, delta: float = 0.5, mu: float = -0.3):
    """BdG Hamiltonian (complex-fermion basis "C") of the chiral p+ip
    superconductor on a W-leg cylinder of length Lx, as bench.py config 5
    builds it (bench.py:105-154; there W=8, Lx=16): hopping t and p_x pairing
    delta along the axis, hopping t and i p_y pairing i*delta around the
    circumference (periodic for W > 2), chemical potential mu."""
    L = W * Lx
    H = np.zeros((2 * L, 2 * L), complex)

    def idx(x, y):
        return x * W + (y % W)

    def add_hop(i, j, amp):
        H[2 * i, 2 * j] += -amp / 2
        H[2 * j, 2 * i] += -np.conj(amp) / 2
        H[2 * i + 1, 2 * j + 1] += np.conj(amp) / 2
        H[2 * j + 1, 2 * i + 1] += amp / 2

    def add_pair(i, j, amp):  # amp c_i^dag c_j^dag + h.c.
        H[2 * i, 2 * j + 1] += amp / 2
        H[2 * j + 1, 2 * i] += np.conj(amp) / 2
        H[2 * j, 2 * i + 1] += -amp / 2
        H[2 * i + 1, 2 * j] += -np.conj(amp) / 2

    for x in range(Lx):
        for y in range(W):
            i = idx(x, y)
            H[2 * i, 2 * i] = -mu / 2
            H[2 * i + 1, 2 * i + 1] = mu / 2
            if x + 1 < Lx:
                add_hop(i, idx(x + 1, y), t)
                add_pair(i, idx(x + 1, y), delta)
            if W > 2:
                add_hop(i, idx(x, y + 1), t)
                add_pair(i, idx(x, y + 1), 1j * delta)
    return H + H.conj().T - np.diag(np.diag(H).real)


def random_pf_fill_case(seed: int, *, G: int, w: int, m: int, P: int, spec: str = "rrc",
                        n_rows: int = 256, zero_every: int = 0):
    """Seeded inputs of :func:`temfpy_torch.ops.kernels.pf_fill` shaped like
    one fill group of the Pfaffian path: ``G`` sites, antisymmetric complex
    N (m, m), ``n_rows`` bra and ket bond rows with up to w/2 excitations
    each (ket positions in [0, m/2), bra positions in [m/2, m); the last
    row of each table a count-0 pad row), ``P`` distinct parity-matching
    pairs padded to a power of two >= 256, and injective scatter tables of
    layout ``spec``.  ``zero_every`` > 0 zeroes N's row and column at every
    zero_every-th bra position: a pair holding one has Pfaffian 0, reached
    by a zero pivot after the steps of the ket positions before it.
    Returns (args, kwargs) as numpy."""
    rng = np.random.default_rng(seed)
    R = K = n_rows
    half = w // 2

    def tables(lo, hi):
        cnt = rng.integers(0, half + 1, R).astype(np.int32)
        cnt[: min(R - 1, 8)] = half  # some rows reach the full width
        cnt[-1] = 0
        pos = np.zeros((R, w), np.int32)
        for r in range(R):
            pos[r, : cnt[r]] = np.sort(rng.choice(np.arange(lo, hi), size=cnt[r], replace=False))
        return pos, cnt

    pos_k, cnt_k = tables(0, m // 2)
    pos_b, cnt_b = tables(m // 2, m)
    rr, cc = np.meshgrid(np.arange(R - 1), np.arange(K - 1), indexing="ij")
    ok = (cnt_b[rr] + cnt_k[cc]) % 2 == 0
    cand = np.flatnonzero(ok)
    if P > cand.size:
        raise ValueError(f"only {cand.size} parity-matching pairs, asked for {P}")
    flat = rng.choice(cand, size=P, replace=False)
    P_b = 256
    while P_b < P:
        P_b *= 2
    pr = np.full(P_b, R - 1, np.int32)
    pc = np.full(P_b, K - 1, np.int32)
    pr[:P], pc[:P] = rr.ravel()[flat], cc.ravel()[flat]
    hr = R // 2
    row_a = np.arange(R, dtype=np.int32) // 2
    row_b = np.arange(R, dtype=np.int32) % 2
    col = np.arange(K, dtype=np.int32)
    if spec == "rrc":
        row_a[-1] = hr
        tabs, shape = (row_a, row_b, col), (hr, 2, K)
    elif spec == "crr":
        tabs, shape = (col, row_b, row_a), (K - 1, 2, hr)
    elif spec == "rc":
        tabs, shape = (np.arange(R, dtype=np.int32), col, np.zeros(1, np.int32)), (R - 1, K)
    else:
        raise ValueError(spec)
    A = rng.normal(size=(G, m, m)) + 1j * rng.normal(size=(G, m, m))
    N = (A - A.transpose(0, 2, 1)) * (0.5 / m**0.5)
    if zero_every:
        z = np.arange(m // 2, m, zero_every)
        N[:, z, :] = 0
        N[:, :, z] = 0
    norm = 0.5 + rng.random(G)
    stack = lambda a: np.stack([a] * G)  # noqa: E731
    args = (N, norm, stack(pos_b), stack(pos_k), stack(cnt_b), stack(cnt_k), stack(pr),
            stack(pc), tuple(stack(t) for t in tabs))
    return args, {"width": w, "spec": spec, "shape": shape}


def random_bdg_overlap_case(seed: int, *, G: int, nb: int, k1: int, k2: int,
                            x: int | None = None, angle: float = 0.3, mode: str | None = None):
    """Seeded inputs of :func:`temfpy_torch.ops.kernels.bdg_overlap` shaped
    like one overlap group of the Pfaffian path: per site a random Nambu
    unitary V1 of half size ``x`` (default nb - 3, at least 1) in the
    complex-fermion basis, V2 = V1 rotated by a random SO(2x) Majorana
    rotation of scale ``angle`` (same vacuum parity, so the vacua overlap),
    both vacuum-padded to ``nb`` and cut to their annihilator halves;
    ``k1``/``k2`` index slots, the last two zero padding as the planner
    pads them, laid out as the planner's ``mode`` lays them out ("right":
    the first modes of the half, j2 reversed; "left": the last ones, j2
    reversed; None: random); the norm guard for min_SV = 1e-6.  Returns
    args as numpy."""
    from scipy.linalg import expm

    from .pfaffian import _pad_nambu_modes, vector_M2C

    rng = np.random.default_rng(seed)
    x = max(1, nb - 3) if x is None else x

    def nambu(O):
        a = (O[:, 0::2] + 1j * O[:, 1::2]) / 2**0.5
        V = vector_M2C(np.concatenate([a, a.conj()], axis=1))
        return _pad_nambu_modes(V, nb)[:, :nb]

    V1, V2, J1, J2 = [], [], [], []
    for _ in range(G):
        O1 = np.linalg.qr(rng.normal(size=(2 * x, 2 * x)))[0]
        A = rng.normal(size=(2 * x, 2 * x)) * angle / (2 * x) ** 0.5
        O2 = O1 @ expm(A - A.T)
        V1.append(nambu(O1))
        V2.append(nambu(O2))
        for J, k in ((J1, k1), (J2, k2)):
            j = np.zeros(k, np.int32)
            n_real = max(1, min(x, k - 2))
            if mode is None:
                j[:n_real] = rng.choice(x, size=n_real, replace=False)
            else:
                first = 0 if mode == "right" else x - n_real
                j[:n_real] = first + np.arange(n_real)
                if J is J2:
                    j[:n_real] = j[:n_real][::-1]
            J.append(j)
    thresh = np.full(G, max(1e-6**x, 1e-300))
    return np.stack(V1), np.stack(V2), np.stack(J1), np.stack(J2), thresh


def random_det_rows_case(seed: int, *, G: int, w: int, m: int, n: int, cross: bool = False,
                         nk: int | None = None, dtype=np.float64):
    """Seeded inputs of :func:`temfpy_torch.ops.kernels.det_rows`: ``G``
    matrices (m, m) with per-matrix scales, and index rows of width ``w``
    (each row holds w, w-1 or w-2 increasing orbitals, the rest sentinels
    ``m + s``; the last row of each table all sentinels).  Paired: ``n``
    row pairs with equal counts; ``cross``: ``n`` bra rows and ``nk`` (default
    n; paired rows ignore it) ket rows.  Returns (args, kwargs) as numpy."""
    rng = np.random.default_rng(seed)

    def rows(k, cnt):
        t = np.empty((k, w), np.int32)
        for r in range(k):
            t[r, : cnt[r]] = np.sort(rng.choice(m, size=cnt[r], replace=False))
            t[r, cnt[r]:] = m + np.arange(cnt[r], w)
        return t

    nk = n if nk is None or not cross else nk
    cnt_b = np.maximum(w - rng.integers(0, 3, n), 0)
    cnt_b[-1] = 0
    cnt_k = cnt_b.copy() if not cross else np.maximum(w - rng.integers(0, 3, nk), 0)
    cnt_k[-1] = 0
    M = rng.normal(size=(G, m, m), scale=m**-0.5).astype(dtype)
    scale = (1.0 + rng.random(G)).astype(dtype)
    if np.issubdtype(dtype, np.complexfloating):
        M = M + 1j * rng.normal(size=(G, m, m), scale=m**-0.5)
        scale = scale * np.exp(1j * rng.random(G))
    idx_b = np.stack([rows(n, cnt_b) for _ in range(G)])
    idx_k = np.stack([rows(nk, cnt_k) for _ in range(G)])
    return (M, idx_b, idx_k, scale), {"cross": cross}


def random_swap_case(seed: int, *, U: int, m: int, c: int, s_b: int, n_rows: int = 64,
                     P: int = 2000, spec: str = "rrc", dtype=np.float64, n_check: int = 32,
                     fail_probe: bool = False):
    """Seeded inputs of :func:`temfpy_torch.ops.kernels.swap_tables` and
    :func:`temfpy_torch.ops.kernels.swap_fill` shaped like one swap bucket
    of the rank-update fill, for ``U`` units: sometimes matrices (m, m), a
    base of ``c`` sorted positions per unit (sentinel-padded to the width
    bucket w_b, a multiple of 8), per-side swap tables of ``n_rows`` rows of
    width W = min(8, c) (each row swaps up to ``s_b`` base positions for
    positions outside the base and self-swaps the rest; the last row is the
    all-self-swap pad row) with their permutation signs, ``P`` random pairs
    padded to a power of two >= 1024 with pad pairs, injective scatter
    tables of layout ``spec`` and ``n_check`` strided checked pairs.

    ``fail_probe`` builds a class that passes the pre-screen and fails the
    probe: every ket row swaps out base position 0, half the bra rows swap
    in one outside position j, and M[j, base[0]] = 3e5, so the tables reach
    ~3e5 (under the 1e6 screen) while every pair's own submatrix stays
    O(1); the bordered matrices then cancel ~1e11-sized terms.

    Returns (M, r0, c0, swap_fill arguments after the tables, kwargs,
    (check_idx_b, check_idx_k)) as numpy: ``(M, det_always, Rin, Rout,
    Rpos, sgr, Cin, Cout, Cpos, sgc, pr, pc, tabs, check_sel)``, and the
    direct index rows (U, n_check, w_b) of the checked pairs (sorted
    positions, then sentinels), as the planner gives them to ``det_rows``."""
    from .ops.linalg import perm_parity_rows

    rng = np.random.default_rng(seed)
    w_b = -(-c // 8) * 8
    W = min(8, c)
    cplx = np.issubdtype(dtype, np.complexfloating)
    M = rng.normal(size=(U, m, m), scale=m**-0.5) + 1.5 * np.eye(m)
    if cplx:
        M = M + 1j * rng.normal(size=(U, m, m), scale=m**-0.5)
    M = M.astype(dtype)
    det_always = (1.0 + rng.random(U)).astype(dtype)
    bases = [np.sort(rng.choice(m, size=c, replace=False)) for _ in range(U)]
    sent = m + np.arange(w_b - c)
    r0 = np.stack([np.concatenate([b, sent]) for b in bases]).astype(np.int32)

    def side(base, lose0=False, gain=None):
        n = n_rows
        rin = np.empty((n, W), np.int32)
        rout = np.empty((n, W), np.int32)
        rpos = np.empty((n, W), np.int32)
        outside = np.setdiff1d(np.arange(m), base)
        for t in range(n):
            a = 0 if t == n - 1 else int(rng.integers(0, min(s_b, len(outside)) + 1))
            pos = np.sort(rng.choice(c, size=W, replace=False)) if t < n - 1 else np.arange(W)
            new = rng.choice(outside, size=a, replace=False)
            if t < n - 1 and lose0:  # base position 0 always swapped out
                a = max(a, 1)
                pos = np.concatenate([[0], np.sort(rng.choice(np.arange(1, c), W - 1, False))])
                new = rng.choice(outside[outside != gain] if gain is not None else outside,
                                 size=a, replace=False)
            if t < n - 1 and gain is not None and t % 2 == 0:  # swap in position `gain`
                a = max(a, 1)
                new = np.concatenate([[gain], rng.choice(outside[outside != gain], a - 1, False)])
            rpos[t] = pos
            rout[t] = base[pos]
            rin[t] = rout[t]
            rin[t, :a] = new
        return rin, rout, rpos, perm_parity_rows(base.astype(np.int64), rpos, rin)

    tabsides = []
    for u, b in enumerate(bases):
        if fail_probe:
            j = int(np.setdiff1d(np.arange(m), b)[0])
            M[u, j, b[0]] = 3e5
            tabsides.append((side(b, gain=j), side(b, lose0=True, gain=j)))
        else:
            tabsides.append((side(b), side(b)))
    stk = lambda k, j: np.stack([ts[k][j] for ts in tabsides])  # noqa: E731
    Rin, Rout, Rpos, sgr = (stk(0, j) for j in range(4))
    Cin, Cout, Cpos, sgc = (stk(1, j) for j in range(4))
    R = K = n_rows
    P_b = 1024
    while P_b < P:
        P_b *= 4
    pr = np.full((U, P_b), R - 1, np.int32)
    pc = np.full((U, P_b), K - 1, np.int32)
    for u in range(U):
        flat = rng.choice((R - 1) * (K - 1), size=P, replace=False)
        pr[u, :P], pc[u, :P] = flat // (K - 1), flat % (K - 1)
    col = np.arange(K, dtype=np.int32)
    if spec == "rrc":
        a_ = np.arange(R, dtype=np.int32) // 2
        a_[-1] = R // 2
        tabs, shape = (a_, np.arange(R, dtype=np.int32) % 2, col), (R // 2, 2, K)
    elif spec == "crr":
        col[-1] = K - 1
        tabs, shape = (col, np.arange(R, dtype=np.int32) % 2,
                       np.arange(R, dtype=np.int32) // 2), (K - 1, 2, R // 2)
    elif spec == "rc":
        tabs, shape = (np.arange(R, dtype=np.int32), col, np.zeros(1, np.int32)), (R - 1, K)
    else:
        raise ValueError(spec)
    stack = lambda a: np.stack([a] * U)  # noqa: E731
    check_sel = stack(np.linspace(0, P - 1, n_check).astype(np.int32))

    def direct_rows(Tin, Tpos, ids):
        out = np.empty((U, n_check, w_b), np.int32)
        for u in range(U):
            for q, t in enumerate(ids[u]):
                arr = bases[u].copy()
                arr[Tpos[u, t, :s_b]] = Tin[u, t, :s_b]
                out[u, q] = np.concatenate([np.sort(arr), sent])
        return out

    chk_b = direct_rows(Rin, Rpos, np.take_along_axis(pr, check_sel, 1))
    chk_k = direct_rows(Cin, Cpos, np.take_along_axis(pc, check_sel, 1))
    args = (M, det_always, Rin, Rout, Rpos, sgr, Cin, Cout, Cpos, sgc, pr, pc,
            tuple(stack(t) for t in tabs), check_sel)
    return M, r0, r0.copy(), args, {"s_b": s_b, "spec": spec, "shape": shape}, (chk_b, chk_k)


def random_pf_gather_case(seed: int, *, m: int, nb: int, nk: int, kb: int, kk: int,
                          dtype=np.complex128):
    """Seeded inputs of :func:`temfpy_torch.ops.kernels.pf_gather`: an
    antisymmetric N (m, m), ket rows of ``kk`` positions in [0, m/2) and bra
    rows of ``kb`` positions in [m/2, m), the last bra rows padded at the
    tail with J-block sentinels ``m, m+1, ...`` (an even run).  Returns
    (N, bra_idx, ket_idx, pad_slots) as numpy."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, m))
    if np.issubdtype(dtype, np.complexfloating):
        A = A + 1j * rng.normal(size=(m, m))
    N = ((A - A.T) * (0.5 / m**0.5)).astype(dtype)
    ket = np.stack([np.sort(rng.choice(m // 2, size=kk, replace=False))
                    for _ in range(nk)]).astype(np.int32)
    bra = np.stack([np.sort(rng.choice(np.arange(m // 2, m), size=kb, replace=False))
                    for _ in range(nb)]).astype(np.int32)
    pad = 0
    for i in range(nb):
        t = 2 * (i % 3) if kb >= 4 else 0  # 0, 2 or 4 tail sentinels
        t = min(t, kb - kb % 2)
        if t:
            bra[i, kb - t:] = m + np.arange(t)
            pad = max(pad, t)
    return N, bra, ket, pad


def random_rsf_cases(seed: int, *, L: int, m: int, r: int, rf: int, kb: int,
                     side: str = "L"):
    """Seeded inputs of every mode of the randomized frontend's kernels
    (``ops.kernels.rsf_apply``, ``rsf_tsprod``, ``rsf_ritz_select``,
    ``rsf_frames``), as a list of (kernel name, mode, args, kwargs) with
    numpy arrays (index arrays int32).

    C is the projector onto L/2 random orthonormal orbitals; the m block
    sizes run from a tiny block (1) to L/2, and the first cut's is empty;
    operands are block- (or complement-) supported as in the sweep.  The
    cases include a lane ``_corth`` drops (a Gram eigenvalue below the
    floor and a zero column before the shift), a filled sketch with its n_f
    column mask and identity pad, a band whose window keeps no Ritz column,
    ties and sentinels in the ranks, a cut with more valid lanes than kb,
    one with none, and one whose Cholesky failed."""
    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.standard_normal((L, L // 2)))[0]
    C = Q @ Q.T
    sizes = np.linspace(1, L // 2, m).round().astype(np.int32)
    sizes[0] = 0
    rows = np.arange(L)[None, :]
    blk = (rows < sizes[:, None]) if side == "L" else (rows >= L - sizes[:, None])
    blk = blk.astype(float)[:, :, None]

    def on(mask, n):
        return mask * rng.standard_normal((m, L, n))

    kw = {"side": side}
    nf = rng.integers(0, rf, size=m).astype(np.int32)
    nf[-1] = rf
    Y = on(blk, r)
    Y[:, :, 1] = Y[:, :, 0]  # rank-deficient: one Gram eigenvalue ~ 0
    G = np.swapaxes(Y, 1, 2) @ Y
    e, Qg = np.linalg.eigh(G)
    U = on(blk, r) / np.sqrt(np.maximum(sizes, 1))[:, None, None]
    U[:, :, 3] = 0.0  # a lane _corth dropped
    CU = blk * (C @ U)
    lam = rng.choice([0.3, 2e-3, 0.99, 1e-9, 4e-13, 1e6], size=(m, r))
    n = 4 * r
    lam_all = rng.choice([0.2, 0.2, 1e-9, 0.7, 0.9999, 3.0], size=(m, n))
    lam_all[0] = 3.0
    lam_all[1, : kb + 4] = 0.4
    tr = rng.uniform(0, L // 2, size=m)
    k = (lam_all < 2.0).sum(1).astype(np.int32)
    order = np.argsort(np.where(lam_all < 2.0, lam_all, 3.0), axis=1, kind="stable").astype(
        np.int32)
    tr_res = np.abs(rng.standard_normal(m)) * 1e-12
    info = np.zeros(m, np.int32)
    info[2] = 3  # a CholeskyQR2 that failed: the cut's trace residual reads inf
    Yf = on(blk, rf) * (np.arange(rf)[None, :] < nf[:, None])[:, None, :]
    cases = [
        ("rsf_apply", "capp", (C, on(blk, r), sizes), kw),
        ("rsf_apply", "mtapp", (C, on(blk, r), sizes), kw),
        ("rsf_apply", "mapp", (C, on(1 - blk, r), sizes), kw),
        ("rsf_apply", "mapp", (C, rng.standard_normal((L, r)), sizes), kw),
        ("rsf_apply", "capp", (C, rng.standard_normal((L, rf)), sizes), {**kw, "ncol": nf}),
        ("rsf_tsprod", "gram", (Y, Y, sizes), kw),
        ("rsf_tsprod", "gram", (U, on(blk, rf), sizes), kw),
        ("rsf_tsprod", "gram", (Yf, Yf, sizes), {**kw, "ncol": nf}),
        ("rsf_tsprod", "sub", (U, rng.standard_normal((m, r, rf)), sizes),
         {**kw, "Z": on(blk, rf)}),
        ("rsf_tsprod", "mul", (U, rng.standard_normal((m, r, r)), sizes), kw),
        ("rsf_tsprod", "scale", (Y, Qg, sizes), {**kw, "e": e, "floor": 1e-2}),
        ("rsf_ritz_select", "shift", (U, rng.standard_normal((m, r, r)), sizes), kw),
    ]
    for lo, hi in ((1e-2, np.inf), (1e-4, 1e-2), (1e-6, 1e-4), (3e-8, 1e-6)):
        cases.append(("rsf_ritz_select", "select", (U, CU, sizes),
                      {**kw, "lam": lam, "lo": lo, "hi": hi, "res_tol": 1e-6}))
    cases += [
        ("rsf_frames", "stats", (lam_all, tr), {}),
        ("rsf_frames", "place", (lam_all, k, nf, tr_res, order, on(blk, n), Yf, info),
         {"kb": kb}),
    ]
    return cases
