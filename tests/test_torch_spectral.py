"""temfpy_torch.ops.spectral (the randomized frontend) against
temfpy_tpu.ops.spectral on the same numpy inputs, both on the CPU (the port
runs the plain twins of its K11a-d kernels there).  Both packages draw the
same random sketches (``np.random.default_rng(seed)`` in one order).

Tolerances:
- the masked products, Grams and combinations are the same float64 sums in
  another order: 1e-13 on O(1) entries;
- anything after an eigh (the Gram and Ritz eighs, LAPACK in both packages)
  is compared by invariants, since degenerate eigenvalues leave the
  eigenvectors' gauge free: projectors onto the kept columns, counts of
  kept and dropped lanes, eigenvalues;
- per cut: the same reroute list and the same entangled and filled counts
  k and n_f; the entangled sqrt(lambda) to the JAX package's own contract,
  5e-7 (tests/test_spectral.py:60-65; the JAX values come down as float32),
  and frames block-supported (exact zeros), orthonormal to 1e-10 and
  C-invariant to 1e-6, as that test asks;
- whole conversions: the port's RSF state against the JAX package's RSF
  state, and against the port's exact frontend: the filled columns are a
  basis of the lambda ~ 1 space, so per-site tensors differ by a bond gauge
  and only states, spectra and charges compare; squared Schmidt values to
  1e-10 against the port's exact frontend (the frontends' eigenvalues agree
  to ~1e-12, Schmidt values are products of up to ~10 of them) and to 1e-7
  against the JAX package (whose eigenvalues come down as float32), 1 -
  fidelity to 1e-10.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import temfpy_torch.testing as ttst
from temfpy_torch import slater
from temfpy_torch.mps.io import mps_from_arrays
from temfpy_torch.ops import kernels, spectral
from temfpy_tpu import slater as jslater
from temfpy_tpu.ops import spectral as jspec
from temfpy_tpu.ops.linalg import _split_f32
from test_spectral import CUTOFF, cylinder_C


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU twins run many small tensor operations; one intra-op
    thread keeps them from spinning the pool's idle threads, which under a
    parallel test run costs far more than it gains."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.delenv("TEMFPY_TORCH_RSF", raising=False)
    for name in ("RSF", "RSF_RANK", "RSF_KB", "RSF_CHUNK", "RSF_MIN_L"):
        monkeypatch.delenv(f"TEMFPY_TPU_{name}", raising=False)
    old = ttst.TEST_ACTION
    ttst.TEST_ACTION = "raise"
    yield
    ttst.TEST_ACTION = old


def _sweeps(C, sizes, side, monkeypatch):
    """Both packages' rsf_sweep_frames on the numpy C, with the per-cut rows
    [.. | k | n_f | tr_res] of their chunks (JAX: its float32 buffer)."""
    rows = {"jax": [], "torch": []}
    jimpl, pimpl = jspec._rsf_chunk_impl, spectral.rsf_chunk

    def jrec(*a, **kw):
        out = jimpl(*a, **kw)
        rows["jax"].append(np.asarray(out[1], np.float64))
        return out

    def prec(*a, **kw):
        out = pimpl(*a, **kw)
        rows["torch"].append(out[1].numpy())
        return out

    monkeypatch.setattr(jspec, "_rsf_chunk_impl", jrec)
    monkeypatch.setattr(spectral, "rsf_chunk", prec)
    ref = jspec.rsf_sweep_frames(C, sizes, side, CUTOFF)
    got = spectral.rsf_sweep_frames(torch.as_tensor(C), sizes, side, CUTOFF)
    kb = spectral.RSF_KB
    # every chunk holds m rows, cut i is row i of the concatenation
    counts = {k: np.concatenate(v)[: len(sizes), 2 * kb : 2 * kb + 2] for k, v in rows.items()}
    return got, ref, counts


def _check_frames(C, sizes, side, got, cuts_ok):
    """Block support, orthonormality and C-invariance of the port's frames
    (tests/test_spectral.py:66-79), and sqrt(lambda) against LAPACK."""
    e_list, col0_list, frames, fb = got
    L = C.shape[0]
    for i in cuts_ok:
        s = sizes[i]
        rows = slice(None, s) if side == "L" else slice(L - s, None)
        blk = C[rows, rows]
        ee = np.linalg.eigh(blk)[0]
        e = e_list[i]
        assert e.shape == ee.shape
        sel, sel_m = (ee > CUTOFF) & (ee < 1 - CUTOFF), (e > CUTOFF) & (e < 1 - CUTOFF)
        if sel.sum() == sel_m.sum():
            np.testing.assert_allclose(np.sqrt(np.sort(e[sel_m])), np.sqrt(np.sort(ee[sel])),
                                       rtol=0, atol=5e-7)
        F = frames[i].numpy()
        occ = F[:, : s - col0_list[i]]
        out_rows = np.delete(np.arange(L), np.arange(L)[rows])
        assert not occ[out_rows].any()
        Fb = occ[rows]
        np.testing.assert_allclose(Fb.T @ Fb, np.eye(Fb.shape[1]), rtol=0, atol=1e-10)
        assert np.abs(blk @ Fb - Fb * e[col0_list[i]:][None, :]).max() < 1e-6


@pytest.mark.parametrize("side", ["L", "R"])
def test_sweep_frames_match_jax(side, monkeypatch):
    """tests/test_spectral.py:37-79 on both packages: the same reroutes, k
    and n_f per cut, the entangled sqrt(lambda) to 5e-7, and the port's
    frames checked as the JAX test checks the JAX package's."""
    L = 64
    C = cylinder_C(L, W=4)
    cuts = list(range(8, L - 7, 5))
    sizes = [x if side == "L" else L - x for x in cuts]
    got, ref, counts = _sweeps(C, sizes, side, monkeypatch)
    assert got[3] == ref[3]
    np.testing.assert_array_equal(counts["torch"], counts["jax"])
    ok = [i for i in range(len(cuts)) if i not in got[3]]
    assert ok, "every cut was rerouted"
    for i in ok:
        assert got[1][i] == ref[1][i]
        e, e0 = got[0][i], ref[0][i]
        sel = (e0 > CUTOFF) & (e0 < 1 - CUTOFF)
        np.testing.assert_array_equal((e > CUTOFF) & (e < 1 - CUTOFF), sel)
        np.testing.assert_allclose(np.sqrt(e[sel]), np.sqrt(e0[sel]), rtol=0, atol=5e-7)
    _check_frames(C, sizes, side, got, ok)


def test_degenerate_cutoff_straddling_matches_jax(monkeypatch):
    """tests/test_spectral.py:126-157: exact cylinder degeneracies and
    eigenvalues straddling the cutoff; both packages reroute the same cuts
    and keep the same counts, and the port's frames pass the checks."""
    L = 64
    C = cylinder_C(L, W=4, dimer=0.0, tilt=False)
    cuts = list(range(6, L - 5, 3))
    got, ref, counts = _sweeps(C, cuts, "L", monkeypatch)
    assert got[3] == ref[3] and len(got[3]) < len(cuts)
    np.testing.assert_array_equal(counts["torch"], counts["jax"])
    ok = [i for i in range(len(cuts)) if i not in got[3]]
    for i in ok:
        sel = (ref[0][i] > CUTOFF) & (ref[0][i] < 1 - CUTOFF)
        np.testing.assert_allclose(np.sqrt(got[0][i][sel]), np.sqrt(ref[0][i][sel]), rtol=0,
                                   atol=5e-7)
    _check_frames(C, cuts, "L", got, ok)


# --------------------------------------------------------------------------
# the kernels' twins against the JAX chunk body's pieces
# --------------------------------------------------------------------------

SIZES = [0, 2, 11, 24, 30]  # an empty and a tiny block, s = L / 2
L_PIECE = 48


def _masks(side, L=L_PIECE, sizes=SIZES):
    """The block-row masks of temfpy_tpu/ops/spectral.py:360-367."""
    pad, iota = np.asarray(sizes), np.arange(L)
    if side == "L":
        return (iota[None, :] < pad[:, None]).astype(float)
    return (iota[None, :] >= (L - pad)[:, None]).astype(float)


def _block_supported(rng, side, n, L=L_PIECE):
    return _masks(side)[:, :, None] * rng.standard_normal((len(SIZES), L, n))


def _sizes():
    return torch.tensor(SIZES, dtype=torch.int32)


@pytest.mark.parametrize("side", ["L", "R"])
@pytest.mark.parametrize("mode", ["capp", "mtapp", "mapp"])
def test_apply_twin_matches_jax(side, mode):
    """K11a's twin against the capp/mtapp/mapp closures (:182-195), on one
    shared sketch and on per-cut blocks, and the filled sketch with its
    n_f column mask (:248-250)."""
    rng = np.random.default_rng(1)
    C = cylinder_C(L_PIECE)
    rm = _masks(side)
    m_in, m_out = {"capp": (rm, rm), "mtapp": (rm, 1 - rm), "mapp": (1 - rm, rm)}[mode]
    X = rng.standard_normal((len(SIZES), L_PIECE, 7))
    G = rng.standard_normal((L_PIECE, 5))
    for x, xs in ((X, X), (G, np.broadcast_to(G, (len(SIZES),) + G.shape))):
        ref = m_out[:, :, None] * jnp.einsum("ab,ibr->iar", C, m_in[:, :, None] * xs)
        got = kernels.rsf_apply_plain(mode, torch.as_tensor(C), torch.as_tensor(x), _sizes(),
                                      side=side)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-13)
    nf = np.array([0, 1, 5, 3, 2])
    nf_mask = (np.arange(5)[None, :] < nf[:, None]).astype(float)
    ref = m_out[:, :, None] * jnp.einsum("ab,ibr->iar", C, m_in[:, :, None] * G * nf_mask[:, None])
    got = kernels.rsf_apply_plain(mode, torch.as_tensor(C), torch.as_tensor(G), _sizes(),
                                  side=side, ncol=torch.as_tensor(nf, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-13)


@pytest.mark.parametrize("side", ["L", "R"])
def test_tsprod_twin_matches_jax(side):
    """K11b's twin: the Gram, the deflation (:199-203), V = U Wv, the
    CholeskyQR2 Gram with its identity pad (:252-254), and _corth (:136-141)
    through gram + eigh + the scale mode, held against the JAX function as
    projectors with a dropped lane (a repeated column) an exact zero."""
    rng = np.random.default_rng(2)
    t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    sizes = _sizes()
    A, Z = _block_supported(rng, side, 6), _block_supported(rng, side, 9)
    np.testing.assert_allclose(
        kernels.rsf_tsprod_plain("gram", t(A), t(Z), sizes, side=side).numpy(),
        np.asarray(jnp.einsum("ilk,ilr->ikr", A, Z)), rtol=0, atol=1e-13)
    S = np.asarray(jnp.einsum("ilk,ilr->ikr", A, Z))
    np.testing.assert_allclose(
        kernels.rsf_tsprod_plain("sub", t(A), t(S), sizes, side=side, Z=t(Z)).numpy(),
        np.asarray(Z - jnp.einsum("ilk,ikr->ilr", A, S)), rtol=0, atol=1e-13)
    W = rng.standard_normal((len(SIZES), 6, 4))
    np.testing.assert_allclose(
        kernels.rsf_tsprod_plain("mul", t(A), t(W), sizes, side=side).numpy(),
        np.asarray(jnp.einsum("ilr,irs->ils", A, W)), rtol=0, atol=1e-13)
    nf = np.array([0, 1, 4, 6, 2])
    nf_mask = (np.arange(6)[None, :] < nf[:, None]).astype(float)
    Yf = A * nf_mask[:, None]
    ref = jnp.einsum("ilr,ils->irs", Yf, Yf) + jnp.einsum("ir,rs->irs", 1.0 - nf_mask,
                                                          jnp.eye(6))
    got = kernels.rsf_tsprod_plain("gram", t(Yf), t(Yf), sizes, side=side,
                                   ncol=torch.as_tensor(nf, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-13)

    Y = A.copy()
    Y[:, :, 5] = Y[:, :, 1]  # a rank-deficient block: one Gram eigenvalue ~0
    for floor in (1e-2, 0.5):
        ref = np.asarray(jspec._corth(jnp.asarray(Y), floor))
        e, Q = torch.linalg.eigh(kernels.rsf_tsprod_plain("gram", t(Y), t(Y), sizes, side=side))
        got = kernels.rsf_tsprod_plain("scale", t(Y), Q, sizes, side=side, e=e,
                                       floor=floor).numpy()
        for i in range(len(SIZES)):
            zero_g, zero_r = ~got[i].any(0), ~ref[i].any(0)
            assert zero_g.sum() == zero_r.sum() >= 1
            np.testing.assert_allclose(got[i] @ got[i].T, ref[i] @ ref[i].T, rtol=0,
                                       atol=1e-10)


@pytest.mark.parametrize("side", ["L", "R"])
def test_ritz_twin_matches_jax(side):
    """K11c's twin: the column-valid pass and _BIG shift (:214-221), and the
    residual filter (:224-234) on every band, one of which keeps no column."""
    rng = np.random.default_rng(3)
    t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    sizes = _sizes()
    U = _block_supported(rng, side, 6)
    U /= np.maximum(np.linalg.norm(U, axis=1, keepdims=True), 1e-300)
    U[:, :, 2] = 0.0  # a lane _corth dropped
    T = rng.standard_normal((len(SIZES), 6, 6))
    valid = np.asarray(jspec._col_valid(jnp.asarray(U)))
    ref = T + np.einsum("ir,rs->irs", (1.0 - valid) * jspec._BIG, np.eye(6))
    got = kernels.rsf_ritz_select_plain("shift", t(U), t(T), sizes, side=side)
    np.testing.assert_array_equal(got.numpy(), ref)

    C = cylinder_C(L_PIECE)
    rm = _masks(side)
    V = U
    CV = rm[:, :, None] * np.einsum("ab,ibr->iar", C, V)
    # Ritz values across every band window, exact eigenvalues of some columns
    lam = rng.choice([1e-3, 0.3, 0.999, 1e-9, 2e-11, 0.5, 1e6], size=(len(SIZES), 6))
    V[:, :, 0] = 0.0
    lam[:, 0] = 0.25  # a zero column: residual 0, kept where the band takes 0.25
    los = list(jspec.BAND_EDGES) + [jspec.SIGMA_FLOOR]
    his = [np.inf] + list(jspec.BAND_EDGES)
    kept = []
    for lo, hi in zip(los, his):
        D = CV - lam[:, None, :] * V
        res = np.sqrt(np.einsum("ilr,ilr->ir", D, D))
        sig2 = lam * (1.0 - lam)
        keep = (sig2 >= lo * lo) & (res < jspec.RES_TOL) & (lam < 2.0)
        if np.isfinite(hi):
            keep &= sig2 < (4.0 * hi) ** 2
        Vk, lk = kernels.rsf_ritz_select_plain("select", t(V), t(CV), sizes, side=side,
                                               lam=t(lam), lo=lo, hi=hi,
                                               res_tol=jspec.RES_TOL)
        np.testing.assert_array_equal(lk.numpy(), np.where(keep, lam, jspec.LAM_SENTINEL))
        np.testing.assert_array_equal(Vk.numpy(), V * keep[:, None, :])
        kept.append(int(keep.sum()))
    assert 0 in kept and max(kept) > 0, kept


@pytest.mark.parametrize("side", ["L", "R"])
def test_ritz_wrapper_updates_in_place(side):
    """The K11c wrapper works in place on a CPU tensor too, with the twin's
    values: "shift" returns T itself, shifted; "select" returns V itself
    with the dropped columns zero, and the twin's lam_out.  Rows outside a
    cut's block stay zero (block sizes 0, 1 and L/2 among them)."""
    rng = np.random.default_rng(5)
    sizes = torch.as_tensor(np.array([0, 1, L_PIECE // 2, 3], np.int32))
    m, r = len(sizes), 6
    blk = kernels.rsf_block_mask(sizes, side, L_PIECE)[:, :, None]
    U = blk * torch.as_tensor(rng.standard_normal((m, L_PIECE, r)))
    T = torch.as_tensor(rng.standard_normal((m, r, r)))
    want = kernels.rsf_ritz_select_plain("shift", U, T, sizes, side=side)
    got = kernels.rsf_ritz_select("shift", U, T, sizes, side=side)
    assert got is T and torch.equal(T, want)
    CV = blk * torch.as_tensor(rng.standard_normal((m, L_PIECE, r))) * 1e-8
    lam = torch.as_tensor(rng.choice([0.3, 1e-9, 0.5], size=(m, r)))
    kw = {"side": side, "lam": lam, "lo": 1e-2, "hi": np.inf, "res_tol": 1.0}
    V = U.clone()
    Vk, lk = kernels.rsf_ritz_select_plain("select", V, CV, sizes, **kw)
    got, lam_out = kernels.rsf_ritz_select("select", V, CV, sizes, **kw)
    assert got is V and torch.equal(V, Vk) and torch.equal(lam_out, lk)
    dropped = lam_out == spectral.LAM_SENTINEL
    assert bool(dropped.any()) and bool((~dropped).any())
    assert float((V * (1 - blk)).abs().max()) == 0.0


@pytest.mark.parametrize("case", ["mode", "side", "sizes", "T", "CV", "lam"])
def test_ritz_wrapper_rejects_bad_arguments(case):
    """The K11c wrapper's checks, before any device dispatch: the mode, the
    side, sizes (m,), T (m, r, r) for "shift", and C V (m, L, r) with lam
    (m, r) for "select"."""
    m, L, r = 3, 8, 4
    X = torch.zeros(m, L, r, dtype=torch.float64)
    sizes = torch.zeros(m, dtype=torch.int32)
    mode, Y, kw = "select", X.clone(), {"side": "L", "lam": torch.zeros(m, r), "lo": 1e-2,
                                        "hi": np.inf, "res_tol": 1e-6}
    if case == "mode":
        mode = "filter"
    elif case == "side":
        kw["side"] = "C"
    elif case == "sizes":
        sizes = torch.zeros(m + 1, dtype=torch.int32)
    elif case == "T":
        mode, Y = "shift", torch.zeros(m, r, r + 1, dtype=torch.float64)
    elif case == "CV":
        Y = torch.zeros(m, L + 1, r, dtype=torch.float64)
    else:
        kw["lam"] = None
    with pytest.raises(ValueError):
        kernels.rsf_ritz_select(mode, X, Y, sizes, **kw)


def test_frames_twin_matches_jax():
    """K11d's twin: the counts and trace check (:236-242), the stable
    ascending ranks with sentinel ties, the placement (:262-283, through the
    JAX package's float32-split one-hot products) and the per-cut rows."""
    rng = np.random.default_rng(4)
    m, L, n, kb, rf = 5, 16, 12, 8, 6
    lam = rng.choice([0.2, 0.2, 1e-9, 0.7, 0.9999, jspec.LAM_SENTINEL], size=(m, n))
    lam[1] = jspec.LAM_SENTINEL  # a cut that keeps no lane
    lam[2, :10] = 0.4  # more valid lanes than kb: the extra ranks go nowhere
    tr = rng.uniform(0, 6, size=m)
    tr[3] = 2.5  # half-integer residual: rounds to even
    U_all = rng.standard_normal((m, L, n)) * (lam < 2.0)[:, None, :]
    Yf = rng.standard_normal((m, L, rf))

    valid = lam < 2.0
    k_ref = valid.sum(1)
    lam_sum = np.where(valid, lam, 0.0).sum(1)
    nf_f = np.asarray(jnp.round(tr - lam_sum))
    nf_ref = np.maximum(nf_f, 0).astype(int)
    key = np.where(valid, lam, jspec.LAM_SENTINEL)
    order = np.asarray(jnp.argsort(key, axis=1))
    k, nf, tr_res, order_t = kernels.rsf_frames_plain("stats", torch.as_tensor(lam),
                                                      torch.as_tensor(tr))
    np.testing.assert_array_equal(k.numpy(), k_ref)
    np.testing.assert_array_equal(nf.numpy(), nf_ref)
    np.testing.assert_allclose(tr_res.numpy(), np.abs(tr - lam_sum - nf_f), rtol=0, atol=1e-15)
    np.testing.assert_array_equal(order_t.numpy(), order)

    Wb = kb + rf
    rank = np.argsort(order, axis=1)
    tpos = np.where(valid & (rank < kb), rank, Wb)
    nf_mask = np.arange(rf)[None, :] < nf_ref[:, None]
    fpos = np.where(nf_mask, k_ref[:, None] + np.arange(rf)[None, :], Wb)

    def place(Vs, pos):  # temfpy_tpu/ops/spectral.py:270-281
        E = jnp.asarray(np.eye(Wb + 1, dtype=np.float32)[pos][..., :Wb])
        return sum(np.asarray(jnp.einsum("ilk,iks->ils", h, E, precision="highest"), np.float64)
                   for h in _split_f32(jnp.asarray(Vs)))

    slab_ref = place(U_all, tpos) + place(Yf * nf_mask[:, None, :], fpos)
    info = torch.zeros(m, dtype=torch.int32)
    info[4] = 2  # a failed CholeskyQR2 marks the cut with an infinite residual
    slab, packed = kernels.rsf_frames_plain("place", torch.as_tensor(lam), k, nf, tr_res,
                                            order_t, torch.as_tensor(U_all),
                                            torch.as_tensor(Yf), info, kb=kb)
    np.testing.assert_allclose(slab.numpy(), slab_ref, rtol=0, atol=1e-15)
    lam_sorted = np.take_along_axis(key, order, axis=1)[:, :kb]
    one_m = np.take_along_axis(np.where(valid, 1.0 - lam, jspec.LAM_SENTINEL), order, 1)[:, :kb]
    tr_res_ref = np.where(info.numpy() != 0, np.inf, tr_res.numpy())
    np.testing.assert_array_equal(packed.numpy(), np.concatenate(
        [lam_sorted, one_m, k_ref[:, None], nf_ref[:, None], tr_res_ref[:, None]], 1))


@pytest.mark.parametrize("side", ["L", "R"])
def test_chunk_plain_matches_jax_chunk(side):
    """One whole chunk, rsf_chunk_plain against _rsf_chunk_impl on the same
    inputs: k and n_f exactly, lambda to the JAX buffer's float32 rounding,
    and per cut the projector onto the occupied frame columns."""
    L, kb, r = L_PIECE, 24, 16
    C = cylinder_C(L)
    rng = np.random.default_rng(1234)
    rf = spectral.rsf_fill_width(int(round(np.trace(C))), L)
    G_ent = rng.standard_normal((jspec.N_BANDS, L, r))
    G_fill = rng.standard_normal((L, rf))
    sizes = np.asarray([1, 5, 13, 20, 24])
    prefix = np.concatenate(([0.0], np.cumsum(np.diag(C))))
    tr = prefix[sizes] if side == "L" else prefix[-1] - prefix[L - sizes]
    slab_j, pk_j = jspec._rsf_chunk_impl(
        jnp.asarray(C), jnp.asarray(_masks(side, L, sizes)), jnp.asarray(tr), jnp.asarray(G_ent),
        jnp.asarray(G_fill), kb=kb, k_keep=kb, rf=rf, q=jspec.POWER_STEPS,
        res_tol=jspec.RES_TOL)
    slab, pk = spectral.rsf_chunk_plain(
        torch.as_tensor(C), torch.as_tensor(sizes, dtype=torch.int32), side, torch.as_tensor(tr),
        torch.as_tensor(G_ent), torch.as_tensor(G_fill), kb=kb)
    pk_j, slab_j = np.asarray(pk_j, np.float64), np.asarray(slab_j)
    pk, slab = pk.numpy(), slab.numpy()
    np.testing.assert_array_equal(pk[:, 2 * kb : 2 * kb + 2], pk_j[:, 2 * kb : 2 * kb + 2])
    for i in range(len(sizes)):
        k, n_f = int(pk[i, 2 * kb]), int(pk[i, 2 * kb + 1])
        np.testing.assert_allclose(pk[i, :k], pk_j[i, :k], rtol=1e-7, atol=1e-15)
        F, Fj = slab[i][:, : k + n_f], slab_j[i][:, : k + n_f]
        np.testing.assert_allclose(F @ F.T, Fj @ Fj.T, rtol=0, atol=1e-10)


# --------------------------------------------------------------------------
# whole conversions
# --------------------------------------------------------------------------


def _ladder48():
    """tests/test_spectral.py:88-108: an L=48 W=4 cylinder with a 1e-4
    potential ramp (no exact degeneracies), chi=96."""
    L, W = 48, 4
    H = np.zeros((L, L))
    for x in range(L // W):
        for y in range(W):
            i = x * W + y
            if x + 1 < L // W:
                H[i, i + W] = H[i + W, i] = -1.0 if x % 2 == 0 else -1.3
            j = x * W + (y + 1) % W
            H[i, j] = H[j, i] = -1.0
    return H - 0.05 * np.eye(L) - 1e-4 * np.diag(np.arange(L)), {"chi_max": 96}


def test_conversion_matches_jax_and_exact_frontend(monkeypatch):
    """C_to_MPS with the randomized frontend in both packages on one numpy
    C, and the port's randomized state against its exact frontend's and
    against a run whose narrow frame bucket reroutes some cuts: charges
    equal, squared Schmidt values and 1 - fidelity as the module says."""
    H, tp = _ladder48()
    L = H.shape[0]
    C = slater.correlation_matrix(H, device="cpu")[0].numpy()
    monkeypatch.setenv("TEMFPY_TPU_RSF", "1")
    monkeypatch.setenv("TEMFPY_TPU_DET_UPDATES", "0")
    ref = jslater.C_to_MPS(C, tp)
    monkeypatch.setenv("TEMFPY_TORCH_RSF", "1")
    got = slater.C_to_MPS(C, tp, device="cpu")
    assert spectral.rsf_stats() == {"cuts": L, "rerouted": 0}
    # a frame bucket below the cuts' entangled counts sends them back to
    # the exact frontend (the self-check's k > kb)
    monkeypatch.setattr(spectral, "RSF_KB", 12)
    narrow = slater.C_to_MPS(C, tp, device="cpu")
    stats = spectral.rsf_stats()
    assert 0 < stats["rerouted"] < stats["cuts"] == L, stats
    monkeypatch.setenv("TEMFPY_TORCH_RSF", "0")
    exact = slater.C_to_MPS(C, tp, device="cpu")
    assert spectral.rsf_stats()["cuts"] == 0
    ref_t = mps_from_arrays([np.array(B) for B in ref._B], ref._S, ref.q_bond, ref.qtotal,
                            ref.form, device="cpu")
    # the JAX package's eigenvalues come down as float32 (relative 6e-8 a
    # mode weight), so its squared Schmidt values hold to 1e-7 only
    for other, tol in ((ref_t, 1e-7), (exact, 1e-10), (narrow, 1e-10)):
        for b in range(L + 1):
            np.testing.assert_array_equal(np.sort(got.q_bond[b]), np.sort(other.q_bond[b]))
            np.testing.assert_allclose(np.sort(got.get_SL(b)) ** 2,
                                       np.sort(other.get_SL(b)) ** 2, rtol=0, atol=tol)
        fid = abs(got.overlap(other)) / np.sqrt(got.norm_squared() * other.norm_squared())
        assert 1 - fid <= 1e-10, 1 - fid


def test_rsf_modes(monkeypatch):
    """"0" (the default) off; "1" on for a real C, the CPU included, never
    for a complex one; any other value (the JAX package's "auto") off; the
    rank, bucket and chunk size are the JAX defaults."""
    C = torch.zeros((600, 600), dtype=torch.float64)
    assert spectral.rsf_mode() == "0" and not spectral.use_rsf(C)
    assert (spectral.RSF_RANK, spectral.RSF_KB, spectral.RSF_CHUNK) == (
        jspec.rsf_rank(), jspec.rsf_kb(), jspec.rsf_chunk()) == (64, 96, 32)
    monkeypatch.setenv("TEMFPY_TORCH_RSF", "1")
    assert spectral.use_rsf(C) and spectral.use_rsf(C.numpy()[:8, :8])
    assert not spectral.use_rsf(C.to(torch.complex128))
    monkeypatch.setenv("TEMFPY_TORCH_RSF", "auto")
    assert not spectral.use_rsf(C) and not spectral.use_rsf(C.numpy())
    for n_fermion, L in ((5, 64), (24, 64), (40, 64), (500, 1024), (520, 1024)):
        rf = 32
        while rf < min(n_fermion + 8, L):
            rf *= 2
        assert spectral.rsf_fill_width(n_fermion, L) == rf


def test_failed_cholesky_reroutes_cut(monkeypatch):
    """A filled sketch whose first column is zero makes the CholeskyQR2
    Gram singular for every cut with n_f >= 1: the factorisation reports
    it (info != 0), the cut's trace residual reads inf and the sweep sends
    it to the exact frontend; the cuts with no filled mode are kept as
    before, and their frames stay finite."""
    L, side = 64, "L"
    C = torch.as_tensor(cylinder_C(L, W=4))
    sizes = [1, 2, 3, 8, 20, 32]
    rows = []
    impl = spectral.rsf_chunk

    def rec(*a, **kw):
        out = impl(*a, **kw)
        rows.append(out[1].numpy())
        return out

    monkeypatch.setattr(spectral, "rsf_chunk", rec)
    base = spectral.rsf_sweep_frames(C, sizes, side, CUTOFF)
    n_f = rows[0][: len(sizes), 2 * spectral.RSF_KB + 1]
    assert (n_f == 0).any() and (n_f >= 1).any(), n_f
    sketches = spectral.rsf_sketches

    def planted(*a, **kw):
        G_ent, G_fill = sketches(*a, **kw)
        G_fill[:, 0] = 0.0
        return G_ent, G_fill

    monkeypatch.setattr(spectral, "rsf_sketches", planted)
    got = spectral.rsf_sweep_frames(C, sizes, side, CUTOFF)
    failed = {i for i in range(len(sizes)) if n_f[i] >= 1}
    assert got[3] == sorted(set(base[3]) | failed)
    for i in range(len(sizes)):
        if i not in got[3]:
            assert torch.isfinite(got[2][i]).all()
            np.testing.assert_array_equal(got[0][i], base[0][i])
