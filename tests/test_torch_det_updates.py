"""The port's rank-update (swap) determinant path against the JAX
package's (tests/test_det_updates.py) and against the port's own direct
path, on the CPU (the kernels' plain twins).

Tolerances:
- the table and bordered-determinant twins against the JAX functions and
  np.linalg.det on the JAX test's seeded case: rtol 1e-9, atol 1e-12 (the
  JAX test's own; the values agree to ~1e-15 in practice);
- C_to_MPS on the W=8 L=32 cylinder at chi=96 with the swap path on in
  both packages: 1 - fidelity <= 1e-10 (the JAX test's swap-vs-direct
  bound), squared Schmidt values to 1e-12 (both packages classify the same
  C; their eigensolvers round at ~1e-15), charges equal;
- the port's swap path against its direct path: site tensors to 1e-9
  absolute, as tests/test_det_updates.py holds the JAX package (same
  frames, same gauge, so the tensors compare entry by entry).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import temfpy_torch.slater as tsl
from temfpy_torch import slater
from temfpy_torch.mps.io import mps_from_arrays
from temfpy_torch.ops import kernels
from temfpy_torch.ops import linalg as tlin
from temfpy_tpu import slater as jslater
from temfpy_tpu.ops import linalg as jlin
from test_det_updates import _bench_model, _piflux_model


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU twins run many small tensor operations; one intra-op
    thread keeps them from spinning the pool's idle threads, which under a
    parallel test run costs far more than it gains."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seeded_swap_case():
    """tests/test_det_updates.py:test_det_swaps_kernel_vs_direct's case."""
    rng = np.random.default_rng(3)
    m, w, pad = 14, 6, 4
    M = rng.normal(size=(m, m))
    M_aug = np.asarray(jlin.block_diag_identity_pad(jnp.asarray(M), pad))
    base_r = np.sort(rng.choice(m, w, replace=False))
    base_c = np.sort(rng.choice(m, w, replace=False))
    r0 = np.concatenate([base_r, m + np.arange(pad)]).astype(np.int32)
    c0 = np.concatenate([base_c, m + np.arange(pad)]).astype(np.int32)
    a_b = b_b = 2
    n = 64
    idx = {k: np.empty((n, 2), np.int32) for k in ("rin", "rout", "rpos", "cin", "cout", "cpos")}
    want = np.empty(n)
    # the JAX test draws its tables after det_swap_tables, from the same rng
    for t in range(n):
        a = rng.integers(0, a_b + 1)
        b = rng.integers(0, b_b + 1)
        pos_r = rng.choice(w, a_b, replace=False)
        new_r = rng.choice(np.setdiff1d(np.arange(m), base_r), a, replace=False)
        idx["rpos"][t], idx["rout"][t] = pos_r, base_r[pos_r]
        idx["rin"][t, :a], idx["rin"][t, a:] = new_r, base_r[pos_r[a:]]
        pos_c = rng.choice(w, b_b, replace=False)
        new_c = rng.choice(np.setdiff1d(np.arange(m), base_c), b, replace=False)
        idx["cpos"][t], idx["cout"][t] = pos_c, base_c[pos_c]
        idx["cin"][t, :b], idx["cin"][t, b:] = new_c, base_c[pos_c[b:]]
        R = np.sort(np.concatenate([np.delete(base_r, pos_r[:a]), new_r]))
        C = np.sort(np.concatenate([np.delete(base_c, pos_c[:b]), new_c]))
        want[t] = np.linalg.det(M[np.ix_(R, C)])
    sign = (jlin.perm_parity_rows(r0[:w].astype(np.int64), idx["rpos"], idx["rin"])
            * jlin.perm_parity_rows(c0[:w].astype(np.int64), idx["cpos"], idx["cin"]))
    return M, M_aug, r0, c0, w, idx, sign, want


def test_det_swap_tables_and_body_match_jax_and_numpy():
    M, M_aug, r0, c0, w, idx, sign, want = _seeded_swap_case()
    ref = jlin.det_swap_tables(jnp.asarray(M_aug), jnp.asarray(r0), jnp.asarray(c0))
    got = tlin.det_swap_tables(torch.as_tensor(M_aug), torch.as_tensor(r0), torch.as_tensor(c0))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-9, atol=1e-12)
    # the swap_tables twin extends M by the base width (10) where the JAX
    # test extends it by 4: the tables agree on the common rows and columns
    tw = kernels.swap_tables(torch.as_tensor(M)[None], torch.as_tensor(r0)[None],
                             torch.as_tensor(c0)[None])
    ma = M_aug.shape[0]
    for g, r in zip(tw[:5], got):
        np.testing.assert_allclose(g[0][tuple(slice(0, ma) for _ in r.shape)].numpy(), r.numpy(),
                                   rtol=1e-12, atol=1e-14)
    assert float(tw[5][0]) == pytest.approx(float(got[1].abs().max()), rel=1e-15)
    assert float(tw[6][0]) == pytest.approx(max(float(t.abs().max()) for t in tw[2:5]), rel=1e-15)
    # the sign helper is the JAX package's
    np.testing.assert_array_equal(
        tlin.perm_parity_rows(r0[:w].astype(np.int64), idx["rpos"], idx["rin"]),
        jlin.perm_parity_rows(r0[:w].astype(np.int64), idx["rpos"], idx["rin"]))
    body_ref = np.asarray(jlin._det_swaps_body(
        jnp.asarray(M_aug), *ref[1:], ref[0], jnp.asarray(sign),
        *(jnp.asarray(idx[k]) for k in ("rin", "rout", "rpos", "cin", "cout", "cpos"))))
    body = tlin.det_swaps_body(torch.as_tensor(M_aug), *got[1:], got[0], torch.as_tensor(sign),
                               *(torch.as_tensor(idx[k]) for k in
                                 ("rin", "rout", "rpos", "cin", "cout", "cpos"))).numpy()
    np.testing.assert_allclose(body, want, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(body, body_ref, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("w", [1, 8, 24, 32, 33, 64])
@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_swap_tables_twin_matches_jax_at_edge_widths(w, dtype):
    """The swap_tables twin (E = 2 entries) against the JAX package's
    det_swap_tables at base widths 1 to 64 (the kernel's register tiers 8,
    16, 32 and its shared-memory path past 32), a few sentinel columns at
    the tail of a wider base, and a singular base in entry 1 (a zero column
    of M: D0 = 0, its pivot row left unscaled, as gauss_solve_det leaves
    it): each output within 1e-12 of its largest entry; max|G| and the
    tables' max as the twin's outputs give them."""
    rng = np.random.default_rng(w)
    m = min(64, w + 6)
    c = w if w <= 8 else w - 3  # real base positions; the rest sentinels
    M = rng.normal(size=(2, m, m))
    if dtype is np.complex128:
        M = M + 1j * rng.normal(size=(2, m, m))
    r0 = np.stack([np.concatenate([np.sort(rng.choice(m, c, replace=False)),
                                   m + np.arange(w - c)]) for _ in range(2)]).astype(np.int32)
    c0 = np.stack([np.concatenate([np.sort(rng.choice(m, c, replace=False)),
                                   m + np.arange(w - c)]) for _ in range(2)]).astype(np.int32)
    M[1][:, c0[1, 0]] = 0
    T = torch.as_tensor
    tw = kernels.swap_tables(T(M), T(r0), T(c0))
    assert float(tw[0][1]) == 0
    for e in range(2):
        M_aug = np.asarray(jlin.block_diag_identity_pad(jnp.asarray(M[e]), w))
        ref = jlin.det_swap_tables(jnp.asarray(M_aug), jnp.asarray(r0[e]), jnp.asarray(c0[e]))
        for g, r in zip(tw[:5], ref):
            r = np.asarray(r)
            np.testing.assert_allclose(g[e].numpy(), r, rtol=0,
                                       atol=1e-12 * max(np.abs(r).max(), 1e-300))
        assert float(tw[5][e]) == float(tw[1][e].abs().max())
        assert float(tw[6][e]) == max(float(t[e].abs().max()) for t in tw[2:5])


@pytest.mark.parametrize("s_b,c,spec,dtype", [(1, 5, "rc", np.float64),
                                              (2, 6, "rrc", np.complex128),
                                              (4, 12, "crr", np.float64),
                                              (8, 20, "rrc", np.float64)])
def test_swap_fill_twin_against_direct_determinants(s_b, c, spec, dtype):
    """The swap_fill twin on a seeded swap bucket (testing.random_swap_case)
    against the direct determinants of the swapped row/column sets, with
    the pad pairs on the trash row and each unit's values written into its
    slot of a caller's buffer."""
    from temfpy_torch import testing

    M, r0, c0, args, kw, _rows = testing.random_swap_case(5, U=2, m=28, c=c, s_b=s_b, n_rows=24,
                                                          P=300, spec=spec, dtype=dtype)
    T = torch.as_tensor
    tabs = kernels.swap_tables(T(M), T(r0), T(c0))
    (Mm, det, Rin, Rout, Rpos, sgr, Cin, Cout, Cpos, sgc, pr, pc, sc_tabs, _chk) = args
    fa = [T(Mm), T(det), *tabs[:5], *(T(a) for a in (Rin, Rout, Rpos, sgr, Cin, Cout, Cpos,
                                                      sgc, pr, pc))]
    vals = kernels.swap_fill(*fa, s_b=s_b)
    sc = tuple(T(t) for t in sc_tabs)
    out = kernels.swap_fill(*fa, sc, **kw)
    assert tuple(out.shape) == (2,) + tuple(kw["shape"])
    buf = torch.zeros((3, kw["shape"][0] + 1) + tuple(kw["shape"][1:]), dtype=out.dtype)
    kernels.swap_fill(*fa, sc, **kw, out=buf, slot=[2, 0])
    np.testing.assert_array_equal(buf[2, : kw["shape"][0]].numpy(), out[0].numpy())
    np.testing.assert_array_equal(buf[0, : kw["shape"][0]].numpy(), out[1].numpy())
    assert not buf[1].any()
    for u in range(2):
        base = r0[u][:c]
        want = []
        for p in range(300):
            r, cc = pr[u, p], pc[u, p]
            Rs, Cs = base.copy(), base.copy()
            Rs[Rpos[u, r, :s_b]] = Rin[u, r, :s_b]
            Cs[Cpos[u, cc, :s_b]] = Cin[u, cc, :s_b]
            want.append(np.linalg.det(Mm[u][np.ix_(np.sort(Rs), np.sort(Cs))]) * det[u])
        np.testing.assert_allclose(vals[u, :300].numpy(), want, rtol=1e-9, atol=1e-12)
        # the scatter lands each real pair's value at its coordinate
        sel = {"r": pr[u, :300], "c": pc[u, :300]}
        coords = tuple(sc_tabs[i][u][sel[s]] for i, s in enumerate(spec))
        np.testing.assert_array_equal(out[u].numpy()[coords], vals[u, :300].numpy())
        assert int((out[u].abs() > 0).sum()) == 300


def test_fill_buffer_checks_the_callers_buffer():
    """kernels.fill_buffer: a fresh zeroed buffer with one slot each, or the
    caller's buffer with its shape and slots checked on the host."""
    cpu, f8 = torch.device("cpu"), torch.float64
    buf, slot = kernels.fill_buffer(None, None, 3, (4, 2, 5), f8, cpu)
    assert tuple(buf.shape) == (3, 5, 2, 5) and slot == [0, 1, 2] and not buf.any()
    out = torch.zeros((2, 5, 2, 5), dtype=f8)
    got, slot = kernels.fill_buffer(out, np.array([1, 1, 0]), 3, (4, 2, 5), f8, cpu)
    assert got is out and slot == [1, 1, 0]
    for bad_out, bad_slot in ((out, [0, 2, 1]), (out, [0, 1]), (out, None),
                              (torch.zeros((2, 4, 2, 5), dtype=f8), [0, 1, 0]),
                              (torch.zeros((2, 5, 2, 5), dtype=torch.complex128), [0, 1, 0]),
                              (torch.zeros((2, 5, 5, 2), dtype=f8).transpose(2, 3), [0, 1, 0])):
        with pytest.raises(ValueError):
            kernels.fill_buffer(bad_out, bad_slot, 3, (4, 2, 5), f8, cpu)


@pytest.mark.parametrize("fail", [False, True])
def test_probe_verdict_on_seeded_classes(fail):
    """testing.random_swap_case's probe-failing class passes the pre-screen
    (|D0| >= 1e-12, max|G| and the tables <= 1e6) and fails the probe; the
    plain class passes both.  The probe's direct values (det_rows on the
    checked pairs' index rows) are the true determinants."""
    from temfpy_torch import testing

    M, r0, c0, args, kw, (ib, ik) = testing.random_swap_case(
        8, U=2, m=26, c=12, s_b=4, n_rows=40, P=1200, spec="rrc", fail_probe=fail)
    T = torch.as_tensor
    tab = kernels.swap_tables(T(M), T(r0), T(c0))
    assert float(tab[0].abs().min()) >= 1e-12
    assert float(torch.maximum(tab[5], tab[6]).max()) <= tsl._SWAP_GMAX
    (Mm, det, Rin, Rout, Rpos, sgr, Cin, Cout, Cpos, sgc, pr, pc, _tabs, chk) = args
    sw = kernels.swap_fill(T(Mm), T(det), *tab[:5], *(T(a) for a in (
        Rin, Rout, Rpos, sgr, Cin, Cout, Cpos, sgc)), T(np.take_along_axis(pr, chk, 1)),
        T(np.take_along_axis(pc, chk, 1)), s_b=kw["s_b"]).numpy()
    dr = kernels.det_rows(T(Mm), T(ib), T(ik), T(det)).numpy()
    for u in range(2):
        for q in (0, 7, 31):
            rows, cols = ib[u, q][ib[u, q] < 26], ik[u, q][ik[u, q] < 26]
            np.testing.assert_allclose(dr[u, q], np.linalg.det(Mm[u][np.ix_(rows, cols)]) * det[u],
                                       rtol=1e-9, atol=1e-12)
        assert tsl._probe_ok([(sw[u], dr[u])]) is (not fail)


def test_swap_plans_match_jax_planner(monkeypatch):
    """The port's rank-update plans equal the JAX planner's (its CPU layout,
    TEMFPY_TPU_SWAP_COLLAPSE=0) on the same site data of the W=8 L=32
    cylinder: class base, swap tables and signs, scatter tables, pair lists,
    checked subsets and their direct index rows exactly; the pair ids up to
    the batch padding (the JAX package pads to its 4x grid, the port to a
    power of two; both pad with the sentinel row)."""
    monkeypatch.setenv("TEMFPY_TPU_DET_UPDATES", "1")
    monkeypatch.setenv("TEMFPY_TPU_SWAP_COLLAPSE", "0")
    monkeypatch.setenv("TEMFPY_TORCH_DET_UPDATES", "1")
    C = np.asarray(jslater.correlation_matrix(_bench_model(32, W=8))[0])
    n_swap = 0
    for which, mode, cuts in (("R", "right", [16, 17, 18]), ("L", "left", [16, 15, 14])):
        svs = jslater._schmidt_vectors_batched(C, cuts, which, {"chi_max": 96}, 1e-8, 8)
        for b, k in zip(svs[1:], svs[:-1]):
            plan = jslater._plan_site(b, k, mode)
            det, som = jslater._site_overlap_kernel(
                plan["frame_bra"], plan["frame_ket"], *(jnp.asarray(d) for d in plan["desc"]),
                kb=plan["kb"], mode=mode)
            jdata = jslater.MPSTensorData(det_always=det, sometimes_matrix=som, **plan["fields"])
            tdata = tsl.MPSTensorData(det_always=torch.as_tensor(np.array(det)),
                                      sometimes_matrix=torch.as_tensor(np.array(som)),
                                      **plan["fields"])
            jp, tp = jdata._plan_fill()[3], tdata._plan_fill()[3]
            assert [p["kind"] for p in tp] == [p["kind"] for p in jp]
            for a, r in zip(tp, jp):
                if a["kind"] == "direct":
                    continue
                n_swap += 1
                assert (a["w_b"], a["m"], len(a["sub"])) == (r["w_b"], r["m"], len(r["sub"]))
                np.testing.assert_array_equal(a["r0"], r["r0"])
                for sa, sr in zip(a["sub"], r["sub"]):
                    assert (sa["s_b"], sa["spec"]) == (sr["s_b"], sr["spec"])
                    for key in ("Rin", "Rout", "Rpos", "sgr", "Cin", "Cout", "Cpos", "sgc",
                                "rows", "cols", "check_sel", "check_idx_b", "check_idx_k"):
                        np.testing.assert_array_equal(sa[key], sr[key], err_msg=key)
                    for t, u in zip(sa["tabs"], sr["tabs"]):
                        np.testing.assert_array_equal(t, u)
                    P = len(sa["rows"])
                    for key, pad in (("pr", len(sa["sgr"]) - 1), ("pc", len(sa["sgc"]) - 1)):
                        np.testing.assert_array_equal(sa[key][:P], sr[key][:P])
                        assert (sa[key][P:] == pad).all() and (sr[key][P:] == pad).all()
    assert n_swap > 0


def _from_jax(m):
    return mps_from_arrays([np.array(B) for B in m._B], m._S, m.q_bond, m.qtotal, m.form,
                           device="cpu")


def _count_plans(monkeypatch):
    counts = {"swap": 0, "direct": 0}
    orig = tsl.MPSTensorData._plan_fill

    def patched(self):
        out = orig(self)
        for plan in out[3]:
            counts["swap" if plan["kind"] != "direct" else "direct"] += 1
        return out

    monkeypatch.setattr(tsl.MPSTensorData, "_plan_fill", patched)
    return counts


@pytest.fixture(scope="module")
def cylinder32():
    """The W=8, L=32 cylinder of tests/test_det_updates.py at chi=96: the
    port with the swap path on and off, the JAX package with it on."""
    mp = pytest.MonkeyPatch()
    try:
        C = np.asarray(jslater.correlation_matrix(_bench_model(32, W=8))[0])
        mp.setenv("TEMFPY_TPU_DET_UPDATES", "1")
        ref = jslater.C_to_MPS(C, {"chi_max": 96})
        mp.setenv("TEMFPY_TORCH_DET_UPDATES", "0")
        direct = slater.C_to_MPS(C, {"chi_max": 96}, device="cpu")
        mp.setenv("TEMFPY_TORCH_DET_UPDATES", "1")
        counts = _count_plans(mp)
        swap = slater.C_to_MPS(C, {"chi_max": 96}, device="cpu")
        stats = dict(tsl._swap_stats())
    finally:
        mp.undo()
    return swap, direct, ref, counts, stats


def test_swap_path_matches_jax_swap_path(cylinder32):
    swap, _direct, ref, _counts, _stats = cylinder32
    ref_t = _from_jax(ref)
    f = abs(swap.overlap(ref_t)) / np.sqrt(swap.norm_squared() * ref_t.norm_squared())
    assert f >= 1 - 1e-10, 1 - f
    for b in range(swap.L + 1):
        np.testing.assert_array_equal(swap.q_bond[b], np.asarray(ref.q_bond[b]))
        np.testing.assert_allclose(np.sort(swap.get_SL(b) ** 2),
                                   np.sort(np.asarray(ref._S[b]) ** 2), rtol=0, atol=1e-12)


def test_swap_path_matches_direct_path(cylinder32):
    swap, direct, _ref, _counts, _stats = cylinder32
    n0, n1 = direct.norm_squared(), swap.norm_squared()
    assert abs(direct.overlap(swap)) / (n0 * n1) ** 0.5 > 1 - 1e-10
    for a, b in zip(direct._B, swap._B):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-9)


def test_swap_path_exercised(cylinder32):
    _swap, _direct, _ref, counts, stats = cylinder32
    assert counts["swap"] > 0, counts
    assert stats["classes"] > 0 and stats["wasted"] == 0, stats


def test_swap_probe_no_wasted_fill_piflux(monkeypatch):
    """The pi-flux cylinder (tests/test_det_updates.py:131): classes fail
    the pre-screen or the probe, none after its swap fill ran, and the
    state equals the direct path's."""
    C = np.asarray(jslater.correlation_matrix(_piflux_model())[0])
    C2 = slater.spinful_correlation_matrix(C, True)
    monkeypatch.setenv("TEMFPY_TORCH_DET_UPDATES", "0")
    direct = slater.C_to_MPS(C2, {"chi_max": 128}, device="cpu")
    monkeypatch.setenv("TEMFPY_TORCH_DET_UPDATES", "1")
    swap = slater.C_to_MPS(C2, {"chi_max": 128}, device="cpu")
    st = tsl._swap_stats()
    assert st["wasted"] == 0 and st["classes"] > 0 and st["fallbacks"] > 0, st
    for a, b in zip(direct._B, swap._B):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-9)


def test_use_det_updates_modes(monkeypatch):
    """auto: on for the CPU, off on CUDA, and off once fallbacks dominate
    the conversion's classes; "0" and "1" override (the stop rule then
    does not apply, as in the JAX package)."""
    monkeypatch.delenv("TEMFPY_TORCH_DET_UPDATES", raising=False)
    tsl._reset_swap_stats()
    assert tsl._use_det_updates("cpu") and not tsl._use_det_updates("cuda")
    tsl._swap_stats().update(classes=8, fallbacks=5)
    assert not tsl._use_det_updates("cpu")
    monkeypatch.setenv("TEMFPY_TORCH_DET_UPDATES", "1")
    assert tsl._use_det_updates("cpu") and tsl._use_det_updates("cuda")
    monkeypatch.setenv("TEMFPY_TORCH_DET_UPDATES", "0")
    tsl._reset_swap_stats()
    assert not tsl._use_det_updates("cpu")
    np.testing.assert_array_equal(tsl._bucket_swaps(np.arange(10)),
                                  [1, 1, 2, 4, 4, 8, 8, 8, 8, 99])
