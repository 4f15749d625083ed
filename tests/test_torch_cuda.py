"""The CUDA kernels against their plain PyTorch twins, on the card.

Marked ``cuda``: skipped where torch sees no GPU (the decision is taken in
a fixture, at run time).  Run on a machine with a card with

    PYTHONPATH=.:tests python -m pytest tests/test_torch_cuda.py -q

Tolerance 1e-12 relative to the largest entry: kernel and twin run the
same float64 / complex128 pivoted elimination and differ only in summation
order.
"""

import numpy as np
import pytest
import torch

from temfpy_torch import gutzwiller, pfaffian, slater, testing
from temfpy_torch.ops import kernels

pytestmark = pytest.mark.cuda
RTOL = 1e-12


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)


@pytest.mark.parametrize("w", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("spec", ["rc", "rrc", "crr"])
@pytest.mark.parametrize("dtype", ["float64", "complex128"])
def test_det_fill_kernel_matches_twin(cuda, w, spec, dtype):
    args, kw = testing.random_det_fill_case(w, G=3, w=w, m=max(w, 24), P=5000, spec=spec,
                                            n_rows=256, dtype=dtype)
    a = [torch.as_tensor(x, device=cuda) for x in args[:6]]
    a.append(tuple(torch.as_tensor(t, device=cuda) for t in args[6]))
    before = kernels.det_fill.launches
    got = kernels.det_fill(*a, **kw)
    assert kernels.det_fill.launches == before + 1
    assert _rel(got, kernels.det_fill_plain(*a, **kw)) <= RTOL
    # in place, each site into its slot of a shared buffer
    shape = kw["shape"]
    buf = torch.zeros((4, shape[0] + 1) + tuple(shape[1:]), dtype=got.dtype, device=cuda)
    kernels.det_fill(*a, **kw, out=buf, slot=[3, 0, 1])
    assert torch.equal(buf[[3, 0, 1], : shape[0]], got) and not buf[2].any()


@pytest.mark.parametrize("mode", ["left", "right"])
@pytest.mark.parametrize("kb,sb", [(64, 16), (64, 24), (32, 16), (32, 24), (32, 32), (8, 16),
                                   (0, 12)])
@pytest.mark.parametrize("dtype", ["float64", "complex128"])
def test_site_overlap_kernel_matches_twin(cuda, mode, kb, sb, dtype):
    """(kb, sb) as the L=256 conversion buckets them, and smaller ones."""
    args, kw = testing.random_site_overlap_case(kb + sb, G=5, L=256, kb=kb, sb=sb,
                                                mode=mode, dtype=dtype)
    a = [torch.as_tensor(x, device=cuda) for x in args]
    for i in (2, 3, 4, 6, 7, 8):
        a[i] = a[i].to(torch.int32)
    d1, s1 = kernels.site_overlap_schur(*a, **kw)
    d0, s0 = kernels.site_overlap_schur_plain(*a, **kw)
    assert _rel(d1, d0) <= RTOL
    assert _rel(d1[:, None, None] * s1, d0[:, None, None] * s0) <= RTOL


def test_kernels_reject_what_they_do_not_take(cuda):
    args, kw = testing.random_det_fill_case(0, G=1, w=8, m=16, P=300, n_rows=64)
    a = [torch.as_tensor(x, device=cuda) for x in args[:6]]
    tabs = tuple(torch.as_tensor(t, device=cuda) for t in args[6])
    with pytest.raises(TypeError):
        kernels.det_fill(a[0], a[1], a[2].long(), *a[3:], tabs, **kw)
    with pytest.raises(ValueError):
        kernels.det_fill(a[0], a[1], a[2].cpu(), *a[3:], tabs, **kw)
    wide = torch.zeros((1, 4, 65), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="width"):
        kernels.det_fill(a[0], a[1], wide, wide, *a[4:], tabs, **kw)


def test_conversion_on_cuda_matches_cpu(cuda):
    rng = np.random.default_rng(0)
    H = rng.normal(size=(40, 40))
    H = H + H.T
    tp = {"chi_max": 64}
    kernels.det_fill.launches = kernels.site_overlap_schur.launches = 0
    gpu = slater.H_to_MPS(H, tp, device=cuda)
    assert kernels.det_fill.launches > 0 and kernels.site_overlap_schur.launches > 0
    cpu = slater.H_to_MPS(H, tp, device="cpu")
    f = abs(gpu.overlap(cpu)) / np.sqrt(gpu.norm_squared() * cpu.norm_squared())
    assert f >= 1 - 1e-10


@pytest.mark.parametrize("w", [4, 8, 12, 16, 32])
@pytest.mark.parametrize("spec", ["rc", "rrc", "crr"])
def test_pf_fill_kernel_matches_twin(cuda, w, spec):
    """Widths of the main path and 32; fewer real pairs than P_b, so pad
    pairs reach the trash row."""
    args, kw = testing.random_pf_fill_case(w, G=3, w=w, m=max(2 * w, 24), P=3000, spec=spec,
                                           n_rows=128)
    a = [torch.as_tensor(x, device=cuda) for x in args[:8]]
    a.append(tuple(torch.as_tensor(t, device=cuda) for t in args[8]))
    before = kernels.pf_fill.launches
    got = kernels.pf_fill(*a, **kw)
    assert kernels.pf_fill.launches == before + 1
    assert _rel(got, kernels.pf_fill_plain(*a, **kw)) <= RTOL


@pytest.mark.parametrize("nb,k1,k2,x", [(8, 8, 8, 5), (32, 16, 8, 30), (32, 24, 24, 17),
                                        (48, 24, 8, 45), (64, 24, 24, 61), (64, 16, 24, 40),
                                        (72, 24, 16, 70), (128, 32, 24, 120),
                                        (160, 16, 16, 150)])
def test_bdg_overlap_kernel_matches_twin(cuda, nb, k1, k2, x):
    """Half sizes in one block (nb <= 64) and in clusters of 2, 3 and 5
    (kernels.bdg_overlap_layout); a second launch returns the same bits."""
    c = [torch.as_tensor(a, device=cuda)
         for a in testing.random_bdg_overlap_case(nb, G=5, nb=nb, k1=k1, k2=k2, x=x)]
    before = kernels.bdg_overlap.launches
    N, norm = kernels.bdg_overlap(*c)
    assert kernels.bdg_overlap.launches == before + 1
    N0, norm0 = kernels.bdg_overlap_plain(*c)
    assert _rel(N, N0) <= RTOL and _rel(norm, norm0) <= RTOL
    N2, norm2 = kernels.bdg_overlap(*c)
    assert torch.equal(_bits(N2), _bits(N)) and torch.equal(_bits(norm2), _bits(norm))


@pytest.mark.parametrize("nb", [32, 64])
def test_bdg_overlap_zero_pivot_midway(cuda, nb):
    """A site whose ket frame has a zero column j: U* has a zero column, the
    elimination meets an exact zero pivot at step j (its row left
    unscaled, as in the twin), det U* = 0 and the norm is NaN; N stays
    finite and equals the twin's, and the other sites are untouched."""
    c = [torch.as_tensor(a, device=cuda)
         for a in testing.random_bdg_overlap_case(nb + 1, G=3, nb=nb, k1=16, k2=8, x=nb - 2)]
    c[1][1, :, nb // 2] = 0.0
    N, norm = kernels.bdg_overlap(*c)
    N0, norm0 = kernels.bdg_overlap_plain(*c)
    assert torch.equal(torch.isnan(norm), torch.isnan(norm0))
    assert bool(torch.isnan(norm[1])) and bool(torch.isfinite(norm[[0, 2]]).all())
    assert bool(torch.isfinite(N).all())
    assert _rel(N, N0) <= RTOL and _rel(norm[[0, 2]], norm0[[0, 2]]) <= RTOL


def test_bdg_overlap_guard_poisons_the_norm(cuda):
    """A threshold above |det U| gives NaN, as the twin does."""
    c = [torch.as_tensor(a, device=cuda)
         for a in testing.random_bdg_overlap_case(1, G=2, nb=8, k1=8, k2=8)]
    c[4] = torch.tensor([2.0, 0.0], dtype=torch.float64, device=cuda)
    _N, norm = kernels.bdg_overlap(*c)
    assert bool(torch.isnan(norm[0])) and bool(torch.isfinite(norm[1]))
    assert bool(torch.isnan(kernels.bdg_overlap_plain(*c)[1][0]))


def test_pfaffian_conversion_on_cuda_matches_cpu(cuda):
    H = testing.pip_hamiltonian(4, 4)
    tp = {"chi_max": 32}
    kernels.pf_fill.launches = kernels.bdg_overlap.launches = 0
    gpu = pfaffian.H_to_MPS(H, tp, basis="C", device=cuda)
    assert kernels.pf_fill.launches > 0 and kernels.bdg_overlap.launches > 0
    cpu = pfaffian.H_to_MPS(H, tp, basis="C", device="cpu")
    f = abs(gpu.overlap(cpu)) / np.sqrt(gpu.norm_squared() * cpu.norm_squared())
    assert f >= 1 - 1e-10
    for b in range(gpu.L + 1):
        np.testing.assert_array_equal(gpu.q_bond[b], cpu.q_bond[b])


@pytest.mark.parametrize("side", ["L", "R"])
@pytest.mark.parametrize("kb,keb", [(64, 32), (256, 128)])
def test_fw_frame_slab_kernel_matches_twin(cuda, side, kb, keb):
    """One slab with Xidx, Fidx = -1 and colmap pads and a short last slab
    (pad cuts), at L = 256."""
    L, B, fb, Wb = 256, 16, 32, 128
    VT, flat, Cmat = testing.random_fw_slab_case(kb + keb, L=L, B=B, kb=kb, keb=keb, fb=fb,
                                                 Wb=Wb)
    a = [torch.as_tensor(x, device=cuda) for x in (VT, flat, Cmat)]
    kw = {"side": side, "L": L, "kb": kb, "fb": fb, "Wb": Wb}
    before = kernels.fw_frame_slab.launches
    got = kernels.fw_frame_slab(*a, **kw)
    assert kernels.fw_frame_slab.launches == before + 1
    assert _rel(got, kernels.fw_frame_slab_plain(*a, **kw)) <= RTOL
    assert float(got[-5:].abs().max()) == 0.0 < float(got.abs().max())


@pytest.mark.parametrize("mode", ["left", "right"])
@pytest.mark.parametrize("kb,sb,dtype", [(160, 32, "float64"), (96, 32, "complex128")])
def test_site_overlap_gmem_kernel_matches_twin(cuda, mode, kb, sb, dtype):
    """mb = 192 (float64) and 128 (complex128), above the shared-memory
    kernel's limit: the wrapper takes the global-memory kernel."""
    args, kw = testing.random_site_overlap_case(kb + sb, G=5, L=256, kb=kb, sb=sb,
                                                mode=mode, dtype=dtype)
    a = [torch.as_tensor(x, device=cuda) for x in args]
    for i in (2, 3, 4, 6, 7, 8):
        a[i] = a[i].to(torch.int32)
    smem, gmem = kernels.site_overlap_schur.launches, kernels.site_overlap_schur_gmem.launches
    d1, s1 = kernels.site_overlap_schur(*a, **kw)
    assert kernels.site_overlap_schur_gmem.launches == gmem + 1
    assert kernels.site_overlap_schur.launches == smem
    d0, s0 = kernels.site_overlap_schur_plain(*a, **kw)
    assert _rel(d1, d0) <= RTOL
    assert _rel(d1[:, None, None] * s1, d0[:, None, None] * s0) <= RTOL


@pytest.mark.parametrize("nb,k1,k2,x", [(257, 24, 24, 250), (272, 16, 24, 266)])
def test_bdg_overlap_gmem_kernel_matches_twin(cuda, nb, k1, k2, x):
    """Half sizes past what a cluster holds take the global-memory
    elimination (the layout's nc = 0), through the one wrapper."""
    assert kernels.bdg_overlap_layout(nb)[0] == 0
    c = [torch.as_tensor(a, device=cuda)
         for a in testing.random_bdg_overlap_case(nb, G=4, nb=nb, k1=k1, k2=k2, x=x)]
    before = kernels.bdg_overlap.launches
    N, norm = kernels.bdg_overlap(*c)
    assert kernels.bdg_overlap.launches == before + 1
    N0, norm0 = kernels.bdg_overlap_plain(*c)
    assert _rel(N, N0) <= RTOL and _rel(norm, norm0) <= RTOL
    N2, norm2 = kernels.bdg_overlap(*c)
    assert torch.equal(_bits(N2), _bits(N)) and torch.equal(_bits(norm2), _bits(norm))


@pytest.mark.parametrize("w", [4, 8, 16, 24, 64])
@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("dtype", ["float64", "complex128"])
def test_det_rows_kernel_matches_twin(cuda, w, cross, dtype):
    (M, ib, ik, sc), kw = testing.random_det_rows_case(w, G=3, w=w, m=max(w, 20), n=300, nk=40,
                                                       cross=cross, dtype=dtype)
    a = [torch.as_tensor(x, device=cuda) for x in (M, ib, ik, sc)]
    before = kernels.det_rows.launches
    got = kernels.det_rows(*a, **kw)
    assert kernels.det_rows.launches == before + 1
    assert _rel(got, kernels.det_rows_plain(*a, **kw)) <= RTOL


@pytest.mark.parametrize("s_b,c,spec", [(1, 5, "rc"), (2, 6, "rrc"), (4, 12, "crr"),
                                        (8, 20, "rrc"), (8, 44, "crr")])
@pytest.mark.parametrize("dtype", ["float64", "complex128"])
def test_swap_kernels_match_twins(cuda, s_b, c, spec, dtype):
    """swap_tables at w_b = 8..48 and swap_fill in both modes, with pad
    pairs on the trash row and self-swap pad columns."""
    M, r0, c0, args, kw, _rows = testing.random_swap_case(s_b + c, U=3, m=c + 14, c=c, s_b=s_b,
                                                          n_rows=40, P=1200, spec=spec,
                                                          dtype=dtype)
    up = lambda x: torch.as_tensor(x, device=cuda)  # noqa: E731
    t0, f0 = kernels.swap_tables.launches, kernels.swap_fill.launches
    tab = kernels.swap_tables(up(M), up(r0), up(c0))
    ref = kernels.swap_tables_plain(up(M), up(r0), up(c0))
    for x, y in zip(tab, ref):
        assert _rel(x, y) <= RTOL
    (Mm, det, Rin, Rout, Rpos, sgr, Cin, Cout, Cpos, sgc, pr, pc, tabs, _chk) = args
    fa = [up(Mm), up(det), *tab[:5], *(up(x) for x in (Rin, Rout, Rpos, sgr, Cin, Cout, Cpos, sgc,
                                                        pr, pc))]
    sc = tuple(up(t) for t in tabs)
    T = kernels.swap_fill(*fa, sc, **kw)
    T0 = kernels.swap_fill_plain(*fa, sc, **kw)
    assert _rel(T, T0) <= RTOL
    # in place, each unit into its slot of a shared buffer
    buf = torch.zeros((4, kw["shape"][0] + 1) + tuple(kw["shape"][1:]), dtype=T.dtype,
                      device=cuda)
    got = kernels.swap_fill(*fa, sc, **kw, out=buf, slot=[3, 0, 1])
    assert got.data_ptr() == buf.data_ptr()
    assert torch.equal(buf[[3, 0, 1], : kw["shape"][0]], T) and not buf[2].any()
    v = kernels.swap_fill(*fa, s_b=s_b)
    assert _rel(v, kernels.swap_fill_plain(*fa, s_b=s_b)) <= RTOL
    assert kernels.swap_tables.launches == t0 + 1 and kernels.swap_fill.launches == f0 + 3


@pytest.mark.parametrize("kb,kk", [(3, 1), (4, 4), (10, 6), (20, 12), (1, 1), (4, 2), (8, 4),
                                   (12, 8), (16, 16)])
@pytest.mark.parametrize("dtype", ["float64", "complex128"])
def test_pf_gather_kernel_matches_twin(cuda, kb, kk, dtype):
    """Every tier: k = 2, 4, 6, 8, 12, 16, 20, 32 (register tiers 4, 8, 16
    and, in float64, 32; complex128 past 16 a warp per pair in shared
    memory), sentinels at the tail of bra_idx; two launches the same
    bits."""
    N, bra, ket, pad = testing.random_pf_gather_case(kb, m=48, nb=30, nk=20, kb=kb, kk=kk,
                                                     dtype=dtype)
    a = [torch.as_tensor(x, device=cuda) for x in (N, bra, ket)]
    before = kernels.pf_gather.launches
    got = kernels.pf_gather(*a, pad)
    assert kernels.pf_gather.launches == before + 1
    assert _rel(got, kernels.pf_gather_plain(*a, pad)) <= RTOL
    assert torch.equal(_bits(got), _bits(kernels.pf_gather(*a, pad)))


@pytest.mark.parametrize("k", [4, 12, 20, 32])
@pytest.mark.parametrize("dtype", ["float64", "complex128"])
def test_pf_gather_edge_cases(cuda, k, dtype):
    """A ket index whose row and column of N are zero (Pf = 0 exactly, as
    the twin), a sentinel run split across the ket/bra border (the ket row
    ends in m, the bra row begins with m + 1), a single pair, and 300 x 200
    pairs (many blocks of every layout)."""
    kk = k // 2 + 1
    kb = k - kk
    N, bra, ket, _pad = testing.random_pf_gather_case(k, m=64, nb=6, nk=4, kb=kb, kk=kk,
                                                      dtype=dtype)
    m = N.shape[0]
    N[5, :] = 0
    N[:, 5] = 0
    ket[0, 0] = 5
    ket[3, -1] = m
    bra[:, 0] = m + 1
    bra[bra >= m + 2] = 40  # the generator's tail sentinels: real rows here
    a = [torch.as_tensor(x, device=cuda) for x in (N, bra, ket)]
    got = kernels.pf_gather(*a, 2)
    ref = kernels.pf_gather_plain(*a, 2)
    assert _rel(got, ref) <= RTOL
    assert not got[:, 0].any() and not ref[:, 0].any()
    one = kernels.pf_gather(a[0], a[1][2:3].contiguous(), a[2][3:4].contiguous(), 2)
    assert tuple(one.shape) == (1, 1) and _rel(one, ref[2:3, 3:4]) <= RTOL
    N, bra, ket, pad = testing.random_pf_gather_case(k + 1, m=64, nb=300, nk=200, kb=kb, kk=kk,
                                                     dtype=dtype)
    a = [torch.as_tensor(x, device=cuda) for x in (N, bra, ket)]
    assert _rel(kernels.pf_gather(*a, pad), kernels.pf_gather_plain(*a, pad)) <= RTOL


def _swap_tables_case(seed, E, w, dtype, singular=()):
    """E entries of base width w over m = min(64, w + 6) sometimes widths,
    a few sentinel columns at the base's tail from w = 9 on; the entries in
    ``singular`` get a zero column of M in their base (D0 = 0)."""
    rng = np.random.default_rng(seed)
    m = min(64, w + 6)
    c = w if w <= 8 else w - 3
    M = rng.normal(size=(E, m, m))
    if dtype == "complex128":
        M = M + 1j * rng.normal(size=(E, m, m))

    def base():
        return np.stack([np.concatenate([np.sort(rng.choice(m, c, replace=False)),
                                         m + np.arange(w - c)]) for _ in range(E)])

    r0, c0 = base().astype(np.int32), base().astype(np.int32)
    for e in singular:
        M[e][:, c0[e, 0]] = 0
    return M, r0, c0


def _swap_tables_ld(M, r0, c0):
    """(D0, G, P, T2, T3) of one entry in x87 extended precision: the
    Gauss-Jordan of [A | I] with the first maximal pivot, then the
    products."""
    Ml = M.cpu().numpy()
    ld = np.clongdouble if np.iscomplexobj(Ml) else np.longdouble
    m, w = Ml.shape[0], len(r0)
    Ma = np.eye(m + w, dtype=ld)
    Ma[:m, :m] = Ml
    r, c = r0.cpu().numpy(), c0.cpu().numpy()
    AB = np.concatenate([Ma[np.ix_(r, c)], np.eye(w, dtype=ld)], axis=1)
    det = ld(1)
    for k in range(w):
        p = k + int(np.argmax(np.abs(AB[k:, k])))
        AB[[k, p]] = AB[[p, k]]
        det = (-det if p != k else det) * AB[k, k]
        row = AB[k] / (AB[k, k] if AB[k, k] != 0 else 1)
        f = AB[:, k].copy()
        f[k] = 0
        AB -= f[:, None] * row[None, :]
        AB[k] = row
    G = AB[:, w:]
    P = Ma[:, c] @ G
    return det, G, P, G @ Ma[r, :], P @ Ma[r, :]


def _swap_tables_held(got, ref, M, r0, c0):
    """Each entry's D0, G, P, T2, T3 within RTOL of the twin's (relative to
    the output's largest entry there).  Where float64 rounding parts them
    further (an ill-conditioned base: the kernel's fused multiply-adds, the
    twin's separate ones), kernel and twin are each held against an
    extended-precision evaluation within the forward-error bound of a
    pivoted elimination, w cond(A) 2^-52 relative: neither is the
    reference there (on entry 20 of the float64 w = 64 case, cond 1.4e7,
    the kernel's error is 5.5e-10 and the twin's 7.3e-11, both under the
    bound's 2e-7)."""
    w = r0.shape[-1]
    for e in range(M.shape[0]):
        pairs = [(x[e], y[e]) for x, y in zip(got[:5], ref[:5])]
        if max(_rel(x, y) for x, y in pairs) <= RTOL:
            continue
        want = _swap_tables_ld(M[e], r0[e], c0[e])
        Ma = np.eye(M.shape[-1] + w, dtype=M.cpu().numpy().dtype)
        Ma[: M.shape[-1], : M.shape[-1]] = M[e].cpu().numpy()
        bound = w * np.linalg.cond(Ma[np.ix_(r0[e].cpu().numpy(), c0[e].cpu().numpy())]) * 2.0**-52

        def err(outs):
            return max(float(np.abs(o.cpu().numpy() - r).max()) / max(float(np.abs(r).max()),
                                                                       1e-300)
                       for o, r in zip(outs, want))

        assert err([x for x, _ in pairs]) <= bound and err([y for _, y in pairs]) <= bound, e


@pytest.mark.parametrize("w", [1, 8, 24, 32, 33, 64])
@pytest.mark.parametrize("E", [1, 300])
@pytest.mark.parametrize("dtype", ["float64", "complex128"])
def test_swap_tables_every_width(cuda, w, E, dtype):
    """K6a at base widths 1 to 64 (register tiers 8, 16, 32, a warp in
    shared memory past 32), one entry and 300 (products over many blocks),
    a singular base (D0 = 0 exactly, its row left unscaled as the twin
    leaves it): each entry held as :func:`_swap_tables_held` says, max|G| and
    the tables' max equal to the outputs' own, the pre-screen verdicts the
    twin's, two launches the same bits."""
    singular = (0,) if E == 1 else (7, 150)
    M, r0, c0 = _swap_tables_case(w * E, E, w, dtype, singular)
    a = [torch.as_tensor(x, device=cuda) for x in (M, r0, c0)]
    before = kernels.swap_tables.launches
    got = kernels.swap_tables(*a)
    assert kernels.swap_tables.launches == before + 1
    ref = kernels.swap_tables_plain(*a)
    _swap_tables_held(got, ref, *a)
    for e in singular:
        assert float(got[0][e].abs()) == 0 and float(ref[0][e].abs()) == 0
    # the kernel's |z| is hypot, torch's may round otherwise in the last bit
    assert _rel(got[5], got[1].abs().flatten(1).amax(1)) <= RTOL
    assert _rel(got[6], torch.stack([t.abs().flatten(1).amax(1) for t in got[2:5]]).amax(0)
                ) <= RTOL

    def verdict(t):
        return (t[0].abs() < 1e-12) | (torch.maximum(t[5], t[6]) > slater._SWAP_GMAX)

    assert torch.equal(verdict(got), verdict(ref))
    again = kernels.swap_tables(*a)
    assert all(torch.equal(_bits(x), _bits(y)) for x, y in zip(got, again))


@pytest.mark.parametrize("c", [5, 20, 30, 33, 60])
@pytest.mark.parametrize("fail", [False, True])
def test_swap_probe_failing_class_every_width(cuda, c, fail):
    """testing.random_swap_case's probe-failing class (and its plain twin
    class) at base widths w_b = 8, 24, 32, 40, 64: on the card the tables
    pass the pre-screen, and the probe (swap_fill values against det_rows'
    direct values) fails exactly where the twins' does."""
    M, r0, c0, args, kw, (ib, ik) = testing.random_swap_case(
        c, U=2, m=c + 14, c=c, s_b=4 if c >= 8 else 2, n_rows=40, P=1200, spec="rrc",
        fail_probe=fail)
    (Mm, det, Rin, Rout, Rpos, sgr, Cin, Cout, Cpos, sgc, pr, pc, _tabs, chk) = args
    up = lambda x: torch.as_tensor(x, device=cuda)  # noqa: E731
    verdicts = []
    for tables, fill, rows in ((kernels.swap_tables, kernels.swap_fill, kernels.det_rows),
                               (kernels.swap_tables_plain, kernels.swap_fill_plain,
                                kernels.det_rows_plain)):
        tab = tables(up(M), up(r0), up(c0))
        screen = float(tab[0].abs().min()) >= 1e-12 and float(
            torch.maximum(tab[5], tab[6]).max()) <= slater._SWAP_GMAX
        sw = fill(up(Mm), up(det), *tab[:5], *(up(x) for x in (
            Rin, Rout, Rpos, sgr, Cin, Cout, Cpos, sgc)), up(np.take_along_axis(pr, chk, 1)),
            up(np.take_along_axis(pc, chk, 1)), s_b=kw["s_b"])
        dr = rows(up(Mm), up(ib), up(ik), up(det))
        verdicts.append((screen, [slater._probe_ok([(sw[u].cpu().numpy(), dr[u].cpu().numpy())])
                                  for u in range(2)]))
    assert verdicts[0] == verdicts[1] == (True, [not fail] * 2)


def test_new_kernels_reject_what_they_do_not_take(cuda):
    M = torch.zeros((1, 8, 8), dtype=torch.float64, device=cuda)
    wide = torch.zeros((1, 4, 65), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="width"):
        kernels.det_rows(M, wide, wide)
    with pytest.raises(TypeError):
        kernels.det_rows(M, wide[..., :8].long(), wide[..., :8].long())
    with pytest.raises(ValueError, match="width"):
        kernels.swap_tables(M, wide[0], wide[0])
    N = torch.zeros((8, 8), dtype=torch.complex128, device=cuda)
    rows = torch.zeros((2, 17), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="Pfaffian width"):
        kernels.pf_gather(N, rows, rows, 0)


def test_public_index_row_ops_on_cuda_match_cpu(cuda):
    """ops.linalg.batched_det_pairs / batched_det_gather and
    ops.pfaffian.batched_pfaffian_gather launch det_rows and pf_gather on a
    CUDA tensor and agree with the CPU."""
    from temfpy_torch.ops import linalg, pfaffian as opf

    (M, ib, ik, _sc), _kw = testing.random_det_rows_case(1, G=1, w=8, m=20, n=50, nk=9,
                                                         cross=True)
    Mc, Mg = torch.as_tensor(M[0]), torch.as_tensor(M[0], device=cuda)
    n5, n7 = kernels.det_rows.launches, kernels.pf_gather.launches
    g = linalg.batched_det_gather(Mg, ib[0], ik[0], chunk=16)
    assert _rel(g.cpu(), linalg.batched_det_gather(Mc, ib[0], ik[0])) <= RTOL
    p = linalg.batched_det_pairs(Mg, ib[0][:9], ik[0])
    assert _rel(p.cpu(), linalg.batched_det_pairs(Mc, ib[0][:9], ik[0])) <= RTOL
    N, bra, ket, pad = testing.random_pf_gather_case(2, m=24, nb=7, nk=5, kb=6, kk=4)
    q = opf.batched_pfaffian_gather(torch.as_tensor(N, device=cuda), bra, ket, pad)
    assert _rel(q.cpu(), opf.batched_pfaffian_gather(torch.as_tensor(N), bra, ket, pad)) <= RTOL
    assert kernels.det_rows.launches == n5 + 5 and kernels.pf_gather.launches == n7 + 1


def test_swap_conversion_on_cuda_matches_cpu(cuda, monkeypatch):
    """The rank-update path forced on the card (swap_tables, swap_fill and the
    det_rows probe launched) against the CPU's swap path."""
    monkeypatch.setenv("TEMFPY_TORCH_DET_UPDATES", "1")
    H = np.zeros((32, 32))
    for x in range(4):
        for y in range(8):
            i = 8 * x + y
            H[i, 8 * x + (y + 1) % 8] = H[8 * x + (y + 1) % 8, i] = -1.0
            if x < 3:
                H[i, i + 8] = H[i + 8, i] = -1.0 if x % 2 == 0 else -1.3
    H -= 0.05 * np.eye(32)
    tp = {"chi_max": 96}
    for name in ("swap_tables", "swap_fill", "det_rows"):
        getattr(kernels, name).launches = 0
    gpu = slater.H_to_MPS(H, tp, device=cuda)
    assert all(getattr(kernels, n).launches > 0 for n in ("swap_tables", "swap_fill", "det_rows"))
    cpu = slater.H_to_MPS(H, tp, device="cpu")
    f = abs(gpu.overlap(cpu)) / np.sqrt(gpu.norm_squared() * cpu.norm_squared())
    assert f >= 1 - 1e-10


def _as_cuda(x, cuda):
    return torch.as_tensor(x, device=cuda) if isinstance(x, np.ndarray) else x


@pytest.mark.parametrize("side", ["L", "R"])
def test_rsf_kernels_match_twins(cuda, side):
    """Every mode of K11a-d on seeded inputs (testing.random_rsf_cases: a
    dropped lane, the filled sketch's column mask and pad, a band keeping
    nothing, rank ties, a failed Cholesky): integer outputs equal, the
    non-finite entries of float outputs equal (the failed cut's infinite
    trace residual), their finite entries within RTOL of the twin's largest
    finite entry (or of 1 for the trace residuals)."""
    for name, mode, args, kw in testing.random_rsf_cases(11, L=320, m=7, r=64, rf=128, kb=96,
                                                         side=side):
        a = [_as_cuda(x, cuda) for x in args]
        kwd = {k: _as_cuda(v, cuda) for k, v in kw.items()}
        kernel, plain = getattr(kernels, name), getattr(kernels, name + "_plain")
        before = kernel.launches
        # K11c works in place (on T or V): the kernel gets clones
        got = kernel(mode, *(x.clone() for x in a), **kwd)
        assert kernel.launches == before + 1
        ref = plain(mode, *a, **kwd)
        got, ref = (got, ref) if isinstance(got, tuple) else ((got,), (ref,))
        for g, r in zip(got, ref):
            if g.dtype == torch.int32:
                assert torch.equal(g, r), (name, mode)
            else:
                fin = r.isfinite()
                assert torch.equal(g.isfinite(), fin) and torch.equal(g[~fin], r[~fin]), \
                    (name, mode)
                scale = max(float(r[fin].abs().max()), 1.0)
                assert float((g - r)[fin].abs().max()) <= RTOL * scale, (name, mode)


@pytest.mark.parametrize("side", ["L", "R"])
def test_rsf_ritz_select_in_place(cuda, side):
    """K11c at block sizes 0, 1 and L/2 (L = 256, r = 64): "shift" updates
    T itself, as the twin; "select" reads and writes only the block rows of
    V (a marker outside them stays), zeroes the dropped columns there
    exactly, and leaves the kept columns and lam_out equal to the twin's
    bit for bit; a second launch on a fresh copy gives the same bits."""
    L, r = 256, 64
    sizes_np = np.array([0, 1, L // 2, 37], np.int32)
    m = sizes_np.size
    rng = np.random.default_rng(21 + (side == "R"))
    sizes = torch.as_tensor(sizes_np, device=cuda)
    blk = kernels.rsf_block_mask(sizes, side, L)[:, :, None]
    U = blk * torch.as_tensor(rng.standard_normal((m, L, r)), device=cuda) / 4
    T = torch.as_tensor(rng.standard_normal((m, r, r)), device=cuda)
    want = kernels.rsf_ritz_select_plain("shift", U, T, sizes, side=side)
    got = kernels.rsf_ritz_select("shift", U, T.clone(), sizes, side=side)
    assert torch.equal(got, want)
    lam = torch.as_tensor(rng.choice([0.3, 0.5, 1e-9, 2.5], size=(m, r)), device=cuda)
    CV = lam[:, None, :] * U + blk * torch.as_tensor(
        rng.choice([0.0, 1e-4], size=(m, 1, r)) * rng.standard_normal((m, L, r)), device=cuda)
    kw = {"side": side, "lam": lam, "lo": 1e-2, "hi": np.inf, "res_tol": 1e-6}
    Vk, lk = kernels.rsf_ritz_select_plain("select", U, CV, sizes, **kw)
    V = U + (1 - blk) * 7.0  # a marker outside the block rows
    out, lam_out = kernels.rsf_ritz_select("select", V, CV, sizes, **kw)
    assert out is V and torch.equal(_bits(lam_out), _bits(lk))
    keep = (lk != kernels.RSF_SENTINEL)[:, None, :]
    assert bool(keep.any()) and bool((~keep).any())
    kept = blk.bool() & keep
    assert torch.equal(_bits(torch.where(kept, V, 0.0)), _bits(torch.where(kept, Vk, 0.0)))
    assert bool((V[(blk.bool() & ~keep).expand_as(V)] == 0.0).all())
    assert bool((V[(1 - blk).bool().expand_as(V)] == 7.0).all())
    V2 = U + (1 - blk) * 7.0
    assert torch.equal(_bits(kernels.rsf_ritz_select("select", V2, CV, sizes, **kw)[0]),
                       _bits(V))


def test_rsf_conversion_on_cuda_matches_cpu(cuda, monkeypatch):
    """The randomized frontend forced on (TEMFPY_TORCH_RSF=1): every K11
    kernel launched on the card, the state equal to the CPU's (twins) and to
    the card's exact frontend."""
    from temfpy_torch.ops import spectral

    H = np.zeros((64, 64))
    for x in range(16):
        for y in range(4):
            i = 4 * x + y
            H[i, 4 * x + (y + 1) % 4] = H[4 * x + (y + 1) % 4, i] = -1.0
            if x < 15:
                H[i, i + 4] = H[i + 4, i] = -1.0 if x % 2 == 0 else -0.2
    H -= 0.05 * np.eye(64) + 1e-4 * np.diag(np.arange(64))
    tp = {"chi_max": 128}
    monkeypatch.setenv("TEMFPY_TORCH_RSF", "1")
    names = ("rsf_apply", "rsf_tsprod", "rsf_ritz_select", "rsf_frames")
    for n in names:
        getattr(kernels, n).launches = 0
    gpu = slater.H_to_MPS(H, tp, device=cuda)
    assert all(getattr(kernels, n).launches > 0 for n in names)
    cpu = slater.H_to_MPS(H, tp, device="cpu")
    monkeypatch.setenv("TEMFPY_TORCH_RSF", "0")
    exact = slater.H_to_MPS(H, tp, device=cuda)
    for other in (cpu, exact):
        f = abs(gpu.overlap(other)) / np.sqrt(gpu.norm_squared() * other.norm_squared())
        assert f >= 1 - 1e-10
    assert spectral.rsf_stats()["cuts"] == 0


# --------------------------------------------------------------------------
# the redesigned K11b (rsf_tsprod: tiles that fill the card, DMMA, cp.async)
# and K9 (fw_frame_slab: real counts, DMMA, cp.async)
# --------------------------------------------------------------------------

def _bits(t):
    return t.contiguous().view(torch.int64)


def _tsprod_within(name, got, ref, mag):
    """K11b against its twin relative to the terms' magnitude |A||B| (the
    products cancel), with the non-finite entries equal."""
    fin = ref.isfinite()
    assert torch.equal(got.isfinite(), fin), name
    err = float((got - ref)[fin].abs().max()) if bool(fin.any()) else 0.0
    assert err <= RTOL * max(mag, 1.0), (name, err, mag)


@pytest.mark.parametrize("side", ["L", "R"])
@pytest.mark.parametrize("p", [1, 7, 64, 96])
@pytest.mark.parametrize("q", [1, 7, 64, 96])
def test_rsf_tsprod_ragged_shapes(cuda, side, p, q):
    """Every rsf_tsprod mode at ragged p, q and block sizes 0, 1, 15, 16,
    17 and L/2 (L = 128; the gram on 32 x 32 tiles, its stages ragged),
    the gram with ncol (identity pad past it) where p = q, and "scale" with
    lanes its filter drops: those columns exactly zero."""
    L = 128
    sizes = np.array([0, 1, 15, 16, 17, L // 2], np.int32)
    m = sizes.size
    rng = np.random.default_rng(100 * p + q + (side == "R"))
    blk = kernels.rsf_block_mask(torch.as_tensor(sizes), side, L).numpy()[:, :, None]
    A = torch.as_tensor(blk * rng.normal(size=(m, L, p)), device=cuda)
    Bq = torch.as_tensor(blk * rng.normal(size=(m, L, q)), device=cuda)
    Z = torch.as_tensor(rng.normal(size=(m, L, q)), device=cuda)
    S = torch.as_tensor(rng.normal(size=(m, p, q)), device=cuda)
    e = torch.as_tensor(rng.choice([0.5, 1e-9, 2.0], size=(m, q)), device=cuda)
    sz = torch.as_tensor(sizes, device=cuda)
    kw = {"side": side}
    cases = [("gram", (A, Bq), {}), ("sub", (A, S), {"Z": Z}), ("mul", (A, S), {}),
             ("scale", (A, S), {"e": e, "floor": 1e-3})]
    if p == q:
        ncol = torch.as_tensor(np.array([p, 0, p // 2, p, 1, p - 1], np.int32), device=cuda)
        cases.append(("gram", (A, A), {"ncol": ncol}))
    for mode, (X, Y), extra in cases:
        got = kernels.rsf_tsprod(mode, X, Y, sz, **kw, **extra)
        ref = kernels.rsf_tsprod_plain(mode, X, Y, sz, **kw, **extra)
        no_ez = {k: v for k, v in extra.items() if k not in ("Z", "e", "floor")}
        mag = float(kernels.rsf_tsprod_plain("gram" if mode == "gram" else "mul", X.abs(),
                                             Y.abs(), sz, **kw, **no_ez).max())
        if mode == "sub":
            mag = max(mag, float(Z.abs().max()))
        _tsprod_within(f"{mode} {extra.keys()}", got, ref, mag)
        if mode == "scale":
            dropped = (e <= 1e-6)[:, None, :].expand_as(got)
            assert bool((got[dropped] == 0).all())
        if mode == "gram" and "ncol" in extra:
            pad = torch.arange(p, device=cuda)[None, :] >= ncol.long()[:, None]
            assert bool((torch.diagonal(got, dim1=1, dim2=2)[pad] == 1).all())


@pytest.mark.parametrize("side", ["L", "R"])
@pytest.mark.parametrize("p", [96, 130])
def test_rsf_gram_on_wide_tiles(cuda, side, p):
    """The gram on 64 x 64 tiles (enough cuts for every SM a block): ragged
    p past a tile edge, block sizes from 0 to L, ncol with its pad."""
    L, m = 200, 40
    assert kernels.rsf_gram_tile(p, p, m) == 64
    rng = np.random.default_rng(p + (side == "R"))
    sizes = np.linspace(0, L, m).round().astype(np.int32)
    blk = kernels.rsf_block_mask(torch.as_tensor(sizes), side, L).numpy()[:, :, None]
    A = torch.as_tensor(blk * rng.normal(size=(m, L, p)), device=cuda)
    sz = torch.as_tensor(sizes, device=cuda)
    ncol = torch.as_tensor(rng.integers(0, p + 1, size=m).astype(np.int32), device=cuda)
    for extra in ({}, {"ncol": ncol}):
        got = kernels.rsf_tsprod("gram", A, A, sz, side=side, **extra)
        ref = kernels.rsf_tsprod_plain("gram", A, A, sz, side=side, **extra)
        mag = float(kernels.rsf_tsprod_plain("gram", A.abs(), A.abs(), sz, side=side,
                                             **extra).max())
        _tsprod_within(f"gram {extra.keys()}", got, ref, mag)


@pytest.mark.parametrize("side", ["L", "R"])
@pytest.mark.parametrize("kb,keb", [(64, 64), (512, 256), (1024, 512)])
@pytest.mark.parametrize("packed", [False, True])
def test_fw_frame_slab_phase3c_shapes(cuda, side, kb, keb, packed):
    """K9 at chip_smoke phase 3c's slab shapes (L = 1024, B = 64, fb = 64,
    Wb = 512): real counts below kb and keb, five pad cuts, Fidx = -1 and
    colmap pads; colmap shuffled (Cmat gathered column by column) or in the
    packing's order (Cmat rows read whole)."""
    L, B, fb, Wb = 1024, 64, 64, 512
    VT, flat, Cmat = testing.random_fw_slab_case(kb + keb + packed, L=L, B=B, kb=kb, keb=keb,
                                                 fb=fb, Wb=Wb, packed=packed)
    o = kb + fb + Wb
    assert (flat[:-5, o + 1] < kb).any() and (flat[:-5, o + 2] < keb).any()
    a = [torch.as_tensor(x, device=cuda) for x in (VT, flat, Cmat)]
    kw = {"side": side, "L": L, "kb": kb, "fb": fb, "Wb": Wb}
    got = kernels.fw_frame_slab(*a, **kw)
    assert _rel(got, kernels.fw_frame_slab_plain(*a, **kw)) <= RTOL
    assert float(got[-5:].abs().max()) == 0.0 < float(got.abs().max())


def test_redesigned_kernels_repeat_bit_for_bit(cuda):
    """Two launches of K11b (grams on 32 x 32 and on 64 x 64 tiles, every
    combine mode) and of K9 on the same inputs return the same bits."""
    L, m, r, rf = 1024, 32, 64, 512
    for name, mode, args, kw in testing.random_rsf_cases(5, L=L, m=m, r=r, rf=rf, kb=96):
        if name != "rsf_tsprod":
            continue
        a = [_as_cuda(x, cuda) for x in args]
        kwd = {k: _as_cuda(v, cuda) for k, v in kw.items()}
        first = kernels.rsf_tsprod(mode, *a, **kwd)
        assert torch.equal(_bits(first), _bits(kernels.rsf_tsprod(mode, *a, **kwd))), mode
    VT, flat, Cmat = testing.random_fw_slab_case(9, L=L, B=16, kb=256, keb=128, fb=32, Wb=256)
    a = [torch.as_tensor(x, device=cuda) for x in (VT, flat, Cmat)]
    kw = {"side": "R", "L": L, "kb": 256, "fb": 32, "Wb": 256}
    assert torch.equal(_bits(kernels.fw_frame_slab(*a, **kw)),
                       _bits(kernels.fw_frame_slab(*a, **kw)))


def test_dmma_fragment_layout(cuda):
    """One mma.sync m16n8k8 float64 product with the fragment layout the
    kernels use, against torch.matmul on the CPU copy: integer-valued
    entries, so the sums are exact."""
    rng = np.random.default_rng(8)
    A = torch.as_tensor(rng.integers(-9, 10, size=(16, 8)).astype(np.float64))
    B = torch.as_tensor(rng.integers(-9, 10, size=(8, 8)).astype(np.float64))
    before = kernels.dmma_probe.launches
    D = kernels.dmma_probe(A.to(cuda), B.to(cuda))
    assert kernels.dmma_probe.launches == before + 1
    assert torch.equal(D.cpu(), torch.matmul(A, B))


def _det_fill_cuda_case(cuda, seed, w, spec="rrc", dtype="float64", m=None, P=3000, G=3,
                        integer=False):
    args, kw = testing.random_det_fill_case(seed, G=G, w=w, m=m or max(w, 24), P=P, spec=spec,
                                            n_rows=256, dtype=dtype)
    M = np.round(2 * args[0]) if integer else args[0]
    a = [torch.as_tensor(x, device=cuda) for x in (M, *args[1:6])]
    a.append(tuple(torch.as_tensor(t, device=cuda) for t in args[6]))
    return a, kw


@pytest.mark.parametrize("w", list(range(1, 65)))
def test_det_fill_every_width(cuda, w):
    """Each width pads to its template width (4, 8, 16, 32, 64) with identity
    rows and columns; the three scatter layouts in turn, pad pairs (3000 of
    4096), different M per site."""
    a, kw = _det_fill_cuda_case(cuda, 100 + w, w, spec=("rc", "rrc", "crr")[w % 3])
    assert _rel(kernels.det_fill(*a, **kw), kernels.det_fill_plain(*a, **kw)) <= RTOL


@pytest.mark.parametrize("w", [3, 8, 13, 16, 24, 32, 40, 64])
@pytest.mark.parametrize("dtype", ["float64", "complex128"])
def test_det_fill_pivot_ties_and_zero_pivots(cuda, w, dtype):
    """M with entries in {-2, ..., 2}: exact ties in the pivot search, zero
    pivots and singular submatrices (det 0 without a division)."""
    a, kw = _det_fill_cuda_case(cuda, 7 * w, w, spec="crr", dtype=dtype, integer=True)
    got, ref = kernels.det_fill(*a, **kw), kernels.det_fill_plain(*a, **kw)
    assert bool(torch.isfinite(got).all()) and _rel(got, ref) <= RTOL


def test_det_fill_all_sentinel_pairs(cuda):
    """A group whose pairs are all pad pairs writes only the trash rows: the
    sliced buffer stays zero."""
    a, kw = _det_fill_cuda_case(cuda, 5, 16, P=300)
    pad_r, pad_c = a[2].shape[1] - 1, a[3].shape[1] - 1
    a[4] = torch.full_like(a[4], pad_r)
    a[5] = torch.full_like(a[5], pad_c)
    got = kernels.det_fill(*a, **kw)
    assert not bool(got.any()) and not bool(kernels.det_fill_plain(*a, **kw).any())


def _overlap_cuda_case(cuda, seed, kb, sb, mode, dtype="float64", L=320, G=3):
    args, kw = testing.random_site_overlap_case(seed, G=G, L=L, kb=kb, sb=sb, mode=mode,
                                                dtype=dtype)
    a = [torch.as_tensor(x, device=cuda) for x in args]
    for i in (2, 3, 4, 6, 7, 8):
        a[i] = a[i].to(torch.int32)
    return a, kw


@pytest.mark.parametrize("mode", ["left", "right"])
@pytest.mark.parametrize("kb,sb,dtype", [(136, 32, "float64"), (137, 32, "float64"),
                                         (138, 32, "float64"), (144, 32, "float64"),
                                         (256, 32, "float64"), (0, 170, "float64"),
                                         (0, 16, "float64"), (88, 32, "complex128"),
                                         (89, 32, "complex128")])
def test_site_overlap_around_the_old_limit(cuda, mode, kb, sb, dtype):
    """mb = 168, 169 (the default wrapper), 170, 176, 288 (the wide one) in
    float64 and 120, 121 in complex128, and kb = 0 (S = O, det 1)."""
    a, kw = _overlap_cuda_case(cuda, kb + sb, kb, sb, mode, dtype)
    wide = not kernels.site_overlap_fits_smem(kb + sb, a[0].dtype)
    smem, gmem = kernels.site_overlap_schur.launches, kernels.site_overlap_schur_gmem.launches
    d1, s1 = kernels.site_overlap_schur(*a, **kw)
    assert (kernels.site_overlap_schur_gmem.launches - gmem,
            kernels.site_overlap_schur.launches - smem) == ((1, 0) if wide else (0, 1))
    d0, s0 = kernels.site_overlap_schur_plain(*a, **kw)
    assert _rel(d1, d0) <= RTOL
    assert _rel(d1[:, None, None] * s1, d0[:, None, None] * s0) <= RTOL
    if kb == 0:
        assert bool((d1 == 1).all())


@pytest.mark.parametrize("kb,sb", [(1, 8), (2, 8), (3, 5), (32, 16), (65, 7), (96, 32)])
@pytest.mark.parametrize("dtype", ["float64", "complex128"])
def test_site_overlap_wide_path_on_narrow_sites(cuda, kb, sb, dtype):
    """The wide wrapper on sites that fit one block: its cluster of two (or,
    at kb = 1, one) blocks against the twin and the default wrapper."""
    a, kw = _overlap_cuda_case(cuda, 3 * kb + sb, kb, sb, "right", dtype, L=128)
    d1, s1 = kernels.site_overlap_schur_gmem(*a, **kw)
    d0, s0 = kernels.site_overlap_schur_plain(*a, **kw)
    assert _rel(d1, d0) <= RTOL
    assert _rel(d1[:, None, None] * s1, d0[:, None, None] * s0) <= RTOL
    d2, s2 = kernels.site_overlap_schur(*a, **kw)
    assert _rel(d2, d0) <= RTOL and _rel(d2[:, None, None] * s2, d0[:, None, None] * s0) <= RTOL


@pytest.mark.parametrize("mode", ["left", "right"])
@pytest.mark.parametrize("kb,sb,dtype", [(384, 32, "float64"), (257, 31, "complex128"),
                                         (160, 160, "complex128"), (64, 536, "float64"),
                                         (0, 600, "float64")])
def test_site_overlap_past_a_cluster(cuda, mode, kb, sb, dtype):
    """Always blocks no cluster holds (float64 kb=384 at mb=416; complex128
    kb=257 at mb=288 and kb=160 at mb=320; mb=600 past any cluster's
    width): the global-memory elimination through either wrapper, against
    the twin, twice for the same bits."""
    a, kw = _overlap_cuda_case(cuda, kb + sb, kb, sb, mode, dtype, L=640, G=2)
    assert kernels.schur_layout(kb, kb + sb, a[0].dtype)[0] == 0
    d0, s0 = kernels.site_overlap_schur_plain(*a, **kw)
    for wrapper in (kernels.site_overlap_schur, kernels.site_overlap_schur_gmem):
        (d1, s1), (d2, s2) = wrapper(*a, **kw), wrapper(*a, **kw)
        assert _rel(d1, d0) <= RTOL
        assert _rel(d1[:, None, None] * s1, d0[:, None, None] * s0) <= RTOL
        assert torch.equal(_bits(d1), _bits(d2)) and torch.equal(_bits(s1), _bits(s2))


def test_fill_kernels_repeat_bit_for_bit(cuda):
    """Two launches of K1 (every template width) and of K2 (both wrappers,
    both dtypes) on the same inputs return the same bits."""
    for w in (4, 8, 16, 24, 64):
        a, kw = _det_fill_cuda_case(cuda, w, w, spec="rrc")
        assert torch.equal(_bits(kernels.det_fill(*a, **kw)), _bits(kernels.det_fill(*a, **kw)))
    for kb, sb, dtype in ((64, 24, "float64"), (256, 32, "float64"), (89, 32, "complex128")):
        a, kw = _overlap_cuda_case(cuda, kb, kb, sb, "left", dtype)
        for wrapper in (kernels.site_overlap_schur, kernels.site_overlap_schur_gmem):
            (d1, s1), (d2, s2) = wrapper(*a, **kw), wrapper(*a, **kw)
            assert torch.equal(_bits(d1), _bits(d2)) and torch.equal(_bits(s1), _bits(s2))


def _rsf_apply_case(seed, L, n, shared, m=8):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(L, L))
    sizes = [0, 1, 7, L // 2, L - 1, L, 33, L // 2 + 1][:m]
    X = rng.normal(size=(L, n)) if shared else rng.normal(size=(len(sizes), L, n))
    ncol = rng.integers(0, n + 2, size=len(sizes)).astype(np.int32)
    return (A + A.T) / 2, X, np.asarray(sizes, np.int32), ncol


@pytest.mark.parametrize("L,n", [(201, 63), (1000, 512), (1024, 64)])
@pytest.mark.parametrize("mode", ["capp", "mtapp", "mapp"])
@pytest.mark.parametrize("side", ["L", "R"])
@pytest.mark.parametrize("shared", [True, False])
def test_rsf_apply_at_every_boundary(cuda, L, n, mode, side, shared):
    """K11a against its twin at block sizes 0, 1, odd, L/2, L - 1 and L (the
    ranges start and end inside a 16-byte pair of its copies; L = 201 and n
    = 63 take the 8-byte copies), L not a multiple of the 64-row tile, a
    shared sketch with nonzero rows outside the input range and per-cut
    blocks, with and without the live-column count: within RTOL of the
    largest entry of |C| |X|, rows outside M_out exact zeros, two launches
    the same bits."""
    C, X, sizes, ncol = _rsf_apply_case(L + n + len(mode), L, n, shared)
    c, x, sz = (torch.as_tensor(t, device=cuda) for t in (C, X, sizes))
    for nc in (None, torch.as_tensor(ncol, device=cuda)):
        kw = {"side": side, "ncol": nc}
        before = kernels.rsf_apply.launches
        got = kernels.rsf_apply(mode, c, x, sz, **kw)
        assert kernels.rsf_apply.launches == before + 1
        ref = kernels.rsf_apply_plain(mode, c, x, sz, **kw)
        mag = float(kernels.rsf_apply_plain(mode, c.abs(), x.abs(), sz, **kw).max())
        assert float((got - ref).abs().max()) <= RTOL * mag
        for i, s in enumerate(sizes.tolist()):  # M_out: the block, or its complement
            blk = (torch.arange(L, device=cuda) < s) if side == "L" else (
                torch.arange(L, device=cuda) >= L - s)
            assert not got[i][blk if mode == "mtapp" else ~blk].any()
        assert torch.equal(_bits(got), _bits(kernels.rsf_apply(mode, c, x, sz, **kw)))


def _swap_fill_cuda_case(cuda, seed, s_b, c, dtype, P, U=3, integer=False, spec="rrc",
                         n_rows=40):
    """Seeded swap_fill inputs on the card: the class tables from
    swap_tables, or (``integer``) every table and M with entries in {-1, 0,
    1}, so that the bordered matrices have exact pivot ties, zero pivots
    and singular cases."""
    M, r0, c0, args, kw, _rows = testing.random_swap_case(seed, U=U, m=c + 14, c=c, s_b=s_b,
                                                          n_rows=n_rows, P=P, spec=spec,
                                                          dtype=dtype)
    up = lambda x: torch.as_tensor(x, device=cuda)  # noqa: E731
    (Mm, det, Rin, Rout, Rpos, sgr, Cin, Cout, Cpos, sgc, pr, pc, tabs, _chk) = args
    tab = kernels.swap_tables(up(M), up(r0), up(c0))[:5]
    if integer:
        rng = np.random.default_rng(seed)
        Mm = rng.integers(-1, 2, size=Mm.shape).astype(Mm.dtype)
        tab = [up(rng.integers(-1, 2, size=t.shape).astype(Mm.dtype)) for t in tab]
    fa = [up(Mm), up(det), *tab, *(up(x) for x in (Rin, Rout, Rpos, sgr, Cin, Cout, Cpos, sgc,
                                                    pr, pc))]
    return fa, tuple(up(t) for t in tabs), kw


@pytest.mark.parametrize("s_b,c", [(1, 5), (2, 6), (3, 12), (4, 12), (8, 20)])
@pytest.mark.parametrize("dtype", ["float64", "complex128"])
@pytest.mark.parametrize("integer", [False, True])
def test_swap_fill_every_bucket(cuda, s_b, c, dtype, integer):
    """K6b at every template width (s_b = 1, 2, 3, 4, 8: SB2 = 2, 4, 8, 8,
    16), both dtypes, both modes, self-swap pads and pad pairs (1001 real
    of P_b = 1024), then the first 1000 pairs alone (P_b not a multiple of
    a block's pairs), and with integer tables (pivot ties, zero pivots):
    against the twin within RTOL of the largest value, two launches the
    same bits."""
    fa, sc, kw = _swap_fill_cuda_case(cuda, 40 + s_b, s_b, c, dtype, 1001, integer=integer)
    ragged = fa[:15] + [fa[15][:, :1000].contiguous(), fa[16][:, :1000].contiguous()]
    for a in (fa, ragged):
        got = kernels.swap_fill(*a, sc, **kw)
        assert bool(torch.isfinite(got).all())
        assert _rel(got, kernels.swap_fill_plain(*a, sc, **kw)) <= RTOL
        assert torch.equal(_bits(got), _bits(kernels.swap_fill(*a, sc, **kw)))
        v = kernels.swap_fill(*a, s_b=s_b)
        assert _rel(v, kernels.swap_fill_plain(*a, s_b=s_b)) <= RTOL
        assert torch.equal(_bits(v), _bits(kernels.swap_fill(*a, s_b=s_b)))


@pytest.mark.parametrize("dtype", ["float64", "complex128"])
@pytest.mark.parametrize("P", [32, 5000])
def test_swap_fill_tables_past_shared_memory(cuda, dtype, P):
    """Classes whose tables fit the 48 KB a block stages (c = 12) and whose
    T3, or more, do not (c = 44, 60: m + w = 106, 138), with the probe's 32
    pairs a unit and a full bucket: against the twin, the geometry staging
    only what fits."""
    for c in (12, 44, 60):
        fa, sc, kw = _swap_fill_cuda_case(cuda, c + P, 4, c, dtype, P, U=4, spec="crr",
                                          n_rows=80)
        geo = kernels.swap_fill_geometry(4, fa[15].shape[1], 4, fa[0].shape[1], fa[3].shape[1],
                                         fa[0].dtype)
        assert geo["smem"] <= kernels.SWAP_STAGE_BYTES
        if c >= 44:
            assert not geo["stage"] >> 4 & 1  # T3 from global memory
        assert _rel(kernels.swap_fill(*fa, sc, **kw),
                    kernels.swap_fill_plain(*fa, sc, **kw)) <= RTOL
        assert _rel(kernels.swap_fill(*fa, s_b=4), kernels.swap_fill_plain(*fa, s_b=4)) <= RTOL


# K5 det_rows and K3 pf_fill on lane segments (registers; W = 64 det_rows a
# warp in shared memory)


def _det_rows_cuda_case(cuda, seed, w, cross, dtype="float64", G=3, n=300, nk=40, m=None,
                        integer=False):
    (M, ib, ik, sc), kw = testing.random_det_rows_case(seed, G=G, w=w, m=m or max(w, 20), n=n,
                                                       nk=nk, cross=cross, dtype=dtype)
    if integer:
        M = np.round(2 * M * max(w, 20) ** 0.5)
    return [torch.as_tensor(x, device=cuda) for x in (M, ib, ik, sc)], kw


@pytest.mark.parametrize("w", [0, 1, 3, 4, 5, 8, 9, 15, 16, 17, 24, 31, 32, 33, 64])
@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("dtype", ["float64", "complex128"])
def test_det_rows_every_template_width(cuda, w, cross, dtype):
    """Each width pads to its template width (4, 8, 16, 32; 64 in shared
    memory) with identity rows and columns: against the twin within RTOL,
    and two launches the same bits (all pairs: ket rows staged, 40 of
    them)."""
    a, kw = _det_rows_cuda_case(cuda, 300 + w, w, cross, dtype)
    got = kernels.det_rows(*a, **kw)
    assert _rel(got, kernels.det_rows_plain(*a, **kw)) <= RTOL
    assert torch.equal(_bits(got), _bits(kernels.det_rows(*a, **kw)))


@pytest.mark.parametrize("w", [3, 8, 13, 16, 24, 32, 40])
@pytest.mark.parametrize("dtype", ["float64", "complex128"])
def test_det_rows_pivot_ties_and_zero_pivots(cuda, w, dtype):
    """M with small integer entries: exact ties in the pivot search (the
    first maximal row wins), zero pivots and singular submatrices (det 0
    without a division), paired and all pairs."""
    for cross in (False, True):
        a, kw = _det_rows_cuda_case(cuda, 9 * w, w, cross, dtype, integer=True)
        got, ref = kernels.det_rows(*a, **kw), kernels.det_rows_plain(*a, **kw)
        assert bool(torch.isfinite(got).all()) and _rel(got, ref) <= RTOL


@pytest.mark.parametrize("w", [2, 5, 8, 12, 16, 24, 32, 64])
def test_det_rows_float64_follows_the_lu_rule(cuda, w):
    """float64, M a signed permutation matrix: every pivot is 0 or +-1, so
    each LU operation is exact and the kernel must give the twin's values
    (0, +-1 times the scale) bit for bit: the same pivot rule and signs."""
    rng = np.random.default_rng(w)
    m = max(w, 20)
    G = 3
    M = np.zeros((G, m, m))
    for g in range(G):
        M[g, np.arange(m), rng.permutation(m)] = rng.choice([-1.0, 1.0], m)
    (_M, ib, ik, sc), kw = testing.random_det_rows_case(w, G=G, w=w, m=m, n=500)
    a = [torch.as_tensor(x, device=cuda) for x in (M, ib, ik, sc)]
    got = kernels.det_rows(*a, **kw)
    assert torch.equal(got, kernels.det_rows_plain(*a, **kw))
    assert torch.equal(_bits(got), _bits(kernels.det_rows(*a, **kw)))


@pytest.mark.parametrize("w", [4, 6, 12, 20, 24])
@pytest.mark.parametrize("dtype", ["float64", "complex128"])
def test_det_rows_probe_shaped_launch(cuda, w, dtype):
    """The rank-update probe's launch: G units of 32 pairs each, one launch
    over the flat (unit, pair) range; and a group of all-sentinel rows,
    whose determinants are the scales."""
    for G in (1, 7, 150):
        a, kw = _det_rows_cuda_case(cuda, w + G, w, False, dtype, G=G, n=32, m=w + 14)
        geo = kernels.det_rows_geometry(w, 32, G, a[0].dtype)
        assert geo["grid"] == (-(-G * 32 // geo["dets_per_block"]), 1)
        before = kernels.det_rows.launches
        got = kernels.det_rows(*a, **kw)
        assert kernels.det_rows.launches == before + 1
        assert _rel(got, kernels.det_rows_plain(*a, **kw)) <= RTOL
    M, _ib, _ik, sc = a
    m = M.shape[-1]
    pad = (m + torch.arange(w, device=cuda, dtype=torch.int32)).expand(M.shape[0], 32, w)
    pad = pad.contiguous()
    ones = kernels.det_rows(M, pad, pad, sc)
    assert torch.equal(ones, sc[:, None].expand_as(ones))


def _pf_fill_cuda_case(cuda, seed, w, spec="rrc", P=3000, G=3, zero_every=0, integer=False):
    args, kw = testing.random_pf_fill_case(seed, G=G, w=w, m=max(2 * w, 24), P=P, spec=spec,
                                           n_rows=128, zero_every=zero_every)
    N = args[0]
    if integer:  # small integers, still antisymmetric
        N = np.round(N * N.shape[-1] ** 0.5)
        N = N - np.swapaxes(N, -1, -2)
    a = [torch.as_tensor(x, device=cuda) for x in (N, *args[1:8])]
    a.append(tuple(torch.as_tensor(t, device=cuda) for t in args[8]))
    return a, kw


@pytest.mark.parametrize("w", [2, 4, 6, 8, 10, 12, 16, 20, 24, 32])
@pytest.mark.parametrize("spec", ["rc", "crr"])
def test_pf_fill_every_template_width(cuda, w, spec):
    """Each width pads to its template width (4, 8, 16, 32) with J blocks;
    pad pairs (3000 real of 4096) reach the trash row: against the twin
    within RTOL, and two launches the same bits."""
    a, kw = _pf_fill_cuda_case(cuda, 500 + w, w, spec)
    got = kernels.pf_fill(*a, **kw)
    assert _rel(got, kernels.pf_fill_plain(*a, **kw)) <= RTOL
    assert torch.equal(_bits(got), _bits(kernels.pf_fill(*a, **kw)))


@pytest.mark.parametrize("w", [4, 8, 12, 16, 32])
def test_pf_fill_pivot_ties_and_zero_pivots_midway(cuda, w):
    """N with small integer entries (exact ties: the first maximal row
    wins), and N with zero rows at some bra positions: a pair holding one
    meets a zero pivot after its ket steps and its Pfaffian is exactly 0,
    where the twin's is."""
    a, kw = _pf_fill_cuda_case(cuda, 60 + w, w, "rrc", integer=True)
    got, ref = kernels.pf_fill(*a, **kw), kernels.pf_fill_plain(*a, **kw)
    assert bool(torch.isfinite(got).all()) and _rel(got, ref) <= RTOL
    a, kw = _pf_fill_cuda_case(cuda, 70 + w, w, "rrc", zero_every=3)
    got, ref = kernels.pf_fill(*a, **kw), kernels.pf_fill_plain(*a, **kw)
    assert _rel(got, ref) <= RTOL
    assert torch.equal(got == 0, ref == 0)
    a0, _ = _pf_fill_cuda_case(cuda, 70 + w, w, "rrc")
    assert (ref == 0).sum() > (kernels.pf_fill_plain(*a0, **kw) == 0).sum()


@pytest.mark.parametrize("w", [4, 16, 32])
def test_pf_fill_all_pad_group(cuda, w):
    """A group whose pairs are all pad pairs writes only the trash rows: the
    sliced buffer stays zero.  A pair the kernel was not planned for (a
    count past the tables' width) reads NaN."""
    a, kw = _pf_fill_cuda_case(cuda, 5, w, P=300)
    pad_r, pad_c = a[2].shape[1] - 1, a[3].shape[1] - 1
    pads = list(a)
    pads[6] = torch.full_like(a[6], pad_r)
    pads[7] = torch.full_like(a[7], pad_c)
    assert not bool(kernels.pf_fill(*pads, **kw).any())
    wide = list(a)  # bra row 0 holds more excitations than the tables' width
    wide[4] = a[4].clone()
    wide[4][:, 0] = w + 2
    wide[6] = a[6].clone()
    wide[6][:, 0] = 0
    got = kernels.pf_fill(*wide, **kw)
    assert bool(torch.isnan(got).any())


def _piflux(W, Lx):
    """Bench config 4's pi-flux cylinder (bench.py:181-212)."""
    L = W * Lx
    H = np.zeros((L, L))
    for x in range(Lx):
        for y in range(W):
            i, j = x * W + y, x * W + (y + 1) % W
            if x + 1 < Lx:
                H[i, i + W] = H[i + W, i] = -1.0 if y % 2 == 0 else 1.0
            H[i, j] = H[j, i] = -1.0
    return H - 1e-4 * np.diag(np.arange(L))


def _squared_spectra_diff(a, b):
    """Max squared-Schmidt difference per bond and charge; labels equal."""
    worst = 0.0
    for bnd in range(a.L + 1):
        qa, qb = a.q_bond[bnd], b.q_bond[bnd]
        assert np.array_equal(qa, qb), bnd
        for q in np.unique(qa):
            sa, sb = np.sort(a.get_SL(bnd)[qa == q]), np.sort(b.get_SL(bnd)[qb == q])
            worst = max(worst, float(np.abs(sa**2 - sb**2).max()))
    return worst


def _twins(monkeypatch, module, **names):
    for name, plain in names.items():
        monkeypatch.setattr(module, name, getattr(kernels, plain))


def test_gutzwiller_on_cuda_kernels_match_twins(cuda, monkeypatch):
    """abrikosov_ph of bench config 4's conversion (W=4, Lx=8, chi=128):
    with the kernels, then with their twins, on the card."""
    H = _piflux(4, 8)
    tp = {"chi_max": 128}
    kernels.det_fill.launches = kernels.site_overlap_schur.launches = 0
    spin = gutzwiller.abrikosov_ph(slater.H_to_MPS(H, tp, spinful="PH", device=cuda))
    assert kernels.det_fill.launches > 0 and kernels.site_overlap_schur.launches > 0
    _twins(monkeypatch, slater, det_fill="det_fill_plain",
           site_overlap_schur="site_overlap_schur_plain")
    twin = gutzwiller.abrikosov_ph(slater.H_to_MPS(H, tp, spinful="PH", device=cuda))
    f = abs(spin.overlap(twin)) / np.sqrt(spin.norm_squared() * twin.norm_squared())
    assert f >= 1 - 1e-10 and spin.L == 32
    # the spin MPS renormalises by its projected weight (spin.norm^2)
    assert _squared_spectra_diff(spin, twin) <= 1e-10 / spin.norm


def test_slater_imps_on_cuda_kernels_match_twins(cuda, monkeypatch):
    def dimer(n):
        M = np.diag(-1.0 - 0.3 * (-1.0) ** np.arange(n - 1), 1)
        return M + M.T

    tp = {"chi_max": 64}
    kernels.det_fill.launches = kernels.site_overlap_schur.launches = 0
    imps, err = slater.H_to_iMPS(dimer(64), dimer(66), tp, 2, 32, device=cuda)
    assert kernels.det_fill.launches > 0 and kernels.site_overlap_schur.launches > 0
    _twins(monkeypatch, slater, det_fill="det_fill_plain",
           site_overlap_schur="site_overlap_schur_plain")
    twin, err_t = slater.H_to_iMPS(dimer(64), dimer(66), tp, 2, 32, device=cuda)
    assert _squared_spectra_diff(imps, twin) <= 1e-10
    assert max(abs(x * x - y * y) for x, y in zip(err, err_t)) <= 1e-10
    assert not imps.finite and imps._B[0].is_cuda


def test_pfaffian_imps_on_cuda_kernels_match_twins(cuda, monkeypatch):
    H, H2 = testing.pip_hamiltonian(4, 8), testing.pip_hamiltonian(4, 9)
    tp = {"chi_max": 64}
    kernels.pf_fill.launches = kernels.bdg_overlap.launches = 0
    imps, err = pfaffian.H_to_iMPS(H, H2, tp, 4, 16, basis="C", device=cuda)
    assert kernels.pf_fill.launches > 0 and kernels.bdg_overlap.launches > 0
    _twins(monkeypatch, pfaffian, pf_fill="pf_fill_plain", bdg_overlap="bdg_overlap_plain")
    twin, err_t = pfaffian.H_to_iMPS(H, H2, tp, 4, 16, basis="C", device=cuda)
    assert _squared_spectra_diff(imps, twin) <= 1e-10
    assert max(abs(x * x - y * y) for x, y in zip(err, err_t)) <= 1e-10
