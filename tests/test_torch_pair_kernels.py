"""K5 ``det_rows`` and K3 ``pf_fill``: their launch geometries take every
determinant and pair exactly once, and their plain twins match the JAX
functions they replace at the main path's widths, on the CPU.

Tolerances:
- determinants 1e-12 relative to the largest value: the twin and
  ``temfpy_tpu.ops.linalg._det_check_impl`` / ``batched_det_gather`` run
  the same pivoted LU and differ only in rounding;
- Pfaffians 1e-12 relative to the largest value: the same Parlett-Reid,
  pivot for pivot; a Pfaffian that meets a zero pivot is exactly 0 in
  both;
- geometries and index rows are integers, compared exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from temfpy_torch import testing
from temfpy_torch.ops import kernels
from temfpy_tpu.ops import linalg as jlin
from temfpy_tpu.ops import pfaffian as jops

RTOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The twins run many small tensor operations; one intra-op thread keeps
    them from spinning the pool's idle threads under a parallel test run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(np.abs(b).max(initial=0.0), 1e-300)
    assert np.abs(a - b).max(initial=0.0) <= rtol * scale, np.abs(a - b).max() / scale


def _taken(total, per_block, threads, lanes, blocks):
    """Indices the kernels' block loops take: block b covers [b * per_block,
    min(total, (b + 1) * per_block)); warp v of it starts at v * (32 /
    lanes) and strides by the block's segments; segment s takes start + s
    where that is below the block's end (csrc/det_rows.cu, csrc/pf_fill.cu,
    as csrc/det_fill.cu)."""
    per_warp, warps = 32 // lanes, threads // 32
    b = np.arange(blocks)[:, None, None, None]
    v = np.arange(warps)[None, :, None, None]
    r = np.arange(-(-per_block // (warps * per_warp)))[None, None, :, None]
    s = np.arange(per_warp)[None, None, None, :]
    begin = b * per_block
    end = np.minimum(total, begin + per_block)
    d0 = begin + v * per_warp + r * warps * per_warp
    d = d0 + s
    ok = (d0 < end) & (d < end)
    return np.broadcast_to(d, ok.shape)[ok]


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
@pytest.mark.parametrize("w", [0, 1, 4, 5, 8, 9, 16, 17, 24, 32, 33, 64])
def test_det_rows_geometry_takes_every_determinant_once(w, dtype):
    """Paired over the flat (matrix, determinant) range, all pairs per
    matrix; the probe's shape (G units x 32 pairs) among them."""
    item = 16 if dtype == torch.complex128 else 8
    for G, n, nk in ((1, 1, None), (40, 32, None), (300, 32, None), (3, 5000, None),
                     (2, 70_000, None), (1, 1, 1), (3, 40, 12), (2, 300, 200), (1, 600, 300)):
        geo = kernels.det_rows_geometry(w, n, G, dtype, nk)
        W, lanes, threads = geo["W"], geo["lanes"], geo["threads"]
        assert W in (4, 8, 16, 32, 64) and w <= W and (W == 4 or w > W // 2)
        assert 32 % lanes == 0 and W % lanes == 0 and threads % 32 == 0
        assert W == 64 or (W // lanes) * W * item <= 64 * 8  # a lane's rows: 128 registers
        assert threads == 64 if W == 64 else threads in (64, kernels.DET_ROWS_THREADS)
        assert geo["dets_per_block"] % (threads // lanes) == 0
        per_matrix = n * nk if nk else n
        total = per_matrix if nk else G * n
        gx, gy = geo["grid"]
        assert gy == (G if nk else 1)
        taken = _taken(total, geo["dets_per_block"], threads, lanes, gx)
        np.testing.assert_array_equal(np.sort(taken), np.arange(total))
        assert geo["stage"] == (nk is not None and W < 64 and 4 * w * nk <= kernels.STAGE_BYTES
                                and min(geo["dets_per_block"], per_matrix) >= nk)
        assert geo["smem"] == (4 * w * nk if geo["stage"] else 0)


@pytest.mark.parametrize("w", [4, 8, 12, 16, 20, 24])
def test_det_rows_probe_launch_spreads_over_the_card(w):
    """The rank-update probe (G units x 32 pairs) is one flat range: every
    block but the last is full, and a small launch takes 64-thread blocks,
    more of them than units."""
    for G in (8, 40, 300):
        geo = kernels.det_rows_geometry(w, 32, G)
        gx, gy = geo["grid"]
        assert gy == 1 and gx == -(-G * 32 // geo["dets_per_block"])
        if G * 32 * geo["lanes"] < kernels.RSF_SMS * 256:
            assert geo["threads"] == 64 and geo["dets_per_block"] == 64 // geo["lanes"]
            assert gx >= G * 32 // 64


def _pairs_taken(P_b, per_block, threads, blocks):
    """Pairs csrc/pf_fill.cu's block loops take: block b covers [b *
    per_block, min(P_b, (b + 1) * per_block)); warp v of it takes chunks of
    32 pairs from b * per_block + 32 v, striding by the block's warps, each
    chunk its pairs up to the block's end (in an order of its own)."""
    warps = threads // 32
    b = np.arange(blocks)[:, None, None, None]
    v = np.arange(warps)[None, :, None, None]
    i = np.arange(-(-per_block // (32 * warps)))[None, None, :, None]
    t = np.arange(32)[None, None, None, :]
    begin = b * per_block
    end = np.minimum(P_b, begin + per_block)
    c0 = begin + 32 * (v + warps * i)
    ok = (c0 < end) & (c0 + t < end)
    return np.broadcast_to(c0 + t, ok.shape)[ok]


@pytest.mark.parametrize("width", [2, 4, 6, 8, 10, 12, 16, 20, 24, 32])
def test_pf_fill_geometry_takes_every_pair_once(width):
    for P_b, G, m in ((1, 1, 8), (256, 4, 16), (3000, 3, 24), (4096, 60, 48), (65536, 4, 64),
                      (131072, 2, 40)):
        geo = kernels.pf_fill_geometry(width, P_b, G, m)
        W, threads = geo["W"], geo["threads"]
        assert W in (4, 8, 16, 32) and width <= W and (W == 4 or width > W // 2)
        assert threads in (64, kernels.PF_FILL_THREADS)
        assert geo["pairs_per_block"] % threads == 0
        taken = _pairs_taken(P_b, geo["pairs_per_block"], threads, geo["blocks_per_site"])
        np.testing.assert_array_equal(np.sort(taken), np.arange(P_b))  # each site's blocks
        fits = m * (m + 1) * 16 <= kernels.STAGE_BYTES
        # at W = 32 the wide tier's matrices take the shared memory
        assert geo["stage"] == (W <= 16 and fits
                                and min(geo["pairs_per_block"], P_b) * width**2 >= m * m)
        wide = threads // 32 * kernels.PF_WIDE_BYTES if W == 32 else 0
        assert geo["smem"] == (m * (m + 1) * 16 if geo["stage"] else 0) + wide


@pytest.mark.parametrize("w", [4, 6, 8, 12, 16, 20, 24])
@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_det_rows_twin_matches_jax(w, cross, dtype):
    """Index rows of width w with w, w-1 or w-2 real slots (sentinel tails)
    and an all-sentinel last row: paired against the rank-update check
    ``_det_check_impl`` on diag(M, I_w) with the scale, all pairs against
    ``batched_det_gather``."""
    n, nk = (9, 7) if cross else (40, None)
    (M, ib, ik, sc), kw = testing.random_det_rows_case(w, G=2, w=w, m=w + 6, n=n, nk=nk,
                                                       cross=cross, dtype=dtype)
    got = kernels.det_rows_plain(*(torch.as_tensor(a) for a in (M, ib, ik, sc)), **kw).numpy()
    for g in range(2):
        if cross:
            want = np.asarray(jlin.batched_det_gather(jnp.asarray(M[g]), ib[g], ik[g])) * sc[g]
        else:
            M_aug = jlin.block_diag_identity_pad(jnp.asarray(M[g]), w)
            want = np.asarray(jlin._det_check_impl(M_aug, sc[g], ib[g], ik[g]))
        close(got[g], want)
    last = got[:, -1, -1] if cross else got[:, -1]
    np.testing.assert_allclose(last, sc, rtol=0, atol=0)  # all-sentinel rows: det 1


@pytest.mark.parametrize("w", [2, 4, 6, 8, 10, 12, 14, 16])
def test_pf_fill_twin_matches_jax_with_zero_pivots(w):
    """Pair Pfaffians of total size tot = 0..w with N's rows and columns
    zero at every third bra position: a pair holding one meets a zero pivot
    after its ket steps (Pf exactly 0 in both), the rest are generic;
    against ``batched_pfaffian_pairs`` on ``_derive_pair_indices``' rows,
    times the norm, scattered by the same tables."""
    m = max(2 * w, 8)
    args, kw = testing.random_pf_fill_case(w, G=2, w=w, m=m, P=300, spec="rrc", n_rows=48,
                                           zero_every=3)
    got = kernels.pf_fill_plain(*(torch.as_tensor(a) for a in args[:8]),
                                tuple(torch.as_tensor(t) for t in args[8]), **kw).numpy()
    N, norm, *tables, tabs = args
    zeros = 0
    for g in range(2):
        idx = jops._derive_pair_indices(*(jnp.asarray(t[g]) for t in tables), w, m)
        vals = np.asarray(jops.batched_pfaffian_pairs(N[g], idx, pad_slots=w)) * norm[g]
        ids = {"r": tables[4][g], "c": tables[5][g]}
        coords = tuple(tabs[i][g][ids[s]] for i, s in enumerate("rrc"))
        ref = np.zeros((kw["shape"][0] + 1,) + kw["shape"][1:], complex)
        ref[coords] = vals
        close(got[g], ref[: kw["shape"][0]])
        real = tables[4][g] != tables[0].shape[1] - 1
        hit = (vals == 0) & real
        np.testing.assert_array_equal(got[g][tuple(c[hit] for c in coords)], 0)
        zeros += int(hit.sum())
    assert zeros > 0
