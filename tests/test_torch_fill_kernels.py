"""K1 (``det_fill``) and K2 (``site_overlap_schur``) at the widths of the
L=1024 conversion, on the CPU, and the launch arithmetic of their kernels.

- The K2 twin against the JAX kernel (``temfpy_tpu.slater.
  _site_overlap_group``) past the old shared-memory limit (mb = 184, 288
  and 416, kb = 160, 256 and 384, L = 512), both sweep modes: the
  captured cases of test_torch_kernels.py stop at L = 32.
- The K1 twin against ``_det_fill_packed_kernel`` at the fill widths of the
  L=1024 conversion (w = 16, 24, which the kernel runs at its template
  width 32, and 64), m = 32, with pad pairs.
- The pure-Python launch helpers the wrappers use: ``det_fill_geometry``
  (every pair of every site taken by exactly one segment of one block),
  ``overlap_tiles`` (every entry of O written by exactly one block) and
  ``schur_layout`` (every row of [A | B] held by exactly one block of the
  cluster, within its shared memory, or the global-memory elimination
  past what a cluster holds).

Tolerance 1e-12 relative to the largest entry, as in test_torch_kernels.py
(for K2 on det(A) and det(A) * S).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from temfpy_torch import testing
from temfpy_torch.ops import kernels
from temfpy_tpu import slater as jslater

RTOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(np.abs(b).max(initial=0.0), 1e-300)
    assert np.abs(a - b).max(initial=0.0) <= rtol * scale, np.abs(a - b).max() / scale


@pytest.mark.parametrize("mode", ["left", "right"])
@pytest.mark.parametrize("kb,mb", [(160, 184), (256, 288), (384, 416)])
def test_site_overlap_twin_matches_jax_past_shared_memory(kb, mb, mode):
    args, kw = testing.random_site_overlap_case(kb + mb, G=2, L=512, kb=kb, sb=mb - kb,
                                                mode=mode)
    assert not kernels.site_overlap_fits_smem(mb, torch.float64)
    det, som = kernels.site_overlap_schur(*(torch.as_tensor(a) for a in args), **kw)
    det_j, som_j = jslater._site_overlap_group(*(jnp.asarray(a) for a in args), **kw)
    det_j, som_j = np.asarray(det_j), np.asarray(som_j)
    close(det.numpy(), det_j)
    close(det.numpy()[:, None, None] * som.numpy(), det_j[:, None, None] * som_j)


@pytest.mark.parametrize("w,spec", [(16, "rrc"), (24, "crr"), (64, "rc")])
def test_det_fill_twin_matches_jax_at_l1024_widths(w, spec):
    args, kw = testing.random_det_fill_case(w, G=2, w=w, m=32, P=1000, spec=spec, n_rows=128)
    assert args[4].shape[1] > 1000  # pad pairs on the trash row
    got = kernels.det_fill(*(torch.as_tensor(a) for a in args[:6]),
                           tuple(torch.as_tensor(t) for t in args[6]), **kw)
    for g in range(2):
        ref = jslater._det_fill_packed_kernel(
            *(jnp.asarray(a[g]) for a in args[:6]), *(jnp.asarray(t[g]) for t in args[6]),
            shape=kw["shape"], spec=spec)
        close(got[g].numpy(), np.asarray(ref))


def _pairs_taken(geo, P_b):
    """The pairs of one site the det_fill blocks take, in the kernel's
    order: block b, warp, round, segment (csrc/det_fill.cu)."""
    lanes, ppb = geo["lanes"], geo["pairs_per_block"]
    per_warp, warps = 32 // lanes, geo["threads"] // 32
    taken = []
    for b in range(geo["blocks_per_site"]):
        end = min(P_b, (b + 1) * ppb)
        for warp in range(warps):
            p0 = b * ppb + warp * per_warp
            while p0 < end:
                taken += [p for p in range(p0, p0 + per_warp) if p < end]
                p0 += warps * per_warp
    return taken


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
@pytest.mark.parametrize("w", [1, 4, 5, 8, 9, 16, 17, 24, 32, 33, 64])
def test_det_fill_geometry_takes_every_pair_once(w, dtype):
    item = 16 if dtype == torch.complex128 else 8
    for P_b, G in ((1, 1), (256, 4), (3000, 3), (4096, 60), (131072, 1)):
        geo = kernels.det_fill_geometry(w, P_b, G, dtype)
        W, lanes = geo["W"], geo["lanes"]
        assert W in (4, 8, 16, 32, 64) and w <= W and (W == 4 or w > W // 2)
        assert 32 % lanes == 0 and W % lanes == 0
        # a lane's rows fit 128 registers, except at W = 64 (shared memory)
        assert W == 64 or (W // lanes) * W * item <= 64 * 8
        assert geo["threads"] == (64 if W == 64 else kernels.DET_FILL_THREADS)
        assert geo["pairs_per_block"] % (geo["threads"] // lanes) == 0
        assert sorted(_pairs_taken(geo, P_b)) == list(range(P_b))


def test_det_fill_geometry_fills_the_card():
    """The dominant bucket of the L=1024 conversion (w=16, P_b=131072, ~45
    sites a group) launches thousands of blocks; a small group still gets
    one block per round of pairs."""
    big = kernels.det_fill_geometry(16, 131072, 45)
    assert big["blocks_per_site"] * 45 >= 4096
    small = kernels.det_fill_geometry(8, 256, 4)
    assert small["pairs_per_block"] == kernels.DET_FILL_THREADS // small["lanes"]


@pytest.mark.parametrize("mb", [1, 8, 63, 64, 65, 128, 169, 288, 320])
def test_overlap_tiles_write_every_entry_once(mb):
    t = kernels.overlap_tiles(mb)
    T = kernels.OVERLAP_TILE
    hits = np.zeros((mb, mb), int)
    for x in range(t * t):
        a0, b0 = (x // t) * T, (x % t) * T
        hits[a0:a0 + T, b0:b0 + T] += 1  # the epilogue writes only a < mb, b < mb
    assert (hits == 1).all() and (t - 1) * T < mb <= t * T


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
@pytest.mark.parametrize("wide", [False, True])
def test_schur_layout_holds_every_row_once(dtype, wide):
    item = 16 if dtype == torch.complex128 else 8
    for mb in (8, 16, 56, 64, 65, 88, 128, 169, 170, 176, 288, 289, 320, 512, 513, 600):
        if mb > kernels.SCHUR_MAX_WIDTH:  # no cluster: the global-memory elimination
            assert all(kernels.schur_layout(kb, mb, dtype, wide=wide) == (0, 0, 0)
                       for kb in (0, 1, mb // 2, mb))
            continue
        cb = next(x for x in (2, 4, 9, 12, 16) if mb <= 32 * x)
        held = 16 * kernels._SCHUR_ROWS_PER_WARP[item == 16][cb]  # rows a block keeps
        assert (held // 16) * cb * item <= 36 * 8  # registers: at most 36 float64 a thread
        for kb in sorted({0, 1, 2, 3, mb // 2, mb - 8, mb}):
            if not 0 <= kb <= mb:
                continue
            floor = 2 if wide and kb >= 2 else 1
            if max(-(-kb // held), floor) > kernels.SCHUR_MAX_CLUSTER:
                assert kernels.schur_layout(kb, mb, dtype, wide=wide) == (0, 0, 0)
                continue
            nc, rows, smem = kernels.schur_layout(kb, mb, dtype, wide=wide)
            assert floor <= nc <= kernels.SCHUR_MAX_CLUSTER and rows <= held
            assert nc == floor or -(-kb // (nc - 1)) > held  # the fewest blocks
            taken = [r for q in range(nc) for r in range(q * rows, min(kb, (q + 1) * rows))]
            assert taken == list(range(kb))
            assert smem == 3 * mb * item <= 48 * 1024


def test_schur_layout_refuses_what_no_cluster_holds():
    """Past a cluster's rows or width the layout is (0, 0, 0), the
    global-memory elimination, for both wrappers: float64 kb=384 at mb=416
    (the widest always block of a half-filled L=2048 chain), complex128
    kb=257 at mb=288 and kb=160 at mb=320, and a site wider than any
    cluster; the widest that fit stay clusters."""
    for kb, mb, dtype in ((480, 512, torch.float64), (384, 416, torch.float64),
                          (257, 288, torch.complex128), (160, 320, torch.complex128),
                          (8, kernels.SCHUR_MAX_WIDTH + 1, torch.float64)):
        for wide in (False, True):
            assert kernels.schur_layout(kb, mb, dtype, wide=wide) == (0, 0, 0)
    assert kernels.schur_layout(256, 416, torch.float64)[0] == 8
    assert kernels.schur_layout(128, 320, torch.complex128)[0] == 8
    # the widest site of bench config 1 at L=1024: four blocks of 64 rows;
    # phase 3c's widest seeded site (kb=288, mb=320): six of 48
    assert kernels.schur_layout(256, 288, torch.float64) == (4, 64, 3 * 288 * 8)
    assert kernels.schur_layout(288, 320, torch.float64)[:2] == (6, 48)
