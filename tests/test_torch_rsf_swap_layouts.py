"""The launch arithmetic of K6b (``swap_fill``), and K11a's (``rsf_apply``)
twin at the block boundaries its kernel masks, on the CPU.

- ``swap_fill_geometry``: every pair of every unit taken by exactly one
  segment of one block, a lane's rows within 128 registers, 32 to 256
  threads, and the staged tables within their shared-memory budget (and so
  within the card's 227 KB), tables too large for it left in global
  memory.
- ``segment_lanes``: the lanes of a pair's segment, as det_fill had them.
- ``rsf_apply_plain`` against a numpy evaluation of the same masked
  product (the rows and columns outside the block masks of
  ``temfpy_tpu/ops/spectral.py`` sliced out), at block sizes 0, 1,
  odd, L/2, L - 1 and L, so that the ranges start and end inside a
  16-byte pair of the kernel's copies: both sides, all three modes, a
  shared sketch with nonzero rows outside the input range and per-cut
  blocks, with and without the live-column count.

Tolerance 1e-12 relative to the largest entry of |C| |X| (the product of
the magnitudes), as chip_smoke holds the kernel.
"""

import numpy as np
import pytest
import torch

from temfpy_torch.ops import kernels

RTOL = 1e-12
SMEM_LIMIT = 227 * 1024


def _pairs_taken(geo, P_b):
    """The pairs the blocks of one unit take, as csrc/swap_fill.cu loops."""
    taken = []
    per_warp = 32 // geo["lanes"]
    warps = geo["threads"] // 32
    for b in range(geo["blocks_per_unit"]):
        end = min(P_b, (b + 1) * geo["pairs_per_block"])
        for wp in range(warps):
            p0 = b * geo["pairs_per_block"] + wp * per_warp
            while p0 < end:
                taken += [p for p in range(p0, p0 + per_warp) if p < end]
                p0 += warps * per_warp
    return taken


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
@pytest.mark.parametrize("s_b", [1, 2, 3, 4, 5, 8])
def test_swap_fill_geometry_takes_every_pair_once(s_b, dtype):
    item = 16 if dtype == torch.complex128 else 8
    for P_b, U in ((1, 1), (32, 8), (33, 2), (1000, 3), (4096, 101), (16384, 91)):
        geo = kernels.swap_fill_geometry(s_b, P_b, U, 32, 16, dtype)
        SB2, lanes = geo["SB2"], geo["lanes"]
        assert SB2 in (2, 4, 8, 16) and 2 * s_b <= SB2 and (SB2 == 2 or 2 * s_b > SB2 // 2)
        assert 32 % lanes == 0 and SB2 % lanes == 0
        assert (SB2 // lanes) * SB2 * item <= 64 * 8  # a lane's rows in 128 registers
        assert geo["threads"] % 32 == 0 and 32 <= geo["threads"] <= kernels.SWAP_FILL_THREADS
        assert geo["pairs_per_block"] % (geo["threads"] // lanes) == 0
        assert sorted(_pairs_taken(geo, P_b)) == list(range(P_b))


def test_swap_fill_geometry_sizes_blocks_by_their_pairs():
    """The probe's 32-pair units take one warp each; the large buckets of the
    L=256 conversion take full blocks, more pairs a block once the launch
    has a thousand blocks."""
    probe = kernels.swap_fill_geometry(4, 32, 103, 32, 16)
    assert probe["threads"] == 32 and probe["blocks_per_unit"] == 1
    big = kernels.swap_fill_geometry(2, 16384, 91, 32, 16)
    assert big["threads"] == kernels.SWAP_FILL_THREADS
    assert big["pairs_per_block"] > big["threads"] and big["blocks_per_unit"] * 91 >= 1024


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
@pytest.mark.parametrize("m,w", [(16, 8), (32, 16), (32, 24), (58, 48), (90, 64)])
@pytest.mark.parametrize("s_b,P_b", [(1, 32), (1, 4096), (4, 32), (4, 16384), (8, 1024)])
def test_swap_fill_geometry_stages_within_shared_memory(m, w, s_b, P_b, dtype):
    item = 16 if dtype == torch.complex128 else 8
    geo = kernels.swap_fill_geometry(s_b, P_b, 64, m, w, dtype)
    ma = m + w
    sizes = [n * item for n in (m * m, w * w, ma * w, w * ma, ma * ma)]
    staged = [sz for t, sz in enumerate(sizes) if geo["stage"] >> t & 1]
    assert geo["smem"] == sum(staged) <= kernels.SWAP_STAGE_BYTES < SMEM_LIMIT
    for t, sz in enumerate(sizes):
        if sz > kernels.SWAP_STAGE_BYTES:  # T3 past (m + w) = 78 in float64
            assert not geo["stage"] >> t & 1
    if (m, w, P_b) == (32, 16, 16384) and dtype == torch.float64:
        assert geo["stage"] == 0b11111  # every table of the common bucket staged


@pytest.mark.parametrize("W,lanes64,lanes128", [(2, 1, 1), (4, 1, 1), (8, 1, 2), (16, 8, 8),
                                                (32, 32, 32), (64, 32, 32)])
def test_segment_lanes(W, lanes64, lanes128):
    assert kernels.segment_lanes(W, torch.float64) == lanes64
    assert kernels.segment_lanes(W, torch.complex128) == lanes128
    if W >= 4:
        assert kernels.det_fill_geometry(W, 256, 1)["lanes"] == lanes64


def _sizes(L):
    return [0, 1, 7, L // 2, L - 1, L, 33, L // 2 + 1]


def _in_out_rows(L, s, side, mode):
    """The rows M_in and M_out of one cut with block size ``s``, from the
    block mask of the JAX frontend (the first s rows on the left side, the
    last s on the right) and its complement."""
    blk = np.arange(L) < s if side == "L" else np.arange(L) >= L - s
    m_in, m_out = {"capp": (blk, blk), "mtapp": (blk, ~blk), "mapp": (~blk, blk)}[mode]
    return np.flatnonzero(m_in), np.flatnonzero(m_out)


def _masked_numpy(mode, C, X, sizes, side, ncol):
    L = C.shape[0]
    out = np.zeros((len(sizes), L, X.shape[-1]))
    for i, s in enumerate(sizes):
        rin, rout = _in_out_rows(L, s, side, mode)
        Xi = (X if X.ndim == 2 else X[i]).copy()
        if ncol is not None:
            Xi[:, ncol[i]:] = 0.0
        out[i, rout] = C[np.ix_(rout, rin)] @ Xi[rin]
    return out


@pytest.mark.parametrize("L,n", [(67, 5), (128, 64), (200, 64), (201, 7)])
@pytest.mark.parametrize("side", ["L", "R"])
@pytest.mark.parametrize("mode", ["capp", "mtapp", "mapp"])
@pytest.mark.parametrize("shared", [True, False])
def test_rsf_apply_twin_at_odd_boundaries(L, n, side, mode, shared):
    rng = np.random.default_rng(L + n + len(mode) + shared)
    A = rng.normal(size=(L, L))
    C = (A + A.T) / 2
    sizes = _sizes(L)
    X = rng.normal(size=(L, n)) if shared else rng.normal(size=(len(sizes), L, n))
    ncol = rng.integers(0, n + 2, size=len(sizes)).astype(np.int32)
    for nc in (None, ncol):
        kw = {"side": side, "ncol": None if nc is None else torch.as_tensor(nc)}
        got = kernels.rsf_apply(mode, torch.as_tensor(C), torch.as_tensor(X),
                                torch.as_tensor(np.asarray(sizes, np.int32)), **kw).numpy()
        ref = _masked_numpy(mode, C, X, sizes, side, nc)
        mag = _masked_numpy(mode, np.abs(C), np.abs(X), sizes, side, nc).max()
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= RTOL * mag
        for i, s in enumerate(sizes):  # rows outside M_out are exact zeros
            rout = _in_out_rows(L, s, side, mode)[1]
            assert not np.delete(got[i], rout, axis=0).any()
