"""The host side of the tiled K11b (``rsf_tsprod``) and K9
(``fw_frame_slab``) kernels, on the CPU.

- K11b's gram takes 32 x 32 output tiles where 64 x 64 ones would leave
  the card's SMs idle (``kernels.rsf_gram_tile``): either grid must cover
  every output entry exactly once.
- K9 stops its product at each cut's real crossing count kf and Gram width
  m, which ``ops/fw.py`` packs into the slab's index rows: they must equal
  the cut's F.size and coefficient columns, and the twin reading only
  those rows and columns of Cmat must give the same frames, bit for bit,
  as the twin reading all of it (Cmat is zero outside them).
"""

import numpy as np
import pytest
import torch

import temfpy_torch.testing as ttst
from temfpy_torch.ops import fw, kernels
from test_fw import cylinder_H, ground_C


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for name in ("FW", "FW_W0", "FW_WMAX", "FW_TOL", "FW_ATOL", "FW_TTOL", "FW_STOL",
                 "FW_SLAB"):
        monkeypatch.delenv(f"TEMFPY_TORCH_{name}", raising=False)
    fw.fw_clear_cache()
    yield
    fw.fw_clear_cache()


@pytest.mark.parametrize("p,q,m", [(64, 64, 32), (64, 64, 7), (1, 7, 6), (7, 96, 6),
                                   (96, 96, 6), (64, 512, 32), (64, 1024, 32), (512, 512, 32),
                                   (1024, 1024, 32), (1024, 1024, 1)])
def test_gram_tiles_cover_the_output_once(p, q, m):
    """The gram kernel's grid of T x T tiles (T from kernels.rsf_gram_tile)
    covers every (cut, a, b) of the (m, p, q) output exactly once, and T is
    32 exactly where 64 x 64 tiles would leave SMs without a block."""
    T = kernels.rsf_gram_tile(p, q, m)
    assert T in (32, 64)
    hits = np.zeros((p, q), np.int64)
    for a0 in range(0, p, T):
        for b0 in range(0, q, T):
            hits[a0 : a0 + T, b0 : b0 + T] += 1
    assert (hits == 1).all()
    assert (T == 32) == (-(-p // 64) * -(-q // 64) * m < kernels.RSF_SMS)


def test_gram_tile_fills_the_card_at_the_main_path_shapes():
    """L = 1024, chunks of 32 cuts: an r-wide Gram (64 x 64 per cut) gets
    128 blocks of 32 x 32 (64 x 64 tiles gave 32 blocks on 132 SMs); the
    rf-wide Grams keep 64 x 64 tiles, of which they have plenty."""
    T = kernels.rsf_gram_tile(64, 64, 32)
    assert (T, (64 // T) ** 2 * 32) == (32, 128)
    assert kernels.rsf_gram_tile(64, 1024, 32) == kernels.rsf_gram_tile(1024, 1024, 32) == 64


@pytest.mark.parametrize("side", ["L", "R"])
def test_fw_slab_counts_equal_the_cuts(side, monkeypatch):
    """Every slab ``fw_frames`` packs for the cuts of a seeded L = 48
    cylinder (slabs of 16, a short last one): per cut kf = F.size and m =
    its coefficient columns, pad cuts 0; and the twin with the counts gives
    the frames of the twin reading the whole of Cmat."""
    monkeypatch.setenv("TEMFPY_TORCH_FW_SLAB", "16")
    L = 48
    H = cylinder_H(L, W=4) + np.diag(1e-3 * np.random.default_rng(4).normal(size=L))
    C = ground_C(H)
    sizes = list(range(1, L))
    slabs = []
    launch = fw.fw_frame_slab

    def keep(VT, flat, Cmat, **kw):
        slabs.append((VT, flat, Cmat, kw))
        return launch(VT, flat, Cmat, **kw)

    monkeypatch.setattr(fw, "fw_frame_slab", keep)
    assert fw.fw_frames(C, sizes, side, 1e-12, "cpu") is not None
    cuts = fw._cut_data_batch(fw._cached_sweep(C), sizes, side, 1e-12)
    assert len(slabs) == -(-len(sizes) // 16)
    for j, (VT, flat, Cmat, kw) in enumerate(slabs):
        kb, fb, Wb = kw["kb"], kw["fb"], kw["Wb"]
        o = kb + fb + Wb
        for t in range(flat.shape[0]):
            c = 16 * j + t
            want = (cuts[c][2].size, cuts[c][3].shape[1]) if c < len(cuts) else (0, 0)
            assert tuple(flat[t, o + 1 : o + 3].tolist()) == want, (j, t)
        full = flat.clone()
        full[:, o + 1], full[:, o + 2] = kb, Cmat.shape[-1]
        assert torch.equal(kernels.fw_frame_slab_plain(VT, flat, Cmat, **kw),
                           kernels.fw_frame_slab_plain(VT, full, Cmat, **kw))


@pytest.mark.parametrize("side", ["L", "R"])
@pytest.mark.parametrize("packed", [False, True])
def test_fw_slab_twin_reads_only_the_counted_block(side, packed):
    """Seeded slabs (``testing.random_fw_slab_case``, real counts below kb
    and keb): the twin with the counts equals the twin reading all of Cmat,
    and entries of Cmat past the counts do not reach the frames."""
    L, B, kb, keb, fb, Wb = 40, 8, 16, 8, 8, 24
    VT, flat, Cmat = (torch.as_tensor(x) for x in ttst.random_fw_slab_case(
        21 + packed, L=L, B=B, kb=kb, keb=keb, fb=fb, Wb=Wb, n_cuts=B - 2, packed=packed))
    kw = {"side": side, "L": L, "kb": kb, "fb": fb, "Wb": Wb}
    o = kb + fb + Wb
    kf, m = flat[:, o + 1].long(), flat[:, o + 2].long()
    assert bool((kf[: B - 2] < kb).any() and (m[: B - 2] < keb).any())
    got = kernels.fw_frame_slab_plain(VT, flat, Cmat, **kw)
    full = flat.clone()
    full[:, o + 1], full[:, o + 2] = kb, keb
    assert torch.equal(got, kernels.fw_frame_slab_plain(VT, full, Cmat, **kw))
    outside = ~((torch.arange(kb)[None, :, None] < kf[:, None, None])
                & (torch.arange(keb)[None, None, :] < m[:, None, None]))
    noisy = Cmat + 7.0 * outside
    assert torch.equal(got, kernels.fw_frame_slab_plain(VT, flat, noisy, **kw))
    assert float(got[B - 2 :].abs().max()) == 0.0


def test_dmma_probe_on_the_cpu_is_the_product():
    rng = np.random.default_rng(2)
    A, B = torch.as_tensor(rng.normal(size=(16, 8))), torch.as_tensor(rng.normal(size=(8, 8)))
    before = kernels.dmma_probe.launches
    assert torch.equal(kernels.dmma_probe(A, B), A @ B)
    assert kernels.dmma_probe.launches == before
    with pytest.raises(ValueError):
        kernels.dmma_probe(A.T, B)
