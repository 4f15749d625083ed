"""Randomized spectral frontend of the Slater sweep.

Counterpart of :mod:`temfpy_tpu.ops.spectral`.  It replaces the per-cut
eigendecompositions of the sweep with products against the resident
correlation matrix C (a projector, C^2 = C):

- **Entangled modes.**  ``C_LL (1 - C_LL) = C_LR C_LR^T`` makes the
  entangled eigenvectors of a cut's block C_LL the left singular vectors of
  C_LR, with sigma^2 = lambda (1 - lambda).  Four sigma bands ([1e-2, inf),
  [1e-4, 1e-2), [1e-6, 1e-4), [3e-8, 1e-6)) are each sketched, power
  iterated against the deflation of the bands before, and resolved by
  Rayleigh-Ritz with C_LL; a residual filter drops unresolved directions,
  which the next band re-finds through an extended keep window.
- **Filled modes.**  An exact-size sketch of P C_LL P (P projects out the
  entangled modes), n_f = round(trace - sum lambda) columns, orthonormalised
  by CholeskyQR2: a basis of the lambda ~ 1 space, not eigenvectors, so the
  per-site tensors differ from the exact frontend's by a bond gauge det(Q)
  = +-1 that leaves the state unchanged.
- **Self-check.**  A cut whose trace residual is not integer to
  ``TRACE_TOL``, whose entangled count passes the frame bucket, whose
  occupied columns start below 0, whose filled count does not fit the
  sketch or whose filled Gram the Cholesky rejects (K11d writes an
  infinite trace residual for it) goes back to the caller (``fallback``),
  which takes the exact frontend for it.

:func:`rsf_chunk` runs one chunk of cuts through the four hand-written
kernels of :mod:`temfpy_torch.ops.kernels` (K11a ``rsf_apply``, K11b
``rsf_tsprod``, K11c ``rsf_ritz_select``, K11d ``rsf_frames``) and three
library calls, as the JAX body does: the batched r x r eighs
(``torch.linalg.eigh``), the Cholesky and the triangular solve.
:func:`rsf_chunk_plain` is the same sequence through the kernels' plain
twins.  On a CPU tensor the two coincide.  :func:`rsf_sweep_frames` is the
host loop over the chunks.  The random sketches come from ``np.random.default_rng(seed)``
in the JAX package's order, so both packages use the same numbers.

``TEMFPY_TORCH_RSF`` turns the frontend on; the rank, bucket and chunk
size are the JAX package's defaults.  Not ported (TPU workarounds): the float32 packed
download and its eigenvalue reconstruction (eigenvalues stay float64 from
kernel to host), the one-hot float32-split placement ``place`` (K11d places
the columns), and the host copy and upload of C (C is used where it lies;
only its diagonal comes down, for the block traces).
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from .. import profiling
from .kernels import (RSF_BIG, RSF_SENTINEL, rsf_apply, rsf_apply_plain, rsf_frames,
                      rsf_frames_plain, rsf_ritz_select, rsf_ritz_select_plain, rsf_tsprod,
                      rsf_tsprod_plain)

logger = logging.getLogger(__name__)

# sigma-band edges (descending), sigma floor, and iteration counts
BAND_EDGES = (1e-2, 1e-4, 1e-6)
SIGMA_FLOOR = 3e-8
N_BANDS = len(BAND_EDGES) + 1
POWER_STEPS = 2
RES_TOL = 1e-6
TRACE_TOL = 1e-10
LAM_SENTINEL = RSF_SENTINEL  # 3.0: > any eigenvalue; marks dropped lanes
_BIG = RSF_BIG  # 1e6: Ritz shift pushing invalid lanes out of every keep window


# per-band sketch rank (must exceed the largest per-band mode count), the
# entangled-column bucket of the frames (the most modes a cut keeps), and the
# cuts per chunk (a chunk's frames take m * L * (kb + rf) * 8 bytes): the JAX
# package's defaults
RSF_RANK = 64
RSF_KB = 96
RSF_CHUNK = 32


def rsf_rank() -> int:
    """Per-band sketch rank (``RSF_RANK``)."""
    return RSF_RANK


def rsf_kb() -> int:
    """Entangled-column bucket of the assembled frames (``RSF_KB``)."""
    return RSF_KB


def rsf_mode() -> str:
    """"0" (off, the default, as in the JAX package) or "1" (on, the CPU
    included).  The JAX package's "auto" is not ported: on an NVIDIA H100
    80GB HBM3 at 700 W the frontend ran 1.84x slower than the exact device
    frontend at L = 1024 (PERF.md)."""
    return os.environ.get("TEMFPY_TORCH_RSF", "0")


def use_rsf(C) -> bool:
    """Whether the Slater frontend takes this module for ``C`` (a tensor or
    numpy array): under mode "1", and never for a complex C."""
    if rsf_mode() != "1":
        return False
    return not (C.is_complex() if torch.is_tensor(C) else np.iscomplexobj(C))


_STATS = {"cuts": 0, "rerouted": 0}


def rsf_stats() -> dict:
    """Cuts through the frontend and cuts it sent back, since the last
    :func:`reset_rsf_stats` (``slater.C_to_MPS`` resets them)."""
    return dict(_STATS)


def reset_rsf_stats():
    _STATS.update(cuts=0, rerouted=0)


# --------------------------------------------------------------------------
# chunk
# --------------------------------------------------------------------------

_KERNEL_OPS = (rsf_apply, rsf_tsprod, rsf_ritz_select, rsf_frames)
_PLAIN_OPS = (rsf_apply_plain, rsf_tsprod_plain, rsf_ritz_select_plain, rsf_frames_plain)


def _chunk(ops, C, sizes, side, tr_blk, G_ent, G_fill, *, kb, q, res_tol):
    """The body of ``temfpy_tpu/ops/spectral.py:_rsf_chunk_impl`` through
    ``ops`` = (apply, tsprod, ritz_select, frames)."""
    apply, tsprod, ritz, frames = ops
    kw = {"side": side}
    kept_U, kept_lam = [], []

    def deflate(Z):
        for U in kept_U:
            Z = tsprod("sub", U, tsprod("gram", U, Z, sizes, **kw), sizes, Z=Z, **kw)
        return Z

    def corth(Y, floor):
        """Gram-eigh orthonormalisation dropping Gram eigenvalues <= floor^2
        (dropped lanes come out as exact zero columns)."""
        with profiling.stage("rsf/eigh"):
            e, Q = torch.linalg.eigh(tsprod("gram", Y, Y, sizes, **kw))
        return tsprod("scale", Y, Q.contiguous(), sizes, e=e.contiguous(), floor=floor, **kw)

    los = list(BAND_EDGES) + [SIGMA_FLOOR]
    his = [np.inf] + list(BAND_EDGES)
    for b, (lo, hi) in enumerate(zip(los, his)):
        U = corth(deflate(apply("mapp", C, G_ent[b], sizes, **kw)), lo / 2.0)
        for _ in range(q):
            Z = deflate(apply("mapp", C, apply("mtapp", C, U, sizes, **kw), sizes, **kw))
            U = corth(Z, (lo / 2.0) ** 2)
        U = corth(deflate(U), 0.5)
        T = ritz("shift", U, tsprod("gram", U, apply("capp", C, U, sizes, **kw), sizes, **kw),
                 sizes, **kw)
        with profiling.stage("rsf/eigh"):
            lam, Wv = torch.linalg.eigh(T)
        V = tsprod("mul", U, Wv.contiguous(), sizes, **kw)
        V, lam = ritz("select", V, apply("capp", C, V, sizes, **kw), sizes,
                      lam=lam.contiguous(), lo=lo, hi=hi, res_tol=res_tol, **kw)
        kept_U.append(V)
        kept_lam.append(lam)

    lam_all = torch.cat(kept_lam, 1)
    k, n_f, tr_res, order = frames("stats", lam_all, tr_blk)

    # filled basis: exact-size sketch of P C_LL P + CholeskyQR2 (the columns
    # past n_f stay zero; the Gram's identity pad keeps the factor regular).
    # A Gram that is not positive definite leaves a partial factor: its
    # nonzero info marks the cut failed in "place" (trace residual inf), so
    # the caller reroutes it
    Yf = deflate(apply("capp", C, G_fill, sizes, ncol=n_f, **kw))
    info = torch.zeros_like(k)
    with profiling.stage("rsf/cholqr"):
        for _ in range(2):
            Rf, err = torch.linalg.cholesky_ex(tsprod("gram", Yf, Yf, sizes, ncol=n_f, **kw))
            info = info | err
            Yf = torch.linalg.solve_triangular(Rf.mT, Yf, upper=True, left=False).contiguous()
    return frames("place", lam_all, k, n_f, tr_res, order, torch.cat(kept_U, 2), Yf, info,
                  kb=kb)


def rsf_chunk(C, sizes, side, tr_blk, G_ent, G_fill, *, kb: int, q: int = POWER_STEPS,
              res_tol: float = RES_TOL):
    """Frames and spectra of one chunk of m cuts through the kernels K11a-d
    (on a CPU tensor, their twins).

    ``C`` (L, L) float64 contiguous; ``sizes`` (m,) int32 block sizes of
    ``side`` "L" (leading rows) or "R" (trailing rows); ``tr_blk`` (m,) the
    block traces; ``G_ent`` (N_BANDS, L, r) and ``G_fill`` (L, rf) the
    random sketches.  Returns the frames (m, L, kb + rf) [entangled
    ascending | filled] and the float64 rows (m, 2 kb + 3) [lam ascending |
    1 - lam | k | n_f | trace residual (inf where the Cholesky failed)]."""
    return _chunk(_KERNEL_OPS, C, sizes, side, tr_blk, G_ent, G_fill, kb=kb, q=q,
                  res_tol=res_tol)


def rsf_chunk_plain(C, sizes, side, tr_blk, G_ent, G_fill, *, kb: int, q: int = POWER_STEPS,
                    res_tol: float = RES_TOL):
    """:func:`rsf_chunk` through the kernels' plain PyTorch twins, on the
    device of ``C``: the math of ``temfpy_tpu/ops/spectral.py:_rsf_chunk_impl``
    as batched torch ops."""
    return _chunk(_PLAIN_OPS, C, sizes, side, tr_blk, G_ent, G_fill, kb=kb, q=q,
                  res_tol=res_tol)


# --------------------------------------------------------------------------
# sweep over the chunks
# --------------------------------------------------------------------------

def rsf_sketches(L: int, r: int, rf: int, seed: int, device):
    """The random sketches (G_ent (N_BANDS, L, r), G_fill (L, rf)) of
    ``np.random.default_rng(seed)``, drawn in the JAX package's order, on
    ``device``."""
    rng = np.random.default_rng(seed)
    G_ent = torch.as_tensor(rng.standard_normal((N_BANDS, L, r)), device=device)
    return G_ent, torch.as_tensor(rng.standard_normal((L, rf)), device=device)


def rsf_fill_width(n_fermion: int, L: int) -> int:
    """The filled sketch's width rf: the power of two >= 32 reaching
    min(n_fermion + 8, L) (``temfpy_tpu/ops/spectral.py:335-340``)."""
    rf = 32
    while rf < min(n_fermion + 8, L):
        rf *= 2
    return rf


def rsf_sweep_frames(C, sizes, side, cutoff, *, seed=1234):
    """Frames and spectra for the sweep cuts of ``sizes`` (block sizes of
    ``side`` "L" or "R") through the randomized frontend.

    ``C`` is the (L, L) float64 correlation tensor, used where it lies.
    Returns ``(e_list, col0_list, frame_list, fallback)`` as
    ``temfpy_tpu.ops.spectral.rsf_sweep_frames`` does: ``e_list[i]`` the full
    ascending eigenvalue array of cut i's block, ``frame_list[i]`` an (L,
    kb + rf) view of the chunk's frames whose columns are the occupied
    eigenvectors (entangled ascending, then a basis of the filled space)
    from full index ``col0_list[i]`` on, and ``fallback`` the cuts the
    caller must decompose exactly (entries None there).  ``cutoff`` is
    unused, as in the JAX package (the caller classifies)."""
    del cutoff
    C = C.contiguous()
    L = C.shape[0]
    n = len(sizes)
    r, kb, m = rsf_rank(), rsf_kb(), RSF_CHUNK
    dev = C.device
    with profiling.stage("rsf/setup"):
        diag = C.diagonal().cpu().numpy()
        n_fermion = int(np.round(float(diag.sum())))
        rf = rsf_fill_width(n_fermion, L)
        G_ent, G_fill = rsf_sketches(L, r, rf, seed, dev)
        prefix = np.concatenate(([0.0], np.cumsum(diag)))
    results, packed = [], []
    for j0 in range(0, n, m):
        sl = [int(s) for s in sizes[j0 : j0 + m]]
        pad = np.asarray(sl + [sl[-1]] * (m - len(sl)))
        tr = prefix[pad] if side == "L" else prefix[-1] - prefix[L - pad]
        with profiling.stage("rsf/chunk"):
            slab, pk = rsf_chunk(C, torch.as_tensor(pad, dtype=torch.int32, device=dev), side,
                                 torch.as_tensor(tr, device=dev), G_ent, G_fill, kb=kb)
        results.append((slab, sl))
        packed.append(pk)
    with profiling.stage("rsf/download"):
        pk_all = torch.cat(packed).cpu().numpy()

    e_list, col0_list, frame_list, fallback = [None] * n, [0] * n, [None] * n, []
    i = 0
    for ci, (slab, sl) in enumerate(results):
        for t, x in enumerate(sl):
            row = pk_all[ci * m + t]
            k, n_f, tr_res = int(row[2 * kb]), int(row[2 * kb + 1]), float(row[2 * kb + 2])
            col0 = x - n_f - k
            if tr_res > TRACE_TOL or k > kb or col0 < 0 or n_f + 8 > rf:
                fallback.append(i)
            else:
                e_list[i] = np.concatenate([np.zeros(col0), np.sort(row[:k]), np.ones(n_f)])
                col0_list[i] = col0
                frame_list[i] = slab[t]
            i += 1
    _STATS["cuts"] += n
    _STATS["rerouted"] += len(fallback)
    if fallback:
        logger.info("rsf frontend: %d/%d cuts sent to the exact frontend", len(fallback), n)
    return e_list, col0_list, frame_list, fallback
