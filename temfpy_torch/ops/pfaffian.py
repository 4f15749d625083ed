r"""Batched Pfaffians of skew-symmetric matrices, in plain PyTorch.

Counterpart of :mod:`temfpy_tpu.ops.pfaffian`.  Parlett-Reid
tridiagonalisation with partial pivoting (Wimmer, ACM TOMS 38, 30 (2012)),
vectorised over the batch: step k pivots the largest ``|A[j, k]|`` with
j > k (the first one on ties) into row and column k+1, flips the sign for
a swap, multiplies the running Pfaffian by ``A[k, k+1]`` and applies the
rank-2 skew update to the trailing block; a zero pivot gives Pf = 0.  Mixed
sizes batch together through ``Pf(A + J + ... + J) = Pf(A)`` with
``J = [[0, 1], [-1, 0]]`` (:func:`symplectic_pad`).

These functions are the plain twin of the CUDA kernel ``pf_fill``
(:func:`temfpy_torch.ops.kernels.pf_fill_plain` builds on them) and the
oracle the tests hold it against.

Not ported (TPU workarounds): the split-plane (re, im) forms
``_pfaffian_batch_last_split``, ``batched_pfaffian_split``,
``_pad_split_planes``, ``_pf_pairs_split_impl``,
``batched_pfaffian_pairs_split`` and the packed ``_pf_pairs_packed_split*``
family; the batch-last layout ``_pfaffian_batch_last`` (same Pfaffians,
implicit pivoting).  :func:`batched_pfaffian_gather` (the all-pairs
Pfaffians) launches the ``pf_gather`` kernel on a CUDA tensor and its twin
(:func:`temfpy_torch.ops.kernels.pf_gather_plain`) on a CPU tensor.
"""

from __future__ import annotations

import torch


def batched_pfaffian(matrices: torch.Tensor, chunk: int | None = None) -> torch.Tensor:
    """Pfaffians of a (..., n, n) batch of skew-symmetric matrices, n even
    (``temfpy_tpu.ops.pfaffian.batched_pfaffian``).  ``chunk`` bounds the
    batch per elimination pass."""
    *batch, n, m = matrices.shape
    if n != m:
        raise ValueError(f"matrices must be square, got {tuple(matrices.shape)}")
    if n % 2:
        raise ValueError(f"Pfaffian requires even dimension, got {n}")
    flat = matrices.reshape(-1, n, n)
    if n == 0:
        return torch.ones(flat.shape[0], dtype=matrices.dtype,
                          device=matrices.device).reshape(batch)
    step = flat.shape[0] if chunk is None else max(1, chunk)
    out = [_pfaffian_batch(flat[i : i + step]) for i in range(0, flat.shape[0], step)]
    return (torch.cat(out) if out else flat.new_ones(0)).reshape(batch)


def _pfaffian_batch(A: torch.Tensor) -> torch.Tensor:
    """Parlett-Reid on a (P, n, n) batch: ``_pfaffian_single`` (explicit
    row/column swaps) for every matrix at once."""
    F = A.clone()
    P, n, _ = F.shape
    ar = torch.arange(P, device=A.device)
    pf = torch.ones(P, dtype=A.dtype, device=A.device)
    one = torch.ones((), dtype=A.dtype, device=A.device)
    for k in range(0, n, 2):
        kp = k + 1 + torch.argmax(F[:, k + 1 :, k].abs(), dim=1)
        row = F[:, k + 1, :].clone()
        F[:, k + 1, :] = F[ar, kp, :]
        F[ar, kp, :] = row
        col = F[:, :, k + 1].clone()
        F[:, :, k + 1] = F[ar, :, kp]
        F[ar, :, kp] = col
        pf = torch.where(kp != k + 1, -pf, pf)
        akk1 = F[:, k, k + 1]
        if k + 2 < n:
            safe = torch.where(akk1 == 0, one, akk1)
            rk = F[:, k, k + 2 :] / safe[:, None]
            ck = F[:, k + 2 :, k + 1]
            F[:, k + 2 :, k + 2 :] += (rk[:, :, None] * ck[:, None, :]
                                       - ck[:, :, None] * rk[:, None, :])
        pf = pf * akk1  # a zero pivot makes the Pfaffian exactly zero
    return pf


def pfaffian_single(A: torch.Tensor) -> torch.Tensor:
    """Pfaffian of one (n, n) skew-symmetric matrix
    (``temfpy_tpu.ops.pfaffian._pfaffian_single`` / ``pfaffian_numpy``)."""
    return batched_pfaffian(A[None])[0]


def symplectic_pad(N: torch.Tensor, pad: int) -> torch.Tensor:
    """``block_diag(N, J, ..., J)`` with ``pad // 2`` copies of
    ``J = [[0, 1], [-1, 0]]`` over the trailing two axes
    (``temfpy_tpu.ops.pfaffian.symplectic_pad``)."""
    if pad % 2:
        raise ValueError(f"pad must be even, got {pad}")
    m = N.shape[-1]
    out = torch.zeros(N.shape[:-2] + (m + pad, m + pad), dtype=N.dtype, device=N.device)
    out[..., :m, :m] = N
    s = torch.arange(m, m + pad, 2, device=N.device)
    out[..., s, s + 1] = 1
    out[..., s + 1, s] = -1
    return out


def derive_pair_indices(pos_b, pos_k, cnt_b, cnt_k, pr, pc, width: int, m: int) -> torch.Tensor:
    """The (P, width) index rows of the pair-Pfaffian batch: ket excitation
    positions first, then bra positions, then a contiguous tail of
    symplectic-padding sentinels ``m, m+1, ...``
    (``temfpy_tpu.ops.pfaffian._derive_pair_indices``).  ``pos_*`` are
    per-bond position tables, ``cnt_*`` the excitation counts, ``pr``/``pc``
    the (P,) pair ids."""
    pr, pc = pr.long(), pc.long()
    nk = cnt_k.long()[pc]
    nb = cnt_b.long()[pr]
    tot = nk + nb
    s = torch.arange(width, device=pr.device)[None, :]
    kslot = torch.clamp(s, max=pos_k.shape[1] - 1)
    ket = pos_k.long()[pc[:, None], kslot]
    bslot = torch.clamp(s - nk[:, None], 0, pos_b.shape[1] - 1)
    bra = pos_b.long()[pr[:, None], bslot]
    pad = m + (s - tot[:, None])
    return torch.where(s < nk[:, None], ket,
                       torch.where(s < tot[:, None], bra, pad)).to(torch.int32)


def batched_pfaffian_pairs(N: torch.Tensor, idx: torch.Tensor, pad_slots: int,
                           chunk: int | None = None) -> torch.Tensor:
    """``Pf(N[idx[p], idx[p]])`` for a flat list of index rows
    (``temfpy_tpu.ops.pfaffian.batched_pfaffian_pairs``).

    Index values >= ``N.shape[0]`` address the symplectic extension of
    ``N`` by ``pad_slots`` rows; each row's padding is a contiguous, even
    tail of consecutive sentinels starting at ``N.shape[0]``, so the padded
    Pfaffian equals the unpadded one.  An all-sentinel row gives 1."""
    w = idx.shape[1]
    if w == 0:
        return torch.ones(idx.shape[0], dtype=N.dtype, device=N.device)
    if w % 2:
        raise ValueError("total index count per row must be even")
    N_aug = symplectic_pad(N, pad_slots) if pad_slots else N
    idx = idx.long()
    P = idx.shape[0]
    step = P if chunk is None else max(1, chunk)
    out = [batched_pfaffian(N_aug[idx[i : i + step, :, None], idx[i : i + step, None, :]])
           for i in range(0, P, step)]
    return torch.cat(out) if out else N.new_ones(0)


def batched_pfaffian_gather(N: torch.Tensor, bra_idx, ket_idx, pad_slots: int,
                            chunk: int | None = None) -> torch.Tensor:
    """Pfaffians ``Pf(N_aug[ix, ix])`` with ``ix = concat(ket_idx[j],
    bra_idx[i])`` for all pairs (i, j), the Bogoliubov-excitation overlaps
    (reference pfaffian.py:1429-1479;
    ``temfpy_tpu.ops.pfaffian.batched_pfaffian_gather``).

    Index slots holding values >= ``N.shape[0]`` address the symplectic
    extension by ``pad_slots`` rows (:func:`symplectic_pad`); every pair must
    use its padding slots as a contiguous, even-aligned run (callers pad
    only the tail of ``bra_idx``).  On a CUDA tensor ``N`` this launches the
    ``pf_gather`` kernel (one warp per pair, total width <= 32), on a CPU
    tensor its twin; ``chunk`` bounds the bra rows per launch.  Returns
    (nb, nk) on N's device."""
    from .kernels import pf_gather
    from .linalg import _as_index

    bra_idx, ket_idx = _as_index(bra_idx, N.device), _as_index(ket_idx, N.device)
    k = bra_idx.shape[1] + ket_idx.shape[1]
    nb, nk = bra_idx.shape[0], ket_idx.shape[0]
    if k == 0:
        return torch.ones((nb, nk), dtype=N.dtype, device=N.device)
    if k % 2:
        raise ValueError("total excitation count per pair must be even")
    step = nb if chunk is None or nb <= chunk else chunk
    outs = [pf_gather(N.contiguous(), bra_idx[i : i + step], ket_idx, pad_slots)
            for i in range(0, nb, max(step, 1))]
    return torch.cat(outs) if outs else N.new_ones((0, nk))
