#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (temfpy_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing a line; any failure raises and exits non-zero:

1. device: needs CUDA; prints the card's name and, on a line of its own,
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``;
2. build: compiles the CUDA kernels from ``temfpy_torch/csrc`` (nvcc);
3. kernels: each kernel against its plain PyTorch twin on the card, on
   seeded inputs at main-path shapes (pad pairs and all three scatter
   layouts for the fill; kb up to 64 for the Schur step), with times;
4. small parity: ``slater.H_to_MPS`` on a W=4 cylinder (L=64, chi=128) on
   the card and on the CPU (twins): fidelity, spectra, charges;
5. full slice: ``slater.H_to_MPS`` on the W=8 cylinder of ``bench.py``
   config 1 (L=256, chi=512, float64), cold and warm, with the launch
   counts of both kernels, the stage profile, peak memory and checks;
   each kernel against its twin on the very inputs the conversion gave it
   (one group per shape; a group whose ill-conditioned sites part them by
   more than the float64 tolerance is held against an extended-precision
   evaluation); then the state brought into exact canonical form by the
   MPS engine;
3b. Pfaffian kernels: ``pf_fill`` and ``bdg_overlap`` against their twins on
   seeded inputs at main-path shapes (widths 4-32, all three scatter
   layouts, pad pairs; half sizes nb = 8, 32, 64 with both sweep layouts);
4b. small BdG parity: ``pfaffian.H_to_MPS`` on a p+ip W=4, Lx=8 cylinder
   (chi=64) on the card and on the CPU (twins);
6. BdG slice: ``pfaffian.C_to_MPS`` at ``bench.py`` config 5 (p+ip W=8,
   Lx=16, L=128, chi=256, basis "M"), cold and warm, with the launch counts
   of both Pfaffian kernels, the stage profile, peak memory, a NaN check,
   <n_i> and the centre site's <c^dag c> / <c c> rows against C, each
   kernel against its twin on the inputs the conversion gave it, and the
   state after ``canonical_form_finite``;
3c. large-L kernels: ``fw_frame_slab`` at L=1024 (B=64, Wb=512, both sides,
   every kind of pad, a short last slab), ``site_overlap_schur_gmem``
   (mb = 192, 320 in float64, 128 in complex128) and ``bdg_overlap_gmem``
   (nb = 96, 128) against their twins on seeded inputs;
4c. FW parity: ``slater.C_to_MPS`` at L=768 (W=8, chi=48) through the
   Fishman-White frontend on the card, against the card's exact frontend
   and against the CPU's FW conversion (twins);
4d. BdG past nb = 64: p+ip W=4, Lx=40 (L=160) on the card and the CPU;
7. the slice at L=1024: ``slater.H_to_MPS`` on bench config 1's cylinder at
   chi=512 through the FW frontend, with phase 5's checks and records, then
   one conversion with FW off for the frontend comparison.

Phases 5, 6 and 7 set their kernels' launch counts to 0 just before their
cold conversion and read them just after (4c and 4d check that theirs
launched).  The second-to-last line
is a JSON object with one record per kernel: its launches in its slice's
cold conversion, its worst absolute error against the twin over the seeded
and main-path checks, the kernel's and the twin's milliseconds summed over
one main-path group per shape, the least time the card could take for the
work of those groups (``bound_ms``: the larger of their operations at
FP64_PEAK and their bytes at HBM_RATE, computed from this run's inputs)
and the time of one PyTorch call computing the same function
(``library_ms``, null where none does).  The last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

import contextlib
import json
import os
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNEL_RTOL = 1e-12
"""Kernel vs twin: both run the same float64 pivoted elimination; only the
summation order of the overlap products differs (a few ulps), amplified by
the mild condition numbers of these inputs, so 1e-12 relative to the
largest entry leaves ~3 orders of margin and still catches any wrong
index, sign or pivot."""
EXT_FACTOR = 2.0
"""Where float64 rounding parts kernel and twin by more than KERNEL_RTOL
(ill-conditioned main-path sites), the kernel's error against an
extended-precision evaluation may be at most this multiple of the twin's:
both run the same pivoted elimination and differ only in rounding, so
neither should be systematically worse; 2 leaves room for the spread of a
maximum over a few thousand entries."""
FP64_PEAK = 67e12
"""FLOP/s: the H100 SXM data sheet's float64 tensor-core peak (dense), the
card's highest float64 rate, so a time derived from it is a lower bound."""
HBM_RATE = 3.35e12
"""bytes/s: the H100 SXM's device-memory rate (data sheet)."""
CMA_FLOP = 8
"""Real operations of one complex multiply-add (4 multiplies, 4 adds)."""
PARITY_TOL = 1e-10
"""GPU vs CPU conversion: cuSOLVER and LAPACK eigensolvers differ at
1e-15..1e-13 in the spectra; Schmidt values are products of up to ~10
mode weights, fidelities sums over chi^2 entries, so 1e-10 is the bound."""


FW_EXACT_TOL = 1e-6
"""Phase 4c, FW against the exact frontend at L=768: 1 - fidelity.  The
JAX package's test at this shape (tests/test_fw.py:126-148) asks for
1e-9, but the Schur-complement fill shared by both packages amplifies the
frontends' ~1e-11 frame difference through always blocks with |det| down
to 1e-48 on this chi=48 state (norm^2 2e-40): that test itself reads
1 - fidelity 1.4e-5 for the JAX package on the CPU, and this phase 2.5e-7
on an H100 (PERF.md, Findings), so the bound is 1e-6."""
CARD_KERNEL_TOL = 1e-5
"""Phase 4c, the card state with the kernels against the CPU's (twins,
one FW sweep): 1 - fidelity.  Kernel and twin round the same
ill-conditioned fill groups differently (every group is held against
extended precision), and the states then part by 1.0e-6 on an H100
(PERF.md, Findings); 1e-5 leaves a 10x margin."""
SLICE_BOUNDS = {"weighted_residual": 1e-2, "n": 3e-2}
"""Phase 7, bench config 1 at L=1024, chi=512: bounds on what the chi
truncation moves, set from the H100 reading of the FW state (centre
Schmidt-weighted residual 5.6e-3; normalised <n_i> 1.59e-2 off diag(C))
with a margin of 1.8-1.9x.  The FW-off state's <n_i> is held to the same
bound."""
FW_SPECTRA_TOL = 2e-8
"""Phase 7, FW against the exact frontend on bonds where both keep the
same count: squared Schmidt values.  The JAX package's FW contract, twice
the sweep's summed frozen-mode budget fw_total_tol (1e-8 at L <= 1024)."""
CLEAN_FW_TOL = 2e-2
"""Phase 7, FW against the exact frontend on bench config 1 itself:
1 - fidelity.  Its W=8 cylinder has degenerate Schmidt multiplets at the
chi=512 cut, which the two frontends keep or drop by a ~1e-12 difference
in their values; the states then part by 5.3e-3 on an H100 (PERF.md,
Findings).  The disordered twin of this check holds FW to FW_EXACT_TOL."""


TRUNCATION_BOUNDS = {"weighted_residual": 5e-5, "n": 1e-4, "cdc": 3e-3, "cc": 3e-3}
"""Phase 6, bench config 5 at chi=256: bounds on what the chi truncation
moves, set from the H100 reading (1.85e-5 centre-site Schmidt-weighted
canonicality residual; normalised <n_i> 5.6e-5 off C; the centre rows of
<c^dag c> and <c c> 1.5e-3 and 1.2e-3 off C) with a margin of 1.8-2.7x."""


def cylinder(W, L, t2=-1.3):
    """bench.py config-1 tight-binding cylinder (bench.py:269-288): width W,
    periodic around the circumference, axis hoppings alternating -1.0/t2,
    a -0.05 chemical potential.  t2=-1.3 is config 1; a strong
    dimerisation (t2=-0.2) keeps chi=128 from binding at W=4, L=64."""
    import numpy as np

    H = np.zeros((L, L))
    Lx = L // W

    def idx(x, y):
        return x * W + y % W

    for x in range(Lx):
        for y in range(W):
            if x + 1 < Lx:
                t = -1.0 if x % 2 == 0 else t2
                H[idx(x, y), idx(x + 1, y)] = H[idx(x + 1, y), idx(x, y)] = t
            if W > 1:
                H[idx(x, y), idx(x, y + 1)] = H[idx(x, y + 1), idx(x, y)] = -1.0
    return H - 0.05 * np.eye(L)


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn()`` on the current stream (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def rel_err(a, b):
    scale = max(float(b.abs().max()), 1e-300)
    return float((a - b).abs().max()) / scale, float((a - b).abs().max())


def timed(torch, fn):
    """(result, milliseconds) of one call of ``fn`` on the current stream."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


def det_fill_err(kernel, plain, args, kw):
    """(relative, absolute) error of the det_fill kernel against its twin."""
    return rel_err(kernel(*args, **kw), plain(*args, **kw))


def overlap_err(kernel, plain, args, kw):
    """(relative, absolute) error of a site_overlap_schur kernel against
    its twin: the worse of det(A) and det(A) * S, the product that enters
    the tensors (S alone carries the 1/det(A) of a near-singular block)."""
    d1, s1 = kernel(*args, **kw)
    d0, s0 = plain(*args, **kw)
    rel_d, ab_d = rel_err(d1, d0)
    rel_s, ab_s = rel_err(d1[:, None, None] * s1, d0[:, None, None] * s0)
    return max(rel_d, rel_s), max(ab_d, ab_s)


def phase_kernels(torch, kernels, testing):
    """Phase 3: kernels against twins on seeded inputs at main-path shapes.
    Returns the worst absolute error per kernel."""
    dev = torch.device("cuda")
    up = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    worst = {"det_fill": 0.0, "site_overlap_schur": 0.0}

    # K1 det_fill: w in {4, 8, 16, 32}, m=32, G=4; spec "rrc" with P=2^18
    # pairs, and spec "crr" with 212,144 pairs padded to 2^18, so that the
    # pad pairs land on the trash row (+ one c128 case)
    cases = [(w, "rrc", 2**18, "f8") for w in (4, 8, 16, 32)]
    cases += [(w, "crr", 212_144, "f8") for w in (4, 8, 16, 32)]
    cases += [(8, "rrc", 2**18, "c16")]
    for w, spec, P, dt in cases:
        args, kw = testing.random_det_fill_case(
            w, G=4, w=w, m=32, P=P, spec=spec,
            dtype={"f8": "float64", "c16": "complex128"}[dt])
        a = [up(x) for x in args[:6]] + [tuple(up(t) for t in args[6])]
        rel, ab = det_fill_err(kernels.det_fill, kernels.det_fill_plain, a, kw)
        if not rel <= KERNEL_RTOL:
            raise AssertionError(f"det_fill w={w} {spec} {dt}: rel err {rel:.3e} > {KERNEL_RTOL}")
        t_k = cuda_ms(lambda: kernels.det_fill(*a, **kw), 10)
        t_p = cuda_ms(lambda: kernels.det_fill_plain(*a, **kw), 2)
        print(f"phase 3: det_fill w={w} {spec} {dt} G=4 P={P} m=32: rel err {rel:.3e} "
              f"abs err {ab:.3e}; kernel {t_k:.3f} ms, plain {t_p:.3f} ms", flush=True)
        worst["det_fill"] = max(worst["det_fill"], ab)

    # K2 site_overlap_schur: L=256, G=64 sites, both modes, at the (kb, sb)
    # the main path gives it (kb=32 and 64 with sb=16 and 24) and kb=sb=32
    cases = [(kb, sb, mode, "f8") for kb, sb in ((32, 32), (32, 16), (32, 24), (64, 16), (64, 24))
             for mode in ("left", "right")]
    cases += [(32, 32, "right", "c16")]
    for kb, sb, mode, dt in cases:
        args, kw = testing.random_site_overlap_case(
            kb + sb, G=64, L=256, kb=kb, sb=sb, mode=mode,
            dtype={"f8": "float64", "c16": "complex128"}[dt])
        a = [up(x) for x in args]
        for i in (2, 3, 4, 6, 7, 8):
            a[i] = a[i].to(torch.int32)
        rel, ab = overlap_err(kernels.site_overlap_schur, kernels.site_overlap_schur_plain,
                              a, kw)
        if not rel <= KERNEL_RTOL:
            raise AssertionError(f"site_overlap_schur kb={kb} sb={sb} {mode} {dt}: "
                                 f"rel err {rel:.3e} > {KERNEL_RTOL}")
        t_k = cuda_ms(lambda: kernels.site_overlap_schur(*a, **kw), 10)
        t_p = cuda_ms(lambda: kernels.site_overlap_schur_plain(*a, **kw), 3)
        print(f"phase 3: site_overlap_schur {mode} {dt} G=64 L=256 kb={kb} sb={sb}: rel err "
              f"{rel:.3e}; kernel {t_k:.3f} ms, plain {t_p:.3f} ms", flush=True)
        worst["site_overlap_schur"] = max(worst["site_overlap_schur"], ab)
    return worst


def _lu_det_ld(A):
    """Determinants of an (n, w, w) numpy batch by LU with partial pivoting,
    in the batch's own (extended) precision."""
    import numpy as np

    A = A.copy()
    n, w, _ = A.shape
    ar = np.arange(n)
    det = np.ones(n, A.dtype)
    for k in range(w):
        p = k + np.argmax(np.abs(A[:, k:, k]), axis=1)
        row_k = A[ar, k].copy()
        A[ar, k] = A[ar, p]
        A[ar, p] = row_k
        det = np.where(p != k, -det, det)
        piv = A[:, k, k]
        det = det * piv
        f = A[:, k + 1:, k] / np.where(piv == 0, 1, piv)[:, None]
        A[:, k + 1:, :] -= f[:, :, None] * A[:, k:k + 1, :]
    return det


def _ld(t):
    """A CUDA tensor as a numpy array in x87 extended precision (64-bit
    mantissa, 11 more bits than float64)."""
    import numpy as np

    a = t.cpu().numpy()
    return a.astype(np.clongdouble if np.iscomplexobj(a) else np.longdouble)


def det_fill_ext(torch, kernels, args, kw, n_sites=4, n_pairs=4096):
    """Kernel and twin of det_fill held against an extended-precision
    evaluation of the same determinants, on the group's worst sites (by
    kernel-twin difference) and their n_pairs most discrepant real pairs.
    Returns (kernel error, twin error, scale, min |det_always| there)."""
    import numpy as np

    M, det, ob, ok, pr, pc, tabs = args
    spec, shape = kw["spec"], kw["shape"]
    K = kernels.det_fill(*args, **kw)
    T = kernels.det_fill_plain(*args, **kw)
    per_site = (K - T).abs().flatten(1).amax(1)
    sites = torch.argsort(per_site, descending=True)[:n_sites].tolist()
    e_k = e_t = scale = 0.0
    m, w = M.shape[-1], ob.shape[-1]
    for g in sites:
        r, c = pr[g].long(), pc[g].long()
        ids = {"r": r, "c": c}
        coords = tuple(tabs[i][g][ids[s]].long() for i, s in enumerate(spec))
        real = coords[0] < shape[0]  # pad pairs point at the trash row
        coords = tuple(x[real] for x in coords)
        kv, tv = K[g][coords], T[g][coords]
        pick = torch.argsort((kv - tv).abs(), descending=True)[:n_pairs]
        Ma = np.eye(m + w, dtype=_ld(M[g]).dtype)
        Ma[:m, :m] = _ld(M[g])
        rows = ob[g][r[real][pick]].cpu().numpy()
        cols = ok[g][c[real][pick]].cpu().numpy()
        ref = _lu_det_ld(Ma[rows[:, :, None], cols[:, None, :]]) * _ld(det[g])
        e_k = max(e_k, float(np.abs(_ld(kv[pick]) - ref).max()))
        e_t = max(e_t, float(np.abs(_ld(tv[pick]) - ref).max()))
        scale = max(scale, float(T[g].abs().max()))
    return e_k, e_t, scale, float(det[sites].abs().min())


def overlap_ext(torch, kernels, args, kw, n_sites=8):
    """Kernel and twin of site_overlap_schur held against an
    extended-precision evaluation (overlap and Gauss-Jordan) of det(A) and
    det(A) * S on the group's worst sites.  Returns (kernel error, twin
    error, scale, min |det(A)| there)."""
    import numpy as np

    kb, mode = kw["kb"], kw["mode"]
    d1, s1 = kernels.site_overlap_schur(*args, **kw)
    d0, s0 = kernels.site_overlap_schur_plain(*args, **kw)
    p1, p0 = d1[:, None, None] * s1, d0[:, None, None] * s0
    per_site = torch.maximum((p1 - p0).abs().flatten(1).amax(1), (d1 - d0).abs())
    sites = torch.argsort(per_site, descending=True)[:n_sites]
    fb, fk, colb, kindb, rowb, signb, colk, kindk, rowk, signk = (_ld(a[sites]) for a in args)
    L = fb.shape[1]

    def build(fr, col, kind, row, sign):
        g = np.take_along_axis(fr, col.astype(int)[:, None, :].repeat(L, 1), 2)
        oh = (np.arange(L)[None, :, None] == row.astype(int)[:, None, :]).astype(fr.dtype)
        kind = kind[:, None, :]
        return np.where(kind == 0, g, np.where(kind == 1, oh, 0)) * sign[:, None, :]

    O = np.einsum("gla,glb->gab", build(fb, colb, kindb, rowb, signb).conj(),
                  build(fk, colk, kindk, rowk, signk))
    if mode == "right":  # the always block trails: rotate it to the front
        O = np.roll(O, (kb, kb), axis=(1, 2))
    # Gauss-Jordan with partial pivoting on [A | B], as the twin runs it
    AB = O[:, :kb, :].copy()
    ar = np.arange(len(O))
    dA = np.ones(len(O), O.dtype)
    for j in range(kb):
        p = j + np.argmax(np.abs(AB[:, j:, j]), axis=1)
        row_j = AB[ar, j].copy()
        AB[ar, j] = AB[ar, p]
        AB[ar, p] = row_j
        dA = np.where(p != j, -dA, dA)
        piv = AB[:, j, j]
        dA = dA * piv
        row = AB[:, j] / np.where(piv == 0, 1, piv)[:, None]
        f = AB[:, :, j].copy()
        f[:, j] = 0
        AB -= f[:, :, None] * row[:, None, :]
        AB[:, j] = row
    ref = dA[:, None, None] * (O[:, kb:, kb:] - O[:, kb:, :kb] @ AB[:, :, kb:])
    e_k = max(float(np.abs(_ld(p1[sites]) - ref).max()), float(np.abs(_ld(d1[sites]) - dA).max()))
    e_t = max(float(np.abs(_ld(p0[sites]) - ref).max()), float(np.abs(_ld(d0[sites]) - dA).max()))
    scale = max(float(np.abs(ref).max()), float(np.abs(dA).max()))
    return e_k, e_t, scale, float(np.abs(dA).min())


def nbytes(*ts):
    """Bytes of tensors (nested tuples allowed)."""
    return sum(nbytes(*t) if isinstance(t, (tuple, list)) else t.numel() * t.element_size()
               for t in ts)


def bound_ms(flops, nbyte):
    """(milliseconds, what bounds it): the least time the card could take to
    do ``flops`` float64 operations and move ``nbyte`` bytes."""
    t_op, t_by = flops / FP64_PEAK, nbyte / HBM_RATE
    return max(t_op, t_by) * 1e3, ("operations" if t_op >= t_by else "bytes")


def det_fill_cost(torch, args, kw, out):
    """(operations, bytes) of one det_fill group: an LU of the c x c block
    each pair needs (c = its occupied orbitals; sentinels add nothing),
    2c^3/3 real operations (x4 complex); every input and the output once."""
    M, det, ob, ok, pr, pc, tabs = args
    cnt = (ob < M.shape[-1]).sum(-1)
    c = torch.gather(cnt, 1, pr.long()).double()
    mult = 4 if M.is_complex() else 1
    return float((2.0 / 3.0 * c**3).sum()) * mult, nbytes(*args, out)


def overlap_cost(torch, args, kw, out):
    """(operations, bytes) of one site_overlap_schur group: O = vb^H vk
    (L mb^2 multiply-adds), Gauss-Jordan on [A | B] (kb^2 mb) and the Schur
    product (sb^2 kb) per site, 2 real operations each (x4 complex)."""
    fb, colb, kb = args[0], args[2], kw["kb"]
    G, L, _ = fb.shape
    mb = colb.shape[-1]
    sb = mb - kb
    mult = 4 if fb.is_complex() else 1
    return 2.0 * G * (L * mb * mb + kb * kb * mb + sb * sb * kb) * mult, nbytes(*args, *out)


def det_fill_library_ms(torch, args):
    """Milliseconds of torch.linalg.det on the group's pre-gathered (P_b, w,
    w) batches, one call per site, summed; the gather and the scatter are
    left out."""
    from temfpy_torch.ops.linalg import block_diag_identity_pad, gather_submatrices

    M, _det, ob, ok, pr, pc, _tabs = args
    w, total = ob.shape[-1], 0.0
    for g in range(M.shape[0]):
        sub = gather_submatrices(block_diag_identity_pad(M[g], w), ob[g][pr[g].long()],
                                 ok[g][pc[g].long()])
        total += timed(torch, lambda: torch.linalg.det(sub))[1]
    return total


CAPTURED = {
    # record name: (kernel, twin, error, extended-precision check, cost)
    "det_fill": ("det_fill", "det_fill_plain", det_fill_err, det_fill_ext, det_fill_cost),
    "site_overlap_schur": ("site_overlap_schur", "site_overlap_schur_plain", overlap_err,
                           overlap_ext, overlap_cost),
    "site_overlap_schur_gmem": ("site_overlap_schur_gmem", "site_overlap_schur_plain",
                                overlap_err, overlap_ext, overlap_cost),
}


def hold(torch, kernels, label, name, key, args, kw):
    """One main-path group of kernel ``name`` against its twin.

    Where a group's sites are ill-conditioned (a near-singular always block
    makes the sometimes matrix large and its small determinants cancel),
    float64 rounding alone parts kernel (fused multiply-adds) and twin
    (separate multiply and subtract) by more than KERNEL_RTOL.  Such a group
    is held, on its worst sites, against an extended-precision evaluation:
    the kernel passes if its error there is at most EXT_FACTOR times the
    twin's, or within KERNEL_RTOL of the largest entry.  Returns the
    (relative, absolute) kernel-twin difference."""
    kname, pname, err, ext, _cost = CAPTURED[name]
    kernel, plain = getattr(kernels, kname), getattr(kernels, pname)
    rel, ab = err(kernel, plain, args, kw)
    if not rel <= KERNEL_RTOL:
        e_k, e_t, scale, dmin = ext(torch, kernels, args, kw)
        print(f"{label}: {name} {key}: kernel-twin rel err {rel:.3e} > {KERNEL_RTOL}; "
              f"against extended precision on the worst sites (min |det_always| "
              f"{dmin:.3e}): kernel {e_k:.3e}, twin {e_t:.3e} (largest entry "
              f"{scale:.3e})", flush=True)
        if not (e_k <= EXT_FACTOR * e_t or e_k <= KERNEL_RTOL * scale):
            raise AssertionError(f"{name} {key}: kernel error {e_k:.3e} against extended "
                                 f"precision exceeds {EXT_FACTOR} x the twin's {e_t:.3e}")
    return rel, ab


def phase_captured(torch, kernels, label, groups_by_name):
    """Phases 5b and 7: each kernel against its twin (:func:`hold`) on the
    exact inputs the main path gave it, one group per (w, spec, P_b) and
    per (kb, mb, mode).  Returns, per kernel, the worst absolute
    kernel-twin difference and the summed kernel and twin milliseconds
    over the groups."""
    rec = {}
    for name, groups in groups_by_name.items():
        kname, pname, _err, _ext, cost = CAPTURED[name]
        kernel, plain = getattr(kernels, kname), getattr(kernels, pname)
        ms = plain_ms = worst = lib_ms = bnd = flops = nbyte = 0.0
        for key, (args, kw) in sorted(groups.items()):
            rel, ab = hold(torch, kernels, label, name, key, args, kw)
            out, t_k = timed(torch, lambda: kernel(*args, **kw))
            _, t_p = timed(torch, lambda: plain(*args, **kw))
            f, b = cost(torch, args, kw, out)
            t_b, _ = bound_ms(f, b)
            print(f"{label}: {name} {key} G={args[0].shape[0]}: rel err {rel:.3e}; "
                  f"kernel {t_k:.3f} ms, plain {t_p:.3f} ms, bound {t_b:.4f} ms", flush=True)
            ms, plain_ms, worst = ms + t_k, plain_ms + t_p, max(worst, ab)
            bnd, flops, nbyte = bnd + t_b, flops + f, nbyte + b
            if name == "det_fill":
                lib_ms += det_fill_library_ms(torch, args)
        by = bound_ms(flops, nbyte)[1]
        print(f"{label}: {name} on {len(groups)} main-path groups: kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms, bound {bnd:.4f} ms ({by}; {flops:.3e} operations, "
              f"{nbyte:.3e} bytes)"
              + (f", torch.linalg.det on the gathered batches {lib_ms:.3f} ms"
                 if name == "det_fill" else ""), flush=True)
        rec[name] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
                     "bound_by": by, "library_ms": lib_ms if name == "det_fill" else None}
    return rec


def phase_parity(torch, np, slater):
    """Phase 4: the same conversion on the card and on the CPU."""
    H = cylinder(4, 64, t2=-0.2)
    tp = {"chi_max": 128}
    t0 = time.perf_counter()
    gpu = slater.H_to_MPS(H, tp, device="cuda")
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = slater.H_to_MPS(H, tp, device="cpu")
    t_cpu = time.perf_counter() - t0
    fid = abs(gpu.overlap(cpu)) / np.sqrt(gpu.norm_squared() * cpu.norm_squared())
    if not fid >= 1 - PARITY_TOL:
        raise AssertionError(f"GPU/CPU fidelity {fid!r} < 1 - {PARITY_TOL}")
    worst = 0.0
    for b in range(1, gpu.L):
        qg, qc = gpu.q_bond[b], cpu.q_bond[b]
        if not np.array_equal(qg, qc):
            raise AssertionError(f"bond {b}: charges differ between GPU and CPU")
        for q in np.unique(qg):
            sg = np.sort(gpu.get_SL(b)[qg == q])
            sc = np.sort(cpu.get_SL(b)[qc == q])
            worst = max(worst, float(np.abs(sg - sc).max()))
    if not worst <= PARITY_TOL:
        raise AssertionError(f"Schmidt spectra differ by {worst:.3e} > {PARITY_TOL}")
    print(f"phase 4: W=4 L=64 chi=128 (chi_max {gpu.chi_max}): 1 - fidelity {1 - fid:.3e}, "
          f"max spectrum diff {worst:.3e}, charges identical; gpu {t_gpu:.2f} s, "
          f"cpu {t_cpu:.2f} s", flush=True)


def canonical_residuals(torch, mps, i):
    """(unweighted, Schmidt-weighted) residual of site i's canonical form,
    with the conjugate: A sites sum_n A^H A = I, B sites sum_n B B^H = I;
    the weighted form is bench.py's audit (bench.py:351-367)."""
    T = mps._B[i]
    if mps.form[i] == "A":
        g = torch.einsum("anb,anc->bc", T.conj(), T)
        w = torch.as_tensor(mps.get_SR(i), device=T.device)
    else:
        g = torch.einsum("anb,cnb->ac", T, T.conj())
        w = torch.as_tensor(mps.get_SL(i), device=T.device)
    r = g - torch.eye(g.shape[0], dtype=g.dtype, device=g.device)
    return float(r.abs().max()), float(torch.linalg.norm(w[:, None] * r * w[None, :]))


@contextlib.contextmanager
def slater_capture(slater, fw, every=False):
    """Wraps the Slater path's kernel entry points for the duration: each
    call goes through, and the inputs of the first group per shape are kept
    (``fills`` per (w, spec, P_b), ``overlaps`` per (kb, mb, mode),
    ``slabs`` per (side, kb, keb, fb, Wb)), with sites per (w, P_b) in
    ``widths`` and per (kb, mb) in ``kbs``.  With ``every``, each det_fill
    and site_overlap_schur group is also kept in ``every`` as (kernel,
    shape key, (args, kw))."""
    cap = {"widths": Counter(), "kbs": Counter(), "fills": {}, "overlaps": {}, "slabs": {},
           "every": []}
    fill, overlap, slab = slater.det_fill, slater.site_overlap_schur, fw.fw_frame_slab

    def keep(kind, name, key, group):
        cap[kind].setdefault(key, group)
        if every:
            cap["every"].append((name, key, group))

    def fill_rec(M, det, ob, ok, pr, pc, tabs, **kw):
        cap["widths"][(ob.shape[-1], pr.shape[-1])] += M.shape[0]
        keep("fills", "det_fill", (ob.shape[-1], kw["spec"], pr.shape[-1]),
             ((M, det, ob, ok, pr, pc, tabs), kw))
        return fill(M, det, ob, ok, pr, pc, tabs, **kw)

    def overlap_rec(fb, fk, colb, *a, kb, mode):
        cap["kbs"][(kb, colb.shape[-1])] += fb.shape[0]
        keep("overlaps", "site_overlap_schur", (kb, colb.shape[-1], mode),
             ((fb, fk, colb, *a), {"kb": kb, "mode": mode}))
        return overlap(fb, fk, colb, *a, kb=kb, mode=mode)

    def slab_rec(VT, flat, Cmat, **kw):
        cap["slabs"].setdefault((kw["side"], kw["kb"], Cmat.shape[-1], kw["fb"], kw["Wb"]),
                                ((VT, flat, Cmat), kw))
        return slab(VT, flat, Cmat, **kw)

    slater.det_fill, slater.site_overlap_schur, fw.fw_frame_slab = fill_rec, overlap_rec, slab_rec
    try:
        yield cap
    finally:
        slater.det_fill, slater.site_overlap_schur, fw.fw_frame_slab = fill, overlap, slab


def check_captured_slater(torch, kernels, label, cap):
    """Every Slater kernel against its twin on the groups ``slater_capture``
    kept (overlap groups split by the kernel their width takes); returns
    the records."""
    overlaps = cap["overlaps"]
    groups = {"det_fill": cap["fills"]}
    if overlaps:
        dtype = next(iter(overlaps.values()))[0][0].dtype
        fits = {k: v for k, v in overlaps.items() if kernels.site_overlap_fits_smem(k[1], dtype)}
        groups["site_overlap_schur"] = fits
        if len(fits) < len(overlaps):
            groups["site_overlap_schur_gmem"] = {k: v for k, v in overlaps.items()
                                                 if k not in fits}
    rec = phase_captured(torch, kernels, label, groups)
    if cap["slabs"]:
        rec["fw_frame_slab"] = fw_captured(torch, kernels, label, cap["slabs"])
    return rec


def slater_slice(torch, np, slater, fw, kernels, profiling, H, chi, label, counted,
                 bounds=None):
    """Phases 5 and 7: ``slater.H_to_MPS`` of H at ``chi`` on the card, cold
    (the launch counts of ``counted`` set to 0 just before and read just
    after) and warm (stage profile, the kernels' input shapes, and the
    inputs of one group per shape, held against the twins); then the
    checks of :func:`check_slater_state` and a device profile.  The FW
    cache is cleared before each conversion, so each runs its own sweep.
    Returns (launches, records, the warm run's state as converted)."""
    L = H.shape[0]
    tp = {"chi_max": chi}

    def run():
        fw.fw_clear_cache()
        return slater.H_to_MPS(H, tp, device="cuda")

    torch.cuda.reset_peak_memory_stats()
    for name in counted:
        getattr(kernels, name).launches = 0
    t0 = time.perf_counter()
    mps = run()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches = {name: getattr(kernels, name).launches for name in counted}
    print(f"{label}: cold conversion {cold:.3f} s; launches {launches}", flush=True)
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched by the main path")
    if "fw_frame_slab" in counted and fw._CACHE[-1][1] is None:
        raise AssertionError(f"{label}: the FW sweep fell back to the exact frontend")

    # warm run: stage profile, the shapes the kernels were given, and the
    # inputs of the first group of each shape
    torch.cuda.reset_peak_memory_stats()
    with slater_capture(slater, fw) as cap, profiling.collect() as prof:
        t0 = time.perf_counter()
        raw = run()
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
    widths, kbs = cap["widths"], cap["kbs"]
    peak = torch.cuda.max_memory_allocated()
    print(f"{label}: warm conversion {warm:.3f} s (stages synchronised); "
          f"max_memory_allocated {peak / 2**20:.1f} MiB", flush=True)
    print(prof.report(), flush=True)
    pairs = Counter()
    for (w, P_b), g in widths.items():
        pairs[w] += P_b * g
    print(f"{label}: det_fill (w, P_b) -> sites:", dict(sorted(widths.items())), flush=True)
    print(f"{label}: padded pairs per width:", dict(sorted(pairs.items())),
          f"total {sum(pairs.values())}", flush=True)
    print(f"{label}: site_overlap_schur (kb, mb) -> sites:", dict(sorted(kbs.items())),
          flush=True)
    rec = check_captured_slater(torch, kernels, label, cap)
    check_slater_state(torch, np, slater, mps, H, chi, label, bounds)
    device_profile(torch, run, label)
    return launches, rec, raw


def check_slater_state(torch, np, slater, mps, H, chi, label, bounds):
    """The exact parts of a Slater MPS: chi, normalised Schmidt values,
    label and tensor dimensions, finite tensors, charge conservation, edge
    canonicality (sites 0 and L-1), sum <n_i> = N, and exact canonicality
    after ``canonical_form_finite`` at sites 0, L/2, L-1 with the state
    unchanged.  The chi truncation's effects (the centre's Schmidt-weighted
    residual, <n_i> against C) are printed, and held to ``bounds`` where
    given."""
    L = H.shape[0]
    if mps.chi_max != chi:
        raise AssertionError(f"chi_max {mps.chi_max} != {chi}")
    for b in range(L + 1):
        S = mps.get_SL(b)
        if not abs(np.linalg.norm(S) - 1) <= 1e-12:
            raise AssertionError(f"Schmidt values on bond {b} not normalised")
        if len(mps.q_bond[b]) != mps.chi(b) or len(S) != mps.chi(b):
            raise AssertionError(f"bond {b}: label/Schmidt/tensor dimensions differ")
    for i in range(L):
        T = mps._B[i]
        if not bool(torch.isfinite(T).all()):
            raise AssertionError(f"tensor {i} has non-finite entries")
        qL = torch.as_tensor(mps.q_bond[i], device=T.device)[:, None, None]
        qp = torch.as_tensor(mps.sites[i].charges, device=T.device)[None, :, None]
        qR = torch.as_tensor(mps.q_bond[i + 1], device=T.device)[None, None, :]
        bad = (qL + qp - qR) != int(mps.qtotal[i])
        if float((T.abs() * bad).max()) > 1e-12 * float(T.abs().max()):
            raise AssertionError(f"tensor {i} violates charge conservation")
    res = {i: canonical_residuals(torch, mps, i) for i in (0, L // 2, L - 1)}
    print(f"{label}: canonicality residual (unweighted, Schmidt-weighted) at sites",
          {i: f"{u:.3e}, {w:.3e}" for i, (u, w) in res.items()}, flush=True)
    for i in (0, L - 1):
        if not res[i][0] <= 1e-10:
            raise AssertionError(f"site {i}: canonicality residual {res[i][0]:.3e} > 1e-10")
    # the centre bond is chi-truncated, so the unweighted residual is O(1)
    # by construction; its Schmidt-weighted residual measures the
    # truncation (the JAX package's audit gave 1.7e-3 on bench config 1)
    if bounds and not res[L // 2][1] <= bounds["weighted_residual"]:
        raise AssertionError(f"site {L // 2}: weighted residual {res[L // 2][1]:.3e} > "
                             f"{bounds['weighted_residual']}")
    C, N = slater.correlation_matrix(H, device="cuda")
    nrm = mps.norm_squared()
    n = mps.expectation_value("N").real / nrm
    dev = float(np.abs(n - C.diagonal().cpu().numpy()).max())
    print(f"{label}: <psi|psi> = {nrm:.6e} (chi-truncated MPS); sum <n_i> = {n.sum():.10f} "
          f"(N={N}); max |<n_i> - C_ii| {dev:.3e}", flush=True)
    # every tensor conserves particle number, so the total is exact; the
    # per-site densities carry the chi truncation
    if not abs(n.sum() - N) <= 1e-8:
        raise AssertionError(f"sum of <n_i> = {n.sum()!r} != N = {N}")
    if bounds and not dev <= bounds["n"]:
        raise AssertionError(f"<n_i> deviates from diag(C) by {dev:.3e} > {bounds['n']}")

    # the same state brought into exact right-canonical form by the MPS
    # engine (charged QR and SVD sweeps, no truncation): every site then
    # meets sum_n B B^H = I, and the densities must not move
    t0 = time.perf_counter()
    mps.canonical_form_finite()
    torch.cuda.synchronize()
    t_canon = time.perf_counter() - t0
    res = {i: canonical_residuals(torch, mps, i)[0] for i in (0, L // 2, L - 1)}
    n_canon = mps.expectation_value("N").real
    moved = float(np.abs(n_canon - n).max())
    print(f"{label}: canonical_form_finite {t_canon:.3f} s, chi_max {mps.chi_max}; residual "
          f"at sites {({i: f'{r:.3e}' for i, r in res.items()})}; <psi|psi> - 1 = "
          f"{mps.norm_squared() - 1:.3e}; max |<n_i> change| {moved:.3e}", flush=True)
    for i, r in res.items():
        if not r <= 1e-10:
            raise AssertionError(f"site {i}: residual {r:.3e} > 1e-10 after canonical_form_finite")
    if not (abs(mps.norm_squared() - 1) <= 1e-10 and moved <= 1e-10):
        raise AssertionError("canonical_form_finite changed the state")


def phase_full(torch, np, slater, fw, kernels, profiling):
    """Phase 5: bench config 1 at L=256, chi=512 (the exact frontend: L is
    below the FW threshold).  The per-site densities carry the chi
    truncation: 7.0e-3 on this state on the H100, so their bound is 1e-2,
    as is the centre's Schmidt-weighted residual's (1.7e-3 measured)."""
    launches, rec, _raw = slater_slice(
        torch, np, slater, fw, kernels, profiling, cylinder(8, 256), 512, "phase 5",
        ("det_fill", "site_overlap_schur"), bounds={"weighted_residual": 1e-2, "n": 1e-2})
    return launches, rec


def device_profile(torch, run, label):
    """One more warm conversion under torch.profiler: device busy time by
    kernel against the wall time (what the stage profile cannot see)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side activities only (kernels, copies, memsets); the profiler's
    # own buffer activities are left out
    per_name: dict = {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA or ev.name in (
                "Buffer Flush", "Activity Buffer Request"):
            continue
        us, n = per_name.get(ev.name, (0.0, 0))
        per_name[ev.name] = (us + ev.device_time_total, n + 1)
    rows = [(us, name, n) for name, (us, n) in per_name.items()]
    busy = sum(r[0] for r in rows) / 1e6
    print(f"{label}: profiled conversion {wall:.3f} s wall, device busy {busy:.3f} s "
          f"(sum of kernel and copy times; idle share {1 - busy / wall:.1%})", flush=True)
    for us, key, count in sorted(rows, reverse=True)[:8]:
        print(f"  {us / 1e3:10.2f} ms  x{count:<6d} {key[:90]}", flush=True)
    for kernel in ("det_fill_kernel", "site_overlap_schur_kernel",
                   "site_overlap_schur_gmem_kernel", "fw_frame_slab_kernel", "pf_fill_kernel",
                   "bdg_overlap_kernel", "bdg_overlap_gmem_kernel"):
        hits = [(us, n) for us, name, n in rows if kernel in name]
        if hits:
            print(f"{label}: {kernel} device time in the conversion "
                  f"{sum(h[0] for h in hits) / 1e3:.3f} ms in {sum(h[1] for h in hits)} launches",
                  flush=True)


# --------------------------------------------------------------------------
# BdG / Pfaffian slice
# --------------------------------------------------------------------------


def pf_fill_cost(torch, args, kw, out):
    """(operations, bytes) of one pf_fill group: per pair of tot = nk + nb
    excitations, Parlett-Reid updates sum_k (tot - k - 2)^2 trailing
    entries (k = 0, 2, ...), each two complex multiply-adds; pad pairs need
    nothing.  Every input and the output once."""
    N, norm, pb, pk, cb, ck, pr, pc, tabs = args
    t = (torch.gather(cb, 1, pr.long()) + torch.gather(ck, 1, pc.long())).double() / 2
    entries = 4 * (t - 1).clamp(min=0) * t * (2 * t - 1) / 6
    return float(entries.sum()) * 2 * CMA_FLOP, nbytes(*args, out)


def bdg_overlap_cost(np, args, out, k1, k2):
    """(operations, bytes) of one bdg_overlap group: what the function
    needs, not what the kernel does.  Per site, with k1/k2 its real active
    counts (not their buckets), complex multiply-adds for the blocks U*
    (nb^2 2nb), Vr[j1, nb:] and Vr[nb:, j2] ((k1 + k2) nb 2nb), an LU of U*
    (nb^3 / 3) with the k1 column and k2 row solves of U*^-1 that AA, BA
    and BB read ((k1 + k2) nb^2), and the off-diagonal entries of AA and BB
    (k (k - 1) nb each; the kernel computes each twice).  Inputs and
    outputs once."""
    nb = args[0].shape[-1]
    k1, k2 = np.asarray(k1, float), np.asarray(k2, float)
    cma = (2 * nb**3 + (k1 + k2) * 2 * nb * nb + nb**3 / 3 + (k1 + k2) * nb * nb
           + (k1 * (k1 - 1) + k2 * (k2 - 1)) * nb)
    return float(cma.sum()) * CMA_FLOP, nbytes(*args, *out)


def pf_err(torch, kernels, args, kw):
    got, ref = kernels.pf_fill(*args, **kw), kernels.pf_fill_plain(*args, **kw)
    return rel_err(got, ref)


def bdg_err(torch, kernels, args, kw):
    """Worse of N and norm, kernel against twin (NaN norms must agree)."""
    (N1, n1), (N0, n0) = kernels.bdg_overlap(*args), kernels.bdg_overlap_plain(*args)
    if not torch.equal(torch.isnan(n1), torch.isnan(n0)):
        return float("inf"), float("inf")
    ok = ~torch.isnan(n0)
    rel_N, ab_N = rel_err(N1[ok], N0[ok]) if bool(ok.any()) else (0.0, 0.0)
    rel_n, ab_n = rel_err(n1[ok], n0[ok]) if bool(ok.any()) else (0.0, 0.0)
    return max(rel_N, rel_n), max(ab_N, ab_n)


def bdg_recorders(pfaffian, overlaps, active, nbs):
    """Wrappers of ``pfaffian.bdg_overlap`` and ``pfaffian._overlap_group``
    that keep the inputs of the first group per (nb, k1_b, k2_b) in
    ``overlaps``, count its sites in ``nbs`` and each site's real active
    counts k1, k2 in ``active``; they call the wrapped functions."""
    overlap, group = pfaffian.bdg_overlap, pfaffian._overlap_group

    def group_rec(plans, device):
        # each site's real active counts, from its N-slot sets
        # [ket (k2_b) | bra (k1_b)] (every real slot is used by some set)
        k2_b = len(plans[0]["j2"])
        active.setdefault(
            (plans[0]["frames"][0].shape[-1], len(plans[0]["j1"]), k2_b),
            ([int(p["fields"]["sets_bra"][:, k2_b:].any(0).sum()) for p in plans],
             [int(p["fields"]["sets_ket"][:, :k2_b].any(0).sum()) for p in plans]))
        return group(plans, device)

    def overlap_rec(*a):
        nbs[(a[0].shape[-1], a[2].shape[-1], a[3].shape[-1])] += a[0].shape[0]
        overlaps.setdefault((a[0].shape[-1], a[2].shape[-1], a[3].shape[-1]), (a, {}))
        return overlap(*a)

    return overlap_rec, group_rec


PF_RECORDS = {
    # record name: (kernel, twin, error, cost)
    "pf_fill": ("pf_fill", "pf_fill_plain", pf_err,
                lambda torch, np, a, kw, out, act: pf_fill_cost(torch, a, kw, out)),
    "bdg_overlap": ("bdg_overlap", "bdg_overlap_plain", bdg_err,
                    lambda torch, np, a, kw, out, act: bdg_overlap_cost(np, a, out, *act)),
    "bdg_overlap_gmem": ("bdg_overlap_gmem", "bdg_overlap_plain", bdg_err,
                         lambda torch, np, a, kw, out, act: bdg_overlap_cost(np, a, out, *act)),
}


def pf_records(torch, np, kernels, label, name, groups, active, failures):
    """The record of one BdG kernel over captured main-path groups: each
    group against the twin (a miss is appended to ``failures``), the
    kernel's and the twin's milliseconds, and the bound."""
    kname, pname, err, cost = PF_RECORDS[name]
    kernel, plain = getattr(kernels, kname), getattr(kernels, pname)
    ms = plain_ms = worst = bnd = flops = nbyte = 0.0
    for key, (args, kw) in sorted(groups.items()):
        rel, ab = err(torch, kernels, args, kw)
        out, t_k = timed(torch, lambda: kernel(*args, **kw))
        _, t_p = timed(torch, lambda: plain(*args, **kw))
        f, b = cost(torch, np, args, kw, out, active.get(key))
        t_b, _ = bound_ms(f, b)
        print(f"{label}: {name} {key} G={args[0].shape[0]}: rel err {rel:.3e} abs err "
              f"{ab:.3e}; kernel {t_k:.3f} ms, plain {t_p:.3f} ms, bound {t_b:.4f} ms",
              flush=True)
        if not rel <= KERNEL_RTOL:
            failures.append(f"{name} {key}: rel err {rel:.3e} > {KERNEL_RTOL}")
        ms, plain_ms, worst = ms + t_k, plain_ms + t_p, max(worst, ab)
        bnd, flops, nbyte = bnd + t_b, flops + f, nbyte + b
    by = bound_ms(flops, nbyte)[1]
    print(f"{label}: {name} on {len(groups)} main-path groups: kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bnd:.4f} ms ({by}; {flops:.3e} operations, "
          f"{nbyte:.3e} bytes)", flush=True)
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
            "bound_by": by, "library_ms": None}


def phase_pf_kernels(torch, kernels, testing):
    """Phase 3b: the Pfaffian kernels against their twins on seeded inputs
    at main-path shapes.  Returns the worst absolute error per kernel."""
    dev = torch.device("cuda")
    worst = {"pf_fill": 0.0, "bdg_overlap": 0.0}
    # K3 pf_fill: widths of the main path (4..16) and 32, the three layouts,
    # 60,000 real pairs padded to P_b = 65,536 (pad pairs reach the trash
    # row), G=4 sites, m = 2w (bench config 5 has m <= 48)
    cases = [(w, spec) for w in (4, 8, 12, 16) for spec in ("rc", "rrc", "crr")] + [(32, "rrc")]
    for w, spec in cases:
        args, kw = testing.random_pf_fill_case(w, G=4, w=w, m=max(2 * w, 16), P=60_000,
                                               spec=spec, n_rows=400)
        a = [torch.as_tensor(x, device=dev) for x in args[:8]]
        a.append(tuple(torch.as_tensor(t, device=dev) for t in args[8]))
        rel, ab = pf_err(torch, kernels, a, kw)
        if not rel <= KERNEL_RTOL:
            raise AssertionError(f"pf_fill w={w} {spec}: rel err {rel:.3e} > {KERNEL_RTOL}")
        t_k = cuda_ms(lambda: kernels.pf_fill(*a, **kw), 10)
        t_p = cuda_ms(lambda: kernels.pf_fill_plain(*a, **kw), 2)
        print(f"phase 3b: pf_fill w={w} {spec} G=4 P=60000 (P_b 65536): rel err {rel:.3e} "
              f"abs err {ab:.3e}; kernel {t_k:.3f} ms, plain {t_p:.3f} ms", flush=True)
        worst["pf_fill"] = max(worst["pf_fill"], ab)
    # K4 bdg_overlap: nb = 8, 32, 64 (the buckets of bench config 5) with
    # the active-mode layouts of both sweep modes, G = 64 sites
    for nb, k1, k2, x in ((8, 8, 8, 6), (32, 16, 16, 30), (64, 24, 24, 63), (64, 24, 16, 40)):
        for mode in ("left", "right"):
            a = [torch.as_tensor(v, device=dev) for v in testing.random_bdg_overlap_case(
                nb + k1, G=64, nb=nb, k1=k1, k2=k2, x=x, mode=mode)]
            rel, ab = bdg_err(torch, kernels, a, {})
            if not rel <= KERNEL_RTOL:
                raise AssertionError(f"bdg_overlap nb={nb} {mode}: rel err {rel:.3e} > "
                                     f"{KERNEL_RTOL}")
            t_k = cuda_ms(lambda: kernels.bdg_overlap(*a), 10)
            t_p = cuda_ms(lambda: kernels.bdg_overlap_plain(*a), 2)
            print(f"phase 3b: bdg_overlap nb={nb} k1={k1} k2={k2} x={x} {mode} G=64: rel err "
                  f"{rel:.3e}; kernel {t_k:.3f} ms, plain {t_p:.3f} ms", flush=True)
            worst["bdg_overlap"] = max(worst["bdg_overlap"], ab)
    return worst


def spectra_diff(np, a, b, label_gauge=False):
    """(max Schmidt-value difference, max squared-Schmidt-value difference)
    per bond and parity between two MPS with identical bond labels."""
    d1 = d2 = 0.0
    for bnd in range(a.L + 1):
        qa, qb = a.q_bond[bnd], b.q_bond[bnd]
        if not np.array_equal(qa, qb):
            raise AssertionError(f"bond {bnd}: parities differ")
        for q in np.unique(qa):
            sa, sb = np.sort(a.get_SL(bnd)[qa == q]), np.sort(b.get_SL(bnd)[qb == q])
            d1 = max(d1, float(np.abs(sa - sb).max()))
            d2 = max(d2, float(np.abs(sa**2 - sb**2).max()))
    return d1, d2


def phase_pf_parity(torch, np, pfaffian, testing):
    """Phase 4b: the same BdG conversion on the card and on the CPU."""
    H = testing.pip_hamiltonian(4, 8)
    tp = {"chi_max": 64}
    t0 = time.perf_counter()
    gpu = pfaffian.H_to_MPS(H, tp, basis="C", device="cuda")
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = pfaffian.H_to_MPS(H, tp, basis="C", device="cpu")
    t_cpu = time.perf_counter() - t0
    fid = abs(gpu.overlap(cpu)) / np.sqrt(gpu.norm_squared() * cpu.norm_squared())
    d_sv, d_w = spectra_diff(np, gpu, cpu)
    print(f"phase 4b: p+ip W=4 Lx=8 chi=64 (chi_max {gpu.chi_max}): 1 - fidelity {1 - fid:.3e}, "
          f"max Schmidt-value diff {d_sv:.3e}, max entanglement-spectrum (squared) diff "
          f"{d_w:.3e}, bond parities identical; gpu {t_gpu:.2f} s, cpu {t_cpu:.2f} s", flush=True)
    if not fid >= 1 - PARITY_TOL:
        raise AssertionError(f"GPU/CPU fidelity {fid!r} < 1 - {PARITY_TOL}")
    if not d_w <= PARITY_TOL:
        raise AssertionError(f"entanglement spectra differ by {d_w:.3e} > {PARITY_TOL}")


def phase_pfaffian_full(torch, np, pfaffian, kernels, profiling, testing):
    """Phase 6: bench config 5 (p+ip W=8, Lx=16, chi=256, basis "M")."""
    W, Lx, chi = 8, 16, 256
    L = W * Lx
    C = pfaffian.correlation_matrix(testing.pip_hamiltonian(W, Lx), basis="C->M", device="cuda")
    tp = {"chi_max": chi}
    run = lambda: pfaffian.C_to_MPS(C, tp, basis="M", device="cuda")  # noqa: E731
    failures = []
    torch.cuda.reset_peak_memory_stats()
    kernels.pf_fill.launches = 0
    kernels.bdg_overlap.launches = 0
    t0 = time.perf_counter()
    mps = run()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches = {"pf_fill": kernels.pf_fill.launches, "bdg_overlap": kernels.bdg_overlap.launches}
    print(f"phase 6: cold conversion {cold:.3f} s; launches {launches}", flush=True)
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched by the main path")

    # warm run: stage profile, the shapes the kernels were given and the
    # inputs of the first group of each shape
    widths, nbs = Counter(), Counter()
    fills, overlaps, active = {}, {}, {}
    fill, overlap, group = pfaffian.pf_fill, pfaffian.bdg_overlap, pfaffian._overlap_group

    overlap_rec, group_rec = bdg_recorders(pfaffian, overlaps, active, nbs)

    def fill_rec(*a, **kw):
        t = (a[4].gather(1, a[6].long()) + a[5].gather(1, a[7].long()))
        for tot, n in zip(*torch.unique(t[t > 0], return_counts=True)):
            widths[int(tot)] += int(n)
        fills.setdefault((kw["width"], kw["spec"], a[6].shape[-1]), (a, kw))
        return fill(*a, **kw)

    pfaffian.pf_fill, pfaffian.bdg_overlap, pfaffian._overlap_group = (fill_rec, overlap_rec,
                                                                       group_rec)
    torch.cuda.reset_peak_memory_stats()
    try:
        with profiling.collect() as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            warm = time.perf_counter() - t0
    finally:
        pfaffian.pf_fill, pfaffian.bdg_overlap, pfaffian._overlap_group = fill, overlap, group
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 6: warm conversion {warm:.3f} s (stages synchronised); max_memory_allocated "
          f"{peak / 2**20:.1f} MiB", flush=True)
    print(prof.report(), flush=True)
    print("phase 6: real pairs per Pfaffian size tot:", dict(sorted(widths.items())),
          f"total {sum(widths.values())}", flush=True)
    print("phase 6: bdg_overlap (nb, k1_b, k2_b) -> sites:", dict(sorted(nbs.items())),
          flush=True)

    # each kernel against its twin on the inputs the conversion gave it
    rec = {name: pf_records(torch, np, kernels, "phase 6", name, groups, active, failures)
           for name, groups in (("pf_fill", fills), ("bdg_overlap", overlaps))}

    # checks on the cold run's state
    if mps.chi_max != chi:
        failures.append(f"chi_max {mps.chi_max} != {chi}")
    for bnd in range(L + 1):
        if not abs(np.linalg.norm(mps.get_SL(bnd)) - 1) <= 1e-12:
            failures.append(f"Schmidt values on bond {bnd} not normalised")
    for i in range(L):
        T = mps._B[i]
        if not bool(torch.isfinite(T).all()):
            failures.append(f"tensor {i} has non-finite entries (a NaN-poisoned norm)")
        qL = torch.as_tensor(mps.q_bond[i], device=T.device)[:, None, None]
        qp = torch.as_tensor(mps.sites[i].charges, device=T.device)[None, :, None]
        qR = torch.as_tensor(mps.q_bond[i + 1], device=T.device)[None, None, :]
        bad = (qL + qp - qR - int(mps.qtotal[i])) % 2 != 0
        if float((T.abs() * bad).max()) > 1e-12 * float(T.abs().max()):
            failures.append(f"tensor {i} violates parity conservation")
    res = {i: canonical_residuals(torch, mps, i) for i in (0, L // 2, L - 1)}
    print("phase 6: canonicality residual (unweighted, Schmidt-weighted) at sites",
          {i: f"{u:.3e}, {w:.3e}" for i, (u, w) in res.items()}, flush=True)
    for i in (0, L - 1):
        if not res[i][0] <= 1e-10:
            failures.append(f"site {i}: canonicality residual {res[i][0]:.3e} > 1e-10")
    if not res[L // 2][1] <= TRUNCATION_BOUNDS["weighted_residual"]:
        failures.append(f"site {L // 2}: weighted residual {res[L // 2][1]:.3e}")
    C_C = pfaffian.matrix_M2C(C)
    nrm = mps.norm_squared()
    n = mps.expectation_value("N").real / nrm
    dev_n = float(np.abs(n - C_C.diagonal()[::2].real).max())
    c = L // 2
    cdc = mps.correlation_function("Cd", "C", sites1=[c])[0] / nrm
    cc = mps.correlation_function("C", "C", sites1=[c])[0] / nrm
    dev_cdc = float(np.abs(cdc - C_C[::2, 2 * c]).max())
    dev_cc = float(np.abs(cc - C_C[::2, 2 * c + 1]).max())
    print(f"phase 6: <psi|psi> = {nrm:.6f} (chi-truncated MPS); max |<n_i> - C| {dev_n:.3e}; "
          f"centre row max |<c^dag_c c_j> - C| {dev_cdc:.3e}, |<c_c c_j> - C| {dev_cc:.3e}",
          flush=True)
    for key, val in (("n", dev_n), ("cdc", dev_cdc), ("cc", dev_cc)):
        if not val <= TRUNCATION_BOUNDS[key]:
            failures.append(f"{key} deviates from C by {val:.3e} > {TRUNCATION_BOUNDS[key]}")

    t0 = time.perf_counter()
    mps.canonical_form_finite()
    torch.cuda.synchronize()
    t_canon = time.perf_counter() - t0
    res = {i: canonical_residuals(torch, mps, i)[0] for i in (0, L // 2, L - 1)}
    n_canon = mps.expectation_value("N").real
    moved = float(np.abs(n_canon - n).max())
    print(f"phase 6: canonical_form_finite {t_canon:.3f} s, chi_max {mps.chi_max}; residual at "
          f"sites {({i: f'{r:.3e}' for i, r in res.items()})}; <psi|psi> - 1 = "
          f"{mps.norm_squared() - 1:.3e}; max |<n_i> change| {moved:.3e}", flush=True)
    for i, r in res.items():
        if not r <= 1e-10:
            failures.append(f"site {i}: residual {r:.3e} > 1e-10 after canonical_form_finite")
    if not (abs(mps.norm_squared() - 1) <= 1e-10 and moved <= 1e-10):
        failures.append("canonical_form_finite changed the state")
    device_profile(torch, run, "phase 6")
    if failures:
        raise AssertionError("phase 6: " + "; ".join(failures))
    return launches, rec


# --------------------------------------------------------------------------
# Slater at large L: the Fishman-White frontend and the wide-site kernels
# --------------------------------------------------------------------------


def fw_slab_cost(torch, args, kw, out):
    """(operations, bytes) of one fw_frame_slab call, counting what its real
    cuts need and no padding.  Operations: per cut the product over its
    block rows of its real crossing modes and Gram columns (the nonzero rows
    and columns of its Cmat), 2 xs kf m.  Bytes: the kf x m real Cmat
    entries, each gathered mode's entries of V over the block rows of the
    widest cut that uses it, each real cut's index row (Xidx, Fidx, colmap,
    xs), and the real cuts' (L, Wb) frames written; pad cuts and pad
    Xidx/Cmat rows and columns add nothing."""
    VT, flat, Cmat = args
    kb, fb, Wb = kw["kb"], kw["fb"], kw["Wb"]
    L = VT.shape[0]
    nz = Cmat != 0
    kf, m = nz.any(2).sum(1), nz.any(1).sum(1)
    xs = flat[:, kb + fb + Wb].long()
    real = xs > 0  # pad cuts of a short slab keep xs = 0
    X, F = flat[:, :kb].long(), flat[:, kb:kb + fb].long()
    used_x = torch.arange(kb, device=X.device)[None, :] < kf[:, None]
    used_f = (F >= 0) & real[:, None]
    f = used_f.sum(1)
    need = torch.zeros(L, dtype=torch.long, device=X.device)
    for idx, used in ((X, used_x), (F, used_f)):
        need.scatter_reduce_(0, idx[used], xs[:, None].expand_as(idx)[used], "amax")
    nbyte = (8 * (int((kf * m).sum()) + int(need.sum()) + int(real.sum()) * L * Wb)
             + 4 * int((kf + 2 * f + m + 1)[real].sum()))
    return float((2 * xs * kf * m).sum()), nbyte


def fw_library_ms(torch, args, kw):
    """Milliseconds of one torch.bmm of the pre-gathered, row-masked V
    columns (B, L, kb) with Cmat: the slab's product alone, its gathers and
    column reordering left out."""
    VT, flat, Cmat = args
    L, kb = kw["L"], kw["kb"]
    xs = flat[:, kb + kw["fb"] + kw["Wb"]].long()
    rows = torch.arange(L, device=VT.device)
    mask = rows[None] < xs[:, None] if kw["side"] == "L" else rows[None] >= (L - xs)[:, None]
    VX = (VT[flat[:, :kb].long()] * mask[:, None, :]).transpose(1, 2).contiguous()
    torch.bmm(VX, Cmat)
    return timed(torch, lambda: torch.bmm(VX, Cmat))[1]


def fw_captured(torch, kernels, label, slabs):
    """fw_frame_slab against its twin on the slabs a conversion gave it,
    one per (side, kb, keb, fb, Wb), with times, bound and library call."""
    ms = plain_ms = worst = lib_ms = bnd = flops = nbyte = 0.0
    for key, (args, kw) in sorted(slabs.items()):
        out = kernels.fw_frame_slab(*args, **kw)
        rel, ab = rel_err(out, kernels.fw_frame_slab_plain(*args, **kw))
        if not (rel <= KERNEL_RTOL and float(out.abs().max()) > 0):
            raise AssertionError(f"{label}: fw_frame_slab {key}: rel err {rel:.3e} > "
                                 f"{KERNEL_RTOL}")
        out, t_k = timed(torch, lambda: kernels.fw_frame_slab(*args, **kw))
        _, t_p = timed(torch, lambda: kernels.fw_frame_slab_plain(*args, **kw))
        f, b = fw_slab_cost(torch, args, kw, out)
        t_b, _ = bound_ms(f, b)
        t_l = fw_library_ms(torch, args, kw)
        print(f"{label}: fw_frame_slab (side, kb, keb, fb, Wb)={key}: rel err {rel:.3e}; kernel "
              f"{t_k:.3f} ms, plain {t_p:.3f} ms, bmm {t_l:.3f} ms, bound {t_b:.4f} ms",
              flush=True)
        ms, plain_ms, worst, lib_ms = ms + t_k, plain_ms + t_p, max(worst, ab), lib_ms + t_l
        bnd, flops, nbyte = bnd + t_b, flops + f, nbyte + b
    by = bound_ms(flops, nbyte)[1]
    print(f"{label}: fw_frame_slab on {len(slabs)} main-path slabs: kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bnd:.4f} ms ({by}; {flops:.3e} operations, {nbyte:.3e} "
          f"bytes), torch.bmm of the pre-gathered masked VX with Cmat {lib_ms:.3f} ms",
          flush=True)
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
            "bound_by": by, "library_ms": lib_ms}


def phase_fw_kernels(torch, kernels, testing):
    """Phase 3c: fw_frame_slab and the two global-memory kernels against
    their twins on seeded inputs.  Returns the worst absolute error per
    kernel."""
    dev = torch.device("cuda")
    worst = {"fw_frame_slab": 0.0, "site_overlap_schur_gmem": 0.0, "bdg_overlap_gmem": 0.0}
    # K9 at the L=1024 slab shape (B=64, Wb=512) with Xidx, Fidx = -1 and
    # colmap pads and 5 pad cuts (a short last slab)
    L, B, fb, Wb = 1024, 64, 64, 512
    for kb, keb in ((64, 64), (512, 256), (1024, 512)):
        a = [torch.as_tensor(x, device=dev) for x in testing.random_fw_slab_case(
            kb + keb, L=L, B=B, kb=kb, keb=keb, fb=fb, Wb=Wb)]
        for side in ("L", "R"):
            kw = {"side": side, "L": L, "kb": kb, "fb": fb, "Wb": Wb}
            out = kernels.fw_frame_slab(*a, **kw)
            rel, ab = rel_err(out, kernels.fw_frame_slab_plain(*a, **kw))
            if not (rel <= KERNEL_RTOL and float(out.abs().max()) > 0):
                raise AssertionError(f"fw_frame_slab kb={kb} keb={keb} {side}: rel err "
                                     f"{rel:.3e} > {KERNEL_RTOL}")
            t_k = cuda_ms(lambda: kernels.fw_frame_slab(*a, **kw), 3)
            t_p = cuda_ms(lambda: kernels.fw_frame_slab_plain(*a, **kw), 1)
            print(f"phase 3c: fw_frame_slab L={L} B={B} kb={kb} keb={keb} fb={fb} Wb={Wb} {side}: "
                  f"rel err {rel:.3e}; kernel {t_k:.3f} ms, plain {t_p:.3f} ms", flush=True)
            worst["fw_frame_slab"] = max(worst["fw_frame_slab"], ab)
    # K2 global-memory kernel: mb = 192 and 320 (float64), 128 (complex128)
    for kb, sb, dt in ((160, 32, "float64"), (288, 32, "float64"), (96, 32, "complex128")):
        for mode in ("left", "right"):
            args, kw = testing.random_site_overlap_case(kb + sb, G=16, L=512, kb=kb, sb=sb,
                                                        mode=mode, dtype=dt)
            a = [torch.as_tensor(x, device=dev) for x in args]
            for i in (2, 3, 4, 6, 7, 8):
                a[i] = a[i].to(torch.int32)
            rel, ab = overlap_err(kernels.site_overlap_schur_gmem,
                                  kernels.site_overlap_schur_plain, a, kw)
            if not rel <= KERNEL_RTOL:
                raise AssertionError(f"site_overlap_schur_gmem mb={kb + sb} {mode} {dt}: rel "
                                     f"err {rel:.3e} > {KERNEL_RTOL}")
            t_k = cuda_ms(lambda: kernels.site_overlap_schur_gmem(*a, **kw), 3)
            t_p = cuda_ms(lambda: kernels.site_overlap_schur_plain(*a, **kw), 1)
            print(f"phase 3c: site_overlap_schur_gmem {mode} {dt} G=16 L=512 kb={kb} sb={sb}: "
                  f"rel err {rel:.3e}; kernel {t_k:.3f} ms, plain {t_p:.3f} ms", flush=True)
            worst["site_overlap_schur_gmem"] = max(worst["site_overlap_schur_gmem"], ab)
    # K4 global-memory kernel: nb = 96 and 128, both sweep layouts
    for nb, k1, k2, x in ((96, 24, 24, 80), (128, 32, 24, 120)):
        for mode in ("left", "right"):
            a = [torch.as_tensor(v, device=dev) for v in testing.random_bdg_overlap_case(
                nb + k1, G=32, nb=nb, k1=k1, k2=k2, x=x, mode=mode)]
            N1, n1 = kernels.bdg_overlap_gmem(*a)
            N0, n0 = kernels.bdg_overlap_plain(*a)
            rel = max(rel_err(N1, N0)[0], rel_err(n1, n0)[0])
            ab = max(rel_err(N1, N0)[1], rel_err(n1, n0)[1])
            if not rel <= KERNEL_RTOL:
                raise AssertionError(f"bdg_overlap_gmem nb={nb} {mode}: rel err {rel:.3e} > "
                                     f"{KERNEL_RTOL}")
            t_k = cuda_ms(lambda: kernels.bdg_overlap_gmem(*a), 3)
            t_p = cuda_ms(lambda: kernels.bdg_overlap_plain(*a), 1)
            print(f"phase 3c: bdg_overlap_gmem nb={nb} k1={k1} k2={k2} x={x} {mode} G=32: rel "
                  f"err {rel:.3e}; kernel {t_k:.3f} ms, plain {t_p:.3f} ms", flush=True)
            worst["bdg_overlap_gmem"] = max(worst["bdg_overlap_gmem"], ab)
    return worst


def with_fw_mode(mode, fn):
    """``fn()`` with TEMFPY_TORCH_FW set to ``mode``, restored after."""
    old = os.environ.get("TEMFPY_TORCH_FW")
    os.environ["TEMFPY_TORCH_FW"] = mode
    try:
        return fn()
    finally:
        if old is None:
            os.environ.pop("TEMFPY_TORCH_FW")
        else:
            os.environ["TEMFPY_TORCH_FW"] = old


def phase_fw_parity(torch, np, slater, fw, kernels):
    """Phase 4c: the FW frontend at its auto-on scale, L = 768 on the W=8
    gapped cylinder with the seeded 1e-3 disorder of tests/test_fw.py:126-148
    (chi=48, svd_min=1e-5).

    - The card with FW (auto; K9 and the wide-site K2 counted) against the
      card's exact frontend: FW_EXACT_TOL.
    - The GPU path against the CPU's (FW forced on, the twins): the card run
      with the K1/K2 twins on the card, PARITY_TOL on fidelity, squared
      Schmidt values and normalised <c^dag c> rows, charges equal.  Both FW
      runs convert the same host array, so they share one sweep.
    - The K1/K2 kernels against their twins on EVERY group of the card run,
      with phase 5's extended-precision rule for ill-conditioned groups:
      this state has always blocks with |det| down to 1e-48, where float64
      rounding alone parts kernel and twin.  The card state with the
      kernels then parts from the CPU's by more than PARITY_TOL; it is held
      to CARD_KERNEL_TOL, and the sites where kernels and twins part most
      are printed (every group holding them has passed the check above)."""
    L = 768
    H = cylinder(8, L)  # the JAX FW test's cylinder (tests/test_fw.py:24-41)
    H += np.diag(1e-3 * np.random.default_rng(3).normal(size=L))
    tp = {"chi_max": 48, "svd_min": 1e-5}
    C = slater.correlation_matrix(H, device="cuda")[0].cpu().numpy()
    fw.fw_clear_cache()
    kernels.fw_frame_slab.launches = kernels.site_overlap_schur_gmem.launches = 0
    t0 = time.perf_counter()
    with slater_capture(slater, fw, every=True) as cap:
        gpu = slater.C_to_MPS(C, tp, device="cuda")
        torch.cuda.synchronize()
    t_fw = time.perf_counter() - t0
    launches = {"fw_frame_slab": kernels.fw_frame_slab.launches,
                "site_overlap_schur_gmem": kernels.site_overlap_schur_gmem.launches}
    if fw._CACHE[-1][1] is None:
        raise AssertionError("phase 4c: the FW sweep fell back to the exact frontend")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"phase 4c: kernel {name} was not launched")
    t0 = time.perf_counter()
    exact = with_fw_mode("0", lambda: slater.C_to_MPS(C, tp, device="cuda"))
    torch.cuda.synchronize()
    t_ex = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = with_fw_mode("1", lambda: slater.C_to_MPS(C, tp, device="cpu"))
    t_cpu = time.perf_counter() - t0
    fill, overlap = slater.det_fill, slater.site_overlap_schur
    slater.det_fill, slater.site_overlap_schur = (kernels.det_fill_plain,
                                                  kernels.site_overlap_schur_plain)
    try:
        twins = slater.C_to_MPS(C, tp, device="cuda")
    finally:
        slater.det_fill, slater.site_overlap_schur = fill, overlap
    fid = lambda a, b: abs(a.overlap(b)) / np.sqrt(a.norm_squared() * b.norm_squared())  # noqa
    f_ex, f_cpu, f_twin = fid(gpu, exact), fid(gpu, cpu), fid(twins, cpu)
    d_sv, d_w = spectra_diff(np, twins, cpu)
    sites = [0, L // 4, L // 2, 3 * L // 4, L - 1]
    cdc = [m.correlation_function("Cd", "C", sites1=sites) / m.norm_squared()
           for m in (twins, cpu)]
    d_cdc = float(np.abs(cdc[0] - cdc[1]).max())
    print(f"phase 4c: W=8 L={L} chi=48 svd_min=1e-5, launches {launches}: card FW {t_fw:.2f} s, "
          f"card exact {t_ex:.2f} s, cpu FW {t_cpu:.2f} s; FW vs exact 1 - fidelity "
          f"{1 - f_ex:.3e}; card (twins) vs cpu 1 - fidelity {1 - f_twin:.3e}, max "
          f"squared-Schmidt diff {d_w:.3e} (values {d_sv:.3e}), charges identical, normalised "
          f"<c^dag c> rows {sites} diff {d_cdc:.3e}; card (kernels) vs cpu 1 - fidelity "
          f"{1 - f_cpu:.3e}", flush=True)
    if not 1 - f_ex <= FW_EXACT_TOL:
        raise AssertionError(f"phase 4c: FW vs exact 1 - fidelity {1 - f_ex:.3e} > {FW_EXACT_TOL}")
    if not (1 - f_twin <= PARITY_TOL and d_w <= PARITY_TOL and d_cdc <= PARITY_TOL):
        raise AssertionError(f"phase 4c: card and CPU FW conversions differ beyond {PARITY_TOL}")
    if not 1 - f_cpu <= CARD_KERNEL_TOL:
        raise AssertionError(f"phase 4c: card (kernels) vs cpu 1 - fidelity {1 - f_cpu:.3e} > "
                             f"{CARD_KERNEL_TOL}")
    spectra_diff(np, gpu, cpu)  # the kernels' state keeps the CPU's charges too
    # kernels and twins on the card share frames and Schmidt data, so the
    # site tensors compare entry by entry
    part = {i: rel_err(gpu._B[i], twins._B[i])[0] for i in range(L)}
    worst_sites = sorted(part, key=part.get, reverse=True)[:4]
    print("phase 4c: sites where the kernels' and the twins' tensors part most (rel):",
          {i: f"{part[i]:.3e}" for i in worst_sites}, flush=True)
    held = Counter()
    for name, key, (args, kw) in cap["every"]:
        if name == "site_overlap_schur" and not kernels.site_overlap_fits_smem(key[1],
                                                                               args[0].dtype):
            name = "site_overlap_schur_gmem"
        hold(torch, kernels, "phase 4c", name, key, args, kw)
        held[name] += 1
    print(f"phase 4c: every group of the card run held against its twin: {dict(held)}",
          flush=True)
    fw_captured(torch, kernels, "phase 4c", cap["slabs"])


def phase_pf_gmem_parity(torch, np, pfaffian, kernels, testing):
    """Phase 4d: BdG past nb = 64: p+ip W=4, Lx=40 (L=160, half blocks up
    to 80 sites, bucket 96) at chi=64, on the card and on the CPU, with
    phase 4b's bounds; bdg_overlap_gmem's launches are counted in the card
    run, which also keeps one group per shape for its record.  Returns
    (launches, records)."""
    H = testing.pip_hamiltonian(4, 40)
    tp = {"chi_max": 64}
    overlaps, active, nbs = {}, {}, Counter()
    overlap_rec, group_rec = bdg_recorders(pfaffian, overlaps, active, nbs)
    overlap, group = pfaffian.bdg_overlap, pfaffian._overlap_group
    kernels.bdg_overlap_gmem.launches = 0
    pfaffian.bdg_overlap, pfaffian._overlap_group = overlap_rec, group_rec
    try:
        t0 = time.perf_counter()
        gpu = pfaffian.H_to_MPS(H, tp, basis="C", device="cuda")
        torch.cuda.synchronize()
        t_gpu = time.perf_counter() - t0
    finally:
        pfaffian.bdg_overlap, pfaffian._overlap_group = overlap, group
    launches = {"bdg_overlap_gmem": kernels.bdg_overlap_gmem.launches}
    if launches["bdg_overlap_gmem"] <= 0:
        raise AssertionError("phase 4d: bdg_overlap_gmem was not launched")
    t0 = time.perf_counter()
    cpu = pfaffian.H_to_MPS(H, tp, basis="C", device="cpu")
    t_cpu = time.perf_counter() - t0
    fid = abs(gpu.overlap(cpu)) / np.sqrt(gpu.norm_squared() * cpu.norm_squared())
    d_sv, d_w = spectra_diff(np, gpu, cpu)
    print(f"phase 4d: p+ip W=4 Lx=40 chi=64 (chi_max {gpu.chi_max}), launches {launches}, "
          f"bdg_overlap (nb, k1_b, k2_b) -> sites {dict(sorted(nbs.items()))}: 1 - fidelity "
          f"{1 - fid:.3e}, max Schmidt-value diff {d_sv:.3e}, max squared diff {d_w:.3e}, bond "
          f"parities identical; gpu {t_gpu:.2f} s, cpu {t_cpu:.2f} s", flush=True)
    if not fid >= 1 - PARITY_TOL:
        raise AssertionError(f"phase 4d: GPU/CPU fidelity {fid!r} < 1 - {PARITY_TOL}")
    if not d_w <= PARITY_TOL:
        raise AssertionError(f"phase 4d: entanglement spectra differ by {d_w:.3e}")
    failures = []
    wide = {k: v for k, v in overlaps.items() if not kernels.bdg_overlap_fits_smem(*k)}
    rec = pf_records(torch, np, kernels, "phase 4d", "bdg_overlap_gmem", wide, active, failures)
    if failures:
        raise AssertionError("phase 4d: " + "; ".join(failures))
    return launches, {"bdg_overlap_gmem": rec}


def compare_frontends(np, a, b):
    """Two conversions of one H (FW and the exact frontend): 1 - fidelity,
    the bonds whose kept Schmidt count differs, and on the other bonds the
    largest squared-Schmidt-value difference and whether the charge
    multisets agree."""
    fid = abs(a.overlap(b)) / np.sqrt(a.norm_squared() * b.norm_squared())
    chi_bonds, d_w, charges = [], 0.0, True
    for bnd in range(a.L + 1):
        sa, sb = np.sort(a.get_SL(bnd) ** 2), np.sort(b.get_SL(bnd) ** 2)
        if len(sa) != len(sb):
            chi_bonds.append(bnd)
            continue
        d_w = max(d_w, float(np.abs(sa - sb).max()))
        charges &= np.array_equal(np.sort(a.q_bond[bnd]), np.sort(b.q_bond[bnd]))
    return {"infidelity": 1 - fid, "chi_bonds": chi_bonds, "d_w": d_w, "charges": charges}


def phase_slice(torch, np, slater, fw, kernels, profiling):
    """Phase 7: the slice at full size, ``slater.H_to_MPS`` on bench config
    1's W=8 cylinder at L=1024, chi=512, float64, with the FW frontend
    (auto-on at L >= 768): cold and warm, stage profile, every kernel
    against its twin on the conversion's own inputs, the exact parts of the
    state and the chi truncation's effects (SLICE_BOUNDS), a device
    profile; then one conversion with FW forced off (the exact device
    frontend), timed for the frontend comparison and held against the FW
    state (:func:`frontend_checks`)."""
    H = cylinder(8, 1024)
    launches, rec, raw = slater_slice(
        torch, np, slater, fw, kernels, profiling, H, 512, "phase 7",
        ("det_fill", "site_overlap_schur", "site_overlap_schur_gmem", "fw_frame_slab"),
        bounds=SLICE_BOUNDS)
    # timed as the FW warm run is (stages synchronised), for the comparison
    torch.cuda.reset_peak_memory_stats()
    with profiling.collect() as prof:
        t0 = time.perf_counter()
        exact = with_fw_mode("0", lambda: slater.H_to_MPS(H, {"chi_max": 512}, device="cuda"))
        torch.cuda.synchronize()
        t_ex = time.perf_counter() - t0
    print(f"phase 7: exact device frontend (FW off): warm conversion {t_ex:.3f} s (stages "
          f"synchronised); max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB", flush=True)
    print(prof.report(), flush=True)
    frontend_checks(torch, np, slater, fw, H, 512, raw, exact)
    return launches, rec


def frontend_checks(torch, np, slater, fw, H, chi, fw_state, exact):
    """Phase 7's FW state against the exact frontend's.

    - Bench config 1 itself: both states' <n_i> within SLICE_BOUNDS of
      diag(C).  Its W=8 cylinder has degenerate Schmidt multiplets at the
      chi cut, kept whole or dropped whole by a ~1e-12 difference in their
      values, so the two frontends may keep different counts on a few
      bonds; there the states part (CLEAN_FW_TOL).  On every other bond the
      squared Schmidt values agree to FW_SPECTRA_TOL and the charges are
      equal.
    - The same cylinder with phase 4c's seeded 1e-3 disorder, which lifts
      the degeneracies: FW (auto) against FW off, both at ``chi``, the same
      kept counts on every bond and 1 - fidelity within FW_EXACT_TOL.  A
      wrong frame column or Schur solve at this shape fails here."""
    diag = slater.correlation_matrix(H, device="cuda")[0].diagonal().cpu().numpy()
    dev = {k: float(np.abs(m.expectation_value("N").real / m.norm_squared() - diag).max())
           for k, m in (("FW", fw_state), ("exact", exact))}
    clean = compare_frontends(np, fw_state, exact)
    del exact
    Hd = H + np.diag(1e-3 * np.random.default_rng(3).normal(size=len(H)))
    tp = {"chi_max": chi}
    fw.fw_clear_cache()
    t0 = time.perf_counter()
    fw_d = slater.H_to_MPS(Hd, tp, device="cuda")
    torch.cuda.synchronize()
    t_fw = time.perf_counter() - t0
    fell_back = fw._CACHE[-1][1] is None
    t0 = time.perf_counter()
    ex_d = with_fw_mode("0", lambda: slater.H_to_MPS(Hd, tp, device="cuda"))
    torch.cuda.synchronize()
    t_ex = time.perf_counter() - t0
    dis = compare_frontends(np, fw_d, ex_d)
    for name, c in (("bench config 1", clean), ("with 1e-3 disorder", dis)):
        print(f"phase 7: FW vs exact frontend, {name}: 1 - fidelity {c['infidelity']:.3e}; "
              f"kept counts differ on bonds {c['chi_bonds']}; elsewhere max squared-Schmidt "
              f"diff {c['d_w']:.3e}, charges {'equal' if c['charges'] else 'DIFFER'}", flush=True)
    print(f"phase 7: max |<n_i> - C_ii| FW {dev['FW']:.3e}, exact {dev['exact']:.3e}; "
          f"disordered conversions FW {t_fw:.2f} s, exact {t_ex:.2f} s", flush=True)
    failures = []
    if not dev["exact"] <= SLICE_BOUNDS["n"]:
        failures.append(f"the exact frontend's <n_i> deviate from diag(C) by {dev['exact']:.3e}")
    for name, c in (("bench config 1", clean), ("disordered", dis)):
        if not (c["d_w"] <= FW_SPECTRA_TOL and c["charges"]):
            failures.append(f"{name}: spectra or charges differ between the frontends")
    if not clean["infidelity"] <= CLEAN_FW_TOL:
        failures.append(f"bench config 1: 1 - fidelity {clean['infidelity']:.3e} > {CLEAN_FW_TOL}")
    if fell_back:
        failures.append("the disordered conversion's FW sweep fell back")
    if dis["chi_bonds"] or not dis["infidelity"] <= FW_EXACT_TOL:
        failures.append(f"disordered: kept counts differ on {dis['chi_bonds']} or 1 - fidelity "
                        f"{dis['infidelity']:.3e} > {FW_EXACT_TOL}")
    if failures:
        raise AssertionError("phase 7: " + "; ".join(failures))


def main() -> int:
    if not (ROOT / "temfpy_torch" / "__init__.py").is_file():
        print("chip_smoke: the temfpy_torch package is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    # phase 1: device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"phase 1: device {name}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    print(smi, flush=True)

    from temfpy_torch import pfaffian, profiling, slater, testing
    from temfpy_torch.ops import _build, fw, kernels

    testing.TEST_ACTION = "pass"

    # phase 2: build
    t0 = time.perf_counter()
    _build.load()
    print(f"phase 2: kernels built and loaded in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds})", flush=True)

    t_start = time.perf_counter()

    def elapsed(label):
        print(f"{label}: done {time.perf_counter() - t_start:.1f} s after the build", flush=True)

    worst = phase_kernels(torch, kernels, testing)
    elapsed("phase 3")
    worst.update(phase_pf_kernels(torch, kernels, testing))
    elapsed("phase 3b")
    worst.update(phase_fw_kernels(torch, kernels, testing))
    elapsed("phase 3c")
    phase_parity(torch, np, slater)
    phase_pf_parity(torch, np, pfaffian, testing)
    elapsed("phases 4, 4b")
    phase_fw_parity(torch, np, slater, fw, kernels)
    elapsed("phase 4c")
    launches, rec = phase_pf_gmem_parity(torch, np, pfaffian, kernels, testing)
    elapsed("phase 4d")
    for label, phase in (
            ("phase 5", lambda: phase_full(torch, np, slater, fw, kernels, profiling)),
            ("phase 6", lambda: phase_pfaffian_full(torch, np, pfaffian, kernels, profiling,
                                                    testing))):
        n, r = phase()
        launches.update(n)
        rec.update(r)
        elapsed(label)
    # phase 7 reads its own counts; det_fill and site_overlap_schur keep
    # phase 5's (their slice), their errors take the worst of both
    n7, r7 = phase_slice(torch, np, slater, fw, kernels, profiling)
    elapsed("phase 7")
    for k in ("site_overlap_schur_gmem", "fw_frame_slab"):
        launches[k] = n7[k]
        rec[k] = r7[k]
    for k in ("det_fill", "site_overlap_schur"):
        rec[k]["max_abs_err"] = max(rec[k]["max_abs_err"], r7[k]["max_abs_err"])
    for k, ab in worst.items():
        rec[k]["max_abs_err"] = max(rec[k]["max_abs_err"], ab)

    meta = {
        "det_fill": ("temfpy_torch/csrc/det_fill.cu",
                     "temfpy_tpu/slater.py:897"),
        "site_overlap_schur": ("temfpy_torch/csrc/site_overlap_schur.cu",
                               "temfpy_tpu/slater.py:830"),
        "site_overlap_schur_gmem": ("temfpy_torch/csrc/site_overlap_schur.cu",
                                    "temfpy_tpu/slater.py:830"),
        "pf_fill": ("temfpy_torch/csrc/pf_fill.cu",
                    "temfpy_tpu/ops/pfaffian.py:295"),
        "bdg_overlap": ("temfpy_torch/csrc/bdg_overlap.cu",
                        "temfpy_tpu/pfaffian.py:772"),
        "bdg_overlap_gmem": ("temfpy_torch/csrc/bdg_overlap.cu",
                             "temfpy_tpu/pfaffian.py:772"),
        "fw_frame_slab": ("temfpy_torch/csrc/fw_frame_slab.cu",
                          "temfpy_tpu/ops/fw.py:314"),
    }
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    out = [{"name": k, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[k], **{f: rec[k][f] for f in keys}}
           for k, (src, rep) in meta.items()]
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
