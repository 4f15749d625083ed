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
   state after ``canonical_form_finite``.

Phases 5 and 6 each set their kernels' launch counts to 0 just before
their cold conversion and read them just after.  The second-to-last line
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

import json
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


def det_fill_err(kernels, args, kw):
    """(relative, absolute) error of the det_fill kernel against its twin."""
    return rel_err(kernels.det_fill(*args, **kw), kernels.det_fill_plain(*args, **kw))


def overlap_err(kernels, args, kw):
    """(relative, absolute) error of the site_overlap_schur kernel against
    its twin: the worse of det(A) and det(A) * S, the product that enters
    the tensors (S alone carries the 1/det(A) of a near-singular block)."""
    d1, s1 = kernels.site_overlap_schur(*args, **kw)
    d0, s0 = kernels.site_overlap_schur_plain(*args, **kw)
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
        rel, ab = det_fill_err(kernels, a, kw)
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
        rel, ab = overlap_err(kernels, a, kw)
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


def phase_captured(torch, kernels, fills, overlaps):
    """Phase 5b: each kernel against its twin on the exact inputs the main
    path gave it, one group per (w, spec, P_b) and per (kb, mb, mode).

    Where a group's sites are ill-conditioned (a near-singular always block
    makes the sometimes matrix large and its small determinants cancel),
    float64 rounding alone parts kernel (fused multiply-adds) and twin
    (separate multiply and subtract) by more than KERNEL_RTOL.  Such a group
    is held, on its worst sites, against an extended-precision evaluation:
    the kernel passes if its error there is at most EXT_FACTOR times the
    twin's, or within KERNEL_RTOL of the largest entry.  Returns, per
    kernel, the worst absolute kernel-twin difference and the summed kernel
    and twin milliseconds over the groups."""
    rec = {}
    for name, groups, err, ext, cost in (
            ("det_fill", fills, det_fill_err, det_fill_ext, det_fill_cost),
            ("site_overlap_schur", overlaps, overlap_err, overlap_ext, overlap_cost)):
        kernel = getattr(kernels, name)
        plain = getattr(kernels, name + "_plain")
        ms = plain_ms = worst = lib_ms = bnd = flops = nbyte = 0.0
        for key, (args, kw) in sorted(groups.items()):
            rel, ab = err(kernels, args, kw)
            if not rel <= KERNEL_RTOL:
                e_k, e_t, scale, dmin = ext(torch, kernels, args, kw)
                print(f"phase 5: {name} {key}: kernel-twin rel err {rel:.3e} > {KERNEL_RTOL}; "
                      f"against extended precision on the worst sites (min |det_always| "
                      f"{dmin:.3e}): kernel {e_k:.3e}, twin {e_t:.3e} (largest entry "
                      f"{scale:.3e})", flush=True)
                if not (e_k <= EXT_FACTOR * e_t or e_k <= KERNEL_RTOL * scale):
                    raise AssertionError(f"{name} {key}: kernel error {e_k:.3e} against extended "
                                         f"precision exceeds {EXT_FACTOR} x the twin's {e_t:.3e}")
            out, t_k = timed(torch, lambda: kernel(*args, **kw))
            _, t_p = timed(torch, lambda: plain(*args, **kw))
            f, b = cost(torch, args, kw, out)
            t_b, _ = bound_ms(f, b)
            print(f"phase 5: {name} {key} G={args[0].shape[0]}: rel err {rel:.3e}; "
                  f"kernel {t_k:.3f} ms, plain {t_p:.3f} ms, bound {t_b:.4f} ms", flush=True)
            ms, plain_ms, worst = ms + t_k, plain_ms + t_p, max(worst, ab)
            bnd, flops, nbyte = bnd + t_b, flops + f, nbyte + b
            if name == "det_fill":
                lib_ms += det_fill_library_ms(torch, args)
        by = bound_ms(flops, nbyte)[1]
        print(f"phase 5: {name} on {len(groups)} main-path groups: kernel {ms:.3f} ms, "
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


def phase_full(torch, np, slater, kernels, profiling):
    """Phase 5: bench config 1 at L=256, chi=512."""
    L, chi, W = 256, 512, 8
    H = cylinder(W, L)
    tp = {"chi_max": chi}
    torch.cuda.reset_peak_memory_stats()
    kernels.det_fill.launches = 0
    kernels.site_overlap_schur.launches = 0
    t0 = time.perf_counter()
    mps = slater.H_to_MPS(H, tp, device="cuda")
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches = {"det_fill": kernels.det_fill.launches,
                "site_overlap_schur": kernels.site_overlap_schur.launches}
    print(f"phase 5: cold conversion {cold:.3f} s; launches {launches}", flush=True)
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched by the main path")

    # warm run: stage profile, the shapes the kernels were given, and the
    # inputs of the first group of each shape, for phase 5b
    widths, kbs = Counter(), Counter()
    fills, overlaps = {}, {}
    fill, overlap = slater.det_fill, slater.site_overlap_schur

    def fill_rec(M, det, ob, ok, pr, pc, tabs, **kw):
        widths[(ob.shape[-1], pr.shape[-1])] += M.shape[0]
        fills.setdefault((ob.shape[-1], kw["spec"], pr.shape[-1]),
                         ((M, det, ob, ok, pr, pc, tabs), kw))
        return fill(M, det, ob, ok, pr, pc, tabs, **kw)

    def overlap_rec(fb, fk, colb, *a, kb, mode):
        kbs[(kb, colb.shape[-1])] += fb.shape[0]
        overlaps.setdefault((kb, colb.shape[-1], mode),
                            ((fb, fk, colb, *a), {"kb": kb, "mode": mode}))
        return overlap(fb, fk, colb, *a, kb=kb, mode=mode)

    slater.det_fill, slater.site_overlap_schur = fill_rec, overlap_rec
    torch.cuda.reset_peak_memory_stats()
    try:
        with profiling.collect() as prof:
            t0 = time.perf_counter()
            mps = slater.H_to_MPS(H, tp, device="cuda")
            torch.cuda.synchronize()
            warm = time.perf_counter() - t0
    finally:
        slater.det_fill, slater.site_overlap_schur = fill, overlap
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 5: warm conversion {warm:.3f} s (stages synchronised); "
          f"max_memory_allocated {peak / 2**20:.1f} MiB", flush=True)
    print(prof.report(), flush=True)
    pairs = Counter()
    for (w, P_b), g in widths.items():
        pairs[w] += P_b * g
    print("phase 5: det_fill (w, P_b) -> sites:", dict(sorted(widths.items())), flush=True)
    print("phase 5: padded pairs per width:", dict(sorted(pairs.items())),
          f"total {sum(pairs.values())}", flush=True)
    print("phase 5: site_overlap_schur (kb, mb) -> sites:", dict(sorted(kbs.items())),
          flush=True)
    rec = phase_captured(torch, kernels, fills, overlaps)

    # checks on the cold run's state
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
    print("phase 5: canonicality residual (unweighted, Schmidt-weighted) at sites",
          {i: f"{u:.3e}, {w:.3e}" for i, (u, w) in res.items()}, flush=True)
    for i in (0, L - 1):
        if not res[i][0] <= 1e-10:
            raise AssertionError(f"site {i}: canonicality residual {res[i][0]:.3e} > 1e-10")
    # the centre bond is chi-truncated, so the unweighted residual is O(1)
    # by construction; its Schmidt-weighted residual measures the
    # truncation (the JAX package's audit gave 1.7e-3 on this state)
    if not res[L // 2][1] <= 1e-2:
        raise AssertionError(f"site {L // 2}: weighted residual {res[L // 2][1]:.3e} > 1e-2")
    C, N = slater.correlation_matrix(H, device="cuda")
    nrm = mps.norm_squared()
    n = mps.expectation_value("N").real / nrm
    dev = float(np.abs(n - C.diagonal().cpu().numpy()).max())
    print(f"phase 5: <psi|psi> = {nrm:.6f} (chi-truncated MPS); sum <n_i> = {n.sum():.10f} "
          f"(N={N}); max |<n_i> - C_ii| {dev:.3e}", flush=True)
    # every tensor conserves particle number, so the total is exact; the
    # per-site densities carry the chi truncation: 7.0e-3 on this state on
    # the H100, so the bound is 1e-2
    if not abs(n.sum() - N) <= 1e-8:
        raise AssertionError(f"sum of <n_i> = {n.sum()!r} != N = {N}")
    if not dev <= 1e-2:
        raise AssertionError(f"<n_i> deviates from diag(C) by {dev:.3e} > 1e-2")

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
    print(f"phase 5: canonical_form_finite {t_canon:.3f} s, chi_max {mps.chi_max}; residual "
          f"at sites {({i: f'{r:.3e}' for i, r in res.items()})}; <psi|psi> - 1 = "
          f"{mps.norm_squared() - 1:.3e}; max |<n_i> change| {moved:.3e}", flush=True)
    for i, r in res.items():
        if not r <= 1e-10:
            raise AssertionError(f"site {i}: residual {r:.3e} > 1e-10 after canonical_form_finite")
    if not (abs(mps.norm_squared() - 1) <= 1e-10 and moved <= 1e-10):
        raise AssertionError("canonical_form_finite changed the state")
    device_profile(torch, lambda: slater.H_to_MPS(H, tp, device="cuda"), "phase 5")
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
    for kernel in ("det_fill_kernel", "site_overlap_schur_kernel", "pf_fill_kernel",
                   "bdg_overlap_kernel"):
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

    def group_rec(plans, device):
        # each site's real active counts, from its N-slot sets
        # [ket (k2_b) | bra (k1_b)] (every real slot is used by some set)
        k2_b = len(plans[0]["j2"])
        active.setdefault(
            (plans[0]["frames"][0].shape[-1], len(plans[0]["j1"]), k2_b),
            ([int(p["fields"]["sets_bra"][:, k2_b:].any(0).sum()) for p in plans],
             [int(p["fields"]["sets_ket"][:, :k2_b].any(0).sum()) for p in plans]))
        return group(plans, device)

    def fill_rec(*a, **kw):
        t = (a[4].gather(1, a[6].long()) + a[5].gather(1, a[7].long()))
        for tot, n in zip(*torch.unique(t[t > 0], return_counts=True)):
            widths[int(tot)] += int(n)
        fills.setdefault((kw["width"], kw["spec"], a[6].shape[-1]), (a, kw))
        return fill(*a, **kw)

    def overlap_rec(*a):
        nbs[(a[0].shape[-1], a[2].shape[-1], a[3].shape[-1])] += a[0].shape[0]
        overlaps.setdefault((a[0].shape[-1], a[2].shape[-1], a[3].shape[-1]), (a, {}))
        return overlap(*a)

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
    rec = {}
    for name, groups, err in (("pf_fill", fills, pf_err), ("bdg_overlap", overlaps, bdg_err)):
        kernel, plain = getattr(kernels, name), getattr(kernels, name + "_plain")
        ms = plain_ms = worst = bnd = flops = nbyte = 0.0
        for key, (args, kw) in sorted(groups.items()):
            rel, ab = err(torch, kernels, args, kw)
            out, t_k = timed(torch, lambda: kernel(*args, **kw))
            _, t_p = timed(torch, lambda: plain(*args, **kw))
            f, b = (pf_fill_cost(torch, args, kw, out) if name == "pf_fill"
                    else bdg_overlap_cost(np, args, out, *active[key]))
            t_b, _ = bound_ms(f, b)
            print(f"phase 6: {name} {key} G={args[0].shape[0]}: rel err {rel:.3e} abs err "
                  f"{ab:.3e}; kernel {t_k:.3f} ms, plain {t_p:.3f} ms, bound {t_b:.4f} ms",
                  flush=True)
            if not rel <= KERNEL_RTOL:
                failures.append(f"{name} {key}: rel err {rel:.3e} > {KERNEL_RTOL}")
            ms, plain_ms, worst = ms + t_k, plain_ms + t_p, max(worst, ab)
            bnd, flops, nbyte = bnd + t_b, flops + f, nbyte + b
        by = bound_ms(flops, nbyte)[1]
        print(f"phase 6: {name} on {len(groups)} main-path groups: kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, bound {bnd:.4f} ms ({by}; {flops:.3e} operations, "
              f"{nbyte:.3e} bytes)", flush=True)
        rec[name] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
                     "bound_by": by, "library_ms": None}

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
    from temfpy_torch.ops import _build, kernels

    testing.TEST_ACTION = "pass"

    # phase 2: build
    t0 = time.perf_counter()
    _build.load()
    print(f"phase 2: kernels built and loaded in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds})", flush=True)

    worst = phase_kernels(torch, kernels, testing)
    worst.update(phase_pf_kernels(torch, kernels, testing))
    phase_parity(torch, np, slater)
    phase_pf_parity(torch, np, pfaffian, testing)
    launches, rec = phase_full(torch, np, slater, kernels, profiling)
    l6, r6 = phase_pfaffian_full(torch, np, pfaffian, kernels, profiling, testing)
    launches.update(l6)
    rec.update(r6)
    for k, ab in worst.items():
        rec[k]["max_abs_err"] = max(rec[k]["max_abs_err"], ab)

    meta = {
        "det_fill": ("temfpy_torch/csrc/det_fill.cu",
                     "temfpy_tpu/slater.py:897"),
        "site_overlap_schur": ("temfpy_torch/csrc/site_overlap_schur.cu",
                               "temfpy_tpu/slater.py:830"),
        "pf_fill": ("temfpy_torch/csrc/pf_fill.cu",
                    "temfpy_tpu/ops/pfaffian.py:295"),
        "bdg_overlap": ("temfpy_torch/csrc/bdg_overlap.cu",
                        "temfpy_tpu/pfaffian.py:772"),
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
