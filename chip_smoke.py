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
   MPS engine.

The second-to-last line is a JSON object with one record per kernel: its
launches in the cold conversion, its worst absolute error against the
twin over phases 3 and 5, and the kernel's and the twin's milliseconds
summed over the main-path groups of phase 5.  The last line is
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
PARITY_TOL = 1e-10
"""GPU vs CPU conversion: cuSOLVER and LAPACK eigensolvers differ at
1e-15..1e-13 in the spectra; Schmidt values are products of up to ~10
mode weights, fidelities sums over chi^2 entries, so 1e-10 is the bound."""


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
    for name, groups, err, ext in (("det_fill", fills, det_fill_err, det_fill_ext),
                                   ("site_overlap_schur", overlaps, overlap_err, overlap_ext)):
        kernel = getattr(kernels, name)
        plain = getattr(kernels, name + "_plain")
        ms = plain_ms = worst = 0.0
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
            _, t_k = timed(torch, lambda: kernel(*args, **kw))
            _, t_p = timed(torch, lambda: plain(*args, **kw))
            print(f"phase 5: {name} {key} G={args[0].shape[0]}: rel err {rel:.3e}; "
                  f"kernel {t_k:.3f} ms, plain {t_p:.3f} ms", flush=True)
            ms, plain_ms, worst = ms + t_k, plain_ms + t_p, max(worst, ab)
        print(f"phase 5: {name} on {len(groups)} main-path groups: kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms", flush=True)
        rec[name] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}
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
    device_profile(torch, slater, H, tp)
    return launches, rec


def device_profile(torch, slater, H, tp):
    """One more warm conversion under torch.profiler: device busy time by
    kernel against the wall time (what the stage profile cannot see)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        slater.H_to_MPS(H, tp, device="cuda")
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
    print(f"phase 5: profiled conversion {wall:.3f} s wall, device busy {busy:.3f} s "
          f"(sum of kernel and copy times; idle share {1 - busy / wall:.1%})", flush=True)
    for us, key, count in sorted(rows, reverse=True)[:8]:
        print(f"  {us / 1e3:10.2f} ms  x{count:<6d} {key[:90]}", flush=True)


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

    from temfpy_torch import profiling, slater, testing
    from temfpy_torch.ops import _build, kernels

    testing.TEST_ACTION = "pass"

    # phase 2: build
    t0 = time.perf_counter()
    _build.load()
    print(f"phase 2: kernels built and loaded in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds})", flush=True)

    worst = phase_kernels(torch, kernels, testing)
    phase_parity(torch, np, slater)
    launches, rec = phase_full(torch, np, slater, kernels, profiling)
    for k, ab in worst.items():
        rec[k]["max_abs_err"] = max(rec[k]["max_abs_err"], ab)

    meta = {
        "det_fill": ("temfpy_torch/csrc/det_fill.cu",
                     "temfpy_tpu/slater.py:897"),
        "site_overlap_schur": ("temfpy_torch/csrc/site_overlap_schur.cu",
                               "temfpy_tpu/slater.py:830"),
    }
    out = [{"name": k, "route": "cuda", "source": meta[k][0], "replaces": meta[k][1],
            "launches": launches[k], **rec[k]} for k in ("det_fill", "site_overlap_schur")]
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
