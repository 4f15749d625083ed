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
   every kind of pad, a short last slab; beside ``torch.bmm``, and a second
   launch that must return the same bits), ``site_overlap_schur_gmem``
   (mb = 192, 320 in float64, 128 in complex128) and ``bdg_overlap`` past
   nb = 64 (nb = 96, 128 in clusters, 272 in the global-memory elimination)
   against their twins on seeded inputs;
3d. rank-update and index-row kernels: ``det_rows`` (w = 4-64, paired and
   all pairs), ``swap_tables`` (w_b = 8, 16, 24), ``swap_fill`` (s_b = 1,
   2, 4, 8, both modes, the three scatter layouts into slots of one
   buffer, a class built to fail the probe) and ``pf_gather`` (widths
   4-32) against their twins on seeded inputs;
3e. the public entry points ``ops.linalg.batched_det_pairs`` /
   ``batched_det_gather`` and ``ops.pfaffian.batched_pfaffian_gather`` on
   the card against the CPU (pf_gather's main path: its launches are
   counted here);
4c. FW parity: ``slater.C_to_MPS`` at L=768 (W=8, chi=48) through the
   Fishman-White frontend forced on (``TEMFPY_TORCH_FW=1``; its default is
   off) on the card against the card's exact frontend, every K1/K2 group
   held; at L=24 the card's FW conversion against the CPU's (twins);
4d. BdG past nb = 64: p+ip W=4, Lx=40 (L=160) on the card and the CPU;
4e. the rank-update path forced on (``TEMFPY_TORCH_DET_UPDATES=1``) on the
   card against the CPU: the W=8, L=32 cylinder (chi=96) and the pi-flux
   W=4, Lx=8 cylinder (chi=128), with the classes, fallbacks and wasted
   swap fills;
8. the rank-update slice at full size: phase 5's conversion with the
   rank-update path on, with phase 5's checks and records, the launches of
   K1, K2, K5, K6a and K6b, every rank-update group held against its twin
   (with the count of groups held against extended precision and their
   kernel/twin error ratios there), the state against phase 5's, and both
   paths' warm wall time;
7. the slice at L=1024: ``slater.H_to_MPS`` on bench config 1's cylinder at
   chi=512 through the FW frontend (forced on), one conversion counted and
   profiled (its cold and warm runs took the same time), with phase 5's
   checks and records, then one conversion with the default exact frontend for the
   frontend comparison (its states, clean and disordered, are kept for 9);
3f. the randomized frontend's kernels: every mode of ``rsf_apply``,
   ``rsf_tsprod``, ``rsf_ritz_select`` and ``rsf_frames`` against its twin
   on seeded inputs at the main path's shapes (L=1024, m=32, r=64,
   rf=512, kb=96, both sides; a dropped lane, a band keeping nothing);
4f. small RSF parity: phase 4's conversion with ``TEMFPY_TORCH_RSF=1`` on
   the card and on the CPU, and against the card's exact frontend;
9. the randomized frontend at full width: bench config 1 at L=1024,
   chi=512 with ``TEMFPY_TORCH_RSF=1``, one conversion counted and
   profiled, with phase 7's checks, the cuts rerouted to the exact
   frontend, every kernel call of three main-path chunks (one per side
   whose cuts are rerouted, one whose cuts are kept) held against its twin,
   the state against phase 7's exact states (clean and disordered), and
   both frontends' times;
10. Gutzwiller projection (bench config 4): ``gutzwiller.abrikosov_ph`` of
   ``slater.H_to_MPS(..., spinful="PH")`` on the pi-flux W=4, Lx=8
   cylinder (chi=128) on the card and the CPU; at full width on the W=8,
   Lx=16 cylinder (chi=512, 256 fermionic sites), cold and warm, every
   K1/K2 group held, the projected state canonical; the infinite branch
   (``slater.H_to_iMPS(..., spinful="PH")``, ``abrikosov_ph``,
   ``canonical_form_infinite`` with its ARPACK fallbacks counted);
11. iMPS (bench config 3): ``slater.H_to_iMPS`` of the dimerized chain
   (L=128, chi=64) on the card and the CPU with splice reconstructions; at
   full width on bench config 1's W=8 cylinder (chi=512) and the
   ``pfaffian.H_to_iMPS`` of bench config 5's p+ip cylinder (chi=256),
   kernels against twins on the card.

Phases 3e, 5, 6, 7, 8 and 9 set their kernels' launch counts to 0 just
before their main-path run and read them just after (4c, 4d, 4e, 4f, 10
and 11 set theirs to 0 and check that they launched).  The phases of the earlier slices run the direct fill
on both devices (``TEMFPY_TORCH_DET_UPDATES=0``; the CPU's default is the
rank-update path).  The second-to-last line
is a JSON object with one record per kernel: its launches in its slice's
counted (cold) conversion, its worst absolute error against the twin over the seeded
and main-path checks (for ``swap_tables``, whose tables span 1e-18 to
1e29, the error relative to each output's largest entry), the kernel's and the twin's milliseconds summed over
one main-path group per shape, the least time the card could take for the
work of those groups (``bound_ms``: the larger of their operations at
FP64_PEAK and their bytes at HBM_RATE, computed from this run's inputs)
and the time of one PyTorch call computing the same function
(``library_ms``, null where none does: ``site_overlap_schur`` and its
wide wrapper, which no single call computes, print the summed library
composition of :func:`overlap_library_ms` beside, for reference).  Every timed
kernel and library call is timed alike (:func:`cuda_ms`, TIMING_REPS
launches after a warm one, on the same captured inputs; the kernel's
one-call time with its wrapper's host work is printed beside; a library
call takes the whole pre-gathered batch of a group, in chunks of
LIBRARY_CHUNK_BYTES); the redesigned ``det_fill``,
``site_overlap_schur`` (both wrappers), ``swap_fill``, ``det_rows``,
``pf_fill``, ``bdg_overlap``, ``fw_frame_slab``, ``rsf_apply``,
``rsf_tsprod`` and ``rsf_ritz_select`` must also return the same bits from
two launches on each held input (``rsf_ritz_select`` works in place: each of
its launches gets a clone of the operand it updates).  ``det_rows``'
record sums every group of phase 8's warm run (the probe's launches), and
phase 6 prints the bound of every ``pf_fill`` launch of its warm run beside
the profiled conversion's device time.  Untimed conversions are metered
(:class:`ConversionMeter`: device time, work and bound of every launch over
the whole conversion): every K1/K2 launch of one more exact conversion in
phase 7, every K6b, K5 and K6a launch of one more rank-update conversion in
phase 8, every K4 launch of phase 6's warm conversion, every K11a and K11c
launch of phase 9's disordered conversion.  ``bdg_overlap`` has two
records: ``bdg_overlap`` (phase 6) and ``bdg_overlap_wide`` (its sites past
nb = 64, phase 4d; both records count the one wrapper's launches).  The last
line is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

import contextlib
import copy
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
extended precision); at L=768 the states parted by 1.0e-6 on an H100
(PERF.md, Findings), so 1e-5 leaves a 10x margin there, and more at
FW_PARITY_L, where the check runs now."""
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


TIMING_REPS = 3
"""CUDA-event repetitions (after a warm call) of every timed kernel call
whose time stands beside a library call's in the ``kernels`` line: both
are timed by :func:`cuda_ms` with these repetitions on the same inputs, so
back-to-back launches hide the host time of either side alike."""


def bitwise_equal(torch, a, b):
    """Whether two outputs (a tensor or a tuple of them) hold the same bits,
    NaNs included."""
    a, b = rsf_outputs(a), rsf_outputs(b)
    bits = lambda t: t.contiguous().view(torch.int64) if t.is_floating_point() else t  # noqa
    return len(a) == len(b) and all(x.shape == y.shape and torch.equal(bits(x), bits(y))
                                    for x, y in zip(a, b))


def check_repeatable(torch, label, fn, out):
    """Raises unless one more call of ``fn`` returns ``out`` bit for bit."""
    if not bitwise_equal(torch, fn(), out):
        raise AssertionError(f"{label}: two launches on the same input differ")


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


def written_bytes(pr, pad_row, like):
    """Bytes of the values a fill writes: one per real pair (pad pairs, whose
    row id is ``pad_row``, land on the trash row).  The zeroed buffer the
    values go into is the caller's, allocated once per bucketed shape."""
    return float((pr != pad_row).sum()) * like.element_size()


def det_fill_cost(torch, args, kw, out):
    """(operations, bytes) of one det_fill group: an LU of the c x c block
    each pair needs (c = its occupied orbitals; sentinels add nothing),
    2c^3/3 real operations (x4 complex); every input once and one value per
    real pair.  Both may be 0-d device tensors (no synchronisation here)."""
    M, det, ob, ok, pr, pc, tabs = args
    cnt = (ob < M.shape[-1]).sum(-1)
    c = torch.gather(cnt, 1, pr.long()).double()
    mult = 4 if M.is_complex() else 1
    real = (pr != ob.shape[1] - 1).sum() * M.element_size()
    return (2.0 / 3.0 * c**3).sum() * mult, nbytes(*args) + real


def overlap_cost(torch, args, kw, out):
    """(operations, bytes) of one site_overlap_schur group: O = vb^H vk
    (L mb^2 multiply-adds), Gauss-Jordan on [A | B] (kb^2 mb) and the Schur
    product (sb^2 kb) per site, 2 real operations each (x4 complex).  The
    bytes are those the function needs: the L rows of each frame column a
    descriptor names (kind 0; one-hot and zero columns read no frame), the
    descriptors and the outputs; a frame's other columns are not read.
    The bytes may be a 0-d device tensor (no synchronisation here)."""
    fb, kindb, kindk, kb = args[0], args[3], args[7], kw["kb"]
    G, L, _ = fb.shape
    mb = kindb.shape[-1]
    sb = mb - kb
    mult = 4 if fb.is_complex() else 1
    cols = (kindb == 0).sum() + (kindk == 0).sum()
    return (2.0 * G * (L * mb * mb + kb * kb * mb + sb * sb * kb) * mult,
            cols * (L * fb.element_size()) + nbytes(*args[2:], *out))


LIBRARY_CHUNK_BYTES = 4 << 30
"""Largest pre-gathered batch (bytes) that one timed library call takes: a
group whose matrices exceed it is timed in site chunks of at most this
size (each still millions of matrices, one call each), so that the
gathered copy and the library's own workspace stay a few GB."""


def batched_library_ms(torch, sites, gather, fn):
    """Milliseconds (:func:`cuda_ms`, TIMING_REPS) of ``fn`` on the
    concatenated batches ``gather(s)`` of ``sites``: one call over all of
    them, or one per chunk of LIBRARY_CHUNK_BYTES, summed.  The gathers are
    made before the timed calls."""
    total, chunk, size = 0.0, [], 0

    def flush():
        nonlocal chunk, size
        if chunk:
            batch = torch.cat(chunk) if len(chunk) > 1 else chunk[0]
            chunk, size = [], 0
            return cuda_ms(lambda: fn(batch), TIMING_REPS)
        return 0.0

    for s in sites:
        sub = gather(s)
        if chunk and size + nbytes(sub) > LIBRARY_CHUNK_BYTES:
            total += flush()
        chunk.append(sub)
        size += nbytes(sub)
    return total + flush()


def det_fill_library_ms(torch, args):
    """Milliseconds of one torch.linalg.det over the group's pre-gathered
    (G P_b, w, w) matrices (:func:`batched_library_ms`); the gather and the
    scatter are left out."""
    from temfpy_torch.ops.linalg import block_diag_identity_pad, gather_submatrices

    M, _det, ob, ok, pr, pc, _tabs = args
    w = ob.shape[-1]
    return batched_library_ms(
        torch, range(M.shape[0]),
        lambda g: gather_submatrices(block_diag_identity_pad(M[g], w), ob[g][pr[g].long()],
                                     ok[g][pc[g].long()]),
        torch.linalg.det)


def overlap_library_ms(torch, args, kw):
    """Milliseconds of the library composition that computes
    site_overlap_schur's function on the same inputs, each step timed by
    :func:`cuda_ms` (TIMING_REPS) and summed: torch.bmm of the gathered
    columns (vb^H vk; the gather made before), torch.linalg.lu_factor and
    lu_solve of A X = B, and torch.baddbmm for D - C X.  No single call
    computes K2, so this is a composition, for reference."""
    from temfpy_torch.ops.kernels import orbital_columns

    fb, fk, colb, kindb, rowb, signb, colk, kindk, rowk, signk = args
    kb = kw["kb"]
    vbh = orbital_columns(fb, colb, kindb, rowb, signb).conj().transpose(1, 2).contiguous()
    vk = orbital_columns(fk, colk, kindk, rowk, signk)
    ms = cuda_ms(lambda: torch.bmm(vbh, vk), TIMING_REPS)
    if kb == 0:
        return ms
    O = torch.bmm(vbh, vk)
    a, s = (slice(None, kb), slice(kb, None)) if kw["mode"] == "left" else (
        slice(-kb, None), slice(None, -kb))
    A, B, C, D = (O[:, i, j].contiguous() for i, j in ((a, a), (a, s), (s, a), (s, s)))
    ms += cuda_ms(lambda: torch.linalg.lu_solve(*torch.linalg.lu_factor(A), B), TIMING_REPS)
    X = torch.linalg.lu_solve(*torch.linalg.lu_factor(A), B)
    return ms + cuda_ms(lambda: torch.baddbmm(D, C, X, alpha=-1), TIMING_REPS)


CAPTURED = {
    # record name: (kernel, twin, error, extended-precision check, cost,
    # library call's milliseconds or None)
    "det_fill": ("det_fill", "det_fill_plain", det_fill_err, det_fill_ext, det_fill_cost,
                 lambda torch, args, kw: det_fill_library_ms(torch, args)),
    "site_overlap_schur": ("site_overlap_schur", "site_overlap_schur_plain", overlap_err,
                           overlap_ext, overlap_cost, overlap_library_ms),
    "site_overlap_schur_gmem": ("site_overlap_schur_gmem", "site_overlap_schur_plain",
                                overlap_err, overlap_ext, overlap_cost, overlap_library_ms),
}
"""The kernels phase_captured holds against their twins; the rank-update
kernels join it below their own section."""
LIBRARY_LABEL = {
    "det_fill": "torch.linalg.det on the gathered batches",
    "site_overlap_schur": "library composition (bmm, lu_factor + lu_solve, baddbmm)",
    "site_overlap_schur_gmem": "library composition (bmm, lu_factor + lu_solve, baddbmm)",
    "det_rows": "torch.linalg.det on the gathered batches",
    "swap_fill": "torch.linalg.det on the bordered matrices",
    "swap_tables": "library composition (lu_factor + lu_solve, three bmm)",
}
COMPOSITION = ("site_overlap_schur", "site_overlap_schur_gmem", "swap_tables")
"""Kernels whose library time is a composition of several calls: printed
and kept as ``composition_ms``, while the ``kernels`` line's
``library_ms`` (one call computing the same function) stays null."""
REPEATED = ("det_fill", "site_overlap_schur", "site_overlap_schur_gmem", "swap_fill",
            "det_rows", "swap_tables")
"""Redesigned kernels whose captured groups must also return the same bits
from a second launch (:func:`check_repeatable`)."""


def hold(torch, kernels, label, name, key, args, kw, ref=None):
    """One main-path group of kernel ``name`` against its twin (``ref``:
    the twin's output on these inputs where the caller has it).

    Where a group's sites are ill-conditioned (a near-singular always block
    makes the sometimes matrix large and its small determinants cancel),
    float64 rounding alone parts kernel (fused multiply-adds) and twin
    (separate multiply and subtract) by more than KERNEL_RTOL.  Such a group
    is held, on its worst sites, against an extended-precision evaluation:
    the kernel passes if its error there is at most EXT_FACTOR times the
    twin's, or within KERNEL_RTOL of the largest entry.  Returns the
    (relative, absolute) kernel-twin difference and, for a group held
    against extended precision, (kernel error, twin error) there, else
    None."""
    kname, pname, err, ext, _cost, _lib = CAPTURED[name]
    kernel, plain = getattr(kernels, kname), getattr(kernels, pname)
    if ref is not None:
        plain = lambda *a, **k: ref  # noqa: E731
    rel, ab = err(kernel, plain, args, kw)
    held = None
    if not rel <= KERNEL_RTOL:
        e_k, e_t, scale, dmin = ext(torch, kernels, args, kw)
        print(f"{label}: {name} {key}: kernel-twin rel err {rel:.3e} > {KERNEL_RTOL}; "
              f"against extended precision on the worst sites (min |det_always| "
              f"{dmin:.3e}): kernel {e_k:.3e}, twin {e_t:.3e} (largest entry "
              f"{scale:.3e})", flush=True)
        if not (e_k <= EXT_FACTOR * e_t or e_k <= KERNEL_RTOL * scale):
            raise AssertionError(f"{name} {key}: kernel error {e_k:.3e} against extended "
                                 f"precision exceeds {EXT_FACTOR} x the twin's {e_t:.3e}")
        held = (e_k, e_t)
    return rel, ab, held


def phase_captured(torch, kernels, label, groups_by_name, quiet=False):
    """Phases 5b, 7 and 8: each kernel against its twin (:func:`hold`) on
    the exact inputs the main path gave it, one group per (w, spec, P_b)
    and per (kb, mb, mode), the redesigned ones (REPEATED) also launched
    twice for the same bits.  Times: the kernel and its library call by
    :func:`cuda_ms` (TIMING_REPS after a warm call, the same inputs), the
    kernel's one-call :func:`timed` figure (its wrapper's host work
    included) printed beside, the twin one :func:`timed` call (the
    reference of the hold); ``quiet``
    prints the sums alone.  Returns, per kernel, the worst absolute
    kernel-twin difference, the summed kernel, twin, bound and library
    milliseconds over the groups, and the kernel/twin error ratios of the
    groups held against extended precision."""
    rec = {}
    for name, groups in groups_by_name.items():
        kname, pname, _err, _ext, cost, library = CAPTURED[name]
        kernel, plain = getattr(kernels, kname), getattr(kernels, pname)
        ms = ms_1 = plain_ms = worst = lib_ms = bnd = flops = nbyte = 0.0
        ext_ratios = []
        for key, (args, kw) in sorted(groups.items()):
            # the twin once: its time, and the reference of the hold
            ref, t_p = timed(torch, lambda: plain(*args, **kw))
            rel, ab, held = hold(torch, kernels, label, name, key, args, kw, ref)
            del ref
            if held is not None:
                ext_ratios.append(held[0] / max(held[1], 1e-300))
            kw_t = dict(kw)
            if kw.get("shape") is not None:
                # the main path's fills scatter into a zeroed buffer made
                # once per bucketed shape; so do the timed calls
                G, shape = args[0].shape[0], kw["shape"]
                kw_t.update(out=torch.zeros((G, shape[0] + 1) + tuple(shape[1:]),
                                            dtype=args[0].dtype, device=args[0].device),
                            slot=list(range(G)))
            call = lambda: kernel(*args, **kw_t)  # noqa: E731
            out, t_1 = timed(torch, call)
            if name in REPEATED:  # a fill's second launch gets a fresh zeroed buffer
                again = call if "out" not in kw_t else (
                    lambda: kernel(*args, **{**kw_t, "out": torch.zeros_like(kw_t["out"])}))
                check_repeatable(torch, f"{label}: {name} {key}", again,
                                 tuple(t.clone() for t in rsf_outputs(out)))
            t_k = cuda_ms(call, TIMING_REPS)
            f, b = (float(x) for x in cost(torch, args, kw, out))
            del out
            t_b, _ = bound_ms(f, b)
            t_l = library(torch, args, kw) if library is not None else None
            if not quiet:
                print(f"{label}: {name} {key} G={args[0].shape[0]}: rel err {rel:.3e}"
                      + ("; repeatable" if name in REPEATED else "")
                      + f"; kernel {t_k:.3f} ms (one call {t_1:.3f} ms), plain {t_p:.3f} ms, "
                      f"bound {t_b:.4f} ms"
                      + (f", library {t_l:.3f} ms" if t_l is not None else ""), flush=True)
            ms, ms_1, plain_ms, worst = ms + t_k, ms_1 + t_1, plain_ms + t_p, max(worst, ab)
            bnd, flops, nbyte = bnd + t_b, flops + f, nbyte + b
            lib_ms += t_l or 0.0
        by = bound_ms(flops, nbyte)[1]
        print(f"{label}: {name} on {len(groups)} main-path groups: kernel {ms:.3f} ms (one "
              f"call each {ms_1:.3f} ms), plain {plain_ms:.3f} ms, bound {bnd:.4f} ms ({by}; "
              f"{flops:.3e} operations, {nbyte:.3e} bytes)"
              + (f", {LIBRARY_LABEL[name]} {lib_ms:.3f} ms" if library is not None else ""),
              flush=True)
        rec[name] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
                     "bound_by": by,
                     "library_ms": lib_ms if library is not None and name not in COMPOSITION
                     else None, "ext_ratios": ext_ratios}
        if name in COMPOSITION:
            rec[name]["composition_ms"] = lib_ms
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
def slater_capture(slater, fw, every=()):
    """Wraps the Slater path's kernel entry points for the duration: each
    call goes through, and the inputs of the first group per shape are kept
    (``fills`` per (w, spec, P_b), ``overlaps`` per (kb, mb, mode),
    ``slabs`` per (side, kb, keb, fb, Wb), and for the rank-update path
    ``swap_tables`` per (m, w_b), ``swap_fills`` per (mode, s_b, w_b, P_b,
    spec), ``det_rows`` per (w, n)), with sites per (w, P_b) in ``widths``
    and per (kb, mb) in ``kbs``, and the real (unpadded) pairs of the
    det_fill and of the scatter-mode swap_fill groups in ``pairs`` (device
    counts, no synchronisation).  Every group of a kernel named in
    ``every`` is also kept in ``every`` as (kernel, shape key, (args,
    kw))."""
    cap = {"widths": Counter(), "kbs": Counter(), "fills": {}, "overlaps": {}, "slabs": {},
           "swap_tables": {}, "swap_fills": {}, "det_rows": {}, "every": [],
           "pairs": {"direct": 0, "swap": 0}}
    names = ("det_fill", "site_overlap_schur", "swap_tables", "swap_fill", "det_rows")
    orig = {n: getattr(slater, n) for n in names}
    slab = fw.fw_frame_slab

    def keep(kind, name, key, group):
        cap[kind].setdefault(key, group)
        if name in every:
            cap["every"].append((name, key, group))

    # the fills write into the conversion's own buffers (out, slot); the
    # groups are kept without them, so that held and timed calls get fresh
    # ones and leave the state alone
    def fill_rec(M, det, ob, ok, pr, pc, tabs, *, out=None, slot=None, **kw):
        cap["widths"][(ob.shape[-1], pr.shape[-1])] += M.shape[0]
        cap["pairs"]["direct"] = cap["pairs"]["direct"] + (pr != ob.shape[1] - 1).sum()
        keep("fills", "det_fill", (ob.shape[-1], kw["spec"], pr.shape[-1]),
             ((M, det, ob, ok, pr, pc, tabs), kw))
        return orig["det_fill"](M, det, ob, ok, pr, pc, tabs, **kw, out=out, slot=slot)

    def overlap_rec(fb, fk, colb, *a, kb, mode):
        cap["kbs"][(kb, colb.shape[-1])] += fb.shape[0]
        keep("overlaps", "site_overlap_schur", (kb, colb.shape[-1], mode),
             ((fb, fk, colb, *a), {"kb": kb, "mode": mode}))
        return orig["site_overlap_schur"](fb, fk, colb, *a, kb=kb, mode=mode)

    def tables_rec(M, r0, c0):
        keep("swap_tables", "swap_tables", (M.shape[-1], r0.shape[-1]), ((M, r0, c0), {}))
        return orig["swap_tables"](M, r0, c0)

    def swap_rec(*a, s_b, spec=None, shape=None, out=None, slot=None):
        scatter = len(a) > 17
        kw = {"s_b": s_b, **({"spec": spec, "shape": shape} if scatter else {})}
        if scatter:
            cap["pairs"]["swap"] = cap["pairs"]["swap"] + (a[15] != a[7].shape[1] - 1).sum()
        keep("swap_fills", "swap_fill", ("fill" if scatter else "probe", s_b, a[3].shape[-1],
                                         a[15].shape[-1], spec), (a, kw))
        return orig["swap_fill"](*a, **kw, **({"out": out, "slot": slot} if scatter else {}))

    def rows_rec(M, ib, ik, scale=None, *, cross=False):
        keep("det_rows", "det_rows", (ib.shape[-1], ib.shape[1]),
             ((M, ib, ik, scale), {"cross": cross}))
        return orig["det_rows"](M, ib, ik, scale, cross=cross)

    def slab_rec(VT, flat, Cmat, **kw):
        cap["slabs"].setdefault((kw["side"], kw["kb"], Cmat.shape[-1], kw["fb"], kw["Wb"]),
                                ((VT, flat, Cmat), kw))
        return slab(VT, flat, Cmat, **kw)

    for n, f in zip(names, (fill_rec, overlap_rec, tables_rec, swap_rec, rows_rec)):
        setattr(slater, n, f)
    fw.fw_frame_slab = slab_rec
    try:
        yield cap
    finally:
        for n, f in orig.items():
            setattr(slater, n, f)
        fw.fw_frame_slab = slab


METER_SLEEP_CYCLES = 2_000_000
"""Device clock cycles (~1 ms on an H100) that :class:`ConversionMeter`
keeps the stream busy before each metered launch, so that the event
before the launch completes only after the wrapper's host work has queued
the kernel and the events bracket its device work alone (with det_fill's
slot upload, a few bytes).  The metered conversion is timed by no one."""


class ConversionMeter:
    """Meters every launch of the kernels it wraps over whole conversions:
    per record, the launches, the device milliseconds (CUDA events around
    each call after a short device sleep, so the wrapper's host time is not
    counted, unless the wrapper synchronises: K6b's scatter mode uploads its
    slot table with a synchronous copy, and the host work after it lands
    inside the events) and the operations and bytes of the call's cost
    function, summed over every launch.  Read :meth:`totals` after the
    conversions."""

    def __init__(self, torch):
        self.torch = torch
        self.per = {}

    def wrap(self, fn, key, cost):
        """``fn`` with each call metered into record ``key(args, kw)``;
        ``cost(args, kw, out)`` gives its (operations, bytes), host numbers
        or device tensors (``out``/``slot`` keywords are not passed to
        either)."""
        torch = self.torch

        def call(*args, **kw):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            torch.cuda._sleep(METER_SLEEP_CYCLES)
            ev[0].record()
            out = fn(*args, **kw)
            ev[1].record()
            work = {k: v for k, v in kw.items() if k not in ("out", "slot")}
            f, b = cost(args, work, out)
            rec = self.per.setdefault(key(args, work), {"launches": 0, "events": [],
                                                        "flops": 0.0, "bytes": 0.0})
            rec["launches"] += 1
            rec["events"].append(ev)
            rec["flops"] = rec["flops"] + f
            rec["bytes"] = rec["bytes"] + b
            return out
        return call

    def totals(self):
        """Per record: launches, device ``ms``, ``flops``, ``bytes`` and the
        bound of that work (``bound_ms``, ``bound_by``)."""
        self.torch.cuda.synchronize()
        out = {}
        for name, rec in sorted(self.per.items()):
            f, b = float(rec["flops"]), float(rec["bytes"])
            t_b, by = bound_ms(f, b)
            out[name] = {"launches": rec["launches"], "flops": f, "bytes": b, "bound_ms": t_b,
                         "bound_by": by,
                         "ms": sum(a.elapsed_time(e) for a, e in rec["events"])}
        return out

    def report(self, label, what):
        for name, c in self.totals().items():
            print(f"{label}: {what}, {name}: {c['launches']} launches, device {c['ms']:.3f} ms "
                  f"(events around each launch), bound {c['bound_ms']:.4f} ms "
                  f"({c['bound_by']}; {c['flops']:.4e} operations, {c['bytes']:.4e} bytes)",
                  flush=True)


@contextlib.contextmanager
def patched(owner, **attrs):
    """Sets attributes of ``owner`` for the block, restoring them after."""
    saved = {k: getattr(owner, k) for k in attrs}
    for k, v in attrs.items():
        setattr(owner, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(owner, k, v)


def fill_meter(torch, slater, kernels, meter):
    """The patches that meter every K1/K2 launch of a Slater conversion
    (``site_overlap_schur`` or ``site_overlap_schur_gmem`` by the width's
    dispatch), for :func:`patched` on ``slater``."""
    def overlap_key(args, kw):
        return ("site_overlap_schur" if kernels.site_overlap_fits_smem(args[2].shape[-1],
                                                                       args[0].dtype)
                else "site_overlap_schur_gmem")

    return {"det_fill": meter.wrap(slater.det_fill, lambda a, k: "det_fill",
                                   lambda a, k, o: det_fill_cost(torch, a, k, o)),
            "site_overlap_schur": meter.wrap(slater.site_overlap_schur, overlap_key,
                                             lambda a, k, o: overlap_cost(torch, a, k, o))}


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
    for name, kind in (("swap_tables", "swap_tables"), ("swap_fill", "swap_fills"),
                       ("det_rows", "det_rows")):
        if cap[kind]:
            groups[name] = cap[kind]
    rec = phase_captured(torch, kernels, label, groups)
    if cap["slabs"]:
        rec["fw_frame_slab"] = fw_captured(torch, kernels, label, cap["slabs"])
    return rec


def slater_slice(torch, np, slater, fw, kernels, profiling, H, chi, label, counted,
                 bounds=None, every=(), hold_fill=True, profile=None, canon=True, once=False):
    """Phases 5, 7, 8 and 9: ``slater.H_to_MPS`` of H at ``chi`` on the card,
    cold (the launch counts of ``counted`` set to 0 just before and read
    just after, with the rank-update statistics) and warm (stage profile,
    the kernels' input shapes, and the inputs of one group per shape, held
    against the twins unless ``hold_fill`` is False; every group of the
    kernels in ``every`` is kept in the capture); ``once``: one conversion
    is both (the L=1024 phases, whose two runs took the same time within
    5%); then the checks of :func:`check_slater_state` (``canon``: with its
    canonical_form_finite round, on a copy of the state under ``once``) and
    a device profile of one more conversion, or of the callable ``profile``
    where given.  The FW cache is cleared before each conversion, so each
    runs its own sweep.  Returns a dict: ``launches``, ``rec`` (records),
    ``raw`` (the warm run's state as converted), ``cap`` (the warm run's
    capture), ``warm`` (seconds), ``prof`` (its stage profile) and
    ``stats``."""
    L = H.shape[0]
    tp = {"chi_max": chi}

    def run():
        fw.fw_clear_cache()
        return slater.H_to_MPS(H, tp, device="cuda")

    def counts(t_run, what):
        launches = {name: getattr(kernels, name).launches for name in counted}
        stats = dict(slater._swap_stats())
        print(f"{label}: {what} conversion {t_run:.3f} s; launches {launches}; rank-update "
              f"classes {stats}", flush=True)
        for name, n in launches.items():
            if n <= 0:
                raise AssertionError(f"kernel {name} was not launched by the main path")
        if "fw_frame_slab" in counted and fw._CACHE[-1][1] is None:
            raise AssertionError(f"{label}: the FW sweep fell back to the exact frontend")
        return launches, stats

    for name in counted:
        getattr(kernels, name).launches = 0
    if not once:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        mps = run()
        torch.cuda.synchronize()
        launches, stats = counts(time.perf_counter() - t0, "cold")

    # warm run: stage profile, the shapes the kernels were given, and the
    # inputs of the first group of each shape
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with slater_capture(slater, fw, every) as cap, profiling.collect() as prof:
        t0 = time.perf_counter()
        raw = run()
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
    if once:
        launches, stats = counts(warm, "counted")
        mps = copy.deepcopy(raw) if canon else raw
    widths, kbs = cap["widths"], cap["kbs"]
    peak = torch.cuda.max_memory_allocated()
    print(f"{label}: {'the same' if once else 'warm'} conversion {warm:.3f} s (stages "
          f"synchronised); max_memory_allocated {peak / 2**20:.1f} MiB, of it "
          f"{resident / 2**20:.1f} MiB resident before the run", flush=True)
    print(prof.report(), flush=True)
    pairs = Counter()
    for (w, P_b), g in widths.items():
        pairs[w] += P_b * g
    print(f"{label}: det_fill (w, P_b) -> sites:", dict(sorted(widths.items())), flush=True)
    print(f"{label}: padded pairs per width:", dict(sorted(pairs.items())),
          f"total {sum(pairs.values())}", flush=True)
    print(f"{label}: site_overlap_schur (kb, mb) -> sites:", dict(sorted(kbs.items())),
          flush=True)
    rec = check_captured_slater(torch, kernels, label, cap) if hold_fill else {}
    check_slater_state(torch, np, slater, mps, H, chi, label, bounds, canon=canon)
    device_profile(torch, profile or run, label)
    return {"launches": launches, "rec": rec, "raw": raw, "cap": cap, "warm": warm,
            "prof": prof, "stats": stats}


def check_slater_state(torch, np, slater, mps, H, chi, label, bounds, canon=True):
    """The exact parts of a Slater MPS: chi, normalised Schmidt values,
    label and tensor dimensions, finite tensors, charge conservation, edge
    canonicality (sites 0 and L-1), sum <n_i> = N, and exact canonicality
    after ``canonical_form_finite`` at sites 0, L/2, L-1 with the state
    unchanged (``canon`` False leaves that round out).  The chi
    truncation's effects (the centre's Schmidt-weighted residual, <n_i>
    against C) are printed, and held to ``bounds`` where given."""
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
    if not canon:
        return

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
    """Phase 5: bench config 1 at L=256, chi=512 (the exact frontend, the
    direct fill: the card's defaults).  The per-site densities carry the chi
    truncation: 7.0e-3 on this state on the H100, so their bound is 1e-2,
    as is the centre's Schmidt-weighted residual's (1.7e-3 measured)."""
    return slater_slice(torch, np, slater, fw, kernels, profiling, cylinder(8, 256), 512,
                        "phase 5", ("det_fill", "site_overlap_schur"), bounds=PHASE5_BOUNDS)


PHASE5_BOUNDS = {"weighted_residual": 1e-2, "n": 1e-2}
"""Phases 5 and 8, bench config 1 at L=256, chi=512: bounds on what the chi
truncation moves (see :func:`phase_full`)."""


def stream_block(slater, H, chi, fw_host=False):
    """A callable that runs one stream block of ``slater.C_to_MPS`` on the
    card: the frontend, the Schmidt enumeration and the site fills of the
    first 64 cuts right of the centre (``fw_host``: with the host copy of
    C the FW frontend takes).  The device profiles of the L=1024 phases
    cover this window: a whole conversion takes the profiler minutes to
    process (the RSF one holds ~1.3 million cuSOLVER kernels)."""
    C, N = slater.correlation_matrix(H, device="cuda")
    c = C.shape[0] // 2
    tp = slater.to_stopping_condition({"chi_max": chi})
    centre = slater.SchmidtVectors.from_correlation_matrix(C, c, tp, diag_tol=1e-8)
    C_host = C.cpu().numpy() if fw_host else None

    def run():
        svs = slater._schmidt_vectors_batched(C, list(range(c + 1, c + 65)), "R", tp, 1e-8,
                                              64, N, C_host)
        return slater.build_site_tensors(
            [(sv, prev, "right") for sv, prev in zip(svs, [centre] + svs[:-1])])
    return run


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
    for kernel in ("det_fill_kernel", "site_overlap_kernel", "site_schur_kernel",
                   "fw_frame_slab_kernel", "pf_fill_kernel",
                   "bdg_products_kernel", "bdg_eliminate_kernel", "bdg_eliminate_gmem_kernel",
                   "swap_inverse_kernel", "swap_inverse_wide_kernel", "swap_products_kernel",
                   "swap_fill_kernel", "det_rows_kernel", "rsf_apply_kernel",
                   "rsf_gram_kernel", "rsf_combine_kernel", "rsf_ritz_shift_kernel",
                   "rsf_ritz_select_kernel", "rsf_frames_stats_kernel",
                   "rsf_frames_place_kernel"):
        hits = [(us, n) for us, name, n in rows if kernel in name]
        if hits:
            print(f"{label}: {kernel} device time in the conversion "
                  f"{sum(h[0] for h in hits) / 1e3:.3f} ms in {sum(h[1] for h in hits)} launches",
                  flush=True)


# --------------------------------------------------------------------------
# BdG / Pfaffian slice
# --------------------------------------------------------------------------


def skew_update_entries(t):
    """Entries Parlett-Reid updates in a (2t x 2t) skew-symmetric matrix:
    step i (of t) updates the strict upper triangle of the trailing
    (2t - 2 - 2i)-wide block, sum_q (2q)(2q - 1)/2 = (t-1)t(2t-1)/3 -
    (t-1)t/2 (the lower triangle follows by skew symmetry), two
    multiply-adds each: about k^3/12 entries, k^3/3 real operations, for
    width k = 2t."""
    return (t - 1) * t * (2 * t - 1) / 3 - (t - 1) * t / 2


def pf_fill_cost(torch, args, kw, out):
    """(operations, bytes) of one pf_fill group: per pair of tot = nk + nb
    excitations, the Parlett-Reid updates of :func:`skew_update_entries`,
    two complex multiply-adds each; pad pairs need nothing.  Every input
    once and one value per real pair."""
    N, norm, pb, pk, cb, ck, pr, pc, tabs = args
    t = (torch.gather(cb, 1, pr.long()) + torch.gather(ck, 1, pc.long())).double() / 2
    return (float(skew_update_entries(t).sum()) * 2 * CMA_FLOP,
            nbytes(*args) + written_bytes(pr, pb.shape[1] - 1, N))


def bdg_overlap_cost(np, args, out, k1, k2):
    """(operations, bytes) of one bdg_overlap group: what the function
    needs, not what the kernel does.  Per site, with k1/k2 its real active
    counts (not their buckets), complex multiply-adds for the blocks U*
    (nb^2 2nb), Vr[j1, nb:] and Vr[nb:, j2] ((k1 + k2) nb 2nb), an LU of U*
    (nb^3 / 3) with the k1 column and k2 row solves of U*^-1 that AA, BA
    and BB read ((k1 + k2) nb^2), and the off-diagonal entries of P U*^-1
    and U*^-1 Q that AA and BB antisymmetrise (k (k - 1) nb: each entry
    once).  Inputs and outputs once."""
    nb = args[0].shape[-1]
    k1, k2 = np.asarray(k1, float), np.asarray(k2, float)
    cma = (2 * nb**3 + (k1 + k2) * 2 * nb * nb + nb**3 / 3 + (k1 + k2) * nb * nb
           + (k1 * (k1 - 1) + k2 * (k2 - 1)) * nb)
    return float(cma.sum()) * CMA_FLOP, nbytes(*args, *out)


def bdg_library_ms(torch, kernels, args):
    """Milliseconds (:func:`cuda_ms`, TIMING_REPS) of a library composition
    of bdg_overlap's function on one group, for reference (no single call
    computes it): ``torch.bmm`` for Vr = V1^H V2 of the full Nambu frames
    (built before the timing), ``torch.linalg.lu_factor`` and ``lu_solve``
    for U*^-1 with |det U*| from the LU's diagonal, the gathers and two
    ``torch.bmm`` for AA and BB, the antisymmetrisation and the norm."""
    V1h, V2h, j1, j2, thresh = args
    V1, V2 = kernels.nambu_full(V1h), kernels.nambu_full(V2h)
    G, nb, k1, k2 = V1h.shape[0], V1h.shape[2], j1.shape[1], j2.shape[1]
    j1, j2 = j1.long(), j2.long()
    eye = torch.eye(nb, dtype=V1.dtype, device=V1.device).expand(G, nb, nb)

    def run():
        Vr = torch.bmm(V1.mH, V2)
        LU, piv = torch.linalg.lu_factor(Vr[:, nb:, nb:])
        Ui = torch.linalg.lu_solve(LU, piv, eye)
        absdet = LU.diagonal(dim1=1, dim2=2).abs().prod(1)
        norm = torch.where(~torch.isfinite(absdet) | (absdet < thresh),
                           torch.full_like(absdet, float("nan")), absdet.sqrt())
        AA = torch.bmm(torch.gather(Vr[:, :, nb:], 1, j1[:, :, None].expand(-1, -1, nb)),
                       torch.gather(Ui, 2, j1[:, None, :].expand(-1, nb, -1)))
        Uj2 = torch.gather(Ui, 1, j2[:, :, None].expand(-1, -1, nb))
        BA = torch.gather(Uj2, 2, j1[:, None, :].expand(-1, k2, -1))
        BB = torch.bmm(Uj2, torch.gather(Vr[:, nb:, :], 2, j2[:, None, :].expand(-1, nb, -1)))
        AA, BB = (AA - AA.mT) / 2, (BB - BB.mT) / 2
        return torch.cat([torch.cat([BB, BA], 2), torch.cat([-BA.mT, AA], 2)], 1), norm

    return cuda_ms(run, TIMING_REPS)


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


def bdg_recorders(pfaffian, overlaps, active, nbs, current=None):
    """Wrappers of ``pfaffian.bdg_overlap`` and ``pfaffian._overlap_group``
    that keep the inputs of the first group per (nb, k1_b, k2_b) in
    ``overlaps``, count its sites in ``nbs`` and each site's real active
    counts k1, k2 in ``active`` (and those of the group being launched in
    ``current[0]``, for a meter's cost); they call the wrapped functions."""
    overlap, group = pfaffian.bdg_overlap, pfaffian._overlap_group

    def group_rec(plans, device):
        # each site's real active counts, from its N-slot sets
        # [ket (k2_b) | bra (k1_b)] (every real slot is used by some set)
        k2_b = len(plans[0]["j2"])
        counts = ([int(p["fields"]["sets_bra"][:, k2_b:].any(0).sum()) for p in plans],
                  [int(p["fields"]["sets_ket"][:, :k2_b].any(0).sum()) for p in plans])
        active.setdefault((plans[0]["frames"][0].shape[-1], len(plans[0]["j1"]), k2_b), counts)
        if current is not None:
            current[:] = [counts]
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
    "bdg_overlap_wide": ("bdg_overlap", "bdg_overlap_plain", bdg_err,
                         lambda torch, np, a, kw, out, act: bdg_overlap_cost(np, a, out, *act)),
}


def pf_records(torch, np, kernels, label, name, groups, active, failures):
    """The record of one BdG kernel over captured main-path groups: each
    group against the twin (a miss is appended to ``failures``) and
    launched twice for the same bits, the kernel's milliseconds
    (:func:`cuda_ms`, TIMING_REPS after a warm call; the one-call
    :func:`timed` figure printed beside), the twin's (one call), the bound,
    and for bdg_overlap the library composition of :func:`bdg_library_ms`
    (``composition_ms``; no single call computes the function)."""
    kname, pname, err, cost = PF_RECORDS[name]
    kernel, plain = getattr(kernels, kname), getattr(kernels, pname)
    ms = plain_ms = worst = bnd = flops = nbyte = comp = 0.0
    for key, (args, kw) in sorted(groups.items()):
        rel, ab = err(torch, kernels, args, kw)
        call = lambda: kernel(*args, **kw)  # noqa: E731
        out, t_1 = timed(torch, call)
        check_repeatable(torch, f"{label}: {name} {key}", call,
                         tuple(t.clone() for t in rsf_outputs(out)))
        t_k = cuda_ms(call, TIMING_REPS)
        _, t_p = timed(torch, lambda: plain(*args, **kw))
        f, b = cost(torch, np, args, kw, out, active.get(key))
        t_b, _ = bound_ms(f, b)
        t_c = bdg_library_ms(torch, kernels, args) if kname == "bdg_overlap" else None
        print(f"{label}: {name} {key} G={args[0].shape[0]}: rel err {rel:.3e} abs err "
              f"{ab:.3e}; repeatable; kernel {t_k:.3f} ms (one call {t_1:.3f} ms), plain "
              f"{t_p:.3f} ms, bound {t_b:.4f} ms"
              + (f", library composition {t_c:.3f} ms" if t_c is not None else ""), flush=True)
        if not rel <= KERNEL_RTOL:
            failures.append(f"{name} {key}: rel err {rel:.3e} > {KERNEL_RTOL}")
        ms, plain_ms, worst = ms + t_k, plain_ms + t_p, max(worst, ab)
        bnd, flops, nbyte, comp = bnd + t_b, flops + f, nbyte + b, comp + (t_c or 0.0)
    by = bound_ms(flops, nbyte)[1]
    print(f"{label}: {name} on {len(groups)} main-path groups: kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bnd:.4f} ms ({by}; {flops:.3e} operations, "
          f"{nbyte:.3e} bytes)"
          + (f", library composition {comp:.3f} ms" if kname == "bdg_overlap" else ""),
          flush=True)
    rec = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
           "bound_by": by, "library_ms": None}
    if kname == "bdg_overlap":
        rec["composition_ms"] = comp
    return rec


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
        check_repeatable(torch, f"phase 3b: pf_fill w={w} {spec}",
                         lambda: kernels.pf_fill(*a, **kw), kernels.pf_fill(*a, **kw))
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
            check_repeatable(torch, f"phase 3b: bdg_overlap nb={nb} {mode}",
                             lambda: kernels.bdg_overlap(*a), kernels.bdg_overlap(*a))
            t_k = cuda_ms(lambda: kernels.bdg_overlap(*a), 10)
            t_p = cuda_ms(lambda: kernels.bdg_overlap_plain(*a), 2)
            print(f"phase 3b: bdg_overlap nb={nb} k1={k1} k2={k2} x={x} {mode} G=64: rel err "
                  f"{rel:.3e}, repeatable; kernel {t_k:.3f} ms, plain {t_p:.3f} ms", flush=True)
            worst["bdg_overlap"] = max(worst["bdg_overlap"], ab)
    return worst


def spectra_diff(np, a, b, label="", qtotal=False):
    """(max Schmidt-value difference, max squared-Schmidt-value difference)
    per bond and charge (or parity) between two MPS, finite or infinite,
    with identical bond labels and, with ``qtotal``, identical tensor
    charges.  The per-charge squared values are what
    ``entanglement_spectrum(by_charge=True)`` lists (as -log S^2)."""
    d1 = d2 = 0.0
    for bnd in range(a.L + 1):
        qa, qb = a.q_bond[bnd], b.q_bond[bnd]
        if not np.array_equal(qa, qb):
            raise AssertionError(f"{label}: bond {bnd}: charge labels differ")
        for q in np.unique(qa):
            sa, sb = np.sort(a.get_SL(bnd)[qa == q]), np.sort(b.get_SL(bnd)[qb == q])
            d1 = max(d1, float(np.abs(sa - sb).max()))
            d2 = max(d2, float(np.abs(sa**2 - sb**2).max()))
    if qtotal and not np.array_equal(a.qtotal, b.qtotal):
        raise AssertionError(f"{label}: tensor charges differ")
    return d1, d2


def padded_spectra_diff(np, a, b):
    """Max squared-Schmidt-value difference per bond and charge between two
    MPS whose labels may differ in length: each sector's values sorted in
    descending order, the shorter padded with zeros."""
    d = 0.0
    for bnd in range(a.L + 1):
        qa, qb = a.q_bond[bnd], b.q_bond[bnd]
        for q in np.union1d(qa, qb):
            sa = np.sort(a.get_SL(bnd)[qa == q] ** 2)[::-1]
            sb = np.sort(b.get_SL(bnd)[qb == q] ** 2)[::-1]
            n = max(len(sa), len(sb))
            d = max(d, float(np.abs(np.pad(sa, (0, n - len(sa)))
                                    - np.pad(sb, (0, n - len(sb)))).max()))
    return d


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
    # every bdg_overlap launch of the warm run metered, each at its group's
    # real active counts
    meter, current = ConversionMeter(torch), [None]
    pfaffian.bdg_overlap = meter.wrap(overlap, lambda a, k: "bdg_overlap",
                                      lambda a, k, o: bdg_overlap_cost(np, a, o, *current[0]))
    overlap_rec, group_rec = bdg_recorders(pfaffian, overlaps, active, nbs, current)

    conv = [0, 0.0, 0.0]  # pf_fill launches, operations, bytes of the warm run

    def fill_rec(*a, **kw):
        t = (a[4].gather(1, a[6].long()) + a[5].gather(1, a[7].long()))
        for tot, n in zip(*torch.unique(t[t > 0], return_counts=True)):
            widths[int(tot)] += int(n)
        fills.setdefault((kw["width"], kw["spec"], a[6].shape[-1]), (a, kw))
        f, b = pf_fill_cost(torch, a, kw, None)
        conv[:] = conv[0] + 1, conv[1] + f, conv[2] + b
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
    print(f"phase 6: warm conversion {warm:.3f} s (stages synchronised; each bdg_overlap "
          f"launch metered behind a ~1 ms device sleep); max_memory_allocated "
          f"{peak / 2**20:.1f} MiB", flush=True)
    meter.report("phase 6", "warm conversion")
    print(prof.report(), flush=True)
    print("phase 6: real pairs per Pfaffian size tot:", dict(sorted(widths.items())),
          f"total {sum(widths.values())}", flush=True)
    print("phase 6: bdg_overlap (nb, k1_b, k2_b) -> sites:", dict(sorted(nbs.items())),
          flush=True)
    t_b, by = bound_ms(conv[1], conv[2])
    print(f"phase 6: warm conversion, pf_fill: {conv[0]} launches, bound {t_b:.4f} ms ({by}; "
          f"{conv[1]:.4e} operations, {conv[2]:.4e} bytes; device time: the profiled "
          f"conversion below)", flush=True)

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
    return cuda_ms(lambda: torch.bmm(VX, Cmat), TIMING_REPS)


def fw_captured(torch, kernels, label, slabs):
    """fw_frame_slab against its twin on the slabs a conversion gave it,
    one per (side, kb, keb, fb, Wb), with a second launch that must return
    the same bits, times (kernel and library call alike by :func:`cuda_ms`,
    TIMING_REPS; the kernel's one-call time, its wrapper's host work
    included, printed beside), bound and library call."""
    ms = ms_1 = plain_ms = worst = lib_ms = bnd = flops = nbyte = 0.0
    for key, (args, kw) in sorted(slabs.items()):
        call = lambda: kernels.fw_frame_slab(*args, **kw)  # noqa: E731
        out = call()
        rel, ab = rel_err(out, kernels.fw_frame_slab_plain(*args, **kw))
        if not (rel <= KERNEL_RTOL and float(out.abs().max()) > 0):
            raise AssertionError(f"{label}: fw_frame_slab {key}: rel err {rel:.3e} > "
                                 f"{KERNEL_RTOL}")
        check_repeatable(torch, f"{label}: fw_frame_slab {key}", call, out)
        del out
        t_1 = timed(torch, call)[1]
        t_k = cuda_ms(call, TIMING_REPS)
        t_p = cuda_ms(lambda: kernels.fw_frame_slab_plain(*args, **kw), 1)
        f, b = fw_slab_cost(torch, args, kw, None)
        t_b, _ = bound_ms(f, b)
        t_l = fw_library_ms(torch, args, kw)
        print(f"{label}: fw_frame_slab (side, kb, keb, fb, Wb)={key}: rel err {rel:.3e}, "
              f"repeatable; kernel {t_k:.3f} ms (one call {t_1:.3f} ms), plain {t_p:.3f} ms, "
              f"bmm {t_l:.3f} ms, bound {t_b:.4f} ms", flush=True)
        ms, ms_1, plain_ms, worst = ms + t_k, ms_1 + t_1, plain_ms + t_p, max(worst, ab)
        lib_ms, bnd, flops, nbyte = lib_ms + t_l, bnd + t_b, flops + f, nbyte + b
    by = bound_ms(flops, nbyte)[1]
    print(f"{label}: fw_frame_slab on {len(slabs)} main-path slabs: kernel {ms:.3f} ms (one "
          f"call each {ms_1:.3f} ms), plain {plain_ms:.3f} ms, bound {bnd:.4f} ms ({by}; "
          f"{flops:.3e} operations, {nbyte:.3e} bytes), torch.bmm of the pre-gathered masked VX "
          f"with Cmat {lib_ms:.3f} ms", flush=True)
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
            "bound_by": by, "library_ms": lib_ms}


def phase_fw_kernels(torch, kernels, testing):
    """Phase 3c: fw_frame_slab and the two global-memory kernels against
    their twins on seeded inputs.  Returns the worst absolute error per
    kernel."""
    dev = torch.device("cuda")
    worst = {"fw_frame_slab": 0.0, "site_overlap_schur_gmem": 0.0, "bdg_overlap_wide": 0.0}
    # K9 at the L=1024 slab shape (B=64, Wb=512) with Xidx, Fidx = -1 and
    # colmap pads and 5 pad cuts (a short last slab)
    L, B, fb, Wb = 1024, 64, 64, 512
    for kb, keb in ((64, 64), (512, 256), (1024, 512)):
        a = [torch.as_tensor(x, device=dev) for x in testing.random_fw_slab_case(
            kb + keb, L=L, B=B, kb=kb, keb=keb, fb=fb, Wb=Wb)]
        for side in ("L", "R"):
            kw = {"side": side, "L": L, "kb": kb, "fb": fb, "Wb": Wb}
            call = lambda: kernels.fw_frame_slab(*a, **kw)  # noqa: E731
            out = call()
            rel, ab = rel_err(out, kernels.fw_frame_slab_plain(*a, **kw))
            if not (rel <= KERNEL_RTOL and float(out.abs().max()) > 0):
                raise AssertionError(f"fw_frame_slab kb={kb} keb={keb} {side}: rel err "
                                     f"{rel:.3e} > {KERNEL_RTOL}")
            check_repeatable(torch, f"phase 3c: fw_frame_slab kb={kb} keb={keb} {side}", call,
                             out)
            del out
            t_k = cuda_ms(call, TIMING_REPS)
            t_p = cuda_ms(lambda: kernels.fw_frame_slab_plain(*a, **kw), 1)
            t_l = fw_library_ms(torch, a, kw)
            print(f"phase 3c: fw_frame_slab L={L} B={B} kb={kb} keb={keb} fb={fb} Wb={Wb} {side}: "
                  f"rel err {rel:.3e}, repeatable; kernel {t_k:.3f} ms, plain {t_p:.3f} ms, "
                  f"torch.bmm {t_l:.3f} ms", flush=True)
            worst["fw_frame_slab"] = max(worst["fw_frame_slab"], ab)
    # K2's wide wrapper: mb = 192 and 320 (float64), 128 (complex128) in a
    # cluster; then always blocks no cluster holds, which take the
    # global-memory elimination: float64 kb=384 at mb=416, complex128
    # kb=160 at mb=320, float64 mb=600 (L=640)
    for kb, sb, dt, L in ((160, 32, "float64", 512), (288, 32, "float64", 512),
                          (96, 32, "complex128", 512), (384, 32, "float64", 512),
                          (160, 160, "complex128", 512), (64, 536, "float64", 640)):
        for mode in ("left", "right"):
            args, kw = testing.random_site_overlap_case(kb + sb, G=16, L=L, kb=kb, sb=sb,
                                                        mode=mode, dtype=dt)
            a = [torch.as_tensor(x, device=dev) for x in args]
            for i in (2, 3, 4, 6, 7, 8):
                a[i] = a[i].to(torch.int32)
            rel, ab = overlap_err(kernels.site_overlap_schur_gmem,
                                  kernels.site_overlap_schur_plain, a, kw)
            if not rel <= KERNEL_RTOL:
                raise AssertionError(f"site_overlap_schur_gmem mb={kb + sb} {mode} {dt}: rel "
                                     f"err {rel:.3e} > {KERNEL_RTOL}")
            call = lambda: kernels.site_overlap_schur_gmem(*a, **kw)  # noqa: E731
            check_repeatable(torch, f"phase 3c: site_overlap_schur_gmem kb={kb} sb={sb} {mode} "
                             f"{dt}", call, call())
            t_k = cuda_ms(call, 3)
            t_p = cuda_ms(lambda: kernels.site_overlap_schur_plain(*a, **kw), 1)
            nc = kernels.schur_layout(kb, kb + sb, a[0].dtype, wide=True)[0]
            print(f"phase 3c: site_overlap_schur_gmem {mode} {dt} G=16 L={L} kb={kb} sb={sb} ("
                  + (f"a cluster of {nc}" if nc else "the global-memory elimination")
                  + f"): rel err {rel:.3e}, repeatable; kernel {t_k:.3f} ms, plain {t_p:.3f} ms",
                  flush=True)
            worst["site_overlap_schur_gmem"] = max(worst["site_overlap_schur_gmem"], ab)
    # K4 past nb = 64: nb = 96 and 128 (clusters of 2 and 3), both sweep
    # layouts, and nb = 272, past what a cluster holds (the global-memory
    # elimination)
    both = ("left", "right")
    for nb, k1, k2, x, G, modes in ((96, 24, 24, 80, 32, both), (128, 32, 24, 120, 32, both),
                                    (272, 24, 16, 260, 8, ("right",))):
        for mode in modes:
            a = [torch.as_tensor(v, device=dev) for v in testing.random_bdg_overlap_case(
                nb + k1, G=G, nb=nb, k1=k1, k2=k2, x=x, mode=mode)]
            rel, ab = bdg_err(torch, kernels, a, {})
            if not rel <= KERNEL_RTOL:
                raise AssertionError(f"bdg_overlap nb={nb} {mode}: rel err {rel:.3e} > "
                                     f"{KERNEL_RTOL}")
            call = lambda: kernels.bdg_overlap(*a)  # noqa: E731
            check_repeatable(torch, f"phase 3c: bdg_overlap nb={nb} {mode}", call, call())
            t_k = cuda_ms(call, 3)
            t_p = cuda_ms(lambda: kernels.bdg_overlap_plain(*a), 1)
            nc = kernels.bdg_overlap_layout(nb)[0]
            print(f"phase 3c: bdg_overlap nb={nb} k1={k1} k2={k2} x={x} {mode} G={G} ("
                  + (f"a cluster of {nc}" if nc else "the global-memory elimination")
                  + f"): rel err {rel:.3e}, repeatable; kernel {t_k:.3f} ms, plain {t_p:.3f} ms",
                  flush=True)
            worst["bdg_overlap_wide"] = max(worst["bdg_overlap_wide"], ab)
    return worst


def with_env(name, value, fn):
    """``fn()`` with the environment variable ``name`` set to ``value``,
    restored after."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        return fn()
    finally:
        if old is None:
            os.environ.pop(name)
        else:
            os.environ[name] = old


def with_fw_mode(mode, fn):
    """``fn()`` with TEMFPY_TORCH_FW set to ``mode``."""
    return with_env("TEMFPY_TORCH_FW", mode, fn)


def with_det_updates(mode, fn):
    """``fn()`` with TEMFPY_TORCH_DET_UPDATES set to ``mode``."""
    return with_env("TEMFPY_TORCH_DET_UPDATES", mode, fn)


FW_PARITY_L = 24
"""Phase 4c's card-against-CPU FW parity: the W=8 cylinder at L=24, the
smallest length at which chi=48 binds as it does at L=768 (FW runs forced
on at every L).  At L=768 the CPU conversion, the card run with the twins
and the <c^dag c> rows (O(L^2) environment steps on two states) took
22.1, 15.9 and about 131 s on an H100 (PERF.md section 7)."""


def phase_fw_parity(torch, np, slater, fw, kernels):
    """Phase 4c: the FW frontend on the W=8 gapped cylinder with the seeded
    1e-3 disorder of tests/test_fw.py:126-148 (chi=48, svd_min=1e-5).

    - At L = 768, its auto-on scale: the card with FW (forced on,
      TEMFPY_TORCH_FW=1; K9 and the wide-site K2 counted) against the
      card's exact frontend (the default): FW_EXACT_TOL; and the K1/K2
      kernels against their twins on EVERY group of the card FW run, with
      phase 5's extended-precision rule for ill-conditioned groups (this
      state has always blocks with |det| down to 1e-48, where float64
      rounding alone parts kernel and twin).
    - At L = FW_PARITY_L: the GPU path against the CPU's (FW forced on, the
      twins): the card run with the K1/K2 twins on the card, PARITY_TOL on
      fidelity, squared Schmidt values and normalised <c^dag c> rows,
      charges equal (all FW runs of one length convert the same host array,
      so they share one sweep); the card state with the kernels against the
      CPU's at CARD_KERNEL_TOL, and the sites where kernels and twins part
      most printed."""
    parts = {}
    L = 768
    H = cylinder(8, L)  # the JAX FW test's cylinder (tests/test_fw.py:24-41)
    H += np.diag(1e-3 * np.random.default_rng(3).normal(size=L))
    tp = {"chi_max": 48, "svd_min": 1e-5}
    C = slater.correlation_matrix(H, device="cuda")[0].cpu().numpy()
    fw.fw_clear_cache()
    kernels.fw_frame_slab.launches = kernels.site_overlap_schur_gmem.launches = 0
    t0 = time.perf_counter()
    with slater_capture(slater, fw, every=("det_fill", "site_overlap_schur")) as cap:
        gpu = with_fw_mode("1", lambda: slater.C_to_MPS(C, tp, device="cuda"))
        torch.cuda.synchronize()
    parts["card FW"] = time.perf_counter() - t0
    launches = {"fw_frame_slab": kernels.fw_frame_slab.launches,
                "site_overlap_schur_gmem": kernels.site_overlap_schur_gmem.launches}
    if fw._CACHE[-1][1] is None:
        raise AssertionError("phase 4c: the FW sweep fell back to the exact frontend")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"phase 4c: kernel {name} was not launched")
    t0 = time.perf_counter()
    exact = slater.C_to_MPS(C, tp, device="cuda")
    torch.cuda.synchronize()
    parts["card exact"] = time.perf_counter() - t0
    f_ex = fidelity(np, gpu, exact)
    print(f"phase 4c: W=8 L={L} chi=48 svd_min=1e-5, launches {launches}: FW vs exact 1 - "
          f"fidelity {1 - f_ex:.3e}", flush=True)
    if not 1 - f_ex <= FW_EXACT_TOL:
        raise AssertionError(f"phase 4c: FW vs exact 1 - fidelity {1 - f_ex:.3e} > {FW_EXACT_TOL}")
    del gpu, exact
    t0 = time.perf_counter()
    hold_every(torch, kernels, "phase 4c", cap)
    fw_captured(torch, kernels, "phase 4c", cap["slabs"])
    parts["holds"] = time.perf_counter() - t0
    del cap

    t0 = time.perf_counter()
    L = FW_PARITY_L
    H = cylinder(8, L)
    H += np.diag(1e-3 * np.random.default_rng(3).normal(size=L))
    C = slater.correlation_matrix(H, device="cuda")[0].cpu().numpy()
    fw.fw_clear_cache()
    gpu = with_fw_mode("1", lambda: slater.C_to_MPS(C, tp, device="cuda"))
    if fw._CACHE[-1][1] is None:
        raise AssertionError(f"phase 4c: the FW sweep fell back at L={L}")
    cpu = with_fw_mode("1", lambda: slater.C_to_MPS(C, tp, device="cpu"))
    with patched(slater, det_fill=kernels.det_fill_plain,
                 site_overlap_schur=kernels.site_overlap_schur_plain):
        twins = with_fw_mode("1", lambda: slater.C_to_MPS(C, tp, device="cuda"))
    f_cpu, f_twin = fidelity(np, gpu, cpu), fidelity(np, twins, cpu)
    d_sv, d_w = spectra_diff(np, twins, cpu)
    sites = [0, L // 4, L // 2, 3 * L // 4, L - 1]
    cdc = [m.correlation_function("Cd", "C", sites1=sites) / m.norm_squared()
           for m in (twins, cpu)]
    d_cdc = float(np.abs(cdc[0] - cdc[1]).max())
    parts[f"parity at L={L}"] = time.perf_counter() - t0
    print(f"phase 4c: W=8 L={L} chi=48 (chi_max {gpu.chi_max}): card (twins) vs cpu 1 - fidelity "
          f"{1 - f_twin:.3e}, max squared-Schmidt diff {d_w:.3e} (values {d_sv:.3e}), charges "
          f"identical, normalised <c^dag c> rows {sites} diff {d_cdc:.3e}; card (kernels) vs "
          f"cpu 1 - fidelity {1 - f_cpu:.3e}", flush=True)
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
    print("phase 4c: seconds per part", {k: round(v, 2) for k, v in parts.items()}, flush=True)


def phase_pf_gmem_parity(torch, np, pfaffian, kernels, testing):
    """Phase 4d: BdG past nb = 64: p+ip W=4, Lx=40 (L=160, half blocks up
    to 80 sites, bucket 96) at chi=64, on the card and on the CPU, with
    phase 4b's bounds; bdg_overlap's launches are counted in the card run
    (the record ``bdg_overlap_wide``: its sites past nb = 64, clusters of
    two), which also keeps one group per shape for its record; then a
    device profile of one more card conversion.  Returns (launches,
    records)."""
    H = testing.pip_hamiltonian(4, 40)
    tp = {"chi_max": 64}
    overlaps, active, nbs = {}, {}, Counter()
    overlap_rec, group_rec = bdg_recorders(pfaffian, overlaps, active, nbs)
    overlap, group = pfaffian.bdg_overlap, pfaffian._overlap_group
    kernels.bdg_overlap.launches = 0
    pfaffian.bdg_overlap, pfaffian._overlap_group = overlap_rec, group_rec
    try:
        t0 = time.perf_counter()
        gpu = pfaffian.H_to_MPS(H, tp, basis="C", device="cuda")
        torch.cuda.synchronize()
        t_gpu = time.perf_counter() - t0
    finally:
        pfaffian.bdg_overlap, pfaffian._overlap_group = overlap, group
    launches = {"bdg_overlap_wide": kernels.bdg_overlap.launches}
    if launches["bdg_overlap_wide"] <= 0 or not any(k[0] > 64 for k in nbs):
        raise AssertionError(f"phase 4d: bdg_overlap launched {launches} times, on half "
                             f"sizes {sorted(nbs)}: none past 64")
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
    wide = {k: v for k, v in overlaps.items() if k[0] > 64}
    rec = pf_records(torch, np, kernels, "phase 4d", "bdg_overlap_wide", wide, active, failures)
    if failures:
        raise AssertionError("phase 4d: " + "; ".join(failures))
    device_profile(torch, lambda: pfaffian.H_to_MPS(H, tp, basis="C", device="cuda"), "phase 4d")
    return launches, {"bdg_overlap_wide": rec}


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
    forced on (TEMFPY_TORCH_FW=1; its "auto" is off on the card): one
    conversion with the launches counted and the stage profile, every
    kernel against its twin on the conversion's own inputs, the exact parts
    of the state and the chi truncation's effects (SLICE_BOUNDS), the
    canonical_form_finite round on a copy of the state, a device profile of
    one stream block (:func:`stream_block`); then one conversion with the
    default exact device frontend, timed for the frontend comparison and
    held against the FW state (:func:`frontend_checks`), and one more,
    untimed, with every K1/K2 launch metered (:class:`ConversionMeter`:
    device time, work and bound over the whole conversion).  Returns the
    launches, the records and the exact frontend's states (bench config 1
    and its disordered twin), warm time and eigh_batch stage, which phase 9
    compares with."""
    H = cylinder(8, 1024)
    res = with_fw_mode("1", lambda: slater_slice(
        torch, np, slater, fw, kernels, profiling, H, 512, "phase 7",
        ("det_fill", "site_overlap_schur", "site_overlap_schur_gmem", "fw_frame_slab"),
        bounds=SLICE_BOUNDS, profile=stream_block(slater, H, 512, fw_host=True), once=True))
    # timed as the FW warm run is (stages synchronised), for the comparison
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with profiling.collect() as prof:
        t0 = time.perf_counter()
        exact = slater.H_to_MPS(H, {"chi_max": 512}, device="cuda")
        torch.cuda.synchronize()
        t_ex = time.perf_counter() - t0
    print(f"phase 7: exact device frontend (the default): warm conversion {t_ex:.3f} s (stages "
          f"synchronised; no meter); max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, of it {resident / 2**20:.1f} "
          f"MiB resident before the run", flush=True)
    print(prof.report(), flush=True)
    # the meter's sleeps, events and cost sums run in a conversion of their
    # own, so that they touch neither the time above nor its stages
    meter = ConversionMeter(torch)
    with patched(slater, **fill_meter(torch, slater, kernels, meter)):
        slater.H_to_MPS(H, {"chi_max": 512}, device="cuda")
    meter.report("phase 7", "exact conversion")
    ex_d = frontend_checks(torch, np, slater, fw, H, 512, res["raw"], exact)
    return res["launches"], res["rec"], {"exact": exact, "exact_dis": ex_d, "t_exact": t_ex,
                                         "eigh_exact": prof.seconds.get("eigh_batch", 0.0)}


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
      the degeneracies: FW (forced on) against the default exact frontend,
      both at ``chi``, the same
      kept counts on every bond and 1 - fidelity within FW_EXACT_TOL.  A
      wrong frame column or Schur solve at this shape fails here.

    Returns the exact frontend's disordered state."""
    diag = slater.correlation_matrix(H, device="cuda")[0].diagonal().cpu().numpy()
    dev = {k: float(np.abs(m.expectation_value("N").real / m.norm_squared() - diag).max())
           for k, m in (("FW", fw_state), ("exact", exact))}
    clean = compare_frontends(np, fw_state, exact)
    Hd = H + np.diag(1e-3 * np.random.default_rng(3).normal(size=len(H)))
    tp = {"chi_max": chi}
    fw.fw_clear_cache()
    t0 = time.perf_counter()
    fw_d = with_fw_mode("1", lambda: slater.H_to_MPS(Hd, tp, device="cuda"))
    torch.cuda.synchronize()
    t_fw = time.perf_counter() - t0
    fell_back = fw._CACHE[-1][1] is None
    t0 = time.perf_counter()
    ex_d = slater.H_to_MPS(Hd, tp, device="cuda")
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
    return ex_d


# --------------------------------------------------------------------------
# The rank-update fill and the index-row entry points
# --------------------------------------------------------------------------

SWAP_DIRECT_TOL = 1e-10
"""Phases 4e and 8: the rank-update path's state against the direct path's,
1 - fidelity: the JAX package's own bound (tests/test_det_updates.py:90)."""
SWAP_TENSOR_TOL = 1e-9
"""Phase 4e: the two paths' site tensors on the card, entry by entry
(absolute), as tests/test_det_updates.py holds the JAX package's."""
SWAP_KERNELS = ("swap_tables", "swap_fill", "det_rows")


def piflux(W, Lx):
    """The pi-flux cylinder of tests/test_det_updates.py:131 (bench config
    4's ansatz): symmetry-degenerate Schmidt spectra whose rank-update
    classes fail the pre-screen or the probe."""
    import numpy as np

    L = W * Lx
    H = np.zeros((L, L))
    for x in range(Lx):
        for y in range(W):
            i = x * W + y
            if x + 1 < Lx:
                H[i, i + W] = H[i + W, i] = -1.0 if y % 2 == 0 else 1.0
            j = x * W + (y + 1) % W
            H[i, j] = H[j, i] = -1.0
    return H - 1e-4 * np.diag(np.arange(L))


def values_err(kernel, plain, args, kw):
    """(relative, absolute) kernel-twin difference of one output tensor."""
    return rel_err(kernel(*args, **kw), plain(*args, **kw))


def swap_tables_err(kernel, plain, args, kw):
    """Worst error over D0, G, P, T2, T3, max|G| and the tables' max, each
    relative to its own largest entry, given as both figures: the tables of
    the classes the pre-screen turns away reach ~1e29, so an absolute
    difference says nothing."""
    rel = max(rel_err(a, b)[0] for a, b in zip(kernel(*args, **kw), plain(*args, **kw)))
    return rel, rel


def _aug_ld(M, w):
    """diag(M, I_w) of a CUDA matrix, in extended precision."""
    import numpy as np

    Ml = _ld(M)
    Ma = np.eye(Ml.shape[0] + w, dtype=Ml.dtype)
    Ma[: Ml.shape[0], : Ml.shape[0]] = Ml
    return Ma


def det_rows_ext(torch, kernels, args, kw, n_mats=4, n_dets=4096):
    """Kernel and twin of det_rows against an extended-precision evaluation
    on the group's worst matrices and their n_dets most discrepant
    determinants.  Returns (kernel error, twin error, largest |det|, min
    |scale| there)."""
    import numpy as np

    M, ib, ik, scale = args
    K, T = kernels.det_rows(*args, **kw), kernels.det_rows_plain(*args, **kw)
    diff = (K - T).abs().flatten(1)
    e_k = e_t = big = 0.0
    mats = torch.argsort(diff.amax(1), descending=True)[:n_mats].tolist()
    for g in mats:
        q = torch.argsort(diff[g], descending=True)[:n_dets]
        i, j = (q // ik.shape[1], q % ik.shape[1]) if kw.get("cross") else (q, q)
        Ma = _aug_ld(M[g], ib.shape[-1])
        rows, cols = ib[g][i].cpu().numpy(), ik[g][j].cpu().numpy()
        ref = _lu_det_ld(Ma[rows[:, :, None], cols[:, None, :]]) * _ld(scale[g])
        e_k = max(e_k, float(np.abs(_ld(K[g].flatten()[q]) - ref).max()))
        e_t = max(e_t, float(np.abs(_ld(T[g].flatten()[q]) - ref).max()))
        big = max(big, float(T[g].abs().max()))
    return e_k, e_t, big, float(scale[mats].abs().min())


def _gauss_jordan_ld(A):
    """(det, inverse) of an (n, w, w) batch by Gauss-Jordan with partial
    pivoting, in the batch's (extended) precision."""
    import numpy as np

    n, w, _ = A.shape
    AB = np.concatenate([A, np.broadcast_to(np.eye(w, dtype=A.dtype), A.shape)], axis=2).copy()
    ar = np.arange(n)
    det = np.ones(n, A.dtype)
    for j in range(w):
        p = j + np.argmax(np.abs(AB[:, j:, j]), axis=1)
        row_j = AB[ar, j].copy()
        AB[ar, j] = AB[ar, p]
        AB[ar, p] = row_j
        det = np.where(p != j, -det, det)
        piv = AB[:, j, j]
        det = det * piv
        row = AB[:, j] / np.where(piv == 0, 1, piv)[:, None]
        f = AB[:, :, j].copy()
        f[:, j] = 0
        AB -= f[:, :, None] * row[:, None, :]
        AB[:, j] = row
    return det, AB[:, :, w:]


def swap_tables_ext(torch, kernels, args, kw, n_entries=8):
    """Kernel and twin of swap_tables against an extended-precision
    evaluation (Gauss-Jordan and the three products) on the group's worst
    entries.  Errors are relative to each output's largest entry there, so
    the scale returned is 1.  Returns (kernel error, twin error, 1, min
    |D0| there)."""
    import numpy as np

    M, r0, c0 = args
    K, T = kernels.swap_tables(M, r0, c0), kernels.swap_tables_plain(M, r0, c0)
    per = torch.stack([(a - b).abs().flatten(1).amax(1) / b.abs().flatten(1).amax(1).clamp(
        min=1e-300) if b.dim() > 1 else (a - b).abs() / b.abs().clamp(min=1e-300)
        for a, b in zip(K[:5], T[:5])]).amax(0)
    sel = torch.argsort(per, descending=True)[:n_entries]
    w = r0.shape[-1]
    e_k = e_t = 0.0
    for e in sel.tolist():
        Ma = _aug_ld(M[e], w)
        r, c = r0[e].cpu().numpy(), c0[e].cpu().numpy()
        D0, G = _gauss_jordan_ld(Ma[np.ix_(r, c)][None])
        P = np.einsum("ij,jk->ik", Ma[:, c], G[0])
        T2 = np.einsum("ij,jk->ik", G[0], Ma[r, :])
        T3 = np.einsum("ij,jk->ik", P, Ma[r, :])
        for ref, kk, tt in zip((D0[0], G[0], P, T2, T3), K[:5], T[:5]):
            s = max(float(np.abs(ref).max()), 1e-300)
            e_k = max(e_k, float(np.abs(_ld(kk[e]) - ref).max()) / s)
            e_t = max(e_t, float(np.abs(_ld(tt[e]) - ref).max()) / s)
    return e_k, e_t, 1.0, float(K[0][sel].abs().min())


def swap_fill_ext(torch, kernels, args, kw, n_units=4, n_pairs=2048):
    """Kernel and twin of swap_fill (its values, which the scatter mode only
    places) against an extended-precision evaluation of the same bordered
    determinants from the same tables, on the group's worst units and their
    n_pairs most discrepant pairs.  Returns (kernel error, twin error,
    largest |value|, min |D0 det_always| there)."""
    import numpy as np

    base, s_b = args[:17], kw["s_b"]
    K = kernels.swap_fill(*base, s_b=s_b)
    T = kernels.swap_fill_plain(*base, s_b=s_b)
    M, det, D0, G, P, T2, T3, Rin, Rout, Rpos, sgr, Cin, Cout, Cpos, sgc, pr, pc = base
    diff = (K - T).abs()
    units = torch.argsort(diff.amax(1), descending=True)[:n_units].tolist()
    e_k = e_t = big = 0.0
    for u in units:
        q = torch.argsort(diff[u], descending=True)[:n_pairs]
        r, c = pr[u][q].long(), pc[u][q].long()
        ix = {k: t[u][idx][:, :s_b].cpu().numpy() for k, t, idx in (
            ("rin", Rin, r), ("rout", Rout, r), ("rpos", Rpos, r), ("cin", Cin, c),
            ("cout", Cout, c), ("cpos", Cpos, c))}
        Ma = _aug_ld(M[u], G.shape[-1])
        Gl, Pl, T2l, T3l = (_ld(t[u]) for t in (G, P, T2, T3))

        def gs(X, i, j):
            return X[i[:, :, None], j[:, None, :]]

        eye = np.eye(s_b, dtype=Ma.dtype)[None]
        Kb = eye + gs(Pl, ix["rin"], ix["rpos"]) - gs(Pl, ix["rout"], ix["rpos"])
        Gcr = gs(Gl, ix["cpos"], ix["rpos"])
        D12 = (gs(Ma, ix["rin"], ix["cin"]) - gs(Ma, ix["rout"], ix["cin"])
               - gs(Ma, ix["rin"], ix["cout"]) + gs(Ma, ix["rout"], ix["cout"]))
        X = (gs(T2l, ix["cpos"], ix["cin"]) - gs(T2l, ix["cpos"], ix["cout"])
             + np.einsum("pij,pjk->pik", Gcr, D12))
        Z = (gs(T3l, ix["rin"], ix["cin"]) - gs(T3l, ix["rout"], ix["cin"])
             - gs(T3l, ix["rin"], ix["cout"]) + gs(T3l, ix["rout"], ix["cout"])
             + np.einsum("pij,pjk->pik", Kb - eye, D12))
        S = np.concatenate([np.concatenate([Kb, Z], 2), np.concatenate([Gcr, eye + X], 2)], 1)
        sign = (sgr[u][r] * sgc[u][c]).cpu().numpy()
        ref = _lu_det_ld(S) * _ld(D0[u]) * sign * _ld(det[u])
        e_k = max(e_k, float(np.abs(_ld(K[u][q]) - ref).max()))
        e_t = max(e_t, float(np.abs(_ld(T[u][q]) - ref).max()))
        big = max(big, float(T[u].abs().max()))
    return e_k, e_t, big, float((D0[units] * det[units]).abs().min())


def det_rows_cost(torch, args, kw, out):
    """(operations, bytes) of one det_rows group: an LU of the c x c block
    each determinant needs (c = the real rows of its bra index row), 2c^3/3
    real operations (x4 complex); every input and the output once."""
    M, ib, ik, _scale = args
    c3 = ((ib < M.shape[-1]).sum(-1).double() ** 3).sum() * (ik.shape[1] if kw.get("cross")
                                                              else 1)
    mult = 4 if M.is_complex() else 1
    return float(c3) * 2.0 / 3.0 * mult, nbytes(*(a for a in args if a is not None), out)


def swap_tables_cost(torch, args, kw, out):
    """(operations, bytes) of one swap_tables group: per entry the inverse of
    the w x w base (2 w^3) and the products P, T2, T3 (2 m_aug w^2 + 2 w^2
    m_aug + 2 m_aug^2 w) real operations (x4 complex); inputs and outputs
    once."""
    M, r0, _c0 = args
    E, m, _ = M.shape
    w = r0.shape[-1]
    ma = m + w
    mult = 4 if M.is_complex() else 1
    return E * (2.0 * w**3 + 4.0 * ma * w * w + 2.0 * ma * ma * w) * mult, nbytes(*args, *out)


def swap_fill_cost(torch, args, kw, out):
    """(operations, bytes) of one swap_fill group: per real pair (pad pairs
    point at the self-swap pad row) an LU of its (2 s_b) x (2 s_b) bordered
    matrix, 2 (2 s_b)^3 / 3 real operations (x4 complex), the assembly left
    out.  Bytes: the sites' matrices, the class tables, the swap and pair
    index tables and the scatter tables once, and the values written: one
    per real pair in scatter mode, the (U, P_b) values in values mode."""
    pr, Rin = args[15], args[7]
    scatter = len(args) > 17
    real = float((pr != Rin.shape[1] - 1).sum()) if scatter else pr.numel()
    mult = 4 if args[0].is_complex() else 1
    n = 2 * kw["s_b"]
    wrote = written_bytes(pr, Rin.shape[1] - 1, args[0]) if scatter else nbytes(out)
    return real * 2.0 * n**3 / 3.0 * mult, nbytes(*args) + wrote


def pf_gather_cost(torch, args, out):
    """(operations, bytes) of one pf_gather call: per pair of width k the
    Parlett-Reid updates of :func:`skew_update_entries` (k / 2), two
    multiply-adds each (8 real operations per complex one, 2 per real one);
    inputs and output once."""
    N, bra, ket = args
    entries = skew_update_entries((bra.shape[1] + ket.shape[1]) / 2)
    per = 2 * (CMA_FLOP if N.is_complex() else 2)
    return bra.shape[0] * ket.shape[0] * entries * per, nbytes(*args, out)


def det_rows_library_ms(torch, args, kw):
    """Milliseconds of one torch.linalg.det over every matrix's pre-gathered
    determinant batch (:func:`batched_library_ms`); the gathers are left
    out."""
    from temfpy_torch.ops.linalg import block_diag_identity_pad, gather_submatrices

    M, ib, ik, _scale = args
    return batched_library_ms(
        torch, range(M.shape[0]),
        lambda g: gather_submatrices(block_diag_identity_pad(M[g], ib.shape[-1]), ib[g], ik[g],
                                     cross=kw.get("cross", False)).flatten(0, -3),
        torch.linalg.det)


def swap_fill_library_ms(torch, args, kw):
    """Milliseconds of one torch.linalg.det over every unit's pre-assembled
    bordered matrices S (all P_b pairs; :func:`batched_library_ms`); the
    assembly and the scatter are left out."""
    from temfpy_torch.ops.linalg import block_diag_identity_pad, swap_bordered

    M, _det, _D0, G, P, T2, T3, Rin, Rout, Rpos, _sgr, Cin, Cout, Cpos, _sgc, pr, pc = args[:17]
    s_b = kw["s_b"]

    def bordered(u):
        r, c = pr[u].long(), pc[u].long()
        return swap_bordered(block_diag_identity_pad(M[u], G.shape[-1]), G[u], P[u], T2[u],
                             T3[u], *(t[u][i][:, :s_b] for t, i in ((Rin, r), (Rout, r),
                                                                    (Rpos, r), (Cin, c),
                                                                    (Cout, c), (Cpos, c))))
    return batched_library_ms(torch, range(M.shape[0]), bordered, torch.linalg.det)


def swap_tables_library_ms(torch, args, kw):
    """Milliseconds of the library composition that computes swap_tables'
    function on the same inputs, each step timed by :func:`cuda_ms`
    (TIMING_REPS) and summed: torch.linalg.lu_factor_ex (no check: the main
    path's groups hold singular bases) and lu_solve of the pre-gathered
    bases against the identity (G; the determinant's diagonal product left
    out), then torch.bmm for P = M_aug[:, c0] G, T2 = G
    M_aug[r0, :] and T3 = P M_aug[r0, :] (the gathers made before).  No
    single call computes K6a, so this is a composition, for reference."""
    from temfpy_torch.ops.linalg import block_diag_identity_pad

    M, r0, c0 = args
    E, m, _ = M.shape
    w = r0.shape[-1]
    Ma = block_diag_identity_pad(M, w)
    r, c = r0.long(), c0.long()
    Mc = torch.gather(Ma, 2, c[:, None, :].expand(E, m + w, w)).contiguous()
    Mr = torch.gather(Ma, 1, r[:, :, None].expand(E, w, m + w)).contiguous()
    A = torch.gather(Mr, 2, c[:, None, :].expand(E, w, w)).contiguous()
    eye = torch.eye(w, dtype=M.dtype, device=M.device).expand(E, w, w).contiguous()
    ms = cuda_ms(lambda: torch.linalg.lu_solve(*torch.linalg.lu_factor_ex(A)[:2], eye),
                 TIMING_REPS)
    G = torch.linalg.lu_solve(*torch.linalg.lu_factor_ex(A)[:2], eye)
    P = torch.bmm(Mc, G)
    return ms + sum(cuda_ms(lambda x=x, y=y: torch.bmm(x, y), TIMING_REPS)
                    for x, y in ((Mc, G), (G, Mr), (P, Mr)))


CAPTURED.update({
    "det_rows": ("det_rows", "det_rows_plain", values_err, det_rows_ext, det_rows_cost,
                 det_rows_library_ms),
    "swap_tables": ("swap_tables", "swap_tables_plain", swap_tables_err, swap_tables_ext,
                    swap_tables_cost, swap_tables_library_ms),
    "swap_fill": ("swap_fill", "swap_fill_plain", values_err, swap_fill_ext, swap_fill_cost,
                  swap_fill_library_ms),
})


def phase_swap_kernels(torch, kernels, testing):
    """Phase 3d: the rank-update and index-row kernels against their twins
    on seeded inputs (KERNEL_RTOL each).

    - det_rows at w in {4, 8, 16, 24, 64}, paired and all pairs, with
      sentinel tails and all-sentinel rows, float64 and complex128;
    - swap_tables at w_b in {8, 16, 24} with m_aug = m + w_b from bench
      config 1's sometimes widths (m = 16, 24, 32);
    - swap_fill at s_b in {1, 2, 4, 8} in both modes, with self-swap pads,
      pad pairs and the three scatter layouts; and a class built to pass
      the pre-screen and fail the probe (testing.random_swap_case's
      ``fail_probe``): the kernels and the twins must both read the probe
      as failed, with det_rows' direct values held at KERNEL_RTOL (the swap
      values of such a class are rounding noise in both, and the class goes
      direct);
    - pf_gather at widths 4-32, float64 and complex128.
    Returns the worst absolute error per kernel."""
    import numpy as np

    from temfpy_torch import slater

    dev = torch.device("cuda")
    up = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    worst = {k: 0.0 for k in ("det_rows", "swap_tables", "swap_fill", "pf_gather")}

    def check(name, label, got, ref, t_k, t_p):
        rel, ab = rel_err(got, ref)
        if not rel <= KERNEL_RTOL:
            raise AssertionError(f"phase 3d: {name} {label}: rel err {rel:.3e} > {KERNEL_RTOL}")
        worst[name] = max(worst[name], ab)
        print(f"phase 3d: {name} {label}: rel err {rel:.3e}; kernel {t_k:.3f} ms, plain "
              f"{t_p:.3f} ms", flush=True)

    for dt in ("float64", "complex128"):
        for w in (4, 8, 16, 24, 64):
            for cross in (False, True):
                n, nk = (256, 64) if cross else (16384, None)
                (M, ib, ik, sc), kw = testing.random_det_rows_case(w, G=4, w=w, m=max(w, 32),
                                                                   n=n, nk=nk, cross=cross,
                                                                   dtype=dt)
                a = [up(x) for x in (M, ib, ik, sc)]
                got = kernels.det_rows(*a, **kw)
                check_repeatable(torch, f"phase 3d: det_rows w={w} cross={cross} {dt}",
                                 lambda: kernels.det_rows(*a, **kw), got)
                t_k = cuda_ms(lambda: kernels.det_rows(*a, **kw), 5)
                t_p = cuda_ms(lambda: kernels.det_rows_plain(*a, **kw), 1)
                check("det_rows", f"w={w} {'cross 256x64' if cross else 'paired 16384'} {dt} "
                      f"G=4", got, kernels.det_rows_plain(*a, **kw), t_k, t_p)
    for c, m in ((6, 16), (12, 24), (20, 32)):
        for dt in ("float64", "complex128"):
            M, r0, c0, _args, _kw, _rows = testing.random_swap_case(c, U=64, m=m, c=c, s_b=1,
                                                                    n_rows=8, P=10, dtype=dt)
            a = [up(x) for x in (M, r0, c0)]
            rel, _ = swap_tables_err(kernels.swap_tables, kernels.swap_tables_plain, a, {})
            if not rel <= KERNEL_RTOL:
                raise AssertionError(f"phase 3d: swap_tables w_b={r0.shape[1]} m={m} {dt}: rel "
                                     f"err {rel:.3e}")
            worst["swap_tables"] = max(worst["swap_tables"], rel)
            t_k = cuda_ms(lambda: kernels.swap_tables(*a), 5)
            t_p = cuda_ms(lambda: kernels.swap_tables_plain(*a), 1)
            print(f"phase 3d: swap_tables w_b={r0.shape[1]} m_aug={m + r0.shape[1]} {dt} E=64: "
                  f"rel err {rel:.3e}; kernel {t_k:.3f} ms, plain {t_p:.3f} ms", flush=True)
    cases = [(1, 6, 16, "rc"), (2, 6, 16, "rrc"), (4, 12, 24, "crr"), (8, 20, 32, "rrc")]
    for (s_b, c, m, spec), dt in [(x, "float64") for x in cases] + [(cases[2], "complex128")]:
        M, r0, c0, args, kw, _rows = testing.random_swap_case(
            s_b, U=8, m=m, c=c, s_b=s_b, n_rows=256, P=60000, spec=spec, dtype=dt)
        tab = kernels.swap_tables(up(M), up(r0), up(c0))
        (Mm, det, Rin, Rout, Rpos, sgr, Cin, Cout, Cpos, sgc, pr, pc, tabs, _chk) = args
        fa = [up(Mm), up(det), *tab[:5], *(up(x) for x in (Rin, Rout, Rpos, sgr, Cin, Cout, Cpos,
                                                            sgc, pr, pc))]
        ta = tuple(up(t) for t in tabs)
        shape = kw["shape"]
        # in place, the units in reverse order into slots of one buffer
        U = len(M)
        buf = torch.zeros((U, shape[0] + 1) + tuple(shape[1:]), dtype=tab[0].dtype, device=dev)
        kw_in = {**kw, "out": buf, "slot": list(range(U - 1, -1, -1))}
        T = kernels.swap_fill(*fa, ta, **kw_in).flip(0)
        T0 = kernels.swap_fill_plain(*fa, ta, **kw)
        t_k = cuda_ms(lambda: kernels.swap_fill(*fa, ta, **kw_in), 5)
        t_p = cuda_ms(lambda: kernels.swap_fill_plain(*fa, ta, **kw), 1)
        label = f"s_b={s_b} w_b={r0.shape[1]} m={m} {spec} {dt} U=8 P=60000"
        check("swap_fill", label + " scatter", T, T0, t_k, t_p)
        check_repeatable(torch, f"phase 3d: swap_fill {label} scatter",
                         lambda: kernels.swap_fill(*fa, ta, **{**kw_in, "out": torch.zeros_like(
                             buf)}).flip(0), T.clone())
        v = kernels.swap_fill(*fa, s_b=s_b)
        check_repeatable(torch, f"phase 3d: swap_fill {label} values",
                         lambda: kernels.swap_fill(*fa, s_b=s_b), v)
        check("swap_fill", label + " values", v, kernels.swap_fill_plain(*fa, s_b=s_b),
              cuda_ms(lambda: kernels.swap_fill(*fa, s_b=s_b), 5),
              cuda_ms(lambda: kernels.swap_fill_plain(*fa, s_b=s_b), 1))
    # a class that passes the pre-screen and fails the probe
    for fail in (False, True):
        M, r0, c0, args, kw, (ib, ik) = testing.random_swap_case(
            8, U=4, m=26, c=12, s_b=4, n_rows=64, P=3000, spec="rrc", fail_probe=fail)
        (Mm, det, Rin, Rout, Rpos, sgr, Cin, Cout, Cpos, sgc, pr, pc, _tabs, chk) = args
        verdicts = []
        for tables, fill, rows in ((kernels.swap_tables, kernels.swap_fill, kernels.det_rows),
                                   (kernels.swap_tables_plain, kernels.swap_fill_plain,
                                    kernels.det_rows_plain)):
            tab = tables(up(Mm), up(r0), up(c0))
            screen = float(tab[0].abs().min()) >= 1e-12 and float(
                torch.maximum(tab[5], tab[6]).max()) <= slater._SWAP_GMAX
            sw = fill(up(Mm), up(det), *tab[:5], *(up(x) for x in (
                Rin, Rout, Rpos, sgr, Cin, Cout, Cpos, sgc)),
                up(np.take_along_axis(pr, chk, 1)), up(np.take_along_axis(pc, chk, 1)),
                s_b=kw["s_b"])
            dr = rows(up(Mm), up(ib), up(ik), up(det))
            verdicts.append((screen, [slater._probe_ok([(sw[u].cpu().numpy(),
                                                         dr[u].cpu().numpy())])
                                      for u in range(4)], dr))
        (s1, v1, dr1), (s0, v0, dr0) = verdicts
        check("det_rows", f"probe rows of the {'failing' if fail else 'passing'} class", dr1,
              dr0, 0.0, 0.0)
        print(f"phase 3d: {'probe-failing' if fail else 'plain'} seeded class: pre-screen passed "
              f"{s1} (twins {s0}); probe verdicts {v1} (twins {v0})", flush=True)
        if not (s1 and s0 and v1 == v0 == [not fail] * 4):
            raise AssertionError(f"phase 3d: the {'failing' if fail else 'plain'} class: "
                                 f"screen {s1}/{s0}, probe {v1}/{v0}")
    for dt in ("float64", "complex128"):
        for kb, kk in ((2, 2), (4, 4), (8, 8), (12, 4), (16, 16)):
            N, bra, ket, pad = testing.random_pf_gather_case(kb, m=64, nb=256, nk=128, kb=kb,
                                                             kk=kk, dtype=dt)
            a = [up(x) for x in (N, bra, ket)]
            got = kernels.pf_gather(*a, pad)
            check("pf_gather", f"k={kb + kk} (kb={kb}, kk={kk}) {dt} 256x128 pairs", got,
                  kernels.pf_gather_plain(*a, pad), cuda_ms(lambda: kernels.pf_gather(*a, pad), 5),
                  cuda_ms(lambda: kernels.pf_gather_plain(*a, pad), 1))
    return worst


def phase_index_row_ops(torch, np, kernels, testing):
    """Phase 3e: the public index-row entry points on the card against the
    CPU on seeded inputs: ``ops.linalg.batched_det_pairs`` /
    ``batched_det_gather`` (det_rows) and ``ops.pfaffian.
    batched_pfaffian_gather`` (pf_gather), KERNEL_RTOL.  pf_gather has no
    other caller, so this phase is its main path: its launch count is set
    to 0 just before and read just after, and its record is taken from
    these calls.  Returns (launches, pf_gather record)."""
    from temfpy_torch.ops import linalg, pfaffian as opf

    dev = torch.device("cuda")
    (M, ib, ik, _sc), _kw = testing.random_det_rows_case(31, G=1, w=12, m=40, n=600, nk=300,
                                                         cross=True)
    Mc, Mg = torch.as_tensor(M[0]), torch.as_tensor(M[0], device=dev)
    for name, fn, a in (("batched_det_gather", linalg.batched_det_gather, (ib[0], ik[0])),
                        ("batched_det_pairs", linalg.batched_det_pairs, (ib[0][:300], ik[0]))):
        n0 = kernels.det_rows.launches
        got = fn(Mg, *a, chunk=256)
        rel = rel_err(got.cpu(), fn(Mc, *a))[0]
        n = kernels.det_rows.launches - n0
        print(f"phase 3e: ops.linalg.{name} {tuple(got.shape)} on the card: {n} det_rows "
              f"launches, rel err against the CPU {rel:.3e}", flush=True)
        if not (rel <= KERNEL_RTOL and n > 0):
            raise AssertionError(f"phase 3e: {name}")
    cases = [testing.random_pf_gather_case(kb * 7 + kk, m=96, nb=512, nk=256, kb=kb, kk=kk,
                                           dtype=dt)
             for kb, kk, dt in ((8, 8, "complex128"), (16, 16, "complex128"),
                                (12, 4, "float64"))]
    # the main path: the public entry point on the card, counted alone
    kernels.pf_gather.launches = 0
    gots = [opf.batched_pfaffian_gather(torch.as_tensor(N, device=dev), bra, ket, pad)
            for N, bra, ket, pad in cases]
    launches = {"pf_gather": kernels.pf_gather.launches}
    if launches["pf_gather"] <= 0:
        raise AssertionError("phase 3e: pf_gather was not launched")
    rec = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": None,
           "per_k": {}}
    flops = nbyte = 0.0
    for (N, bra, ket, pad), got in zip(cases, gots):
        ref = opf.batched_pfaffian_gather(torch.as_tensor(N), bra, ket, pad)
        rel, ab = rel_err(got.cpu(), ref)
        # timed on inputs already on the card (no index upload)
        a = [torch.as_tensor(x, device=dev) for x in (N, bra, ket)]
        _, t_k = timed(torch, lambda: kernels.pf_gather(*a, pad))
        _, t_p = timed(torch, lambda: kernels.pf_gather_plain(*a, pad))
        f, b = pf_gather_cost(torch, a, got)
        t_b, _ = bound_ms(f, b)
        k = bra.shape[1] + ket.shape[1]
        print(f"phase 3e: ops.pfaffian.batched_pfaffian_gather k={k} {N.dtype} 512x256: rel err "
              f"against the CPU {rel:.3e}; kernel {t_k:.3f} ms, plain {t_p:.3f} ms, bound "
              f"{t_b:.4f} ms", flush=True)
        if not rel <= KERNEL_RTOL:
            raise AssertionError(f"phase 3e: batched_pfaffian_gather k={k}: {rel:.3e}")
        rec["max_abs_err"] = max(rec["max_abs_err"], ab)
        rec["ms"] += t_k
        rec["plain_ms"] += t_p
        rec["bound_ms"] += t_b
        rec["per_k"][f"k={k} {N.dtype}"] = {"ms": t_k, "cuda_ms": cuda_ms(
            lambda: kernels.pf_gather(*a, pad), TIMING_REPS), "bound_ms": t_b}
        flops, nbyte = flops + f, nbyte + b
    rec["bound_by"] = bound_ms(flops, nbyte)[1]
    print(f"phase 3e: pf_gather per k (one call, cuda_ms over {TIMING_REPS}, bound): "
          f"{json.dumps(rec['per_k'])}", flush=True)
    return launches, {"pf_gather": rec}


def phase_swap_parity(torch, np, slater, kernels):
    """Phase 4e: ``slater.C_to_MPS`` with the rank-update path forced on
    (TEMFPY_TORCH_DET_UPDATES=1) on the card against the CPU (twins), on
    the W=8, L=32 cylinder at chi=96 (tests/test_det_updates.py:73) and on
    the pi-flux W=4, Lx=8 cylinder, spinful "PH", chi=128
    (tests/test_det_updates.py:131), where classes fail the pre-screen or
    the probe: PARITY_TOL on fidelity and squared Schmidt values, equal
    charges; the card's swap state against its direct state
    (SWAP_DIRECT_TOL, tensors to SWAP_TENSOR_TOL); swap_tables, swap_fill
    and det_rows launched; no wasted swap fill.  Returns det_rows' launches
    in the cylinder's card run."""
    out = {}
    for name, H, tp, spinful in (("W=8 L=32 chi=96", cylinder(8, 32), {"chi_max": 96}, None),
                                 ("pi-flux W=4 Lx=8 PH chi=128", piflux(4, 8),
                                  {"chi_max": 128}, "PH")):
        C = slater.correlation_matrix(H, device="cpu")[0].numpy()
        for k in SWAP_KERNELS:
            getattr(kernels, k).launches = 0
        t0 = time.perf_counter()
        gpu = with_det_updates("1", lambda: slater.C_to_MPS(C, tp, spinful=spinful,
                                                            device="cuda"))
        torch.cuda.synchronize()
        t_gpu = time.perf_counter() - t0
        stats = dict(slater._swap_stats())
        launches = {k: getattr(kernels, k).launches for k in SWAP_KERNELS}
        out.setdefault("det_rows", launches["det_rows"])
        cpu = with_det_updates("1", lambda: slater.C_to_MPS(C, tp, spinful=spinful,
                                                            device="cpu"))
        stats_cpu = dict(slater._swap_stats())
        direct = with_det_updates("0", lambda: slater.C_to_MPS(C, tp, spinful=spinful,
                                                               device="cuda"))
        fid = abs(gpu.overlap(cpu)) / np.sqrt(gpu.norm_squared() * cpu.norm_squared())
        d_sv, d_w = spectra_diff(np, gpu, cpu)
        f_dir = abs(gpu.overlap(direct)) / np.sqrt(gpu.norm_squared() * direct.norm_squared())
        d_t = max(float((a - b).abs().max()) for a, b in zip(gpu._B, direct._B))
        print(f"phase 4e: {name}: launches {launches}; classes on the card {stats}, on the CPU "
              f"{stats_cpu}; card vs CPU 1 - fidelity {1 - fid:.3e}, squared-Schmidt diff "
              f"{d_w:.3e}, charges identical; card swap vs card direct 1 - fidelity "
              f"{1 - f_dir:.3e}, max tensor diff {d_t:.3e}; card {t_gpu:.2f} s", flush=True)
        if not (fid >= 1 - PARITY_TOL and d_w <= PARITY_TOL):
            raise AssertionError(f"phase 4e: {name}: card and CPU differ beyond {PARITY_TOL}")
        if not (1 - f_dir <= SWAP_DIRECT_TOL and d_t <= SWAP_TENSOR_TOL):
            raise AssertionError(f"phase 4e: {name}: swap and direct paths differ")
        if not (all(n > 0 for n in launches.values()) and stats["classes"] > 0
                and stats["wasted"] == 0):
            raise AssertionError(f"phase 4e: {name}: launches {launches}, classes {stats}")
    return out


def phase_swap_slice(torch, np, slater, fw, kernels, profiling, direct):
    """Phase 8: the slice at full size with the rank-update path on,
    ``slater.H_to_MPS`` on bench config 1's cylinder (W=8, L=256, chi=512,
    float64) under TEMFPY_TORCH_DET_UPDATES=1, with phase 5's records and
    bounds (:func:`slater_slice`: cold with the launches of K1, K2, K5,
    K6a and K6b, warm with the stage profile, a device profile); every
    swap_tables, swap_fill and det_rows group of the warm run held against
    its twin (extended precision for ill-conditioned groups); the classes,
    fallbacks and pairs routed swap and direct; the state against phase
    5's direct state ``direct`` (its dict): 1 - fidelity within
    SWAP_DIRECT_TOL, squared Schmidt values and charges equal, the sites
    whose tensors part most; then both paths' warm conversions in turns
    (direct, swap, swap, direct), for the wall time both ways.  Returns
    (launches, records)."""
    H = cylinder(8, 256)
    counted = ("det_fill", "site_overlap_schur") + SWAP_KERNELS
    res = with_det_updates("1", lambda: slater_slice(
        torch, np, slater, fw, kernels, profiling, H, 512, "phase 8", counted,
        bounds=PHASE5_BOUNDS, every=SWAP_KERNELS))
    cap, stats = res["cap"], res["stats"]
    pairs = {k: int(v) for k, v in cap["pairs"].items()}
    print(f"phase 8: rank-update classes {stats}; real pairs routed swap {pairs['swap']}, "
          f"direct {pairs['direct']}", flush=True)
    if stats["classes"] <= 0 or stats["wasted"] != 0 or pairs["swap"] <= 0:
        raise AssertionError(f"phase 8: classes {stats}, pairs {pairs}")
    held, ext = Counter(), {}
    for name, key, (args, kw) in cap["every"]:
        if name == "det_rows":  # held below, where its record is timed
            continue
        _rel, _ab, e = hold(torch, kernels, "phase 8", name, key, args, kw)
        held[name] += 1
        if e is not None:
            ext.setdefault(name, []).append(e[0] / max(e[1], 1e-300))
    # K5's record: every det_rows group of the warm run (the probe launches
    # one a bucket), each held and timed as phase_captured does
    rows = {i: g for i, (name, _key, g) in enumerate(cap["every"]) if name == "det_rows"}
    res["rec"]["det_rows"] = phase_captured(torch, kernels, "phase 8 (every group)",
                                            {"det_rows": rows}, quiet=True)["det_rows"]
    held["det_rows"] = len(rows)
    if res["rec"]["det_rows"]["ext_ratios"]:
        ext["det_rows"] = res["rec"]["det_rows"]["ext_ratios"]
    print(f"phase 8: every rank-update group of the warm run held against its twin: "
          f"{dict(held)}; beyond {KERNEL_RTOL} relative (to the group's largest entry) and "
          f"held against extended precision: "
          f"{ {k: len(ext.get(k, [])) for k in held} }; their kernel/twin error ratios "
          f"there: { {k: [f'{r:.3g}' for r in sorted(v)] for k, v in ext.items()} }",
          flush=True)
    raw, ref = res["raw"], direct["raw"]
    fid = abs(raw.overlap(ref)) / np.sqrt(raw.norm_squared() * ref.norm_squared())
    d_sv, d_w = spectra_diff(np, raw, ref)
    part = {i: rel_err(a, b)[0] for i, (a, b) in enumerate(zip(raw._B, ref._B))}
    worst_sites = sorted(part, key=part.get, reverse=True)[:4]
    print(f"phase 8: swap path vs phase 5's direct path: 1 - fidelity {1 - fid:.3e}, max "
          f"squared-Schmidt diff {d_w:.3e}, charges identical; sites whose tensors part most "
          f"(rel): {({i: f'{part[i]:.3e}' for i in worst_sites})}", flush=True)
    if not (1 - fid <= SWAP_DIRECT_TOL and d_w <= PARITY_TOL):
        raise AssertionError(f"phase 8: swap vs direct 1 - fidelity {1 - fid:.3e} > "
                             f"{SWAP_DIRECT_TOL} or squared Schmidt values {d_w:.3e} apart")
    # the two paths' warm wall times, in turns (direct, swap, swap, direct),
    # stages synchronised as in the warm runs above
    times, reports = {"0": [], "1": []}, {}
    for mode in ("0", "1", "1", "0"):
        with profiling.collect() as prof:
            t0 = time.perf_counter()
            with_det_updates(mode, lambda: slater.H_to_MPS(H, {"chi_max": 512}, device="cuda"))
            torch.cuda.synchronize()
            times[mode].append(time.perf_counter() - t0)
        reports[mode] = prof.report()
    print(f"phase 8: warm conversions in turns (stages synchronised): swap path "
          f"{times['1']} s, direct path {times['0']} s", flush=True)
    for mode, name in (("1", "swap path"), ("0", "direct path")):
        print(f"phase 8: stage profile, {name}:\n{reports[mode]}", flush=True)
    # every K6b launch, and K5's and K6a's beside it, of one more rank-update
    # conversion, untimed
    meter = ConversionMeter(torch)
    with patched(slater, **swap_meter(torch, slater, meter)):
        with_det_updates("1", lambda: slater.H_to_MPS(H, {"chi_max": 512}, device="cuda"))
    meter.report("phase 8", "rank-update conversion")
    return res["launches"], res["rec"]


def swap_meter(torch, slater, meter):
    """The patches that meter every swap_tables, swap_fill and det_rows
    launch of a rank-update conversion, for :func:`patched` on ``slater``."""
    return {name: meter.wrap(getattr(slater, name), lambda a, k, n=name: n,
                             lambda a, k, o, c=cost: c(torch, a, k, o))
            for name, cost in (("swap_tables", swap_tables_cost), ("swap_fill", swap_fill_cost),
                               ("det_rows", det_rows_cost))}


# --------------------------------------------------------------------------
# The randomized spectral frontend (K11a-d)
# --------------------------------------------------------------------------

RSF_KERNELS = ("rsf_apply", "rsf_tsprod", "rsf_ritz_select", "rsf_frames")
RSF_TRACE_ATOL = 1e-12
"""K11d's trace residuals |tr - sum lambda - n_f| (about 1e-13 on the main
path) against the twin's: both add the same float64 eigenvalues in another
order, so absolute 1e-12."""


def rsf_outputs(out):
    return out if isinstance(out, tuple) else (out,)


def rsf_magnitude(kernels, name, mode, args, kw):
    """The scale a K11 product's rounding is measured against: the largest
    entry of |A| |B| (the twin on the operands' absolute values), and of
    |Z| for "sub".  The sweep's products cancel (a deflation removes most
    of its input; C_LR^T applied to a small singular vector), so the
    output's own largest entry would hold float64 rounding to the wrong
    scale.  None for the kernels that only filter and place."""
    plain = getattr(kernels, name + "_plain")
    if name == "rsf_apply":
        C, X, sizes = args
        return float(plain(mode, C.abs(), X.abs(), sizes, **kw).max())
    if name != "rsf_tsprod":
        return None
    A, B, sizes = args
    kw_abs = {k: v for k, v in kw.items() if k not in ("Z", "e", "floor")}
    m = plain("gram" if mode == "gram" else "mul", A.abs(), B.abs(), sizes, **kw_abs)
    return max(finite_max(m), finite_max(kw["Z"].abs()) if mode == "sub" else 0.0)


def finite_max(t):
    """Largest finite entry of ``t`` (0 if none): a cut whose Cholesky
    failed carries non-finite filled columns, which the caller reroutes."""
    t = t[t.isfinite()]
    return float(t.max()) if t.numel() else 0.0


def rsf_err(kernels, name, mode, args, kw, out, ref):
    """(relative, absolute) error of a K11 kernel's outputs against its
    twin's: integer outputs must be equal (else inf); float outputs must
    be non-finite at the same entries with the same value (NaN with NaN:
    a cut whose Cholesky failed, rerouted by the caller), else inf, and
    their finite entries are compared relative to :func:`rsf_magnitude`
    for the products ("scale" outputs
    with each column's 1/sqrt(e) factor divided out first, as both apply
    the same factor to the same e), to each output's largest entry for
    the filters and placements, and absolutely for the trace residuals."""
    mag = rsf_magnitude(kernels, name, mode, args, kw)
    rel = ab = 0.0
    for i, (g, r) in enumerate(zip(rsf_outputs(out), rsf_outputs(ref))):
        if not g.is_floating_point():
            if not bool((g == r).all()):
                return float("inf"), float("inf")
            continue
        fin = g.isfinite()
        same = (g == r) | (g.isnan() & r.isnan())
        if not bool(((fin == r.isfinite()) & (fin | same)).all()):
            return float("inf"), float("inf")
        diff = (g - r).abs().where(fin, 0.0)
        if mode == "scale":  # divide out d where d > 0 (both outputs are 0 elsewhere)
            d = kernels.rsf_inv_sqrt(kw["e"], kw["floor"])[:, None, :]
            diff = diff / d.clamp_min(1e-300) * (d > 0) + diff * (d <= 0)
        d = float(diff.max()) if diff.numel() else 0.0
        if name == "rsf_frames" and mode == "stats" and i == 2:
            scale = 1.0
        elif mag is not None:
            scale = max(mag, 1e-300)
        else:
            scale = max(finite_max(r.abs()), 1e-300)
        rel, ab = max(rel, d / scale), max(ab, d)
    return rel, ab


def rsf_tolerance(name, mode):
    return RSF_TRACE_ATOL if (name, mode) == ("rsf_frames", "stats") else KERNEL_RTOL


def _rsf_rows(sizes, side, L):
    """Per cut (block rows, complement rows) as host ints."""
    s = [int(x) for x in sizes.tolist()]
    return s, [L - x for x in s]


def rsf_cost(name, mode, args, kw, out):
    """(operations, bytes) of one K11 call, counted from its real work: the
    masked rows and live columns only; each input byte once (the shared
    C once, as its largest masked block), each output byte once."""
    if name == "rsf_apply":
        C, X, sizes = args
        L, n = C.shape[0], X.shape[-1]
        s, c = _rsf_rows(sizes, kw["side"], L)
        ins, outs = {"capp": (s, s), "mtapp": (s, c), "mapp": (c, s)}[mode]
        ncol = kw.get("ncol")
        neff = [min(int(v), n) for v in ncol.tolist()] if ncol is not None else [n] * len(s)
        flops = sum(2.0 * i * o * e for i, o, e in zip(ins, outs, neff))
        x_bytes = (max(ins) * n if X.dim() == 2 else sum(i * e for i, e in zip(ins, neff))) * 8
        return flops, max(i * o for i, o in zip(ins, outs)) * 8 + x_bytes + nbytes(out)
    if name == "rsf_tsprod":
        A, B, sizes = args
        m, L, p = A.shape
        q = B.shape[-1]
        s, _c = _rsf_rows(sizes, kw["side"], L)
        if mode == "gram":
            ncol = kw.get("ncol")
            pe = [min(int(v), p) for v in ncol.tolist()] if ncol is not None else [p] * m
            qe = [min(int(v), q) for v in ncol.tolist()] if ncol is not None else [q] * m
            return (sum(2.0 * si * a * b for si, a, b in zip(s, pe, qe)),
                    sum(si * (a + b) for si, a, b in zip(s, pe, qe)) * 8 + nbytes(out))
        extra = nbytes(kw["Z"]) if mode == "sub" else nbytes(kw["e"]) if mode == "scale" else 0
        return (sum(2.0 * si * p * q for si in s),
                sum(s) * p * 8 + nbytes(B) + extra + nbytes(out))
    if name == "rsf_ritz_select":
        # in place: U (shift) or V and C V (select) over the block rows read
        # once, the sizes, and what changes: the shifted diagonal entries of T
        # (read and written), or lam (read), lam_out and the dropped columns'
        # block rows (written)
        from temfpy_torch.ops.kernels import RSF_SENTINEL, rsf_block_mask

        X, Y, sizes = args
        s, _c = _rsf_rows(sizes, kw["side"], X.shape[1])
        r = X.shape[-1]
        if mode == "shift":
            blk = rsf_block_mask(sizes, kw["side"], X.shape[1], X.dtype)[:, :, None]
            shifted = int((~((blk * X * X).sum(1) > 0.25)).sum())
            return 2.0 * sum(s) * r, sum(s) * r * 8 + nbytes(sizes) + shifted * 16
        dropped = (out[1] == RSF_SENTINEL).sum(1).tolist()
        return (4.0 * sum(s) * r,
                2 * sum(s) * r * 8 + nbytes(sizes, kw["lam"], out[1])
                + sum(si * d for si, d in zip(s, dropped)) * 8)
    lam_all = args[0]
    m, n = lam_all.shape
    if mode == "stats":
        return float(m * n * n), nbytes(*args) + nbytes(out)
    k, nf, _tr, _order, U_all, Yf, info = args[1:]
    L, rf, kb = U_all.shape[1], Yf.shape[-1], kw["kb"]
    cols = sum(min(int(a), kb) + min(int(b), rf) for a, b in zip(k.tolist(), nf.tolist()))
    return 0.0, cols * L * 8 + nbytes(lam_all, k, nf, _tr, _order, info) + nbytes(out)


def rsf_library_ms(torch, kernels, name, mode, args, kw):
    """Milliseconds of torch.bmm computing the K11a/K11b call's product on
    its dense masked operands (built before the timing), else None."""
    if name not in ("rsf_apply", "rsf_tsprod"):
        return None
    if name == "rsf_apply":
        C, X, sizes = args
        L, m = C.shape[0], sizes.shape[0]
        blk = kernels.rsf_block_mask(sizes, kw["side"], L)
        mi, mo = {"capp": (blk, blk), "mtapp": (blk, 1 - blk), "mapp": (1 - blk, blk)}[mode]
        Cm = mo[:, :, None] * C[None] * mi[:, None, :]
        Xm = X.expand(m, *X.shape[-2:])
        if kw.get("ncol") is not None:
            Xm = Xm * (torch.arange(Xm.shape[-1], device=X.device)[None, :]
                       < kw["ncol"].long()[:, None]).to(X.dtype)[:, None]
        Xm = Xm.contiguous()
        return cuda_ms(lambda: torch.bmm(Cm, Xm), 3)
    A, B, sizes = args
    if mode == "gram":
        blk = kernels.rsf_block_mask(sizes, kw["side"], A.shape[1])[:, :, None]
        At = (blk * A).mT.contiguous()
        return cuda_ms(lambda: torch.bmm(At, B), 3)
    return cuda_ms(lambda: torch.bmm(A, B), 3)


RSF_IN_PLACE = {("rsf_ritz_select", "shift"): 1, ("rsf_ritz_select", "select"): 0}
"""(kernel, mode) -> the argument a K11 call updates in place (T, V)."""


class RsfRecords:
    """Per K11 kernel: the worst kernel-twin error and the summed kernel,
    twin, bound and library milliseconds over the calls it was given."""

    def __init__(self):
        self.rec = {n: {"max_abs_err": 0.0, "ms": 0.0, "ms_1call": 0.0, "plain_ms": 0.0,
                        "bound_ms": 0.0, "flops": 0.0, "bytes": 0.0, "library_ms": None,
                        "calls": 0}
                    for n in RSF_KERNELS}

    def add(self, torch, kernels, label, name, mode, args, kw):
        """One call of kernel ``name`` against its twin: fails beyond the
        tolerance, and for the redesigned ``rsf_apply``, ``rsf_tsprod`` and
        ``rsf_ritz_select`` unless a second launch returns the same bits;
        times kernel, twin and library call alike (:func:`cuda_ms`,
        TIMING_REPS) and the kernel's one call with its wrapper's host work
        (:func:`timed`); returns the kernel's output.  K11c updates T or V
        in place (RSF_IN_PLACE): each of its launches gets a clone of that
        operand of its own, made before the timed launches, so that no launch
        reads another's output and ``args`` stay the twin's inputs."""
        kernel, plain = getattr(kernels, name), getattr(kernels, name + "_plain")
        slot = RSF_IN_PLACE.get((name, mode))

        def fresh():
            if slot is None:
                return args
            return [a.clone() if i == slot else a for i, a in enumerate(args)]

        call = lambda: kernel(mode, *fresh(), **kw)  # noqa: E731
        first = fresh()
        out, t_1 = timed(torch, lambda: kernel(mode, *first, **kw))
        if name in ("rsf_apply", "rsf_tsprod", "rsf_ritz_select"):
            check_repeatable(torch, f"{label}: {name} {mode}", call, out)
        pool = iter([fresh() for _ in range(TIMING_REPS + 1)])
        t_k = cuda_ms(lambda: kernel(mode, *next(pool), **kw), TIMING_REPS)
        del pool
        ref = plain(mode, *args, **kw)
        t_p = cuda_ms(lambda: plain(mode, *args, **kw), TIMING_REPS)
        rel, ab = rsf_err(kernels, name, mode, args, kw, out, ref)
        if not rel <= rsf_tolerance(name, mode):
            raise AssertionError(f"{label}: {name} {mode} differs from its twin: rel err "
                                 f"{rel:.3e} (abs {ab:.3e})")
        f, b = rsf_cost(name, mode, args, kw, out)
        lib = rsf_library_ms(torch, kernels, name, mode, args, kw)
        r = self.rec[name]
        r["max_abs_err"] = max(r["max_abs_err"], ab)
        r["ms"] += t_k
        r["ms_1call"] += t_1
        r["plain_ms"] += t_p
        r["bound_ms"] += bound_ms(f, b)[0]
        r["flops"] += f
        r["bytes"] += b
        r["calls"] += 1
        if lib is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + lib
        return out, (rel, ab, t_k, t_1, t_p, bound_ms(f, b), lib)

    def records(self):
        out = {}
        for n, r in self.rec.items():
            out[n] = {"max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                      "bound_ms": r["bound_ms"],
                      "bound_by": bound_ms(r["flops"], r["bytes"])[1],
                      "library_ms": r["library_ms"]}
        return out

    def report(self, label):
        for n, r in self.rec.items():
            lib = (f", torch.bmm on the dense masked operands {r['library_ms']:.3f} ms"
                   if r["library_ms"] is not None else "")
            print(f"{label}: {n} over {r['calls']} calls: kernel {r['ms']:.3f} ms (one call "
                  f"each {r['ms_1call']:.3f} ms), plain "
                  f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
                  f"({bound_ms(r['flops'], r['bytes'])[1]}; {r['flops']:.3e} operations, "
                  f"{r['bytes']:.3e} bytes){lib}; max abs err {r['max_abs_err']:.3e}",
                  flush=True)


def phase_rsf_kernels(torch, kernels, testing):
    """Phase 3f: every mode of K11a-d against its twin on seeded inputs at
    the main path's shapes (testing.random_rsf_cases: L=1024, m=32, r=64,
    rf=512, kb=96, both sides; an empty, a tiny and an L/2 block; a lane
    _corth drops, a band keeping no column, the filled sketch's column mask
    and pad, rank ties and sentinels), each timed (:meth:`RsfRecords.add`)
    against its twin, with its bound and, for K11a/K11b, torch.bmm on the dense
    masked operands.  Returns the worst absolute error per kernel."""
    dev = torch.device("cuda")
    recs = RsfRecords()
    for side in ("L", "R"):
        for name, mode, args, kw in testing.random_rsf_cases(17, L=1024, m=32, r=64, rf=512,
                                                             kb=96, side=side):
            a = [torch.as_tensor(x, device=dev) for x in args]
            k = {key: torch.as_tensor(v, device=dev) if hasattr(v, "dtype") else v
                 for key, v in kw.items()}
            shape = "x".join(str(s) for s in a[1 if name != "rsf_frames" else 0].shape)
            _, (rel, ab, t_k, t_1, t_p, (t_b, by), lib) = recs.add(torch, kernels, "phase 3f",
                                                                   name, mode, a, k)
            lib_s = f", torch.bmm {lib:.3f} ms" if lib is not None else ""
            print(f"phase 3f: {name} {mode} side {side} ({shape}): rel err {rel:.3e}; kernel "
                  f"{t_k:.3f} ms (one call {t_1:.3f} ms), plain {t_p:.3f} ms, bound {t_b:.4f} ms "
                  f"({by}){lib_s}", flush=True)
    recs.report("phase 3f")
    return {n: r["max_abs_err"] for n, r in recs.rec.items()}


def with_rsf(mode, fn):
    return with_env("TEMFPY_TORCH_RSF", mode, fn)


def phase_rsf_parity(torch, np, slater, kernels, spectral):
    """Phase 4f: ``slater.H_to_MPS`` with the randomized frontend forced on
    (TEMFPY_TORCH_RSF=1) on phase 4's W=4, L=64 cylinder (chi=128) on the
    card (K11a-d launched) and on the CPU (twins): 1 - fidelity, squared
    Schmidt values and charges to PARITY_TOL, the cuts rerouted; and the
    card's RSF state against its default exact state: chi=128 does not bind
    here, so the two agree to PARITY_TOL too."""
    H = cylinder(4, 64, t2=-0.2)
    tp = {"chi_max": 128}
    for n in RSF_KERNELS:
        getattr(kernels, n).launches = 0
    t0 = time.perf_counter()
    gpu = with_rsf("1", lambda: slater.H_to_MPS(H, tp, device="cuda"))
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    launches = {n: getattr(kernels, n).launches for n in RSF_KERNELS}
    stats = spectral.rsf_stats()
    cpu = with_rsf("1", lambda: slater.H_to_MPS(H, tp, device="cpu"))
    exact = slater.H_to_MPS(H, tp, device="cuda")
    fid = lambda a, b: abs(a.overlap(b)) / np.sqrt(a.norm_squared() * b.norm_squared())  # noqa
    res = {}
    for name, other in (("cpu", cpu), ("exact", exact)):
        d_sv, d_w = spectra_diff(np, gpu, other)
        res[name] = (1 - fid(gpu, other), d_w)
    print(f"phase 4f: W=4 L=64 chi=128 RSF forced on, launches {launches}, cuts {stats}; card "
          f"{t_gpu:.2f} s; card vs cpu 1 - fidelity {res['cpu'][0]:.3e}, max squared-Schmidt "
          f"diff {res['cpu'][1]:.3e}; card RSF vs card exact 1 - fidelity "
          f"{res['exact'][0]:.3e}, diff {res['exact'][1]:.3e}; charges identical", flush=True)
    if min(launches.values()) <= 0:
        raise AssertionError(f"phase 4f: a K11 kernel was not launched: {launches}")
    for name, (inf, d_w) in res.items():
        if not (inf <= PARITY_TOL and d_w <= PARITY_TOL):
            raise AssertionError(f"phase 4f: card RSF vs {name}: 1 - fidelity {inf:.3e}, "
                                 f"squared Schmidt values {d_w:.3e} apart (> {PARITY_TOL})")


def rsf_hold_chunks(torch, kernels, spectral, C, chunks, label):
    """Every K11 call of main-path chunks, held against its twin and timed
    (:meth:`RsfRecords.add`): ``chunks`` lists (side, block sizes) of chunks the
    conversion runs, each run through ``rsf_sweep_frames`` with the kernels
    wrapped.  Prints the cuts each chunk keeps (its other cuts go to the
    exact frontend, so their kernel outputs are dropped) and raises if no
    chunk keeps one."""
    recs = RsfRecords()

    def wrap(name):
        def f(mode, *args, **kw):
            return recs.add(torch, kernels, label, name, mode, args, kw)[0]
        return f

    kept = []
    with patched(spectral, _KERNEL_OPS=tuple(wrap(n) for n in RSF_KERNELS)):
        for side, sizes in chunks:
            fallback = spectral.rsf_sweep_frames(C, sizes, side, 0.0)[3]
            kept.append(len(sizes) - len(fallback))
    print(f"{label}: held chunks (side, sizes) -> cuts kept: "
          f"{ {(side, f'{sz[0]}..{sz[-1]}'): k for (side, sz), k in zip(chunks, kept)} }",
          flush=True)
    if not any(kept):
        raise AssertionError(f"{label}: no held chunk keeps a cut")
    recs.report(label)
    return recs.records()


def rsf_memory(torch, spectral, C, sizes, side, label):
    """Where phase 9's peak device memory comes from: the peak above what
    is resident before each call, in MiB, of the frontend alone on one
    stream block of the conversion (``sizes``): ``rsf_sweep_frames`` (and
    what its frames hold after it returns, as the conversion keeps them
    while it reroutes), and ``eigh_blocks`` on the same sizes (the exact
    frontend's call, which the rerouted cuts take on top of those
    frames)."""
    from temfpy_torch.ops.linalg import eigh_blocks

    def peak(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - base
        del out
        return (torch.cuda.max_memory_allocated() - base) / 2**20, held / 2**20

    p_sweep, held = peak(lambda: spectral.rsf_sweep_frames(C, sizes, side, 0.0))
    p_eigh, _ = peak(lambda: eigh_blocks(C, sizes, side, chunk=len(sizes)))
    print(f"{label}: peak device memory above the resident, one stream block of "
          f"{len(sizes)} cuts (side {side}, sizes {sizes[0]}..{sizes[-1]}): rsf_sweep_frames "
          f"{p_sweep:.1f} MiB ({held:.1f} MiB held by its frames after it returns), "
          f"eigh_blocks on the same sizes {p_eigh:.1f} MiB", flush=True)


def phase_rsf_slice(torch, np, slater, fw, kernels, profiling, spectral, ph7):
    """Phase 9: the randomized frontend at full width, ``slater.H_to_MPS`` on
    bench config 1's W=8 cylinder at L=1024, chi=512, float64 with
    TEMFPY_TORCH_RSF=1, through :func:`slater_slice` (one conversion with
    the launches of K11a-d beside K1/K2 counted from 0 and the stage
    profile with the rsf/* stages, phase 7's checks with SLICE_BOUNDS
    without the canonical_form_finite round (phase 7 runs it at this
    shape); K1/K2 are held in phase 7 on the same shapes; the device
    profile covers one stream block, :func:`stream_block`); the cuts
    rerouted; every K11 call of three main-path chunks held against its
    twin: the first chunk of each side (block sizes 511..480 right and left
    of the centre, whose cuts the frontend sends back) and the first chunk
    of the left side's edge block (sizes 63..32, whose cuts it keeps); the
    state against phase 7's exact states ``ph7``: bench config 1 within
    CLEAN_FW_TOL (ties at the chi cut), and the 1e-3-disordered twin with
    the same kept counts on every bond and 1 - fidelity within
    FW_EXACT_TOL; and both frontends' wall time and eigh_batch stage."""
    H = cylinder(8, 1024)
    L = H.shape[0]
    C = slater.correlation_matrix(H, device="cuda")[0]
    c = L // 2
    m = spectral.RSF_CHUNK
    chunks = [("R", [L - x for x in range(c + 1, c + 1 + m)]),
              ("L", list(range(c - 1, c - 1 - m, -1))), ("L", list(range(63, 63 - m, -1)))]

    window = stream_block(slater, H, 512)

    def block():
        """:func:`stream_block` through the randomized frontend; the cut
        counts stay the counted conversion's."""
        counts = spectral.rsf_stats()
        out = window()
        spectral.reset_rsf_stats()
        spectral._STATS.update(counts)
        return out

    counted = ("det_fill", "site_overlap_schur", "site_overlap_schur_gmem") + RSF_KERNELS
    res = with_rsf("1", lambda: slater_slice(
        torch, np, slater, fw, kernels, profiling, H, 512, "phase 9", counted,
        bounds=SLICE_BOUNDS, hold_fill=False, profile=block, canon=False, once=True))
    stats = spectral.rsf_stats()
    print(f"phase 9: randomized frontend cuts {stats} (rerouted to the exact frontend: "
          f"{stats['rerouted']})", flush=True)
    rec = with_rsf("1", lambda: rsf_hold_chunks(torch, kernels, spectral, C, chunks,
                                                "phase 9"))
    rsf_memory(torch, spectral, C, [L - x for x in range(c + 1, c + 65)], "R", "phase 9")
    del C
    clean = compare_frontends(np, res["raw"], ph7["exact"])
    Hd = H + np.diag(1e-3 * np.random.default_rng(3).normal(size=L))
    # every K11a and K11c launch of this conversion metered
    meter = ConversionMeter(torch)
    ops = spectral._KERNEL_OPS
    apply, ritz = (meter.wrap(ops[i], lambda a, k, n=n: n,
                              lambda a, k, o, n=n: rsf_cost(n, a[0], a[1:], k, o))
                   for i, n in ((0, "rsf_apply"), (2, "rsf_ritz_select")))
    t0 = time.perf_counter()
    with patched(spectral, _KERNEL_OPS=(apply, ops[1], ritz, ops[3])):
        rsf_d = with_rsf("1", lambda: slater.H_to_MPS(Hd, {"chi_max": 512}, device="cuda"))
    torch.cuda.synchronize()
    t_d = time.perf_counter() - t0
    meter.report("phase 9", "disordered RSF conversion")
    stats_d = spectral.rsf_stats()
    dis = compare_frontends(np, rsf_d, ph7["exact_dis"])
    del rsf_d
    for name, cmp in (("bench config 1", clean), ("with 1e-3 disorder", dis)):
        print(f"phase 9: RSF vs phase 7's exact state, {name}: 1 - fidelity "
              f"{cmp['infidelity']:.3e}; kept counts differ on bonds {cmp['chi_bonds']}; "
              f"elsewhere max squared-Schmidt diff {cmp['d_w']:.3e}, charges "
              f"{'equal' if cmp['charges'] else 'DIFFER'}", flush=True)
    eig_rsf = res["prof"].seconds.get("eigh_batch", 0.0)
    print(f"phase 9: conversions (stages synchronised): randomized frontend, the first at "
          f"this size {res['warm']:.3f} s (eigh_batch {eig_rsf:.3f} s, of it rsf/eigh "
          f"{res['prof'].seconds.get('rsf/eigh', 0.0):.3f} s), exact frontend (phase 7) "
          f"{ph7['t_exact']:.3f} s (eigh_batch {ph7['eigh_exact']:.3f} s); disordered RSF "
          f"conversion {t_d:.2f} s (metered: each K11a and K11c launch waits behind the "
          f"meter's device sleep), cuts {stats_d}", flush=True)
    failures = []
    if stats["cuts"] != L or stats_d["cuts"] != L:
        failures.append(f"the frontend did not take every cut: {stats}, {stats_d}")
    if not clean["infidelity"] <= CLEAN_FW_TOL:
        failures.append(f"bench config 1: 1 - fidelity {clean['infidelity']:.3e} > "
                        f"{CLEAN_FW_TOL}")
    if dis["chi_bonds"] or not dis["infidelity"] <= FW_EXACT_TOL:
        failures.append(f"disordered: kept counts differ on {dis['chi_bonds']} or 1 - fidelity "
                        f"{dis['infidelity']:.3e} > {FW_EXACT_TOL}")
    if not (dis["d_w"] <= FW_SPECTRA_TOL and dis["charges"]):
        failures.append("disordered: spectra or charges differ between the frontends")
    if failures:
        raise AssertionError("phase 9: " + "; ".join(failures))
    return res["launches"], rec


# --------------------------------------------------------------------------
# Gutzwiller projection and iMPS (bench configs 3 and 4)
# --------------------------------------------------------------------------


CANONICAL_IMPS_TOL = 1e-5
"""Phase 10, the projected iMPS: sum_n B B^H = I per tensor, the tolerance
of tests/test_spinful_imps.py:73 (the infinite canonical form stops at a
transfer-map residual of 1e-9 and its power iteration at 1e-13 on a
chi^2-dimensional fixed point)."""


SPIN_SPECTRUM_TOL = 2e-8
"""Phase 10, config 4's spin MPS card vs CPU: squared Schmidt values per Sz
sector.  The sorted spectra of two reduced density matrices differ by at
most the norm of their difference, which is first order in the difference
of the two states, while 1 - fidelity is second order: a fermionic
difference that float64 fidelities cannot resolve (1 - F ~ 1e-14, a state
difference up to ~1e-7) moves the spin spectra of config 4 by ~1e-9.  Phase
10 prints a control beside the reading: two sound CPU conversions whose
Hamiltonians differ by one ulp (seeded), projected; the bound is about three
times the largest control reading (PERF.md section 5)."""


def fidelity(np, a, b):
    """|<a|b>| / sqrt(<a|a> <b|b>) of two finite MPS."""
    return abs(a.overlap(b)) / np.sqrt(a.norm_squared() * b.norm_squared())


def error_diff(a, b):
    """Max difference of the squared iMPSError fields: each field is the
    root of a difference of O(1) sums, so at rounding level its root
    amplifies the summation order; the squares compare at PARITY_TOL."""
    return max(abs(x * x - y * y) for x, y in zip(a, b))


def hold_every(torch, kernels, label, cap):
    """Every K1/K2 group the capture kept in ``every``, against its twin
    (:func:`hold`); returns the worst absolute difference per kernel."""
    held, worst = Counter(), Counter()
    for name, key, (args, kw) in cap["every"]:
        if name == "site_overlap_schur" and not kernels.site_overlap_fits_smem(key[1],
                                                                               args[0].dtype):
            name = "site_overlap_schur_gmem"
        _rel, ab, _ext = hold(torch, kernels, label, name, key, args, kw)
        held[name] += 1
        worst[name] = max(worst[name], ab)
    print(f"{label}: every K1/K2 group of the card run held against its twin: {dict(held)}",
          flush=True)
    return worst


def imps_checks(torch, np, imps, label):
    """A canonical iMPS: right-canonical tensors (CANONICAL_IMPS_TOL),
    normalised Schmidt values, a consistent wrap bond (a constant drift per
    cell) and the charge rule on every tensor.  Returns the worst
    canonicality residual."""
    res = max(canonical_residuals(torch, imps, i)[0] for i in range(imps.L))
    for i, B in enumerate(imps._B):
        qL = torch.as_tensor(imps.q_bond[i], device=B.device)[:, None, None]
        qp = torch.as_tensor(imps.sites[i].charges, device=B.device)[None, :, None]
        qR = torch.as_tensor(imps.q_bond[i + 1], device=B.device)[None, None, :]
        bad = (qL + qp - qR) != int(imps.qtotal[i])
        if float((B.abs() * bad).max()) > 1e-10:
            raise AssertionError(f"{label}: tensor {i} violates its charge rule")
    dq = imps.q_bond[imps.L] - imps.q_bond[0]
    s_norm = max(abs(np.linalg.norm(S) - 1) for S in imps._S)
    if not (res <= CANONICAL_IMPS_TOL and s_norm <= 1e-8 and dq.size and np.all(dq == dq[0])):
        raise AssertionError(f"{label}: canonicality residual {res:.3e}, Schmidt norm error "
                             f"{s_norm:.3e}, wrap drift {np.unique(dq)}")
    return res


def phase_gutzwiller(torch, np, slater, gutzwiller, fw, kernels):
    """Phase 10: Gutzwiller projection (bench config 4, bench.py:181-212).

    - Config 4 itself: the pi-flux cylinder W=4, Lx=8 with the 1e-4
      diag(arange(L)) split, chi=128, ``slater.H_to_MPS(..., spinful="PH")``
      then ``gutzwiller.abrikosov_ph`` on the card and on the CPU (twins):
      PARITY_TOL on the spin MPS's fidelity, SPIN_SPECTRUM_TOL on its
      squared Schmidt values per Sz sector (what
      ``entanglement_spectrum(by_charge=True)`` lists), with two CPU
      controls printed beside the reading; equal Sz bond labels.
    - Full width: the W=8, Lx=16 pi-flux cylinder at chi=512 (256
      fermionic sites -> 128 spin sites, the fermionic size of bench config
      1 at L=256) on the card, cold and warm, the conversion and the
      projection timed on their own, the K1/K2 launches of the cold run,
      every K1/K2 group of the warm run held against its twin, the peak
      memory, and the projected state's norm and canonical residuals at
      sites 0, L/2, L-1 (its ``canonical_form_finite`` ran inside the
      projection).
    - The infinite branch: ``slater.H_to_iMPS(..., spinful="PH")`` on config
      4's cylinder, one ring a cell (L_short=32, cut=16), chi=128, then
      ``abrikosov_ph`` and its ``canonical_form_infinite``, whose ARPACK
      fallbacks, matvecs and failures are printed (a failure raises):
      right-canonical tensors, normalised Schmidt values
      (:func:`imps_checks`).
    Returns (launches, worst kernel-twin differences)."""
    t_phase = time.perf_counter()
    tp = {"chi_max": 128}
    H = piflux(4, 8)
    fermions = [slater.H_to_MPS(H, tp, spinful="PH", device=dev) for dev in ("cuda", "cpu")]
    f_f = fidelity(np, *fermions)
    d_f = spectra_diff(np, *fermions, "phase 10", qtotal=True)[1]
    gpu, cpu = (gutzwiller.abrikosov_ph(m) for m in fermions)
    f = fidelity(np, gpu, cpu)
    d_w = spectra_diff(np, gpu, cpu, "phase 10", qtotal=True)[1]
    weight = min(gpu.norm, cpu.norm) ** 2
    # the control: H moved by one ulp (a seeded symmetric perturbation),
    # converted and projected on the CPU; its labels may differ where the
    # canonical form's cutoff meets a Schmidt value, so the sorted spectra
    # are compared per Sz sector with zeros for the missing values
    controls = []
    for seed in (0, 1):
        E = np.random.default_rng(seed).standard_normal(H.shape)
        ctl = gutzwiller.abrikosov_ph(slater.H_to_MPS(
            H + np.finfo(float).eps * (E + E.T) / 2, tp, spinful="PH", device="cpu"))
        controls.append(padded_spectra_diff(np, cpu, ctl))
    print(f"phase 10: config 4 (pi-flux W=4 Lx=8, PH, chi=128 -> {gpu.L} spin sites, chi_max "
          f"{gpu.chi_max}): fermionic MPS card vs CPU 1 - fidelity {1 - f_f:.3e}, squared-Schmidt "
          f"diff {d_f:.3e}; projected weight {weight:.3e}; spin MPS card vs CPU 1 - fidelity "
          f"{1 - f:.3e}, squared-Schmidt diff per Sz sector {d_w:.3e} (bound "
          f"{SPIN_SPECTRUM_TOL:.0e}), Sz labels identical; control (CPU, H moved by one ulp, "
          f"seeds 0, 1): {[f'{c:.3e}' for c in controls]}", flush=True)
    if not (1 - f <= PARITY_TOL and d_f <= PARITY_TOL and d_w <= SPIN_SPECTRUM_TOL):
        raise AssertionError("phase 10: card and CPU projections differ")

    # full width
    H = piflux(8, 16)
    tp = {"chi_max": 512}
    counted = ("det_fill", "site_overlap_schur", "site_overlap_schur_gmem")
    for name in counted:
        getattr(kernels, name).launches = 0
    torch.cuda.reset_peak_memory_stats()
    times = {}
    for run in ("cold", "warm"):
        ctx = (slater_capture(slater, fw, every=("det_fill", "site_overlap_schur"))
               if run == "warm" else contextlib.nullcontext({}))
        with ctx as cap:
            t0 = time.perf_counter()
            fmps = slater.H_to_MPS(H, tp, spinful="PH", device="cuda")
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        spin = gutzwiller.abrikosov_ph(fmps)
        torch.cuda.synchronize()
        times[run] = (t1 - t0, time.perf_counter() - t1)
        if run == "cold":
            launches = {name: getattr(kernels, name).launches for name in counted}
            if launches["det_fill"] <= 0 or launches["site_overlap_schur"] <= 0:
                raise AssertionError(f"phase 10: K1/K2 not launched: {launches}")
    peak = torch.cuda.max_memory_allocated()
    del fmps
    worst = hold_every(torch, kernels, "phase 10", cap)
    Ls = spin.L
    res = {i: canonical_residuals(torch, spin, i)[0] for i in (0, Ls // 2, Ls - 1)}
    nrm = spin.norm_squared()
    finite = all(bool(torch.isfinite(B).all()) for B in spin._B)
    print(f"phase 10: pi-flux W=8 Lx=16 PH chi=512 -> {Ls} spin sites (chi_max {spin.chi_max}): "
          f"launches {launches}; conversion cold {times['cold'][0]:.3f} s, warm "
          f"{times['warm'][0]:.3f} s; projection (with canonical_form_finite) cold "
          f"{times['cold'][1]:.3f} s, warm {times['warm'][1]:.3f} s; max_memory_allocated "
          f"{peak / 2**20:.1f} MiB; canonical residual at sites "
          f"{({i: f'{r:.3e}' for i, r in res.items()})}; <psi|psi> - 1 = {nrm - 1:.3e}",
          flush=True)
    if not (all(r <= 1e-10 for r in res.values()) and abs(nrm - 1) <= 1e-10 and finite
            and Ls == 128):
        raise AssertionError("phase 10: the projected state is not canonical and normalised")
    del spin, cap

    # the infinite branch
    t0 = time.perf_counter()
    imps, err = slater.H_to_iMPS(piflux(4, 8), piflux(4, 9), {"chi_max": 128}, 4, 16,
                                 spinful="PH", device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    spin = gutzwiller.abrikosov_ph(imps)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    res = imps_checks(torch, np, spin, "phase 10")
    stats = spin.transfer_stats
    print(f"phase 10: config 4 iMPS (one ring a cell, PH, chi=128): {err!r}; iMPS {t1 - t0:.3f} "
          f"s, projection + canonical_form_infinite {t2 - t1:.3f} s ({spin.L} spin sites, "
          f"bond dims {[len(S) for S in spin._S]}); ARPACK fallbacks {stats['fallbacks']}, "
          f"matvecs {stats['matvecs']}, failures {stats['arpack_failures']}; canonicality "
          f"residual {res:.3e}; entanglement entropy "
          f"{np.round(spin.entanglement_entropy(), 6).tolist()}", flush=True)
    if stats["arpack_failures"]:
        raise AssertionError("phase 10: the ARPACK branch failed; the canonical form kept an "
                             "unconverged power iterate")
    print(f"phase 10: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches, worst


def dimer_chain(n):
    """Bench config 3's dimerized chain (bench.py:160-164)."""
    import numpy as np

    H = np.zeros((n, n))
    for i in range(n - 1):
        H[i, i + 1] = H[i + 1, i] = -1.0 - 0.3 * (-1) ** i
    return H


def phase_imps(torch, np, slater, pfaffian, fw, kernels, testing):
    """Phase 11: iMPS (bench config 3, bench.py:157-178).

    - Config 3 itself: the dimerized chain at L=128, a cell of 2 sites,
      chi=64, cut=64, on the card and on the CPU (twins): the iMPSError
      fields (squared, :func:`error_diff`) and the squared Schmidt values
      at PARITY_TOL, equal labels, and on each device the splice of n = 1,
      3 cells into the L=128 conversion against the conversion of L + 2n:
      |overlap| within 1e-6 of 1 (tests/test_imps.py:84-113).
    - Full width, two W=8 cylinders at L_short=256, cut=128, chi=512, two
      rings a cell (sites_per_cell=16, the period of ``cylinder``'s
      alternating hoppings): bench config 1's, which is gapless, and a
      gapped one (t2=-0.2), each on the card with the kernels (K1/K2
      launches, every group held against its twin) and with the twins on
      the card (:func:`slater_imps_cell`); wall time and peak memory.  The
      iMPSError is printed, not bounded; the agreement of the two runs is
      bounded in full on the gapped cell only.
    - The Pfaffian iMPS on bench config 5's p+ip W=8 cylinder (Lx_short=16,
      one ring a cell, chi=256): K3/K4 launched, every group held against
      its twin at KERNEL_RTOL, and the same comparisons, bounded in full.
    Returns (launches, worst kernel-twin differences)."""
    t_phase = time.perf_counter()
    H = dimer_chain(128)
    H2 = dimer_chain(130)
    tp = {"chi_max": 64}
    out = {}
    for dev in ("cuda", "cpu"):
        imps, err = slater.H_to_iMPS(H, H2, tp, 2, 64, device=dev)
        short = slater.H_to_MPS(H, tp, device=dev)
        ovs = [abs(slater.H_to_MPS(dimer_chain(128 + 2 * n), tp, device=dev).overlap(
            short.splice(imps, 64, n))) for n in (1, 3)]
        out[dev] = (imps, err, ovs)
    d_w = spectra_diff(np, out["cuda"][0], out["cpu"][0], "phase 11", qtotal=True)[1]
    d_e = error_diff(out["cuda"][1], out["cpu"][1])
    print(f"phase 11: config 3 (dimerized chain L=128, cell 2, chi=64): card {out['cuda'][1]!r}; "
          f"card vs CPU squared iMPSError fields diff {d_e:.3e}, squared-Schmidt diff "
          f"{d_w:.3e}, labels identical; splice |overlap| n=1, 3: card "
          f"{[f'{o:.12f}' for o in out['cuda'][2]]}, CPU {[f'{o:.12f}' for o in out['cpu'][2]]}",
          flush=True)
    if not (d_w <= PARITY_TOL and d_e <= PARITY_TOL
            and all(abs(o - 1) <= 1e-6 for dev in out for o in out[dev][2])):
        raise AssertionError("phase 11: config 3's iMPS differs between card and CPU or does "
                             "not reconstruct the longer chains")
    del out

    # full width, Slater: kernels against twins on the card
    counted = ("det_fill", "site_overlap_schur", "site_overlap_schur_gmem")
    for name in counted:
        getattr(kernels, name).launches = 0
    worst = Counter()
    for t2, certify, label in ((-1.3, False, "bench config 1 cylinder W=8"),
                               (-0.2, True, "gapped cylinder W=8 (t2=-0.2)")):
        w = slater_imps_cell(torch, np, slater, fw, kernels, cylinder(8, 256, t2),
                             cylinder(8, 272, t2), certify,
                             f"phase 11: {label}, L_short=256, two rings a cell, chi=512")
        worst = Counter({k: max(worst[k], w[k]) for k in set(worst) | set(w)})
    launches = {name: getattr(kernels, name).launches for name in counted}
    if launches["det_fill"] <= 0 or launches["site_overlap_schur"] + launches[
            "site_overlap_schur_gmem"] <= 0:
        raise AssertionError(f"phase 11: K1/K2 not launched: {launches}")
    print(f"phase 11: Slater cells: launches {launches}", flush=True)

    # the Pfaffian iMPS: kernels against twins on the card, every K3/K4
    # group held
    H, H2 = testing.pip_hamiltonian(8, 16), testing.pip_hamiltonian(8, 17)
    tp = {"chi_max": 256}
    kernels.pf_fill.launches = kernels.bdg_overlap.launches = 0
    groups = []

    def keep(name):
        fn = getattr(pfaffian, name)

        def call(*a, **kw):
            groups.append((name, a, kw))
            return fn(*a, **kw)
        return call

    with patched(pfaffian, pf_fill=keep("pf_fill"), bdg_overlap=keep("bdg_overlap")):
        t0 = time.perf_counter()
        imps, err = pfaffian.H_to_iMPS(H, H2, tp, 8, 64, basis="C", device="cuda")
        torch.cuda.synchronize()
        t_k = time.perf_counter() - t0
    pf_launches = {"pf_fill": kernels.pf_fill.launches,
                   "bdg_overlap": kernels.bdg_overlap.launches}
    if min(pf_launches.values()) <= 0:
        raise AssertionError(f"phase 11: K3/K4 not launched: {pf_launches}")
    held = Counter()
    for name, a, kw in groups:
        rel, ab = (pf_err if name == "pf_fill" else bdg_err)(torch, kernels, a, kw)
        held[name] += 1
        worst[name] = max(worst[name], ab)
        if not rel <= KERNEL_RTOL:
            raise AssertionError(f"phase 11: {name} group: kernel-twin rel err {rel:.3e}")
    del groups
    short = pfaffian.H_to_MPS(H, tp, basis="C", device="cuda")
    with patched(pfaffian, pf_fill=kernels.pf_fill_plain, bdg_overlap=kernels.bdg_overlap_plain):
        twin, err_t = pfaffian.H_to_iMPS(H, H2, tp, 8, 64, basis="C", device="cuda")
        short_t = pfaffian.H_to_MPS(H, tp, basis="C", device="cuda")
    imps_against_twins(np, (short, short_t), 64, (imps, err), (twin, err_t),
                       "phase 11: Pfaffian iMPS, p+ip W=8 Lx_short=16, cell 8, chi=256",
                       certify=True)
    print(f"phase 11: Pfaffian iMPS: launches {pf_launches}, every group held against its twin "
          f"{dict(held)} (worst abs {dict(worst)}); kernels {t_k:.3f} s", flush=True)
    print(f"phase 11: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {**launches, **pf_launches}, worst


def slater_imps_cell(torch, np, slater, fw, kernels, H, H2, certify, label):
    """One full-width Slater iMPS cell (two rings, cut=128, chi=512): the
    card run with the kernels, every K1/K2 group held against its twin,
    then the run with the twins on the card, compared by
    :func:`imps_against_twins`.  Returns the worst kernel-twin differences
    per kernel."""
    tp = {"chi_max": 512}
    torch.cuda.reset_peak_memory_stats()
    with slater_capture(slater, fw, every=("det_fill", "site_overlap_schur")) as cap:
        t0 = time.perf_counter()
        imps, err = slater.H_to_iMPS(H, H2, tp, 16, 128, device="cuda")
        torch.cuda.synchronize()
        t_k = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    worst = hold_every(torch, kernels, label, cap)
    del cap
    short = slater.H_to_MPS(H, tp, device="cuda")
    with patched(slater, det_fill=kernels.det_fill_plain,
                 site_overlap_schur=kernels.site_overlap_schur_plain):
        t0 = time.perf_counter()
        twin, err_t = slater.H_to_iMPS(H, H2, tp, 16, 128, device="cuda")
        torch.cuda.synchronize()
        t_t = time.perf_counter() - t0
        short_t = slater.H_to_MPS(H, tp, device="cuda")
    imps_against_twins(np, (short, short_t), 128, (imps, err), (twin, err_t), label, certify)
    print(f"{label}: bond dims {[len(S) for S in imps._S]}; kernels {t_k:.3f} s, twins "
          f"{t_t:.3f} s, max_memory_allocated {peak / 2**20:.1f} MiB", flush=True)
    return worst


def imps_against_twins(np, shorts, cut, ours, twins, label, certify):
    """An iMPS with the kernels against the same with the twins on the
    card.  Each is spliced (n=1) into its own short chain (``shorts``: the
    kernels' and the twins' conversion), so that the two splices compare as
    states whatever basis each chain took in its degenerate Schmidt
    multiplets.  Bounded at PARITY_TOL: the squared Schmidt values, labels
    and tensor charges, and the squared unitarity errors, which the
    overlaps alone fix.  With ``certify`` also the squared Schmidt-mixing
    errors and 1 - fidelity of the two splices: they depend on the
    Procrustes rotation, which is unique only where the cell's two
    Schmidt bases span each other (a gapped cell at the Hamiltonian's
    period, the p+ip cell); on bench config 1's gapless cylinder the
    rotation's completion on the overlap's null space follows the
    rounding, so they are printed only."""
    (imps, err), (twin, err_t) = ours, twins
    d_w = spectra_diff(np, imps, twin, label, qtotal=True)[1]
    d_u = max(abs(err.left_unitary**2 - err_t.left_unitary**2),
              abs(err.right_unitary**2 - err_t.right_unitary**2))
    d_e = error_diff(err, err_t)
    f = fidelity(np, shorts[0].splice(imps, cut, 1), shorts[1].splice(twin, cut, 1))
    print(f"{label}: {err!r}; kernels vs twins: squared-Schmidt diff {d_w:.3e}, squared "
          f"unitarity errors diff {d_u:.3e}, squared iMPSError fields diff {d_e:.3e} (Schmidt "
          f"mixing {err.left_schmidt:.6e}, {err.right_schmidt:.6e} vs {err_t.left_schmidt:.6e}, "
          f"{err_t.right_schmidt:.6e}), splices (n=1) 1 - fidelity {1 - f:.3e}; "
          f"{'bounded' if certify else 'the last two printed only (gauge not unique)'}",
          flush=True)
    bounded = [d_w, d_u] + ([d_e, 1 - f] if certify else [])
    if not all(x <= PARITY_TOL for x in bounded):
        raise AssertionError(f"{label}: the kernels' and the twins' iMPS differ")


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
    from temfpy_torch.ops import _build, fw, kernels, spectral

    testing.TEST_ACTION = "pass"

    # phase 2: build
    t0 = time.perf_counter()
    _build.load()
    print(f"phase 2: kernels built and loaded in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds})", flush=True)

    t_start = time.perf_counter()

    def elapsed(label):
        print(f"{label}: done {time.perf_counter() - t_start:.1f} s after the build", flush=True)

    # the phases of the earlier slices run the direct fill on both devices
    # (the CPU's default is the rank-update path); 4e and 8 turn it on
    os.environ["TEMFPY_TORCH_DET_UPDATES"] = "0"
    worst = phase_kernels(torch, kernels, testing)
    elapsed("phase 3")
    worst.update(phase_pf_kernels(torch, kernels, testing))
    elapsed("phase 3b")
    worst.update(phase_fw_kernels(torch, kernels, testing))
    elapsed("phase 3c")
    worst_swap = phase_swap_kernels(torch, kernels, testing)
    elapsed("phase 3d")
    launches, rec = phase_index_row_ops(torch, np, kernels, testing)
    elapsed("phase 3e")
    worst_rsf = phase_rsf_kernels(torch, kernels, testing)
    elapsed("phase 3f")
    phase_parity(torch, np, slater)
    phase_pf_parity(torch, np, pfaffian, testing)
    elapsed("phases 4, 4b")
    phase_fw_parity(torch, np, slater, fw, kernels)
    elapsed("phase 4c")
    n, r = phase_pf_gmem_parity(torch, np, pfaffian, kernels, testing)
    launches.update(n)
    rec.update(r)
    elapsed("phase 4d")
    rows_4e = phase_swap_parity(torch, np, slater, kernels)
    elapsed("phase 4e")
    phase_rsf_parity(torch, np, slater, kernels, spectral)
    elapsed("phase 4f")
    direct = phase_full(torch, np, slater, fw, kernels, profiling)
    launches.update(direct["launches"])
    rec.update(direct["rec"])
    elapsed("phase 5")
    # phase 8 reads its own counts; det_fill and site_overlap_schur keep
    # phase 5's (their slice), their errors take the worst of both
    n8, r8 = phase_swap_slice(torch, np, slater, fw, kernels, profiling, direct)
    del direct
    elapsed("phase 8")
    for k in SWAP_KERNELS:
        launches[k] = n8[k]
        rec[k] = r8[k]
    if launches["det_rows"] == 0:
        launches["det_rows"] = rows_4e["det_rows"]
    for k in ("det_fill", "site_overlap_schur"):
        rec[k]["max_abs_err"] = max(rec[k]["max_abs_err"], r8[k]["max_abs_err"])
    n, r = phase_pfaffian_full(torch, np, pfaffian, kernels, profiling, testing)
    launches.update(n)
    rec.update(r)
    elapsed("phase 6")
    # phase 7 reads its own counts; det_fill and site_overlap_schur keep
    # phase 5's (their slice), their errors take the worst of both
    n7, r7, ph7 = phase_slice(torch, np, slater, fw, kernels, profiling)
    elapsed("phase 7")
    for k in ("site_overlap_schur_gmem", "fw_frame_slab"):
        launches[k] = n7[k]
        rec[k] = r7[k]
    for k in ("det_fill", "site_overlap_schur"):
        rec[k]["max_abs_err"] = max(rec[k]["max_abs_err"], r7[k]["max_abs_err"])
    # phase 9 reads its own counts for K11a-d and compares with phase 7's
    # exact states
    n9, r9 = phase_rsf_slice(torch, np, slater, fw, kernels, profiling, spectral, ph7)
    del ph7
    elapsed("phase 9")
    for k in RSF_KERNELS:
        launches[k] = n9[k]
        rec[k] = r9[k]
    # phases 10 and 11 check that their kernels launched; the kernels keep
    # the launches of their own slices, their errors take the worst
    from temfpy_torch import gutzwiller

    _n10, worst10 = phase_gutzwiller(torch, np, slater, gutzwiller, fw, kernels)
    elapsed("phase 10")
    _n11, worst11 = phase_imps(torch, np, slater, pfaffian, fw, kernels, testing)
    elapsed("phase 11")
    for k, ab in list(worst10.items()) + list(worst11.items()):
        rec[k]["max_abs_err"] = max(rec[k]["max_abs_err"], ab)
    for k, ab in list(worst.items()) + list(worst_swap.items()) + list(worst_rsf.items()):
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
        "bdg_overlap_wide": ("temfpy_torch/csrc/bdg_overlap.cu",
                             "temfpy_tpu/pfaffian.py:772"),
        "fw_frame_slab": ("temfpy_torch/csrc/fw_frame_slab.cu",
                          "temfpy_tpu/ops/fw.py:314"),
        "swap_tables": ("temfpy_torch/csrc/swap_tables.cu",
                        "temfpy_tpu/ops/linalg.py:741"),
        "swap_fill": ("temfpy_torch/csrc/swap_fill.cu",
                      "temfpy_tpu/slater.py:1038"),
        "det_rows": ("temfpy_torch/csrc/det_rows.cu",
                     "temfpy_tpu/ops/linalg.py:540"),
        "pf_gather": ("temfpy_torch/csrc/pf_gather.cu",
                      "temfpy_tpu/ops/pfaffian.py:502"),
        **{k: (f"temfpy_torch/csrc/{k}.cu", "temfpy_tpu/ops/spectral.py:153")
           for k in RSF_KERNELS},
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
