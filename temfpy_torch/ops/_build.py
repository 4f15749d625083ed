"""Build and load the hand-written CUDA kernels of :mod:`temfpy_torch`.

At first use, every ``temfpy_torch/csrc/*.cu`` is compiled by ``nvcc`` for
``sm_90a`` (Hopper), one ``nvcc`` process per source, all started together,
and the objects are linked into one shared library with a plain C
interface, which is loaded with :mod:`ctypes`.  The library goes to
``temfpy_torch/_build/`` under a name that carries a hash of the sources,
so an edited source is rebuilt and an unchanged one is reused.  Nothing is
built when a module is imported; a missing ``nvcc`` raises
:class:`RuntimeError` naming the commands.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
DEFAULT_CUDA_HOME = Path("/usr/local/cuda")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None
"""Wall-clock of the last build in this process (None: loaded from an
existing library or not built)."""

_vp = ctypes.c_void_p
_i = ctypes.c_int
_d = ctypes.c_double
_SIGNATURES = {
    # dtype, M, det_always, occ_b, occ_k, pr, pc, tab0, tab1, tab2, slot,
    # out, G, m, w, R_b, K_b, P_b, n0, n1, n2, sel, D0p1, D1, D2,
    # pairs_per_block, stream
    "tf_det_fill": [_i] + [_vp] * 11 + [_i] * 14 + [_vp],
    # dtype, frames_b, frames_k, G, L, Wb, Wk, colb, kindb, rowb, signb,
    # colk, kindk, rowk, signk, mb, kb, right_mode, cluster, rows_per_block,
    # smem, work, det_out, S_out, stream
    "tf_site_overlap_schur": [_i, _vp, _vp] + [_i] * 4 + [_vp] * 8 + [_i] * 6
    + [_vp] * 4,
    # V1h, V2h, j1, j2, thresh, G, nb, k1, k2, cluster, rows_per_block, smem,
    # work, N_out, norm_out, stream
    "tf_bdg_overlap": [_vp] * 5 + [_i] * 7 + [_vp] * 4,
    # VT, flat, Cmat, out, B, L, kb, keb, fb, Wb, right, stream
    "tf_fw_frame_slab": [_vp] * 4 + [_i] * 7 + [_vp],
    # N, norm, pos_b, pos_k, cnt_b, cnt_k, pr, pc, tab0, tab1, tab2, out,
    # G, m, width, wt, R_b, K_b, P_b, n0, n1, n2, sel, D0p1, D1, D2,
    # pairs_per_block, threads, stage, stream
    "tf_pf_fill": [_vp] * 13 + [_i] * 17 + [_vp],
    # dtype, M, scale, idx_b, idx_k, out, G, m, w, nb, nk, cross,
    # dets_per_block, threads, stage, stream
    "tf_det_rows": [_i] + [_vp] * 5 + [_i] * 9 + [_vp],
    # dtype, M, r0, c0, D0, G, P, T2, T3, gmax, tmax, E, m, w, stream
    "tf_swap_tables": [_i] + [_vp] * 10 + [_i] * 3 + [_vp],
    # dtype, M, det_always, D0, G, P, T2, T3, Rin, Rout, Rpos, sgr, Cin, Cout,
    # Cpos, sgc, pr, pc, tab0, tab1, tab2, slot, out, U, m, w, R_b, K_b, Wr,
    # Wc, P_b, s_b, n0, n1, n2, sel, D0p1, D1, D2, scatter, pairs_per_block,
    # threads, stage, stream
    "tf_swap_fill": [_i] + [_vp] * 22 + [_i] * 20 + [_vp],
    # dtype, N, bra_idx, ket_idx, out, m, nb, nk, kb, kk, stream
    "tf_pf_gather": [_i] + [_vp] * 4 + [_i] * 5 + [_vp],
    # C, X, x_shared, sizes, ncol, out, m, L, n, right, mode, stream
    "tf_rsf_apply": [_vp, _vp, _i, _vp, _vp, _vp] + [_i] * 5 + [_vp],
    # A, B, sizes, ncol, G, m, L, p, q, right, tile, stream
    "tf_rsf_gram": [_vp] * 5 + [_i] * 6 + [_vp],
    # A, B, D, stream
    "tf_dmma_probe": [_vp] * 4,
    # A, S, Z, e, sizes, out, floor, m, L, p, q, right, mode, stream
    "tf_rsf_combine": [_vp] * 6 + [_d] + [_i] * 6 + [_vp],
    # U, T, sizes, big, m, L, r, right, stream
    "tf_rsf_ritz_shift": [_vp] * 3 + [_d] + [_i] * 4 + [_vp],
    # V (updated in place), CV, lam, sizes, lam_out, lo2, hi_ext, res_tol,
    # sentinel, m, L, r, right, stream
    "tf_rsf_ritz_select": [_vp] * 5 + [_d] * 4 + [_i] * 4 + [_vp],
    # lam, tr, k, nf, tr_res, order, sentinel, m, n, stream
    "tf_rsf_frames_stats": [_vp] * 6 + [_d] + [_i] * 2 + [_vp],
    # U_all, Yf, lam, k, nf, tr_res, order, slab, packed, sentinel, m, L, n,
    # rf, kb, Wb, stream
    "tf_rsf_frames_place": [_vp] * 10 + [_d] + [_i] * 6 + [_vp],
}


def find_nvcc() -> str | None:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the default
    toolkit location; None if there is none."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").is_file():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = DEFAULT_CUDA_HOME / "bin" / "nvcc"
    return str(default) if default.is_file() else None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def nvcc_commands(nvcc: str, out: Path, objdir: Path) -> tuple[list[list[str]], list[str]]:
    """(one compile command per source, the link command) building ``out``
    with objects in ``objdir``."""
    objs = [objdir / (p.stem + ".o") for p in sources()]
    compiles = [[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(o), str(p)]
                for p, o in zip(sources(), objs)]
    return compiles, [nvcc, *NVCC_FLAGS, "-shared", "-o", str(out), *map(str, objs)]


def build() -> Path:
    """Compiles the kernels if no library for the current sources exists;
    returns the library's path."""
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = BUILD_DIR / f"libtemfpy_kernels_{_source_hash()}.so"
    if target.is_file():
        return target
    nvcc = find_nvcc()
    if nvcc is None:
        compiles, link = nvcc_commands("nvcc", target, BUILD_DIR)
        cmds = "; ".join(" ".join(c) for c in compiles + [link])
        raise RuntimeError(
            "building the temfpy_torch CUDA kernels needs nvcc, which was not "
            f"found (CUDA_HOME, PATH, {DEFAULT_CUDA_HOME}); the commands are: {cmds}"
        )
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        tmp = Path(work) / target.name
        compiles, link = nvcc_commands(nvcc, tmp, Path(work))
        procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True)) for cmd in compiles]
        failed = []
        for cmd, proc in procs:
            out, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}\n{err}")
        if not failed:
            proc = subprocess.run(link, capture_output=True, text=True)
            if proc.returncode != 0:
                failed.append(f"link failed ({proc.returncode}): {' '.join(link)}\n"
                              f"{proc.stdout}\n{proc.stderr}")
        if failed:
            raise RuntimeError("\n".join(failed))
        os.replace(tmp, target)
    build_seconds = time.perf_counter() - t0
    return target


def load() -> ctypes.CDLL:
    """The kernel library, built on first call, with ``argtypes`` set."""
    global _lib
    if _lib is not None:  # every launch asks: no lock once loaded
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
