"""Build and load the hand-written CUDA kernels of :mod:`temfpy_torch`.

At first use, every ``temfpy_torch/csrc/*.cu`` is compiled by ``nvcc`` for
``sm_90a`` (Hopper) into one shared library with a plain C interface, which
is loaded with :mod:`ctypes`.  The library goes to ``temfpy_torch/_build/``
under a name that carries a hash of the sources, so an edited source is
rebuilt and an unchanged one is reused.  Nothing is built when a module is
imported; a missing ``nvcc`` raises :class:`RuntimeError` naming the
command.
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
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None
"""Wall-clock of the last build in this process (None: loaded from an
existing library or not built)."""

_vp = ctypes.c_void_p
_i = ctypes.c_int
_SIGNATURES = {
    # dtype, M, det_always, occ_b, occ_k, pr, pc, tab0, tab1, tab2, out,
    # G, m, w, R_b, K_b, P_b, n0, n1, n2, sel, D0p1, D1, D2, stream
    "tf_det_fill": [_i] + [_vp] * 10 + [_i] * 13 + [_vp],
    # dtype, frames_b, frames_k, G, L, Wb, Wk, colb, kindb, rowb, signb,
    # colk, kindk, rowk, signk, mb, kb, right_mode, det_out, S_out, stream
    "tf_site_overlap_schur": [_i, _vp, _vp] + [_i] * 4 + [_vp] * 8 + [_i] * 3
    + [_vp] * 3,
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


def nvcc_command(nvcc: str, out: Path) -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out),
            *(str(p) for p in sources())]


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
        cmd = " ".join(nvcc_command("nvcc", target))
        raise RuntimeError(
            "building the temfpy_torch CUDA kernels needs nvcc, which was not "
            f"found (CUDA_HOME, PATH, {DEFAULT_CUDA_HOME}); the command is: {cmd}"
        )
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = nvcc_command(nvcc, Path(tmp))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, target)
    build_seconds = time.perf_counter() - t0
    return target


def load() -> ctypes.CDLL:
    """The kernel library, built on first call, with ``argtypes`` set."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
