"""The configurations' Hamiltonians at zero field equal bench.py's and
chip_smoke's, entry for entry; the field lands where it says."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import manifest

ROOT = manifest.ROOT


def _config(name):
    with open(manifest.HERE / "configs" / f"{name}.json") as f:
        return json.load(f)


def test_cylinder_equals_chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    cfg = _config("slater_cyl8")
    ham = manifest.load_module(manifest.HERE / "hamiltonians" / "cylinder.py")
    for Lx in (4, 32):
        H = ham.build(cfg["params"], Lx)
        np.testing.assert_array_equal(H, chip_smoke.cylinder(8, 8 * Lx))
    field = np.arange(8 * 4, dtype=float)
    H0 = ham.build(cfg["params"], 4)
    np.testing.assert_array_equal(ham.with_field(H0, field) - H0, np.diag(field))


_CAPTURE = """
import sys
import numpy as np
sys.path.insert(0, {root!r})
import bench
import temfpy_tpu.pfaffian as pf

class Captured(Exception):
    pass

def capture(H, basis=None, **kw):
    np.save({out!r}, np.asarray(H))
    raise Captured

pf.correlation_matrix = capture
try:
    bench.bench_pfaffian_pip(W=8, Lx=4, chi=8)
except Captured:
    pass
"""


def test_pip_cylinder_equals_bench(tmp_path):
    """bench.py builds config 5's Hamiltonian inside ``bench_pfaffian_pip``
    and hands it to the JAX package's ``correlation_matrix``: intercepted
    there, in a process of its own (the harness's may not load JAX)."""
    if importlib.util.find_spec("jax") is None:
        pytest.skip("bench.py's Hamiltonian comes from a run of the JAX package")
    out = tmp_path / "H.npy"
    p = subprocess.run([sys.executable, "-c", _CAPTURE.format(root=str(ROOT), out=str(out))],
                       capture_output=True, text=True, timeout=600,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert p.returncode == 0, p.stderr
    cfg = _config("pfaffian_pip8")
    ham = manifest.load_module(manifest.HERE / "hamiltonians" / "pip_cylinder.py")
    H = ham.build(cfg["params"], 4)
    np.testing.assert_array_equal(H, np.load(out))
    field = np.linspace(-1, 1, 32)
    d = np.diag(ham.with_field(H, field) - H).real
    np.testing.assert_allclose(d[0::2], -field / 2)
    np.testing.assert_allclose(d[1::2], field / 2)
