"""temfpy_torch must not import jax, directly or through temfpy_tpu.

Checked in a fresh interpreter: tests/conftest.py imports jax into this
one."""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_and_runs_without_jax():
    code = textwrap.dedent(
        """
        import sys
        import numpy as np
        import temfpy_torch
        from temfpy_torch import config, mps, profiling, schmidt_utils, slater, testing, utils
        from temfpy_torch.mps import io
        from temfpy_torch.ops import _build, kernels, linalg

        H = np.diag(-np.ones(7), 1)
        H = H + H.T
        state = slater.H_to_MPS(H, {"chi_max": 16}, device="cpu")
        assert abs(state.norm_squared() - 1) < 1e-10
        bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "temfpy_tpu")))
        assert not bad, bad
        print("ok")
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
