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
        from temfpy_torch import (config, gutzwiller, iMPS, mps, pfaffian, profiling,
                                  schmidt_utils, slater, testing, utils)
        from temfpy_torch.mps import io
        from temfpy_torch.ops import _build, fw, kernels, linalg, spectral
        from temfpy_torch.ops import pfaffian as ops_pfaffian

        H = np.diag(-np.ones(7), 1)
        H = H + H.T
        state = slater.H_to_MPS(H, {"chi_max": 16}, device="cpu")
        assert abs(state.norm_squared() - 1) < 1e-10
        bdg = pfaffian.H_to_MPS(testing.pip_hamiltonian(2, 3), {"chi_max": 16}, basis="C",
                                device="cpu")
        assert abs(bdg.norm_squared() - 1) < 1e-10
        # Gutzwiller projection, finite and infinite, and the iMPS drivers
        spin = gutzwiller.abrikosov_ph(slater.H_to_MPS(H[:4, :4], {"chi_max": 32},
                                                       spinful="PH", device="cpu"))
        assert spin.L == 4 and abs(spin.norm_squared() - 1) < 1e-10

        def dimer(L):
            M = np.diag(np.where(np.arange(L - 1) % 2, -2.5, -1.0), 1)
            return M + M.T

        cell, err = slater.H_to_iMPS(dimer(4), dimer(6), {"chi_max": 64}, 2, 2, spinful="PH",
                                     device="cpu")
        spin = gutzwiller.abrikosov_ph(cell)
        assert not spin.finite and max(abs(np.linalg.norm(S) - 1) for S in spin._S) < 1e-8
        short, long_ = (slater.H_to_MPS(dimer(L), {"chi_max": 16}, device="cpu") for L in (8, 10))
        cell, err = iMPS.MPS_to_iMPS(short, long_, 2, 4)
        assert np.isfinite(err.total_error) and not cell.finite and cell.L == 2
        # the rank-update fill (on by default for CPU conversions) and the
        # index-row batches
        W, L = 8, 32
        Hc = np.zeros((L, L))
        for i in range(L):
            Hc[i, (i // W) * W + (i + 1) % W] = Hc[(i // W) * W + (i + 1) % W, i] = -1.0
            if i + W < L:
                Hc[i, i + W] = Hc[i + W, i] = -1.0
        swap = slater.H_to_MPS(Hc, {"chi_max": 96}, device="cpu")
        assert slater._swap_stats()["classes"] > 0 and swap.L == L
        import torch
        M = torch.eye(4, dtype=torch.float64)
        assert linalg.batched_det_gather(M, [[0, 1]], [[0, 1], [1, 0]]).tolist() == [[1.0, -1.0]]
        assert linalg.batched_det_pairs(M, [[0, 1]], [[1, 0]]).tolist() == [-1.0]
        N = torch.tensor([[0.0, 2.0], [-2.0, 0.0]], dtype=torch.complex128)
        assert complex(ops_pfaffian.batched_pfaffian_gather(N, [[1]], [[0]], 0)[0, 0]) == 2
        # the randomized frontend forced on, through the twins of its kernels
        import os
        os.environ["TEMFPY_TORCH_RSF"] = "1"
        rsf = slater.H_to_MPS(Hc, {"chi_max": 96}, device="cpu")
        fid = abs(rsf.overlap(swap)) / np.sqrt(rsf.norm_squared() * swap.norm_squared())
        assert spectral.rsf_stats()["cuts"] == L and fid > 1 - 1e-10
        # a conversion over a 2-shard CPU mesh, and a checkpoint round trip
        import tempfile
        import temfpy_torch.parallel
        from temfpy_torch.parallel import make_mesh, use_mesh
        with use_mesh(make_mesh(devices=["cpu"] * 2)):
            meshed = slater.H_to_MPS(H, {"chi_max": 16})
        assert max(float((a - b).abs().max()) for a, b in zip(state._B, meshed._B)) <= 1e-12
        with tempfile.TemporaryDirectory() as tmp:
            io.save_mps(tmp + "/state.npz", meshed)
            back = io.load_mps(tmp + "/state.npz", device="cpu")
        assert abs(abs(back.overlap(state)) - 1) < 1e-12
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
