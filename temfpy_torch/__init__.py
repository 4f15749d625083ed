"""temfpy_torch: the PyTorch/CUDA port of TeMFpy-TPU.

Converts fermionic mean-field states into matrix product states on an
NVIDIA GPU (or on the CPU, through the plain PyTorch twins of the kernels).
The JAX package :mod:`temfpy_tpu` is the reference this package is held
against; module names match it so each counterpart is easy to find.

This package imports torch, numpy and scipy, and never jax.

Ported so far:

- the Slater -> finite MPS path (``slater.H_to_MPS`` / ``slater.C_to_MPS``)
  with its three spectral frontends (the exact batched eigh, the
  Fishman-White sweep :mod:`temfpy_torch.ops.fw` and the randomized
  frontend :mod:`temfpy_torch.ops.spectral`) and its two tensor fills (the
  direct determinant fill and the rank-update fill);
- the BdG/Pfaffian -> finite MPS path (``pfaffian.H_to_MPS`` /
  ``pfaffian.C_to_MPS``);
- iMPS unit cells from two chains that differ by one cell
  (``slater.H_to_iMPS`` / ``C_to_iMPS``, ``pfaffian.H_to_iMPS`` /
  ``C_to_iMPS``, and :func:`temfpy_torch.iMPS.MPS_to_iMPS` from two finite
  MPS);
- Gutzwiller projection of finite and infinite Abrikosov-fermion MPS to
  spin-1/2 (:mod:`temfpy_torch.gutzwiller`);
- the charge-labelled MPS engine they need, finite and infinite chains
  (:mod:`temfpy_torch.mps`);
- the hand-written CUDA kernels of those paths, 13 sources under
  ``temfpy_torch/csrc/`` built with nvcc at first use, each behind a
  wrapper in :mod:`temfpy_torch.ops.kernels` beside its plain PyTorch twin.

The entry points run on the card unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"

__all__ = [
    "config",
    "gutzwiller",
    "iMPS",
    "mps",
    "ops",
    "pfaffian",
    "profiling",
    "schmidt_utils",
    "slater",
    "testing",
    "utils",
]


def __getattr__(name):
    """Lazy submodule access (``temfpy_torch.slater`` etc.)."""
    if name in __all__:
        import importlib

        module = importlib.import_module(f"temfpy_torch.{name}")
        globals()[name] = module
        return module
    raise AttributeError(f"module '{__name__}' has no attribute '{name}'")
