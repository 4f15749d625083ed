"""temfpy_torch: the PyTorch/CUDA port of TeMFpy-TPU.

Converts fermionic mean-field states into matrix product states on an
NVIDIA GPU (or on the CPU, through the plain PyTorch twins of the kernels).
The JAX package :mod:`temfpy_tpu` is the reference this package is held
against; module names match it so each counterpart is easy to find.

This package imports torch, numpy and scipy, and never jax.

Ported so far: the Slater -> finite MPS path (``slater.H_to_MPS`` /
``slater.C_to_MPS``), the BdG/Pfaffian -> finite MPS path
(``pfaffian.H_to_MPS`` / ``pfaffian.C_to_MPS``), the charge-labelled MPS
engine they need (:mod:`temfpy_torch.mps`), and the four hand-written CUDA
kernels of those paths (:mod:`temfpy_torch.ops.kernels`).  The entry points
run on the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

__all__ = [
    "config",
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
