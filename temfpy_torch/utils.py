"""Small generic utilities (API parity with reference ``temfpy/utils.py``;
counterpart of :mod:`temfpy_tpu.utils`).

The degenerate-block SVD completion lives in
:func:`temfpy_torch.ops.linalg.block_svd`.
"""

from __future__ import annotations

import logging

import numpy as np


def HT(M):
    """Hermitian conjugate of a numpy array or torch tensor; for batched
    inputs the trailing two axes are conjugate-transposed
    (reference utils.py:8)."""
    return M.conj().swapaxes(-1, -2)


def n_slice(x: slice) -> int:
    """Number of elements selected by a slice of a very long array
    (reference utils.py:13)."""
    step = x.step or 1
    return (x.stop - x.start) // step


def normalize_SV(lam: np.ndarray, logger: logging.Logger | None = None) -> np.ndarray:
    """Normalises Schmidt values, logging the norm (reference utils.py:99-103)."""
    norm = float(np.linalg.norm(lam))
    if logger is not None:
        logger.info("Norm of Schmidt values: %s", norm)
    return lam / norm
