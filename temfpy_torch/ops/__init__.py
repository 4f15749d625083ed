"""Device operations of temfpy_torch: plain PyTorch linear algebra
(:mod:`.linalg`, :mod:`.pfaffian`) and the hand-written CUDA kernels with
their twins (:mod:`.kernels`, built by :mod:`._build`).  The batched entry
points are re-exported here, as in :mod:`temfpy_tpu.ops`."""

from . import linalg, pfaffian  # noqa: F401
from .linalg import (  # noqa: F401
    batched_det_gather,
    batched_det_pairs,
    block_diag_identity_pad,
    block_svd,
    eigh_blocks,
)
from .pfaffian import (  # noqa: F401
    batched_pfaffian,
    batched_pfaffian_gather,
    batched_pfaffian_pairs,
)
