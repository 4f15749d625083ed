"""Several shards for one conversion (counterpart of :mod:`temfpy_tpu.parallel`).

One process drives a grid of torch devices (:class:`~.mesh.Mesh`: distinct
cards, or logical shards of one card or of the CPU).  Under
:class:`~.mesh.use_mesh` the conversions split their independent batches:

- the per-cut block eigendecompositions over the "cuts" axis;
- the per-site overlap batches and the per-pair determinant and Pfaffian
  batches of the tensor fill over the "pairs" axis;
- large site tensors' bond rows over the shards, so no device holds the
  whole chain (:func:`~.mesh.bond_shard_put`).
"""

from .mesh import (  # noqa: F401
    Mesh,
    active_mesh,
    bond_shard_put,
    flagship_forward,
    gather_replicated,
    make_mesh,
    multichip_conversion_step,
    replicate,
    shard_batch,
    sharded_det_pairs,
    sharded_schmidt_spectra,
    use_mesh,
)
