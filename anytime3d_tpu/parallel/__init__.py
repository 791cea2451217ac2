"""Parallelism layer: mesh construction and sharding rules.

The reference's only distribution is single-host MirroredStrategy data
parallelism (SURVEY.md §2.7). Here: a global ``jax.sharding.Mesh`` over
('data', 'model') axes — DP via batch sharding on 'data' (XLA inserts the
gradient psum), TP via parameter sharding of the large decoder /
head kernels on 'model'. Multi-host extends the same mesh across hosts via
``jax.distributed.initialize``.
"""

from anytime3d_tpu.parallel.mesh import (
    make_mesh,
    batch_sharding,
    replicated,
    shard_batch,
    param_sharding_rules,
    shard_params,
)

__all__ = [
    "make_mesh",
    "batch_sharding",
    "replicated",
    "shard_batch",
    "param_sharding_rules",
    "shard_params",
]
