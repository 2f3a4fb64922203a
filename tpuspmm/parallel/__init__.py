"""Distributed SpMM over a jax.sharding.Mesh.

The CUDA reference is strictly single-device (one hard-coded GPU,
reference/src/main.cu:176; no collectives anywhere — SURVEY.md §2.4, §5).
This package is the new-build capability layered on top: sparse operands
row/block-partitioned across devices, dense panels replicated, column-
sharded, or streamed around a ring with compute overlap, and a
least-squares training step demonstrating gradient collectives.
"""

from tpuspmm.parallel.mesh import make_mesh, mesh_devices
from tpuspmm.parallel.shard import (RowShardedPlan, KBucketedTriplets,
                                   StackedBlockPlans, bucket_blockplans)
from tpuspmm.parallel.spmm import (
    spmm_row_sharded,
    spmm_ring,
    spmm_2d,
    spmm_kshard,
)
from tpuspmm.parallel.train import lsq_train_step, make_train_state
from tpuspmm.parallel import multihost

__all__ = [
    "make_mesh",
    "mesh_devices",
    "RowShardedPlan",
    "KBucketedTriplets",
    "StackedBlockPlans",
    "bucket_blockplans",
    "spmm_row_sharded",
    "spmm_ring",
    "spmm_2d",
    "spmm_kshard",
    "lsq_train_step",
    "make_train_state",
    "multihost",
]
