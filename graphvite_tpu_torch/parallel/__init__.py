"""Vertex partitions and the per-block step (the port of the parts of
graphvite_tpu/parallel/ that single-card blocked training uses).

The reference scales by staging (head partition x tail partition) blocks
of the embedding tables between host memory and the device under an
episode schedule (include/core/solver.h:519-575, 873-887). On one card the
port trains one such block per episode (ops/blocked.py, and
GraphSolver's blocked loop): `VertexPartition` deals the vertices into P
degree-balanced buckets with partition-local ids, and
`make_sharded_graph_step` trains one batch of a block on the resident
(head, tail) shard pair with negatives from the tail partition. The
multi-device engines are a later slice.
"""
from graphvite_tpu_torch.parallel.mesh import (VertexPartition,
                                               make_sharded_graph_step)

__all__ = ["VertexPartition", "make_sharded_graph_step"]
