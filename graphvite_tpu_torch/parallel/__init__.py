"""Vertex partitions, the worker group and the multi-device engines (the
port of graphvite_tpu/parallel/).

The reference scales by staging (head partition x tail partition) blocks
of the embedding tables under an orthogonal episode schedule
(include/core/solver.h:519-575, 873-887). On one card the port trains one
such block per episode (ops/blocked.py and GraphSolver's blocked loop).
Over W workers (`DeviceGroup`: a device, stream and generator per
worker, in one process or, with GRAPHVITE_COORDINATOR, over several) `ShardedGraphTrainer` keeps partition p's vertex
shard on worker p and rotates the context shards around the ring (edges
mode), or fetches and updates rows on their owners (banded walks);
`ReplicatedEdgeTrainer` trains LargeVis replicas and merges their deltas.
For knowledge graphs (parallel/kg.py) `ShardedKGTrainer` holds two of 2W
entity partitions per worker under a tournament rotation, and
`ReplicatedKGTrainer` trains replicas and sums their deltas.
"""
from graphvite_tpu_torch.parallel.mesh import (BlockEdgeTables, DeviceGroup,
                                               ReplicatedEdgeTrainer,
                                               ShardedGraphTrainer,
                                               VertexPartition,
                                               make_sharded_graph_step)
from graphvite_tpu_torch.parallel.kg import (ReplicatedKGTrainer,
                                             ShardedKGTrainer)

__all__ = ["BlockEdgeTables", "DeviceGroup", "ReplicatedEdgeTrainer",
           "ReplicatedKGTrainer", "ShardedGraphTrainer", "ShardedKGTrainer",
           "VertexPartition", "make_sharded_graph_step"]
