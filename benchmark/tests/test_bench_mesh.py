"""What the walks engine's cell adds: its clone made in chunks gives the
edges of clones.power_law_edges, and its round counts by hand."""
import numpy as np
import pytest
import torch

from benchmark import clones
from benchmark.apps import graph_mesh
from benchmark.counts import line


@pytest.mark.parametrize("seed", [3_000_000_017, 5, 2**33 + 7])
def test_chunked_clone_is_the_clone(seed, monkeypatch):
    monkeypatch.setattr(graph_mesh, "CLONE_CHUNK", 1000)
    want = clones.power_law_edges(5000, 25000, seed)
    got = graph_mesh.power_law_edges(5000, 25000, seed)
    assert got[0].dtype == np.int32
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)


def test_line_round_counts_by_hand():
    # two workers, each one walk of 3 vertices, offsets +-1, pool G 1 M 2
    mask = torch.zeros((1, 3, 2))
    mask[0, 0, 0] = mask[0, 1, 0] = 1           # forward pairs
    mask[0, 1, 1] = mask[0, 2, 1] = 1           # backward pairs
    rec = {"chains": [torch.tensor([[3, 5, 3]]), torch.tensor([[4, 5, 6]])],
           "masks": [mask, mask], "pools": [torch.tensor([[5, 8]]),
                                            torch.tensor([[9, 8]])]}
    cfg = {"resource": {"dim": 4, "float_type": "float32"}}
    ops, nbytes = line.per_batch(cfg, [rec])
    D, M, pairs, active = 4, 2, 4, 3
    assert ops == 6 * D * pairs + 6 * D * M * active + 4 * D * (2 * 3 + 2)
    # vertex rows {3, 4, 5, 6}, context rows {3, 4, 5, 6, 8, 9}, over
    # the round's two worker-batches; ids 5 a worker-batch
    assert nbytes == (2 * D * 4 * (4 + 6)) / 2 + 8 * 5
