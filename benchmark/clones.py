"""Synthetic graphs of published sizes, made from the run's seed.

Frozen copies of chip_smoke.py's generators, so that a later change to the
smoke cannot move the benchmark's inputs:

* `power_law_edges` is `power_law_graph` (chip_smoke.py:448-467) without
  the Graph object: undirected input edges whose endpoints are
  `u ** 2.5 * V` for uniform u, self loops dropped;
* `power_law_kg` is `fill_power_law_kg` (chip_smoke.py:1218-1236) without
  the KnowledgeGraph object: power-law heads and tails, Zipf-skewed
  relations with propensity (r + 3) ** -0.9.

Both return numpy arrays; the job modules under `apps/` hand them to the
program, and the references under `reference/` read the same arrays.
"""
from __future__ import annotations

import numpy as np


def power_law_edges(num_vertex, num_edge, seed):
    """(u, v) int64: the kept undirected input edges (self loops dropped)."""
    rng = np.random.default_rng(seed)
    u = (rng.random(num_edge) ** 2.5 * num_vertex).astype(np.int64)
    v = (rng.random(num_edge) ** 2.5 * num_vertex).astype(np.int64)
    keep = u != v
    return u[keep], v[keep]


def power_law_kg(num_entity, num_relation, num_triplet, seed):
    """(heads, tails, relations) int64, `num_triplet` each."""
    rng = np.random.default_rng(seed)
    heads = (rng.random(num_triplet) ** 2.5 * num_entity).astype(np.int64)
    tails = (rng.random(num_triplet) ** 2.5 * num_entity).astype(np.int64)
    rel_p = (np.arange(num_relation) + 3.0) ** -0.9
    relations = rng.choice(num_relation, num_triplet,
                           p=rel_p / rel_p.sum()).astype(np.int64)
    return heads, tails, relations
