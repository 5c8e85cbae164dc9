"""One DeepWalk step on the walk route (reference/deepwalk.py states the
objective), counted from the model's equations at the batch's own shapes.

Operations: each valid pair scores one dot product and gives two
gradients (3 x 2D); each walk position with a valid pair scores the M
rows of its group's pool, with the same two gradients (3 x 2D x M); each
updated row entry takes its weight decay and its SGD update (2 x 2D).
Bytes: each distinct vertex row and each distinct context row the batch
touches (walk vertices, and for the context table also the pool) is read
once and written once; the walk and pool ids are read once (int64)."""
from __future__ import annotations

import torch


def per_batch(cfg, steps):
    """(operations, bytes) of one batch, averaged over `steps`."""
    D = int(cfg["resource"]["dim"])
    elem = torch.empty((), dtype=getattr(
        torch, cfg["resource"]["float_type"])).element_size()
    ops = nbytes = 0.0
    for s in steps:
        chain, mask, pool = s["chain"], s["mask"] > 0, s["pool"]
        G, M = pool.shape
        pairs = int(mask.sum())
        active = int(mask.any(dim=-1).sum())
        ops += (6 * D * pairs + 6 * D * M * active
                + 4 * D * (2 * chain.numel() + G * M))
        u_vertex = torch.unique(chain).numel()
        u_context = torch.unique(torch.cat([chain.reshape(-1),
                                            pool.reshape(-1)])).numel()
        nbytes += (2 * D * elem * (u_vertex + u_context)
                   + 8 * (chain.numel() + pool.numel()))
    return ops / len(steps), nbytes / len(steps)
