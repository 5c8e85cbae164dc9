"""One round of LINE on the walks engine (reference/line.py states the
objective), counted from the model's equations at the round's own shapes,
per worker-batch: the round's counts over its W worker-batches, since
the job counts worker-batches.

Operations: each trained pair scores one dot product and gives two
gradients (3 x 2D); each walk position with a trained pair scores the M
rows of its group's pool, with the same two gradients (3 x 2D x M); each
updated row entry takes its weight decay and its SGD update (2 x 2D).
Bytes: each distinct vertex row and each distinct context row the round
touches over all workers (walk vertices, and for the context table also
the pools) is read once and written once at its owner; the walk and pool
ids are read once (int64)."""
from __future__ import annotations

import torch


def per_batch(cfg, steps):
    """(operations, bytes) of one worker-batch, averaged over the rounds
    `steps` (the job's round records)."""
    D = int(cfg["resource"]["dim"])
    elem = torch.empty((), dtype=getattr(
        torch, cfg["resource"]["float_type"])).element_size()
    ops = nbytes = 0.0
    batches = 0
    for rec in steps:
        chains, pools = rec["chains"], rec["pools"]
        for chain, mask, pool in zip(chains, rec["masks"], pools):
            mask = mask > 0
            G, M = pool.shape
            pairs = int(mask.sum())
            active = int(mask.any(dim=-1).sum())
            ops += (6 * D * pairs + 6 * D * M * active
                    + 4 * D * (2 * chain.numel() + G * M))
            nbytes += 8 * (chain.numel() + pool.numel())
            batches += 1
        u_vertex = torch.unique(torch.cat([c.reshape(-1)
                                           for c in chains])).numel()
        u_context = torch.unique(torch.cat(
            [c.reshape(-1) for c in chains]
            + [p.reshape(-1) for p in pools])).numel()
        nbytes += 2 * D * elem * (u_vertex + u_context)
    return ops / batches, nbytes / batches
