"""One RotatE step with shared candidate pools (reference/rotate.py states
the objective), counted from the model's equations at the batch's own
shapes, per complex dimension (dim / 2 of them).

Operations: each scored pair, the positive and the M candidates of each
triplet, takes the difference of two complex numbers (2), its squared
magnitude (3), a root (1) and the sum over dimensions (1), then the
gradient scale (1), both gradient components (2) and their accumulation
into the two rows it touches (4): 14. Each triplet rotates its head and
its tail frame once and rotates its two accumulated gradients back, and
takes its phase gradient: 20. Each updated row entry takes its SGD
update (2 per real element). Bytes: each distinct entity and relation row
the batch touches is read once and written once; the ids are read once
(int64)."""
from __future__ import annotations

import torch


def per_batch(cfg, steps):
    """(operations, bytes) of one batch, averaged over `steps`."""
    D = int(cfg["resource"]["dim"])
    elem = torch.empty((), dtype=getattr(
        torch, cfg["resource"]["float_type"])).element_size()
    ops = nbytes = 0.0
    for s in steps:
        B = s["heads"].numel()
        G, M = s["negatives"].shape
        ops += (D // 2) * (14 * B * (M + 1) + 20 * B) + 2 * D * (
            3 * B + G * M)
        u_ent = torch.unique(torch.cat([s["heads"].reshape(-1),
                                        s["tails"].reshape(-1),
                                        s["negatives"].reshape(-1)])).numel()
        u_rel = torch.unique(s["rels"]).numel()
        nbytes += 2 * D * elem * (u_ent + u_rel) + 8 * (3 * B + G * M)
    return ops / len(steps), nbytes / len(steps)
