"""Kernel 1 (`scatter_add_`: table[ids[j]] += upd[j], duplicates summed):
the least it must move and compute for one call. Each id is read once,
each float32 update row once, and each distinct row of the table it
touches is read once and written once; one addition per update element.
Ids outside [0, rows) are dropped and touch nothing."""
from __future__ import annotations

import torch


def call_counts(ids, rows, width, elem_bytes):
    """(bytes, operations) of one call."""
    n = ids.numel()
    kept = ids[(ids >= 0) & (ids < rows)]
    touched = int(torch.unique(kept).numel())
    nbytes = (n * ids.element_size() + n * width * 4
              + 2 * touched * width * elem_bytes)
    return nbytes, kept.numel() * width
