"""The initial tables, made by the benchmark from the run's seed.

A configuration's `init` lists its tables in the program's order, each as
{"name", "rows", "cols", "low", "high", "cols_drawn"}: `cols_drawn` columns
(all when left out) are uniform in [low, high), the rest zero; "rows" and
"cols" name a dataset or resource key, or are numbers, and "low"/"high"
are numbers or one of the expressions in `_bound`. The tables are drawn on
the device in blocks of BLOCK_ROWS rows from one generator per table, so
that `blocks` can draw the same values again, block by block, for the
reference and for the readings of the program's state, without a second
copy of a table that may be a tenth of the card's memory.
"""
from __future__ import annotations

import math

import torch

BLOCK_ROWS = 1 << 18


def _size(key, cfg):
    if isinstance(key, int):
        return key
    for group in ("dataset", "resource"):
        if key in cfg.get(group, {}):
            return int(cfg[group][key])
    raise KeyError("init size %r is in neither dataset nor resource" % key)


def _bound(expr, cfg):
    """A number, or an expression over dim, margin and pi."""
    if isinstance(expr, (int, float)):
        return float(expr)
    names = {"dim": float(cfg["resource"]["dim"]), "pi": math.pi,
             "margin": float(cfg["train"].get("margin", 0.0))}
    return float(eval(expr, {"__builtins__": {}}, names))


def shapes(cfg):
    """[(name, rows, cols)] of the configuration's tables."""
    return [(t["name"], _size(t["rows"], cfg), _size(t["cols"], cfg))
            for t in cfg["init"]]


def blocks(cfg, index, seed, device):
    """Yield (row0, block float32 [n, cols]) of table `index`, in order."""
    spec = cfg["init"][index]
    rows, cols = _size(spec["rows"], cfg), _size(spec["cols"], cfg)
    drawn = _size(spec.get("cols_drawn", cols), cfg)
    lo, hi = _bound(spec.get("low", 0.0), cfg), _bound(spec.get("high", 0.0),
                                                        cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1000003 + 7919 * (index + 1)) % (1 << 62))
    for r0 in range(0, rows, BLOCK_ROWS):
        n = min(BLOCK_ROWS, rows - r0)
        block = torch.zeros((n, cols), dtype=torch.float32, device=device)
        if drawn and hi > lo:
            u = torch.rand((n, drawn), generator=gen, device=device)
            block[:, :drawn] = u.mul_(hi - lo).add_(lo)
            del u
        yield r0, block


def make(cfg, seed, device, dtype):
    """Every table of the configuration, in `dtype`, on `device`."""
    out = []
    for i, (_, rows, cols) in enumerate(shapes(cfg)):
        t = torch.empty((rows, cols), dtype=dtype, device=device)
        for r0, block in blocks(cfg, i, seed, device):
            t[r0:r0 + block.shape[0]] = block.to(dtype)
        out.append(t)
    return out


def rows_of(cfg, index, seed, ids):
    """Initial float32 rows `ids` (a 1-D int64 tensor) of table `index`."""
    cols = shapes(cfg)[index][2]
    out = torch.empty((ids.numel(), cols), dtype=torch.float32,
                      device=ids.device)
    for r0, block in blocks(cfg, index, seed, ids.device):
        sel = (ids >= r0) & (ids < r0 + block.shape[0])
        out[sel] = block[ids[sel] - r0]
    return out


def distance_sq(cfg, index, seed, table):
    """Squared distance, in float64, between `table` and its initial
    value."""
    total = 0.0
    for r0, block in blocks(cfg, index, seed, table.device):
        diff = table[r0:r0 + block.shape[0]].float() - block
        total += float(diff.square().sum(dtype=torch.float64))
    return total
