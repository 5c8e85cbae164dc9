"""Walker alias tables for O(1) discrete sampling (the port's copy of
graphvite_tpu/ops/alias.py).

Tables are built on the host (native ctypes code, numpy fallback) and
sampled with two uniforms -> gather -> select, the decision rule of the
reference's alias_table.cuh:148-152: on the device, or on the host for
the host samplers (sampler.py).
"""
from __future__ import annotations

import numpy as np
import torch

from graphvite_tpu_torch import native as _native
from graphvite_tpu_torch.utils import tracing


def build_alias(weights: np.ndarray):
    """Build an alias table. Returns (prob, alias) float64/int64 arrays.

    prob[i] is the probability of keeping column i when it is hit by the
    uniform first draw; alias[i] is the donor column otherwise.
    """
    weights = np.ascontiguousarray(weights, dtype=np.float64)
    n = weights.size
    if n == 0:
        return np.zeros(0), np.zeros(0, dtype=np.int64)
    total = weights.sum()
    if not np.isfinite(total) or total <= 0:
        raise ValueError("alias table requires positive finite weights")
    if _native.load() is not None:
        return _native.build_alias(weights)
    return _build_alias_numpy(weights * (n / total))


def _build_alias_numpy(scaled: np.ndarray):
    """Queue-based alias construction (host fallback)."""
    n = scaled.size
    prob = np.ones(n, dtype=np.float64)
    alias = np.arange(n, dtype=np.int64)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    scaled = scaled.copy()
    while small and large:
        s = small.pop()
        l = large.pop()
        prob[s] = scaled[s]
        alias[s] = l
        scaled[l] = scaled[l] - (1.0 - scaled[s])
        if scaled[l] < 1.0:
            small.append(l)
        else:
            large.append(l)
    # leftovers are 1 within float error
    for i in small + large:
        prob[i] = 1.0
    return prob, alias


class AliasTable:
    """Host-built alias table over `weights`, sampled on the device
    (`device_sample`) or, for the host samplers, on the host in numpy."""

    def __init__(self, weights: np.ndarray):
        self.count = int(np.asarray(weights).size)
        with tracing.span(tracing.ALIAS_BUILD) as sp:
            self.prob, self.alias = build_alias(np.asarray(weights))
            if sp is not tracing.OFF:
                sp.set("native", _native.load() is not None)

    def sample(self, rng: np.random.Generator, size) -> np.ndarray:
        u1 = rng.random(size)
        u2 = rng.random(size)
        return self.sample_with(u1, u2)

    def sample_with(self, u1: np.ndarray, u2: np.ndarray) -> np.ndarray:
        idx = (u1 * self.count).astype(np.int64)
        np.clip(idx, 0, self.count - 1, out=idx)
        keep = u2 < self.prob[idx]
        return np.where(keep, idx, self.alias[idx])


class PackedAliasTables:
    """Many small alias tables packed into flat arrays (per-vertex neighbor
    tables for random walks). offsets[i]:offsets[i+1] delimits table i;
    the walk chain samples them on the device, the host walk sampler in
    numpy (`sample`, vectorized across a batch of table ids).
    `uniform_tables` makes uniform tables over the same offsets with no
    alias arrays."""

    def __init__(self, weights_flat: np.ndarray, offsets: np.ndarray,
                 uniform: bool = False):
        self.offsets = np.ascontiguousarray(offsets, dtype=np.int64)
        self.sizes = np.diff(self.offsets)
        self.uniform = uniform
        if uniform:
            self.prob = self.alias = None
            return
        weights_flat = np.ascontiguousarray(weights_flat, dtype=np.float64)
        if _native.load() is not None and weights_flat.size:
            self.prob, self.alias = _native.build_alias_packed(weights_flat, self.offsets)
            return
        prob = np.empty_like(weights_flat)
        alias = np.empty(weights_flat.size, dtype=np.int64)
        for i in range(self.sizes.size):
            lo, hi = self.offsets[i], self.offsets[i + 1]
            if hi > lo:
                p, a = build_alias(weights_flat[lo:hi])
                prob[lo:hi] = p
                alias[lo:hi] = a
        self.prob = prob
        self.alias = alias

    @classmethod
    def uniform_tables(cls, offsets: np.ndarray):
        return cls(np.zeros(0), offsets, uniform=True)

    def sample(self, table_ids: np.ndarray, u1: np.ndarray,
               u2: np.ndarray) -> np.ndarray:
        """The *local* index drawn within each table id."""
        sizes = self.sizes[table_ids]
        idx = (u1 * sizes).astype(np.int64)
        np.clip(idx, 0, np.maximum(sizes - 1, 0), out=idx)
        if self.uniform:
            return idx
        flat = self.offsets[table_ids] + idx
        keep = u2 < self.prob[flat]
        return np.where(keep, idx, self.alias[flat])


def device_alias_arrays(table: AliasTable, dtype=np.float32):
    """(prob, alias) ready for upload as device negative-sampler state.

    When n < 2^24 (int32 survives an f32 round-trip) prob and alias are
    packed into one [n, 2] f32 array, so a sample costs one row gather."""
    n = table.prob.shape[0]
    if 0 < n < (1 << 24):
        packed = np.stack([table.prob.astype(dtype),
                           table.alias.astype(dtype)], axis=1)
        return (packed,)
    return table.prob.astype(dtype), table.alias.astype(np.int32)


def alias_draws(arrays, shape, generator=None, device=None):
    """The two draws of `device_sample` over the alias tensors `arrays`,
    made by the port itself. Over an unpacked (prob, alias) pair, the
    layout of tables of 2^24 entries or more, the column is an integer
    draw over [0, n): a float32 uniform reaches at most 2^24 columns, and
    the reference's float draw (ops/alias.py:154-174 there) misses the
    others as first picks (ROADMAP queue 3). The packed layout (n < 2^24)
    keeps the float draw, which reaches every column. The second draw is
    the alias test's uniform either way."""
    if len(arrays) == 2:
        idx = torch.randint(0, arrays[0].shape[0], shape,
                            generator=generator, device=device)
    else:
        idx = torch.rand(shape, generator=generator, device=device)
    return idx, torch.rand(shape, generator=generator, device=device)


def _first_pick(u1, n):
    """The first-level column: an integer draw as it is, a float uniform
    by the reference's rule min(int(u1 n), n - 1)."""
    if not u1.is_floating_point():
        return u1.long()
    return torch.clamp((u1 * n).long(), max=n - 1)


def device_sample(*args):
    """Sample from device-resident alias tensors.

    Accepts either (packed[n,2], u1, u2) or (prob[n], alias[n], u1, u2);
    u1 / u2 have the sample shape, on the arrays' device: u2 a uniform in
    [0, 1), u1 either a uniform (the reference's draw, column
    min(int(u1 n), n - 1)) or an integer column in [0, n) (`alias_draws`).
    Returns int64 ids (the reference returns int32; the values are
    equal)."""
    if len(args) == 3:
        packed, u1, u2 = args
        idx = _first_pick(u1, packed.shape[0])
        rows = packed[idx]                       # one gather of [.., 2]
        keep = u2 < rows[..., 0]
        return torch.where(keep, idx, rows[..., 1].long())
    prob, alias, u1, u2 = args
    idx = _first_pick(u1, prob.shape[0])
    keep = u2 < prob[idx]
    return torch.where(keep, idx, alias[idx].long())
