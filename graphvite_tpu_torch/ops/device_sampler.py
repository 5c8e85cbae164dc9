"""On-device positive samples (the port of the edge sampler and the
first-order walk parts of graphvite_tpu/ops/device_sampler.py).

Edges (augmentation_step 1): `DeviceEdgeSampler` draws each batch's
positive edges on the device, from a host-shuffled stream of 1024-edge
chunks (optionally sorted by head id), uniformly, or by edge weight.

Walks: walks start from alias-sampled edges and step through per-vertex
alias tables over out-edge weights; they truncate at dead ends (the
reference's graph.cuh:376-450 semantics). The banded emitter hands whole
walks to the step with one pair-validity mask per (position, offset).

Random draws: the sample and chain functions take their random numbers as
optional inputs (`draws`), so a test can feed them the JAX reference's own
draws and get the same samples; otherwise they draw from an explicit
`torch.Generator` on the arrays' device.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from graphvite_tpu_torch.ops.alias import (AliasTable, PackedAliasTables,
                                           device_alias_arrays,
                                           device_sample)


@dataclasses.dataclass
class DeviceEdgeSampler:
    """Positive edges on the device, in one of four modes:

    * streamed (unweighted graphs with at least MIN_STREAM_BLOCKS chunks of
      edges): the packed [E, 2] (head, tail) array ([E, 3] with the
      relation, for knowledge graphs) is shuffled on the host
      once, padded with re-drawn edges to whole STREAM_CHUNK blocks, and
      each batch gathers ceil(B / 1024) random whole blocks;
    * sorted stream (`sort_stream`, or GRAPHVITE_SORTED_STREAM=1): the
      shuffled stream is also stable-sorted by head id, so sorting the
      drawn block ids gives a batch whose heads ascend (the copies of a
      block drawn more than once are interleaved to keep it so); where B
      is not a multiple of 1024, the batch is rotated by a uniform offset
      before truncation, so truncation drops every row with equal
      probability, and leaves two ascending runs;
    * uniform random edges (unweighted, too few edges to stream);
    * alias-weighted edges (weighted graphs).

    The host shuffle uses the reference's np.random.default_rng(0x5eed ^
    num_edge), so the stream is the reference's, bit for bit."""

    STREAM_CHUNK = 1024
    MIN_STREAM_BLOCKS = 64   # enough blocks for batch diversity

    edges: torch.Tensor      # [E, 2|3] int32, or [nblocks, C, 2|3] streamed
    alias_arrays: tuple      # () uniform | (packed,) | (prob, alias)
    num_edge: int
    uniform: bool
    with_rel: bool = False
    streamed: bool = False
    sorted_stream: bool = False

    @classmethod
    def build(cls, graph, with_relation=False, sort_stream=None,
              device="cpu"):
        w = graph.edge_weights
        w = w.cpu().numpy() if torch.is_tensor(w) else np.asarray(w)
        uniform = bool(w.size == 0 or np.all(w == w[0]))
        alias_arrays = () if uniform else device_alias_arrays(AliasTable(w))
        del w
        cols = [graph.edge_heads, graph.edge_tails]
        if with_relation:
            cols.append(graph.edge_relations)
        n_edge = int(cols[0].shape[0])
        C = cls.STREAM_CHUNK
        streamed = uniform and n_edge >= C * cls.MIN_STREAM_BLOCKS
        if all(torch.is_tensor(c) for c in cols) and not streamed:
            # device edge arrays (KNNGraph) stay on the device
            return cls(
                edges=torch.stack([c.to(device=device, dtype=torch.int32)
                                   for c in cols], dim=1),
                alias_arrays=tuple(torch.as_tensor(a, device=device)
                                   for a in alias_arrays),
                num_edge=n_edge, uniform=uniform,
                with_rel=bool(with_relation))
        packed = np.stack([c.cpu().numpy().astype(np.int32)
                           if torch.is_tensor(c) else np.asarray(c, np.int32)
                           for c in cols], axis=1)
        if sort_stream is None:
            sort_stream = os.environ.get("GRAPHVITE_SORTED_STREAM",
                                         "0") != "0"
        sorted_stream = bool(streamed and sort_stream)
        if streamed:
            rng = np.random.default_rng(0x5eed ^ n_edge)
            packed = packed[rng.permutation(n_edge)]
            pad = (-n_edge) % C
            if pad:
                # re-drawn edges; their ~C/E over-weight is negligible
                packed = np.concatenate(
                    [packed, packed[rng.integers(0, n_edge, pad)]])
            if sorted_stream:
                # stable: within a head, the shuffled order stays
                packed = packed[np.argsort(packed[:, 0], kind="stable")]
            packed = packed.reshape(-1, C, packed.shape[1])
        return cls(
            edges=torch.as_tensor(packed, device=device),
            alias_arrays=tuple(torch.as_tensor(a, device=device)
                               for a in alias_arrays),
            num_edge=n_edge, uniform=uniform, with_rel=bool(with_relation),
            streamed=streamed, sorted_stream=sorted_stream)

    def arrays(self):
        return (self.edges,) + self.alias_arrays

    def make_sample_fn(self, batch_size: int):
        """fn(edges, *alias_arrays, generator=None, draws=None) -> (heads
        [B] int32, tails [B] int32, mask [B] float32 ones), with the
        relations [B] int32 before the mask when built `with_relation`.
        `draws` replaces the generator's numbers: (block ids
        [ceil(B/1024)], roll shift or None) when streamed, edge ids [B]
        when uniform, (u1, u2) [B] when weighted."""
        B = int(batch_size)
        C = self.STREAM_CHUNK
        streamed, sorted_stream = self.streamed, self.sorted_stream
        uniform, n_edge = self.uniform, self.num_edge
        with_rel = self.with_rel

        def sample(edges, *alias_arrays, generator=None, draws=None):
            dev = edges.device
            if streamed:
                nb = -(-B // C)
                roll = sorted_stream and B % C
                if draws is None:
                    bid = torch.randint(0, edges.shape[0], (nb,),
                                        generator=generator, device=dev)
                    shift = (torch.randint(0, nb * C, (), generator=generator,
                                           device=dev) if roll else None)
                else:
                    bid, shift = draws
                if sorted_stream:
                    # blocks are disjoint slices of a head-sorted array:
                    # block-id order is head order
                    bid = torch.sort(bid).values
                row = edges[bid].reshape(nb * C, -1)
                if sorted_stream:
                    row = _interleave_repeats(row, bid, C)
                if roll:
                    idx = (torch.arange(nb * C, device=dev) + shift) % (nb * C)
                    row = row[idx]
                row = row[:B]
            elif uniform:
                eid = draws if draws is not None else torch.randint(
                    0, n_edge, (B,), generator=generator, device=dev)
                row = edges[eid]
            else:
                if draws is None:
                    draws = (torch.rand(B, generator=generator, device=dev),
                             torch.rand(B, generator=generator, device=dev))
                row = edges[device_sample(*alias_arrays, *draws)]
            cols = row.t().contiguous()
            mask = torch.ones(B, dtype=torch.float32, device=dev)
            if with_rel:
                return cols[0], cols[1], cols[2], mask
            return cols[0], cols[1], mask

        return sample


def _interleave_repeats(row, bid, C):
    """Rows [nb * C, 2] of the ascending block ids `bid`, reordered so that
    a block drawn k times contributes each of its rows k times in a row:
    the batch then ascends by head even when a block repeats (the
    reference concatenates the copies, which leaves its batch unsorted; at
    97 draws of 44k blocks about one batch in ten repeats a block). The
    identity when no block repeats. Runs on the device, no host sync."""
    nb = bid.shape[0]
    first = torch.searchsorted(bid, bid)
    mult = torch.searchsorted(bid, bid, right=True) - first
    rank = torch.arange(nb, device=bid.device) - first
    col = torch.arange(C, device=bid.device)
    dest = (first * C + rank)[:, None] + col[None, :] * mult[:, None]
    out = torch.empty_like(row)
    out[dest.reshape(-1)] = row
    return out


def _alias_pick(prob, alias, u1, u2):
    """Walker alias decision on device tensors."""
    n = prob.shape[0]
    idx = torch.clamp((u1 * n).long(), max=n - 1)
    return torch.where(u2 < prob[idx], idx, alias[idx].long())


def make_walk_chain_fn(uniform, walk_length, num_walk):
    """First-order walk generator.

    Returned fn(edge_prob, edge_alias, heads, tails, vdeg, indices,
    nbr_prob, nbr_alias, *, generator=None, draws=None) -> (chain [L+1, W]
    int64, valid [L+1, W] bool), where vdeg is the packed [V, 2] (CSR row
    start, degree) array and valid[j] means all steps up to position j
    were alive. `draws` = (u1 [W], u2 [W], w1s [L-1, W], w2s [L-1, W])
    replaces the generator's uniforms: start-edge draws and per-step
    neighbor draws, in the reference's order."""
    L, W = int(walk_length), int(num_walk)

    def step_neighbor(vdeg, indices, nbr_prob, nbr_alias, v, u1, u2):
        row = vdeg[v]
        start = row[..., 0].long()
        deg = row[..., 1]
        alive = deg > 0
        safe_deg = torch.clamp(deg, min=1)
        idx = torch.minimum((u1 * safe_deg).long(), (safe_deg - 1).long())
        # a dead vertex's row start may be the end of `indices`: clamp the
        # gathers (their result is discarded for dead lanes)
        last = indices.shape[0] - 1
        flat = torch.clamp(start + idx, max=last)
        if not uniform:
            local = torch.where(u2 < nbr_prob[flat], idx,
                                nbr_alias[flat].long())
            flat = torch.clamp(start + local, max=last)
        nxt = indices[flat].long()
        return torch.where(alive, nxt, v), alive

    def chain_fn(edge_prob, edge_alias, heads, tails, vdeg, indices,
                 nbr_prob, nbr_alias, *, generator=None, draws=None):
        if draws is None:
            dev = heads.device

            def rand(*shape):
                return torch.rand(shape, generator=generator, device=dev)

            draws = (rand(W), rand(W), rand(L - 1, W), rand(L - 1, W))
        u1, u2, w1s, w2s = draws
        eid = _alias_pick(edge_prob, edge_alias, u1, u2)
        v0 = heads[eid].long()
        v1 = tails[eid].long()
        steps, alives = [], []
        v = v1
        alive = torch.ones_like(v1, dtype=torch.bool)
        for i in range(L - 1):
            nxt, step_alive = step_neighbor(vdeg, indices, nbr_prob,
                                            nbr_alias, v, w1s[i], w2s[i])
            alive = alive & step_alive
            v = torch.where(alive, nxt, v)
            steps.append(v)
            alives.append(alive)
        chain = torch.stack([v0, v1] + steps)
        alive_all = torch.stack(
            [torch.ones_like(alive), torch.ones_like(alive)] + alives)
        # cumulative validity: position j valid iff all steps up to j alive
        valid = torch.cumprod(alive_all.int(), dim=0) > 0
        return chain, valid

    return chain_fn


def walk_offsets(aug, bidir=False):
    """Augmentation tail offsets shared by the banded emitter and the
    banded step (order is part of the contract: pmask[..., t] refers to
    offsets[t])."""
    offs = list(range(1, aug + 1))
    if bidir:
        offs += [-k for k in range(1, aug + 1)]
    return offs


def emit_walk_banded(chain, valid, aug, bidir=False):
    """Banded emission: whole walks, one pair-validity mask per (position,
    offset). Returns (chainT [W, L+1], pmask [W, L+1, T] float32):
    pmask[w, i, t] flags pair (chain[i], chain[i + offsets[t]])."""
    L1, W = chain.shape
    zeros = torch.zeros((L1, W), dtype=torch.bool, device=chain.device)
    ms = []
    for k in walk_offsets(aug, bidir):
        m = zeros.clone()
        if k > 0:
            m[: L1 - k] = valid[k:] & valid[: L1 - k]
        else:
            m[-k:] = valid[:k] & valid[-k:]
        ms.append(m)
    pmask = torch.stack(ms, dim=-1).transpose(0, 1)          # [W, L1, T]
    return chain.t().contiguous(), pmask.float().contiguous()


@dataclasses.dataclass
class DeviceWalkSampler:
    """Random-walk augmented pairs in banded layout, generated on device.

    One batch: W whole walks of length L from alias-sampled start edges,
    W = batch_size / (T * (L+1)) with T = aug (2 * aug with `bidir`)."""

    edge_prob: torch.Tensor     # [E] f32   (walk start edges)
    edge_alias: torch.Tensor    # [E] i32
    heads: torch.Tensor         # [E] i32
    tails: torch.Tensor         # [E] i32
    vdeg: torch.Tensor          # [V, 2] i32: packed (CSR row start, degree)
    indices: torch.Tensor       # [Ed] i32
    nbr_prob: torch.Tensor      # [Ed] f32  per-vertex packed alias (or empty)
    nbr_alias: torch.Tensor     # [Ed] i32
    uniform: bool
    walk_length: int
    augmentation_step: int
    batch_size: int
    num_walk: int
    bidir: bool = False
    num_tail: int = 0

    @classmethod
    def build(cls, graph, augmentation_step, walk_length, batch_size,
              bidir=False, device="cpu"):
        """First-order walks in the banded layout (node2vec's biased walks
        and the pair/multitail layouts are ROADMAP queue 1, item 11)."""
        t = AliasTable(graph.edge_weights)
        w = np.asarray(graph.csr_weights, np.float64)
        uniform = bool(w.size == 0 or np.all(w == w[0]))
        if uniform:
            nbr_prob = np.zeros(0, np.float32)
            nbr_alias = np.zeros(0, np.int32)
        else:
            packed = PackedAliasTables(w, graph.indptr)
            nbr_prob = packed.prob.astype(np.float32)
            nbr_alias = packed.alias.astype(np.int32)
        L, aug = int(walk_length), int(augmentation_step)
        T = aug * (2 if bidir else 1)
        slot_unit = T * (L + 1)
        if batch_size % slot_unit:
            raise ValueError(
                "batch_size %d must be a multiple of the per-walk slot "
                "count %d (= tails %d x positions %d)"
                % (batch_size, slot_unit, T, L + 1))
        num_walk = max(batch_size // slot_unit, 1)

        def up(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=device)

        return cls(
            edge_prob=up(t.prob, torch.float32),
            edge_alias=up(t.alias, torch.int32),
            heads=up(graph.edge_heads, torch.int32),
            tails=up(graph.edge_tails, torch.int32),
            vdeg=up(np.stack([graph.indptr[:-1], np.diff(graph.indptr)],
                             axis=1), torch.int32),
            indices=up(graph.indices, torch.int32),
            nbr_prob=up(nbr_prob, torch.float32),
            nbr_alias=up(nbr_alias, torch.int32),
            uniform=uniform,
            walk_length=L, augmentation_step=aug,
            batch_size=int(batch_size), num_walk=num_walk,
            bidir=bool(bidir), num_tail=T)

    def arrays(self):
        return (self.edge_prob, self.edge_alias, self.heads, self.tails,
                self.vdeg, self.indices, self.nbr_prob, self.nbr_alias)

    def make_sample_fn(self, batch_size: int):
        """fn(*arrays, generator=None, draws=None) -> (chainT [W, L1],
        chainT, pmask [W, L1, T]): the banded step reads the ids once for
        both roles; mean(pmask) is the valid-pair fraction."""
        if batch_size != self.batch_size:
            raise ValueError("sampler was built for batch_size %d, not %d"
                             % (self.batch_size, batch_size))
        aug = self.augmentation_step
        bidir = self.bidir
        chain_fn = make_walk_chain_fn(self.uniform, self.walk_length,
                                      self.num_walk)

        def sample(*arrays, generator=None, draws=None):
            chain, valid = chain_fn(*arrays, generator=generator,
                                    draws=draws)
            ct, pm = emit_walk_banded(chain, valid, aug, bidir=bidir)
            return ct, ct, pm

        return sample

