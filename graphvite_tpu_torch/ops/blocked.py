"""Block-partitioned single-card training (the port of
graphvite_tpu/ops/blocked.py).

Vertices are zigzag-partitioned into P buckets (solver.h:873-887,
parallel/mesh.py:VertexPartition) and every episode trains ONE (head
partition, tail partition) block on the resident shard pair, so the table
updates touch [cap, D] shards instead of [V, D] tables and, with the
solver's host master, only two shards need to be on the card at a time:
tables larger than the card become trainable.

Sampling follows the reference's two-level factorization (the sample
pools of solver.h:417-462): a block is drawn in proportion to its total
edge weight, then edges within it by weight (alias tables per block), and
negatives come from the resident tail partition's degree^0.75 alias table
(solver.h:1264-1278).

One divergence from the reference: the reference picks the first-level
edge of a block as lo + min(int(u * n), n - 1) from a float32 uniform,
which has 2^23 values, so a block of more than 2^23 edges has edges that
are never picked first (on an unweighted graph, never picked at all). The
runners here draw that index as an integer over [0, n); the float draw
remains for the alias test. Both runners take their draws as an optional
input, so tests can feed in the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from graphvite_tpu_torch.ops.alias import AliasTable
from graphvite_tpu_torch.optim import Optimizer


def choose_num_partition(num_vertex: int, dim: int,
                         target_block_bytes: int = 32 << 20) -> int:
    """Smallest power of two P with a block (cap x D f32) under the target."""
    p = 1
    while (num_vertex // p + 1) * dim * 4 > target_block_bytes and p < 256:
        p *= 2
    return p


class FlatBlockTables:
    """All P^2 block edge tables packed flat.

    offsets[b], offsets[b+1] delimit block b = i * P + j; heads/tails are
    partition-LOCAL ids; block_prob/block_alias is the P^2-way alias table
    over total block weights for the first-level draw. Host numpy,
    bit-equal to the reference's."""

    def __init__(self, graph, partition):
        P_ = partition.num_partition
        hp = partition.part_of[graph.edge_heads]
        tp = partition.part_of[graph.edge_tails]
        lh = partition.local_of[graph.edge_heads]
        lt = partition.local_of[graph.edge_tails]
        w = np.asarray(graph.edge_weights, np.float64)
        blk = hp.astype(np.int64) * P_ + tp
        order = np.argsort(blk, kind="stable")
        blk, lh, lt, w = blk[order], lh[order], lt[order], w[order]
        counts = np.bincount(blk, minlength=P_ * P_)
        offsets = np.zeros(P_ * P_ + 1, np.int64)
        np.cumsum(counts, out=offsets[1:])
        prob = np.empty(w.size, np.float32)
        alias = np.empty(w.size, np.int32)
        block_w = np.zeros(P_ * P_, np.float64)
        for b in range(P_ * P_):
            lo, hi = offsets[b], offsets[b + 1]
            if hi > lo:
                t = AliasTable(w[lo:hi])
                prob[lo:hi] = t.prob
                alias[lo:hi] = t.alias
                block_w[b] = w[lo:hi].sum()
        # zero-weight blocks keep ~0 probability mass (1e-300)
        bt = AliasTable(np.maximum(block_w, 1e-300)
                        if block_w.sum() > 0 else np.ones_like(block_w))
        self.prob = prob
        self.alias = alias
        self.heads = lh.astype(np.int32)
        self.tails = lt.astype(np.int32)
        self.offsets = offsets.astype(np.int32)
        self.block_prob = bt.prob.astype(np.float32)
        self.block_alias = bt.alias.astype(np.int32)

    def edge_tensors(self, device):
        """(prob, alias, heads, tails) on `device`: what the episode
        runner reads."""
        return tuple(torch.from_numpy(a).to(device)
                     for a in (self.prob, self.alias, self.heads, self.tails))

    def device_arrays(self, device):
        """Every array on `device`, in make_blocked_runner's order."""
        return tuple(torch.from_numpy(a).to(device) for a in
                     (self.prob, self.alias, self.heads, self.tails,
                      self.offsets, self.block_prob, self.block_alias))


def _pick_edges(lo, idx, u, eprob, ealias, eheads, etails):
    """Local (heads, tails) of the edges at in-block indices `idx` of the
    block starting at `lo`, after the alias test with uniforms `u`. The
    edge index is clamped into the arrays, as a JAX gather clamps it (a
    block of no edges has its mask 0)."""
    pos = (idx + lo).clamp_(max=eprob.shape[0] - 1)
    eid = torch.where(u < eprob[pos], pos, ealias[pos].long() + lo)
    return eheads[eid], etails[eid]


def make_block_episode_runner(step_fn, opt: Optimizer, batch_size: int,
                              ep_batches: int):
    """One call = one episode on ONE (head, tail) block, the block entering
    only through the arrays passed in (its edge range and the resident
    shards): the reference's episode residency (solver.h:588-654) with the
    shards on the card. An eager loop, like ops/steps.py:make_fused_runner;
    the losses stay on the device.

    step_fn: make_sharded_graph_step's step over partition-LOCAL ids.

    run(local, lo, n_blk, batch_id0, num_batch_total, generator, eprob,
        ealias, eheads, etails, nprob, nalias, nsize, draws=None)
      -> (local, losses [ep_batches])
    where (eprob, ealias, eheads, etails) are FlatBlockTables' flat arrays
    on the device, [lo, lo + n_blk) the block's edge range (ints) and
    (nprob, nalias, nsize) the tail partition's negative sampler. `draws`:
    one tuple per batch of (idx [B] int64 in-block edge indices in
    [0, n_blk), u [B] alias uniforms, u1 [B, K], u2 [B, K] negative
    uniforms); otherwise the indices come from torch.randint and the
    uniforms from torch.rand on `generator`."""
    B = int(batch_size)
    EP = int(ep_batches)

    def run(local, lo, n_blk, batch_id0, num_batch_total, generator,
            eprob, ealias, eheads, etails, nprob, nalias, nsize,
            draws=None):
        lo, n_blk = int(lo), int(n_blk)
        dev = eprob.device
        mask = torch.full((B,), 1.0 if n_blk > 0 else 0.0, device=dev)
        losses = []
        with torch.no_grad():
            for it in range(EP):
                lr = opt.schedule_lr(batch_id0 + it, num_batch_total)
                if draws is None:
                    idx = torch.randint(0, max(n_blk, 1), (B,),
                                        generator=generator, device=dev)
                    u = torch.rand((B,), generator=generator, device=dev)
                    neg_draws = None
                else:
                    idx, u, *neg_draws = draws[it]
                h, t = _pick_edges(lo, idx, u, eprob, ealias, eheads,
                                   etails)
                local, loss = step_fn(local, (h, t, mask), lr, nprob,
                                      nalias, nsize, generator=generator,
                                      draws=neg_draws or None)
                losses.append(loss)
        return local, torch.stack(losses)

    return run


def make_blocked_runner(step_fn, opt: Optimizer, num_partition: int,
                        batch_size: int, ep_batches: int):
    """Episode runner over a [P, cap, D] arena with the two-level draw on
    the device: each batch draws its block from the P^2-way block alias
    table, slices the block's shards out of the arena, trains them and
    writes them back. GraphSolver trains with make_block_episode_runner;
    this runner is the reference's other form, kept with its exactness
    test.

    run(arena, batch_id0, num_batch_total, generator, block_arrays,
        neg_arrays, draws=None) -> (arena, losses [ep_batches])
      arena: {"tables": (vertex [P, cap, D], context [P, cap, D]),
              "moments": ((...), (...)) same leading layout}, in place
      block_arrays: FlatBlockTables.device_arrays()
      neg_arrays: (prob [P, cap], alias [P, cap], sizes [P])
      draws: one tuple per batch of (ub [2] block uniforms, idx [B] int64
        in-block edge indices, u [B], u1 [B, K], u2 [B, K]); otherwise
        drawn from `generator`, the in-block index as an integer (a 62-bit
        draw modulo the block's edge count, on the device)."""
    P_ = int(num_partition)
    B = int(batch_size)
    EP = int(ep_batches)

    def run(arena, batch_id0, num_batch_total, generator, block_arrays,
            neg_arrays, draws=None):
        (eprob, ealias, eheads, etails, offsets, bprob, balias) = block_arrays
        nprob, nalias, nsizes = neg_arrays
        dev = eprob.device
        vertex, context = arena["tables"]
        v_moms, c_moms = arena["moments"]
        losses = []
        with torch.no_grad():
            for it in range(EP):
                lr = opt.schedule_lr(batch_id0 + it, num_batch_total)
                if draws is None:
                    ub = torch.rand((2,), generator=generator, device=dev)
                    raw = torch.randint(0, 1 << 62, (B,),
                                        generator=generator, device=dev)
                    u = torch.rand((B,), generator=generator, device=dev)
                    neg_draws = None
                else:
                    ub, idx, u, *neg_draws = draws[it]
                # level 1: block ~ total block weight
                bidx = torch.clamp((ub[:1] * (P_ * P_)).long(),
                                   max=P_ * P_ - 1)
                blk = torch.where(ub[1:] < bprob[bidx], bidx,
                                  balias[bidx].long())          # [1]
                i, j = blk // P_, blk % P_
                lo = offsets[blk].long()
                n_blk = torch.clamp(offsets[blk + 1].long() - lo, min=0)
                if draws is None:
                    idx = raw % torch.clamp(n_blk, min=1)
                # level 2: edges within the block ~ edge weight
                h, t = _pick_edges(lo, idx, u, eprob, ealias, eheads,
                                   etails)
                mask = (n_blk > 0).float().expand(B)

                def take(x, k):
                    return x.index_select(0, k)[0]

                local = {
                    "tables": (take(vertex, i), take(context, j)),
                    "moments": (tuple(take(m, i) for m in v_moms),
                                tuple(take(m, j) for m in c_moms)),
                }
                new_local, loss = step_fn(
                    local, (h, t, mask), lr, take(nprob, j),
                    take(nalias, j), take(nsizes, j), generator=generator,
                    draws=neg_draws or None)
                nv, nc = new_local["tables"]
                nvm, ncm = new_local["moments"]
                vertex.index_copy_(0, i, nv[None])
                context.index_copy_(0, j, nc[None])
                for m, nm in zip(v_moms, nvm):
                    m.index_copy_(0, i, nm[None])
                for m, nm in zip(c_moms, ncm):
                    m.index_copy_(0, j, nm[None])
                losses.append(loss)
        return arena, torch.stack(losses)

    return run
