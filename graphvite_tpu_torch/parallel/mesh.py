"""Degree-balanced vertex partitions and the per-block graph step (the
port of VertexPartition and make_sharded_graph_step of
graphvite_tpu/parallel/mesh.py).

Vertices are dealt to P partitions in degree order (solver.h:873-887) and
renumbered so partition p owns local ids [0, size_p); a table becomes P
shards of [cap, D] rows (padded rows zero). `VertexPartition` is host
numpy, bit-equal to the reference's, plus tensor forms of its shard and
unshard maps for the solver's shards on the card or in host memory.
"""
from __future__ import annotations

import numpy as np
import torch

from graphvite_tpu_torch.ops.alias import AliasTable
from graphvite_tpu_torch.ops.steps import _logistic_terms
from graphvite_tpu_torch.optim import Optimizer, apply_row_updates


class VertexPartition:
    """Zigzag degree-balanced partition of vertices (solver.h:873-887).

    deal index i of the degree-descending order to bucket
    min(i % 2P, 2P - 1 - (i % 2P)) so heavy vertices spread evenly.
    """

    def __init__(self, degrees: np.ndarray, num_partition: int):
        self.num_partition = int(num_partition)
        n = degrees.shape[0]
        order = np.argsort(-np.asarray(degrees), kind="stable")
        twop = 2 * self.num_partition
        slot = np.arange(n) % twop
        bucket = np.minimum(slot, twop - 1 - slot)
        part_of = np.empty(n, dtype=np.int32)
        part_of[order] = bucket.astype(np.int32)
        self.part_of = part_of                     # global id -> partition
        counts = np.bincount(part_of, minlength=self.num_partition)
        self.sizes = counts.astype(np.int64)       # members per partition
        self.capacity = int(counts.max()) if n else 0
        # local index within partition, in global-id order
        local = np.zeros(n, dtype=np.int32)
        for p in range(self.num_partition):
            members = np.nonzero(part_of == p)[0]
            local[members] = np.arange(members.size, dtype=np.int32)
        self.local_of = local                      # global id -> local idx
        # partition-major gather map: [P, cap] -> global id (padded with 0)
        self.members = np.zeros((self.num_partition, self.capacity),
                                dtype=np.int64)
        self.valid = np.zeros((self.num_partition, self.capacity),
                              dtype=bool)
        for p in range(self.num_partition):
            m = np.nonzero(part_of == p)[0]
            self.members[p, : m.size] = m
            self.valid[p, : m.size] = True

    def shard_rows(self, table: np.ndarray) -> np.ndarray:
        """[V, D] -> [P, cap, D] partition-major copy (padded rows zero)."""
        out = np.zeros((self.num_partition, self.capacity) + table.shape[1:],
                       dtype=table.dtype)
        out[self.valid] = table[self.members[self.valid]]
        return out

    def unshard_rows(self, sharded: np.ndarray) -> np.ndarray:
        """[P, cap, D] -> [V, D]."""
        v = self.part_of.shape[0]
        out = np.empty((v,) + sharded.shape[2:], dtype=sharded.dtype)
        out[self.members[self.valid]] = sharded[self.valid]
        return out

    def member_ids(self, p, device="cpu"):
        """Global ids of partition p's members in local-id order, as an
        int64 tensor on `device`."""
        ids = torch.from_numpy(self.members[p, : self.sizes[p]])
        return ids.to(device)

    def shard_tensor(self, table, p, out=None):
        """Partition p's [cap, D] shard of the [V, D] tensor `table`, on
        the table's device or written into `out` (a [cap, D] buffer, as a
        pinned host master); padded rows zero."""
        m = int(self.sizes[p])
        if out is None:
            out = torch.empty((self.capacity,) + tuple(table.shape[1:]),
                              dtype=table.dtype, device=table.device)
        torch.index_select(table, 0, self.member_ids(p, table.device),
                           out=out[:m])
        out[m:].zero_()
        return out

    def unshard_tensors(self, parts, out):
        """Write the P [cap, D] shards `parts` back into the [V, D] tensor
        `out` (on any device) and return it."""
        for p, part in enumerate(parts):
            m = int(self.sizes[p])
            out.index_copy_(0, self.member_ids(p, out.device),
                            part[:m].to(out.device))
        return out

    def negative_alias_arrays(self, weights: np.ndarray,
                              exponent: float = 0.75,
                              padded_uniform: bool = False):
        """Per-partition alias tables over member weights^exponent
        (solver.h:1264-1278), padded to [P, cap] each.

        `padded_uniform=True` builds each table over the FULL cap-length
        padded weight vector (zero weight beyond the partition size), so a
        uniform draw over all cap slots realizes the member distribution.
        The default form is only correct for draws bounded by `sizes`."""
        prob = np.zeros((self.num_partition, self.capacity), dtype=np.float32)
        alias = np.zeros((self.num_partition, self.capacity), dtype=np.int32)
        sizes = np.zeros((self.num_partition,), dtype=np.int32)
        w = np.maximum(np.asarray(weights, np.float64), 1e-12) ** exponent
        for p in range(self.num_partition):
            m = self.members[p][self.valid[p]]
            sizes[p] = m.size
            if not m.size:
                continue
            if padded_uniform:
                wp = np.zeros((self.capacity,), np.float64)
                wp[: m.size] = w[m]
                t = AliasTable(wp)
                prob[p] = t.prob
                alias[p] = t.alias
            else:
                t = AliasTable(w[m])
                prob[p, : m.size] = t.prob
                alias[p, : m.size] = t.alias
        return prob, alias, sizes


def make_sharded_graph_step(model, opt: Optimizer, num_negative: int,
                            negative_weight: float):
    """The per-block node-embedding step: K negative draws per sample from
    the resident tail partition's alias table, scored against the
    partition-local (vertex, context) shards.

    step(state, (heads, tails, mask), lr, neg_prob, neg_alias, neg_size,
    generator=None, draws=None) -> (state, loss): heads and tails [B] are
    local ids of the resident shards, mask [B] the sample validity;
    neg_prob / neg_alias [cap] the tail partition's alias arrays
    (`VertexPartition.negative_alias_arrays`' default form) and neg_size
    its member count (an int or a 0-dim tensor). Negatives are drawn over
    [0, neg_size), never over the padded slots. `draws` = (u1, u2) [B, K]
    uniforms; otherwise they come from `generator`.

    As in the reference (mesh.py:226-261), and unlike the classic step of
    ops/steps.py, the vertex update carries no per-entry touch counts or
    squared sums and no id is masked: each head is one touch and a masked
    sample is a zero-gradient touch (the moment rules count it)."""
    k = num_negative

    def step(state, xs, lr, neg_prob, neg_alias, neg_size, generator=None,
             draws=None):
        heads, tails, wmask = xs
        vertex, context = state["tables"]
        v_moms, c_moms = state["moments"]
        b = heads.shape[0]
        if draws is None:
            dev = vertex.device
            draws = (torch.rand((b, k), generator=generator, device=dev),
                     torch.rand((b, k), generator=generator, device=dev))
        u1, u2 = draws
        idx = torch.clamp((u1 * neg_size).long(), max=neg_size - 1)
        negs = torch.where(u2 < neg_prob[idx], idx, neg_alias[idx].long())

        heads = heads.long()
        v = vertex[heads].float()                            # [B, D]
        ctx_ids = torch.cat([negs, tails.long()[:, None]], dim=1)
        c = context[ctx_ids].float()                         # [B, K+1, D]
        logits = model.score(v[:, None, :], c)
        gradient, weight, sample_loss = _logistic_terms(
            logits, k, negative_weight, wmask)
        gv, gc = model.backward(v[:, None, :], c, gradient)
        w = weight[..., None]
        wd = opt.weight_decay
        reg_v = (w * gv).sum(dim=1) + (weight.sum(dim=-1)[:, None] * wd) * v
        reg_c = w * gc + wd * w * c
        new_vertex, new_v_moms = apply_row_updates(
            vertex, v_moms, heads, reg_v, opt, lr)
        new_context, new_c_moms = apply_row_updates(
            context, c_moms, ctx_ids.reshape(-1),
            reg_c.reshape(b * (k + 1), -1), opt, lr)
        new_state = {"tables": (new_vertex, new_context),
                     "moments": (new_v_moms, new_c_moms)}
        return new_state, sample_loss.sum() / torch.clamp(wmask.sum(),
                                                          min=1.0)

    return step
