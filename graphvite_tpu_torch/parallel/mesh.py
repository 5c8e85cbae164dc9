"""Multi-device training: vertex partitions, the worker group and its
collectives, and the episode engines (the port of
graphvite_tpu/parallel/mesh.py).

The reference drives a `jax.sharding.Mesh` from one controller; its
collectives are `ppermute` (the ring, the KG seat rotation), `all_to_all`
(the walk engine's row routing), `psum` (the replicated merge) and
`all_gather` / `psum_scatter` (the KG engine's global negative pool). The
port keeps that design: one Python process holds W workers
(`DeviceGroup`), each with its own `torch.device`, on CUDA its own stream,
and its own `torch.Generator`; the collectives are functions over lists
of per-worker tensors (`ring_shift`, `permute`, `all_to_all`, `sum`,
`all_gather`, `reduce_scatter`), narrow enough that a
`torch.distributed` backend can stand behind the same interface for the
multi-host path. Workers may share a device (`device_ids=[0, 0]`): the
ring then renames list entries and copies nothing.

Layout (ShardedGraphTrainer). Vertices are dealt to P = W partitions in
degree order (solver.h:873-887) and renumbered so partition p owns local
ids [0, size_p); a table becomes P shards of [cap, D] rows (padded rows
zero). In edges mode worker p keeps head partition p (the vertex shard)
for the whole run, while the context shard, its moments and its negative
alias arrays travel one step around the ring after every episode: at
episode e worker p trains block (p, (p + e) % P), the orthogonal episode
schedule of solver.h:519-575. In walks mode both tables stay put; every
worker generates whole walks over the replicated graph and fetches and
updates rows on their owners by all_to_all (`_walk_batch`).
ReplicatedEdgeTrainer (LargeVis) keeps a full replica per worker and
merges the episode deltas.

Random draws: each worker draws from its own generator, seeded from
(seed, rotation, worker) as the reference folds the rotation into
PRNGKey(seed) and splits it over the devices; `run_episode` also takes
the draws as an input (`episode_draws` makes them on the CPU), so tests
can feed the reference's and the card can be held against the CPU.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch
from torch.profiler import record_function

from graphvite_tpu_torch.ops.alias import (AliasTable, PackedAliasTables,
                                           device_sample)
from graphvite_tpu_torch.ops.blocked import _pick_edges
from graphvite_tpu_torch.ops.steps import (_logistic_terms,
                                           graph_pool_groups,
                                           make_graph_banded_core,
                                           make_graph_pool_step,
                                           walk_shift_fwd)
from graphvite_tpu_torch.ops.scatter import scatter_add_
from graphvite_tpu_torch.ops.device_sampler import (emit_walk_banded,
                                                    make_walk_chain_fn,
                                                    walk_offsets)
from graphvite_tpu_torch.optim import Optimizer, apply_row_updates
from graphvite_tpu_torch.utils.common import logger


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


# ---------------------------------------------------------------------------
# the worker group and its collectives
# ---------------------------------------------------------------------------

def worker_seed(seed, rotation, worker):
    """The seed of a worker's generator for one episode: a function of
    (seed, rotation, worker), as the reference splits fold_in(PRNGKey(seed),
    rotation) over its devices."""
    ss = np.random.SeedSequence([int(seed) & (2**63 - 1), int(rotation),
                                 int(worker)])
    return int(ss.generate_state(1, np.uint64)[0])


class DeviceGroup:
    """W workers in one process (the port of make_mesh, which builds the
    reference's jax.sharding.Mesh; GRAPHVITE_COORDINATOR, its multi-host
    switch, raises): worker i runs on
    `devices[i]`, on CUDA on a stream of its own, and draws from a
    generator of its own. Workers may share a device.

    The collectives take and return lists of per-worker tensors, each on
    its worker's device; on CUDA each destination's stream waits for the
    source streams (an event, no host sync), a tensor that crosses
    streams is recorded on the stream that reads it, and a copy between
    two devices is a peer copy ordered on both workers' streams:

    * ring_shift(xs): ppermute with perm (i, (i - 1) % P), i.e. worker i
      receives worker (i + 1) % P's tensor; between workers of one device
      the entry is renamed, not copied;
    * all_to_all(chunks): chunks[i] is [P, C, ...] on worker i; worker j
      receives [P, C, ...] whose row i is chunks[i][j]; the identity for
      one worker;
    * sum(xs): every worker receives the sum over workers, added in worker
      order on each (so every worker holds the same bits);
    * permute(xs, pairs): ppermute with the (source, destination) `pairs`;
      a worker that receives nothing gets zeros (a broadcast view);
    * all_gather(xs): every worker receives the workers' tensors
      concatenated along dim 0 in worker order (all_gather, tiled);
    * reduce_scatter(xs): xs[i] is [P * C, ...]; worker j receives the sum
      over workers of chunk j, xs[i][j C:(j + 1) C], added in worker order
      (psum_scatter, tiled).
    """

    def __init__(self, devices):
        if os.environ.get("GRAPHVITE_COORDINATOR"):
            raise NotImplementedError(
                "GRAPHVITE_COORDINATOR (multi-host training) is not ported "
                "yet (ROADMAP queue 1, item 19)")
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a device group needs at least one worker")
        self.size = len(self.devices)
        self.on_cuda = self.devices[0].type == "cuda"
        if any((d.type == "cuda") != self.on_cuda for d in self.devices):
            raise ValueError("workers on CUDA and on the CPU cannot mix: %r"
                             % (self.devices,))
        if self.on_cuda:
            self.devices = [torch.device("cuda", d.index if d.index
                                         is not None else 0)
                            for d in self.devices]
            self.streams = [torch.cuda.Stream(device=d)
                            for d in self.devices]
        else:
            self.streams = [None] * self.size
        self.generators = [torch.Generator(device=d) for d in self.devices]
        # the distinct devices, in worker order (replicated arrays)
        self.distinct = list(dict.fromkeys(self.devices))

    def __len__(self):
        return self.size

    def worker(self, i):
        """Context in which worker i's work is issued (its stream)."""
        if not self.on_cuda:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.streams[i])

    def seed_generators(self, seed, rotation):
        for i, g in enumerate(self.generators):
            g.manual_seed(worker_seed(seed, rotation, i))
        return self.generators

    def begin(self):
        """Order every worker's stream after the work issued so far on its
        device's current stream (the state it starts from)."""
        if self.on_cuda:
            for d, s in zip(self.devices, self.streams):
                s.wait_stream(torch.cuda.current_stream(d))

    def end(self):
        """Order each device's current stream after its workers' streams
        (the caller reads what the workers wrote)."""
        if self.on_cuda:
            for d, s in zip(self.devices, self.streams):
                torch.cuda.current_stream(d).wait_stream(s)

    def _events(self):
        if not self.on_cuda:
            return None
        return [s.record_event() for s in self.streams]

    def _fetch(self, x, i, j, events):
        """Worker i's tensor `x` made readable on worker j."""
        if i == j or not self.on_cuda:
            return x.to(self.devices[j])
        src, dst = self.streams[i], self.streams[j]
        if self.devices[i] == self.devices[j]:
            dst.wait_event(events[i])
            x.record_stream(dst)
            return x
        # a peer copy with both workers' streams current on their devices:
        # it runs after the source's work and before the destination's
        with torch.cuda.stream(src), torch.cuda.stream(dst):
            return x.to(self.devices[j], non_blocking=True)

    # each collective runs under a profiler range of its name (mesh::...),
    # so a trace shows its copies' device time

    def ring_shift(self, xs):
        P = self.size
        if P == 1:
            return list(xs)
        with record_function("mesh::ring_shift"):
            ev = self._events()
            return [self._fetch(xs[(j + 1) % P], (j + 1) % P, j, ev)
                    for j in range(P)]

    def all_to_all(self, chunks):
        P = self.size
        if P == 1:
            return list(chunks)
        with record_function("mesh::all_to_all"):
            ev = self._events()
            out = []
            for j in range(P):
                parts = [self._fetch(chunks[i][j], i, j, ev)
                         for i in range(P)]
                with self.worker(j):
                    out.append(torch.stack(parts))
            return out

    def sum(self, xs):
        P = self.size
        if P == 1:
            return list(xs)
        with record_function("mesh::sum"):
            ev = self._events()
            out = []
            for j in range(P):
                parts = [self._fetch(xs[i], i, j, ev) for i in range(P)]
                with self.worker(j):
                    acc = parts[0].clone()
                    for p in parts[1:]:
                        acc += p
                out.append(acc)
            return out

    def permute(self, xs, pairs):
        P = self.size
        src_of = {int(j): int(i) for i, j in pairs}
        if P == 1:
            return [xs[0] if 0 in src_of else xs[0].new_zeros(()).expand_as(
                xs[0])]
        with record_function("mesh::permute"):
            ev = self._events()
            out = []
            for j in range(P):
                if j in src_of:
                    i = src_of[j]
                    out.append(self._fetch(xs[i], i, j, ev))
                else:
                    with self.worker(j):
                        out.append(xs[j].new_zeros(()).expand_as(xs[j]))
            return out

    def all_gather(self, xs):
        P = self.size
        if P == 1:
            return list(xs)
        with record_function("mesh::all_gather"):
            ev = self._events()
            out = []
            for j in range(P):
                parts = [self._fetch(xs[i], i, j, ev) for i in range(P)]
                with self.worker(j):
                    out.append(torch.cat(parts))
            return out

    def reduce_scatter(self, xs):
        P = self.size
        if P == 1:
            return list(xs)
        with record_function("mesh::reduce_scatter"):
            ev = self._events()
            C = xs[0].shape[0] // P
            out = []
            for j in range(P):
                parts = [self._fetch(xs[i][j * C:(j + 1) * C], i, j, ev)
                         for i in range(P)]
                with self.worker(j):
                    acc = parts[0].clone()
                    for p in parts[1:]:
                        acc += p
                out.append(acc)
            return out


def _as_tensor(x, device):
    if torch.is_tensor(x):
        return x.to(device)
    return torch.as_tensor(np.ascontiguousarray(x), device=device)


# ---------------------------------------------------------------------------
# edges: the P x P block edge tables
# ---------------------------------------------------------------------------

class BlockEdgeTables:
    """Per-worker alias tables over the P x P edge blocks.

    Edges are grouped by (head partition, tail partition); worker i owns
    all blocks (i, *), stationary like the head-role table. Within a
    worker the P blocks are packed contiguously, `offsets[i, j]`
    delimiting block (i, j); each block has its own alias table (local
    indices). Each block is shuffled with default_rng(seed), so a uniform
    graph can draw a batch as one contiguous window (the reference's
    pseudo-shuffle, graph.cuh:362-365). Host numpy, equal to the
    reference's bit for bit; built vectorized over the blocks (one
    argsort, one packed alias build) where the reference loops."""

    def __init__(self, graph, partition: VertexPartition, seed: int = 7):
        P_ = partition.num_partition
        hp = partition.part_of[graph.edge_heads]
        tp = partition.part_of[graph.edge_tails]
        rng = np.random.default_rng(seed)
        key = hp.astype(np.int64) * P_ + tp
        order = np.argsort(key * (1 << 20)
                           + rng.integers(0, 1 << 20, key.size))
        del rng
        key = key[order]
        lh = partition.local_of[graph.edge_heads[order]]
        lt = partition.local_of[graph.edge_tails[order]]
        w = np.asarray(graph.edge_weights, np.float64)[order]
        del order
        self.uniform = bool(w.size == 0 or np.all(w == w[0]))
        counts = np.bincount(key, minlength=P_ * P_).reshape(P_, P_)
        per_dev = counts.sum(axis=1)
        cap = max(int(per_dev.max()) if per_dev.size else 0, 1)
        self.capacity = cap
        # one packed alias build over every block (offsets: the blocks'
        # bounds in the block-sorted edge order)
        bounds = np.zeros(P_ * P_ + 1, np.int64)
        np.cumsum(counts.reshape(-1), out=bounds[1:])
        if w.size:
            packed = PackedAliasTables(w, bounds)
            eprob, ealias = packed.prob, packed.alias
        else:
            eprob, ealias = np.zeros(0), np.zeros(0, np.int64)
        prob = np.zeros((P_, cap), np.float32)
        alias = np.zeros((P_, cap), np.int32)
        heads = np.zeros((P_, cap), np.int32)
        tails = np.zeros((P_, cap), np.int32)
        offsets = np.zeros((P_, P_ + 1), np.int32)
        np.cumsum(counts, axis=1, out=offsets[:, 1:])
        start = bounds[::P_][:P_]
        for i in range(P_):
            sl = slice(start[i], start[i] + per_dev[i])
            heads[i, : per_dev[i]] = lh[sl]
            tails[i, : per_dev[i]] = lt[sl]
            prob[i, : per_dev[i]] = eprob[sl]
            alias[i, : per_dev[i]] = ealias[sl]
        self.prob, self.alias = prob, alias
        self.heads, self.tails = heads, tails
        self.offsets = offsets

    def device_arrays(self, group):
        """Per worker: (prob, alias, heads, tails) tensors on its device."""
        return [tuple(torch.from_numpy(np.ascontiguousarray(a[i])).to(d)
                      for a in (self.prob, self.alias, self.heads,
                                self.tails))
                for i, d in enumerate(group.devices)]


# ---------------------------------------------------------------------------
# the per-block classic step
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# LargeVis: full replicas, merged deltas
# ---------------------------------------------------------------------------

class ReplicatedEdgeTrainer:
    """Naive-parallel training of SMALL shared tables (the multi-GPU
    LargeVis mode, visualization.cuh:417-596, as the reference's
    naive_parallel, solver.h:383, 526-529): a full replica per worker,
    each training its own positive stream; at the end of every episode
    each replica becomes start + mean over workers of (replica - start),
    the reference's pmean merge (mesh.py:341-352). Moments stay per
    worker (per-GPU moment caches).

    step_fn: a LargeVis step (`make_vis_pool_step`,
    `make_vis_train_step`): step(state, heads, tails, lr, *neg_state,
    generator=None, draws=None) over {"tables": (table,), "moments":
    ((m...),)}.

    Positives: an alias draw over every edge, the first-level index from
    a float32 uniform as the reference (and the port's flat edge route)
    takes it. Draws per worker and batch: ((u0, u1) [B] edge uniforms,
    [step draws per reuse])."""

    def __init__(self, group: DeviceGroup, step_fn, opt: Optimizer,
                 batch_size: int, ep_batches: int, positive_reuse: int = 1):
        self.group = group
        self.step_fn = step_fn
        self.opt = opt
        self.batch_size = int(batch_size)
        self.ep_batches = int(ep_batches)
        self.positive_reuse = max(int(positive_reuse), 1)

    def init_state(self, tables, moments=None):
        """(tables, moments) per worker from the canonical tables (tensors
        or numpy [*, D] arrays) and, for resume, the canonical moments
        (one tuple per table; None: zeros)."""
        g = self.group
        if moments is None:
            moments = tuple((None,) * self.opt.num_moment for _ in tables)
        out_t, out_m = [], []
        for d in g.devices:
            ts = tuple(_as_tensor(t, d).clone() for t in tables)
            ms = tuple(tuple(torch.zeros(t.shape, dtype=torch.float32,
                                         device=d) if m is None
                             else _as_tensor(m, d).float().clone()
                             for m in side)
                       for t, side in zip(ts, moments))
            out_t.append(ts)
            out_m.append(ms)
        return out_t, out_m

    def init_edges(self, graph):
        """The edge alias table and the edge arrays, once per distinct
        device: (prob, alias, heads, tails)."""
        w = graph.edge_weights
        w = w.cpu().numpy() if torch.is_tensor(w) else np.asarray(w)
        t = AliasTable(w)
        prob = t.prob.astype(np.float32)
        alias = t.alias.astype(np.int32)
        out = {}
        for d in self.group.distinct:
            out[d] = (torch.from_numpy(prob).to(d),
                      torch.from_numpy(alias).to(d),
                      _as_tensor(graph.edge_heads, d).to(torch.int32),
                      _as_tensor(graph.edge_tails, d).to(torch.int32))
        return out

    def episode_draws(self, generator):
        """Every worker's draws of one episode from one CPU generator, on
        the CPU (`draws_to` moves them): [worker][batch] = ((u0, u1),
        [step draws per reuse])."""
        B = self.batch_size
        shape = getattr(self.step_fn, "pool_shape", None)
        if shape is None:
            shape = self.step_fn.draw_shape(B)
        out = []
        for _ in range(self.group.size):
            batches = []
            for _ in range(self.ep_batches):
                edge = tuple(torch.rand(B, generator=generator)
                             for _ in range(2))
                steps = [tuple(torch.rand(shape, generator=generator)
                               for _ in range(2))
                         for _ in range(self.positive_reuse)]
                batches.append((edge, steps))
            out.append(batches)
        return out

    def run_episode(self, tables, moments, edge_arrays, neg_state,
                    batch_id0, num_batch_total, seed, draws=None):
        """One episode on every worker: EP batches, each reused R times
        with fresh negatives at lr = schedule(batch_id0 + (i R + r) W).
        `neg_state`: the negative sampler's tensors (any device; copied
        to each worker's). Returns (tables, moments, losses [W] of [EP])."""
        g = self.group
        W, B, R = g.size, self.batch_size, self.positive_reuse
        gens = g.seed_generators(seed, 0)
        negs = {d: tuple(x.to(d) for x in neg_state) for d in g.distinct}
        g.begin()
        deltas, states, losses = [], [], []
        for w in range(W):
            dev = g.devices[w]
            eprob, ealias, eheads, etails = edge_arrays[dev]
            with g.worker(w), torch.no_grad():
                start = tuple(t.clone() for t in tables[w])
                st = {"tables": tables[w], "moments": moments[w]}
                ls = []
                for i in range(self.ep_batches):
                    if draws is None:
                        u = (torch.rand(B, generator=gens[w], device=dev),
                             torch.rand(B, generator=gens[w], device=dev))
                        steps = [None] * R
                    else:
                        u, steps = draws[w][i]
                    eid = device_sample(eprob, ealias, u[0], u[1])
                    h, t = eheads[eid], etails[eid]
                    rl = []
                    for r in range(R):
                        lr = self.opt.schedule_lr(
                            batch_id0 + (i * R + r) * W, num_batch_total)
                        st, loss = self.step_fn(st, h, t, lr, *negs[dev],
                                                generator=gens[w],
                                                draws=steps[r])
                        rl.append(loss)
                    ls.append(rl[0] if R == 1 else torch.stack(rl).mean())
                deltas.append(tuple(s.float() - s0.float() for s, s0
                                    in zip(st["tables"], start)))
                states.append((start, st["moments"]))
                losses.append(torch.stack(ls))
        n_tab = len(tables[0])
        summed = [g.sum([d[k] for d in deltas]) for k in range(n_tab)]
        out_tables = []
        for w in range(W):
            with g.worker(w):
                start = states[w][0]
                out_tables.append(tuple(
                    (s0.float() + summed[k][w] / W).to(s0.dtype)
                    for k, s0 in enumerate(start)))
        g.end()
        return out_tables, [s[1] for s in states], losses


def _draws_to(draws, device):
    """A nested list/tuple of CPU draw tensors, on `device`."""
    if torch.is_tensor(draws):
        return draws.to(device)
    if draws is None:
        return None
    kind = type(draws)
    return kind(_draws_to(x, device) for x in draws)


def draws_to(draws, device):
    """Move episode draws (per worker, `episode_draws`' layout) to each
    worker's device: `device` a device or a list of them, one per
    worker."""
    if isinstance(device, (list, tuple)):
        return [_draws_to(d, dev) for d, dev in zip(draws, device)]
    return _draws_to(draws, device)


# ---------------------------------------------------------------------------
# node embedding: sharded tables, edges and banded walks
# ---------------------------------------------------------------------------

class ShardedGraphTrainer:
    """Episode-scheduled sharded training over a DeviceGroup of P workers
    (one partition each).

    Per worker: the stationary head-role shard (vertex table and
    moments) and, in edges mode, the rotating tail-role shard (context
    table, moments and the partition's negative alias arrays), which
    `ring_shift` moves one step after every episode.

    Positive sampling per `sampler_mode`:

    * "edges" (LINE, augmentation_step 1): per-worker block alias tables
      (BlockEdgeTables). A uniform graph whose every nonempty block holds
      a full batch draws each batch as one window of the block's shuffled
      edges (one uniform); otherwise the in-block edge index is an
      integer draw over [0, n) (the reference takes it from a float32
      uniform: ROADMAP queue 3) and a uniform makes the alias test. The
      shared-negative pool step runs on the resident shards with pools
      from the resident tail partition (padded-uniform alias arrays);
      `negative_sharing=False` takes the classic per-draw step.
    * "walks" (DeepWalk, node2vec): the banded whole-walk step over
      row-sharded tables with distributed row fetch and update
      (`_walk_batch`): the same step family as the flat engine.

    Draws per worker and batch: edges ((u,) window or (idx, u) alias,
    step draws (u1, u2)); walks (chain draws, (u1, u2) pool draws)."""

    def __init__(self, group: DeviceGroup, partition: VertexPartition,
                 dim: int, model, opt: Optimizer, num_negative: int = 1,
                 negative_weight: float = 5.0, batch_size: int = 100000,
                 ep_batches: int = 50, sampler_mode: str = "edges",
                 walk_cfg=None, negative_sharing: bool = True,
                 pool_size: int = 128, trust: float = 0.25):
        if partition.num_partition != group.size:
            raise ValueError("one partition per worker: %d partitions, %d "
                             "workers" % (partition.num_partition,
                                          group.size))
        if sampler_mode not in ("edges", "walks"):
            raise ValueError(sampler_mode)
        self.group = group
        self.partition = partition
        self.num_partition = group.size
        self.dim = int(dim)
        self.model = model
        self.opt = opt
        self.num_negative = int(num_negative)
        self.negative_weight = float(negative_weight)
        self.batch_size = int(batch_size)
        self.ep_batches = int(ep_batches)
        self.rotation = 0
        self.sampler_mode = sampler_mode
        self.trust = float(trust) if trust else None
        self.walk_cfg = dict(walk_cfg or {})
        if "route_slack" not in self.walk_cfg:
            self.walk_cfg["route_slack"] = float(
                os.environ.get("GRAPHVITE_WALK_ROUTE_SLACK", 2.0))
        self._drops = None        # per worker: dropped requests (device)
        self._pairs = None        # per worker: pairs trained (device)
        self._emitted = 0         # row requests made, all workers
        self._drop_warned = False
        self._edges_uniform = False
        self.negative_sharing = bool(negative_sharing)
        if sampler_mode == "edges":
            if self.negative_sharing:
                self.pool_groups = graph_pool_groups(self.batch_size)
                self.step = make_graph_pool_step(
                    opt, num_negative, negative_weight,
                    pool_size=int(pool_size), pool_groups=self.pool_groups,
                    trust=trust)
            else:
                self.step = make_sharded_graph_step(
                    model, opt, num_negative, negative_weight)

    # -- host-side state ------------------------------------------------------
    def init_state(self, vertex, context, moments=None):
        """Shard the [V, D] tables (tensors on any device, or numpy) into
        per-worker [cap, D] shards on the workers' devices. `moments`
        ((v_moms...), (c_moms...)) canonical [V, D] moments seed the
        shards' (resume=True continues from what an earlier mesh run
        gathered); None: zeros. Moments are float32 whatever the tables'
        dtype."""
        part, g = self.partition, self.group
        self.rotation = 0
        if moments is None:
            moments = ((None,) * self.opt.num_moment,) * 2
        src = [_as_tensor(vertex, g.devices[0]),
               _as_tensor(context, g.devices[0])]
        out = []
        for p, d in enumerate(g.devices):
            tables = tuple(part.shard_tensor(t, p).to(d) for t in src)
            moms = tuple(
                tuple(torch.zeros((part.capacity, self.dim),
                                  dtype=torch.float32, device=d)
                      if m is None else
                      part.shard_tensor(_as_tensor(m, g.devices[0]).float(),
                                        p).to(d)
                      for m in side)
                for side in moments)
            out.append({"tables": tables, "moments": moms})
        return out

    def init_negative_state(self, vertex_weights, exponent: float = 0.75):
        """Edges: per worker (prob, alias, size) of the tail partition it
        holds (padded-uniform for the pool step). Walks: ONE global
        degree^exponent alias table on every distinct device (pool rows
        are fetched from their owners like chain rows)."""
        g = self.group
        if self.sampler_mode == "walks":
            w = np.maximum(np.asarray(vertex_weights, np.float64),
                           1e-12) ** exponent
            t = AliasTable(w)
            return {d: (torch.from_numpy(t.prob.astype(np.float32)).to(d),
                        torch.from_numpy(t.alias.astype(np.int32)).to(d))
                    for d in g.distinct}
        prob, alias, sizes = self.partition.negative_alias_arrays(
            vertex_weights, exponent, padded_uniform=self.negative_sharing)
        return ([torch.from_numpy(prob[i]).to(d)
                 for i, d in enumerate(g.devices)],
                [torch.from_numpy(alias[i]).to(d)
                 for i, d in enumerate(g.devices)],
                [int(s) for s in sizes])

    def build_blocks(self, graph, tables=None):
        """BlockEdgeTables on the workers (edges mode; `tables`: the ones
        built for this graph and partition already), with the window-draw
        switch: only where every nonempty block holds a full batch
        (smaller blocks would replay one fixed order)."""
        if tables is None:
            tables = BlockEdgeTables(graph, self.partition)
        sizes = np.diff(tables.offsets, axis=1).reshape(-1)
        nonempty = sizes[sizes > 0]
        self._edges_uniform = (tables.uniform and nonempty.size > 0
                               and bool((nonempty >= self.batch_size).all()))
        self.block_offsets = tables.offsets.astype(np.int64)
        return tables.device_arrays(self.group)

    def build_sample_state(self, graph):
        """Edges: the block tables. Walks: the walk arrays (replicated
        once per distinct device) with the partition maps, and the
        banded engine's shapes, whose fetch capacity follows s_max, the
        heaviest partition's degree share."""
        if self.sampler_mode == "edges":
            return self.build_blocks(graph)
        t = AliasTable(graph.edge_weights)
        w = np.asarray(graph.csr_weights, np.float64)
        uniform = bool(w.size == 0 or np.all(w == w[0]))
        self.walk_cfg["uniform"] = uniform
        indptr = np.asarray(graph.indptr)
        deg = np.diff(indptr)
        max_deg = int(deg.max()) if deg.size else 1
        self.walk_cfg["bs_iters"] = max(
            int(np.ceil(np.log2(max_deg + 1))) + 1, 1)
        if uniform:
            nbr_prob = np.zeros(0, np.float32)
            nbr_alias = np.zeros(0, np.int32)
        else:
            packed = PackedAliasTables(w, indptr)
            nbr_prob = packed.prob.astype(np.float32)
            nbr_alias = packed.alias.astype(np.int32)
        arrays = [t.prob.astype(np.float32), t.alias.astype(np.int32),
                  np.asarray(graph.edge_heads, np.int32),
                  np.asarray(graph.edge_tails, np.int32),
                  np.stack([indptr[:-1], deg], axis=1).astype(np.int32),
                  np.asarray(graph.indices, np.int32), nbr_prob, nbr_alias]
        if self.walk_cfg.get("biased"):
            # row-sorted CSR indices: the binary-search membership
            order = np.lexsort((graph.indices, np.repeat(
                np.arange(indptr.size - 1), deg)))
            arrays.append(np.asarray(graph.indices[order], np.int32))
        maps = (self.partition.part_of.astype(np.int64),
                self.partition.local_of.astype(np.int64))
        deg_mass = np.bincount(self.partition.part_of,
                               weights=np.asarray(deg, np.float64),
                               minlength=self.num_partition)
        s_max = float(deg_mass.max() / max(deg_mass.sum(), 1e-12))
        self._build_banded(s_max)
        return {d: (tuple(torch.as_tensor(np.ascontiguousarray(a), device=d)
                          for a in arrays),)
                + tuple(torch.as_tensor(m, device=d) for m in maps)
                for d in self.group.distinct}

    def _build_banded(self, s_max):
        """The walks engine's shapes, core and chain (mesh.py:586-653)."""
        cfg = self.walk_cfg
        P_ = self.num_partition
        aug = int(cfg["augmentation_step"])
        Lw = int(cfg["walk_length"])
        L1 = Lw + 1
        bidir = bool(cfg.get("bidir", True))
        self._offs = walk_offsets(aug, bidir)
        T = len(self._offs)
        slot_unit = T * L1
        Bw = max(int(cfg.get("batch_walks")
                     or max(self.batch_size // slot_unit, 1)), 1)
        G = graph_pool_groups(Bw, target_group=max(2048 // slot_unit, 1))
        M = int(cfg.get("pool_size", 64))
        self._core, _ = make_graph_banded_core(
            self.opt, self.num_negative, self.negative_weight, aug, bidir,
            pool_size=M, pool_groups=G, trust=self.trust)
        self._banded_shape = dict(Bw=Bw, L1=L1, T=T, G=G, M=M)
        Npos = Bw * L1
        N = Npos + G * M
        slack = float(cfg.get("route_slack", 2.0))
        C = int(min(N, max(int(np.ceil(N * max(slack / P_, 1.3 * s_max))),
                           8)))
        self._banded_capacity = C
        self._chain_fn = make_walk_chain_fn(
            cfg["uniform"], Lw, Bw, biased=cfg.get("biased", False),
            p=cfg.get("p", 1.0), q=cfg.get("q", 1.0),
            bs_iters=cfg.get("bs_iters", 32), membership="search")

    # -- draws ------------------------------------------------------------------
    def episode_draws(self, generator):
        """Every worker's draws of the next episode from one CPU
        generator, on the CPU (`draws_to` moves them), in run_episode's
        layout ([worker][batch])."""
        P_, EP, B = self.num_partition, self.ep_batches, self.batch_size
        K = self.num_negative

        def rand(*shape):
            return torch.rand(shape, generator=generator)

        out = []
        for i in range(P_):
            batches = []
            for _ in range(EP):
                if self.sampler_mode == "walks":
                    s = self._banded_shape
                    Bw, L1, G, M = s["Bw"], s["L1"], s["G"], s["M"]
                    fn = self._chain_fn
                    if self.walk_cfg.get("biased"):
                        chain = (rand(Bw), rand(Bw),
                                 rand(L1 - 2, fn.rounds_cap, 3,
                                      fn.proposals, Bw))
                    else:
                        chain = (rand(Bw), rand(Bw), rand(L1 - 2, Bw),
                                 rand(L1 - 2, Bw))
                    batches.append((chain, (rand(G, M), rand(G, M))))
                    continue
                j = (i + self.rotation) % P_
                lo, hi = self.block_offsets[i, j], self.block_offsets[i, j + 1]
                n = max(int(hi - lo), 1)
                if self._edges_uniform:
                    pos = (rand(),)
                else:
                    pos = (torch.randint(0, n, (B,), generator=generator),
                           rand(B))
                if self.negative_sharing:
                    shape = self.step.pool_shape
                else:
                    shape = (B, K)
                batches.append((pos, (rand(*shape), rand(*shape))))
            out.append(batches)
        return out

    # -- the episode -----------------------------------------------------------
    def run_episode(self, state, sample_state, neg_state, batch_id0,
                    num_batch_total, seed, draws=None):
        """One episode of EP batches on every worker at lr =
        schedule(batch_id0 + i P): the P workers train concurrently, so
        global progress is P batches per batch. Returns (state,
        neg_state, losses: per worker [EP] on its device)."""
        gens = self.group.seed_generators(seed, self.rotation)
        self.group.begin()
        if self.sampler_mode == "edges":
            state, neg_state, losses = self._episode_edges(
                state, sample_state, neg_state, batch_id0, num_batch_total,
                gens, draws)
        else:
            state, losses = self._episode_walks(
                state, sample_state, neg_state, batch_id0, num_batch_total,
                gens, draws)
        self.group.end()
        self.rotation += 1
        return state, neg_state, losses

    def _episode_edges(self, state, blocks, neg_state, batch_id0,
                       num_batch_total, gens, draws):
        g, P_, B = self.group, self.num_partition, self.batch_size
        nprob, nalias, nsize = neg_state
        losses = []
        for i in range(P_):
            dev = g.devices[i]
            bprob, balias, bheads, btails = blocks[i]
            j = (i + self.rotation) % P_
            lo = int(self.block_offsets[i, j])
            hi = int(self.block_offsets[i, j + 1])
            n_block = max(hi - lo, 0)
            st = state[i]
            ls = []
            with g.worker(i), torch.no_grad():
                for it in range(self.ep_batches):
                    lr = self.opt.schedule_lr(batch_id0 + it * P_,
                                              num_batch_total)
                    if draws is None:
                        if self._edges_uniform:
                            pos = (torch.rand((), generator=gens[i],
                                              device=dev),)
                        else:
                            pos = (torch.randint(0, max(n_block, 1), (B,),
                                                 generator=gens[i],
                                                 device=dev),
                                   torch.rand((B,), generator=gens[i],
                                              device=dev))
                        step_draws = None
                    else:
                        pos, step_draws = draws[i][it]
                    if self._edges_uniform:
                        # one window of the block's shuffled edges; its
                        # slots outside the block (a window clamped into a
                        # neighbouring block) are masked
                        span = max(n_block - B, 0)
                        start = lo + (pos[0] * (span + 1)).long()
                        start = torch.clamp(start, max=bheads.shape[0] - B)
                        p = start + torch.arange(B, device=dev)
                        h, t = bheads[p], btails[p]
                        mask = ((p >= lo) & (p < hi)).float()
                    else:
                        h, t = _pick_edges(lo, pos[0], pos[1], bprob, balias,
                                           bheads, btails)
                        mask = torch.full((B,), 1.0 if n_block > 0 else 0.0,
                                          device=dev)
                    if self.negative_sharing:
                        st, loss = self.step(st, h, t, lr, nprob[i],
                                             nalias[i], mask=mask,
                                             generator=gens[i],
                                             draws=step_draws)
                    else:
                        st, loss = self.step(st, (h, t, mask), lr, nprob[i],
                                             nalias[i], nsize[i],
                                             generator=gens[i],
                                             draws=step_draws)
                    ls.append(loss)
                losses.append(torch.stack(ls))
            state[i] = st
        # the tail role moves one step around the ring
        contexts = g.ring_shift([s["tables"][1] for s in state])
        n_mom = self.opt.num_moment
        c_moms = [g.ring_shift([s["moments"][1][m] for s in state])
                  for m in range(n_mom)]
        for i in range(P_):
            state[i] = {"tables": (state[i]["tables"][0], contexts[i]),
                        "moments": (state[i]["moments"][0],
                                    tuple(c_moms[m][i]
                                          for m in range(n_mom)))}
        neg_state = (g.ring_shift(nprob), g.ring_shift(nalias),
                     [nsize[(i + 1) % P_] for i in range(P_)])
        return state, neg_state, losses

    def _episode_walks(self, state, sample_state, neg_state, batch_id0,
                       num_batch_total, gens, draws):
        g, P_ = self.group, self.num_partition
        D = self.dim
        sgd = self.opt.num_moment == 0
        local = []
        for i, s in enumerate(state):
            if not sgd:
                local.append(dict(s))
                continue
            # the fused (vertex | context) arena for the episode: the
            # serve gather and the owner's update are one row op each
            with g.worker(i):
                local.append({"vc": torch.cat(s["tables"], dim=-1)})
        losses = [[] for _ in range(P_)]
        stats = [[] for _ in range(P_)]
        for it in range(self.ep_batches):
            lr = self.opt.schedule_lr(batch_id0 + it * P_, num_batch_total)
            bd = None if draws is None else [draws[i][it] for i in range(P_)]
            self._walk_batch(local, sample_state, neg_state, lr, gens, bd,
                             losses, stats)
        out = []
        for i in range(P_):
            with g.worker(i):
                if sgd:
                    vc = local[i]["vc"]
                    out.append({"tables": (vc[:, :D].contiguous(),
                                           vc[:, D:].contiguous()),
                                "moments": ((), ())})
                else:
                    out.append(local[i])
                drops = torch.stack([d for d, _ in stats[i]]).sum()
                pairs = torch.stack([n for _, n in stats[i]]).double().sum()
                if self._drops[i] is not None:
                    drops = drops + self._drops[i]
                    pairs = pairs + self._pairs[i]
                self._drops[i], self._pairs[i] = drops, pairs
                losses[i] = torch.stack(losses[i])
        return out, losses

    def _walk_batch(self, local, sample_state, neg_state, lr, gens, draws,
                    losses, stats):
        """One walks-mode batch on every worker (mesh.py:681-824):

        1. every worker draws Bw walks over the replicated graph and a
           [G, M] negative pool, and assigns each of its N row requests
           (chain positions, then pool slots) a slot of capacity C at the
           row's owner by a one-hot cumsum (no sort); requests past C are
           dropped, their band slots masked;
        2. all_to_all the (local id, valid) requests; each owner serves
           its rows (one gather of the fused [cap, 2D] arena on SGD);
           all_to_all the rows back;
        3. run the banded core on the fetched rows;
        4. all_to_all the per-row gradients (with touch counts and squared
           sums for the moment rules) to the owners, which apply them:
           SGD one kernel-1 scatter-add on the arena, ids `cap` dropped;
           moment rules apply_row_updates with entry counts and squares
           (kernel 2 on shards above DENSE_UPDATE_ELEMS), zero-count slots
           dropped so they do not decay the moments."""
        g, P_ = self.group, self.num_partition
        D = self.dim
        s = self._banded_shape
        Bw, L1, G, M = s["Bw"], s["L1"], s["G"], s["M"]
        C = self._banded_capacity
        Npos = Bw * L1
        N = Npos + G * M
        aug = int(self.walk_cfg["augmentation_step"])
        bidir = bool(self.walk_cfg.get("bidir", True))
        k, nw = self.num_negative, self.negative_weight
        sgd = self.opt.num_moment == 0
        if self._drops is None:
            self._drops = [None] * P_
            self._pairs = [None] * P_
        ctx = []
        reqs = []
        for i in range(P_):
            dev = g.devices[i]
            walk_arrays, part_of, local_of = sample_state[dev]
            nprob, nalias = neg_state[dev]
            with g.worker(i), torch.no_grad():
                chain_draws = pool_draws = None
                if draws is not None:
                    chain_draws, pool_draws = draws[i]
                chain, valid = self._chain_fn(*walk_arrays,
                                              generator=gens[i],
                                              draws=chain_draws)
                chainT, pmask = emit_walk_banded(chain, valid, aug, bidir)
                if pool_draws is None:
                    pool_draws = (torch.rand((G, M), generator=gens[i],
                                             device=dev),
                                  torch.rand((G, M), generator=gens[i],
                                             device=dev))
                pool_ids = device_sample(nprob, nalias, *pool_draws)
                ids = torch.cat([chainT.reshape(-1), pool_ids.reshape(-1)])
                owner = part_of[ids]
                lid = local_of[ids]
                # [P, N], the scan along the contiguous axis (a scan over
                # the outer axis of [N, P] took ~1 ms on the card)
                onehot = (owner[None, :] == torch.arange(
                    P_, device=dev)[:, None]).long()
                csum = torch.cumsum(onehot, dim=1)
                cntp = csum[:, -1]
                slot_of = csum.gather(0, owner[None, :])[0] - 1
                fetched = slot_of < C
                loc = owner * C + torch.clamp(slot_of, max=C - 1)
                n_drop = torch.clamp(cntp - C, min=0).sum()
                dest = torch.where(fetched, loc, torch.full_like(loc, P_ * C))
                src2 = torch.full((P_ * C + 1,), N, dtype=torch.long,
                                  device=dev)
                src2.scatter_(0, dest, torch.arange(N, device=dev))
                src2 = src2[:P_ * C]
                ok = (src2 < N).reshape(P_, C)
                src2 = torch.clamp(src2, max=N - 1).reshape(P_, C)
                reqs.append(torch.stack(
                    [torch.where(ok, lid[src2], torch.zeros_like(src2)),
                     ok.long()], dim=-1))                      # [P, C, 2]
                ctx.append(dict(pmask=pmask, fetched=fetched, loc=loc,
                                n_drop=n_drop, ok=ok, src2=src2))
        got = g.all_to_all(reqs)
        serves = []
        for i in range(P_):
            with g.worker(i), torch.no_grad():
                glid = got[i][..., 0]
                ctx[i]["glid"] = glid
                ctx[i]["gok"] = got[i][..., 1] > 0
                if sgd:
                    serves.append(local[i]["vc"][glid])        # [P, C, 2D]
                else:
                    vertex, context = local[i]["tables"]
                    serves.append(torch.cat([vertex[glid], context[glid]],
                                            dim=-1))
        rows = g.all_to_all(serves)
        rets = []
        for i in range(P_):
            c_ = ctx[i]
            dev = g.devices[i]
            with g.worker(i), torch.no_grad():
                fetched = c_["fetched"]
                flat = torch.where(fetched[:, None],
                                   rows[i].reshape(P_ * C, -1)[c_["loc"]],
                                   0.0)
                v = flat[:Npos, :D].reshape(Bw, L1, D).float()
                c = flat[:Npos, D:].reshape(Bw, L1, D).float()
                Prows = flat[Npos:, D:].reshape(G, M, D).float()
                fposf = fetched[:Npos].reshape(Bw, L1).float()
                fpool = fetched[Npos:].reshape(G, M).float()
                # a pair trains only if BOTH endpoint rows arrived
                pm = c_["pmask"] * fposf[..., None]
                pm = pm * torch.stack([walk_shift_fwd(fposf, kk)
                                       for kk in self._offs], dim=-1)
                o = self._core(v, c, Prows, pm, lr, pool_mask=fpool)
                losses[i].append(o["loss_sum"]
                                 / torch.clamp(o["n_active"], min=1.0)
                                 / (1.0 + k * nw))
                stats[i].append((c_["n_drop"], o["n_active"]))
                self._emitted += N
                zeros = torch.zeros((G * M, D), device=dev)
                if sgd:
                    ret = torch.cat([
                        torch.cat([o["dv"].reshape(Npos, D),
                                   o["dc"].reshape(Npos, D)], dim=-1),
                        torch.cat([zeros, o["dP"].reshape(G * M, D)],
                                  dim=-1)]).mul_(lr)
                else:
                    ret = torch.cat([
                        torch.cat([o["dv"].reshape(Npos, D),
                                   o["dc"].reshape(Npos, D),
                                   o["v_sqs"], o["c_sqs_main"],
                                   o["v_counts"][:, None],
                                   o["c_counts_main"][:, None]], dim=-1),
                        torch.cat([zeros, o["dP"].reshape(G * M, D), zeros,
                                   o["p_sqs"].reshape(G * M, D),
                                   torch.zeros((G * M, 1), device=dev),
                                   o["p_counts"].reshape(G * M, 1)],
                                  dim=-1)])
                ok = c_["ok"]
                rets.append(torch.where(ok[..., None], ret[c_["src2"]], 0.0))
        back = g.all_to_all(rets)
        for i in range(P_):
            c_ = ctx[i]
            with g.worker(i), torch.no_grad():
                retg = back[i].reshape(P_ * C, -1)
                okf = c_["gok"].reshape(-1)
                ids_o = c_["glid"].reshape(-1)
                if sgd:
                    vc = local[i]["vc"]
                    cap = vc.shape[0]
                    upd_ids = torch.where(okf, ids_o,
                                          torch.full_like(ids_o, cap))
                    scatter_add_(vc, upd_ids, retg.neg_())
                    continue
                vertex, context = local[i]["tables"]
                v_moms, c_moms = local[i]["moments"]
                cap = vertex.shape[0]
                v_cnt = retg[:, 4 * D]
                c_cnt = retg[:, 4 * D + 1]
                sentinel = torch.full_like(ids_o, cap)
                v_ids = torch.where(okf & (v_cnt > 0), ids_o, sentinel)
                c_ids = torch.where(okf & (c_cnt > 0), ids_o, sentinel)
                new_vertex, new_v_moms = apply_row_updates(
                    vertex, v_moms, v_ids, retg[:, :D], self.opt, lr,
                    entry_counts=v_cnt, entry_sqs=retg[:, 2 * D:3 * D],
                    trust=self.trust)
                new_context, new_c_moms = apply_row_updates(
                    context, c_moms, c_ids, retg[:, D:2 * D], self.opt, lr,
                    entry_counts=c_cnt, entry_sqs=retg[:, 3 * D:4 * D],
                    trust=self.trust)
                local[i] = {"tables": (new_vertex, new_context),
                            "moments": (new_v_moms, new_c_moms)}

    # -- accounting and gathering -----------------------------------------------
    def drop_counts(self):
        """(dropped, emitted) row requests of the walks engine since the
        counts were last reset, read from the workers (a host sync)."""
        if not self._drops or any(d is None for d in self._drops):
            return 0, self._emitted
        return int(sum(int(d) for d in self._drops)), self._emitted

    def valid_pairs(self):
        """Pairs the walks engine trained since the counts were last
        reset (their masks' sum, after dropped requests), read from the
        workers (a host sync)."""
        if not self._pairs or any(n is None for n in self._pairs):
            return 0.0
        return float(sum(float(n) for n in self._pairs))

    def reset_drop_counts(self):
        self._drops = self._pairs = None
        self._emitted = 0

    @property
    def pair_drops(self):
        return self.drop_counts()[0]

    @property
    def pair_emitted(self):
        return self.drop_counts()[1]

    def check_drops(self):
        """Warn once when more than 1% of the row requests were dropped
        (mesh.py:975-987); returns (dropped, emitted)."""
        drops, emitted = self.drop_counts()
        if emitted and drops > 0.01 * emitted and not self._drop_warned:
            logger.warning(
                "row-fetch routing dropped %d of %d requests (%.1f%%): "
                "hub-skewed partition exceeds the all_to_all capacity; "
                "raise walk_cfg['route_slack'] (GRAPHVITE_WALK_ROUTE_SLACK)"
                " above %.1f", drops, emitted, 100.0 * drops / emitted,
                float(self.walk_cfg.get("route_slack", 2.0)))
            self._drop_warned = True
        return drops, emitted

    @property
    def rotating(self):
        """Only the edges engine rotates the context role; the walks
        engine keeps both tables partition-stationary."""
        return self.sampler_mode == "edges"

    def canonical(self, per_worker, rotated, out):
        """Write per-worker shards back into the [V, D] tensor `out` in
        global order; `rotated`: the shards travel with the ring (after e
        episodes worker i holds partition (i + e) % P)."""
        P_ = self.num_partition
        e = self.rotation % P_ if (rotated and self.rotating) else 0
        parts = [per_worker[(p - e) % P_] for p in range(P_)]
        return self.partition.unshard_tensors(parts, out)

    def gather_tables(self, state, device=None):
        """(vertex, context) [V, D] in global order on `device` (worker 0's
        by default), undoing the tail-shard rotation."""
        device = device or self.group.devices[0]
        v = self.partition.part_of.shape[0]
        out = []
        for side, rotated in ((0, False), (1, True)):
            shards = [s["tables"][side] for s in state]
            t = torch.empty((v, self.dim), dtype=shards[0].dtype,
                            device=device)
            out.append(self.canonical(shards, rotated, t))
        return tuple(out)

    def gather_moments(self, state, device=None):
        """Canonical ((v_moms...), (c_moms...)) [V, D] float32."""
        device = device or self.group.devices[0]
        v = self.partition.part_of.shape[0]
        out = []
        for side, rotated in ((0, False), (1, True)):
            moms = []
            for m in range(self.opt.num_moment):
                shards = [s["moments"][side][m] for s in state]
                t = torch.empty((v, self.dim), dtype=torch.float32,
                                device=device)
                moms.append(self.canonical(shards, rotated, t))
            out.append(tuple(moms))
        return tuple(out)
