"""Knowledge-graph training over several workers (the port of
graphvite_tpu/parallel/kg.py): replicated (naive-parallel) and
partitioned (tied-weights sharded) modes.

The reference trains KG embeddings with tied entity weights by staging 2P
partitions under a diagonal-butterfly schedule (knowledge_graph.cuh:
531-533, solver.h:532-561); without a partitioned matrix it falls back to
`naive_parallel`: a full replica per GPU, deltas merged at write-back
(solver.h:383, 526-529).

`ReplicatedKGTrainer` is that naive-parallel mode: tables replicated over
the workers, each training an episode on its own positive stream, the
replicas' episode deltas summed (`DeviceGroup.sum`).

`ShardedKGTrainer` is the partitioned mode: entities split into 2W
partitions over W workers (two resident shards per worker, the
tied-weights arena), scheduled by a round-robin tournament. The circle
method makes every partition pair co-reside exactly once per sweep of
2W - 1 rounds, and its seat rotation is one fixed permutation (a forward
chain into slot 0, a backward chain into slot 1, a local crossover),
which `DeviceGroup.permute` carries. Relations stay replicated with a
summed-delta merge (the kGlobal protocol's scatter_sub accumulation,
solver.h:1410-1420); entity updates are always local to the resident
shards, except for the global pool's candidate gradients, which travel
to their owners by `reduce_scatter`.

Random draws: each worker draws from its own generator, seeded from
(seed, round, worker); `run_episode` also takes the draws as an input
(`episode_draws` makes them on the CPU), so tests can feed the
reference's and the card can be held against the CPU. Host numpy only
for the schedule and the block sort.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from graphvite_tpu_torch.ops.alias import (AliasTable, alias_draws,
                                           device_sample)
from graphvite_tpu_torch.ops.scatter import scatter_add_
from graphvite_tpu_torch.ops.steps import (kg_pool_groups,
                                           make_kg_pool_step,
                                           make_kg_train_step)
from graphvite_tpu_torch.optim import Optimizer, apply_row_updates
from graphvite_tpu_torch.parallel.mesh import DeviceGroup, _as_tensor


def _kg_step_draws(step_fn, batch_size, num_entity, generator):
    """The negatives a KG step draws for itself (`negatives`), from a CPU
    generator: the pooled step's [G, M] candidate ids, or the classic
    step's (cand_ids, corrupt_head) [B, K] over 2 V split ids."""
    shape = getattr(step_fn, "pool_shape", None)
    if shape is not None:
        return torch.randint(0, num_entity, shape, generator=generator)
    nid = torch.randint(0, 2 * num_entity,
                        (batch_size, step_fn.num_negative),
                        generator=generator)
    ch = nid < num_entity
    return torch.where(ch, nid, nid - num_entity), ch


class ReplicatedKGTrainer:
    """Naive-parallel KG training: replicated tables, summed deltas.

    step_fn: a KG step (`make_kg_train_step`, `make_kg_pool_step`).
    Positives: an alias draw over the edge weights (`init_edges`). Draws
    per worker and batch: (u [2, B] edge uniforms, negatives or None)."""

    def __init__(self, group: DeviceGroup, dim: int, step_fn, opt: Optimizer,
                 batch_size: int = 2048, ep_batches: int = 8):
        self.group = group
        self.dim = int(dim)
        self.step_fn = step_fn
        self.opt = opt
        self.batch_size = int(batch_size)
        self.ep_batches = int(ep_batches)

    def init_state(self, tables, moments=None):
        """(tables, moments) per worker from the canonical (entity,
        relation) tables (tensors or numpy) and, for resume, the canonical
        moments (one tuple per table; None: zeros). Moments are float32."""
        g = self.group
        if moments is None:
            moments = tuple((None,) * self.opt.num_moment for _ in tables)
        out_t, out_m = [None] * g.size, [None] * g.size
        for w in g.local:
            d = g.devices[w]
            ts = tuple(_as_tensor(t, d).clone() for t in tables)
            out_t[w] = ts
            out_m[w] = tuple(
                tuple(torch.zeros(t.shape, dtype=torch.float32, device=d)
                      if m is None else _as_tensor(m, d).float().clone()
                      for m in side)
                for t, side in zip(ts, moments))
        return out_t, out_m

    def init_edges(self, kg):
        """The edge alias table and the triplet arrays, once per distinct
        device: (prob, alias, heads, tails, relations)."""
        t = AliasTable(np.asarray(kg.edge_weights))
        arrays = (t.prob.astype(np.float32), t.alias.astype(np.int32),
                  np.asarray(kg.edge_heads, np.int32),
                  np.asarray(kg.edge_tails, np.int32),
                  np.asarray(kg.edge_relations, np.int32))
        return {d: tuple(torch.from_numpy(a).to(d) for a in arrays)
                for d in self.group.distinct}

    def episode_draws(self, generator, num_entity):
        """Every worker's draws of one episode from one CPU generator, on
        the CPU (`mesh.draws_to` moves them): [worker][batch] = (u [2, B],
        negatives)."""
        B = self.batch_size
        return [[(torch.rand((2, B), generator=generator),
                  _kg_step_draws(self.step_fn, B, num_entity, generator))
                 for _ in range(self.ep_batches)]
                for _ in range(self.group.size)]

    def run_episode(self, tables, moments, edge_arrays, batch_id0,
                    num_batch_total, seed, draws=None):
        """One episode of EP batches on every worker at lr =
        schedule(batch_id0 + i); the replicas then become start + the sum
        over workers of (replica - start). Returns (tables, moments,
        losses: per worker [EP] on its device)."""
        g = self.group
        B = self.batch_size
        gens = g.seed_generators(seed, 0)
        g.begin()
        W = g.size
        starts, deltas, moms, losses = ([None] * W for _ in range(4))
        for w in g.local:
            dev = g.devices[w]
            eprob, ealias, eheads, etails, erels = edge_arrays[dev]
            with g.worker(w), torch.no_grad():
                start = tuple(t.clone() for t in tables[w])
                st = {"tables": tables[w], "moments": moments[w]}
                ls = []
                for i in range(self.ep_batches):
                    lr = self.opt.schedule_lr(batch_id0 + i, num_batch_total)
                    if draws is None:
                        u = alias_draws((eprob, ealias), (B,), gens[w], dev)
                        negs = None
                    else:
                        u, negs = draws[w][i]
                    eid = device_sample(eprob, ealias, u[0], u[1])
                    st, loss = self.step_fn(st, eheads[eid], etails[eid],
                                            erels[eid], lr, negatives=negs,
                                            generator=gens[w])
                    ls.append(loss)
                deltas[w] = tuple(s - s0 for s, s0
                                  in zip(st["tables"], start))
                starts[w] = start
                moms[w] = st["moments"]
                losses[w] = torch.stack(ls)
        summed = [g.sum([d[k] if d is not None else None for d in deltas])
                  for k in range(len(starts[g.local[0]]))]
        out = [None] * W
        for w in g.local:
            with g.worker(w):
                out[w] = tuple(s0 + summed[k][w]
                               for k, s0 in enumerate(starts[w]))
        g.end()
        return out, moms, losses


class TripletBlocks:
    """A KG's triplets sorted into (head partition, tail partition) blocks
    of a 2W-part VertexPartition (reference kg.py:490-509): `arrays`
    {device: (heads, tails, relations)} as int32 local ids, once per
    distinct device; `block_off` [(2W)^2 + 1] the host's offsets of the
    blocks. It depends on the graph, the partition and the devices alone,
    so trainers of other optimizers or steps share it."""

    def __init__(self, kg, partition, devices):
        P2 = partition.num_partition
        h = np.asarray(kg.edge_heads)
        t = np.asarray(kg.edge_tails)
        r = np.asarray(kg.edge_relations)
        block = (partition.part_of[h].astype(np.int64) * P2
                 + partition.part_of[t])
        order = np.argsort(block, kind="stable")
        self.block_off = np.searchsorted(
            block[order], np.arange(P2 * P2 + 1)).astype(np.int64)
        del block
        arrays = (partition.local_of[h][order].astype(np.int32),
                  partition.local_of[t][order].astype(np.int32),
                  r[order].astype(np.int32))
        self.arrays = {d: tuple(torch.from_numpy(a).to(d) for a in arrays)
                       for d in devices}


class ShardedKGTrainer:
    """Tied-weights sharded KG training (see the module docstring).

    Layout, per worker: the entity arena [2, cap, D] (slots 0 and 1 hold
    two partition shards) and its moments of the same shape, always
    float32; the relation table [R, D] (replicated) and its moments (per
    worker, the reference's per-GPU moment caches).

    Seats: with M = 2W - 1 tournament seats plus one fixed seat F, worker
    0 holds (F, seat 0) and worker t holds (seat t, seat M - t). Rotating
    every seat i -> i + 1 (mod M) realizes all-pairs coverage and is the
    fixed permutation of `_transition`.

    Blocks trained in a round, per worker: (p0, p1) and (p1, p0); worker 0
    also trains the resident diagonals ((p1, p1) every round, and (F, F)
    once per sweep), so every (head part, tail part) block is trained
    once per sweep.

    Negatives (`negative_pool`; GRAPHVITE_KG_NEG_POOL in the solver):
    * "pooled": the shared-candidate step (`make_kg_pool_step`) on the
      arena, each group's pool drawn uniformly over the resident span;
    * "global": Q resident draws per worker, their rows all_gather'ed, the
      external-pool step over the W Q pool ids with split-id corruption;
      the candidate gradients (with squares and touch counts) are summed
      into pool space with kernel 1 and sent back to their owners by
      reduce_scatter, where apply_row_updates applies them (untouched
      pool rows routed to id 2 cap, so they drop). A collective every
      batch: the loop issues batch t on every worker before it;
    * anything else, "resident": the classic step with split-id
      corruption over the two resident slots.

    Draws per worker and batch: (u [B], negative draws): pooled un [G, M],
    global (up [Q], nid [B, K]), resident un [B, K]."""

    def __init__(self, group: DeviceGroup, partition, dim: int, model,
                 opt: Optimizer, num_negative: int = 8,
                 margin_or_l3: float = 12.0,
                 adversarial_temperature: float = 2.0,
                 relation_lr_multiplier: float = 1.0,
                 batch_size: int = 2048, ep_batches: int = 8,
                 negative_pool: str = "global", pool_size: int = None,
                 trust: float = 0.25):
        W = group.size
        if partition.num_partition != 2 * W:
            raise ValueError("tied weights need 2W partitions: %d for %d "
                             "workers" % (partition.num_partition, W))
        self.group = group
        self.partition = partition
        self.dim = int(dim)
        self.opt = opt
        self.batch_size = B = int(batch_size)
        self.ep_batches = int(ep_batches)
        self.num_worker = W
        self.M = 2 * W - 1
        self.cap = partition.capacity
        self.num_negative = K = int(num_negative)
        self.negative_pool = negative_pool
        if negative_pool == "pooled":
            target = int(os.environ.get("GRAPHVITE_KG_POOL_TARGET", 512))
            psize = int(pool_size) if pool_size else 0
            self.pool_groups = kg_pool_groups(B, target_group=target)
            self.step = make_kg_pool_step(
                model, opt, K, margin_or_l3, adversarial_temperature,
                relation_lr_multiplier, pool_size=psize,
                pool_groups=self.pool_groups, trust=trust)
            self.pool_size = self.step.pool_shape[1]
        else:
            if pool_size is None:
                pool_size = max(256, min(4096, -(-B * K // W)))
            self.pool_size = int(pool_size)
            self.step = make_kg_train_step(
                model, opt, K, margin_or_l3, adversarial_temperature,
                relation_lr_multiplier,
                external_pool=(negative_pool == "global"))
        self.sizes = np.bincount(partition.part_of,
                                 minlength=2 * W).astype(np.int64)
        self.reset_schedule()

    # -- the tournament schedule (host) --------------------------------------
    def reset_schedule(self):
        self.fixed = 0                              # partition at w0 slot 0
        self.seats = list(range(1, 2 * self.num_worker))
        self.round = 0

    def assignments(self):
        """Current (slot 0, slot 1) partition ids per worker."""
        W, M = self.num_worker, self.M
        out = [(self.fixed, self.seats[0])]
        for t in range(1, W):
            out.append((self.seats[t], self.seats[M - t]))
        return out

    def advance_schedule(self):
        self.seats = [self.seats[-1]] + self.seats[:-1]
        self.round += 1

    # -- state --------------------------------------------------------------
    def _arena(self, table, d):
        """Worker d's [2, cap, D] arena of the canonical [V, D] tensor."""
        p0, p1 = self.assignments()[d]
        dev = self.group.devices[d]
        return torch.stack([self.partition.shard_tensor(table, p).to(dev)
                            for p in (p0, p1)])

    def init_state(self, entity, relation, moments=None):
        """Per-worker state from the canonical [V, D] entity and [R, D]
        relation tables (tensors on any device, or numpy; the whole tables
        in every process; None for a worker of another process). `moments`
        ((entity moments...), (relation moments...)) canonical arrays seed
        the arena moments and every worker's relation moments: resume
        continues from the gathered ones (entities exactly; relations from
        the mean the workers restart with). None: zeros. Resets the
        schedule."""
        g = self.group
        self.reset_schedule()
        if moments is None:
            moments = ((None,) * self.opt.num_moment,) * 2
        e_moms, r_moms = moments
        src = _as_tensor(entity, g.home)
        shape = (2, self.cap, self.dim)
        state = {k: [None] * g.size
                 for k in ("arena", "arena_moms", "rel", "rel_moms")}
        for d in g.local:
            dev = g.devices[d]
            state["arena"][d] = self._arena(src, d)
            state["arena_moms"][d] = tuple(
                torch.zeros(shape, dtype=torch.float32, device=dev)
                if m is None else
                self._arena(_as_tensor(m, g.home).float(), d)
                for m in e_moms)
            rel = _as_tensor(relation, dev)
            state["rel"][d] = rel.clone()
            state["rel_moms"][d] = tuple(
                torch.zeros(rel.shape, dtype=torch.float32, device=dev)
                if m is None else _as_tensor(m, dev).float().clone()
                for m in r_moms)
        return state

    def init_triplets(self, kg):
        """The triplets sorted into (head partition, tail partition)
        blocks (`TripletBlocks`), for this trainer's partition and
        devices."""
        return TripletBlocks(kg, self.partition, self.group.distinct)

    # -- draws --------------------------------------------------------------
    def episode_draws(self, generator):
        """Every worker's draws of the next episode from one CPU
        generator, on the CPU (`mesh.draws_to` moves them):
        [worker][batch] = (u [B], negative draws)."""
        B, K, Q = self.batch_size, self.num_negative, self.pool_size
        W = self.num_worker
        out = []
        for _ in range(W):
            batches = []
            for _ in range(self.ep_batches):
                u = torch.rand(B, generator=generator)
                if self.negative_pool == "pooled":
                    neg = torch.rand(self.step.pool_shape,
                                     generator=generator)
                elif self.negative_pool == "global":
                    neg = (torch.rand(Q, generator=generator),
                           torch.randint(0, 2 * W * Q, (B, K),
                                         generator=generator))
                else:
                    neg = torch.rand((B, K), generator=generator)
                batches.append((u, neg))
            out.append(batches)
        return out

    def _draw(self, w, i, gens, draws):
        if draws is not None:
            return draws[w][i]
        dev = self.group.devices[w]
        B, K, Q = self.batch_size, self.num_negative, self.pool_size
        u = torch.rand(B, generator=gens[w], device=dev)
        if self.negative_pool == "pooled":
            neg = torch.rand(self.step.pool_shape, generator=gens[w],
                             device=dev)
        elif self.negative_pool == "global":
            neg = (torch.rand(Q, generator=gens[w], device=dev),
                   torch.randint(0, 2 * self.num_worker * Q, (B, K),
                                 generator=gens[w], device=dev))
        else:
            neg = torch.rand((B, K), generator=gens[w], device=dev)
        return u, neg

    # -- the episode --------------------------------------------------------
    def _blocks(self, w, diag_f, block_off):
        """Worker w's resident blocks this round, as host ints: per block
        (start - cum, head slot, tail slot), the cumulative sample counts
        `cum` [5] and the resident partition sizes (sz0, sz1)."""
        p0, p1 = self.assignments()[w]
        P2 = 2 * self.num_worker
        bh = (p0, p1, p1, p0)
        bt = (p1, p0, p1, p0)
        enabled = (True, p0 != p1, w == 0, w == 0 and diag_f)
        off = block_off
        starts = [int(off[a * P2 + b]) for a, b in zip(bh, bt)]
        ns = [int(off[a * P2 + b + 1]) - s if e else 0
              for a, b, s, e in zip(bh, bt, starts, enabled)]
        cum = [0]
        for n in ns:
            cum.append(cum[-1] + n)
        shift = [s - c for s, c in zip(starts, cum[:4])]
        return shift, cum, (int(self.sizes[p0]), int(self.sizes[p1]))

    def _positives(self, u, blocks, trip):
        """The batch's positives from uniforms u [B] over the resident
        blocks (kg.py:263-280): arena ids of heads and tails, relations,
        the head and tail slots and the mask."""
        shift, cum, _ = blocks
        cap = self.cap
        total = cum[4]
        trip_h, trip_t, trip_r = trip
        r = torch.clamp((u * max(total, 1)).long(), max=max(total - 1, 0))
        ge1, ge2, ge3 = ((r >= c).long() for c in cum[1:4])
        # the block index is ge1 + ge2 + ge3 (cum ascends), so per-block
        # values telescope over the three steps
        idx = (r + shift[0] + ge1 * (shift[1] - shift[0])
               + ge2 * (shift[2] - shift[1]) + ge3 * (shift[3] - shift[2]))
        # out-of-range gathers clamp, as the reference's do
        idx = torch.clamp(idx, 0, trip_h.shape[0] - 1)
        sh = ge1 - ge3                                  # (0, 1, 1, 0)
        st = 1 - ge1 + ge2 - ge3                        # (1, 0, 1, 0)
        h = sh * cap + trip_h[idx]
        t = st * cap + trip_t[idx]
        mask = torch.full(u.shape, 1.0 if total > 0 else 0.0,
                          device=u.device)
        return h, t, trip_r[idx], sh, st, mask

    def _span_ids(self, un, sz):
        """Arena ids of uniforms `un` over the resident span (both slots'
        live rows)."""
        span = max(sz[0] + sz[1], 1)
        rp = torch.clamp((un * span).long(), max=span - 1)
        slot = (rp >= sz[0]).long()
        return slot * self.cap + (rp - slot * sz[0])

    def run_episode(self, state, triplets, batch_id0, num_batch_total, seed,
                    draws=None):
        """One round: EP batches on every worker at lr = schedule(batch_id0
        + i W), the relation merge, the seat rotation. The input state is
        donated (updated in place, its arenas dropped). Returns (state,
        losses: per worker [EP] on its device)."""
        g = self.group
        W, cap, D = self.num_worker, self.cap, self.dim
        diag_f = self.round % self.M == 0
        gens = g.seed_generators(seed, self.round)
        g.begin()
        blocks = [self._blocks(w, diag_f, triplets.block_off)
                  for w in range(W)]
        rel0, st = [None] * W, [None] * W
        for w in g.local:
            with g.worker(w):
                rel0[w] = state["rel"][w].clone()
                st[w] = {"tables": (state["arena"][w].view(2 * cap, D),
                                    state["rel"][w]),
                         "moments": (tuple(m.view(2 * cap, D) for m in
                                           state["arena_moms"][w]),
                                     state["rel_moms"][w])}
        # the input state is donated: its arenas are updated in place, and
        # dropping them here lets each kind's old arenas go in the rotation
        state["arena"] = state["arena_moms"] = None
        losses = [[] for _ in range(W)]
        if self.negative_pool == "global":
            for i in range(self.ep_batches):
                self._global_batch(i, st, triplets, blocks, batch_id0,
                                   num_batch_total, gens, draws, losses)
        else:
            for w in g.local:
                trip = triplets.arrays[g.devices[w]]
                with g.worker(w), torch.no_grad():
                    for i in range(self.ep_batches):
                        lr = self.opt.schedule_lr(batch_id0 + i * W,
                                                  num_batch_total)
                        u, neg = self._draw(w, i, gens, draws)
                        h, t, r, sh, st_, mask = self._positives(
                            u, blocks[w], trip)
                        if self.negative_pool == "pooled":
                            negatives = self._span_ids(neg, blocks[w][2])
                        else:
                            negatives = self._resident_negatives(
                                neg, sh, st_, blocks[w][2])
                        st[w], loss = self.step(st[w], h, t, r, lr,
                                                mask=mask,
                                                negatives=negatives)
                        losses[w].append(loss)
        # relations: every worker's delta summed (GRAPHVITE_REL_MERGE=mean:
        # averaged)
        scale = (1.0 / W if os.environ.get("GRAPHVITE_REL_MERGE", "sum")
                 == "mean" else 1.0)
        deltas, rel_out = [None] * W, [None] * W
        for w in g.local:
            with g.worker(w):
                deltas[w] = st[w]["tables"][1] - rel0[w]
        summed = g.sum(deltas)
        for w in g.local:
            with g.worker(w):
                rel_out[w] = rel0[w] + scale * summed[w]

        def each(fn):
            return [fn(s) if s is not None else None for s in st]

        arena = each(lambda s: s["tables"][0].view(2, cap, D))
        arena_moms = each(lambda s: tuple(m.view(2, cap, D)
                                          for m in s["moments"][0]))
        rel_moms = each(lambda s: tuple(s["moments"][1]))
        del st, deltas, summed
        # the seat rotation moves the arenas and their moments, one kind
        # at a time (each kind's old arenas go as its new ones come)
        arena = self._transition(arena)
        n_mom = self.opt.num_moment
        moved = []
        for m in range(n_mom):
            moved.append(self._transition(
                [am[m] if am is not None else None for am in arena_moms]))
            arena_moms = [am[:m] + (None,) + am[m + 1:]
                          if am is not None else None for am in arena_moms]
        g.end()
        self.advance_schedule()
        state = {"arena": arena,
                 "arena_moms": [tuple(moved[m][w] for m in range(n_mom))
                                if g.is_local(w) else None
                                for w in range(W)],
                 "rel": rel_out, "rel_moms": rel_moms}
        return state, [torch.stack(ls) if g.is_local(w) else None
                       for w, ls in enumerate(losses)]

    def _resident_negatives(self, un, sh, st, sz):
        """Split-id corruption over the two resident slots (kg.py:343-358):
        a draw below the head slot's size replaces the head."""
        cap = self.cap
        s_h = sz[0] + sh * (sz[1] - sz[0])              # [B]
        s_t = sz[0] + st * (sz[1] - sz[0])
        span = torch.clamp(s_h + s_t, min=1)[:, None]
        rr = torch.minimum((un * span).long(), span - 1)
        ch = rr < s_h[:, None]
        cand_slot = torch.where(ch, sh[:, None], st[:, None])
        cand_local = torch.where(ch, rr, rr - s_h[:, None])
        return cand_slot * cap + cand_local, ch

    def _global_batch(self, i, st, triplets, blocks, batch_id0,
                      num_batch_total, gens, draws, losses):
        """Batch i of the global pool on every worker (kg.py:296-342)."""
        g = self.group
        W, cap, Q = self.num_worker, self.cap, self.pool_size
        WQ = W * Q
        lr = self.opt.schedule_lr(batch_id0 + i * W, num_batch_total)
        n_mom = self.opt.num_moment
        ctx, rows, sums = [None] * W, [None] * W, [None] * W
        for w in g.local:
            with g.worker(w), torch.no_grad():
                u, (up, nid) = self._draw(w, i, gens, draws)
                h, t, r, _, _, mask = self._positives(
                    u, blocks[w], triplets.arrays[g.devices[w]])
                pool_arena = self._span_ids(up, blocks[w][2])     # [Q]
                rows[w] = st[w]["tables"][0][pool_arena]
                ctx[w] = (h, t, r, mask, nid, pool_arena)
        pools = g.all_gather(rows)                              # [W Q, D]
        for w in g.local:
            h, t, r, mask, nid, _ = ctx[w]
            with g.worker(w), torch.no_grad():
                ch = nid < WQ
                idx = torch.where(ch, nid, nid - WQ)
                st[w], loss, cand_grad = self.step(
                    st[w], h, t, r, lr, mask=mask,
                    pool=(pools[w], idx, ch))
                losses[w].append(loss)
                B, K, D = cand_grad.shape
                gr = cand_grad.reshape(B * K, D)
                act = mask[:, None].expand(B, K).reshape(-1, 1)
                cols = [gr] + ([gr * gr] if n_mom else []) + [act]
                # pad to a multiple of 4 columns (the kernel's vector path)
                pad = -((2 if n_mom else 1) * D + 1) % 4
                if pad:
                    cols.append(gr.new_zeros((B * K, pad)))
                acc = torch.zeros((WQ, sum(c.shape[1] for c in cols)),
                                  device=gr.device)
                sums[w] = scatter_add_(acc, idx.reshape(-1),
                                       torch.cat(cols, dim=1))
        mine = g.reduce_scatter(sums)                           # [Q, C]
        for w in g.local:
            pool_arena = ctx[w][5]
            with g.worker(w), torch.no_grad():
                D = self.dim
                my_g = mine[w][:, :D]
                my_sq = mine[w][:, D:2 * D] if n_mom else None
                my_cnt = mine[w][:, (2 if n_mom else 1) * D]
                ent, rel = st[w]["tables"]
                e_m, r_m = st[w]["moments"]
                upd_ids = torch.where(my_cnt > 0, pool_arena,
                                      torch.full_like(pool_arena, 2 * cap))
                ent, e_m = apply_row_updates(ent, e_m, upd_ids, my_g,
                                             self.opt, lr,
                                             entry_counts=my_cnt,
                                             entry_sqs=my_sq)
                st[w] = {"tables": (ent, rel), "moments": (e_m, r_m)}

    def _transition(self, xs):
        """The seat rotation i -> i + 1 (mod M) on per-worker [2, cap, D]
        tensors: a forward chain into slot 0 (worker 0 feeds its slot 1),
        a backward chain into slot 1, and a local slot 0 -> slot 1
        crossover at worker W - 1 (kg.py:403-426)."""
        g, W = self.group, self.num_worker
        if W == 1:
            return xs
        fwd = [(d, d + 1) for d in range(W - 1)]
        bwd = [(d, d - 1) for d in range(1, W)]
        got_fwd = g.permute([(x[1] if w == 0 else x[0]) if x is not None
                             else None for w, x in enumerate(xs)], fwd)
        got_bwd = g.permute([x[1] if x is not None else None for x in xs],
                            bwd)
        out = [None] * W
        for w in g.local:
            x = xs[w]
            with g.worker(w):
                out[w] = torch.stack([x[0] if w == 0 else got_fwd[w],
                                      x[0] if w == W - 1 else got_bwd[w]])
        return out

    # -- gathering ----------------------------------------------------------
    def _gather(self, parts, dtype, device):
        """Per-worker [2, cap, D] arenas -> the canonical [V, D] tensor on
        `device`, through the current seat map; across processes every
        worker's arena comes to every process (a collective)."""
        part = self.partition
        parts = self.group.collect(parts)
        out = torch.empty((part.part_of.shape[0], self.dim), dtype=dtype,
                          device=device)
        for d, (a, b) in enumerate(self.assignments()):
            for s, p in enumerate((a, b)):
                m = int(part.sizes[p])
                out.index_copy_(0, part.member_ids(p, device),
                                parts[d][s, :m].to(device))
        return out

    def gather_entities(self, state, device=None):
        """The [V, D] entity table on `device` (the first local worker's
        by default), in every process."""
        device = device or self.group.home
        dtype = state["arena"][self.group.local[0]].dtype
        return self._gather(state["arena"], dtype, device)

    def gather_entity_moments(self, state, device=None):
        """The canonical [V, D] float32 entity moments."""
        device = device or self.group.home
        return tuple(self._gather([am[m] if am is not None else None
                                   for am in state["arena_moms"]],
                                  torch.float32, device)
                     for m in range(self.opt.num_moment))

    def gather_relation_moments(self, state, device=None):
        """The workers' relation moments as their mean: the canonical
        summary a resumed run restarts every worker from (the reference
        keeps them per device and never merges them)."""
        device = device or self.group.home
        W = self.num_worker
        out = []
        for m in range(self.opt.num_moment):
            every = self.group.collect([rm[m] if rm is not None else None
                                        for rm in state["rel_moms"]])
            out.append(torch.stack([x.to(device) for x in every]).mean(dim=0)
                       if W > 1 else every[0].to(device))
        return tuple(out)
