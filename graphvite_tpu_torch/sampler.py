"""Host-side positive-sample pipelines in vectorized numpy (the port of
graphvite_tpu/sampler.py, `sampler_backend="host"`).

The reference's CPU sampler threads (include/core/solver.h:903-1146
SamplerMixin, instance/graph.cuh:283-451 GraphSampler) become samplers
that produce whole *pools* of samples as flat numpy arrays, which the
solver uploads and trains over in one runner call
(`ops/steps.py:make_pool_runner`). A background thread double-buffers
pool production against device compute (the 2-pool pipeline of
solver.h:417-462, 629-648).

Statistical behavior preserved:
* positive edges drawn from a global alias table over edge weights;
* DeepWalk/LINE walks: per-vertex alias tables over out-edge weights
  (graph.cuh:376-450), walks truncated at dead ends;
* node2vec: per-edge second-order alias tables with p/q bias
  (graph.cuh:298-373, build at graph.cuh:657-681);
* every pair within `augmentation_step` hops is a positive sample;
* pseudo-shuffle interleaving at stride pool/base (graph.cuh:362-364).

The draws come from `np.random.default_rng(seed)` streams, in the
reference's order, so a pool equals the reference's from the same seed
bit for bit.
"""
from __future__ import annotations

import queue as _queue
import threading
import time

import numpy as np

from graphvite_tpu_torch.ops.alias import AliasTable, PackedAliasTables
from graphvite_tpu_torch.utils.common import logger


def pseudo_shuffle(arrays, base: int):
    """out[o % base * (n/base) + o // base] = in[o]  (graph.cuh:362-364)."""
    if base <= 1:
        return arrays
    n = arrays[0].shape[0]
    usable = (n // base) * base
    out = []
    for a in arrays:
        head = a[:usable].reshape(usable // base, base).T.reshape(-1)
        out.append(np.concatenate([head, a[usable:]]) if usable < n else head)
    return out


def _host(x):
    """A graph array as numpy (KNN graphs keep theirs as tensors on their
    device)."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class EdgeSampler:
    """Plain positive-edge sampler (LINE aug=1 / KG / LargeVis); the analog of
    SamplerMixin::sample (solver.h:1012-1055) minus partition bookkeeping."""

    def __init__(self, graph, seed=0, with_relation=False):
        self.graph = graph
        self.rng = np.random.default_rng(seed)
        self.with_relation = with_relation
        self.edge_table = AliasTable(_host(graph.edge_weights))
        self.heads = _host(graph.edge_heads)
        self.tails = _host(graph.edge_tails)
        self.rels = _host(graph.edge_relations) if with_relation else None

    def pool(self, pool_size: int):
        eids = self.edge_table.sample(self.rng, pool_size)
        heads = self.heads[eids].astype(np.int32)
        tails = self.tails[eids].astype(np.int32)
        if self.with_relation:
            return heads, tails, self.rels[eids].astype(np.int32)
        return heads, tails


def second_order_entries(graph):
    """Entries of node2vec's second-order table: one per (directed edge,
    neighbour of its tail), the sum of deg(tail) over the edges."""
    return int(np.asarray(graph.degrees, np.int64)[graph.edge_tails].sum())


class RandomWalkSampler:
    """DeepWalk / LINE random-walk sampler with augmentation
    (graph.cuh:376-450). node2vec is the `biased=True` variant
    (graph.cuh:298-373)."""

    def __init__(self, graph, augmentation_step, random_walk_length=40,
                 random_walk_batch_size=100, shuffle_base=1, seed=0,
                 biased=False, p=1.0, q=1.0):
        self.graph = graph
        self.augmentation_step = int(augmentation_step)
        self.walk_length = int(random_walk_length)
        self.walk_batch = max(int(random_walk_batch_size), 256)
        self.shuffle_base = max(int(shuffle_base), 1)
        self.rng = np.random.default_rng(seed)
        self.biased = biased
        self.edge_table = AliasTable(graph.edge_weights)
        if biased:
            self._build_second_order(p, q)
        else:
            # per-vertex alias tables over out-edge weights; uniform graphs
            # skip the alias indirection entirely
            w = graph.csr_weights
            if not w.size or np.all(w == w[0]):
                self.vertex_tables = PackedAliasTables.uniform_tables(
                    graph.indptr)
            else:
                self.vertex_tables = PackedAliasTables(w, graph.indptr)

    def _build_second_order(self, p, q):
        """Per-directed-edge tables over the tail's out-edges, reweighted:
        w/p back to the source, w to common neighbors, w/q otherwise
        (graph.cuh:663-672)."""
        g = self.graph
        deg = g.degrees
        tail_deg = deg[g.edge_tails]
        offsets = np.zeros(g.num_directed_edge + 1, dtype=np.int64)
        np.cumsum(tail_deg, out=offsets[1:])
        total = int(offsets[-1])
        logger.info("node2vec: building %d second-order alias entries", total)
        # flat slots: for edge e = (u, v), neighbor slot k -> x =
        # indices[indptr[v] + k]
        e_of_slot = np.repeat(np.arange(g.num_directed_edge), tail_deg)
        k_of_slot = np.arange(total) - offsets[e_of_slot]
        v_of_slot = g.edge_tails[e_of_slot]
        flat = g.indptr[v_of_slot] + k_of_slot
        x = g.indices[flat]
        w = g.csr_weights[flat].astype(np.float64)
        u = g.edge_heads[e_of_slot]
        # membership test x in N(u) via sorted directed-edge keys
        keys = np.sort(g.edge_heads * g.num_vertex + g.edge_tails)
        probe = x * g.num_vertex + u  # x -> u edge exists <=> u in N(x)
        # reference tests `neighbors[x].find(u)` (graph.cuh:668): u in N(x)
        pos = np.searchsorted(keys, probe)
        pos = np.minimum(pos, keys.size - 1)
        is_common = keys[pos] == probe
        is_return = x == u
        w = np.where(is_return, w / p, np.where(is_common, w, w / q))
        self.edge_tables = PackedAliasTables(w, offsets)
        self._slot_flat_base = None  # slots map directly through CSR

    def _walk_batch(self, num_walks):
        """Vectorized batch of walks; returns chains [W, L+1] int64 and
        lengths [W] (chain[i, :len+1] valid)."""
        g = self.graph
        L = self.walk_length
        rng = self.rng
        eids = self.edge_table.sample(rng, num_walks)
        chains = np.zeros((num_walks, L + 1), dtype=np.int64)
        chains[:, 0] = g.edge_heads[eids]
        chains[:, 1] = g.edge_tails[eids]
        lengths = np.full(num_walks, L, dtype=np.int64)
        current = chains[:, 1].copy()
        cur_eid = eids.copy() if self.biased else None
        deg = g.degrees
        alive = deg[current] > 0
        for j in range(2, L + 1):
            dead = ~alive
            cut = dead & (lengths == L)
            lengths[cut] = np.minimum(lengths[cut], j - 1)
            if not alive.any():
                break
            idx = np.nonzero(alive)[0]
            cur = current[idx]
            u1 = rng.random(idx.size)
            u2 = rng.random(idx.size)
            if self.biased:
                local = self.edge_tables.sample(cur_eid[idx], u1, u2)
            else:
                local = self.vertex_tables.sample(cur, u1, u2)
            nxt_flat = g.indptr[cur] + local
            nxt = g.indices[nxt_flat]
            chains[idx, j] = nxt
            if self.biased:
                cur_eid[idx] = g.csr_edge_ids[nxt_flat]
            current[idx] = nxt
            alive[idx] = deg[nxt] > 0
            # a walk that just moved still counts this step; it dies next step
        return chains, lengths

    def pool(self, pool_size: int):
        """Emit >= pool_size (head, tail) pairs from walks, truncate,
        pseudo-shuffle."""
        heads_out = []
        tails_out = []
        collected = 0
        while collected < pool_size:
            chains, lengths = self._walk_batch(self.walk_batch)
            for k in range(1, self.augmentation_step + 1):
                # pairs (chain[j], chain[j+k]) for j + k <= length
                L = self.walk_length
                if k > L:
                    break
                js = np.arange(0, L + 1 - k)
                h = chains[:, :L + 1 - k]
                t = chains[:, k:]
                valid = js[None, :] + k <= lengths[:, None]
                heads_out.append(h[valid])
                tails_out.append(t[valid])
                collected += int(valid.sum())
        heads = np.concatenate(heads_out)[:pool_size].astype(np.int32)
        tails = np.concatenate(tails_out)[:pool_size].astype(np.int32)
        heads, tails = pseudo_shuffle([heads, tails], self.shuffle_base)
        return heads, tails


class PrefetchingPool:
    """Double-buffered pool pipeline: a background thread produces the next
    pool while the device consumes the current one (the 2-pool design of
    solver.h:124, 417-462)."""

    def __init__(self, sampler, pool_size, depth=2):
        self.sampler = sampler
        self.pool_size = pool_size
        self.queue = _queue.Queue(maxsize=depth)
        self._stop = False
        # seconds the thread spent making pools, and the caller waiting in
        # next() (whether the loop is host-bound)
        self.produce_s = 0.0
        self.wait_s = 0.0
        self.pools = 0
        self.thread = threading.Thread(target=self._work, daemon=True)
        self.thread.start()

    def _work(self):
        try:
            while not self._stop:
                t0 = time.perf_counter()
                pool = self.sampler.pool(self.pool_size)
                self.produce_s += time.perf_counter() - t0
                self.pools += 1
                self.queue.put(pool)
        except Exception as e:  # pragma: no cover
            logger.error("sampler thread failed: %s", e)
            self.queue.put(e)

    def next(self):
        t0 = time.perf_counter()
        item = self.queue.get()
        self.wait_s += time.perf_counter() - t0
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        """Stop the thread: drain the queue until it has left its loop (it
        finishes the pool it is making, so this waits that long)."""
        self._stop = True
        while True:
            try:
                while True:
                    self.queue.get_nowait()
            except _queue.Empty:
                pass
            self.thread.join(timeout=0.05)
            if not self.thread.is_alive():
                return
