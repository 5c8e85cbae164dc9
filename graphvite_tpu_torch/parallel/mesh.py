"""Multi-device training: vertex partitions, the worker group and its
collectives, and the episode engines (the port of
graphvite_tpu/parallel/mesh.py).

The reference drives a `jax.sharding.Mesh` from one controller; its
collectives are `ppermute` (the ring, the KG seat rotation), `all_to_all`
(the walk engine's row routing), `psum` (the replicated merge) and
`all_gather` / `psum_scatter` (the KG engine's global negative pool). The
port keeps that design: a `DeviceGroup` holds W workers, each with its
own `torch.device`, on CUDA its own stream, and its own
`torch.Generator`; the collectives are functions over lists of
per-worker tensors (`ring_shift`, `permute`, `all_to_all`, `sum`,
`all_gather`, `reduce_scatter`). Workers may share a device
(`device_ids=[0, 0]`): the ring then renames list entries and copies
nothing. With GRAPHVITE_COORDINATOR set, the group spans processes, as
the reference's mesh spans hosts: each process holds its own workers,
and the collectives carry what crosses a process boundary over
`torch.distributed` (gloo, or NCCL between cards of their own).

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
import time

import numpy as np
import torch

from graphvite_tpu_torch.ops.alias import (AliasTable, PackedAliasTables,
                                           alias_draws, device_sample)
from graphvite_tpu_torch.ops.blocked import _pick_edges
from graphvite_tpu_torch.ops.steps import (_logistic_terms,
                                           graph_pool_groups,
                                           make_graph_banded_core,
                                           make_graph_pool_step,
                                           walk_shift_fwd)
from graphvite_tpu_torch.ops.scatter import scatter_add_
from graphvite_tpu_torch.ops.device_sampler import (DeviceWalkSampler,
                                                    walk_offsets)
from graphvite_tpu_torch.optim import Optimizer, apply_row_updates
from graphvite_tpu_torch.utils import tracing
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


DIST_TIMEOUT_S = 600      # a peer that never comes fails, not hangs


def _join_processes():
    """Join the process group of GRAPHVITE_COORDINATOR=host:port,
    GRAPHVITE_NUM_PROCESSES and GRAPHVITE_PROCESS_ID (the reference's
    make_mesh calls jax.distributed.initialize from them), once per
    process; a missing variable raises KeyError as the reference's does.
    The group is gloo's: the workers' tensors cross it through host
    buffers, or a NCCL group made beside it (`DeviceGroup`)."""
    import datetime

    import torch.distributed as dist

    if dist.is_initialized():
        return
    coord = os.environ["GRAPHVITE_COORDINATOR"]
    world = int(os.environ["GRAPHVITE_NUM_PROCESSES"])
    rank = int(os.environ["GRAPHVITE_PROCESS_ID"])
    host, _, port = coord.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError("GRAPHVITE_COORDINATOR must be host:port, not %r"
                         % coord)
    if not 0 <= rank < world:
        raise ValueError("GRAPHVITE_PROCESS_ID %d is not in [0, %d)"
                         % (rank, world))
    dist.init_process_group(
        "gloo", init_method="tcp://%s:%s" % (host, port), world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))


_NCCL = {}                 # the NCCL group of this process, made once


def _card_id(device):
    """A name of the card behind a CUDA device that no other card on any
    host shares."""
    return str(torch.cuda.get_device_properties(device).uuid)


class DeviceGroup:
    """W workers (the port of make_mesh, which builds the reference's
    jax.sharding.Mesh): worker i runs on `devices[i]`, on CUDA on a
    stream of its own, and draws from a generator of its own. Workers may
    share a device.

    Several processes: with GRAPHVITE_COORDINATOR set, the group joins
    the process group of that address (`_join_processes`) and spans every
    process; `devices` are then this process's workers. The processes
    tell each other their counts, and the global worker order is
    process-major, process 0's workers first, as jax.devices() orders
    them. Every list of per-worker values is indexed by the global worker:
    `size` is the global W, `local` the range of workers held here, and a
    remote worker's entry of `devices`, `streams`, `generators`, of a
    collective's input and of its output is None. An engine loops over
    `local` and never touches a remote worker's state. Every process
    calls the same collectives in the same order, each worker's tensor of
    the same shape and dtype (the reference's SPMD contract).

    Transport across processes (`transport`): "nccl" when every process's
    workers sit on cards that no other process uses, else "gloo" (CPU
    workers, or two processes on one card, which NCCL refuses). gloo
    carries host tensors: a CUDA tensor goes to a pinned host buffer on
    its worker's stream, the host waits for that copy, gloo moves the
    bytes, and a copy onto the destination worker's stream brings them
    back. NCCL moves device tensors on a stream of the group's, ordered
    after the sources' streams and before the destinations'. The
    collectives only copy: every sum adds in worker order on each
    receiver, so W workers over several processes hold the bits of W
    workers in one.

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
      (psum_scatter, tiled);
    * collect(xs): every worker's tensor in every process (remote ones as
      received copies), readable on the current streams;
      `gather_values(xs)` stacks them on the CPU (process_allgather).
    """

    def __init__(self, devices):
        local = [torch.device(d) for d in devices]
        if not local:
            raise ValueError("a device group needs at least one worker")
        self.on_cuda = local[0].type == "cuda"
        if any((d.type == "cuda") != self.on_cuda for d in local):
            raise ValueError("workers on CUDA and on the CPU cannot mix: %r"
                             % (local,))
        if self.on_cuda:
            local = [torch.device("cuda", d.index if d.index is not None
                                  else 0) for d in local]
        self.process, self.num_process = 0, 1
        self.transport = None
        counts = [len(local)]
        if os.environ.get("GRAPHVITE_COORDINATOR"):
            counts = self._join(local)
        self.counts = counts
        self.size = sum(counts)
        lo = sum(counts[:self.process])
        self.local = range(lo, lo + len(local))
        self.owner = [p for p, c in enumerate(counts) for _ in range(c)]
        self.devices = [None] * self.size
        self.devices[lo:lo + len(local)] = local
        self.home = local[0]
        self.streams = [None] * self.size
        self.generators = [None] * self.size
        for i in self.local:
            d = self.devices[i]
            if self.on_cuda:
                self.streams[i] = torch.cuda.Stream(device=d)
            self.generators[i] = torch.Generator(device=d)
        # the distinct devices of this process, in worker order
        # (replicated arrays)
        self.distinct = list(dict.fromkeys(local))
        # cross-process traffic: exchanges, bytes sent, and host seconds
        # from the sources' readiness to the last byte's arrival, of which
        # `stage_s` went to the copies into host buffers (gloo on CUDA)
        self.comm = {"exchanges": 0, "bytes": 0, "seconds": 0.0,
                     "stage_s": 0.0}

    def _join(self, local):
        """Join the processes and agree on the counts and the transport;
        returns every process's worker count."""
        import datetime

        import torch.distributed as dist

        _join_processes()
        self.process = dist.get_rank()
        self.num_process = dist.get_world_size()
        cards = (sorted({_card_id(d) for d in local}) if self.on_cuda
                 else [])
        infos = [None] * self.num_process
        dist.all_gather_object(infos, (len(local), self.on_cuda, cards))
        if any(info[1] != self.on_cuda for info in infos):
            raise ValueError("workers on CUDA and on the CPU cannot mix "
                             "across processes: %r" % (infos,))
        seen = [c for info in infos for c in info[2]]
        self.transport = ("nccl" if self.on_cuda
                          and len(seen) == len(set(seen)) else "gloo")
        if self.transport == "nccl":
            torch.cuda.set_device(local[0])
            if "group" not in _NCCL:
                _NCCL["group"] = dist.new_group(
                    backend="nccl",
                    timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
                # the group's first call is a barrier, not a batch of
                # point-to-point messages (which need every rank in the
                # first call)
                dist.barrier(group=_NCCL["group"],
                             device_ids=[local[0].index])
            self.comm_stream = torch.cuda.Stream(device=local[0])
        logger.info("device group: %d workers over %d processes (%d here, "
                    "process %d), transport %s", sum(i[0] for i in infos),
                    self.num_process, len(local), self.process,
                    self.transport)
        return [info[0] for info in infos]

    def __len__(self):
        return self.size

    def is_local(self, i):
        return self.devices[i] is not None

    def worker(self, i):
        """Context in which worker i's work is issued (its stream)."""
        if not self.on_cuda:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.streams[i])

    def seed_generators(self, seed, rotation):
        """Seed each local worker's generator from (seed, rotation, global
        worker): W workers draw alike over any number of processes."""
        for i in self.local:
            self.generators[i].manual_seed(worker_seed(seed, rotation, i))
        return self.generators

    def begin(self):
        """Order every worker's stream after the work issued so far on its
        device's current stream (the state it starts from)."""
        if self.on_cuda:
            for i in self.local:
                self.streams[i].wait_stream(
                    torch.cuda.current_stream(self.devices[i]))

    def end(self):
        """Order each device's current stream after its workers' streams
        (the caller reads what the workers wrote)."""
        if self.on_cuda:
            for i in self.local:
                torch.cuda.current_stream(self.devices[i]).wait_stream(
                    self.streams[i])

    def _events(self):
        if not self.on_cuda:
            return None
        return [s.record_event() if s is not None else None
                for s in self.streams]

    def _fetch(self, x, i, j, events):
        """Worker i's tensor `x` made readable on worker j (both local)."""
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

    # -- across processes ----------------------------------------------------

    def _exchange(self, msgs):
        """Send and receive one collective's cross-process messages. `msgs`
        lists (source worker, destination process, tensor, like, key) in
        one order that every process enumerates alike: `tensor` the
        source's (read on the sending process), `like` a local tensor of
        the received shape and dtype (read on the receiving one). Returns
        {key: the received tensor} for this process's receives, staged: a
        host tensor under gloo, a tensor on `home` written on the group's
        stream under NCCL (`_land` brings it to a worker)."""
        me = self.process
        sends = [(k, m) for k, m in enumerate(msgs)
                 if self.owner[m[0]] == me and m[1] != me]
        recvs = [(k, m) for k, m in enumerate(msgs)
                 if m[1] == me and self.owner[m[0]] != me]
        if not sends and not recvs:
            return {}
        import torch.distributed as dist

        nccl = self.transport == "nccl"
        srcs = sorted({m[0] for _, m in sends})
        if self.on_cuda and not nccl:
            # the sources' work done: what follows is the transfer's time
            for i in srcs:
                self.streams[i].synchronize()
        t0 = time.perf_counter()
        if nccl:
            comm = self.comm_stream
            for i in srcs:
                comm.wait_stream(self.streams[i])
        ops, nbytes, got = [], 0, {}
        for k, (i, q, x, _, _) in sends:
            if nccl:
                # on `home`, ordered after the source's stream
                with torch.cuda.stream(self.streams[i]), \
                        torch.cuda.stream(comm):
                    x = x.to(self.home, non_blocking=True).contiguous()
                x.record_stream(comm)
            elif self.on_cuda:
                with torch.cuda.stream(self.streams[i]):
                    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                    h.copy_(x, non_blocking=True)
                x = h
            else:
                x = x.contiguous()
            ops.append((k, dist.isend, x, q))
        if self.on_cuda and not nccl:
            for i in srcs:                # the host buffers are written
                self.streams[i].synchronize()
        self.comm["stage_s"] += time.perf_counter() - t0
        with (torch.cuda.stream(comm) if nccl
              else contextlib.nullcontext()):
            for k, (i, _, _, like, key) in recvs:
                y = torch.empty(like.shape, dtype=like.dtype,
                                device=self.home if nccl else "cpu",
                                pin_memory=self.on_cuda and not nccl)
                got[key] = y
                ops.append((k, dist.irecv, y, self.owner[i]))
            # every tensor travels as its bytes, the ops in message order
            # on both sides (gloo matches them by tag, NCCL by order)
            group = _NCCL["group"] if nccl else None
            p2p = []
            for k, fn, t, peer in sorted(ops, key=lambda op: op[0]):
                flat = t.reshape(-1).view(torch.uint8)
                if fn is dist.isend:
                    nbytes += flat.numel()
                p2p.append(dist.P2POp(fn, flat, peer, group=group, tag=k))
            for work in dist.batch_isend_irecv(p2p):
                work.wait()
        self.comm["exchanges"] += 1
        self.comm["bytes"] += nbytes
        self.comm["seconds"] += time.perf_counter() - t0
        return got

    def _land(self, y, j):
        """A received tensor (`_exchange`) made readable on local worker j."""
        if not self.on_cuda:
            return y
        dst = self.streams[j]
        if self.transport == "nccl":
            dst.wait_stream(self.comm_stream)
            y.record_stream(dst)
            if self.devices[j] == self.home:
                return y
            with torch.cuda.stream(self.comm_stream), torch.cuda.stream(dst):
                return y.to(self.devices[j], non_blocking=True)
        with torch.cuda.stream(dst):
            return y.to(self.devices[j], non_blocking=True)

    def _local(self, x, i):
        return x if self.is_local(i) else None

    def _routed(self, pairs, xs, likes):
        """Worker j of each (source i, destination j) of `pairs` receives
        `xs[i, j]` (a callable): local pairs by `_fetch`, the others as
        messages; likes(j, i) the received shape on a local j. Returns
        {(i, j): tensor readable on j} for the local destinations."""
        ev = self._events()
        msgs = [(i, self.owner[j], xs(i, j) if self.is_local(i) else None,
                 likes(j, i) if self.is_local(j) else None, (i, j))
                for i, j in pairs if self.owner[i] != self.owner[j]]
        got = self._exchange(msgs)
        return {(i, j): (self._fetch(xs(i, j), i, j, ev) if self.is_local(i)
                         else self._land(got[i, j], j))
                for i, j in pairs if self.is_local(j)}

    def _remote(self, xs):
        """Every remote worker's tensor, received once in this process:
        {worker: the staged tensor} (`_exchange`)."""
        like = xs[self.local[0]]
        return self._exchange([(i, q, self._local(xs[i], i), like, i)
                               for i in range(self.size)
                               for q in range(self.num_process)
                               if q != self.owner[i]])

    def _everyone(self, xs):
        """Every worker's tensor on every local worker: {j: [the P
        tensors readable on j]}; a remote one is landed on each local
        worker."""
        ev = self._events()
        got = self._remote(xs)
        return {j: [self._fetch(xs[i], i, j, ev) if self.is_local(i)
                    else self._land(got[i], j) for i in range(self.size)]
                for j in self.local}

    @contextlib.contextmanager
    def spans(self, name):
        """A span of `name` on every local worker, each on its worker's
        stream (utils/tracing.py): its device seconds are that worker's
        card's time from the work issued before the block to the block's
        last work, per card. Nothing is recorded without a session."""
        opened = []
        for i in self.local:
            with self.worker(i):
                opened.append((i, tracing.span(name,
                                               device=self.devices[i])))
        try:
            yield
        finally:
            for i, sp in reversed(opened):
                with self.worker(i):
                    sp.__exit__(None, None, None)

    # each collective runs in a span of its name on every worker (mesh::...,
    # a profiler range under a profiler: utils/tracing.py), so a trace
    # shows its copies' device time on each card

    def ring_shift(self, xs):
        P = self.size
        if P == 1:
            return list(xs)
        with self.spans("mesh::ring_shift"):
            pairs = [((j + 1) % P, j) for j in range(P)]
            got = self._routed(pairs, lambda i, j: xs[i],
                               lambda j, i: xs[j])
            out = [None] * P
            for (i, j), x in got.items():
                out[j] = x
            return out

    def all_to_all(self, chunks):
        P = self.size
        if P == 1:
            return list(chunks)
        with self.spans("mesh::all_to_all"):
            pairs = [(i, j) for i in range(P) for j in range(P)]
            got = self._routed(pairs, lambda i, j: chunks[i][j],
                               lambda j, i: chunks[j][i])
            out = [None] * P
            for j in self.local:
                with self.worker(j):
                    out[j] = torch.stack([got[i, j] for i in range(P)])
            return out

    def sum(self, xs):
        P = self.size
        if P == 1:
            return list(xs)
        with self.spans("mesh::sum"):
            out = [None] * P
            for j, parts in self._everyone(xs).items():
                with self.worker(j):
                    acc = parts[0].clone()
                    for p in parts[1:]:
                        acc += p
                out[j] = acc
            return out

    def permute(self, xs, pairs):
        P = self.size
        src_of = {int(j): int(i) for i, j in pairs}
        if P == 1:
            return [xs[0] if 0 in src_of else xs[0].new_zeros(()).expand_as(
                xs[0])]
        with self.spans("mesh::permute"):
            got = self._routed([(i, j) for j, i in sorted(src_of.items())],
                               lambda i, j: xs[i], lambda j, i: xs[j])
            out = [None] * P
            for j in self.local:
                if j in src_of:
                    out[j] = got[src_of[j], j]
                else:
                    with self.worker(j):
                        out[j] = xs[j].new_zeros(()).expand_as(xs[j])
            return out

    def all_gather(self, xs):
        P = self.size
        if P == 1:
            return list(xs)
        with self.spans("mesh::all_gather"):
            out = [None] * P
            for j, parts in self._everyone(xs).items():
                with self.worker(j):
                    out[j] = torch.cat(parts)
            return out

    def reduce_scatter(self, xs):
        P = self.size
        if P == 1:
            return list(xs)
        with self.spans("mesh::reduce_scatter"):
            C = xs[self.local[0]].shape[0] // P

            def chunk(i, j):
                return xs[i][j * C:(j + 1) * C]

            pairs = [(i, j) for i in range(P) for j in range(P)]
            got = self._routed(pairs, chunk, lambda j, i: chunk(j, j))
            out = [None] * P
            for j in self.local:
                with self.worker(j):
                    acc = got[0, j].clone()
                    for i in range(1, P):
                        acc += got[i, j]
                out[j] = acc
            return out

    def collect(self, xs):
        """Every worker's tensor, in every process: the local workers' own
        tensors and copies of the remote ones (host tensors under gloo,
        on `home` under NCCL), all readable on the current streams (this
        orders them after the workers' streams, as `end` does). The
        tensors may come from the current streams (an engine's stacked
        losses): the workers' streams, which stage what is sent, are
        ordered after them first."""
        self.end()
        if self.num_process == 1:
            return list(xs)
        self.begin()
        out = list(xs)
        for i, y in self._remote(xs).items():
            if self.transport == "nccl":
                cur = torch.cuda.current_stream(self.home)
                cur.wait_stream(self.comm_stream)
                y.record_stream(cur)
            out[i] = y
        return out

    def gather_values(self, xs):
        """Every worker's small tensor `xs[i]` stacked on the CPU in worker
        order, [W, ...], in every process (the counterpart of
        multihost_utils.process_allgather): losses, drop counts."""
        return torch.stack([x.cpu() for x in self.collect(xs)])


def _as_tensor(x, device):
    if torch.is_tensor(x):
        return x.to(device)
    return torch.as_tensor(np.ascontiguousarray(x), device=device)


def _where_it_is(x):
    """A tensor where it lies, numpy as a host tensor (no copy)."""
    if torch.is_tensor(x):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


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
        """Per worker: (prob, alias, heads, tails) tensors on its device
        (None for a worker of another process)."""
        return [tuple(torch.from_numpy(np.ascontiguousarray(a[i])).to(d)
                      for a in (self.prob, self.alias, self.heads,
                                self.tails)) if d is not None else None
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

    Positives: an alias draw over every edge, the first-level index an
    integer draw over the edges (`alias_draws`; the reference takes it
    from a float32 uniform, which `draws` may pass). Draws per worker and
    batch: ((u0, u1) [B] edge draws, [step draws per reuse])."""

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
        out_t, out_m = [None] * g.size, [None] * g.size
        for w in g.local:
            d = g.devices[w]
            ts = tuple(_as_tensor(t, d).clone() for t in tables)
            out_m[w] = tuple(tuple(torch.zeros(t.shape, dtype=torch.float32,
                                               device=d) if m is None
                                   else _as_tensor(m, d).float().clone()
                                   for m in side)
                             for t, side in zip(ts, moments))
            out_t[w] = ts
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
        deltas, states, losses = [None] * W, [None] * W, [None] * W
        for w in g.local:
            dev = g.devices[w]
            eprob, ealias, eheads, etails = edge_arrays[dev]
            with g.worker(w), torch.no_grad():
                start = tuple(t.clone() for t in tables[w])
                st = {"tables": tables[w], "moments": moments[w]}
                ls = []
                for i in range(self.ep_batches):
                    if draws is None:
                        u = alias_draws((eprob, ealias), (B,), gens[w], dev)
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
                deltas[w] = tuple(s.float() - s0.float() for s, s0
                                  in zip(st["tables"], start))
                states[w] = (start, st["moments"])
                losses[w] = torch.stack(ls)
        n_tab = len(tables[g.local[0]])
        summed = [g.sum([d[k] if d is not None else None for d in deltas])
                  for k in range(n_tab)]
        out_tables, out_moms = [None] * W, [None] * W
        for w in g.local:
            with g.worker(w):
                start = states[w][0]
                out_tables[w] = tuple(
                    (s0.float() + summed[k][w] / W).to(s0.dtype)
                    for k, s0 in enumerate(start))
            out_moms[w] = states[w][1]
        g.end()
        return out_tables, out_moms, losses


def _draws_to(draws, device):
    """A nested list/tuple of CPU draw tensors, on `device` (None: a worker
    of another process, whose draws stay behind)."""
    if draws is None or device is None:
        return None
    if torch.is_tensor(draws):
        return draws.to(device)
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

def make_walk_worker_step(core, offsets, num_negative, negative_weight,
                          shape, sgd):
    """One worker's part of a walks-mode batch once its rows have arrived:
    step(rows, lr, mask=pmask, fetched=fetched) -> (ret, loss, n_active).

    `rows` [N, 2D] are the (vertex | context) rows of the worker's N
    requests, its Bw * L1 chain positions then its G * M pool slots (zero
    where not fetched); `pmask` [Bw, L1, T] the band's pair flags as the
    walks give them; `fetched` [N] which requests arrived. A pair trains
    only if both its rows arrived; a pool slot that did not is left out
    of the negatives (the core's `pool_mask`). `ret` holds each request's
    gradient row, for its owner: lr times (dv | dc) on SGD, for the
    moment rules (dv | dc | v_sqs | c_sqs | v_count | c_count); `loss` is
    the mean over the trained pairs, over 1 + num_negative x
    negative_weight; `n_active` the pairs trained (a device scalar)."""
    Bw, L1, G, M = shape["Bw"], shape["L1"], shape["G"], shape["M"]
    Npos = Bw * L1
    k, nw = num_negative, negative_weight

    def step(rows, lr, mask=None, fetched=None):
        D = rows.shape[1] // 2
        v = rows[:Npos, :D].reshape(Bw, L1, D).float()
        c = rows[:Npos, D:].reshape(Bw, L1, D).float()
        P = rows[Npos:, D:].reshape(G, M, D).float()
        fposf = fetched[:Npos].reshape(Bw, L1).float()
        fpool = fetched[Npos:].reshape(G, M).float()
        # a pair trains only if BOTH endpoint rows arrived
        pm = mask * fposf[..., None]
        pm = pm * torch.stack([walk_shift_fwd(fposf, kk) for kk in offsets],
                              dim=-1)
        o = core(v, c, P, pm, lr, table_bf16=rows.dtype == torch.bfloat16,
                 pool_mask=fpool)
        loss = (o["loss_sum"] / torch.clamp(o["n_active"], min=1.0)
                / (1.0 + k * nw))
        tracing.count(tracing.VALID_PAIRS, o["n_active"])
        zeros = torch.zeros((G * M, D), device=rows.device)
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
                           torch.zeros((G * M, 1), device=rows.device),
                           o["p_counts"].reshape(G * M, 1)], dim=-1)])
        return ret, loss, o["n_active"]

    return step


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
        """Shard the [V, D] tables (tensors on any device, host memory
        included, or numpy; the whole tables in every process) into
        per-worker [cap, D] shards on the workers' devices (None for a
        worker of another process): each shard is cut where its table
        lies, so no card holds a whole table. `moments` ((v_moms...),
        (c_moms...)) canonical [V, D] moments seed the shards'
        (resume=True continues from what an earlier mesh run gathered);
        None: zeros. Moments are float32 whatever the tables' dtype. The
        walks engine on SGD keeps both shards in one fused [cap, 2D]
        arena (`"arena"`), its tables being views of it, for as long as
        the state lives."""
        part, g = self.partition, self.group
        self.rotation = 0
        if moments is None:
            moments = ((None,) * self.opt.num_moment,) * 2
        src = [_where_it_is(vertex), _where_it_is(context)]
        D = self.dim
        fused = self.sampler_mode == "walks" and self.opt.num_moment == 0
        out = [None] * g.size
        for p in g.local:
            d = g.devices[p]
            if fused:
                arena = torch.empty((part.capacity, 2 * D),
                                    dtype=src[0].dtype, device=d)
                for side, t in enumerate(src):
                    arena[:, side * D:(side + 1) * D] = part.shard_tensor(
                        t, p).to(d)
                out[p] = {"tables": (arena[:, :D], arena[:, D:]),
                          "moments": ((), ()), "arena": arena}
                continue
            tables = tuple(part.shard_tensor(t, p).to(d) for t in src)
            moms = tuple(
                tuple(torch.zeros((part.capacity, self.dim),
                                  dtype=torch.float32, device=d)
                      if m is None else
                      part.shard_tensor(_where_it_is(m).float(), p).to(d)
                      for m in side)
                for side in moments)
            out[p] = {"tables": tables, "moments": moms}
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
        return ([torch.from_numpy(prob[i]).to(d) if d is not None else None
                 for i, d in enumerate(g.devices)],
                [torch.from_numpy(alias[i]).to(d) if d is not None else None
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

    # the flat start arrays (heads and tails, 8 bytes a directed edge on
    # every card) above this many bytes give way to the CSR start
    FLAT_START_MAX_BYTES = 1 << 30

    @tracing.setup_stage(tracing.SAMPLER_BUILD)
    def build_sample_state(self, graph):
        """Edges: the block tables. Walks: the walk state, a
        DeviceWalkSampler replicated once per distinct device (built on
        the first, copied card to card), with the partition maps, and the
        banded engine's shapes, whose fetch capacity follows s_max, the
        heaviest partition's degree share. On an unweighted graph the
        walks start at a CSR position (`start_csr`: the state is the CSR
        indices, int32, and 24 bytes a vertex) where the flat start
        arrays would pass FLAT_START_MAX_BYTES; else at a flat edge, as
        the reference does."""
        if self.sampler_mode == "edges":
            return self.build_blocks(graph)
        cfg = self.walk_cfg
        w = graph.csr_weights
        uniform = bool(w.size == 0 or np.all(w == w[0]))
        n_dir = int(np.asarray(graph.indices).size)
        start_csr = uniform and 8 * n_dir > self.FLAT_START_MAX_BYTES
        cfg["uniform"], cfg["start_csr"] = uniform, start_csr
        indptr = np.asarray(graph.indptr)
        deg = np.diff(indptr)
        aug = int(cfg["augmentation_step"])
        bidir = bool(cfg.get("bidir", True))
        T = len(walk_offsets(aug, bidir))
        L1 = int(cfg["walk_length"]) + 1
        Bw = max(int(cfg.get("batch_walks")
                     or max(self.batch_size // (T * L1), 1)), 1)
        devices = self.group.distinct
        sampler = DeviceWalkSampler.build(
            graph, aug, L1 - 1, Bw * T * L1, biased=cfg.get("biased", False),
            p=cfg.get("p", 1.0), q=cfg.get("q", 1.0), bidir=bidir,
            banded=True, device=devices[0], start_csr=start_csr,
            membership="search")
        cfg["bs_iters"] = sampler.bs_iters
        maps = (self.partition.part_of.astype(np.int32),
                self.partition.local_of.astype(np.int32))
        deg_mass = np.bincount(self.partition.part_of,
                               weights=np.asarray(deg, np.float64),
                               minlength=self.num_partition)
        s_max = float(deg_mass.max() / max(deg_mass.sum(), 1e-12))
        self._build_banded(s_max, sampler)
        out = {}
        for d in devices:
            if d != devices[0]:
                sampler = sampler.to(d)
            out[d] = (sampler.arrays(),) + tuple(
                torch.as_tensor(m, device=d) for m in maps)
        return out

    def _build_banded(self, s_max, sampler):
        """The walks engine's shapes, core, chain and worker step
        (mesh.py:586-653)."""
        cfg = self.walk_cfg
        P_ = self.num_partition
        aug = int(cfg["augmentation_step"])
        bidir = bool(cfg.get("bidir", True))
        self._offs = walk_offsets(aug, bidir)
        T = len(self._offs)
        L1 = sampler.walk_length + 1
        Bw = sampler.num_walk
        G = graph_pool_groups(Bw, target_group=max(2048 // (T * L1), 1))
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
        self._chain_fn = sampler.make_chain_fn()
        self._sample_fn = sampler.make_sample_fn(sampler.batch_size)
        self._worker_step = make_walk_worker_step(
            self._core, self._offs, self.num_negative, self.negative_weight,
            self._banded_shape, self.opt.num_moment == 0)

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
        losses = [None] * P_
        for i in g.local:
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
                losses[i] = torch.stack(ls)
            state[i] = st
        # the tail role moves one step around the ring
        contexts = g.ring_shift([s["tables"][1] if s else None
                                 for s in state])
        n_mom = self.opt.num_moment
        c_moms = [g.ring_shift([s["moments"][1][m] if s else None
                                for s in state])
                  for m in range(n_mom)]
        for i in g.local:
            state[i] = {"tables": (state[i]["tables"][0], contexts[i]),
                        "moments": (state[i]["moments"][0],
                                    tuple(c_moms[m][i]
                                          for m in range(n_mom)))}
        neg_state = (g.ring_shift(nprob), g.ring_shift(nalias),
                     [nsize[(i + 1) % P_] for i in range(P_)])
        return state, neg_state, losses

    def _episode_walks(self, state, sample_state, neg_state, batch_id0,
                       num_batch_total, gens, draws):
        """The walks episode: an `episode` span on every card, its
        batches each a `sample`, `step` and `update` span on every worker
        and three `mesh::all_to_all` on every card. On SGD the fused
        arena of each worker's state is trained in place, and stays."""
        g, P_ = self.group, self.num_partition
        D = self.dim
        sgd = self.opt.num_moment == 0
        local = [None] * P_
        for i in g.local:
            s = state[i]
            if sgd and "arena" not in s:
                # shards made elsewhere: fused once, then kept
                with g.worker(i):
                    arena = torch.cat(s["tables"], dim=-1)
                state[i] = s = {"tables": (arena[:, :D], arena[:, D:]),
                                "moments": ((), ()), "arena": arena}
            local[i] = s if sgd else dict(s)
        losses = [[] for _ in range(P_)]
        stats = [[] for _ in range(P_)]
        with g.spans(tracing.EPISODE):
            for it in range(self.ep_batches):
                lr = self.opt.schedule_lr(batch_id0 + it * P_,
                                          num_batch_total)
                bd = None if draws is None else [
                    draws[i][it] if g.is_local(i) else None
                    for i in range(P_)]
                self._walk_batch(local, sample_state, neg_state, lr, gens,
                                 bd, losses, stats)
        out = [None] * P_
        for i in g.local:
            with g.worker(i):
                out[i] = state[i] if sgd else local[i]
                drops = torch.stack([d for d, _ in stats[i]]).sum()
                pairs = torch.stack([n for _, n in stats[i]]).double().sum()
                if self._drops[i] is not None:
                    drops = drops + self._drops[i]
                    pairs = pairs + self._pairs[i]
                self._drops[i], self._pairs[i] = drops, pairs
                losses[i] = torch.stack(losses[i])
        for i in range(P_):
            if not g.is_local(i):
                losses[i] = None
        return out, losses

    def _walk_batch(self, local, sample_state, neg_state, lr, gens, draws,
                    losses, stats):
        """One walks-mode batch on every worker (mesh.py:681-824):

        1. every worker draws Bw walks over the replicated graph and a
           [G, M] negative pool (a `sample` span), and assigns each of its
           N row requests (chain positions, then pool slots) a slot of
           capacity C at the row's owner by a one-hot cumsum (no sort);
           requests past C are dropped, their band slots masked;
        2. all_to_all the (local id, valid) requests; each owner serves
           its rows (one gather of the fused [cap, 2D] arena on SGD);
           all_to_all the rows back;
        3. run the worker step (`make_walk_worker_step`: the banded core
           on the fetched rows) in a `step` span;
        4. all_to_all the per-row gradients (with touch counts and squared
           sums for the moment rules) to the owners, which apply them in
           an `update` span: SGD one kernel-1 scatter-add on the arena,
           ids `cap` dropped; moment rules apply_row_updates with entry
           counts and squares (kernel 2 on shards above
           DENSE_UPDATE_ELEMS), zero-count slots dropped so they do not
           decay the moments.

        Counters per worker-batch: `pair_slots` (the band's slots),
        `valid_pairs` (the pairs trained), `row_requests` (N) and
        `row_drops` (the requests past C)."""
        g, P_ = self.group, self.num_partition
        D = self.dim
        s = self._banded_shape
        G, M = s["G"], s["M"]
        C = self._banded_capacity
        Npos = s["Bw"] * s["L1"]
        N = Npos + G * M
        sgd = self.opt.num_moment == 0
        if self._drops is None:
            self._drops = [None] * P_
            self._pairs = [None] * P_
        ctx = [None] * P_
        reqs = [None] * P_
        for i in g.local:
            dev = g.devices[i]
            walk_arrays, part_of, local_of = sample_state[dev]
            nprob, nalias = neg_state[dev]
            with g.worker(i), torch.no_grad(), \
                    tracing.span(tracing.SAMPLE, device=dev):
                chain_draws = pool_draws = None
                if draws is not None:
                    chain_draws, pool_draws = draws[i]
                chainT, _, pmask = self._sample_fn(*walk_arrays,
                                                   generator=gens[i],
                                                   draws=chain_draws)
                if pool_draws is None:
                    pool_draws = alias_draws((nprob, nalias), (G, M),
                                             gens[i], dev)
                pool_ids = device_sample(nprob, nalias, *pool_draws)
                ids = torch.cat([chainT.reshape(-1), pool_ids.reshape(-1)])
                owner = part_of[ids].long()
                lid = local_of[ids].long()
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
                reqs[i] = torch.stack(
                    [torch.where(ok, lid[src2], torch.zeros_like(src2)),
                     ok.long()], dim=-1)                       # [P, C, 2]
                ctx[i] = dict(pmask=pmask, fetched=fetched, loc=loc,
                              n_drop=n_drop, ok=ok, src2=src2)
            tracing.count(tracing.PAIR_SLOTS, pmask.numel())
            tracing.count(tracing.ROW_REQUESTS, N)
            tracing.count(tracing.ROW_DROPS, n_drop)
        got = g.all_to_all(reqs)
        serves = [None] * P_
        for i in g.local:
            with g.worker(i), torch.no_grad():
                glid = got[i][..., 0]
                ctx[i]["glid"] = glid
                ctx[i]["gok"] = got[i][..., 1] > 0
                if sgd:
                    serves[i] = local[i]["arena"][glid]        # [P, C, 2D]
                else:
                    vertex, context = local[i]["tables"]
                    serves[i] = torch.cat([vertex[glid], context[glid]],
                                          dim=-1)
        rows = g.all_to_all(serves)
        rets = [None] * P_
        self._emitted += N * P_
        for i in g.local:
            c_ = ctx[i]
            dev = g.devices[i]
            with g.worker(i), torch.no_grad(), \
                    tracing.span(tracing.STEP, device=dev):
                fetched = c_["fetched"]
                flat = torch.where(fetched[:, None],
                                   rows[i].reshape(P_ * C, -1)[c_["loc"]],
                                   0.0)
                ret, loss, n_active = self._worker_step(
                    flat, lr, mask=c_["pmask"], fetched=fetched)
                losses[i].append(loss)
                stats[i].append((c_["n_drop"], n_active))
                ok = c_["ok"]
                rets[i] = torch.where(ok[..., None], ret[c_["src2"]], 0.0)
        back = g.all_to_all(rets)
        for i in g.local:
            c_ = ctx[i]
            with g.worker(i), torch.no_grad(), \
                    tracing.span(tracing.UPDATE, device=g.devices[i]):
                retg = back[i].reshape(P_ * C, -1)
                okf = c_["gok"].reshape(-1)
                ids_o = c_["glid"].reshape(-1)
                if sgd:
                    vc = local[i]["arena"]
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
    def _counted(self, counts):
        """Every worker's count, in worker order, on the host (a host sync;
        across processes a collective every process calls); None before
        the first walks batch."""
        if not counts or any(counts[i] is None for i in self.group.local):
            return None
        return self.group.gather_values(counts).tolist()

    def drop_counts(self):
        """(dropped, emitted) row requests of the walks engine over all
        workers since the counts were last reset."""
        drops = self._counted(self._drops)
        if drops is None:
            return 0, self._emitted
        return int(sum(int(d) for d in drops)), self._emitted

    def valid_pairs(self):
        """Pairs the walks engine trained over all workers since the
        counts were last reset (their masks' sum, after dropped
        requests)."""
        pairs = self._counted(self._pairs)
        if pairs is None:
            return 0.0
        return float(sum(float(n) for n in pairs))

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
        episodes worker i holds partition (i + e) % P). Across processes
        the shards of every worker come to every process (a
        collective)."""
        P_ = self.num_partition
        e = self.rotation % P_ if (rotated and self.rotating) else 0
        per_worker = self.group.collect(per_worker)
        parts = [per_worker[(p - e) % P_] for p in range(P_)]
        return self.partition.unshard_tensors(parts, out)

    def _shards(self, state, side, what="tables", m=None):
        return [(s[what][side] if m is None else s[what][side][m])
                if s is not None else None for s in state]

    def shard_worker(self, side, p):
        """The worker holding partition p's shard of table `side` (0
        vertex, 1 context): in edges mode the context shards travel one
        step around the ring an episode."""
        P_ = self.num_partition
        e = self.rotation % P_ if (side == 1 and self.rotating) else 0
        return (p - e) % P_

    def rows(self, state, side, ids):
        """Rows `ids` (global ids, an int64 tensor) of table `side` of the
        per-worker `state`, float32 on the ids' device, each read on the
        card that holds it: no whole table is made. This process's
        workers only."""
        dev = ids.device
        maps = self._maps.get(dev) if hasattr(self, "_maps") else None
        if maps is None:
            self._maps = getattr(self, "_maps", {})
            maps = self._maps[dev] = tuple(
                torch.as_tensor(m, device=dev)
                for m in (self.partition.part_of, self.partition.local_of))
        owner = maps[0][ids].long()
        lid = maps[1][ids].long()
        out = torch.zeros((ids.numel(), self.dim), dtype=torch.float32,
                          device=dev)
        for p in range(self.num_partition):
            sel = torch.nonzero(owner == p).squeeze(1)
            if sel.numel():
                t = state[self.shard_worker(side, p)]["tables"][side]
                out[sel] = t[lid[sel].to(t.device)].float().to(dev)
        return out

    def gather_tables(self, state, device=None):
        """(vertex, context) [V, D] in global order on `device` (the first
        local worker's by default), undoing the tail-shard rotation; in
        every process."""
        device = device or self.group.home
        v = self.partition.part_of.shape[0]
        out = []
        for side, rotated in ((0, False), (1, True)):
            shards = self._shards(state, side)
            t = torch.empty((v, self.dim),
                            dtype=shards[self.group.local[0]].dtype,
                            device=device)
            out.append(self.canonical(shards, rotated, t))
        return tuple(out)

    def gather_moments(self, state, device=None):
        """Canonical ((v_moms...), (c_moms...)) [V, D] float32."""
        device = device or self.group.home
        v = self.partition.part_of.shape[0]
        out = []
        for side, rotated in ((0, False), (1, True)):
            moms = []
            for m in range(self.opt.num_moment):
                shards = self._shards(state, side, "moments", m)
                t = torch.empty((v, self.dim), dtype=torch.float32,
                                device=device)
                moms.append(self.canonical(shards, rotated, t))
            out.append(tuple(moms))
        return tuple(out)
