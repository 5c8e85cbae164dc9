"""Node embedding on the walks engine over several workers, one card each:
GraphSolver(num_worker=W).build, then GraphSolver.train (LINE on the walk
route), resumed call after call, on a power-law clone of the
configuration's dataset (`mesh.num_worker` workers).

A round is one batch on every worker: the engine's batch ids advance by
W a round, so this job counts worker-batches (a call of E rounds trains
E x W of them) and drives calls by rounds (`_train`). It records whole
rounds from the program's own outputs: each worker's walks and pair
flags (the walk sampler's banded sample), its pool (the alias draw the
engine makes), its loss and its dropped requests; for a window round
also the rows before and after at every id the round reads. The tables
are made in host memory and read shard by shard (`table_rows`), so no
card holds a whole table.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import gc
import os

import numpy as np
import torch

from benchmark import init, trace
from benchmark.apps import TrainingJob
from benchmark.reference import common, line

CLONE_CHUNK = 1 << 25


def _engine_state():
    """Whether the program's walks engine keeps a compact walk state and
    its worker step (what this job reaches into)."""
    from graphvite_tpu_torch.parallel import mesh

    return (hasattr(mesh, "make_walk_worker_step")
            and hasattr(mesh.ShardedGraphTrainer, "FLAT_START_MAX_BYTES")
            and hasattr(mesh.ShardedGraphTrainer, "rows"))


def _uniforms(seed, offset, n):
    """The numbers default_rng(seed).random draws at positions [offset,
    offset + n) of its stream (one 64-bit output a double)."""
    bits = np.random.PCG64(seed)
    bits.advance(offset)
    return np.random.Generator(bits).random(n)


def power_law_edges(num_vertex, num_edge, seed):
    """clones.power_law_edges(num_vertex, num_edge, seed), made in chunks
    on the host's cores: the same edges in the same order, as int32 where
    the ids fit."""
    dtype = np.int32 if num_vertex < 2**31 else np.int64
    bounds = [(lo, min(lo + CLONE_CHUNK, num_edge))
              for lo in range(0, num_edge, CLONE_CHUNK)]

    def part(bound):
        lo, hi = bound
        u = (_uniforms(seed, lo, hi - lo) ** 2.5
             * num_vertex).astype(np.int64)
        v = (_uniforms(seed, num_edge + lo, hi - lo) ** 2.5
             * num_vertex).astype(np.int64)
        keep = u != v
        return u[keep].astype(dtype), v[keep].astype(dtype)

    workers = max(len(os.sched_getaffinity(0)), 1)
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        parts = list(pool.map(part, bounds))
    u = np.concatenate([p[0] for p in parts])
    v = np.concatenate([p[1] for p in parts])
    return u, v


class Job(TrainingJob):
    # faults.py plants the first three where fault_points() says; the
    # job plants "exchange". No "own_draws": the pools are recorded as
    # the engine drew them, not replayed from its generator
    FAULTS = ("unchanged", "half_batch", "token", "exchange")

    def __init__(self, cfg, traffic, seed, device):
        super().__init__(cfg, traffic, seed, device)
        if self.device.type == "cuda" and self.device.index is None:
            # a worker's stream makes its own card the current one: name
            # the card that holds what the job keeps
            self.device = torch.device("cuda", 0)
        if not _engine_state():
            raise RuntimeError(
                "graphvite_tpu_torch's walks engine has no compact walk "
                "state (parallel/mesh.py: make_walk_worker_step, "
                "ShardedGraphTrainer.FLAT_START_MAX_BYTES and .rows): "
                "this configuration does not fit its cards")
        from graphvite_tpu_torch.graph import Graph
        from graphvite_tpu_torch.solver import GraphSolver

        ds = cfg["dataset"]
        V = int(ds["num_vertex"])
        self.workers = int(cfg["mesh"]["num_worker"])
        self.edges = power_law_edges(V, int(ds["num_edge"]), self.seed)
        u, v = self.edges
        # an anonymous symmetrized graph, filled straight into the arrays;
        # its weights all one, a view of one number
        g = Graph()
        g.num_vertex = V
        g.num_edge = int(u.size)
        g.id2name = g.name2id = None
        g.as_undirected = True
        g.edge_heads = np.concatenate([u, v])
        g.edge_tails = np.concatenate([v, u])
        g.edge_weights = np.broadcast_to(np.ones(1, np.float32),
                                         g.edge_heads.shape)
        g._finalize(normalization=False)
        res = cfg["resource"]
        self.solver = GraphSolver(dim=int(res["dim"]),
                                  float_type=res["float_type"],
                                  num_worker=self.workers,
                                  device=self.device, seed=self.seed)
        self.solver.build(g, **cfg["build"])
        self._host_init = None
        self.install_init(self.solver)
        self._capture = None

    # -- hooks --------------------------------------------------------------
    def fault_points(self):
        """The walks engine's worker step (half_batch masks the second
        half of a worker's walks in it), the walk sampler altering a
        walk's sixth vertex, and kernel 1 on the owners' arenas."""
        if int(self.cfg["train"]["augmentation_step"]) < 2 or \
                self.cfg["build"]["optimizer"]["type"] != "SGD":
            raise ValueError("%s does not train the walks engine's arena"
                             % self.cfg["name"])
        return {"step": ("graphvite_tpu_torch.parallel.mesh",
                         "make_walk_worker_step"),
                "sampler": ("graphvite_tpu_torch.ops.device_sampler",
                            "DeviceWalkSampler"),
                "token": (0, (0, 5)),
                "update": ("graphvite_tpu_torch.ops.scatter", "scatter_add_")}

    def plant(self, fault):
        """"exchange": the rows the owners send back come from the wrong
        owner (each worker's second all_to_all of a batch, the rows,
        rolled by one source)."""
        if fault != "exchange":
            raise ValueError("no fault %r" % fault)
        from graphvite_tpu_torch.parallel.mesh import DeviceGroup

        orig = DeviceGroup.all_to_all
        calls = [0]

        def all_to_all(group, chunks):
            out = orig(group, chunks)
            calls[0] += 1
            if calls[0] % 3 == 2:
                out = [None if x is None else x.roll(1, dims=0)
                       for x in out]
            return out

        return trace.swapped([DeviceGroup], "all_to_all", all_to_all)

    # -- the tables ----------------------------------------------------------
    def install_init(self, solver):
        """The solver's tables are the benchmark's (benchmark.init), drawn
        on the job's device block by block and kept in host memory, made
        where the solver would make its own: at a fresh train call."""
        dtype = solver.float_type

        def init_embeddings(*args, **kwargs):
            solver.state = None
            if self._host_init is None:
                tables = []
                for i, (_, rows, cols) in enumerate(init.shapes(self.cfg)):
                    t = torch.empty((rows, cols), dtype=dtype)
                    for r0, block in init.blocks(self.cfg, i, self.seed,
                                                 self.device):
                        t[r0:r0 + block.shape[0]] = block.to(dtype).cpu()
                    tables.append(t)
                self._host_init = tuple(tables)
            moments = tuple(solver.optimizer.init_moments(t.shape, "cpu")
                            for t in self._host_init)
            solver.state = {"tables": self._host_init, "moments": moments}

        solver.init_embeddings = init_embeddings

    def _blocks(self, i):
        """(row0, the program's float32 rows of table i) in init's
        blocks, read from the shards on the job's device."""
        rows = init.shapes(self.cfg)[i][1]
        for r0 in range(0, rows, init.BLOCK_ROWS):
            ids = torch.arange(r0, min(r0 + init.BLOCK_ROWS, rows),
                               device=self.device)
            yield r0, self.solver.table_rows(i, ids)

    def leaf_distances(self):
        out = []
        for i in range(len(self.cfg["init"])):
            total = 0.0
            blocks = init.blocks(self.cfg, i, self.seed, self.device)
            for (_, got), (_, want) in zip(self._blocks(i), blocks):
                total += float((got - want).square().sum(
                    dtype=torch.float64))
            out.append(float(np.sqrt(total)))
        return out

    # -- the rounds ----------------------------------------------------------
    def _train(self, rounds, fresh=False):
        """One call of the solver's train entry that trains `rounds` more
        rounds (rounds x W worker-batches), the linear schedule running to
        their end: from the initial tables (`fresh`), or resumed. A fresh
        call of one round runs before the engine's batch is planned, so
        it asks for one batch id: the engine trains one round at the
        schedule's first rate."""
        s, W = self.solver, self.workers
        b0 = 0 if fresh else s.batch_id
        total = b0 + rounds * W
        if fresh and rounds == 1:
            num_epoch, want = 1e-12, 1
        else:
            num_epoch = total * s.effective_batch / s.graph.num_edge + 1e-9
            want = total
        s.train(resume=not fresh, num_epoch=num_epoch, **self.cfg["train"])
        if s.batch_id != total or s.num_batch != want:
            raise RuntimeError("train ran to batch %d of %d, not %d"
                               % (s.batch_id, s.num_batch, total))
        self.calls.append((list(range(b0, total)), want))

    def _wrap_runners(self):
        """Every walks-engine batch goes through `_round`, which records
        the rounds that `_record` counts."""
        from graphvite_tpu_torch.ops import alias
        from graphvite_tpu_torch.parallel import mesh

        stack = contextlib.ExitStack()
        orig = mesh.ShardedGraphTrainer._walk_batch
        job = self

        def walk_batch(trainer, local, sample_state, neg_state, lr, gens,
                       draws, losses, stats):
            if not job._record:
                return orig(trainer, local, sample_state, neg_state, lr,
                            gens, draws, losses, stats)
            job._record -= 1
            return job._round(orig, trainer, local, sample_state, neg_state,
                              lr, gens, draws, losses, stats)

        stack.enter_context(trace.swapped([mesh.ShardedGraphTrainer],
                                          "_walk_batch", walk_batch))
        sample = alias.device_sample

        def device_sample(*args, **kwargs):
            out = sample(*args, **kwargs)
            cap = job._capture
            if cap is not None:
                cap["pools"].append(out.clone().to(job.device))
                if len(cap["pools"]) == cap["workers"] and cap["window"]:
                    # every worker has drawn; no row has moved yet
                    job._synchronize(cap["trainer"])
                    cap["ids"] = torch.cat(
                        [torch.cat([c.reshape(-1), p.reshape(-1)])
                         for c, p in zip(cap["chains"], cap["pools"])]
                    ).long().to(job.device)
                    cap["before"] = [cap["trainer"].rows(cap["local"], t,
                                                         cap["ids"])
                                     for t in range(2)]
            return out

        stack.enter_context(trace.replaced(
            ("graphvite_tpu_torch.ops.alias", "device_sample"),
            device_sample))
        self._unwrap = stack.close

    def _round(self, orig, trainer, local, sample_state, neg_state, lr,
               gens, draws, losses, stats):
        """Run one round as the engine does, keeping each worker's walks,
        pair flags, pool, loss and dropped requests and, for a window
        round, the rows it reads before and after."""
        cap = {"chains": [], "masks": [], "pools": [], "trainer": trainer,
               "local": local, "window": self._window,
               "workers": len(trainer.group.local)}
        sample_fn = trainer._sample_fn

        def sample(*args, **kwargs):
            chain, tails, mask = sample_fn(*args, **kwargs)
            cap["chains"].append(chain.clone().to(self.device))
            cap["masks"].append(mask.clone().to(self.device))
            return chain, tails, mask

        self._capture = cap
        trainer._sample_fn = sample
        try:
            orig(trainer, local, sample_state, neg_state, lr, gens, draws,
                 losses, stats)
        finally:
            trainer._sample_fn = sample_fn
            self._capture = None
        # what the workers' streams wrote, read on the current ones
        self._synchronize(trainer)
        rec = {"chains": cap["chains"], "masks": cap["masks"],
               "pools": cap["pools"],
               "lr": lr,
               "drops": [int(stats[i][-1][0]) for i in trainer.group.local],
               "losses": [float(losses[i][-1])
                          for i in trainer.group.local]}
        if cap["window"]:
            rec["ids"] = cap["ids"]
            rec["before"] = cap["before"]
            rec["after"] = [trainer.rows(local, t, cap["ids"])
                            for t in range(2)]
            self.window_step = rec
        else:
            self.steps.append(rec)

    @staticmethod
    def _synchronize(trainer):
        for d in trainer.group.distinct:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def set_up(self):
        """One fresh call of one round; a second fresh call of
        `followed_steps` rounds, its first the same round again (every
        worker's generator restarts with the call); the window resumes
        from it. The initial tables stay in host memory between the two
        fresh calls, then go."""
        n = int(self.traffic["followed_steps"])
        self._wrap_runners()
        self._record = 1
        self._train(1, fresh=True)
        lr = self.steps[0]["lr"]
        self.readings["grad_norms"] = [d / lr for d in self.leaf_distances()]
        self._record = n
        self._train(n, fresh=True)
        self.readings["losses"] = (
            self.solver.batch_losses.double().cpu().tolist())
        self.readings["change_norms"] = self.leaf_distances()
        self.first, self.steps = self.steps[0], self.steps[1:]
        self.followed_call = self.calls[1]
        self._host_init = None
        gc.collect()

    def first_batch_diff(self):
        a, b = self.first, self.steps[0]
        return sum(int((x != y).sum())
                   for key in ("chains", "masks", "pools")
                   for x, y in zip(a[key], b[key]))

    def call(self, record=True):
        """One call of the window: whole episodes of rounds, its first
        round recorded (`record`). Returns its worker-batches."""
        rounds = self.batches_per_call()
        self._record, self._window = int(record), True
        self._train(rounds)
        self._record = 0
        return rounds * self.workers

    def samples_per_batch(self):
        """Valid walk pairs of a worker-batch: its pair slots times the
        mean pair flag of the followed rounds."""
        share = float(torch.stack([m.float().mean() for s in self.steps
                                   for m in s["masks"]]).mean())
        return self.solver.effective_batch * share

    def release(self):
        """Count the non-finite entries of the program's tables, shard by
        shard, then free the program before the reference runs."""
        if self._unwrap is not None:
            self._unwrap()
        self.tables_nonfinite = sum(
            int((~torch.isfinite(rows)).sum())
            for i in range(len(self.cfg["init"]))
            for _, rows in self._blocks(i))
        cards = {d for d in self.solver.worker_devices if d.type == "cuda"}
        self.solver = None
        gc.collect()
        for card in cards:
            with torch.cuda.device(card):
                torch.cuda.empty_cache()

    # -- the reference ------------------------------------------------------
    def check(self, dtype):
        """(gaps, sampler readings) as TrainingJob.check, with a window
        round of W worker-batches."""
        checks = line.check_sampler(self.cfg, self.edges,
                                    self.steps + [self.window_step])
        checks["first_batch_diff"] = self.first_batch_diff()
        checks["tables_nonfinite"] = self.tables_nonfinite
        ref = line.follow(self.cfg, self.seed, self.edges, self.steps,
                          [self.followed_call], torch.float32)
        checks["reference_grad_norms"] = ref["grad_norms"]
        got = (self.readings if dtype == torch.float32 else
               line.follow(self.cfg, self.seed, self.edges, self.steps,
                           [self.followed_call], dtype))
        gaps = common.gaps(got, ref)
        ref = line.follow_window(self.cfg, self.edges, self.window_step,
                                 torch.float32)
        rec = self.window_step
        # the distinct rows the round read, before and after
        before, after = ([common.local_rows(rec["ids"], r)[1]
                          for r in rec[key]] for key in ("before", "after"))
        got = ({"losses": rec["losses"],
                "grad_norms": common.step_norms(before, after, rec["lr"])}
               if dtype == torch.float32 else
               line.follow_window(self.cfg, self.edges, rec, dtype))
        gaps.update(line.window_gaps(got, ref))
        return gaps, checks
