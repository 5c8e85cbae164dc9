"""Training solvers (the port of graphvite_tpu/solver.py's SolverBase,
GraphSolver and KnowledgeGraphSolver).

Embedding tables live on the device for the whole run; an "episode" is one
runner call that samples and trains a run of batches on the device, with
losses kept there until log time. The solver runs on CUDA unless the
caller passes `device="cpu"`.

Ported here: node embedding on the edge route (augmentation_step 1:
edge sampler, pool step, and on the card the sorted stream with the sweep
kernels; blocked episodes over vertex partitions, with the host master
where the tables overflow the card) and on the walk route (above 1:
first-order walks, or node2vec's biased walks; the banded layout with its
fused (vertex|context) SGD arena or the unfused step for moment
optimizers and the trust clip on small tables, the multitail and the pair
layouts), each route also with the classic K-draw step. Knowledge
graphs: the classic per-draw step and the shared-candidate-pool step
over a tied entity table and a relation table,
positives from the relation-carrying edge sampler. LargeVis: the classic
K-draw step and the shared-pool step over one padded coordinate table,
positives from the alias-weighted edge sampler over a KNN graph. With
num_worker > 1, node embedding trains on the sharded multi-device engine
(edges or banded walks), LargeVis on the replicated one
(parallel/mesh.py) and knowledge graphs on the tied-weights sharded one
(parallel/kg.py), worker i on cuda:device_ids[i] or, for device="cpu",
on the CPU. sampler_backend="host" trains every solver on pools from the
host samplers (sampler.py, `_train_loop`). The reference's experimental
walk opt-ins (GRAPHVITE_SWEEP_WALK, GRAPHVITE_BULK_WALKS,
GRAPHVITE_BF16_BAND, GRAPHVITE_SWEEP_BANDED, GRAPHVITE_BF16_COMPUTE) are
off unless set, as there. Tables that the host master leaves in host
memory are scored by `predict` in chunks of touched rows.
"""
from __future__ import annotations

import functools
import math
import os
import pickle
import time

import numpy as np
import torch

from graphvite_tpu_torch import base
from graphvite_tpu_torch import optim as _optim
from graphvite_tpu_torch.models import GRAPH_MODELS, KG_MODELS, LargeVis
from graphvite_tpu_torch.ops import blocked as _blocked
from graphvite_tpu_torch.ops import steps as _steps
from graphvite_tpu_torch.ops.alias import AliasTable, device_alias_arrays
from graphvite_tpu_torch.ops.device_sampler import (DeviceEdgeSampler,
                                                    DeviceWalkSampler)
from graphvite_tpu_torch.optim import Optimizer, make_optimizer
from graphvite_tpu_torch.parallel.kg import ShardedKGTrainer, TripletBlocks
from graphvite_tpu_torch.parallel.mesh import (BlockEdgeTables,
                                               DeviceGroup,
                                               ReplicatedEdgeTrainer,
                                               ShardedGraphTrainer,
                                               VertexPartition,
                                               make_sharded_graph_step)
from graphvite_tpu_torch.sampler import (EdgeSampler, PrefetchingPool,
                                         RandomWalkSampler)
from graphvite_tpu_torch.utils import tracing
from graphvite_tpu_torch.utils.common import auto, hbm_budget_bytes, logger

EXPECTED_DEGREE = 1600  # graph.cuh:55, used by the augmentation auto-rule


def resolve_device(device=None):
    """The device a solver runs on: CUDA unless the caller asks otherwise;
    asking for CUDA where there is none raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run on the CPU")
    return dev


def _bf16_from_numpy(arr):
    """bf16 numpy array (ml_dtypes' bfloat16, or its raw uint16 bits) ->
    torch.bfloat16, through a uint16 view: the port needs no ml_dtypes."""
    bits = np.array(arr).view(np.uint16).view(np.int16)
    return torch.from_numpy(bits).view(torch.bfloat16)


def _tensor_from_numpy(arr, device, dtype):
    arr = np.asarray(arr)
    if arr.dtype.name in ("bfloat16", "uint16"):
        t = _bf16_from_numpy(arr)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=device, dtype=dtype)


def _host_rows(table, ids):
    """float32 rows `ids` of a table in host memory (a tensor, or a numpy
    array: bf16 as ml_dtypes' bfloat16 or its uint16 bits), gathered on
    the host."""
    ids = np.asarray(ids, dtype=np.int64)
    if torch.is_tensor(table):
        return table.index_select(
            0, torch.from_numpy(ids).to(table.device)).float().cpu()
    return _tensor_from_numpy(np.asarray(table)[ids], "cpu", torch.float32)


def state_from_numpy(state_np, device, float_type=torch.float32):
    """The reference's numpy state {"tables": (vertex, context), "moments":
    ((v_moms...), (c_moms...))} (knowledge graphs: entity and relation
    tables, moments per table) -> the port's state on `device`. Tables
    take `float_type`; bf16 arrays (dtype name "bfloat16", or uint16 bits
    as state_to_numpy writes them) go through a uint16 view; moments are
    float32."""
    float_type = base.torch_float_type(float_type)
    tables = tuple(_tensor_from_numpy(t, device, float_type)
                   for t in state_np["tables"])
    moments = tuple(tuple(_tensor_from_numpy(m, device, torch.float32)
                          for m in group)
                    for group in state_np["moments"])
    return {"tables": tables, "moments": moments}


def _numpy_from_tensor(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def state_to_numpy(state):
    """The inverse of state_from_numpy: float32 tables as float32 arrays,
    bf16 tables as their uint16 bits."""
    return {"tables": tuple(_numpy_from_tensor(t) for t in state["tables"]),
            "moments": tuple(tuple(_numpy_from_tensor(m) for m in group)
                             for group in state["moments"])}


def _traced_call(train):
    """A solver's train entry as one `train` span whose first stage,
    `prepare`, runs until the loop's first episode; the loop's `finish`
    stage runs from its last episode to the return (utils/tracing.py)."""
    @functools.wraps(train)
    def traced(self, *args, **kwargs):
        with tracing.span(tracing.TRAIN, device=self.device):
            tracing.stage(tracing.PREPARE)
            return train(self, *args, **kwargs)
    return traced


def _one_process(loop):
    """The solvers' mesh loops run their W workers in one process. With
    GRAPHVITE_COORDINATOR set they raise: multi-process training runs
    through the engines (parallel/), as in the reference, whose solvers
    fail reading their losses back over processes (its solver.py:767;
    ROADMAP queue 3)."""
    if os.environ.get("GRAPHVITE_COORDINATOR"):
        raise RuntimeError(
            "GRAPHVITE_COORDINATOR is set, but %s trains its workers in one "
            "process: multi-process training runs through the engines of "
            "graphvite_tpu_torch.parallel (ShardedGraphTrainer, "
            "ReplicatedEdgeTrainer, ShardedKGTrainer, ReplicatedKGTrainer) "
            "on a DeviceGroup" % loop)

class _LiveShards:
    """A graph engine's per-worker shards left on the cards by a run:
    called, it gathers the tables and moments into host memory in
    canonical order."""

    def __init__(self, trainer, shards, negatives):
        self.trainer, self.shards, self.negatives = trainer, shards, negatives

    def __call__(self):
        cpu = torch.device("cpu")
        state = {"tables": self.trainer.gather_tables(self.shards, cpu),
                 "moments": self.trainer.gather_moments(self.shards, cpu)}
        self.shards = None
        return state


class SolverBase:
    """Shared machinery: build/train plumbing over a state dict
    {"tables": (...), "moments": (...)}."""

    def __init__(self, dim, float_type=None, index_type=None,
                 device_ids=None, num_sampler_per_worker=auto,
                 gpu_memory_limit=auto, seed=1024, sampler_backend="device",
                 num_worker=1, device=None):
        # `device` picks the card (default "cuda"). num_worker > 1 trains
        # with the multi-device engines (parallel/mesh.py), worker i on
        # cuda:device_ids[i] (default range(num_worker); repeated ids put
        # several workers on one card), or on the CPU for device="cpu";
        # device_ids are read only then. num_sampler_per_worker is accepted
        # for API parity with the reference. gpu_memory_limit bounds the
        # device memory budget of the overflow rules (bytes or "4G"-style;
        # auto = query the device): blocked episodes and the host master on
        # the edge route, a warning on the walk route.
        # sampler_backend: "device" draws positives on the device inside
        # the runner; any other value ("host") makes pools of them in numpy
        # on a background thread (sampler.py) for the pool runner, as the
        # reference reads it
        if num_worker in (auto, None):
            num_worker = 1
        self.num_worker = int(num_worker)
        self.device = resolve_device(device)
        self.worker_devices = [self.device]
        if self.num_worker > 1:
            self.worker_devices = self._place_workers(device_ids)
            self.device = self.worker_devices[0]
        self.sampler_backend = sampler_backend
        self.gpu_memory_limit = gpu_memory_limit
        self.dim = int(dim)
        self.float_type = base.torch_float_type(float_type)
        self.index_type = index_type
        self.seed = seed
        self.graph = None
        self.model = None
        self.state = None
        self.optimizer = None
        self.num_negative = 1
        self.batch_size = 100000
        self.episode_size = auto
        self.batch_id = 0
        self.num_batch = 0
        self.effective_batch = self.batch_size
        self.batch_losses = None
        self._rng = np.random.default_rng(seed)

    # -- the state ----------------------------------------------------------
    @property
    def state(self):
        """{"tables": (...), "moments": (...)}. After a run on several
        workers the tables stay as the workers' shards on their cards (a
        resumed run trains them on); reading the state gathers them into
        host memory and ends that (a later run shards them again)."""
        live = self._live
        if live is not None:
            self._live = None
            self._state = live()
        return self._state

    @state.setter
    def state(self, value):
        self._live = None
        self._state = value

    def _has_state(self):
        """Whether there is a state, without gathering live shards."""
        return self._live is not None or self._state is not None

    def _place_workers(self, device_ids):
        """The devices of the num_worker workers: the CPU for each on a CPU
        solver; else cuda:device_ids[i], device_ids defaulting to
        range(num_worker), each id a visible card (as the reference
        checks its mesh, solver.py:61-64)."""
        W = self.num_worker
        if self.device.type == "cpu":
            return [torch.device("cpu")] * W
        visible = torch.cuda.device_count()
        if device_ids in (auto, None):
            if W > visible:
                raise ValueError(
                    "num_worker=%d but only %d devices visible (pass "
                    "device_ids to place several workers on one card)"
                    % (W, visible))
            device_ids = range(W)
        device_ids = [int(i) for i in device_ids]
        if len(device_ids) != W:
            raise ValueError("num_worker=%d but %d device_ids"
                             % (W, len(device_ids)))
        bad = [i for i in device_ids if not 0 <= i < visible]
        if bad:
            raise ValueError("device_ids %r: only %d devices visible"
                             % (bad, visible))
        return [torch.device("cuda", i) for i in device_ids]

    # -- per-application hooks ---------------------------------------------
    def get_default_optimizer(self) -> Optimizer:
        raise NotImplementedError

    def get_available_models(self):
        raise NotImplementedError

    def _table_shapes(self):
        raise NotImplementedError

    def init_embeddings(self):
        raise NotImplementedError

    # -- build ---------------------------------------------------------------
    @tracing.setup_stage(tracing.SOLVER_BUILD)
    def build(self, graph, optimizer=auto, num_partition=auto, num_negative=1,
              batch_size=100000, episode_size=auto):
        """Allocate embedding/moment tables. `num_partition` is accepted for
        parity; device-resident tables need no partition staging."""
        self.graph = graph
        self.optimizer = make_optimizer(optimizer, self.get_default_optimizer())
        self.num_negative = int(num_negative)
        self.batch_size = int(batch_size)
        self.episode_size = episode_size
        self.num_partition = num_partition
        self._allocate()
        return self

    def _allocate(self):
        shapes = self._table_shapes()
        where = self._allocation_device()
        tables = tuple(torch.zeros(s, dtype=self.float_type, device=where)
                       for s in shapes)
        # moments are always f32: bf16 EMA accumulators lose the update
        # signal at GraphVite's beta values (1 - beta ~ 1e-3 < bf16 eps)
        moments = tuple(self.optimizer.init_moments(s, where)
                        for s in shapes)
        self.state = {"tables": tables, "moments": moments}

    def _allocation_device(self):
        """Where build() allocates the state."""
        return self.device

    # -- training loop -------------------------------------------------------
    def _episode_batches(self):
        if self.episode_size not in (auto, None):
            return max(int(self.episode_size), 1)
        # enough batches per runner call; the reference's auto-rule is
        # kSamplePerVertex-based (solver.h:426-436)
        per_vertex = max(175 * self.graph.num_vertex // self.batch_size, 1)
        return int(min(max(per_vertex, 8), 200))

    def _get_sampler(self, key, make):
        """Memoize device samplers per graph (the alias-table build over all
        edges is the dominant host cost on large graphs)."""
        if not hasattr(self, "_sampler_cache"):
            self._sampler_cache = {}
        full_key = (id(self.graph),) + key
        sampler = self._sampler_cache.get(full_key)
        if sampler is None:
            sampler = make()
            # keep every sampler of the CURRENT graph, drop stale graphs'
            self._sampler_cache = {
                k: v for k, v in self._sampler_cache.items()
                if k[0] == id(self.graph)}
            self._sampler_cache[full_key] = sampler
        return sampler

    def _batch_plan(self):
        """(effective_batch, micro_batch, num_micro).

        Memory: the batch is capped by GRAPHVITE_STEP_BYTES of live step
        intermediates. Its default of 2 GB is the reference's, tuned on a
        TPU v5e and untuned for this card: it is kept so that both
        packages plan the same batches. Staleness: a batched step applies all
        its row updates at one stale parameter point, so the batch is split
        into `num_micro` sequential micro-steps, each under
        GRAPHVITE_MAX_TOUCH (default 64) touches per row. Sweep-route edge
        batches come in whole 1024-edge stream chunks; banded batches in
        whole walks of T * (L+1) slots, with a power-of-2 walk factor so
        the pool groups can divide them; position-major (multitail)
        batches in units that T tails divide."""
        if getattr(self, "_pooled_step", False):
            live_bytes = 16 * self.dim * 4
        else:
            live_bytes = (self.num_negative + 2) * self.dim * 4 * 8
        budget = float(os.environ.get("GRAPHVITE_STEP_BYTES", 2e9))
        mem_cap = max(int(budget / max(live_bytes, 1)), 512)
        eff = min(self.batch_size, mem_cap)
        unit = 256 if eff >= 256 else 8
        if getattr(self, "_sweep_scatter", False) and eff >= 1024:
            # the sweep routes take batches of whole sorted stream chunks:
            # a partial chunk forces the roll, leaving two sorted runs
            unit = 1024
        T = int(getattr(self, "_multitail_T", 0) or 0)
        if T > 1:
            # position-major walk batches split into T tails per head
            unit = unit * T // math.gcd(unit, T)
        s = int(getattr(self, "_walk_slot_unit", 0) or 0)
        if s > 1:
            mult = 64
            while mult > 1 and s * mult > eff:
                mult //= 2
            unit = s * mult
        eff = max(eff // unit * unit, unit)
        tau = float(os.environ.get("GRAPHVITE_MAX_TOUCH", 64))
        touch_cap = max(int(tau * self.graph.num_vertex
                            / (self.num_negative + 2)), 512)
        if eff <= touch_cap:
            return eff, eff, 1
        micro = min(-(-eff // touch_cap), 256)
        bm = max(eff // micro // unit * unit, unit)
        return bm * micro, bm, micro

    def _effective_batch(self):
        return self._batch_plan()[0]

    def _train_loop_device(self, step_fn, sampler, neg_state, num_epoch,
                           positive_reuse, log_frequency, state_pack=None,
                           state_unpack=None, has_relation=False):
        """Episodes of sampling + training on the device; the host reads
        the losses only at log time. `has_relation`: triplet samples and
        the knowledge-graph step signature."""
        num_edge = self.graph.num_edge
        self._state_to_device()
        batch_size, micro_batch, num_micro = self._batch_plan()
        self.effective_batch = batch_size  # what sample accounting must use
        if batch_size < self.batch_size:
            logger.info("batch_size %d -> %d to fit step intermediates",
                        self.batch_size, batch_size)
        if num_micro > 1:
            logger.info("batch of %d applied as %d sequential micro-steps "
                        "of %d (staleness bound)", batch_size, num_micro,
                        micro_batch)
            step_fn = _steps.make_micro_step(step_fn, num_micro,
                                             has_relation)
        self.num_batch = max(int(num_epoch * num_edge // batch_size), 1)
        R = max(int(positive_reuse), 1)
        # clamp so short runs don't overshoot by a whole episode
        ep_groups = max(min(self._episode_batches(), self.num_batch) // R, 1)
        sample_fn = sampler.make_sample_fn(batch_size)
        # GRAPHVITE_BULK_WALKS=1 (the reference's experimental opt-in):
        # the whole episode's walks in one chain call
        bulk_fn = None
        if (hasattr(sampler, "make_episode_sample_fn") and ep_groups > 1
                and not getattr(sampler, "position_major", False)
                and os.environ.get("GRAPHVITE_BULK_WALKS", "0") == "1"):
            bulk_fn = sampler.make_episode_sample_fn(batch_size, ep_groups)
        self._active_sample_fn = sample_fn
        self._active_bulk_fn = bulk_fn
        self._active_sampler = sampler
        # the step and negative sampler of this run, for callers that
        # replay one of its batches
        self._active_step_fn = step_fn
        self._active_neg_state = neg_state
        runner = _steps.make_fused_runner(
            step_fn, sample_fn, self.optimizer, ep_groups, R,
            state_pack=state_pack, state_unpack=state_unpack,
            bulk_sample_fn=bulk_fn)
        sampler_arrays = sampler.arrays()
        generator = torch.Generator(device=self.device)
        generator.manual_seed(self.seed + self.batch_id)
        logger.info("training %s: %d batches of %d "
                    "(device episodes of %d x %d batches)",
                    self.model, self.num_batch, batch_size, ep_groups, R)
        next_log = log_frequency
        losses_acc, all_losses = [], []
        tracing.stage(None)
        while self.batch_id < self.num_batch:
            self.state, losses = runner(self.state, self.batch_id,
                                        self.num_batch, generator,
                                        sampler_arrays, neg_state)
            self.batch_id += ep_groups * R
            losses_acc.append(losses)
            all_losses.append(losses)
            if self.batch_id >= next_log or self.batch_id >= self.num_batch:
                mean_loss = float(torch.cat(losses_acc).mean())
                logger.info("Batch id: %d / %d, loss = %.6g",
                            min(self.batch_id, self.num_batch),
                            self.num_batch, mean_loss)
                losses_acc = []
                next_log = self.batch_id + log_frequency
        tracing.stage(tracing.FINISH)
        # per-batch losses of this train() call, still on the device
        self.batch_losses = torch.cat(all_losses)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        tracing.resolve()

    def _train_loop(self, step_fn, sampler, has_relation, neg_state,
                    num_epoch, positive_reuse, log_frequency):
        """The host sampler backend (reference solver.py:514-557): a
        background thread makes pools of `episode batches x batch_size`
        positives in numpy (sampler.py, PrefetchingPool), each is copied
        from pinned host memory to the device without blocking, and the
        pool runner trains its batches, each `positive_reuse` times, with
        the step's own negatives. The batch is batch_size: no memory or
        staleness plan, as in the reference. `host_stats` holds the pools'
        production and wait seconds."""
        num_edge = self.graph.num_edge
        self._state_to_device()
        B = self.batch_size
        self.num_batch = max(int(num_epoch * num_edge // B), 1)
        self.effective_batch = B
        ep_batches = self._episode_batches()
        R = max(int(positive_reuse), 1)
        runner = _steps.make_pool_runner(step_fn, self.num_batch,
                                         self.optimizer, has_relation)
        self._active_step_fn = step_fn
        self._active_neg_state = neg_state
        generator = torch.Generator(device=self.device)
        generator.manual_seed(self.seed + self.batch_id)
        pin = self.device.type == "cuda"
        logger.info("training %s: %d batches of %d (host pools of %d "
                    "batches)", self.model, self.num_batch, B, ep_batches)
        prefetch = PrefetchingPool(sampler, ep_batches * B)
        next_log = log_frequency
        losses_acc, all_losses = [], []
        t0 = time.perf_counter()
        tracing.stage(None)
        try:
            while self.batch_id < self.num_batch:
                pool = []
                for a in prefetch.next():
                    t = torch.from_numpy(a.reshape(ep_batches, B))
                    if pin:
                        t = t.pin_memory()
                    t = t.to(self.device, non_blocking=True)
                    pool.append(t.repeat_interleave(R, dim=0) if R > 1
                                else t)
                self.state, losses = runner(self.state, pool, self.batch_id,
                                            generator, *neg_state)
                self.batch_id += ep_batches * R
                losses_acc.append(losses)
                all_losses.append(losses)
                if (self.batch_id >= next_log
                        or self.batch_id >= self.num_batch):
                    logger.info("Batch id: %d / %d, loss = %.6g",
                                min(self.batch_id, self.num_batch),
                                self.num_batch,
                                float(torch.cat(losses_acc).mean()))
                    losses_acc = []
                    next_log = self.batch_id + log_frequency
        finally:
            prefetch.close()
        tracing.stage(tracing.FINISH)
        self.batch_losses = torch.cat(all_losses)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        tracing.resolve()
        self.host_stats = {"pools": prefetch.pools, "ep_batches": ep_batches,
                           "produce_s": prefetch.produce_s,
                           "wait_s": prefetch.wait_s,
                           "loop_s": time.perf_counter() - t0}

    def clear(self):
        """Drop the state (tables and moments), freeing their device
        memory."""
        self.state = None

    def _resident(self, t):
        """Whether `t` is a tensor on the solver's device (the host master
        leaves its tables in host memory)."""
        return (torch.is_tensor(t) and t.device.type == self.device.type
                and self.device.index in (None, t.device.index))

    def _state_to_device(self):
        """Move a state that the host master left in host memory to the
        device (a flat run resumed after a blocked one)."""
        st = self.state
        if all(self._resident(t) for t in st["tables"]):
            return
        self.state = {"tables": tuple(t.to(self.device)
                                      for t in st["tables"]),
                      "moments": tuple(tuple(m.to(self.device) for m in g)
                                       for g in st["moments"])}

    # -- persistence ---------------------------------------------------------
    def table(self, i):
        """Host copy of a table, always float32."""
        return self.state["tables"][i].detach().float().cpu().numpy()

    def save_checkpoint(self, file_name):
        """Mid-training checkpoint: tables + optimizer moments + batch
        counter (bf16 tables are stored as their uint16 bits)."""
        with open(file_name, "wb") as f:
            pickle.dump({"state": state_to_numpy(self.state),
                         "batch_id": self.batch_id,
                         "num_batch": self.num_batch, "model": self.model,
                         "optimizer": self.optimizer}, f,
                        protocol=pickle.HIGHEST_PROTOCOL)
        logger.info("checkpoint saved to %s (batch %d)", file_name,
                    self.batch_id)

    def load_checkpoint(self, file_name):
        """Load a checkpoint written by save_checkpoint (pickle: only load
        files this program wrote)."""
        with open(file_name, "rb") as f:
            ckpt = pickle.load(f)
        self.state = state_from_numpy(ckpt["state"], self.device,
                                      self.float_type)
        self.batch_id = ckpt["batch_id"]
        self.num_batch = ckpt["num_batch"]
        self.model = ckpt["model"]
        self.optimizer = ckpt["optimizer"]
        logger.info("checkpoint loaded from %s (batch %d)", file_name,
                    self.batch_id)
        return self

    def __repr__(self):
        return "%s<dim=%d, %s, %s>" % (type(self).__name__, self.dim,
                                       str(self.float_type).replace(
                                           "torch.", ""), self.device)


class GraphSolver(SolverBase):
    """Node-embedding solver (ref graph.cuh:586-813), walk route."""

    def get_default_optimizer(self):
        # ref graph.cuh:634-636
        return Optimizer(type="SGD", lr=0.025, weight_decay=5e-3, schedule="linear")

    def get_available_models(self):
        return set(GRAPH_MODELS)

    def _table_shapes(self):
        v = self.graph.num_vertex
        return ((v, self.dim), (v, self.dim))

    def _allocate(self):
        """One worker: zero tables where `_allocation_device` says. Several
        workers: none yet; the first run makes the tables in host memory
        and shards them (zeros of a billion-edge graph's tables would take
        tens of seconds to write, and are never trained)."""
        if self.num_worker > 1:
            self.state = None
            return
        super()._allocate()

    # rows of one device draw of the vertex table's initial values
    INIT_CHUNK_ROWS = 1 << 21

    def init_embeddings(self, host=False):
        """vertex ~ U(-0.5/dim, 0.5/dim), context = 0 (graph.cuh:724-731),
        drawn on the device from a generator seeded by the solver's rng,
        INIT_CHUNK_ROWS rows at a time. The previous state is dropped
        first, so the device never holds two (tables and moments are most
        of its memory). `host`: the state is made in host memory (the
        host master's tables, and the tables of several workers, which
        their engines shard), from the same draws."""
        self.state = None
        v = self.graph.num_vertex
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(self._rng.integers(2**31)))
        host = host or self.num_worker > 1
        where = torch.device("cpu") if host else self.device
        lo, hi = -0.5 / self.dim, 0.5 / self.dim
        vertex = torch.empty((v, self.dim), dtype=self.float_type,
                             device=where)
        for r in range(0, v, self.INIT_CHUNK_ROWS):
            n = min(self.INIT_CHUNK_ROWS, v - r)
            u = torch.rand((n, self.dim), generator=gen, device=self.device)
            vertex[r:r + n] = u.mul_(hi - lo).add_(lo).to(self.float_type)
            del u
        tables = (vertex, torch.zeros((v, self.dim), dtype=self.float_type,
                                      device=where))
        moments = tuple(self.optimizer.init_moments((v, self.dim), where)
                        for _ in range(2))
        self.state = {"tables": tables, "moments": moments}

    def table_rows(self, table, ids):
        """Rows `ids` (an int64 tensor) of table `table` (0 vertex, 1
        context), float32 on the ids' device, read where the tables are:
        after a run on several workers from the shards on their cards,
        with no gather."""
        live = self._live
        if live is not None:
            return live.trainer.rows(live.shards, table, ids)
        t = self.state["tables"][table]
        return t[ids.to(t.device)].float().to(ids.device)

    @property
    def vertex_embeddings(self):
        return self.table(0)

    @property
    def context_embeddings(self):
        return self.table(1)

    @_traced_call
    def train(self, model="LINE", num_epoch=2000, resume=False,
              augmentation_step=auto, random_walk_length=40,
              random_walk_batch_size=100, shuffle_base=auto, p=1.0, q=1.0,
              positive_reuse=1, negative_sample_exponent=0.75,
              negative_weight=5.0, negative_sharing=auto,
              log_frequency=1000):
        """Train on the device, routed as the reference routes it: the
        edge route for augmentation_step 1, walks above it (node2vec's
        biased by p and q). The step family: a shared negative pool unless
        GRAPHVITE_NEG_SHARING=0 picks the classic K-draw step
        (`negative_sharing` is read as auto for every value a caller can
        pass equal to 0, False included, as the reference reads it). The
        pooled walk layout: banded, or GRAPHVITE_WALK_STEP=multitail|pair
        (GRAPHVITE_MULTITAIL=0: pair). `sampler_backend="host"` trains
        the host samplers' pools (`_train_host`); `random_walk_batch_size`
        and `shuffle_base` serve them only."""
        if model not in self.get_available_models():
            raise ValueError("unknown model `%s`" % model)
        num_vertex = self.graph.num_vertex
        num_edge = self.graph.num_edge
        if augmentation_step in (auto, None):
            avg_degree = max(float(num_edge) / num_vertex, 1.0 + 1e-6)
            augmentation_step = max(
                int(math.log(EXPECTED_DEGREE) / math.log(avg_degree)), 1)
        augmentation_step = int(augmentation_step)
        if augmentation_step > random_walk_length:
            raise ValueError("`random_walk_length` must be >= `augmentation_step`")
        self.model = model
        if shuffle_base in (auto, None):
            shuffle_base = augmentation_step
        if model in ("DeepWalk", "node2vec"):
            shuffle_base = 1  # graph.cuh:784-786
        if self.num_worker > 1:
            # the multi-device engines (reference solver.py:819-827)
            if not resume or not self._has_state() or self.batch_id == 0:
                self.init_embeddings()
                self.batch_id = 0
            self.augmentation_step = augmentation_step
            self._train_loop_mesh(model, num_epoch, augmentation_step,
                                  random_walk_length, p, q,
                                  float(negative_weight),
                                  float(negative_sample_exponent),
                                  log_frequency)
            return
        if self.sampler_backend != "device":
            self._train_host(model, num_epoch, resume, augmentation_step,
                             random_walk_length, random_walk_batch_size,
                             shuffle_base, p, q, positive_reuse,
                             negative_sample_exponent, negative_weight,
                             negative_sharing, log_frequency)
            return
        # the edge route trains blocked episodes for num_partition > 1 or
        # tables that overflow the device, from host masters where the
        # loop's demand does: decided first, so that such tables are made
        # in host memory
        blocked = self._blocked_plan() if augmentation_step == 1 else None
        if not resume or self.state is None or self.batch_id == 0:
            self.init_embeddings(host=bool(blocked and blocked[1]))
            self.batch_id = 0
        self.augmentation_step = augmentation_step

        # negative sampler: tail-side, degree^exponent (solver.h:1264-1278);
        # blocked episodes draw from per-partition tables instead
        neg_state = None
        if not blocked:
            weights = np.maximum(
                np.asarray(self.graph.vertex_weights, dtype=np.float64),
                1e-12) ** negative_sample_exponent
            neg_state = tuple(
                torch.as_tensor(a, device=self.device)
                for a in device_alias_arrays(AliasTable(weights)))

        env = os.environ.get
        if negative_sharing in (auto, None):
            negative_sharing = env("GRAPHVITE_NEG_SHARING", "1") != "0"
        negative_sharing = bool(negative_sharing)
        # pooled steps keep ~16 [B, D] tensors live per sample, the classic
        # step [B, K+1, D] chains (the batch plan's memory cap)
        self._pooled_step = negative_sharing
        # SGD safety net for dense small graphs (optim.apply_row_updates)
        trust = float(env("GRAPHVITE_TRUST", 0.25)) or None
        # the sweep routes (the hand-written sorted-id kernels): on by
        # default on the card, GRAPHVITE_SWEEP_SCATTER=1 forces them on any
        # device (the CPU tests), "0" turns them off; they engage only for
        # pooled steps on tables above the dense-update size, read at call
        # time
        sweep_env = env("GRAPHVITE_SWEEP_SCATTER", "")
        sweep_enabled = (sweep_env == "1"
                         or (sweep_env != "0" and self.device.type == "cuda"))
        big = num_vertex * self.dim > _optim.DENSE_UPDATE_ELEMS
        self._sweep_scatter = self._sweep_gather = False
        self._sweep_context = False
        self._banded_fused = False
        self._multitail_T = self._walk_slot_unit = 0
        if blocked:
            self._train_loop_blocked(
                GRAPH_MODELS[model], num_epoch, blocked[0], blocked[1],
                float(negative_weight), float(negative_sample_exponent),
                log_frequency)
            return
        if augmentation_step == 1:
            # the context sweep needs no sorted ids, so it has a gate of
            # its own (GRAPHVITE_SWEEP_CONTEXT: "1" forces it, "0" stops it)
            ctx_env = env("GRAPHVITE_SWEEP_CONTEXT", "")
            sweep_context = (negative_sharing and big
                             and (ctx_env == "1" or (ctx_env != "0"
                                                     and sweep_enabled)))
            self._train_edges(num_epoch, positive_reuse, negative_weight,
                              neg_state, trust,
                              sweep_enabled and big and negative_sharing,
                              sweep_context, negative_sharing, log_frequency)
            return
        # GRAPHVITE_SWEEP_WALK=1 (the reference's experimental opt-in):
        # walk pairs sorted by head in the step (sort_heads) take the sweep
        # routes where their gate holds, on the pair layout
        sort_heads = (negative_sharing and sweep_enabled and big
                      and env("GRAPHVITE_SWEEP_WALK", "0") == "1")
        if sort_heads:
            ctx_env = env("GRAPHVITE_SWEEP_CONTEXT", "")
            self._sweep_scatter = True
            self._sweep_context = ctx_env == "1" or (ctx_env != "0"
                                                     and sweep_enabled)
            self._sweep_gather = env("GRAPHVITE_SWEEP_GATHER", "1") != "0"
        # the pooled walk layouts, exact regroupings of one pair set:
        # "pair" (one slot per pair), "multitail" (one sample per walk
        # position with its T tails), "banded" (whole walks, the default)
        walk_step_mode = env("GRAPHVITE_WALK_STEP", "banded")
        if env("GRAPHVITE_MULTITAIL", "1") == "0":
            walk_step_mode = "pair"
        walk_grouped = (negative_sharing and not sort_heads
                        and walk_step_mode in ("banded", "multitail"))
        banded = walk_grouped and walk_step_mode == "banded"
        multitail = walk_grouped and walk_step_mode == "multitail"
        # bidirectional emission mines the reversed pairs of each walk
        # (grouped layouts on an undirected graph); GRAPHVITE_WALK_BIDIR=0
        # restores forward-only
        walk_bidir = (walk_grouped and bool(self.graph.as_undirected)
                      and env("GRAPHVITE_WALK_BIDIR", "1") != "0")
        num_tail = (augmentation_step * (2 if walk_bidir else 1)
                    if walk_grouped else 0)
        self._multitail_T = num_tail if multitail else 0
        # banded batches come in whole-walk units of T * (L+1) slots
        self._walk_slot_unit = (num_tail * (random_walk_length + 1)
                                if banded else 0)
        # groups scale with the micro-batch, the unit the pool step sees
        pool_batch = self._batch_plan()[1]
        # grouped layouts default to 64 pool rows, the pair layout to 128
        pool_size = int(env("GRAPHVITE_POOL_SIZE",
                            64 if walk_grouped else 128))
        if banded:
            # groups partition WALKS; bound coherent pair mass per pool row
            # at a ~2048-slot target
            slot_unit = self._walk_slot_unit
            pool_groups = _steps.graph_pool_groups(
                max(pool_batch // slot_unit, 1),
                target_group=max(2048 // slot_unit, 1))
            # fused (vertex|context) arena: ONE gather + ONE scatter per
            # batch. SGD only, and only where the trust clip is inactive
            # (its row-norm logic is per table); packed/unpacked once per
            # episode. GRAPHVITE_SWEEP_BANDED=1 takes the separate tables
            # through kernel 1's unsorted front end instead
            self._banded_fused = (
                self.optimizer.num_moment == 0
                and (trust is None or big)
                and env("GRAPHVITE_SWEEP_BANDED", "0") != "1"
                and env("GRAPHVITE_FUSED_ARENA", "1") != "0")
            if self._banded_fused:
                step_fn = _steps.make_graph_banded_fused_step(
                    self.optimizer, self.num_negative, float(negative_weight),
                    augmentation_step, walk_bidir, pool_size=pool_size,
                    pool_groups=pool_groups)
            else:
                step_fn = _steps.make_graph_banded_walk_step(
                    self.optimizer, self.num_negative, float(negative_weight),
                    augmentation_step, walk_bidir, pool_size=pool_size,
                    pool_groups=pool_groups, trust=trust)
        elif multitail:
            # groups bound coherent PAIR mass per pool row, so the target
            # in positions shrinks by the tail count
            pool_groups = _steps.graph_pool_groups(
                pool_batch // num_tail,
                target_group=max(2048 // num_tail, 256))
            step_fn = _steps.make_graph_pool_multitail_step(
                self.optimizer, self.num_negative, float(negative_weight),
                num_tail, pool_size=pool_size, pool_groups=pool_groups,
                trust=trust)
        elif negative_sharing:
            # walk pairs arrive unsorted: the sweeps stay off unless the
            # step sorts them (sort_heads)
            step_fn = _steps.make_graph_pool_step(
                self.optimizer, self.num_negative, float(negative_weight),
                pool_size=pool_size,
                pool_groups=_steps.graph_pool_groups(pool_batch),
                trust=trust, sweep_vertex=sort_heads,
                sweep_context=self._sweep_context,
                sweep_gather=self._sweep_gather, sort_heads=sort_heads)
        else:
            step_fn = _steps.make_graph_train_step(
                GRAPH_MODELS[model], self.optimizer, self.num_negative,
                float(negative_weight), trust=trust)

        demand, budget = self._memory_demand()
        if demand > budget:
            logger.warning(
                "device memory demand %.1f GB > budget %.1f GB; walk "
                "augmentation trains the flat tables regardless",
                demand / 1e9, budget / 1e9)

        eff_batch = self._effective_batch()
        biased = model == "node2vec"
        sampler = self._get_sampler(
            ("walk", augmentation_step, int(random_walk_length), biased,
             float(p), float(q), eff_batch, multitail, banded, walk_bidir,
             # the membership structure and the proposal count shape the
             # built sampler and its chain (node2vec only)
             env("GRAPHVITE_N2V_CUCKOO", "1"),
             env("GRAPHVITE_N2V_PROPOSALS", ""),
             env("GRAPHVITE_CUCKOO_MAX_BYTES", ""), str(self.device)),
            lambda: DeviceWalkSampler.build(
                self.graph, augmentation_step, random_walk_length, eff_batch,
                biased=biased, p=p, q=q, position_major=multitail,
                bidir=walk_bidir, banded=banded, device=self.device))
        fused = self._banded_fused
        self._train_loop_device(
            step_fn, sampler, neg_state, num_epoch, positive_reuse,
            log_frequency,
            state_pack=_steps.banded_fused_pack if fused else None,
            state_unpack=_steps.banded_fused_unpack if fused else None)

    def _train_host(self, model, num_epoch, resume, augmentation_step,
                    random_walk_length, random_walk_batch_size, shuffle_base,
                    p, q, positive_reuse, negative_sample_exponent,
                    negative_weight, negative_sharing, log_frequency):
        """The host sampler backend (reference solver.py:1154-1162): flat
        tables on the device, positives from EdgeSampler (augmentation
        step 1) or RandomWalkSampler (above; biased for node2vec). The
        reference's device-only gates hold: no sweep routes, no blocked
        episodes, no grouped walk layouts, so the pooled step is the pair
        step over batch_size (its groups from batch_size) with 128 pool
        rows, or the classic step for GRAPHVITE_NEG_SHARING=0."""
        env = os.environ.get
        if not resume or self.state is None or self.batch_id == 0:
            self.init_embeddings()
            self.batch_id = 0
        self.augmentation_step = augmentation_step
        weights = np.maximum(
            np.asarray(self.graph.vertex_weights, dtype=np.float64),
            1e-12) ** negative_sample_exponent
        neg_state = tuple(torch.as_tensor(a, device=self.device)
                          for a in device_alias_arrays(AliasTable(weights)))
        if negative_sharing in (auto, None):
            negative_sharing = env("GRAPHVITE_NEG_SHARING", "1") != "0"
        self._pooled_step = negative_sharing = bool(negative_sharing)
        trust = float(env("GRAPHVITE_TRUST", 0.25)) or None
        self._sweep_scatter = self._sweep_gather = False
        self._sweep_context = self._banded_fused = False
        self._multitail_T = self._walk_slot_unit = 0
        if negative_sharing:
            step_fn = _steps.make_graph_pool_step(
                self.optimizer, self.num_negative, float(negative_weight),
                pool_size=int(env("GRAPHVITE_POOL_SIZE", 128)),
                pool_groups=_steps.graph_pool_groups(self.batch_size),
                trust=trust)
        else:
            step_fn = _steps.make_graph_train_step(
                GRAPH_MODELS[model], self.optimizer, self.num_negative,
                float(negative_weight), trust=trust)
        seed = int(self._rng.integers(2**31))
        if augmentation_step == 1:
            sampler = EdgeSampler(self.graph, seed=seed)
        else:
            sampler = RandomWalkSampler(
                self.graph, augmentation_step, random_walk_length,
                random_walk_batch_size, shuffle_base, seed=seed,
                biased=(model == "node2vec"), p=p, q=q)
        self._train_loop(step_fn, sampler, False, neg_state, num_epoch,
                         positive_reuse, log_frequency)

    def _train_loop_mesh(self, model_name, num_epoch, augmentation_step,
                         random_walk_length, p, q, negative_weight,
                         negative_sample_exponent, log_frequency):
        """The multi-device engine (reference solver.py:639-793): one
        vertex partition per worker, on-worker block or walk sampling
        (parallel/mesh.py:ShardedGraphTrainer). Edges mode (augmentation
        step 1) trains the shared-pool step on the resident (head, tail)
        block and rotates the context shards around the ring; walks mode
        trains the banded step with rows fetched from and updated on their
        owners. GRAPHVITE_NEG_SHARING=0 takes the classic per-draw step in
        edges mode; walks mode is banded only.

        The batch plan: GRAPHVITE_STEP_BYTES of step intermediates, the
        staleness touch cap over a worker's V / P rows, and for walks
        whole walks times a power-of-2 factor. Episodes: edges mode
        revisits every block GRAPHVITE_MIN_SWEEPS times (many short
        residencies), walks mode has no residency. The state comes back
        in canonical order on the first worker's device (the context
        shards and their moments rolled back by the rotation), so
        resume=True continues from the gathered moments. Per-batch losses
        stay on the device (`batch_losses`); the walks engine's dropped
        requests are in `mesh_stats`."""
        _one_process("GraphSolver")
        env = os.environ.get
        P_ = self.num_worker
        walks = int(augmentation_step) > 1
        negative_sharing = env("GRAPHVITE_NEG_SHARING", "1") != "0" or walks
        self._pooled_step = negative_sharing
        budget = float(env("GRAPHVITE_STEP_BYTES", 2e9))
        live_bytes = (16 * self.dim * 4 if negative_sharing
                      else (self.num_negative + 2) * self.dim * 4 * 8)
        mem_cap = max(int(budget / max(live_bytes, 1)), 512)
        tau = float(env("GRAPHVITE_MAX_TOUCH", 64))
        cap_rows = max(self.graph.num_vertex // P_, 1)
        touch_cap = max(int(tau * cap_rows / (self.num_negative + 2)), 512)
        batch_size = min(self.batch_size, mem_cap, touch_cap)
        pool_size = int(env("GRAPHVITE_POOL_SIZE", 64 if walks else 128))
        trust = float(env("GRAPHVITE_TRUST", 0.25)) or None
        if walks:
            bidir = (bool(self.graph.as_undirected)
                     and env("GRAPHVITE_WALK_BIDIR", "1") != "0")
            T = int(augmentation_step) * (2 if bidir else 1)
            slot_unit = T * (int(random_walk_length) + 1)
            mult = 64
            while mult > 1 and slot_unit * mult > batch_size:
                mult //= 2
            unit = slot_unit * mult
        else:
            bidir = False
            unit = 256 if batch_size >= 256 else 8
        batch_size = max(batch_size // unit * unit, unit)
        if batch_size < self.batch_size:
            logger.info("batch_size %d -> %d per worker (%d workers)",
                        self.batch_size, batch_size, P_)
        self.effective_batch = batch_size
        self.num_batch = max(int(num_epoch * self.graph.num_edge
                                 // batch_size), 1)
        min_sweeps = int(env("GRAPHVITE_MIN_SWEEPS", 16))
        if walks:
            ep_batches = max(min(self._episode_batches(),
                                 max(self.num_batch // P_, 1)), 1)
        else:
            sweep_cap = max(self.num_batch // (P_ * P_ * min_sweeps), 1)
            ep_batches = max(min(self._episode_batches(), sweep_cap,
                                 max(self.num_batch // P_, 1)), 1)

        # the episode length is not in the key: it is the trainer's to
        # change call by call, while the walk state stays
        key = (id(self.graph), "mesh", model_name, self.optimizer,
               self.num_negative, float(negative_weight),
               tuple(self.worker_devices), batch_size,
               int(augmentation_step), int(random_walk_length), float(p),
               float(q), negative_sharing,
               pool_size, bidir, trust, env("GRAPHVITE_WALK_ROUTE_SLACK", ""),
               # the walks engine's core reads it when it is built
               env("GRAPHVITE_BF16_BAND", ""))
        setup = {}
        live = self._live
        if getattr(self, "_mesh_key", None) != key:
            if live is not None:
                # another engine: the shards come home first
                _ = self.state
                live = None
            t0 = time.perf_counter()
            part = VertexPartition(np.asarray(self.graph.degrees), P_)
            setup["partition_s"] = time.perf_counter() - t0
            group = DeviceGroup(self.worker_devices)
            common = dict(num_negative=self.num_negative,
                          negative_weight=float(negative_weight),
                          batch_size=batch_size, ep_batches=ep_batches,
                          trust=trust)
            if walks:
                walk_cfg = dict(
                    augmentation_step=int(augmentation_step),
                    walk_length=int(random_walk_length),
                    batch_walks=max(batch_size // slot_unit, 1),
                    bidir=bidir, pool_size=pool_size,
                    biased=(model_name == "node2vec"), p=float(p),
                    q=float(q))
                trainer = ShardedGraphTrainer(
                    group, part, self.dim, GRAPH_MODELS[model_name],
                    self.optimizer, sampler_mode="walks", walk_cfg=walk_cfg,
                    **common)
            else:
                trainer = ShardedGraphTrainer(
                    group, part, self.dim, GRAPH_MODELS[model_name],
                    self.optimizer, sampler_mode="edges",
                    negative_sharing=negative_sharing, pool_size=pool_size,
                    **common)
            self._mesh_trainer = None      # free the old engine's arrays
            self._mesh_sample_state = None
            self._mesh_negatives = None
            t0 = time.perf_counter()
            if walks:
                self._mesh_sample_state = trainer.build_sample_state(
                    self.graph)
            else:
                # the block tables depend on the graph and P alone: kept
                # for the next engine on them (another optimizer or step)
                blocks_key = (id(self.graph), P_)
                cached = getattr(self, "_mesh_blocks", None)
                if cached is None or cached[0] != blocks_key:
                    self._mesh_blocks = None
                    self._mesh_blocks = (blocks_key,
                                         BlockEdgeTables(self.graph, part))
                self._mesh_sample_state = trainer.build_blocks(
                    self.graph, self._mesh_blocks[1])
            setup["sample_state_s"] = time.perf_counter() - t0
            self._mesh_trainer = trainer
            self._mesh_key = key
        trainer = self._mesh_trainer
        trainer.ep_batches = ep_batches
        group = trainer.group
        demand, budget = self._memory_demand()
        if demand > budget:
            logger.warning("device memory demand %.1f GB a card > budget "
                           "%.1f GB", demand / 1e9, budget / 1e9)
        t0 = time.perf_counter()
        neg_key = float(negative_sample_exponent)
        cached = getattr(self, "_mesh_negatives", None)
        if walks and cached is not None and cached[0] == neg_key:
            # the walks engine's table is global and never moves
            neg_state = cached[1]
        else:
            neg_state = trainer.init_negative_state(
                np.asarray(self.graph.vertex_weights),
                negative_sample_exponent)
            self._mesh_negatives = (neg_key, neg_state) if walks else None
        setup["negative_alias_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if live is not None:
            # a resumed run trains the shards the last one left
            state = live.shards
            self._live = None
            if not walks:
                neg_state = live.negatives
        else:
            st = self.state
            self.state = None       # the shards replace the tables
            state = trainer.init_state(st["tables"][0], st["tables"][1],
                                       moments=st["moments"])
            del st
        setup["split_s"] = time.perf_counter() - t0
        logger.info("training %s on %d workers: %d batches of %d "
                    "(episodes of %d)", model_name, P_, self.num_batch,
                    batch_size, ep_batches)
        trainer.reset_drop_counts()
        next_log = log_frequency
        losses_acc, all_losses = [], []
        episodes = 0
        t0 = time.perf_counter()
        tracing.stage(None)
        while self.batch_id < self.num_batch:
            state, neg_state, losses = trainer.run_episode(
                state, self._mesh_sample_state, neg_state, self.batch_id,
                self.num_batch, self.seed)
            self.batch_id += ep_batches * P_
            episodes += 1
            # [EP, P]: batch i of every worker, in the order they train
            losses = torch.stack([l.to(self.device) for l in losses], dim=1)
            losses_acc.append(losses.reshape(-1))
            all_losses.append(losses.reshape(-1))
            if self.batch_id >= next_log or self.batch_id >= self.num_batch:
                l = torch.cat(losses_acc)
                # zero-loss batches come only from empty blocks
                l = l[l > 0]
                logger.info("Batch id: %d / %d, loss = %.6g",
                            min(self.batch_id, self.num_batch),
                            self.num_batch,
                            float(l.mean()) if l.numel() else 0.0)
                losses_acc = []
                next_log = self.batch_id + log_frequency
        tracing.stage(tracing.FINISH)
        for d in group.distinct:
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        loop_s = time.perf_counter() - t0
        tracing.resolve()
        # the shards stay on the cards: reading `state` gathers them
        self._live = _LiveShards(trainer, state, neg_state)
        self.batch_losses = torch.cat(all_losses)
        drops, emitted = (trainer.check_drops() if walks else (0, 0))
        self.mesh_stats = {"workers": P_, "ep_batches": ep_batches,
                           "episodes": episodes, "batch_size": batch_size,
                           "loop_s": loop_s, "setup_s": setup,
                           "dropped": drops, "requests": emitted,
                           "valid_pairs": (trainer.valid_pairs() if walks
                                           else None)}

    def _allocation_device(self):
        """Tables over the device budget are allocated in host memory:
        blocked episodes stage them from there, and a flat route moves
        them to the device when it trains. With several workers the
        whole tables are always made in host memory: the engines shard
        them onto the cards, and no card holds a whole table."""
        if self.num_worker > 1:
            return torch.device("cpu")
        demand, budget = self._memory_demand()
        return torch.device("cpu") if demand > budget else self.device

    def _memory_demand(self, edge_bytes=None):
        """(bytes the tables, moments and edge arrays need on the device,
        the device's budget). `edge_bytes`: the edge arrays' bytes; by
        default the auto rule's 16 per edge (reference solver.py:1075).

        With several workers, per card: one partition's rows of the
        tables and moments (a 1 / num_worker share, rounded up), the
        walks engine's state on every card (`edge_bytes` by default: the
        CSR indices, 4 bytes a directed edge, and 40 bytes a vertex: its
        packed row start and degree, its row start for the start search,
        the two partition maps and the negative alias table), and a
        worker-batch's exchange (a row of 2D floats and an id for each of
        its batch_size slots, three times)."""
        n_moms = 2 * self.optimizer.num_moment
        itemsize = torch.empty((), dtype=self.float_type).element_size()
        V = self.graph.num_vertex
        budget = hbm_budget_bytes(self.gpu_memory_limit, self.device)
        if self.num_worker > 1:
            W = self.num_worker
            rows = -(-V // W)
            if edge_bytes is None:
                n_dir = getattr(self.graph, "num_directed_edge",
                                2 * self.graph.num_edge)
                edge_bytes = 4 * int(n_dir) + 40 * V
            batch = 3 * self.batch_size * (2 * self.dim * 4 + 8)
            demand = (rows * self.dim * (2 * itemsize + n_moms * 4)
                      + edge_bytes + batch)
            return demand, budget
        if edge_bytes is None:
            edge_bytes = 16 * self.graph.num_edge
        demand = (V * self.dim * (2 * itemsize + n_moms * 4) + edge_bytes)
        return demand, budget

    def _blocked_plan(self):
        """(P, host_master) for blocked episodes on the edge route, or None
        for flat tables (reference solver.py:1063-1102, :235-246).

        num_partition auto: tables in the budget train flat; above it, the
        smallest power of two P (at most 64) whose two resident shards
        (2 demand / P) fit. An explicit num_partition > 1 trains blocked.
        The host master engages where the loop's own demand estimate
        (edges as their local heads' bytes times 4: heads, tails, prob,
        alias) exceeds the budget; GRAPHVITE_HOST_MASTER=1/0 forces it."""
        num_partition = self.num_partition
        if num_partition in (auto, None):
            demand, budget = self._memory_demand()
            if demand <= budget:
                return None
            num_partition = 2
            while (num_partition < 64
                   and 2 * demand / num_partition > budget):
                num_partition *= 2
            logger.info("device memory demand %.1f GB > budget %.1f GB: "
                        "blocked episodes with %d^2 blocks",
                        demand / 1e9, budget / 1e9, num_partition)
        num_partition = int(num_partition)
        if num_partition <= 1:
            return None
        hm_env = os.environ.get("GRAPHVITE_HOST_MASTER")
        demand, budget = self._memory_demand(
            np.asarray(self.graph.edge_heads).size * 4 * 4)
        host_master = (hm_env == "1" if hm_env is not None
                       else demand > budget)
        if host_master:
            logger.info("host-master mode: shards staged per episode (%s)",
                        "forced by GRAPHVITE_HOST_MASTER" if hm_env == "1"
                        else "demand %.1f GB > budget %.1f GB"
                        % (demand / 1e9, budget / 1e9))
        return num_partition, host_master

    def _train_loop_blocked(self, model_cls, num_epoch, num_partition,
                            host_master, negative_weight,
                            negative_sample_exponent, log_frequency):
        """Block-partitioned episodes on one card (reference
        solver.py:168-362): every episode trains one (head, tail) partition
        block through ops/blocked.py:make_block_episode_runner, so the
        table updates touch [cap, D] shards. Blocks are scheduled on the
        host in proportion to their edge counts, with the reference's numpy
        generator, so both packages visit the same block sequence.

        `host_master`: the shards' masters (tables and moments) live in
        host memory, pinned on a CUDA device, and each side keeps ONE shard
        on the card (the reference worker's one-slot cache,
        solver.h:1349-1495): a hit reuses the resident shard, a miss writes
        the evicted shard back to its master and uploads the next. Copies
        run on the current stream, so a write-back lands before any later
        upload of the same master; the host reads the masters only after a
        synchronize. The state stays in host memory afterwards, where
        `predict` scores it in chunks. A failed pin, upload or write-back
        raises. Counts and times of the run are in `self.blocked_stats`."""
        P_ = int(num_partition)
        dev = self.device
        on_cuda = dev.type == "cuda"
        self.num_batch = max(int(num_epoch * self.graph.num_edge
                                 // self.batch_size), 1)
        self.effective_batch = self.batch_size
        # many short residencies: every block must be revisited often or
        # its burst gets overwritten (ref auto episode_size
        # solver.h:426-436)
        min_sweeps = int(os.environ.get("GRAPHVITE_MIN_SWEEPS", 16))
        sweep_cap = max(self.num_batch // (P_ * P_ * min_sweeps), 1)
        ep_batches = max(min(self._episode_batches(), sweep_cap,
                             self.num_batch), 1)

        prep_key = (id(self.graph), "blocked", P_,
                    float(negative_sample_exponent), str(dev))
        if getattr(self, "_blocked_key", None) != prep_key:
            setup = {}
            t0 = time.perf_counter()
            part = VertexPartition(np.asarray(self.graph.degrees), P_)
            setup["partition_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            tables = _blocked.FlatBlockTables(self.graph, part)
            setup["block_tables_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            nprob, nalias, nsizes = part.negative_alias_arrays(
                np.asarray(self.graph.vertex_weights),
                negative_sample_exponent)
            setup["negative_alias_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            self._blocked_edges = tables.edge_tensors(dev)
            self._blocked_neg = (
                [torch.from_numpy(nprob[p]).to(dev) for p in range(P_)],
                [torch.from_numpy(nalias[p]).to(dev) for p in range(P_)],
                [int(nsizes[p]) for p in range(P_)])
            setup["upload_s"] = time.perf_counter() - t0
            self._blocked_part = part
            self._blocked_tables = tables
            self._blocked_setup_s = setup
            self._blocked_key = prep_key
        part = self._blocked_part
        offsets = self._blocked_tables.offsets
        nprob, nalias, nsizes = self._blocked_neg

        step = make_sharded_graph_step(model_cls, self.optimizer,
                                       self.num_negative, negative_weight)
        runner = _blocked.make_block_episode_runner(
            step, self.optimizer, self.batch_size, ep_batches)
        stats = {"num_partition": P_, "host_master": bool(host_master),
                 "ep_batches": ep_batches, "episodes": 0, "hits": 0,
                 "misses": 0, "h2d_bytes": 0, "d2h_bytes": 0,
                 "setup_s": dict(self._blocked_setup_s)}
        copies = []          # (direction, bytes, start, end) per transfer

        def timed_copy(direction, nbytes, fn):
            if on_cuda:
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
                out = fn()
                end.record()
            else:
                start = time.perf_counter()
                out = fn()
                end = time.perf_counter()
            copies.append((direction, nbytes, start, end))
            stats[direction + "_bytes"] += nbytes
            return out

        # per-partition shards: on the device, or host masters
        t0 = time.perf_counter()
        state = self.state
        self.state = None      # the shards replace the tables
        tables = list(state["tables"])
        mom_groups = [list(g) for g in state["moments"]]
        del state
        pinned = host_master and on_cuda
        if host_master:
            stats["master_memory"] = ("pinned" if pinned else
                                      "pageable (the solver runs on the "
                                      "CPU)")

        def master_buffer(like):
            shape = (part.capacity,) + tuple(like.shape[1:])
            if not pinned:
                return torch.empty(shape, dtype=like.dtype)
            try:
                return torch.empty(shape, dtype=like.dtype, pin_memory=True)
            except RuntimeError as e:
                raise RuntimeError(
                    "pinning a %.2f GB host master failed (the host's "
                    "locked-memory limit?): %s" % (
                        like.element_size() * math.prod(shape) / 1e9,
                        e)) from e

        def split(t):
            parts = []
            for p in range(P_):
                if host_master:
                    buf = master_buffer(t)
                    if t.device.type == "cpu":
                        part.shard_tensor(t, p, out=buf)
                    else:
                        buf.copy_(part.shard_tensor(t, p))
                    parts.append(buf)
                else:
                    parts.append(part.shard_tensor(t, p).to(dev))
            return parts

        def split_all(ts):
            out = []
            for k in range(len(ts)):
                out.append(split(ts[k]))
                ts[k] = None      # free each table once it is split
            return out

        vparts, cparts = split_all(tables)
        vmoms = split_all(mom_groups[0])
        cmoms = split_all(mom_groups[1])
        if on_cuda:
            torch.cuda.synchronize(dev)
        stats["split_s"] = time.perf_counter() - t0
        if host_master:
            stats["master_gb"] = sum(
                x.element_size() * x.numel() for group in
                ([vparts, cparts] + vmoms + cmoms) for x in group) / 1e9
            logger.info("host masters: %.2f GB of %s host memory",
                        stats["master_gb"], stats["master_memory"])

        # one-slot device caches: partition -> (table, moments) on the card
        vcache, ccache = {}, {}

        def write_back(cache, masters, mom_masters):
            for old, (ot, oms) in cache.items():
                for dst, src in zip([masters] + mom_masters, (ot,) + oms):
                    timed_copy("d2h", src.element_size() * src.numel(),
                               lambda: dst[old].copy_(src,
                                                      non_blocking=True))
            cache.clear()

        def stage(cache, p, masters, mom_masters):
            if p in cache:
                stats["hits"] += 1
                return cache[p]
            stats["misses"] += 1
            write_back(cache, masters, mom_masters)
            staged = [timed_copy("h2d", m[p].element_size() * m[p].numel(),
                                 lambda: m[p].to(dev, non_blocking=True,
                                                 copy=True))
                      for m in [masters] + mom_masters]
            cache[p] = (staged[0], tuple(staged[1:]))
            return cache[p]

        counts = np.maximum((offsets[1:] - offsets[:-1]).astype(np.float64),
                            0)
        block_p = counts / counts.sum()
        rng = np.random.default_rng(self.seed ^ 0x5eed)
        generator = torch.Generator(device=dev)
        generator.manual_seed(self.seed + self.batch_id)
        logger.info("training %s: %d batches of %d (blocked episodes of %d "
                    "batches, %d^2 blocks%s)", self.model, self.num_batch,
                    self.batch_size, ep_batches, P_,
                    ", host master" if host_master else "")
        next_log = log_frequency
        losses_acc, all_losses = [], []
        t0 = time.perf_counter()
        tracing.stage(None)
        while self.batch_id < self.num_batch:
            blk = int(rng.choice(block_p.size, p=block_p))
            i, j = blk // P_, blk % P_
            if host_master:
                v_dev, vm_dev = stage(vcache, i, vparts, vmoms)
                c_dev, cm_dev = stage(ccache, j, cparts, cmoms)
                local = {"tables": (v_dev, c_dev),
                         "moments": (vm_dev, cm_dev)}
            else:
                local = {"tables": (vparts[i], cparts[j]),
                         "moments": (tuple(m[i] for m in vmoms),
                                     tuple(m[j] for m in cmoms))}
            local, losses = runner(
                local, offsets[blk], offsets[blk + 1] - offsets[blk],
                self.batch_id, self.num_batch, generator,
                *self._blocked_edges, nprob[j], nalias[j], nsizes[j])
            if host_master:
                # the episode's outputs are the resident shards now
                vcache[i] = (local["tables"][0], local["moments"][0])
                ccache[j] = (local["tables"][1], local["moments"][1])
            else:
                vparts[i], cparts[j] = local["tables"]
                for m, nm in zip(vmoms, local["moments"][0]):
                    m[i] = nm
                for m, nm in zip(cmoms, local["moments"][1]):
                    m[j] = nm
            del local
            self.batch_id += ep_batches
            stats["episodes"] += 1
            losses_acc.append(losses)
            all_losses.append(losses)
            if self.batch_id >= next_log or self.batch_id >= self.num_batch:
                mean_loss = float(torch.cat(losses_acc).mean())
                logger.info("Batch id: %d / %d, loss = %.6g",
                            min(self.batch_id, self.num_batch),
                            self.num_batch, mean_loss)
                losses_acc = []
                next_log = self.batch_id + log_frequency
        tracing.stage(tracing.FINISH)
        if host_master:
            write_back(vcache, vparts, vmoms)
            write_back(ccache, cparts, cmoms)
        if on_cuda:
            # the host reads the masters below
            torch.cuda.synchronize(dev)
        stats["loop_s"] = time.perf_counter() - t0
        for direction in ("h2d", "d2h"):
            stats[direction + "_s"] = sum(
                (s.elapsed_time(e) / 1e3 if on_cuda else e - s)
                for d, _, s, e in copies if d == direction)

        t0 = time.perf_counter()
        v = self.graph.num_vertex
        where = torch.device("cpu") if host_master else dev

        def join(parts):
            out = torch.empty((v,) + tuple(parts[0].shape[1:]),
                              dtype=parts[0].dtype, device=where)
            part.unshard_tensors(parts, out)
            parts.clear()        # free each table's shards once joined
            return out

        self.state = {"tables": (join(vparts), join(cparts)),
                      "moments": (tuple(join(m) for m in vmoms),
                                  tuple(join(m) for m in cmoms))}
        if on_cuda:
            torch.cuda.synchronize(dev)
        stats["join_s"] = time.perf_counter() - t0
        self.batch_losses = torch.cat(all_losses)
        self.blocked_stats = stats

    def _train_edges(self, num_epoch, positive_reuse, negative_weight,
                     neg_state, trust, use_sweep, use_sweep_ctx,
                     negative_sharing, log_frequency):
        """The edge route (augmentation_step 1): positive edges from the
        device edge sampler through the shared-pool step, or the classic
        K-draw step without `negative_sharing`. `use_sweep`: the sweep gate
        holds (on, pooled, and tables above the dense-update size); the
        vertex-side sweeps then take the sorted stream. `use_sweep_ctx`:
        the context update takes the unsorted sweep."""
        if use_sweep:
            # a graph too small (or weighted) for the stream has no sorted
            # heads, and a batch below one 1024-edge chunk is rolled into
            # two sorted runs: the vertex side then takes the plain route
            self._sweep_scatter = True
            use_sweep = (self._get_sampler(
                ("edge", True), lambda: DeviceEdgeSampler.build(
                    self.graph, sort_stream=True, device=self.device)
            ).sorted_stream and self._effective_batch()
                % DeviceEdgeSampler.STREAM_CHUNK == 0)
        self._sweep_scatter = use_sweep
        self._sweep_context = use_sweep_ctx
        self._sweep_gather = (
            use_sweep
            and os.environ.get("GRAPHVITE_SWEEP_GATHER", "1") != "0")
        if negative_sharing:
            # batches of whole 1024-edge stream chunks on the sweep route
            # (_batch_plan); pool groups scale with the micro-batch
            pool_groups = _steps.graph_pool_groups(self._batch_plan()[1])
            step_fn = _steps.make_graph_pool_step(
                self.optimizer, self.num_negative, float(negative_weight),
                pool_size=int(os.environ.get("GRAPHVITE_POOL_SIZE", 128)),
                pool_groups=pool_groups, trust=trust,
                sweep_vertex=use_sweep, sweep_context=use_sweep_ctx,
                sweep_gather=self._sweep_gather)
        else:
            step_fn = _steps.make_graph_train_step(
                GRAPH_MODELS[self.model], self.optimizer, self.num_negative,
                float(negative_weight), trust=trust)
        sampler = self._get_sampler(
            ("edge", use_sweep), lambda: DeviceEdgeSampler.build(
                self.graph, sort_stream=True if use_sweep else None,
                device=self.device))
        self._train_loop_device(step_fn, sampler, neg_state, num_epoch,
                                positive_reuse, log_frequency)

    def predict(self, heads, tails=None):
        """Score (head, tail) pairs; accepts an (n, 2) array or two arrays.
        Returns a float32 numpy array. Tables off the device (the host
        master's, or numpy arrays) are scored in chunks of touched rows
        (`_predict_host_rows`)."""
        if tails is None:
            arr = np.asarray(heads)
            heads, tails = arr[:, 0], arr[:, 1]
        model = GRAPH_MODELS[self.model or "LINE"]
        vertex, context = self.state["tables"]
        if not (self._resident(vertex) and self._resident(context)):
            return self._predict_host_rows(model, vertex, context,
                                           np.asarray(heads),
                                           np.asarray(tails))
        h = torch.as_tensor(np.asarray(heads), dtype=torch.long,
                            device=self.device)
        t = torch.as_tensor(np.asarray(tails), dtype=torch.long,
                            device=self.device)
        with torch.no_grad():
            scores = model.score(vertex[h], context[t]).float()
        return scores.cpu().numpy()

    def _predict_host_rows(self, model, vertex, context, heads, tails,
                           chunk=1 << 18):
        """Chunked scoring against tables in host memory (reference
        solver.py:1195-1216): per chunk, only the touched [chunk, D] head
        and tail rows are gathered on the host, as float32, and scored on
        the device; the whole table never goes to the card."""
        n = heads.shape[0]
        out = np.empty(n, np.float32)
        with torch.no_grad():
            for lo in range(0, n, chunk):
                hi = min(lo + chunk, n)
                vr = _host_rows(vertex, heads[lo:hi]).to(self.device)
                cr = _host_rows(context, tails[lo:hi]).to(self.device)
                out[lo:hi] = model.score(vr, cr).float().cpu().numpy()
        return out

    def save_embeddings(self, file_name):
        """word2vec text+binary format (graph.cuh:796-805), written in one
        pass."""
        emb = np.ascontiguousarray(self.vertex_embeddings, dtype=np.float32)
        n = self.graph.num_vertex
        names = [(self.graph.id2name[i] + " ").encode() for i in range(n)]
        rows = emb.view(np.uint8).reshape(n, -1)
        with open(file_name, "wb") as f:
            f.write(("%d %d\n" % (n, self.dim)).encode())
            f.write(b"".join(
                name + row.tobytes() + b"\n"
                for name, row in zip(names, rows)))


class KnowledgeGraphSolver(SolverBase):
    """KG-embedding solver (ref knowledge_graph.cuh:511-678). The entity
    table is shared between head and tail roles (tied weights); relations
    are a separate table."""

    def get_default_optimizer(self):
        # ref knowledge_graph.cuh:556-558
        return Optimizer(type="Adam", lr=5e-5, weight_decay=0.0,
                         schedule="linear")

    def get_available_models(self):
        return set(KG_MODELS)

    def _table_shapes(self):
        return ((self.graph.num_vertex, self.dim),
                (self.graph.num_relation, self.dim))

    @property
    def entity_embeddings(self):
        return self.table(0)

    @property
    def relation_embeddings(self):
        return self.table(1)

    def init_embeddings(self, margin=12.0):
        """Per-model init schemes (knowledge_graph.cuh:567-621), drawn on
        the device from a generator seeded by the solver's rng, so a
        multi-GB entity table is never uploaded. The previous state is
        dropped first, so the device never holds two."""
        self.state = None
        ne, nr, d = self.graph.num_vertex, self.graph.num_relation, self.dim
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(self._rng.integers(2**31)))

        def U(shape, lo, hi):
            # in place: the entity table may be most of the device's memory
            u = torch.rand(shape, generator=gen, device=self.device)
            return u.mul_(hi - lo).add_(lo)

        if self.model == "TransE":
            ent = U((ne, d), -margin / d, margin / d)
            rel = U((nr, d), -margin / d, margin / d)
        elif self.model in ("DistMult", "ComplEx", "SimplE"):
            ent = U((ne, d), -0.5, 0.5)
            rel = U((nr, d), -0.5, 0.5)
        elif self.model == "RotatE":
            ent = U((ne, d), -margin * 2 / d, margin * 2 / d)
            rel = torch.zeros((nr, d), device=self.device)
            rel[:, : d // 2] = U((nr, d // 2), -math.pi, math.pi)
        elif self.model == "QuatE":
            def quat_init(n):
                m = U((n, d // 4), -1 / math.sqrt(d / 2),
                      1 / math.sqrt(d / 2))
                phase = U((n, d // 4), -math.pi, math.pi)
                v = U((n, d // 4, 3), 0.0, 1.0)
                v = v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True)
                         + 1e-15)
                sin = torch.sin(phase)
                out = torch.stack(
                    [m * torch.cos(phase), m * v[..., 0] * sin,
                     m * v[..., 1] * sin, m * v[..., 2] * sin], dim=-1)
                return out.reshape(n, d)
            ent = quat_init(ne)
            rel = quat_init(nr)
        else:
            raise ValueError(self.model)
        tables = (ent.to(self.float_type), rel.to(self.float_type))
        moments = (self.optimizer.init_moments((ne, d), self.device),
                   self.optimizer.init_moments((nr, d), self.device))
        self.state = {"tables": tables, "moments": moments}

    @_traced_call
    def train(self, model="RotatE", num_epoch=2000, resume=False,
              relation_lr_multiplier=1.0, margin=12.0,
              l3_regularization=2e-3, sample_batch_size=2000,
              positive_reuse=1, adversarial_temperature=2.0,
              negative_sharing=auto, log_frequency=100):
        """Train on the device. `negative_sharing`: the pooled step
        (shared candidate pools) or the classic per-draw step; auto picks
        the pooled step where the classic step's [B, K+1, D] intermediates
        would cap its batch below 4096 samples (GRAPHVITE_KG_NEG_SHARING
        overrides). `sampler_backend="host"` trains pools from the host
        edge sampler (`_train_loop`); `sample_batch_size` is accepted for
        parity (the reference's host sampler does not read it either)."""
        if model not in self.get_available_models():
            raise ValueError("unknown model `%s`" % model)
        self.model = model
        self.margin = float(margin)
        self.l3_regularization = float(l3_regularization)
        self.adversarial_temperature = float(adversarial_temperature)
        if not resume or self.state is None or self.batch_id == 0:
            self.init_embeddings(margin=margin)
            self.batch_id = 0

        mdl = KG_MODELS[model]
        margin_or_l3 = (self.margin if mdl.uses_margin
                        else self.l3_regularization)
        if self.num_worker > 1:
            self._train_loop_mesh_kg(model, num_epoch, margin_or_l3,
                                     float(relation_lr_multiplier),
                                     log_frequency)
            return
        if negative_sharing in (auto, None):
            env = os.environ.get("GRAPHVITE_KG_NEG_SHARING")
            if env is not None:
                negative_sharing = env != "0"
            else:
                budget = float(os.environ.get("GRAPHVITE_STEP_BYTES", 2e9))
                classic_cap = budget / ((self.num_negative + 2)
                                        * self.dim * 32)
                negative_sharing = classic_cap < 4096
        self._pooled_step = bool(negative_sharing)
        host = self.sampler_backend != "device"
        if negative_sharing:
            trust = float(os.environ.get("GRAPHVITE_TRUST", 0.25)) or None
            # the host backend's batches are batch_size, unplanned
            pool_batch = self.batch_size if host else self._batch_plan()[1]
            pool_groups = _steps.kg_pool_groups(
                pool_batch, target_group=int(os.environ.get(
                    "GRAPHVITE_KG_POOL_TARGET", 512)))
            step_fn = _steps.make_kg_pool_step(
                mdl, self.optimizer, self.num_negative, margin_or_l3,
                self.adversarial_temperature, float(relation_lr_multiplier),
                pool_size=int(os.environ.get("GRAPHVITE_KG_POOL_SIZE", 0)),
                pool_groups=pool_groups, trust=trust)
        else:
            step_fn = _steps.make_kg_train_step(
                mdl, self.optimizer, self.num_negative, margin_or_l3,
                self.adversarial_temperature, float(relation_lr_multiplier))
        if host:
            # reference solver.py:1387-1392
            sampler = EdgeSampler(self.graph,
                                  seed=int(self._rng.integers(2**31)),
                                  with_relation=True)
            self._train_loop(step_fn, sampler, True, (), num_epoch,
                             positive_reuse, log_frequency)
            return
        sampler = self._get_sampler(
            ("kg_edge", str(self.device)),
            lambda: DeviceEdgeSampler.build(self.graph, with_relation=True,
                                            device=self.device))
        self._train_loop_device(step_fn, sampler, (), num_epoch,
                                positive_reuse, log_frequency,
                                has_relation=True)

    def _mesh_kg_plan(self, num_epoch):
        """(negative pool, batch per worker, batches, episode batches) of
        `num_epoch` epochs on the mesh
        loop (reference solver.py:1394-1440). The pool: GRAPHVITE_KG_NEG_POOL,
        else "pooled" where the classic step's [B, K+1, D] intermediates
        would cap its batch below 4096 samples and "global" otherwise.
        The batch: the smallest of batch_size, the GRAPHVITE_STEP_BYTES
        cap and the staleness cap over a worker's 2 V / 2W resident rows
        (GRAPHVITE_MAX_TOUCH), in units of 256 (8 below 256). Episodes:
        every block revisited GRAPHVITE_MIN_SWEEPS times over the run's
        sweeps of 2W - 1 rounds."""
        env = os.environ.get
        W = self.num_worker
        budget = float(env("GRAPHVITE_STEP_BYTES", 2e9))
        neg_pool = env("GRAPHVITE_KG_NEG_POOL")
        if neg_pool is None:
            classic_cap = budget / ((self.num_negative + 2) * self.dim * 32)
            neg_pool = "pooled" if classic_cap < 4096 else "global"
        pooled = neg_pool == "pooled"
        live_bytes = (16 * self.dim * 4 if pooled
                      else (self.num_negative + 2) * self.dim * 4 * 8)
        mem_cap = max(int(budget / max(live_bytes, 1)), 512)
        tau = float(env("GRAPHVITE_MAX_TOUCH", 64))
        rows_per_worker = max(2 * self.graph.num_vertex // (2 * W), 1)
        touch_cap = max(int(tau * rows_per_worker
                            / (self.num_negative + 2)), 64)
        batch_size = min(self.batch_size, mem_cap, touch_cap)
        unit = 256 if batch_size >= 256 else 8
        batch_size = max(batch_size // unit * unit, unit)
        num_batch = max(int(num_epoch * self.graph.num_edge
                            // batch_size), 1)
        min_sweeps = int(env("GRAPHVITE_MIN_SWEEPS", 16))
        sweep_cap = max(num_batch // (W * (2 * W - 1) * min_sweeps), 1)
        ep_batches = max(min(self._episode_batches(), sweep_cap,
                             max(num_batch // W, 1)), 1)
        return neg_pool, batch_size, num_batch, ep_batches

    def _train_loop_mesh_kg(self, model_name, num_epoch, margin_or_l3,
                            relation_lr_multiplier, log_frequency):
        """Tied-weights sharded entity tables over the workers (reference
        solver.py:1394-1501): 2W partitions under the tournament rotation,
        relations replicated with the summed-delta merge
        (parallel/kg.py:ShardedKGTrainer). An entity table W times larger
        than one card's memory becomes trainable. The trainer (its
        partition and block-sorted triplets) is kept for the next call on
        the same graph and settings, its partition and block-sorted
        triplets for any engine on the graph and workers. The state comes
        back in canonical
        order on the first worker's device: entity moments exactly,
        relation moments as the workers' mean, so resume=True continues
        from them. Per-batch losses stay on the device (`batch_losses`);
        `mesh_stats` holds loop and set-up seconds and the episodes."""
        _one_process("KnowledgeGraphSolver")
        env = os.environ.get
        W = self.num_worker
        neg_pool, batch_size, num_batch, ep_batches = self._mesh_kg_plan(
            num_epoch)
        pooled = neg_pool == "pooled"
        self._pooled_step = pooled
        if batch_size < self.batch_size:
            logger.info("batch_size %d -> %d per worker (%d workers)",
                        self.batch_size, batch_size, W)
        self.effective_batch = batch_size
        self.num_batch = num_batch
        key = (id(self.graph), "kgmesh", model_name, self.optimizer,
               self.num_negative, float(margin_or_l3),
               self.adversarial_temperature, float(relation_lr_multiplier),
               tuple(self.worker_devices), batch_size, ep_batches, neg_pool,
               env("GRAPHVITE_KG_FAST", "1"),
               env("GRAPHVITE_KG_POOL_TARGET", ""),
               env("GRAPHVITE_KG_POOL_SIZE", ""), env("GRAPHVITE_TRUST", ""))
        setup = {}
        if getattr(self, "_kgmesh_key", None) != key:
            self._kgmesh_trainer = None
            # the partition and the block-sorted triplets depend on the
            # graph, W and the devices alone: kept for the next engine on
            # them (another optimizer, step or batch)
            prep_key = (id(self.graph), tuple(self.worker_devices))
            prep = getattr(self, "_kgmesh_prep", None)
            if prep is None or prep[0] != prep_key:
                self._kgmesh_prep = None
                t0 = time.perf_counter()
                part = VertexPartition(np.asarray(self.graph.degrees), 2 * W)
                setup["partition_s"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                blocks = TripletBlocks(self.graph, part,
                                       list(dict.fromkeys(
                                           self.worker_devices)))
                setup["triplet_sort_s"] = time.perf_counter() - t0
                self._kgmesh_prep = (prep_key, part, blocks)
            part = self._kgmesh_prep[1]
            trust = float(env("GRAPHVITE_TRUST", 0.25)) or None
            trainer = ShardedKGTrainer(
                DeviceGroup(self.worker_devices), part, self.dim,
                KG_MODELS[model_name], self.optimizer,
                num_negative=self.num_negative, margin_or_l3=margin_or_l3,
                adversarial_temperature=self.adversarial_temperature,
                relation_lr_multiplier=relation_lr_multiplier,
                batch_size=batch_size, ep_batches=ep_batches,
                negative_pool=neg_pool,
                pool_size=(int(env("GRAPHVITE_KG_POOL_SIZE", 0)) if pooled
                           else None),
                trust=trust)
            self._kgmesh_trainer = trainer
            self._kgmesh_key = key
        trainer = self._kgmesh_trainer
        group = trainer.group
        t0 = time.perf_counter()
        st = self.state
        self.state = None       # the arenas replace the tables
        state = trainer.init_state(st["tables"][0], st["tables"][1],
                                   moments=st["moments"])
        del st
        setup["split_s"] = time.perf_counter() - t0
        logger.info("training %s on %d workers (2x%d entity partitions, %s "
                    "negatives): %d batches of %d (episodes of %d)",
                    model_name, W, W, neg_pool, self.num_batch, batch_size,
                    ep_batches)
        next_log = log_frequency
        losses_acc, all_losses = [], []
        episodes = 0
        t0 = time.perf_counter()
        tracing.stage(None)
        while self.batch_id < self.num_batch:
            state, losses = trainer.run_episode(
                state, self._kgmesh_prep[2], self.batch_id, self.num_batch,
                self.seed)
            self.batch_id += ep_batches * W
            episodes += 1
            # [EP, W]: batch i of every worker, in the order they train
            losses = torch.stack([l.to(self.device) for l in losses], dim=1)
            losses_acc.append(losses.reshape(-1))
            all_losses.append(losses.reshape(-1))
            if self.batch_id >= next_log or self.batch_id >= self.num_batch:
                logger.info("Batch id: %d / %d, loss = %.6g",
                            min(self.batch_id, self.num_batch),
                            self.num_batch,
                            float(torch.cat(losses_acc).mean()))
                losses_acc = []
                next_log = self.batch_id + log_frequency
        tracing.stage(tracing.FINISH)
        for d in group.distinct:
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        loop_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ent = trainer.gather_entities(state, self.device)
        e_moms = trainer.gather_entity_moments(state, self.device)
        r_moms = trainer.gather_relation_moments(state, self.device)
        rel = state["rel"][0].to(self.device)
        del state
        self.state = {"tables": (ent, rel), "moments": (e_moms, r_moms)}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        setup["join_s"] = time.perf_counter() - t0
        self.batch_losses = torch.cat(all_losses)
        self.mesh_stats = {"workers": W, "negative_pool": neg_pool,
                           "ep_batches": ep_batches, "episodes": episodes,
                           "batch_size": batch_size, "loop_s": loop_s,
                           "setup_s": setup}

    def predict(self, samples):
        """samples: (n, 3) array of (head, tail, relation) ids -> logits, a
        float32 numpy array; scored in chunks of 2^20, or, for tables off
        the device, of 2^17 (`_predict_host_rows`)."""
        arr = np.asarray(samples)
        mdl = KG_MODELS[self.model]
        margin_or_l3 = (self.margin if mdl.uses_margin
                        else self.l3_regularization)
        entity, relation = self.state["tables"]
        if not (self._resident(entity) and self._resident(relation)):
            return self._predict_host_rows(mdl, margin_or_l3, entity,
                                           relation, arr)
        out = []
        chunk = 1 << 20
        with torch.no_grad():
            for i in range(0, arr.shape[0], chunk):
                h, t, r = (torch.as_tensor(
                    np.ascontiguousarray(arr[i:i + chunk, c]),
                    dtype=torch.long, device=self.device) for c in range(3))
                out.append(_steps.kg_predict(
                    mdl, entity, relation, h, t, r,
                    margin_or_l3).float().cpu().numpy())
        return (np.concatenate(out) if out
                else np.zeros(0, dtype=np.float32))

    def _predict_host_rows(self, mdl, margin_or_l3, entity, relation, arr,
                           chunk=1 << 17):
        """Chunked scoring against tables in host memory (reference
        solver.py:1533-1557): per chunk, the touched head, tail and
        relation rows are gathered on the host as float32 and scored on
        the device."""
        n = arr.shape[0]
        out = np.empty(n, np.float32)
        with torch.no_grad():
            for lo in range(0, n, chunk):
                part = arr[lo:lo + chunk]
                h, t, r = (_host_rows(table, part[:, c]).to(self.device)
                           for table, c in ((entity, 0), (entity, 1),
                                            (relation, 2)))
                out[lo:lo + chunk] = mdl.score(
                    h, t, r, margin_or_l3).float().cpu().numpy()
        return out


class VisualizationSolver(SolverBase):
    """LargeVis solver (ref visualization.cuh:417-596): one coordinate
    table serves both head and tail roles.

    Tables are padded to MIN_COLS columns, as the reference pads them: the
    squared-distance math keeps the zero-initialized pad columns exactly
    zero under every rule and weight decay, so they are inert;
    `coordinates` strips them."""

    MIN_COLS = 8

    def get_default_optimizer(self):
        # ref visualization.cuh:554-556
        return Optimizer(type="Adam", lr=0.5, weight_decay=1e-5,
                         schedule="linear")

    def get_available_models(self):
        return {"LargeVis"}

    @property
    def _pad_dim(self):
        return max(self.dim, self.MIN_COLS)

    def _table_shapes(self):
        return ((self.graph.num_vertex, self._pad_dim),)

    def init_embeddings(self):
        """coord ~ U(-5e-5/dim, 5e-5/dim) (visualization.cuh:563-569),
        drawn on the device from a generator seeded by the solver's rng;
        the pad columns are zero."""
        self.state = None
        v = self.graph.num_vertex
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(self._rng.integers(2**31)))
        bound = 5e-5 / self.dim
        coord = torch.zeros((v, self._pad_dim), dtype=torch.float32,
                            device=self.device)
        u = torch.rand((v, self.dim), generator=gen, device=self.device)
        coord[:, :self.dim] = u.mul_(2 * bound).sub_(bound)
        self.state = {"tables": (coord.to(self.float_type),),
                      "moments": (self.optimizer.init_moments(
                          (v, self._pad_dim), self.device),)}

    @property
    def coordinates(self):
        return self.table(0)[:, :self.dim]

    @_traced_call
    def train(self, model="LargeVis", num_epoch=50, resume=False,
              sample_batch_size=2000, positive_reuse=5,
              negative_sample_exponent=0.75, negative_weight=5.0,
              negative_sharing=auto, log_frequency=1000):
        """Train on the device with the alias-weighted edge sampler (KNN
        weights are not uniform). `negative_sharing`: the shared-pool step
        (default) or the classic K-draw step; auto, like every value equal
        to 0 (False included, as in the reference), reads
        GRAPHVITE_NEG_SHARING ("0" picks the classic step).
        `sampler_backend="host"` trains pools from the host edge sampler
        (`_train_loop`); `sample_batch_size` is accepted for parity (the
        reference's host sampler does not read it either)."""
        if model not in self.get_available_models():
            raise ValueError("unknown model `%s`" % model)
        self.model = "LargeVis"
        if not resume or self.state is None or self.batch_id == 0:
            self.init_embeddings()
            self.batch_id = 0
        weights = np.asarray(self.graph.vertex_weights, dtype=np.float64)
        weights = np.maximum(weights, 1e-12) ** negative_sample_exponent
        neg_state = tuple(torch.as_tensor(a, device=self.device)
                          for a in device_alias_arrays(AliasTable(weights)))
        trust = float(os.environ.get("GRAPHVITE_TRUST", 0.25)) or None
        if negative_sharing in (auto, None):
            negative_sharing = os.environ.get("GRAPHVITE_NEG_SHARING",
                                              "1") != "0"
        # the pooled step plans its batch under the pooled memory cap
        self._pooled_step = bool(negative_sharing)
        host = self.sampler_backend != "device"
        if negative_sharing:
            # the host backend's batches are batch_size, unplanned
            pool_batch = self.batch_size if host else self._batch_plan()[1]
            pool_groups = _steps.graph_pool_groups(pool_batch)
            step_fn = _steps.make_vis_pool_step(
                self.optimizer, self.num_negative, float(negative_weight),
                pool_groups=pool_groups, trust=trust)
        else:
            step_fn = _steps.make_vis_train_step(
                LargeVis, self.optimizer, self.num_negative,
                float(negative_weight), trust=trust)
        if self.num_worker > 1:
            self._train_loop_mesh_vis(step_fn, neg_state, num_epoch,
                                      log_frequency, positive_reuse)
            return
        if host:
            # reference solver.py:1655-1657
            sampler = EdgeSampler(self.graph,
                                  seed=int(self._rng.integers(2**31)))
            self._train_loop(step_fn, sampler, False, neg_state, num_epoch,
                             positive_reuse, log_frequency)
            return
        sampler = self._get_sampler(
            ("edge", str(self.device)),
            lambda: DeviceEdgeSampler.build(self.graph, device=self.device))
        self._train_loop_device(step_fn, sampler, neg_state, num_epoch,
                                positive_reuse, log_frequency)

    def _train_loop_mesh_vis(self, step_fn, neg_state, num_epoch,
                             log_frequency, positive_reuse=1):
        """Multi-device LargeVis (reference solver.py:1659-1730): the
        coordinate table is small, so every worker keeps a full replica,
        trains its own positive stream, and the replicas merge their
        episode deltas (parallel/mesh.py:ReplicatedEdgeTrainer). Episodes
        are short (GRAPHVITE_VIS_MESH_EP, default 4 batches): a layout is
        symmetric under rotation and reflection, so replicas that drift
        apart for long would settle on differently oriented layouts whose
        deltas cancel. The moments stay per worker; worker 0's become the
        state."""
        _one_process("VisualizationSolver")
        W = self.num_worker
        batch_size, _, _ = self._batch_plan()
        self.effective_batch = batch_size
        self.num_batch = max(int(num_epoch * self.graph.num_edge
                                 // batch_size), 1)
        ep_cap = int(os.environ.get("GRAPHVITE_VIS_MESH_EP", 4))
        ep_batches = max(min(self._episode_batches(), ep_cap,
                             max(self.num_batch // W, 1)), 1)
        R = max(int(positive_reuse), 1)
        key = (id(self.graph), "vismesh", self.optimizer, self.num_negative,
               tuple(self.worker_devices), batch_size, ep_batches, R,
               getattr(step_fn, "pool_shape", None))
        if getattr(self, "_vismesh_key", None) != key:
            group = DeviceGroup(self.worker_devices)
            self._vismesh_trainer = ReplicatedEdgeTrainer(
                group, step_fn, self.optimizer, batch_size, ep_batches,
                positive_reuse=R)
            self._vismesh_edges = None
            self._vismesh_edges = self._vismesh_trainer.init_edges(
                self.graph)
            self._vismesh_key = key
        trainer = self._vismesh_trainer
        trainer.step_fn = step_fn
        group = trainer.group
        tables, moments = trainer.init_state(self.state["tables"],
                                             self.state["moments"])
        logger.info("training LargeVis on %d workers: %d batches of %d "
                    "(episodes of %d)", W, self.num_batch, batch_size,
                    ep_batches)
        next_log = log_frequency
        losses_acc, all_losses = [], []
        t0 = time.perf_counter()
        tracing.stage(None)
        while self.batch_id < self.num_batch:
            tables, moments, losses = trainer.run_episode(
                tables, moments, self._vismesh_edges, neg_state,
                self.batch_id, self.num_batch, self.seed + self.batch_id)
            self.batch_id += ep_batches * R * W
            losses = torch.stack([l.to(self.device) for l in losses], dim=1)
            losses_acc.append(losses.reshape(-1))
            all_losses.append(losses.reshape(-1))
            if self.batch_id >= next_log or self.batch_id >= self.num_batch:
                logger.info("Batch id: %d / %d, loss = %.6g",
                            min(self.batch_id, self.num_batch),
                            self.num_batch,
                            float(torch.cat(losses_acc).mean()))
                losses_acc = []
                next_log = self.batch_id + log_frequency
        tracing.stage(tracing.FINISH)
        for d in group.distinct:
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        self.mesh_stats = {"workers": W, "ep_batches": ep_batches,
                           "batch_size": batch_size,
                           "loop_s": time.perf_counter() - t0}
        # every replica holds the merged table; the per-worker moments
        # are never merged (the reference's per-GPU moment caches)
        self.state = {"tables": tuple(t.to(self.device) for t in tables[0]),
                      "moments": tuple(tuple(m.to(self.device) for m in g)
                                       for g in moments[0])}
        self.batch_losses = torch.cat(all_losses)
