"""The port's worker group over several processes
(graphvite_tpu_torch/parallel/mesh.py: DeviceGroup with
GRAPHVITE_COORDINATOR; the engines of parallel/mesh.py and parallel/kg.py
over it) in the style of tests/test_multihost.py: two local processes,
two CPU workers each, over gloo.

* The reference test's own set-up (V 256, 2,048 edges, LINE, dim 16, K 2,
  batch 64, 2 batches per episode, 4 episodes): both processes agree on
  the global loss, and every loss and table entry is finite.
* Every engine mode: 2 processes x 2 workers give the bits of 1 process x
  4 workers from the same seed (the collectives only copy, and every sum
  adds in worker order): tables, moments and losses equal.
* Edges mode on the JAX package's own draws at W = 4 (made here as
  tests/test_torch_mesh.py makes them): each process feeds its workers'
  draws, and the gathered tables match the reference's one-process
  4-device result within that test's tolerance (rtol 1e-5, atol 1e-6;
  losses rtol 1e-5).

The processes run this file as a script (`python test_torch_multihost.py
PID PORT DIR`): it imports torch, numpy and the port at its top, and
JAX only inside the functions that make the reference's draws and
results, which only the test process calls."""
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from graphvite_tpu_torch.graph import Graph, KnowledgeGraph
from graphvite_tpu_torch.models import GRAPH_MODELS, KG_MODELS
from graphvite_tpu_torch.ops import steps
from graphvite_tpu_torch.ops.alias import AliasTable, device_alias_arrays
from graphvite_tpu_torch.optim import Optimizer
from graphvite_tpu_torch.parallel import kg as kg_mod
from graphvite_tpu_torch.parallel import mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "graphvite_tpu", "ml_dtypes", "yaml", "pandas")
PROCESSES, PER_PROCESS = 2, 2
W = PROCESSES * PER_PROCESS
F32_TOL = dict(rtol=1e-5, atol=1e-6)
LOSS_TOL = dict(rtol=1e-5)
CHILD_TIMEOUT_S = 240


# ---------------------------------------------------------------------------
# the runs: each takes a group (W workers in one process or over several)
# and returns numpy arrays that every process holds alike
# ---------------------------------------------------------------------------

def _two_blocks_edges(n=60, seed=0, weighted=False):
    """tests/test_parallel.py's two dense blocks with sparse cross edges,
    as an edge list."""
    rng = np.random.default_rng(seed)
    half = n // 2
    edges = []
    for _ in range(n * 12):
        blk = rng.integers(2)
        u = rng.integers(half) + blk * half
        v = rng.integers(half) + blk * half
        if u != v:
            edges.append((str(u), str(v)))
    for _ in range(n // 4):
        edges.append((str(rng.integers(half)), str(rng.integers(half) + half)))
    if weighted:
        w = rng.random(len(edges)) * 3 + 0.1
        edges = [e + (float(x),) for e, x in zip(edges, w)]
    return edges


def _two_blocks(n=60, seed=0, weighted=False):
    return Graph().load_edge_list(_two_blocks_edges(n, seed, weighted))


def _tables(v, dim, seed=0):
    rng = np.random.default_rng(seed)
    vertex = rng.uniform(-0.5, 0.5, (v, dim)).astype(np.float32) / dim * 8
    context = rng.normal(size=(v, dim)).astype(np.float32) * 0.1
    return vertex, context


def _global(group, per_worker):
    """Every worker's tensor as one numpy array [W, ...]."""
    return group.gather_values(per_worker).numpy()


def _graph_outputs(group, tr, state, losses):
    out = {"losses": np.stack(losses)}
    for name, t in zip(("vertex", "context"),
                       tr.gather_tables(state, device="cpu")):
        out[name] = t.numpy()
    for side, moms in zip(("vertex", "context"),
                          tr.gather_moments(state, device="cpu")):
        for m, t in enumerate(moms):
            out["%s_moment%d" % (side, m)] = t.numpy()
    return out


def run_reference_setup(group, draws=None):
    """tests/test_multihost.py's episode engine run, in the port."""
    rng = np.random.default_rng(0)
    g = Graph().load_edge_list([(str(rng.integers(256)),
                                 str(rng.integers(256)))
                                for _ in range(2048)])
    part = mesh.VertexPartition(np.asarray(g.degrees), group.size)
    opt = Optimizer(type="SGD", lr=0.025, weight_decay=5e-3)
    tr = mesh.ShardedGraphTrainer(group, part, 16, GRAPH_MODELS["LINE"], opt,
                                  num_negative=2, negative_weight=1.0,
                                  batch_size=64, ep_batches=2)
    vertex = rng.uniform(-0.03, 0.03, (g.num_vertex, 16)).astype(np.float32)
    context = np.zeros((g.num_vertex, 16), np.float32)
    state = tr.init_state(vertex, context)
    neg = tr.init_negative_state(g.vertex_weights)
    blocks = tr.build_sample_state(g)
    losses = []
    for e in range(4):
        state, neg, ls = tr.run_episode(state, blocks, neg,
                                        e * 2 * group.size, 64, seed=e)
        losses.append(_global(group, ls))
    return _graph_outputs(group, tr, state, losses)


def _edges_trainer(group, rule, weighted, sharing=True):
    g = _two_blocks(weighted=weighted)
    lr = 0.025 if rule == "SGD" else 1e-3
    opt = Optimizer(type=rule, lr=lr, weight_decay=5e-3)
    part = mesh.VertexPartition(np.asarray(g.degrees), group.size)
    tr = mesh.ShardedGraphTrainer(
        group, part, 16, GRAPH_MODELS["LINE"], opt, num_negative=2,
        negative_weight=5.0, batch_size=64, ep_batches=3,
        negative_sharing=sharing, pool_size=16, trust=0.25)
    return g, tr


def _run_edges(group, rule, weighted, sharing=True, draws=None):
    g, tr = _edges_trainer(group, rule, weighted, sharing)
    vertex, context = _tables(g.num_vertex, 16)
    moments = None
    if rule != "SGD":
        rng = np.random.default_rng(1)
        moments = tuple(tuple(rng.uniform(0, 1e-4, (g.num_vertex, 16))
                              .astype(np.float32) for _ in range(2))
                        for _ in range(2))
    state = tr.init_state(vertex, context, moments=moments)
    neg = tr.init_negative_state(np.asarray(g.vertex_weights))
    blocks = tr.build_sample_state(g)
    losses = []
    for e in range(len(draws) if draws is not None else 3):
        d = (mesh.draws_to(draws[e], group.devices) if draws is not None
             else None)
        state, neg, ls = tr.run_episode(state, blocks, neg, 4 * e, 200, 5,
                                        draws=d)
        losses.append(_global(group, ls))
    out = _graph_outputs(group, tr, state, losses)
    out["neg_prob"] = _global(group, neg[0])
    out["neg_size"] = np.asarray(neg[2])
    return out


def run_edges_sgd(group, draws=None):
    """Edges mode, SGD, a weighted graph (the alias draw of the positives
    and the integer in-block index), three episodes: the ring crosses the
    processes after each."""
    return _run_edges(group, "SGD", weighted=True)


def run_edges_adam(group, draws=None):
    """Edges mode, Adam from warm moments, an unweighted graph (the window
    draw): the moments travel the ring with the context shards."""
    return _run_edges(group, "Adam", weighted=False)


def run_edges_classic(group, draws=None):
    """Edges mode on the classic per-draw step (negative_sharing off)."""
    return _run_edges(group, "SGD", weighted=False, sharing=False)


def run_edges_reference_draws(group, draws):
    """Edges mode on the reference's draws (`reference_edges`)."""
    return _run_edges(group, "SGD", weighted=True, draws=draws)


def _run_walks(group, rule):
    g = _two_blocks(80)
    opt = Optimizer(type=rule, lr=0.025 if rule == "SGD" else 1e-3,
                    weight_decay=5e-3, **({"beta2": 0.999}
                                          if rule == "Adam" else {}))
    walk_cfg = dict(augmentation_step=2, walk_length=6, batch_walks=16,
                    bidir=True, pool_size=16)
    tr = mesh.ShardedGraphTrainer(
        group, mesh.VertexPartition(np.asarray(g.degrees), group.size), 16,
        GRAPH_MODELS["DeepWalk"], opt, num_negative=1, negative_weight=1.0,
        batch_size=16 * 4 * 7, ep_batches=3, sampler_mode="walks",
        walk_cfg=walk_cfg, trust=0.25)
    sample = tr.build_sample_state(g)
    vertex, context = _tables(g.num_vertex, 16)
    state = tr.init_state(vertex, context)
    neg = tr.init_negative_state(np.asarray(g.vertex_weights))
    losses = []
    for e in range(2):
        state, neg, ls = tr.run_episode(state, sample, neg, 3 * e, 100, 3)
        losses.append(_global(group, ls))
    out = _graph_outputs(group, tr, state, losses)
    dropped, emitted = tr.drop_counts()
    out["requests"] = np.asarray([dropped, emitted])
    out["valid_pairs"] = np.asarray(tr.valid_pairs())
    return out


def run_walks_sgd(group, draws=None):
    """Walks mode, SGD on the fused arena: three all_to_alls a batch."""
    return _run_walks(group, "SGD")


def run_walks_adam(group, draws=None):
    """Walks mode, Adam (the moment rules' counts and squares routed back
    to the owners)."""
    return _run_walks(group, "Adam")


def run_replicated_edges(group, draws=None):
    """ReplicatedEdgeTrainer (LargeVis replicas) with the pooled step,
    SGD, two reuses per batch: the merge sums the deltas across the
    processes."""
    g = _two_blocks(600, weighted=True)
    opt = Optimizer(type="SGD", lr=0.3, weight_decay=1e-5)
    step = steps.make_vis_pool_step(opt, 5, 3.0, pool_size=8, pool_groups=4,
                                    trust=0.25)
    rng = np.random.default_rng(3)
    coord = np.zeros((g.num_vertex, 8), np.float32)
    coord[:, :2] = rng.normal(size=(g.num_vertex, 2)) * 3
    w = np.maximum(np.asarray(g.vertex_weights, np.float64), 1e-12) ** 0.75
    neg = tuple(torch.as_tensor(a)
                for a in device_alias_arrays(AliasTable(w)))
    tr = mesh.ReplicatedEdgeTrainer(group, step, opt, 32, 3,
                                    positive_reuse=2)
    tables, moments = tr.init_state((coord,))
    edges = tr.init_edges(g)
    losses = []
    for e in range(2):
        tables, moments, ls = tr.run_episode(tables, moments, edges, neg,
                                             e * 12, 100, 9 + e)
        losses.append(_global(group, ls))
    return {"losses": np.stack(losses),
            "replicas": _global(group, [t[0] if t else None
                                        for t in tables])}


def _kg():
    rng = np.random.default_rng(0)
    return KnowledgeGraph().load_triplet_list(
        [(str(rng.integers(40)), "r%d" % rng.integers(4),
          str(rng.integers(40))) for _ in range(400)])


def _kg_tables(kg, dim, seed=0):
    rng = np.random.default_rng(seed)
    ent = rng.uniform(-0.5, 0.5, (kg.num_vertex, dim)).astype(np.float32)
    phases = rng.uniform(-np.pi, np.pi, (kg.num_relation, dim // 2))
    rel = np.concatenate([phases, np.zeros((kg.num_relation,
                                            dim - dim // 2))],
                         axis=1).astype(np.float32)
    return ent, rel


def _run_sharded_kg(group, mode, rule):
    kg = _kg()
    opt = Optimizer(type=rule, lr=0.05 if rule == "SGD" else 5e-3,
                    weight_decay=0.0)
    part = mesh.VertexPartition(np.asarray(kg.degrees), 2 * group.size)
    tr = kg_mod.ShardedKGTrainer(
        group, part, 16, KG_MODELS["RotatE"], opt, num_negative=4,
        margin_or_l3=6.0, adversarial_temperature=2.0,
        relation_lr_multiplier=1.0, batch_size=64, ep_batches=2,
        negative_pool=mode, trust=0.25)
    ent, rel = _kg_tables(kg, 16)
    state = tr.init_state(ent, rel)
    blocks = tr.init_triplets(kg)
    losses = []
    for e in range(3):
        state, ls = tr.run_episode(state, blocks, 2 * group.size * e, 100, 1)
        losses.append(_global(group, ls))
    out = {"losses": np.stack(losses),
           "entity": tr.gather_entities(state, device="cpu").numpy(),
           "relations": _global(group, state["rel"])}
    for m, t in enumerate(tr.gather_entity_moments(state, device="cpu")):
        out["entity_moment%d" % m] = t.numpy()
    for m, t in enumerate(tr.gather_relation_moments(state, device="cpu")):
        out["relation_moment%d" % m] = t.numpy()
    return out


def run_kg_pooled(group, draws=None):
    """ShardedKGTrainer, pooled negatives, Adam: the relation merge on
    `sum` and the seat rotation's two `permute`s per table kind."""
    return _run_sharded_kg(group, "pooled", "Adam")


def run_kg_global(group, draws=None):
    """ShardedKGTrainer, global negatives, Adam: an `all_gather` and a
    `reduce_scatter` across the processes every batch."""
    return _run_sharded_kg(group, "global", "Adam")


def run_kg_pooled_sgd(group, draws=None):
    """ShardedKGTrainer, pooled negatives, SGD: kernel 1's updates alone
    (on the card the moment rules' dense route adds with index_add_'s
    float atomics, whose bits vary from run to run)."""
    return _run_sharded_kg(group, "pooled", "SGD")


def run_kg_resident(group, draws=None):
    """ShardedKGTrainer, resident negatives, SGD."""
    return _run_sharded_kg(group, "resident", "SGD")


def run_replicated_kg(group, draws=None):
    """ReplicatedKGTrainer with the classic step, Adam."""
    kg = _kg()
    opt = Optimizer(type="Adam", lr=1e-3, weight_decay=0.0)
    step = steps.make_kg_train_step(KG_MODELS["RotatE"], opt, 4, 6.0, 2.0,
                                    1.0)
    tr = kg_mod.ReplicatedKGTrainer(group, 16, step, opt, batch_size=64,
                                    ep_batches=3)
    tables, moments = tr.init_state(_kg_tables(kg, 16))
    edges = tr.init_edges(kg)
    losses = []
    for e in range(2):
        tables, moments, ls = tr.run_episode(tables, moments, edges, 3 * e,
                                             100, e)
        losses.append(_global(group, ls))
    out = {"losses": np.stack(losses)}
    for k, name in enumerate(("entity", "relation")):
        out[name] = _global(group, [t[k] if t else None for t in tables])
        out[name + "_moment0"] = _global(
            group, [m[k][0] if m else None for m in moments])
    return out


RUNS = {
    "reference_setup": run_reference_setup,
    "edges_sgd": run_edges_sgd,
    "edges_adam": run_edges_adam,
    "edges_classic": run_edges_classic,
    "walks_sgd": run_walks_sgd,
    "walks_adam": run_walks_adam,
    "replicated_edges": run_replicated_edges,
    "kg_pooled": run_kg_pooled,
    "kg_pooled_sgd": run_kg_pooled_sgd,
    "kg_global": run_kg_global,
    "kg_resident": run_kg_resident,
    "replicated_kg": run_replicated_kg,
    "edges_reference_draws": run_edges_reference_draws,
}


# ---------------------------------------------------------------------------
# the reference's draws, saved for the processes
# ---------------------------------------------------------------------------

def _save_draws(path, draws):
    flat = {}
    for e, episode in enumerate(draws):
        for w, batches in enumerate(episode):
            for b, (pos, step) in enumerate(batches):
                for k, x in enumerate(pos):
                    flat["e%d_w%d_b%d_pos%d" % (e, w, b, k)] = x.numpy()
                for k, x in enumerate(step):
                    flat["e%d_w%d_b%d_step%d" % (e, w, b, k)] = x.numpy()
    np.savez(path, **flat)


def _load_draws(path):
    flat = np.load(path)
    keys = {tuple(int(p[1:]) for p in k.split("_")[:3]) for k in flat}
    E, Wd, B = (max(k[i] for k in keys) + 1 for i in range(3))

    def part(e, w, b, kind):
        n = sum(1 for k in flat if k.startswith("e%d_w%d_b%d_%s"
                                                % (e, w, b, kind)))
        return tuple(torch.from_numpy(flat["e%d_w%d_b%d_%s%d"
                                           % (e, w, b, kind, k)])
                     for k in range(n))

    return [[[(part(e, w, b, "pos"), part(e, w, b, "step"))
              for b in range(B)] for w in range(Wd)] for e in range(E)]


def reference_edges(path):
    """The JAX package's edges engine at W = 4 on `run_edges_sgd`'s graph
    and set-up over two episodes: saves its draws in the port's layout to
    `path` (tests/test_torch_mesh.py:_edges_episode_draws) and returns its
    gathered tables and losses."""
    import jax
    import jax.numpy as jnp

    import graphvite_tpu.optim as ref_optim
    import graphvite_tpu.parallel.mesh as ref_mesh
    from graphvite_tpu.graph import Graph as RefGraph
    from graphvite_tpu.models import GRAPH_MODELS as REF_MODELS

    def t(x):
        return torch.as_tensor(np.array(x))

    g, ptr = _edges_trainer(mesh.DeviceGroup(["cpu"] * W), "SGD", True)
    rg = RefGraph().load_edge_list(_two_blocks_edges(weighted=True))
    rpart = ref_mesh.VertexPartition(np.asarray(rg.degrees), W)
    rtr = ref_mesh.ShardedGraphTrainer(
        ref_mesh.make_mesh(W), rpart, 16, REF_MODELS["LINE"],
        ref_optim.Optimizer(type="SGD", lr=0.025, weight_decay=5e-3),
        num_negative=2, negative_weight=5.0, batch_size=64, ep_batches=3,
        negative_sharing=True, pool_size=16, trust=0.25)
    vertex, context = _tables(g.num_vertex, 16)
    rstate = rtr.init_state(vertex, context)
    rneg = rtr.init_negative_state(np.asarray(rg.vertex_weights))
    rblocks = rtr.build_sample_state(rg)
    ptr.build_sample_state(g)
    all_draws, losses = [], []
    for e in range(2):
        keys = jax.random.split(
            jax.random.fold_in(jax.random.PRNGKey(5), e), W)
        episode = []
        for i in range(W):
            j = (i + e) % W
            lo, hi = ptr.block_offsets[i, j], ptr.block_offsets[i, j + 1]
            safe_n = max(int(hi - lo), 1)
            batches = []
            for it in range(3):
                ks, kt = jax.random.split(jax.random.fold_in(keys[i], it))
                u = jax.random.uniform(ks, (2, 64))
                idx = jnp.minimum((u[0] * safe_n).astype(jnp.int32),
                                  safe_n - 1)
                k1, k2 = jax.random.split(kt)
                shape = ptr.step.pool_shape
                batches.append(((t(idx).long(), t(u[1])),
                                (t(jax.random.uniform(k1, shape)),
                                 t(jax.random.uniform(k2, shape)))))
            episode.append(batches)
        all_draws.append(episode)
        rstate, rneg, rl = rtr.run_episode(rstate, rblocks, rneg, 4 * e, 200,
                                           5)
        losses.append(np.asarray(rl))
    _save_draws(path, all_draws)
    vertex, context = rtr.gather_tables(rstate)
    return {"vertex": np.asarray(vertex), "context": np.asarray(context),
            "losses": np.stack(losses)}



# ---------------------------------------------------------------------------
# the processes
# ---------------------------------------------------------------------------

def child(pid, port, workdir, device="cpu", per_process=PER_PROCESS,
          names=None):
    """One of the PROCESSES processes: `per_process` workers on `device`
    each ("{pid}" in it stands for the process's index), the runs `names`
    (default: every run of RUNS) in order, each run's arrays saved to
    workdir."""
    os.environ["GRAPHVITE_COORDINATOR"] = "localhost:%s" % port
    os.environ["GRAPHVITE_NUM_PROCESSES"] = str(PROCESSES)
    os.environ["GRAPHVITE_PROCESS_ID"] = str(pid)
    torch.set_num_threads(1)
    path = os.path.join(workdir, "reference_draws.npz")
    draws = _load_draws(path) if os.path.exists(path) else None
    size = PROCESSES * per_process
    for name in names or RUNS:
        group = mesh.DeviceGroup([device.format(pid=pid)] * per_process)
        assert group.size == size, group.counts
        assert list(group.local) == [per_process * pid + k
                                     for k in range(per_process)]
        out = RUNS[name](group, draws)
        np.savez(os.path.join(workdir, "%s_%d.npz" % (name, pid)), **out)
        print("ran %s, transport %s" % (name, group.transport), flush=True)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
    assert not loaded, loaded
    print("MH_OK pid=%d workers=%d" % (pid, size), flush=True)


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn(workdir, args=(), timeout=CHILD_TIMEOUT_S):
    """Run the PROCESSES processes of this file (`child`, with `args`
    after PID PORT DIR) to their end, each with the same deadline: when
    one fails or the deadline passes, the others are killed. Returns
    [(exit code, output)] per process."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("XLA_", "JAX_", "GRAPHVITE_"))}
    env["PYTHONPATH"] = REPO
    port = str(_free_port())
    logs = [open(os.path.join(workdir, "process_%d.log" % i), "w+")
            for i in range(PROCESSES)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               str(i), port, workdir] + list(args),
                              stdout=logs[i], stderr=subprocess.STDOUT,
                              env=env, cwd=REPO)
             for i in range(PROCESSES)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            failed = any(p.poll() not in (None, 0) for p in procs)
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            try:
                p.communicate(timeout=30)
            except subprocess.TimeoutExpired:
                pass
    outs = []
    for f in logs:
        f.seek(0)
        outs.append(f.read())
        f.close()
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def outputs(workdir, runs, name):
    """Each process's arrays of run `name`."""
    got = []
    for pid, (rc, out) in enumerate(runs):
        path = os.path.join(workdir, "%s_%d.npz" % (name, pid))
        assert os.path.exists(path), "process %d (rc %s) made no %s:\n%s" % (
            pid, rc, name, out[-3000:])
        got.append(dict(np.load(path)))
    return got


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the cores (see tests/test_torch_mesh.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def processes(tmp_path_factory):
    """The reference's edges run (its draws saved for the processes), then
    the two processes; returns (workdir, the reference's result, the
    processes' exit codes and outputs)."""
    workdir = str(tmp_path_factory.mktemp("multihost"))
    ref = reference_edges(os.path.join(workdir, "reference_draws.npz"))
    return workdir, ref, spawn(workdir)


@pytest.fixture(scope="module")
def one_process(processes):
    """A run of RUNS by name with W workers in this process, on the
    draws the processes read."""
    draws = _load_draws(os.path.join(processes[0], "reference_draws.npz"))
    done = {}

    def run(name):
        if name not in done:
            done[name] = RUNS[name](mesh.DeviceGroup(["cpu"] * W), draws)
        return done[name]

    return run


def _outputs(processes, name):
    return outputs(processes[0], processes[2], name)


def test_processes_finish_clean(processes):
    """Both processes ran every case, exited 0 and loaded nothing of JAX
    or the JAX package."""
    for pid, (rc, out) in enumerate(processes[2]):
        assert rc == 0, "process %d failed:\n%s" % (pid, out[-3000:])
        assert "MH_OK pid=%d workers=%d" % (pid, W) in out, out[-2000:]


def test_reference_setup_agrees_and_is_finite(processes):
    """tests/test_multihost.py's checks: the processes computed the same
    global loss, and every loss and table entry is finite."""
    a, b = _outputs(processes, "reference_setup")
    assert float(a["losses"].mean()) == float(b["losses"].mean())
    for out in (a, b):
        for key in ("losses", "vertex", "context"):
            assert np.isfinite(out[key]).all(), key
    assert a["losses"].shape == (4, W, 2)


@pytest.mark.parametrize("name", [n for n in RUNS
                                  if n != "edges_reference_draws"])
def test_two_processes_equal_one(processes, one_process, name):
    """2 processes x 2 workers hold the bits of 1 process x 4 workers from
    the same seed: every gathered table, moment, count and loss."""
    want = one_process(name)
    for out in _outputs(processes, name):
        assert sorted(out) == sorted(want)
        for key in want:
            assert out[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(out[key], want[key], err_msg=key)


def test_edges_on_the_reference_draws(processes, one_process):
    """Each process feeds its workers' share of the reference's draws: the
    gathered tables match the JAX package's one-process 4-device engine
    within tests/test_torch_mesh.py's tolerance, and the 4 workers of one
    process to the bit."""
    ref = processes[1]
    want = one_process("edges_reference_draws")
    for out in _outputs(processes, "edges_reference_draws"):
        for key in ("vertex", "context"):
            np.testing.assert_allclose(out[key], ref[key], **F32_TOL)
            np.testing.assert_array_equal(out[key], want[key])
        np.testing.assert_allclose(out["losses"], ref["losses"], **LOSS_TOL)


if __name__ == "__main__":
    # PID PORT DIR [DEVICE PER_PROCESS NAME,NAME,...]
    pid, port, workdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    if len(sys.argv) > 4:
        child(pid, port, workdir, sys.argv[4], int(sys.argv[5]),
              sys.argv[6].split(","))
    else:
        child(pid, port, workdir)
