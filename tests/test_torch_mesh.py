"""The port's multi-device engines (graphvite_tpu_torch/parallel/mesh.py:
DeviceGroup, BlockEdgeTables, ShardedGraphTrainer in edges and walks mode,
ReplicatedEdgeTrainer; the solvers' mesh loops) against the JAX package's
(graphvite_tpu/parallel/mesh.py) on the CPU: the reference on the virtual
8-device mesh of tests/conftest.py, the port with W CPU workers.

The engines are fed the reference's own draws: the episode keys are
folded as its run_episode folds them (split(fold_in(PRNGKey(seed),
rotation), P), then fold_in per batch) and the same uniforms are drawn
here, the edges engine's in-block index computed from the reference's
float32 uniform as the reference computes it.

Tolerances: BlockEdgeTables bit-equal. One episode's float32 tables and
moments rtol 1e-5, atol 1e-6 (the order of a row's summed updates is the
only difference); losses rtol 1e-5; the walks engine's dropped and
emitted request counts equal. LargeVis replicas: a table entry within
rtol 1e-5 of the largest magnitude in its row, atol 1e-7
(tests/test_torch_vis_steps.py's rule; an entry's update sums the row's
touches, which can cancel). Solvers, as tests/test_parallel.py holds the
reference: two-block AUC > 0.9 and within 0.03 of the reference's mesh
run; the mesh loss within 25% of the single-device loss; LargeVis
cluster separation > 1.5 and at least half the single-device one."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphvite_tpu.optim as ref_optim
import graphvite_tpu.parallel.mesh as ref_mesh
import graphvite_tpu.ops.steps as ref_steps
import graphvite_tpu_torch.optim as port_optim
import graphvite_tpu_torch.ops.steps as port_steps
import graphvite_tpu_torch.parallel.mesh as port_mesh
from graphvite_tpu.graph import Graph as RefGraph
from graphvite_tpu.models import GRAPH_MODELS as REF_GRAPH_MODELS
from graphvite_tpu.models.visualization import LargeVis as RefLargeVis
from graphvite_tpu.ops.alias import AliasTable as RefAliasTable
from graphvite_tpu.ops.alias import device_alias_arrays
from graphvite_tpu_torch.graph import Graph
from graphvite_tpu_torch.models import GRAPH_MODELS, LargeVis

F32_TOL = dict(rtol=1e-5, atol=1e-6)
LOSS_TOL = dict(rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the cores: with torch's default of one thread
    per core, each of the many tiny ops these tests run waits on the other
    workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.as_tensor(np.array(x))


def _edges(n=60, seed=0, weighted=False, cross=None):
    """tests/test_parallel.py's two dense blocks with sparse cross edges
    (weighted: a weight per edge)."""
    rng = np.random.default_rng(seed)
    half = n // 2
    edges = []
    for _ in range(n * 12):
        blk = rng.integers(2)
        u = rng.integers(half) + blk * half
        v = rng.integers(half) + blk * half
        if u != v:
            edges.append((str(u), str(v)))
    for _ in range(n // 4 if cross is None else cross):
        edges.append((str(rng.integers(half)),
                      str(rng.integers(half) + half)))
    if weighted:
        w = rng.random(len(edges)) * 3 + 0.1
        edges = [e + (float(x),) for e, x in zip(edges, w)]
    return edges


def _graphs(**kw):
    e = _edges(**kw)
    return RefGraph().load_edge_list(e), Graph().load_edge_list(e)


def _opts(rule, lr=None, **extra):
    lr = lr if lr is not None else (0.025 if rule == "SGD" else 1e-3)
    kw = dict(type=rule, lr=lr, weight_decay=5e-3, **extra)
    return ref_optim.Optimizer(**kw), port_optim.Optimizer(**kw)


def _tables(v, dim, seed=0):
    rng = np.random.default_rng(seed)
    vertex = rng.uniform(-0.5, 0.5, (v, dim)).astype(np.float32) / dim * 8
    context = rng.normal(size=(v, dim)).astype(np.float32) * 0.1
    return vertex, context


def _moments(rule, v, dim, seed=1):
    if rule == "SGD":
        return None
    rng = np.random.default_rng(seed)
    return tuple(tuple(rng.uniform(0, 1e-4, (v, dim)).astype(np.float32)
                       for _ in range(2)) for _ in range(2))


def _port_group(W):
    return port_mesh.DeviceGroup(["cpu"] * W)


# ---------------------------------------------------------------------------
# the worker group's collectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("W", [1, 2, 4])
def test_collectives_match_the_reference_semantics(W):
    """ring_shift is ppermute with perm (i, (i - 1) % P); all_to_all routes
    row j of worker i's chunks to worker j's row i; sum gives every worker
    the same sum (jax.lax.ppermute / all_to_all / psum on the mesh)."""
    g = _port_group(W)
    rng = np.random.default_rng(W)
    xs = rng.normal(size=(W, W, 3, 2)).astype(np.float32)
    mesh = ref_mesh.make_mesh(W)
    spec = jax.sharding.PartitionSpec("p")

    def ref_fn(x):
        perm = [(i, (i - 1) % W) for i in range(W)]
        ring = jax.lax.ppermute(x, "p", perm) if W > 1 else x
        a2a = (jax.lax.all_to_all(x[0], "p", 0, 0, tiled=False)[None]
               if W > 1 else x)
        return ring, a2a, jax.lax.psum(x, "p")

    want = jax.jit(jax.shard_map(ref_fn, mesh=mesh, in_specs=spec,
                                 out_specs=(spec, spec, spec),
                                 check_vma=False))(jnp.asarray(xs))
    parts = [torch.from_numpy(xs[i]) for i in range(W)]
    got = (g.ring_shift(parts), g.all_to_all(parts), g.sum(parts))
    for a, b in zip(got, want):
        np.testing.assert_allclose(torch.stack(a).numpy(), np.asarray(b),
                                   rtol=1e-6)


def test_group_placement_and_coordinator(monkeypatch):
    g = _port_group(3)
    assert len(g) == 3 and g.distinct == [torch.device("cpu")]
    with pytest.raises(ValueError, match="cannot mix"):
        port_mesh.DeviceGroup(["cpu", "cuda:0"])
    # with the coordinator set the group joins the processes (the
    # reference's make_mesh reads the same variables); a missing one
    # raises before any connection is tried, as the reference's KeyError
    monkeypatch.setenv("GRAPHVITE_COORDINATOR", "localhost:1234")
    monkeypatch.delenv("GRAPHVITE_NUM_PROCESSES", raising=False)
    with pytest.raises(KeyError, match="GRAPHVITE_NUM_PROCESSES"):
        _port_group(2)
    # the solvers' mesh loops train in one process: with the coordinator
    # set they raise a clear error (multi-process training runs through
    # the engines; tests/test_torch_multihost.py)
    from graphvite_tpu_torch.solver import GraphSolver

    s = GraphSolver(dim=8, num_worker=2, device="cpu")
    s.build(Graph().load_edge_list(_edges(40)), batch_size=256)
    with pytest.raises(RuntimeError, match="through the engines"):
        s.train(model="LINE", num_epoch=1, augmentation_step=1)


def test_worker_seeds_differ_by_rotation_and_worker():
    seeds = {port_mesh.worker_seed(7, r, w) for r in range(3)
             for w in range(4)}
    assert len(seeds) == 12
    assert port_mesh.worker_seed(7, 1, 2) == port_mesh.worker_seed(7, 1, 2)


# ---------------------------------------------------------------------------
# the block edge tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("W", [2, 4])
@pytest.mark.parametrize("weighted", [False, True])
def test_block_tables_match_reference(W, weighted):
    rg, pg = _graphs(weighted=weighted)
    rpart = ref_mesh.VertexPartition(np.asarray(rg.degrees), W)
    ppart = port_mesh.VertexPartition(np.asarray(pg.degrees), W)
    want = ref_mesh.BlockEdgeTables(rg, rpart)
    got = port_mesh.BlockEdgeTables(pg, ppart)
    assert got.uniform == want.uniform == (not weighted)
    assert got.capacity == want.capacity
    for name in ("prob", "alias", "heads", "tails", "offsets"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    # every directed edge once; block (i, j) holds head partition i and
    # tail partition j (tests/test_parallel.py::test_block_tables_cover_
    # all_edges)
    assert int(got.offsets[:, -1].sum()) == pg.num_directed_edge
    members = [ppart.members[p][ppart.valid[p]] for p in range(W)]
    pairs = set(zip(pg.edge_heads.tolist(), pg.edge_tails.tolist()))
    for i in range(W):
        for j in range(W):
            lo, hi = got.offsets[i, j], got.offsets[i, j + 1]
            h = members[i][got.heads[i, lo:hi]]
            t = members[j][got.tails[i, lo:hi]]
            assert all((a, b) in pairs for a, b in zip(h.tolist(),
                                                       t.tolist()))
    arrays = got.device_arrays(_port_group(W))
    assert len(arrays) == W and all(len(a) == 4 for a in arrays)
    np.testing.assert_array_equal(arrays[1][2].numpy(), got.heads[1])


# ---------------------------------------------------------------------------
# edges mode: one or more episodes on the reference's draws
# ---------------------------------------------------------------------------

def _edges_episode_draws(seed, rotation, W, EP, B, K, offsets, window,
                         pool_shape):
    """What each reference worker draws in one edges-mode episode
    (mesh.py:483-558), in the port trainer's draw layout."""
    keys = jax.random.split(
        jax.random.fold_in(jax.random.PRNGKey(seed), rotation), W)
    out = []
    for i in range(W):
        j = (i + rotation) % W
        n_block = max(int(offsets[i, j + 1] - offsets[i, j]), 0)
        safe_n = max(n_block, 1)
        batches = []
        for it in range(EP):
            ks, kt = jax.random.split(jax.random.fold_in(keys[i], it))
            if window:
                pos = (_t(jax.random.uniform(ks, ())),)
            else:
                u = jax.random.uniform(ks, (2, B))
                idx = jnp.minimum((u[0] * safe_n).astype(jnp.int32),
                                  safe_n - 1)
                pos = (_t(idx).long(), _t(u[1]))
            k1, k2 = jax.random.split(kt)
            shape = pool_shape if pool_shape is not None else (B, K)
            step = (_t(jax.random.uniform(k1, shape)),
                    _t(jax.random.uniform(k2, shape)))
            batches.append((pos, step))
        out.append(batches)
    return out


def _edges_pair(W, rule, sharing, weighted=False, B=64, EP=3, dim=16,
                K=2, lr=None, pool_size=16):
    rg, pg = _graphs(weighted=weighted)
    ropt, popt = _opts(rule, lr)
    rpart = ref_mesh.VertexPartition(np.asarray(rg.degrees), W)
    ppart = port_mesh.VertexPartition(np.asarray(pg.degrees), W)
    kw = dict(num_negative=K, negative_weight=5.0, batch_size=B,
              ep_batches=EP, negative_sharing=sharing, pool_size=pool_size,
              trust=0.25)
    rtr = ref_mesh.ShardedGraphTrainer(
        ref_mesh.make_mesh(W), rpart, dim, REF_GRAPH_MODELS["LINE"], ropt,
        **kw)
    ptr = port_mesh.ShardedGraphTrainer(
        _port_group(W), ppart, dim, GRAPH_MODELS["LINE"], popt, **kw)
    return rg, pg, rtr, ptr


def _shards(state_ref, side, what="tables"):
    return np.asarray(state_ref[what][side])


def _run_edges(W, rule, sharing, weighted, episodes, B=64, EP=3):
    rg, pg, rtr, ptr = _edges_pair(W, rule, sharing, weighted, B=B, EP=EP)
    vertex, context = _tables(pg.num_vertex, 16)
    moms = _moments(rule, pg.num_vertex, 16)
    rstate = rtr.init_state(vertex, context, moments_np=moms)
    pstate = ptr.init_state(vertex, context, moments=moms)
    rneg = rtr.init_negative_state(np.asarray(rg.vertex_weights))
    pneg = ptr.init_negative_state(np.asarray(pg.vertex_weights))
    rblocks = rtr.build_sample_state(rg)
    pblocks = ptr.build_sample_state(pg)
    assert ptr._edges_uniform == rtr._edges_uniform
    pool_shape = ptr.step.pool_shape if sharing else None
    losses = []
    for e in range(episodes):
        draws = _edges_episode_draws(5, ptr.rotation, W, EP, B,
                                     ptr.num_negative, ptr.block_offsets,
                                     ptr._edges_uniform, pool_shape)
        rstate, rneg, rl = rtr.run_episode(rstate, rblocks, rneg, 4 * e,
                                           200, 5)
        pstate, pneg, pl = ptr.run_episode(pstate, pblocks, pneg, 4 * e,
                                           200, 5, draws=draws)
        losses.append((torch.stack(pl).numpy(), np.asarray(rl)))
    return rtr, ptr, rstate, pstate, rneg, pneg, losses


@pytest.mark.parametrize("W", [2, 4])
@pytest.mark.parametrize("rule,sharing,weighted", [
    ("SGD", True, False), ("Adam", True, False), ("SGD", False, True),
    ("Adam", False, False), ("SGD", True, True)])
def test_edges_episode_matches_reference(W, rule, sharing, weighted):
    rtr, ptr, rstate, pstate, rneg, pneg, losses = _run_edges(
        W, rule, sharing, weighted, episodes=2)
    # a uniform graph with blocks of at least a batch takes the window
    # draw, a weighted one the alias draw
    assert ptr._edges_uniform == (not weighted)
    for pl, rl in losses:
        assert pl.shape == rl.shape == (W, 3)
        np.testing.assert_allclose(pl, rl, **LOSS_TOL)
    for side in range(2):
        want = _shards(rstate, side)
        for i in range(W):
            np.testing.assert_allclose(pstate[i]["tables"][side].numpy(),
                                       want[i], **F32_TOL)
        for m in range(ptr.opt.num_moment):
            want = np.asarray(rstate["moments"][side][m])
            for i in range(W):
                np.testing.assert_allclose(
                    pstate[i]["moments"][side][m].numpy(), want[i],
                    **F32_TOL)
    # the negative alias arrays rotated with the context shards
    for got, want in zip(pneg[:2], rneg[:2]):
        np.testing.assert_array_equal(torch.stack(got).numpy(),
                                      np.asarray(want))
    np.testing.assert_array_equal(pneg[2], np.asarray(rneg[2]))
    # and the gathered canonical tables agree
    for a, b in zip(ptr.gather_tables(pstate), rtr.gather_tables(rstate)):
        np.testing.assert_allclose(a.numpy(), b, **F32_TOL)


def test_edges_episode_kernel_route(monkeypatch):
    """Shards above the dense-update size: kernel 2's route (its plain
    version here) against the reference's sort-based route."""
    monkeypatch.setattr(port_optim, "DENSE_UPDATE_ELEMS", 64)
    monkeypatch.setattr(ref_optim, "DENSE_UPDATE_ELEMS", 64)
    rtr, ptr, rstate, pstate, _, _, losses = _run_edges(
        2, "Adam", True, False, episodes=1)
    np.testing.assert_allclose(*losses[0], **LOSS_TOL)
    for a, b in zip(ptr.gather_tables(pstate), rtr.gather_tables(rstate)):
        np.testing.assert_allclose(a.numpy(), b, **F32_TOL)


@pytest.mark.parametrize("episodes", [1, 2, 4])
def test_rotation_bookkeeping(episodes):
    """lr = 0: after 1, 2 and P episodes the gathered tables and moments
    are the inputs, the rotation undone (tests/test_parallel.py::
    test_rotation_bookkeeping)."""
    pg = Graph().load_edge_list(_edges(32))
    W = 4
    popt = port_optim.Optimizer(type="Adam", lr=0.0)
    ptr = port_mesh.ShardedGraphTrainer(
        _port_group(W), port_mesh.VertexPartition(np.asarray(pg.degrees), W),
        8, GRAPH_MODELS["LINE"], popt, num_negative=1, negative_weight=1.0,
        batch_size=32, ep_batches=2)
    vertex, context = _tables(pg.num_vertex, 8)
    moms = tuple(tuple(np.random.default_rng(s).random(
        (pg.num_vertex, 8)).astype(np.float32) for s in (1, 2))
        for _ in range(2))
    state = ptr.init_state(vertex, context, moments=moms)
    neg = ptr.init_negative_state(pg.vertex_weights)
    blocks = ptr.build_blocks(pg)
    for e in range(episodes):
        state, neg, _ = ptr.run_episode(state, blocks, neg, 0, 100, e)
    assert ptr.rotation == episodes
    v, c = ptr.gather_tables(state)
    np.testing.assert_array_equal(v.numpy(), vertex)
    np.testing.assert_array_equal(c.numpy(), context)
    # Adam at lr 0 leaves the tables; the moments moved, so only their
    # order is checked: the context moments follow their rows
    got = ptr.gather_moments(state)
    assert len(got) == 2 and len(got[1]) == 2
    fresh = ptr.init_state(v, c, moments=got)
    again = ptr.gather_moments(fresh)
    for a, b in zip(got, again):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.numpy(), y.numpy())


# ---------------------------------------------------------------------------
# walks mode
# ---------------------------------------------------------------------------

def _walk_episode_draws(seed, rotation, W, EP, Bw, L, G, M, biased, R=None):
    """What each reference worker draws in one walks-mode episode
    (mesh.py:693-698; the chain's uniforms as device_sampler.py draws
    them)."""
    keys = jax.random.split(
        jax.random.fold_in(jax.random.PRNGKey(seed), rotation), W)
    out = []
    for i in range(W):
        batches = []
        for it in range(EP):
            kw, kp = jax.random.split(jax.random.fold_in(keys[i], it))
            kk = jax.random.split(kw, 3)
            u1 = jax.random.uniform(kk[0], (Bw,))
            u2 = jax.random.uniform(kk[1], (Bw,))
            if biased:
                step_keys = jax.random.split(kk[2], L - 1)
                rest = (jax.vmap(lambda k: jax.vmap(
                    lambda r: jax.random.uniform(jax.random.fold_in(k, r),
                                                 (3, R, Bw)))(
                    jnp.arange(64 // R)))(step_keys),)
            else:
                ks = jax.random.split(kk[2], 2)
                rest = (jax.random.uniform(ks[0], (L - 1, Bw)),
                        jax.random.uniform(ks[1], (L - 1, Bw)))
            chain = tuple(_t(x) for x in (u1, u2) + rest)
            pu = jax.random.uniform(kp, (2, G, M))
            batches.append((chain, (_t(pu[0]), _t(pu[1]))))
        out.append(batches)
    return out


def _sink_edges():
    """Directed edges into a sink: most walks reach the hub and stay there
    (a dead end repeats its vertex), so its owner gets most requests while
    its degree share (0 out-edges) sizes the capacity small."""
    edges = [(str(i), "hub") for i in range(60)]
    return edges + [(str(i), str((i + 1) % 60)) for i in range(0, 60, 3)]


def _walk_pair(W, rule, biased=False, slack=None, lr=None, dim=16,
               EP=3, sink=False):
    e = _sink_edges() if sink else _edges(80)
    rg = RefGraph().load_edge_list(e, as_undirected=not sink)
    pg = Graph().load_edge_list(e, as_undirected=not sink)
    # Adam at beta2 0.999: the banded step gives pool rows counts of
    # 10-20 touches, and at the default 0.99999 both packages' closed form
    # takes 1 - beta2^c as 1 - exp(c log beta2) in float32 (optim.py,
    # _one_minus_pow), where one ulp of exp (XLA's against torch's) moves
    # the second moment's new share by ~4e-4 relative
    ropt, popt = _opts(rule, lr, **({"beta2": 0.999} if rule == "Adam"
                                    else {}))
    walk_cfg = dict(augmentation_step=2, walk_length=6, batch_walks=16,
                    bidir=True, pool_size=16, biased=biased, p=4.0, q=2.0)
    if slack is not None:
        walk_cfg["route_slack"] = slack
    kw = dict(num_negative=1, negative_weight=1.0, batch_size=16 * 4 * 7,
              ep_batches=EP, sampler_mode="walks", walk_cfg=dict(walk_cfg),
              trust=0.25)
    rtr = ref_mesh.ShardedGraphTrainer(
        ref_mesh.make_mesh(W), ref_mesh.VertexPartition(
            np.asarray(rg.degrees), W), dim, REF_GRAPH_MODELS["DeepWalk"],
        ropt, **kw)
    kw["walk_cfg"] = dict(walk_cfg)
    ptr = port_mesh.ShardedGraphTrainer(
        _port_group(W), port_mesh.VertexPartition(np.asarray(pg.degrees), W),
        dim, GRAPH_MODELS["DeepWalk"], popt, **kw)
    return rg, pg, rtr, ptr


def _run_walks(W, rule, biased=False, slack=None, episodes=1, lr=None,
               EP=3, sink=False):
    rg, pg, rtr, ptr = _walk_pair(W, rule, biased, slack, lr, EP=EP,
                                  sink=sink)
    rss = rtr.build_sample_state(rg)
    pss = ptr.build_sample_state(pg)
    assert ptr._banded_shape == rtr._banded_shape
    assert ptr._banded_capacity == rtr._banded_capacity
    vertex, context = _tables(pg.num_vertex, 16)
    moms = _moments(rule, pg.num_vertex, 16)
    rstate = rtr.init_state(vertex, context, moments_np=moms)
    pstate = ptr.init_state(vertex, context, moments=moms)
    rneg = rtr.init_negative_state(np.asarray(rg.vertex_weights))
    pneg = ptr.init_negative_state(np.asarray(pg.vertex_weights))
    s = ptr._banded_shape
    R = getattr(ptr._chain_fn, "proposals", None)
    losses = []
    for e in range(episodes):
        draws = _walk_episode_draws(3, ptr.rotation, W, EP, s["Bw"],
                                    s["L1"] - 1, s["G"], s["M"], biased, R)
        rstate, rneg, rl = rtr.run_episode(rstate, rss, rneg, EP * e, 100,
                                           3)
        pstate, pneg, pl = ptr.run_episode(pstate, pss, pneg, EP * e, 100,
                                           3, draws=draws)
        losses.append((torch.stack(pl).numpy(), np.asarray(rl)))
    return rtr, ptr, rstate, pstate, losses


@pytest.mark.parametrize("rule,biased,kernel_route", [
    ("SGD", False, False), ("Adam", False, False), ("Adam", False, True),
    ("SGD", True, False)])
def test_walks_episode_matches_reference(rule, biased, kernel_route,
                                         monkeypatch):
    """DeepWalk SGD on the fused arena (kernel 1's plain version), Adam on
    the dense and the kernel-2 route, node2vec's biased chain with the
    sorted-indices membership; two episodes at W = 2."""
    if kernel_route:
        monkeypatch.setattr(port_optim, "DENSE_UPDATE_ELEMS", 64)
        monkeypatch.setattr(ref_optim, "DENSE_UPDATE_ELEMS", 64)
    rtr, ptr, rstate, pstate, losses = _run_walks(2, rule, biased,
                                                  episodes=2)
    for pl, rl in losses:
        assert pl.shape == rl.shape == (2, 3)
        np.testing.assert_allclose(pl, rl, **LOSS_TOL)
    for a, b in zip(ptr.gather_tables(pstate), rtr.gather_tables(rstate)):
        np.testing.assert_allclose(a.numpy(), b, **F32_TOL)
    for side in range(2):
        for m in range(ptr.opt.num_moment):
            want = np.asarray(rstate["moments"][side][m])
            for i in range(2):
                np.testing.assert_allclose(
                    pstate[i]["moments"][side][m].numpy(), want[i],
                    **F32_TOL)
    assert (ptr.pair_drops, ptr.pair_emitted) == (rtr.pair_drops,
                                                  rtr.pair_emitted)


def _bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


def _bf16_walk_episode(ptr, pg, vertex, context):
    """One walks episode of the port on bf16 tables, on the reference's
    draws; (losses [1, W], tables as float32 numpy, per-row touch counts
    over the workers)."""
    pss = ptr.build_sample_state(pg)
    s = ptr._banded_shape
    draws = _walk_episode_draws(3, 0, ptr.num_partition, 1, s["Bw"],
                                s["L1"] - 1, s["G"], s["M"], False)
    pneg = ptr.init_negative_state(np.asarray(pg.vertex_weights))
    state = ptr.init_state(torch.as_tensor(vertex).bfloat16(),
                           torch.as_tensor(context).bfloat16())
    state, _, losses = ptr.run_episode(state, pss, pneg, 0, 100, 3,
                                       draws=draws)
    touches = np.zeros(pg.num_vertex, np.int64)
    for i, dev in enumerate(ptr.group.devices):
        chain_draws, pool_draws = draws[i][0]
        chain, _ = ptr._chain_fn(*pss[dev][0], draws=chain_draws)
        pool = port_mesh.device_sample(*pneg[dev], *pool_draws)
        touches += np.bincount(torch.cat([chain.reshape(-1),
                                          pool.reshape(-1)]).numpy(),
                               minlength=pg.num_vertex)
    return (torch.stack(losses).numpy(),
            [t.float().numpy() for t in ptr.gather_tables(state)], touches)


def test_walks_episode_bf16_band(monkeypatch):
    """GRAPHVITE_BF16_BAND=1 on bf16 tables at W = 2: the walks engine
    rounds each band product to bf16 as the reference's does (its mesh
    step passes table_bf16 to the core), so one episode's losses equal the
    reference's to rtol 1e-5, while the port's run without the switch is
    further off than that. Rows of magnitude ~1 make the products large
    enough for the rounding to show in the loss. The reference runs with
    jit disabled: compiled for the CPU, XLA may keep a bf16 product in
    float32 (its excess-precision rule), and its episode then trains as
    if the switch were off. Tables: within n + 2
    bf16 ulps of the reference's for a row touched n times (the reference
    rounds each shipped delta to bf16 and adds in bf16; the port sums in
    float32 and rounds once)."""
    monkeypatch.setenv("GRAPHVITE_BF16_BAND", "1")
    rg, pg, rtr, ptr = _walk_pair(2, "SGD", EP=1)
    rng = np.random.default_rng(5)
    vertex = torch.as_tensor(rng.uniform(-1, 1, (pg.num_vertex, 16)),
                             dtype=torch.float32).bfloat16().float().numpy()
    context = torch.as_tensor(rng.normal(0, 0.5, (pg.num_vertex, 16)),
                              dtype=torch.float32).bfloat16().float().numpy()
    rss = rtr.build_sample_state(rg)
    rstate = rtr.init_state(vertex.astype(jnp.bfloat16),
                            context.astype(jnp.bfloat16))
    rneg = rtr.init_negative_state(np.asarray(rg.vertex_weights))
    with jax.disable_jit():
        rstate, _, rl = rtr.run_episode(rstate, rss, rneg, 0, 100, 3)
    rl = np.asarray(rl)
    pl, ptab, touches = _bf16_walk_episode(ptr, pg, vertex, context)
    np.testing.assert_allclose(pl, rl, **LOSS_TOL)
    for a, b, t0 in zip(ptab, rtr.gather_tables(rstate), (vertex, context)):
        b = np.asarray(b, np.float32)
        mag = np.maximum(np.maximum(np.abs(a), np.abs(b)), np.abs(t0))
        assert np.all(np.abs(a - b)
                      <= (touches[:, None] + 2) * _bf16_ulp(mag))
    monkeypatch.setenv("GRAPHVITE_BF16_BAND", "0")
    _, pg0, _, ptr0 = _walk_pair(2, "SGD", EP=1)
    pl0, _, _ = _bf16_walk_episode(ptr0, pg0, vertex, context)
    assert not np.allclose(pl0, rl, **LOSS_TOL)


def test_walk_pair_drop_accounting():
    """A route slack far below the load of a sink's owner drops requests:
    the dropped and emitted counts equal the reference's, the masked pairs train the same
    tables, and the 1% warning fires (tests/test_parallel.py::
    test_walk_pair_drop_accounting)."""
    rtr, ptr, rstate, pstate, losses = _run_walks(2, "SGD", slack=0.3,
                                                  sink=True)
    drops, emitted = ptr.drop_counts()
    assert 0 < drops < emitted
    assert (drops, emitted) == (rtr.pair_drops, rtr.pair_emitted)
    np.testing.assert_allclose(*losses[0], **LOSS_TOL)
    for a, b in zip(ptr.gather_tables(pstate), rtr.gather_tables(rstate)):
        np.testing.assert_allclose(a.numpy(), b, **F32_TOL)
    assert ptr.check_drops() == (drops, emitted) and ptr._drop_warned


@pytest.mark.parametrize("rule", ["SGD", "Adam"])
def test_banded_mesh_lr0_roundtrip(rule):
    """lr = 0: the fetch, core and gradient return leave both sharded
    tables exactly as they were (tests/test_parallel.py::
    test_banded_mesh_lr0_roundtrip), over three episodes of their own
    draws."""
    rg, pg, rtr, ptr = _walk_pair(4, rule, lr=0.0)
    pss = ptr.build_sample_state(pg)
    vertex, context = _tables(pg.num_vertex, 16)
    state = ptr.init_state(vertex, context)
    neg = ptr.init_negative_state(np.asarray(pg.vertex_weights))
    for e in range(3):
        state, neg, losses = ptr.run_episode(state, pss, neg, 3 * e, 100, e)
        assert all(bool(torch.isfinite(l).all()) for l in losses)
    v, c = ptr.gather_tables(state)
    np.testing.assert_array_equal(v.numpy(), vertex)
    np.testing.assert_array_equal(c.numpy(), context)


# ---------------------------------------------------------------------------
# LargeVis replicas
# ---------------------------------------------------------------------------

def _vis_episode_draws(seed, W, EP, R, B, shape):
    keys = jax.random.split(jax.random.PRNGKey(seed), W)
    out = []
    for i in range(W):
        batches = []
        for it in range(EP):
            ks, kt = jax.random.split(jax.random.fold_in(keys[i], it))
            u = jax.random.uniform(ks, (2, B))
            steps = []
            for r in range(R):
                k1, k2 = jax.random.split(jax.random.fold_in(kt, r))
                steps.append((_t(jax.random.uniform(k1, shape)),
                              _t(jax.random.uniform(k2, shape))))
            batches.append(((_t(u[0]), _t(u[1])), steps))
        out.append(batches)
    return out


def _vis_loss_comparable(kind, draws, edges, neg, G):
    """[W, EP] batches whose loss both packages compute alike. A pool row
    that is one of its group's heads has x = 0, where the pooled step's
    loss term -log(x + 1e-15) turns the rounding of x into a different
    number: the port forms x in float64 (exactly 0), the reference
    expands it in float32 (ROADMAP queue 3, float64 products in the
    pooled LargeVis step). The gradients stay well-conditioned there
    (x + 0.1), so the tables are compared on every batch."""
    from graphvite_tpu_torch.ops.alias import device_sample
    eprob, ealias, eheads, _ = next(iter(edges.values()))
    ok = np.ones((len(draws), len(draws[0])), bool)
    if kind != "pool":
        return ok
    for w, batches in enumerate(draws):
        for i, ((u0, u1), steps) in enumerate(batches):
            heads = eheads[device_sample(eprob, ealias, u0, u1)].reshape(
                G, -1)
            for st in steps:
                pool = device_sample(*(_t(a) for a in neg), *st)
                hit = (heads[:, :, None] == pool[:, None, :]).any()
                ok[w, i] &= not bool(hit)
    return ok


@pytest.mark.parametrize("kind,rule,R", [("pool", "Adam", 1),
                                         ("pool", "SGD", 2),
                                         ("classic", "Adam", 1)])
def test_replicated_trainer_matches_reference(kind, rule, R):
    from graphvite_tpu.graph import Graph as RG
    e = _edges(600, weighted=True)
    rg, pg = RG().load_edge_list(e), Graph().load_edge_list(e)
    W, B, EP, K, NW, M, G, D = 2, 32, 3, 5, 3.0, 8, 4, 8
    kw = (dict(type="SGD", lr=0.3, weight_decay=1e-5) if rule == "SGD"
          else dict(type="Adam", lr=0.5, weight_decay=1e-5))
    ropt, popt = ref_optim.Optimizer(**kw), port_optim.Optimizer(**kw)
    trust = 0.25 if rule == "SGD" else None
    if kind == "pool":
        rstep = ref_steps.make_vis_pool_step(ropt, K, NW, pool_size=M,
                                             pool_groups=G, trust=trust)
        pstep = port_steps.make_vis_pool_step(popt, K, NW, pool_size=M,
                                              pool_groups=G, trust=trust)
        shape = pstep.pool_shape
    else:
        rstep = ref_steps.make_vis_train_step(RefLargeVis, ropt, K, NW,
                                              trust=trust)
        pstep = port_steps.make_vis_train_step(LargeVis, popt, K, NW,
                                               trust=trust)
        shape = pstep.draw_shape(B)
    rng = np.random.default_rng(3)
    coord = np.zeros((pg.num_vertex, D), np.float32)
    coord[:, :2] = rng.normal(size=(pg.num_vertex, 2)) * 3
    moms = None
    if rule == "Adam":
        # warm moments in the live columns, zero in the pad columns, as
        # training leaves them
        moms = tuple(np.zeros((pg.num_vertex, D), np.float32)
                     for _ in range(2))
        for m in moms:
            m[:, :2] = np.abs(rng.normal(size=(pg.num_vertex, 2))) * 1e-2 \
                + 1e-3
        moms = (moms,)
    w = np.maximum(np.asarray(pg.vertex_weights, np.float64), 1e-12) ** 0.75
    neg = device_alias_arrays(RefAliasTable(w))
    rtr = ref_mesh.ReplicatedEdgeTrainer(ref_mesh.make_mesh(W), rstep, ropt,
                                         B, EP, positive_reuse=R)
    ptr = port_mesh.ReplicatedEdgeTrainer(_port_group(W), pstep, popt, B, EP,
                                          positive_reuse=R)
    rt, rm = rtr.init_state((coord,), moments_np=moms)
    pt, pm = ptr.init_state((coord,), moms)
    redges = rtr.init_edges(rg)
    pedges = ptr.init_edges(pg)
    compared = 0
    for ep in range(2):
        draws = _vis_episode_draws(9 + ep, W, EP, R, B, shape)
        rt, rm, rl = rtr.run_episode(rt, rm, redges,
                                     tuple(jnp.asarray(a) for a in neg),
                                     ep * EP * R * W, 100, 9 + ep)
        pt, pm, pl = ptr.run_episode(pt, pm, pedges,
                                     tuple(_t(a) for a in neg),
                                     ep * EP * R * W, 100, 9 + ep,
                                     draws=draws)
        ok = _vis_loss_comparable(kind, draws, pedges, neg, G)
        compared += int(ok.sum())
        np.testing.assert_allclose(torch.stack(pl).numpy()[ok],
                                   np.asarray(rl)[ok], **LOSS_TOL)
    print("losses compared on %d of %d batches" % (compared, 2 * W * EP))
    assert compared >= W * EP
    want = np.asarray(rt[0])
    scale = np.abs(want).max(axis=1, keepdims=True)
    for i in range(W):
        got = pt[i][0].numpy()
        assert np.all(np.abs(got - want) <= 1e-7 + 1e-5 * scale)
        assert np.all(got[:, 2:] == 0.0)
    # per-worker moments: never merged
    for m in range(popt.num_moment):
        want = np.asarray(rm[0][m])
        for i in range(W):
            np.testing.assert_allclose(pm[i][0][m].numpy(), want[i],
                                       **F32_TOL)
        assert not np.allclose(want[0], want[1])


# ---------------------------------------------------------------------------
# the solvers and applications
# ---------------------------------------------------------------------------

def _two_block_edges(seed=0):
    """tests/test_blocked.py's two communities of 40 vertices."""
    rng = np.random.default_rng(seed)
    edges = []
    for blk in range(2):
        nodes = np.arange(blk * 40, blk * 40 + 40)
        for _ in range(500):
            u, v = rng.choice(nodes, 2, replace=False)
            edges.append((str(u), str(v)))
    for _ in range(25):
        edges.append((str(rng.integers(0, 40)),
                      str(40 + rng.integers(0, 40))))
    return edges


def _two_block_auc(solver):
    from graphvite_tpu_torch.application.evaluate import rank_sum_auc
    n2i = solver.graph.name2id
    intra = np.asarray([(n2i[str(a)], n2i[str(b)])
                        for a in range(0, 20) for b in range(20, 40)])
    cross = np.asarray([(n2i[str(a)], n2i[str(b)])
                        for a in range(0, 20) for b in range(60, 80)])
    si = np.asarray(solver.predict(intra))
    sc = np.asarray(solver.predict(cross))
    return rank_sum_auc(np.r_[si, sc], np.r_[np.ones(len(si)),
                                            np.zeros(len(sc))])


MESH_RUNS = {"LINE": dict(num_epoch=200, augmentation_step=1),
             "DeepWalk": dict(num_epoch=100, augmentation_step=2,
                              random_walk_length=6)}


def _mesh_solvers(model, num_worker=2, seed=1024, optimizer=None):
    import graphvite_tpu.solver as ref_solver
    import graphvite_tpu_torch.solver as port_solver

    edges = _two_block_edges()
    out = []
    for pkg, G, kw in ((port_solver, Graph, dict(device="cpu")),
                       (ref_solver, RefGraph, {})):
        s = pkg.GraphSolver(dim=16, num_worker=num_worker, seed=seed, **kw)
        build = dict(num_negative=2, batch_size=256, episode_size=4)
        if optimizer is not None:
            build["optimizer"] = optimizer
        s.build(G().load_edge_list(edges), **build)
        s.train(model=model, negative_weight=1.0, log_frequency=10**9,
                **MESH_RUNS[model])
        out.append(s)
    return out


@pytest.mark.parametrize("model", ["LINE", "DeepWalk"])
@pytest.mark.parametrize("num_worker", [2, 4])
def test_solver_mesh_quality_matches_reference(model, num_worker):
    """GraphSolver(num_worker=2 or 4) on CPU workers: two-block AUC > 0.9
    and within 0.03 of the reference's mesh run with as many devices
    (tests/test_parallel.py::test_solver_mesh_line,
    ::test_solver_mesh_deepwalk)."""
    port, ref = _mesh_solvers(model, num_worker)
    assert port.num_worker == num_worker
    assert port.mesh_stats["workers"] == num_worker
    assert port.effective_batch == ref.effective_batch
    assert port.num_batch == ref.num_batch
    assert port.mesh_stats["ep_batches"] == port._mesh_trainer.ep_batches
    assert port._mesh_trainer.ep_batches == ref._mesh_trainer.ep_batches
    v, c = port.vertex_embeddings, port.context_embeddings
    assert np.isfinite(v).all() and np.isfinite(c).all()
    a_port, a_ref = _two_block_auc(port), _two_block_auc(ref)
    assert a_port > 0.9, a_port
    assert abs(a_port - a_ref) <= 0.03, (a_port, a_ref)
    assert port.batch_losses.shape == (port.mesh_stats["episodes"]
                                       * port.mesh_stats["ep_batches"]
                                       * num_worker,)
    if model == "DeepWalk":
        assert port.mesh_stats["requests"] > 0
        assert port.mesh_stats["dropped"] == 0


@pytest.mark.parametrize("model", ["LINE", "DeepWalk"])
def test_solver_mesh_matches_single_device_loss(model):
    """The mesh run's closing loss is within 25% of the single-device
    run's (tests/test_parallel.py::test_solver_mesh_matches_single_chip_
    loss, ::test_solver_mesh_deepwalk_matches_single_chip_loss)."""
    import graphvite_tpu_torch.solver as port_solver

    edges = _two_block_edges()
    tail = []
    for W in (1, 2):
        s = port_solver.GraphSolver(dim=16, num_worker=W, seed=7,
                                    device="cpu")
        s.build(Graph().load_edge_list(edges), num_negative=2,
                batch_size=256, episode_size=4)
        s.train(model=model, negative_weight=1.0, log_frequency=10**9,
                **MESH_RUNS[model])
        l = s.batch_losses.numpy()
        l = l[l > 0]
        tail.append(float(l[-len(l) // 10:].mean()))
    single, mesh = tail
    assert abs(single - mesh) / max(single, 1e-9) < 0.25, (single, mesh)


def test_solver_mesh_node2vec_and_adam():
    """node2vec's biased chain and Adam's moment return through the
    walks engine train finite, moving tables (tests/test_parallel.py::
    test_banded_mesh_node2vec_finite, ::test_banded_mesh_adam_moments_
    finite); the classic step through the edges engine."""
    import graphvite_tpu_torch.solver as port_solver

    g = Graph().load_edge_list(_two_block_edges())
    s = port_solver.GraphSolver(dim=8, seed=5, num_worker=2, device="cpu")
    s.build(g, num_negative=1, batch_size=512, episode_size=2)
    s.train(model="node2vec", num_epoch=20, augmentation_step=2,
            random_walk_length=6, p=4.0, q=2.0, log_frequency=10**9)
    assert s._mesh_trainer.walk_cfg["biased"]
    assert np.isfinite(s.vertex_embeddings).all()
    assert not np.allclose(s.context_embeddings, 0)
    s = port_solver.GraphSolver(dim=8, seed=3, num_worker=2, device="cpu")
    s.build(g, optimizer=dict(type="Adam", lr=1e-3), num_negative=2,
            batch_size=512, episode_size=4)
    s.train(model="DeepWalk", num_epoch=20, augmentation_step=2,
            random_walk_length=6, log_frequency=10**9)
    assert np.isfinite(s.vertex_embeddings).all()
    assert all(bool((m != 0).any()) for g_ in s.state["moments"]
               for m in g_)


def test_solver_mesh_classic_step(monkeypatch):
    monkeypatch.setenv("GRAPHVITE_NEG_SHARING", "0")
    port, ref = _mesh_solvers("LINE")
    assert not port._mesh_trainer.negative_sharing
    a_port, a_ref = _two_block_auc(port), _two_block_auc(ref)
    assert a_port > 0.9 and abs(a_port - a_ref) <= 0.03, (a_port, a_ref)


def test_mesh_moment_resume_carrythrough():
    """resume=True continues from the gathered moments: re-sharding the
    canonical moments a run gathered reproduces its shards (the context
    side at rotation 0), and the solver hands its moments to the next
    run (tests/test_parallel.py::test_mesh_moment_resume_carrythrough)."""
    import graphvite_tpu_torch.solver as port_solver

    pg = Graph().load_edge_list(_edges(60))
    W, dim = 4, 8
    popt = port_optim.Optimizer(type="Adam", lr=1e-3)
    part = port_mesh.VertexPartition(np.asarray(pg.degrees), W)
    tr = port_mesh.ShardedGraphTrainer(
        _port_group(W), part, dim, GRAPH_MODELS["LINE"], popt,
        num_negative=2, negative_weight=1.0, batch_size=128, ep_batches=2)
    v0 = np.random.default_rng(0).normal(size=(pg.num_vertex, dim)).astype(
        np.float32)
    st = tr.init_state(v0, np.zeros_like(v0))
    neg = tr.init_negative_state(np.asarray(pg.vertex_weights))
    blocks = tr.build_blocks(pg)
    st, neg, _ = tr.run_episode(st, blocks, neg, 0, 1000, 1)
    v1, c1 = tr.gather_tables(st)
    moms = tr.gather_moments(st)
    assert any(float(m.abs().sum()) > 0 for g in moms for m in g)
    st2 = tr.init_state(v1, c1, moments=moms)
    for i in range(W):
        for a, b in zip(st[i]["moments"][0], st2[i]["moments"][0]):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        # context moments re-enter in canonical order (rotation 0)
        for m_can, b in zip(moms[1], st2[i]["moments"][1]):
            np.testing.assert_array_equal(
                part.shard_tensor(m_can, i).numpy(), b.numpy())
    st3 = tr.init_state(v1, c1)
    assert all(float(m.abs().sum()) == 0 for m in st3[0]["moments"][0])

    s = port_solver.GraphSolver(dim=dim, num_worker=2, device="cpu")
    s.build(pg, optimizer=dict(type="Adam", lr=1e-3), num_negative=2,
            batch_size=128, episode_size=2)
    s.train(model="LINE", num_epoch=4, augmentation_step=1,
            log_frequency=10**9)
    before = [m.clone() for g in s.state["moments"] for m in g]
    seen = []
    trainer = s._mesh_trainer
    orig = trainer.init_state

    def spy(vertex, context, moments=None):
        seen.append([m.clone() for g in moments for m in g])
        return orig(vertex, context, moments=moments)

    trainer.init_state = spy
    s.batch_id = s.num_batch // 2
    s.train(model="LINE", num_epoch=4, augmentation_step=1, resume=True,
            log_frequency=10**9)
    assert len(seen) == 1
    for a, b in zip(seen[0], before):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_solver_mesh_visualization():
    """VisualizationSolver(num_worker=2) on CPU workers: both communities
    separate, and the layout is at least half as separated as the
    single-device one and as the reference's mesh layout
    (tests/test_parallel.py::test_solver_mesh_visualization)."""
    import graphvite_tpu.solver as ref_solver
    import graphvite_tpu_torch.solver as port_solver

    edges = _edges(100)
    half = 50

    def separation(pkg, G, num_worker, **kw):
        g = G().load_edge_list(edges)
        s = pkg.VisualizationSolver(dim=2, seed=3, num_worker=num_worker,
                                    **kw)
        s.build(g, num_negative=5, batch_size=512, episode_size=4)
        s.train(num_epoch=200, log_frequency=10**9)
        coords = s.coordinates
        assert np.isfinite(coords).all()
        names = np.asarray([g.name2id[str(i)] for i in range(2 * half)])
        a, b = coords[names[:half]], coords[names[half:]]
        within = (np.linalg.norm(a - a.mean(0), axis=1).mean()
                  + np.linalg.norm(b - b.mean(0), axis=1).mean()) / 2
        return np.linalg.norm(a.mean(0) - b.mean(0)) / max(within, 1e-9), s

    single, _ = separation(port_solver, Graph, 1, device="cpu")
    mesh, s = separation(port_solver, Graph, 2, device="cpu")
    ref, _ = separation(ref_solver, RefGraph, 2)
    assert s.mesh_stats["workers"] == 2
    assert len(s.state["moments"][0]) == 2
    assert single > 1.5, single
    assert mesh > max(1.5, 0.5 * single, 0.5 * ref), (single, mesh, ref)


def test_graph_application_gpus_train_on_cpu_workers():
    """`gpus` in the resource section: num_worker = len(gpus), device_ids
    = gpus; on the CPU the workers are CPU workers."""
    from graphvite_tpu_torch.application import GraphApplication

    app = GraphApplication(dim=16, gpus=[0, 1], device="cpu")
    assert app.solver.num_worker == 2
    assert app.solver.worker_devices == [torch.device("cpu")] * 2
    app.load(edge_list=_two_block_edges())
    app.build(num_negative=2, batch_size=256, episode_size=4)
    app.train(model="LINE", num_epoch=200, augmentation_step=1,
              negative_weight=1.0, log_frequency=10**9)
    assert app.solver.mesh_stats["workers"] == 2
    assert _two_block_auc(app.solver) > 0.9


def test_worker_placement(monkeypatch):
    """device_ids place worker i on cuda:device_ids[i] (repeats allowed);
    without them W must not exceed the visible cards (reference
    solver.py:61-64); the KG solver places its workers the same way (its
    engines are ported: tests/test_torch_kg_mesh.py)."""
    import graphvite_tpu_torch.solver as port_solver

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    s = port_solver.GraphSolver(dim=8, num_worker=2, device_ids=[0, 0])
    assert s.worker_devices == [torch.device("cuda", 0)] * 2
    assert s.device == torch.device("cuda", 0)
    with pytest.raises(ValueError, match="devices visible"):
        port_solver.GraphSolver(dim=8, num_worker=2)
    with pytest.raises(ValueError, match="devices visible"):
        port_solver.GraphSolver(dim=8, num_worker=2, device_ids=[0, 1])
    with pytest.raises(ValueError, match="device_ids"):
        port_solver.VisualizationSolver(dim=2, num_worker=2,
                                        device_ids=[0])
    # a single worker ignores device_ids, as before
    assert port_solver.GraphSolver(dim=8, device_ids=[3]).num_worker == 1
    kg = port_solver.KnowledgeGraphSolver(dim=8, num_worker=2,
                                          device_ids=[0, 0])
    assert kg.worker_devices == [torch.device("cuda", 0)] * 2
    with pytest.raises(ValueError, match="devices visible"):
        port_solver.KnowledgeGraphSolver(dim=8, num_worker=2)
