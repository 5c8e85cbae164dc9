"""The walks engine at a billion-edge scale, at sizes a CPU holds: 64-bit
row starts in the walk chain, integer start columns, the CSR start edge
against the flat pick, one round of four CPU workers against the plain
reference of the benchmark (benchmark/reference/line.py), resumed calls,
and the per-card memory plan at Friendster's sizes."""
import math
import types

import numpy as np
import pytest
import torch

import graphvite_tpu.ops.device_sampler as ref_sampler
from graphvite_tpu_torch.graph import Graph
from graphvite_tpu_torch.ops import device_sampler as ds
from graphvite_tpu_torch.optim import Optimizer
from graphvite_tpu_torch.parallel import mesh
from graphvite_tpu_torch.solver import GRAPH_MODELS, GraphSolver

from benchmark.reference import deepwalk as ref_deepwalk
from benchmark.reference import line as ref_line

FRIENDSTER_V = 65_608_366
FRIENDSTER_E = 1_806_067_135


def _power_law_graph(V=400, E=3000, seed=0):
    rng = np.random.default_rng(seed)
    u = (rng.random(E) ** 2.5 * V).astype(np.int64)
    v = (rng.random(E) ** 2.5 * V).astype(np.int64)
    keep = u != v
    u, v = u[keep], v[keep]
    g = Graph()
    g.num_vertex = V
    g.num_edge = int(u.size)
    g.id2name = g.name2id = None
    g.as_undirected = True
    g.edge_heads = np.concatenate([u, v])
    g.edge_tails = np.concatenate([v, u])
    g.edge_weights = np.ones(g.edge_heads.size, np.float32)
    g._finalize(normalization=False)
    return g, (u, v)


def _csr_chain(L, W):
    return ds.make_walk_chain_fn(True, L, W, start_csr=True)


def test_row_starts_past_int32():
    """Rows that start past 2^31 and 2^32 (the indices a stride-0 view of
    one entry, so the test needs no memory): the start edge's head is the
    row that holds the drawn position, its tail the entry there, and the
    walk steps through a row that starts past 2^32."""
    d0, d1, d2, d3 = 2**31 + 10, 2**31 + 20, 5, 7
    starts = torch.tensor([0, d0, d0 + d1, d0 + d1 + d2])
    n = d0 + d1 + d2 + d3
    vdeg = torch.stack([starts, torch.tensor([d0, d1, d2, d3])], dim=1)
    indices = torch.tensor([3], dtype=torch.int32).expand(n)
    assert indices.shape[0] > 2**32 and indices.stride() == (0,)
    empty_f = torch.zeros(0)
    empty_i = torch.zeros(0, dtype=torch.int32)
    cols = torch.tensor([0, d0 - 1, d0, d0 + d1 - 1, d0 + d1, d0 + d1 + 4,
                         d0 + d1 + d2, n - 1])
    W, L = cols.numel(), 4
    draws = (cols, None, torch.rand(L - 1, W), torch.rand(L - 1, W))
    chain, valid = _csr_chain(L, W)(empty_f, empty_i, starts, empty_i, vdeg,
                                     indices, empty_f, empty_i, draws=draws)
    assert chain[0].tolist() == [0, 0, 1, 1, 2, 2, 3, 3]
    assert (chain[1:] == 3).all() and valid.all()
    # the row of vertex 3 starts past 2^32: a step's position is there
    assert int(vdeg[3, 0]) > 2**32 and vdeg.dtype == torch.int64
    # a sampler built from a graph keeps its row starts in int64
    g, _ = _power_law_graph()
    s = ds.DeviceWalkSampler.build(g, 2, 6, 4 * 7 * 8, banded=True,
                                   bidir=True, start_csr=True)
    assert s.vdeg.dtype == s.heads.dtype == torch.int64
    assert s.edge_prob.numel() == s.tails.numel() == 0


def test_start_columns_reach_every_edge():
    """n = 45,227,962 start columns: the chain's own integer draws (a
    walk of length 1 over n rows of one edge each) reach the share of
    columns that uniform draws do, 1 - exp(-k / n) within 0.2%; the
    reference's float rule reaches at most 2^24 of them. A float u1
    passed in gives the reference's columns exactly."""
    n = 45_227_962
    k = 1 << 24
    gen = torch.Generator().manual_seed(11)
    starts = torch.arange(n)
    indices = torch.zeros(1, dtype=torch.int32).expand(n)
    e_f, e_i = torch.zeros(0), torch.zeros(0, dtype=torch.int32)
    chain, _ = _csr_chain(1, k)(e_f, e_i, starts, e_i, torch.zeros((1, 2)),
                                indices, e_f, e_i, generator=gen)
    hit = torch.zeros(n, dtype=torch.bool)
    hit[chain[0]] = True
    share = float(hit.float().mean())
    assert abs(share - (1 - math.exp(-k / n))) < 2e-3, share
    hit.zero_()
    hit[ds._start_column(torch.rand(k, generator=gen), n)] = True
    assert float(hit.float().mean()) < share - 0.05
    # the float rule: columns floor(u n) of at most 2^24 float32 values
    u1 = torch.rand(1 << 20, generator=gen)
    u2 = torch.rand(1 << 20, generator=gen)
    want = ref_sampler._alias_pick(np.ones(n, np.float32),
                                   np.arange(n, dtype=np.int32),
                                   u1.numpy(), u2.numpy())
    got = ds._alias_pick(torch.zeros(0), torch.zeros(0, dtype=torch.int32),
                         u1, u2, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(ds._start_column(u1, n), got)


def test_csr_start_edges_are_the_flat_distribution():
    """On an unweighted graph the CSR start edge and the flat pick draw
    the directed edges uniformly: 300,000 start edges of each, counted
    per directed edge, pass a chi-square test at p > 1e-6 (the
    statistic under chi2.ppf(1 - 1e-6, E - 1)), and the two sets of
    counts agree with each other at the same threshold."""
    from scipy import stats

    g, _ = _power_law_graph(V=300, E=2500, seed=3)
    V, E = g.num_vertex, g.edge_heads.size
    keys = np.asarray(g.edge_heads) * V + np.asarray(g.edge_tails)
    uniq, mult = np.unique(keys, return_counts=True)
    W = 300_000
    counts = []
    for csr in (True, False):
        s = ds.DeviceWalkSampler.build(g, 1, 1, W, start_csr=csr)
        fn = s.make_chain_fn()
        chain, _ = fn(*s.arrays(), generator=torch.Generator().manual_seed(5))
        k = (chain[0] * V + chain[1]).numpy()
        pos = np.searchsorted(uniq, k)
        assert (uniq[pos] == k).all()
        counts.append(np.bincount(pos, minlength=uniq.size))
    threshold = stats.chi2.ppf(1 - 1e-6, uniq.size - 1)
    for c in counts:
        want = W * mult / E
        assert ((c - want) ** 2 / want).sum() < threshold
    a, b = counts
    # two samples of one multinomial: (a - b)^2 / (a + b) summed
    both = (a + b) > 0
    assert (((a - b) ** 2)[both] / (a + b)[both]).sum() < threshold


def _line_cfg(dim, slack, workers=4):
    return {"dataset": {"num_vertex": None},
            "resource": {"dim": dim, "float_type": "float32"},
            "build": {"optimizer": {"type": "SGD", "lr": 0.025,
                                    "weight_decay": 0.005},
                      "num_negative": 1},
            "train": {"negative_weight": 5.0, "augmentation_step": 2},
            "mesh": {"num_worker": workers, "route_slack": slack,
                     "trust": 0.25}}


@pytest.mark.parametrize("cap", [None, 40])
def test_one_round_matches_the_plain_reference(cap, monkeypatch):
    """One round of four CPU workers on the CSR start, from seeded random
    tables, against benchmark/reference/line.py on the same walks and
    pools: every worker's loss and every row of both tables within 1e-5.
    Both compute in float32; the engine adds the four workers' updates
    of a row in kernel 1's order and the reference in index_add's, each
    a sum of up to a few hundred terms of magnitude under 1, so the two
    differ by a few float32 ulps (~1e-7): 1e-5 leaves a hundredfold room.
    With the owners' capacity cut to 40 requests a worker (the rule gives
    ~150) they drop requests, which the reference finds again from the
    requests."""
    monkeypatch.setattr(mesh.ShardedGraphTrainer, "FLAT_START_MAX_BYTES", 0)
    g, edges = _power_law_graph()
    V, D, P = g.num_vertex, 16, 4
    opt = Optimizer(type="SGD", lr=0.025, weight_decay=0.005)
    walk_cfg = dict(augmentation_step=2, walk_length=6, batch_walks=16,
                    bidir=True, pool_size=16)
    tr = mesh.ShardedGraphTrainer(
        mesh.DeviceGroup(["cpu"] * P),
        mesh.VertexPartition(np.asarray(g.degrees), P), D,
        GRAPH_MODELS["LINE"], opt, num_negative=1, negative_weight=5.0,
        batch_size=16 * 4 * 7, ep_batches=1, sampler_mode="walks",
        walk_cfg=walk_cfg, trust=0.25)
    ss = tr.build_sample_state(g)
    assert tr.walk_cfg["start_csr"]
    rule = tr._banded_capacity
    if cap is not None:
        tr._banded_capacity = cap
    rng = np.random.default_rng(7)
    vertex = rng.normal(0, 0.3, (V, D)).astype(np.float32)
    context = rng.normal(0, 0.3, (V, D)).astype(np.float32)
    state = tr.init_state(vertex, context)
    neg = tr.init_negative_state(np.asarray(g.vertex_weights))
    draws = tr.episode_draws(torch.Generator().manual_seed(9))
    num_batch = 100
    state, _, losses = tr.run_episode(state, ss, neg, 0, num_batch, 3,
                                      draws=draws)
    # the walks and pools the workers drew, again from the same draws
    s = tr._banded_shape
    cpu = torch.device("cpu")
    rec = {"chains": [], "pools": []}
    masks = []
    for i in range(P):
        chain_draws, pool_draws = draws[i][0]
        ct, _, pm = tr._sample_fn(*ss[cpu][0], draws=chain_draws)
        rec["chains"].append(ct)
        masks.append(pm)
        rec["pools"].append(mesh.device_sample(*neg[cpu], *pool_draws))
    cfg = _line_cfg(D, 2.0)
    cfg["dataset"]["num_vertex"] = V
    eng = ref_line.Engine(cfg, edges, "cpu", ((s["Bw"], s["L1"]),
                                               (s["G"], s["M"])))
    assert eng.cap == rule
    eng.cap = tr._banded_capacity
    got = [eng.arrived(c, p) for c, p in zip(rec["chains"], rec["pools"])]
    drops, _ = tr.drop_counts()
    assert drops == sum(int((~x).sum()) for x in got)
    if cap is not None:
        assert drops > 0
    lr = opt.schedule_lr(0, num_batch)
    vt, ct, ref_losses = ref_line.round_step(
        torch.as_tensor(vertex), torch.as_tensor(context), lambda x: x, rec,
        got, lr, cfg, eng.deg)
    np.testing.assert_allclose([float(l[0]) for l in losses], ref_losses,
                               rtol=1e-5)
    v, c = tr.gather_tables(state)
    np.testing.assert_allclose(v.numpy(), vt.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(c.numpy(), ct.numpy(), rtol=0, atol=1e-5)
    # the round moved rows, and the pair flags are the walks' own
    assert not np.allclose(v.numpy(), vertex)
    for chain, pm in zip(rec["chains"], masks):
        assert torch.equal(ref_deepwalk.pair_mask(chain, eng.deg, 2), pm > 0)


def _solver(g, episode):
    s = GraphSolver(dim=8, num_worker=4, device="cpu", seed=5)
    s.build(g, optimizer={"type": "SGD", "lr": 0.025,
                          "schedule": "constant"},
            num_negative=1, batch_size=2048, episode_size=episode)
    return s


def _epochs(s, batches):
    return batches * s.effective_batch / s.graph.num_edge + 1e-9


def test_resumed_calls_equal_one_call(monkeypatch):
    """Two resumed calls of one episode each train the bits of one call
    of both episodes on the same seed (the shards stay on the workers
    between the calls, the episodes' generators go on), and the tables
    come back in host memory when read."""
    monkeypatch.setattr(mesh.ShardedGraphTrainer, "FLAT_START_MAX_BYTES", 0)
    g, _ = _power_law_graph(V=600, E=5000, seed=1)
    kw = dict(model="LINE", augmentation_step=2, random_walk_length=6,
              log_frequency=10**9)
    probe = _solver(g, 2)
    probe.train(num_epoch=1e-12, **kw)
    eff = probe.effective_batch
    one = _solver(g, 2)
    one.train(num_epoch=16 * eff / g.num_edge + 1e-9, **kw)
    two = _solver(g, 2)
    two.train(num_epoch=8 * eff / g.num_edge + 1e-9, **kw)
    assert two._live is not None and two.batch_id == 8
    two.train(num_epoch=16 * eff / g.num_edge + 1e-9, resume=True, **kw)
    assert one.batch_id == two.batch_id == 16
    assert two._mesh_trainer.rotation == 2
    for a, b in zip(one.state["tables"], two.state["tables"]):
        assert a.device.type == "cpu"
        assert torch.equal(a, b)
    # the rows read where the tables are equal the gathered ones
    ids = torch.arange(g.num_vertex)
    three = _solver(g, 2)
    three.train(num_epoch=8 * eff / g.num_edge + 1e-9, **kw)
    rows = three.table_rows(1, ids)
    assert three._live is not None
    assert torch.equal(rows, three.state["tables"][1].float())
    assert three._live is None


def test_per_card_demand_at_friendster_sizes():
    """GraphSolver(num_worker=4) at Friendster's sizes (dim 96, float32,
    SGD): the per-card demand, a quarter of the tables' rows plus the
    walks engine's state and a batch's exchange, is under 80 GB; the
    whole tables are made in host memory, and a card's share of them is
    a quarter of a table's bytes each."""
    graph = types.SimpleNamespace(num_vertex=FRIENDSTER_V,
                                  num_edge=FRIENDSTER_E,
                                  num_directed_edge=2 * FRIENDSTER_E)
    s = GraphSolver(dim=96, num_worker=4, device="cpu")
    s.graph = graph
    s.optimizer = Optimizer(type="SGD", lr=0.025, weight_decay=0.005)
    s.batch_size = 100000
    demand, budget = s._memory_demand()
    whole = FRIENDSTER_V * 96 * 4
    walk_state = 4 * 2 * FRIENDSTER_E + 40 * FRIENDSTER_V
    shards = demand - walk_state - 3 * 100000 * (2 * 96 * 4 + 8)
    assert demand < 80e9, demand
    assert shards == -(-FRIENDSTER_V // 4) * 96 * 4 * 2
    assert shards / 2 < whole / 3
    assert s._allocation_device() == torch.device("cpu")
    # one worker holds the whole tables: over the card
    s1 = GraphSolver(dim=96, device="cpu")
    s1.graph, s1.optimizer = graph, s.optimizer
    assert s1._memory_demand()[0] > 2 * whole
