"""The reference's five experimental walk opt-ins in the port, each held to
the reference's step, sampler or runner on the reference's own draws, then
trained end to end by GraphSolver on the CPU:

* GRAPHVITE_SWEEP_WALK=1: the pool step's sort_heads front end with the
  sweep switches (the reference's Pallas sweeps in interpret mode);
* GRAPHVITE_BULK_WALKS=1: DeviceWalkSampler.make_episode_sample_fn (banded
  and pair layouts, node2vec's biased chain) and the runner's bulk slices;
* GRAPHVITE_BF16_BAND=1: the banded core's bf16 band products (the fused
  and the unfused walk step);
* GRAPHVITE_SWEEP_BANDED=1: the banded walk step's updates through kernel
  1's unsorted front end;
* GRAPHVITE_BF16_COMPUTE=1: the pool step's products with bf16 operands.

The reference's steps run eagerly, op by op, where XLA rounds a bf16
product as the switch asks (compiled for the CPU, its excess-precision
rule may keep such a product in float32).

Tolerances: sampler ids bit-equal. Losses rtol 2e-5 (2e-6 where a switch
must show in them). float32 tables and moments rtol 1e-5 and atol 1e-5 of
the array's largest magnitude (the order of a row's summed updates is the
only difference). bfloat16 tables within n + 2 bf16 ulps of the
reference's for a row touched n times (the reference rounds each delta to
bf16 before its scatter sums them, the port sums in float32 and rounds
once), within 1 ulp where both round each delta first
(GRAPHVITE_SWEEP_BANDED); their float32 moments as float32 tables.
Learning: two-block AUC > 0.9 with each switch."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphvite_tpu.ops.device_sampler as ref_sampler
import graphvite_tpu.ops.steps as ref_steps
import graphvite_tpu.optim as ref_optim
import graphvite_tpu_torch.ops.device_sampler as port_sampler
import graphvite_tpu_torch.ops.steps as port_steps
import graphvite_tpu_torch.optim as port_optim
from graphvite_tpu.graph import Graph as RefGraph
from graphvite_tpu.ops.alias import AliasTable, device_alias_arrays
from graphvite_tpu_torch import state_from_numpy
from graphvite_tpu_torch.graph import Graph
from graphvite_tpu_torch.ops.device_sampler import walk_offsets
from graphvite_tpu_torch.solver import GraphSolver
from test_solver import two_blocks
from test_torch_node2vec import _reference_biased_draws
from test_torch_sampler import _reference_draws
from test_torch_solver import _link_auc, _port_graph

LOSS_TOL = dict(rtol=2e-5)
V, D, K, NW = 1024, 32, 1, 5.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the cores (see tests/test_torch_solver.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.as_tensor(np.array(x))


def _bf16(x):
    """float32 values that bfloat16 holds exactly."""
    return torch.as_tensor(np.asarray(x, np.float32)).bfloat16().float().numpy()


def _bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


def _close32(a, b):
    np.testing.assert_allclose(a, b, rtol=1e-5,
                               atol=1e-5 * max(np.abs(b).max(), 1e-30))


def _opts(rule, wd=5e-3):
    kw = dict(type=rule, lr=0.025 if rule == "SGD" else 1e-3,
              weight_decay=wd)
    return ref_optim.Optimizer(**kw), port_optim.Optimizer(**kw), kw["lr"]


def _neg(seed=9):
    w = np.random.default_rng(seed).random(V) + 0.1
    return device_alias_arrays(AliasTable(w))


def _state(rule, rng, scale=(0.1, 0.1), bf16=False, width=D, tables=2):
    n_mom = port_optim.OPTIMIZER_MOMENTS[rule]
    tabs = tuple(rng.normal(0, s, (V, width)).astype(np.float32)
                 for s in scale[:tables])
    if bf16:
        tabs = tuple(_bf16(t) for t in tabs)
    moms = tuple(tuple(np.abs(rng.normal(0, 1e-3, (V, width)))
                       .astype(np.float32) for _ in range(n_mom))
                 for _ in range(tables))
    return {"tables": tabs, "moments": moms}


def _ref_state(state, dtype):
    return {"tables": tuple(jnp.asarray(t).astype(dtype)
                            for t in state["tables"]),
            "moments": tuple(tuple(jnp.asarray(m) for m in g)
                             for g in state["moments"])}


def _numpy(st):
    def f(x):
        return (x.float().numpy() if torch.is_tensor(x)
                else np.asarray(x, np.float32))
    return ([f(t) for t in st["tables"]],
            [f(m) for g in st["moments"] for m in g])


def _pool_draws(key, G, M):
    k1, k2 = jax.random.split(key)
    return tuple(_t(jax.random.uniform(k, (G, M))) for k in (k1, k2))


# ---------------------------------------------------------------------------
# GRAPHVITE_SWEEP_WALK: the sort_heads front end of the pool step
# ---------------------------------------------------------------------------

B, G, M = 512, 4, 16


def _pair_batch(seed):
    """Walk pairs in emission order: unsorted heads with repeats, tails, a
    mask with dead slots (some on the parking row V - 1)."""
    rng = np.random.default_rng(seed)
    heads = (rng.random(B) ** 2 * V).astype(np.int32)
    tails = (rng.random(B) ** 2 * V).astype(np.int32)
    heads[:3] = tails[3:6] = V - 1
    mask = (rng.random(B) > 0.15).astype(np.float32)
    return heads, tails, mask


def _run_pool(rule, dtype, seed, ref_kw, port_kw, state_kw=None):
    r_opt, p_opt, lr = _opts(rule, wd=0.0 if rule == "Adam" else 5e-3)
    heads, tails, mask = _pair_batch(seed)
    rng = np.random.default_rng(seed + 1)
    state = _state(rule, rng, bf16=dtype == "bfloat16", **(state_kw or {}))
    neg = _neg()
    key = jax.random.PRNGKey(seed)
    r_step = ref_steps.make_graph_pool_step(
        r_opt, K, NW, pool_size=M, pool_groups=G, trust=0.25, **ref_kw)
    r_new, r_loss = r_step(
        _ref_state(state, jnp.bfloat16 if dtype == "bfloat16"
                   else jnp.float32), jnp.asarray(heads), jnp.asarray(tails),
        key, jnp.float32(lr), *(jnp.asarray(a) for a in neg),
        mask=jnp.asarray(mask))
    p_step = port_steps.make_graph_pool_step(
        p_opt, K, NW, pool_size=M, pool_groups=G, trust=0.25, **port_kw)
    p_new, p_loss = p_step(
        state_from_numpy(state, "cpu", dtype), _t(heads), _t(tails), lr,
        *(_t(a) for a in neg), mask=_t(mask), draws=_pool_draws(key, G, M))
    pool = np.asarray(ref_steps.device_sample(
        *(jnp.asarray(a) for a in neg),
        *(jnp.asarray(u.numpy()) for u in _pool_draws(key, G, M))))
    touches = (np.bincount(heads, minlength=V)[:, None],
               np.bincount(np.concatenate([tails, pool.reshape(-1)]),
                           minlength=V)[:, None])
    return ((*_numpy(p_new), float(p_loss)),
            (*_numpy(r_new), float(r_loss)), state, touches)


SWEEP_REF = dict(sweep_vertex=True, sweep_context=True, sweep_gather=True,
                 sweep_tile=512, sweep_chunk=256, sweep_gather_tile=256,
                 sort_heads=True)
SWEEP_PORT = dict(sweep_vertex=True, sweep_context=True, sweep_gather=True,
                  sort_heads=True)


@pytest.mark.parametrize("rule", ["SGD", "Adam"])
def test_sort_heads_step_matches_reference(rule):
    """float32: the heads sorted in the step take kernel 3, kernel 1's
    sorted entry (SGD) or kernel 2 (Adam); the context side the unsorted
    front end. Masked heads park at row V - 1 with no touch."""
    (p_tab, p_mom, p_loss), (r_tab, r_mom, r_loss), state, _ = _run_pool(
        rule, "float32", 11, SWEEP_REF, SWEEP_PORT)
    np.testing.assert_allclose(p_loss, r_loss, **LOSS_TOL)
    assert len(p_mom) == len(r_mom) == (4 if rule == "Adam" else 0)
    for a, b in zip(p_tab + p_mom, r_tab + r_mom):
        _close32(a, b)
    # every live head's vertex row moved; the parking row's moments too
    heads, _, mask = _pair_batch(11)
    live = np.unique(heads[mask > 0])
    assert (np.abs(p_tab[0][live] - state["tables"][0][live]).max(axis=1)
            > 0).all()


def test_sort_heads_step_bf16_matches_reference():
    (p16, _, p_loss), (r16, _, r_loss), state, touches = _run_pool(
        "SGD", "bfloat16", 12, SWEEP_REF, SWEEP_PORT)
    np.testing.assert_allclose(p_loss, r_loss, **LOSS_TOL)
    for a, b, t0, n in zip(p16, r16, state["tables"], touches):
        mag = np.maximum(np.maximum(np.abs(a), np.abs(b)), np.abs(t0))
        assert np.all(np.abs(a - b) <= (n + 2) * _bf16_ulp(mag))


def test_sort_heads_order_is_stable():
    """Equal heads keep their emission order (a stable argsort), so the
    sorted entry sums a row's updates in the reference's order."""
    _, p_opt, lr = _opts("SGD")
    heads = np.array([5, 3, 5, 3, 5, 1, 0, 3], np.int32)
    tails = np.arange(8, dtype=np.int32) + 100
    seen = {}

    def spy(table, ids, out_dtype=None):
        seen["heads"] = ids.clone()
        return table[ids].float()

    step = port_steps.make_graph_pool_step(p_opt, K, NW, pool_size=4,
                                           pool_groups=2, **SWEEP_PORT)
    orig = port_steps.gather_sorted
    port_steps.gather_sorted = spy
    try:
        rng = np.random.default_rng(0)
        st = state_from_numpy(_state("SGD", rng), "cpu", "float32")
        step(st, _t(heads), _t(tails), lr, *(_t(a) for a in _neg()),
             mask=torch.ones(8), draws=(torch.rand(2, 4), torch.rand(2, 4)))
    finally:
        port_steps.gather_sorted = orig
    assert seen["heads"].tolist() == sorted(heads.tolist())


# ---------------------------------------------------------------------------
# GRAPHVITE_BF16_COMPUTE: bf16 operands for the pool step's products
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rule", ["SGD", "Adam"])
def test_bf16_compute_matches_reference(rule, monkeypatch):
    """bf16 tables with the switch in both packages. Adam's float32
    moments carry the rounded negative gradients at rtol 1e-5, where the
    port without the switch is further off; tables within n + 2 ulps."""
    monkeypatch.setenv("GRAPHVITE_BF16_COMPUTE", "1")
    plain = dict(sweep_vertex=False, sweep_context=False)
    (p16, p_mom, p_loss), (r16, r_mom, r_loss), state, touches = _run_pool(
        rule, "bfloat16", 13, plain, plain, dict(scale=(0.5, 0.5)))
    np.testing.assert_allclose(p_loss, r_loss, **LOSS_TOL)
    for a, b, t0, n in zip(p16, r16, state["tables"], touches):
        mag = np.maximum(np.maximum(np.abs(a), np.abs(b)), np.abs(t0))
        assert np.all(np.abs(a - b) <= (n + 2) * _bf16_ulp(mag))
    for a, b in zip(p_mom, r_mom):
        _close32(a, b)
    if rule == "Adam":
        monkeypatch.setenv("GRAPHVITE_BF16_COMPUTE", "0")
        (_, off_mom, _), _, _, _ = _run_pool(rule, "bfloat16", 13, plain,
                                            plain, dict(scale=(0.5, 0.5)))
        with pytest.raises(AssertionError):
            for a, b in zip(off_mom, r_mom):
                _close32(a, b)


# ---------------------------------------------------------------------------
# the banded steps: GRAPHVITE_BF16_BAND and GRAPHVITE_SWEEP_BANDED
# ---------------------------------------------------------------------------

AUG, BIDIR, BW, L1, GB, MB = 2, True, 16, 7, 4, 16


def _walk_batch(seed):
    rng = np.random.default_rng(seed)
    T = len(walk_offsets(AUG, BIDIR))
    chain = (rng.random((BW, L1)) ** 2 * V).astype(np.int64)
    mask = (rng.random((BW, L1, T)) > 0.2).astype(np.float32)
    return chain, mask


def _run_banded(kind, rule, dtype, seed, scale=(0.1, 0.1)):
    """One banded step of each package ("fused": the SGD arena; "walk":
    separate tables, the trust clip off)."""
    r_opt, p_opt, lr = _opts(rule, wd=0.0 if rule == "Adam" else 5e-3)
    chain, mask = _walk_batch(seed)
    rng = np.random.default_rng(seed + 1)
    bf16 = dtype == "bfloat16"
    if kind == "fused":
        st = _state(rule, rng, scale, bf16)
        state = {"tables": (np.concatenate(st["tables"], axis=1),),
                 "moments": ((),)}
        r_make, p_make = (ref_steps.make_graph_banded_fused_step,
                          port_steps.make_graph_banded_fused_step)
        kw = {}
    else:
        state = _state(rule, rng, scale, bf16)
        r_make, p_make = (ref_steps.make_graph_banded_walk_step,
                          port_steps.make_graph_banded_walk_step)
        kw = dict(trust=None)
    neg = _neg()
    key = jax.random.PRNGKey(seed)
    r_step = r_make(r_opt, K, NW, AUG, BIDIR, pool_size=MB, pool_groups=GB,
                    **kw)
    r_new, r_loss = r_step(
        _ref_state(state, jnp.bfloat16 if bf16 else jnp.float32),
        jnp.asarray(chain), jnp.asarray(chain), key, jnp.float32(lr),
        *(jnp.asarray(a) for a in neg), mask=jnp.asarray(mask))
    p_step = p_make(p_opt, K, NW, AUG, BIDIR, pool_size=MB, pool_groups=GB,
                    **kw)
    p_new, p_loss = p_step(
        state_from_numpy(state, "cpu", dtype), _t(chain), _t(chain), lr,
        *(_t(a) for a in neg), mask=_t(mask), draws=_pool_draws(key, GB, MB))
    pool = np.asarray(ref_steps.device_sample(
        *(jnp.asarray(a) for a in neg),
        *(jnp.asarray(u.numpy()) for u in _pool_draws(key, GB, MB))))
    n = np.bincount(np.concatenate([chain.reshape(-1), pool.reshape(-1)]),
                    minlength=V)[:, None]
    return ((*_numpy(p_new), float(p_loss)),
            (*_numpy(r_new), float(r_loss)), state, n)


@pytest.mark.parametrize("kind,rule", [("fused", "SGD"), ("walk", "Adam")])
def test_bf16_band_matches_reference(kind, rule, monkeypatch):
    """Rows of magnitude ~1 so the band products' rounding shows in the
    loss: rtol 2e-6 of the reference's with the switch, which the port
    without it misses. Tables within n + 2 ulps; Adam's moments float32."""
    scale = (0.6, 0.6)
    monkeypatch.setenv("GRAPHVITE_BF16_BAND", "1")
    (p16, p_mom, p_loss), (r16, r_mom, r_loss), state, n = _run_banded(
        kind, rule, "bfloat16", 21, scale)
    np.testing.assert_allclose(p_loss, r_loss, rtol=2e-6)
    for a, b, t0 in zip(p16, r16, state["tables"]):
        mag = np.maximum(np.maximum(np.abs(a), np.abs(b)), np.abs(t0))
        nn = n if a.shape[1] == D else np.concatenate([n, n], axis=0)[:V]
        assert np.all(np.abs(a - b) <= (nn + 2) * _bf16_ulp(mag))
    for a, b in zip(p_mom, r_mom):
        _close32(a, b)
    monkeypatch.setenv("GRAPHVITE_BF16_BAND", "0")
    (_, _, off_loss), _, _, _ = _run_banded(kind, rule, "bfloat16", 21,
                                           scale)
    assert abs(off_loss - r_loss) > 2e-6 * abs(r_loss)
    # on float32 tables the switch changes nothing
    monkeypatch.setenv("GRAPHVITE_BF16_BAND", "1")
    (_, _, on32), _, _, _ = _run_banded(kind, rule, "float32", 21, scale)
    monkeypatch.setenv("GRAPHVITE_BF16_BAND", "0")
    (_, _, off32), _, _, _ = _run_banded(kind, rule, "float32", 21, scale)
    assert on32 == off32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sweep_banded_matches_reference(dtype, monkeypatch):
    """SGD through kernel 1's unsorted front end, ids unmasked: float32 as
    the reference's sweeps; bf16 with each delta rounded to bf16 before
    the float32 sum in both packages, so within 1 ulp."""
    monkeypatch.setenv("GRAPHVITE_SWEEP_BANDED", "1")
    calls = []
    orig = port_steps.scatter_add_

    def spy(table, ids, upd):
        calls.append(ids.numel())
        return orig(table, ids, upd)

    monkeypatch.setattr(port_steps, "scatter_add_", spy)
    (p_tab, _, p_loss), (r_tab, _, r_loss), state, _ = _run_banded(
        "walk", "SGD", dtype, 22)
    assert calls == [BW * L1, BW * L1 + GB * MB]
    np.testing.assert_allclose(p_loss, r_loss, **LOSS_TOL)
    for a, b in zip(p_tab, r_tab):
        if dtype == "float32":
            _close32(a, b)
        else:
            assert np.all(np.abs(a - b) <= _bf16_ulp(np.maximum(
                np.abs(a), np.abs(b))))
    moved = [np.abs(a - t0).max() > 0 for a, t0 in zip(p_tab,
                                                       state["tables"])]
    assert all(moved)


def test_sweep_banded_is_sgd_only(monkeypatch):
    """Moment rules keep apply_row_updates (the reference's switch is SGD
    only)."""
    monkeypatch.setenv("GRAPHVITE_SWEEP_BANDED", "1")
    (p_tab, p_mom, p_loss), (r_tab, r_mom, r_loss), _, _ = _run_banded(
        "walk", "Adam", "float32", 23)
    np.testing.assert_allclose(p_loss, r_loss, **LOSS_TOL)
    for a, b in zip(p_tab + p_mom, r_tab + r_mom):
        _close32(a, b)


# ---------------------------------------------------------------------------
# GRAPHVITE_BULK_WALKS: the episode sampler and the runner
# ---------------------------------------------------------------------------

def _walk_edges(seed=0):
    rng = np.random.default_rng(seed)
    e = (rng.random((900, 2)) ** 2 * 150).astype(np.int64)
    e = e[e[:, 0] != e[:, 1]]
    edges = [tuple(map(str, x)) for x in e]
    return edges + [(str(i), "sink%d" % i) for i in range(0, 150, 7)]


@pytest.mark.parametrize("layout,biased", [("banded", False),
                                           ("pair", False),
                                           ("banded", True)])
def test_episode_sampler_matches_reference(layout, biased, monkeypatch):
    """All n batches' walks from one chain call of W * n lanes, fed the
    reference's draws for that call: every batch's ids and masks equal the
    reference's, batch g holding walks g*W .. (g+1)*W - 1."""
    monkeypatch.setenv("GRAPHVITE_N2V_CUCKOO", "0")
    edges = _walk_edges()
    L, aug, n = 8, 2, 3
    banded = layout == "banded"
    batch = (2 * aug * (L + 1)) * 5 if banded else 120
    kw = dict(banded=banded, bidir=banded, biased=biased, p=4.0, q=2.0)
    s_ref = ref_sampler.DeviceWalkSampler.build(
        RefGraph().load_edge_list(edges, as_undirected=False), aug, L, batch,
        **kw)
    s_port = port_sampler.DeviceWalkSampler.build(
        Graph().load_edge_list(edges, as_undirected=False), aug, L, batch,
        **kw)
    ref_fn = s_ref.make_episode_sample_fn(batch, n)
    port_fn = s_port.make_episode_sample_fn(batch, n)
    lanes = s_ref.num_walk * n
    key = jax.random.PRNGKey(4)
    want = ref_fn(key, *s_ref.arrays())
    if biased:
        R = s_port.make_chain_fn().proposals
        draws = _reference_biased_draws(key, lanes, L, R)
    else:
        draws = _reference_draws(key, lanes, L)
    got = port_fn(*s_port.arrays(), draws=draws)
    for a, b in zip(got, want):
        assert a.shape[0] == n
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # batch g is what the per-batch sampler makes from walks g*W..
    per_batch = s_port.make_sample_fn(batch)
    W = s_port.num_walk
    for g in range(n):
        sl = tuple(d[..., g * W:(g + 1) * W] for d in draws)
        for a, b in zip(per_batch(*s_port.arrays(), draws=sl), got):
            np.testing.assert_array_equal(a.numpy(), b[g].numpy())


def test_episode_sampler_refuses_position_major():
    edges = _walk_edges()
    s = port_sampler.DeviceWalkSampler.build(
        Graph().load_edge_list(edges, as_undirected=False), 2, 8, 4 * 36,
        position_major=True, bidir=True)
    with pytest.raises(NotImplementedError, match="position-major"):
        s.make_episode_sample_fn(4 * 36, 3)


def test_runner_takes_bulk_slices():
    """With a bulk sampler the runner draws once before the loop and group
    g trains slice g (each `positive_reuse` times); the per-batch sampler
    is not called."""
    seen = []

    def step(state, heads, tails, lr, *neg, mask=None, generator=None):
        seen.append((int(heads[0]), int(tails[0]), float(mask[0]), lr))
        return state, torch.tensor(float(len(seen)))

    def sample_fn(*arrays, generator=None):
        raise AssertionError("the per-batch sampler ran")

    n = 3
    bulk = (torch.arange(n)[:, None] * torch.ones(1, 4, dtype=torch.long),
            10 + torch.arange(n)[:, None] * torch.ones(1, 4,
                                                       dtype=torch.long),
            torch.arange(n, dtype=torch.float32)[:, None] * torch.ones(1, 4))
    opt = port_optim.Optimizer(type="SGD", lr=0.5)
    runner = port_steps.make_fused_runner(
        step, sample_fn, opt, n, positive_reuse=2,
        bulk_sample_fn=lambda *a, generator=None: bulk)
    _, losses = runner({}, 0, 100, None, (), ())
    assert [s[:3] for s in seen] == [(g, 10 + g, float(g)) for g in range(n)
                                     for _ in range(2)]
    assert losses.tolist() == [1, 2, 3, 4, 5, 6]


# ---------------------------------------------------------------------------
# each switch through GraphSolver
# ---------------------------------------------------------------------------

SOLVER_CASES = {
    "sweep_walk": ({"GRAPHVITE_SWEEP_WALK": "1",
                    "GRAPHVITE_SWEEP_SCATTER": "1"}, "float32", {}),
    "bulk_walks": ({"GRAPHVITE_BULK_WALKS": "1"}, "float32", {}),
    "bulk_walks_node2vec": ({"GRAPHVITE_BULK_WALKS": "1"}, "float32",
                            {"model": "node2vec", "p": 4.0, "q": 2.0}),
    "bf16_band": ({"GRAPHVITE_BF16_BAND": "1"}, "bfloat16", {}),
    "sweep_banded": ({"GRAPHVITE_SWEEP_BANDED": "1"}, "float32", {}),
    "bf16_compute": ({"GRAPHVITE_BF16_COMPUTE": "1"}, "bfloat16",
                     {"augmentation_step": 1, "model": "LINE"}),
}


@pytest.mark.parametrize("case", sorted(SOLVER_CASES))
def test_solver_trains_with_switch(case, monkeypatch):
    env, float_type, train_kw = SOLVER_CASES[case]
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    # the sweeps engage for tables above the dense-update size
    monkeypatch.setattr(port_optim, "DENSE_UPDATE_ELEMS", 64)
    g = _port_graph(two_blocks())
    s = GraphSolver(dim=16, device="cpu", float_type=float_type)
    s.build(g, optimizer={"type": "SGD", "lr": 0.1, "weight_decay": 5e-3},
            num_negative=1, batch_size=512, episode_size=8)
    kw = dict(model="DeepWalk", num_epoch=2000, augmentation_step=2,
              random_walk_length=8, negative_weight=1.0,
              log_frequency=10**9)
    kw.update(train_kw)
    s.train(**kw)
    losses = s.batch_losses.float()
    tenth = max(losses.numel() // 10, 1)
    assert torch.isfinite(losses).all()
    assert losses[-tenth:].mean() < losses[:tenth].mean()
    assert _link_auc(s, g) > 0.9
    if case == "sweep_walk":
        assert s._sweep_scatter and s._sweep_context and s._sweep_gather
        assert s._walk_slot_unit == 0 and s._multitail_T == 0
    if case.startswith("bulk"):
        assert s._active_bulk_fn is not None
    if case == "sweep_banded":
        assert not s._banded_fused and s._walk_slot_unit > 0
    if case == "bf16_band":
        assert s._banded_fused
