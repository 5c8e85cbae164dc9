"""The port's banded walk steps (ops/steps.py) against the JAX package's on
the same chain, mask, state and pool draws (the u1, u2 the reference draws
from its key, rebuilt here with the same splits).

Tolerances (those of tests/test_pool_steps.py:490-496, float32): loss rtol
2e-5; tables and moments rtol 3e-4, atol 3e-6. bfloat16: the reference
rounds each delta to bf16 before its scatter sums them, while the port's
kernel sums in float32 and rounds once (a recorded divergence), so the port's
bf16 step is held to the float32 steps rounded once (exactly for its own,
within 1 bf16 ulp for the reference's), and to the reference's bf16 step
within n + 1 bf16 ulps for a row touched n times."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphvite_tpu.ops.steps as ref
import graphvite_tpu.optim as ref_optim
import graphvite_tpu_torch.ops.steps as port
import graphvite_tpu_torch.optim as port_optim
from graphvite_tpu.ops.device_sampler import emit_walk_banded

LOSS_TOL = dict(rtol=2e-5)
TABLE_TOL = dict(rtol=3e-4, atol=3e-6)
V, D, W, L, AUG, K, M, G, NW = 70, 8, 8, 9, 2, 3, 4, 2, 5.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the cores: with torch's default of one thread
    per core, each of the many tiny ops these tests run waits on the other
    workers' threads (minutes instead of seconds)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _walks(seed, bidir):
    rng = np.random.default_rng(seed)
    chain = rng.integers(0, V, (L + 1, W)).astype(np.int32)
    alive = rng.random((L + 1, W)) > 0.15   # some walks die early
    alive[:2] = True
    valid = np.cumprod(alive, axis=0) > 0
    ct, pm = emit_walk_banded(jnp.asarray(chain), jnp.asarray(valid), AUG,
                              bidir=bidir)
    return np.asarray(ct), np.asarray(pm)


def _neg_state():
    w = np.random.default_rng(9).random(V) + 0.1
    from graphvite_tpu.ops.alias import AliasTable, device_alias_arrays
    return device_alias_arrays(AliasTable(w))


def _pool_draws(key):
    k1, k2 = jax.random.split(key)
    return tuple(torch.as_tensor(np.array(jax.random.uniform(k, (G, M))))
                 for k in (k1, k2))


def _opts(rule):
    lr = 0.05 if rule == "SGD" else 1e-3
    kw = dict(type=rule, lr=lr, weight_decay=1e-3)
    return ref_optim.Optimizer(**kw), port_optim.Optimizer(**kw), lr


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("rule", ["SGD", "Adam"])
@pytest.mark.parametrize("trust", [None, 0.25])
@pytest.mark.parametrize("bidir", [False, True])
def test_banded_core_matches_reference(rule, trust, bidir):
    r_opt, p_opt, lr = _opts(rule)
    rng = np.random.default_rng(1)
    T = AUG * (2 if bidir else 1)
    _, pm = _walks(2, bidir)
    v = rng.normal(size=(W, L + 1, D)).astype(np.float32)
    c = rng.normal(size=(W, L + 1, D)).astype(np.float32)
    P = rng.normal(size=(G, M, D)).astype(np.float32)
    # a large lr on the trust case makes the pool clip bind
    lr = 5.0 if trust else lr
    r_core, _ = ref.make_graph_banded_core(r_opt, K, NW, AUG, bidir, M, G,
                                           trust)
    p_core, shape = port.make_graph_banded_core(p_opt, K, NW, AUG, bidir, M,
                                                G, trust)
    assert shape[3] == T
    want = r_core(jnp.asarray(v), jnp.asarray(c), jnp.asarray(P),
                  jnp.asarray(pm), lr)
    got = p_core(_t(v), _t(c), _t(P), _t(pm), lr)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(np.asarray(got[key]),
                                   np.asarray(want[key]), err_msg=key,
                                   **TABLE_TOL)


def _state_np(rule, seed=3):
    rng = np.random.default_rng(seed)
    n_mom = 2 if rule == "Adam" else 0
    tables = [rng.normal(size=(V, D)).astype(np.float32) for _ in range(2)]
    moms = [[np.abs(rng.normal(size=(V, D))).astype(np.float32) * 0.01
             for _ in range(n_mom)] for _ in range(2)]
    return tables, moms


def _compare_states(got, want):
    pairs = list(zip(got["tables"], want["tables"]))
    for g_moms, w_moms in zip(got["moments"], want["moments"]):
        assert len(g_moms) == len(w_moms)
        pairs += list(zip(g_moms, w_moms))
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TABLE_TOL)


@pytest.mark.parametrize("rule", ["SGD", "Adam"])
@pytest.mark.parametrize("trust", [None, 0.25])
@pytest.mark.parametrize("bidir", [False, True])
def test_unfused_step_matches_reference(rule, trust, bidir):
    r_opt, p_opt, lr = _opts(rule)
    ct, pm = _walks(4, bidir)
    tables, moms = _state_np(rule)
    key = jax.random.PRNGKey(5)
    neg = _neg_state()
    r_step = ref.make_graph_banded_walk_step(r_opt, K, NW, AUG, bidir, M, G,
                                             trust)
    p_step = port.make_graph_banded_walk_step(p_opt, K, NW, AUG, bidir, M, G,
                                              trust)
    r_state = {"tables": tuple(jnp.asarray(t) for t in tables),
               "moments": tuple(tuple(jnp.asarray(m) for m in g)
                                for g in moms)}
    p_state = {"tables": tuple(_t(t) for t in tables),
               "moments": tuple(tuple(_t(m) for m in g) for g in moms)}
    r_new, r_loss = r_step(r_state, jnp.asarray(ct), jnp.asarray(ct), key,
                           jnp.float32(lr), *(jnp.asarray(a) for a in neg),
                           mask=jnp.asarray(pm))
    p_new, p_loss = p_step(p_state, _t(ct).long(), _t(ct).long(), lr,
                           *(_t(a) for a in neg), mask=_t(pm),
                           draws=_pool_draws(key))
    np.testing.assert_allclose(float(p_loss), float(r_loss), **LOSS_TOL)
    _compare_states(p_new, r_new)


def _fused_run(vc, bidir, seed, port_dtype=None, ref_dtype=None):
    """One fused SGD step of each package from the same float32 table
    values `vc`; a package whose dtype is None is not run."""
    r_opt, p_opt, lr = _opts("SGD")
    ct, pm = _walks(seed, bidir)
    key = jax.random.PRNGKey(seed)
    neg = _neg_state()
    out = {}
    if ref_dtype is not None:
        r_step = ref.make_graph_banded_fused_step(r_opt, K, NW, AUG, bidir,
                                                  M, G)
        r_new, r_loss = r_step(
            {"tables": (jnp.asarray(vc).astype(ref_dtype),),
             "moments": ((),)}, jnp.asarray(ct), jnp.asarray(ct), key,
            jnp.float32(lr), *(jnp.asarray(a) for a in neg),
            mask=jnp.asarray(pm))
        out["ref"] = (np.asarray(r_new["tables"][0].astype(jnp.float32)),
                      float(r_loss))
    if port_dtype is not None:
        p_step = port.make_graph_banded_fused_step(p_opt, K, NW, AUG, bidir,
                                                   M, G)
        p_vc = _t(vc).to(port_dtype)
        p_new, p_loss = p_step({"tables": (p_vc,), "moments": ((),)},
                               _t(ct).long(), _t(ct).long(), lr,
                               *(_t(a) for a in neg), mask=_t(pm),
                               draws=_pool_draws(key))
        assert p_new["tables"][0] is p_vc   # updated in place
        out["port"] = (p_vc.float().numpy(), float(p_loss))
    return out


def _vc(seed):
    tables, _ = _state_np("SGD", seed)
    return np.concatenate(tables, axis=1)


@pytest.mark.parametrize("bidir", [False, True])
def test_fused_step_matches_reference(bidir):
    out = _fused_run(_vc(6), bidir, 6, torch.float32, jnp.float32)
    (p_vc, p_loss), (r_vc, r_loss) = out["port"], out["ref"]
    np.testing.assert_allclose(p_loss, r_loss, **LOSS_TOL)
    np.testing.assert_allclose(p_vc, r_vc, **TABLE_TOL)


def _bf16_ulp(x):
    # bf16 keeps 8 significant bits: one ulp is 2^(e-7) for |x| in [2^e, 2^(e+1))
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


def test_fused_step_bf16():
    """bf16 tables. The port's kernel sums a row's float32 deltas and
    rounds once: its bf16 step equals its float32 step from the same
    (bf16-valued) table rounded to bf16, exactly, and lies within 1 bf16
    ulp of the reference's float32 step. The reference's bf16 step rounds
    each delta and each partial sum: it stays within n + 1 ulps of the
    port's, for a row touched n times in the batch."""
    vc16 = _bf16(_vc(6))
    out = _fused_run(vc16, True, 6, torch.bfloat16, jnp.bfloat16)
    (p_vc, p_loss), (r_vc, r_loss) = out["port"], out["ref"]
    f32 = _fused_run(vc16, True, 6, torch.float32, jnp.float32)
    np.testing.assert_array_equal(p_vc, _bf16(f32["port"][0]))
    r32 = f32["ref"][0]
    assert np.all(np.abs(p_vc - r32) <= _bf16_ulp(r32))
    # losses are computed from the same bf16 table values in float32
    np.testing.assert_allclose(p_loss, r_loss, **LOSS_TOL)
    ct, _ = _walks(6, True)
    k1, k2 = (np.array(x) for x in _pool_draws(jax.random.PRNGKey(6)))
    from graphvite_tpu.ops.alias import device_sample
    pool = np.asarray(device_sample(*(jnp.asarray(a) for a in _neg_state()),
                                    jnp.asarray(k1), jnp.asarray(k2)))
    touches = np.bincount(np.concatenate([ct.reshape(-1), pool.reshape(-1)]),
                          minlength=V)[:, None]
    mag = np.maximum(np.maximum(np.abs(p_vc), np.abs(r_vc)), np.abs(vc16))
    assert np.all(np.abs(p_vc - r_vc) <= (touches + 1) * _bf16_ulp(mag))


def _bf16(x):
    return torch.as_tensor(np.asarray(x, np.float32)).bfloat16().float().numpy()


def test_fused_pack_roundtrip():
    tables, _ = _state_np("SGD")
    state = {"tables": tuple(_t(t) for t in tables), "moments": ((), ())}
    back = port.banded_fused_unpack(port.banded_fused_pack(state))
    for a, b in zip(back["tables"], tables):
        assert a.is_contiguous()
        np.testing.assert_array_equal(a.numpy(), b)


def test_graph_pool_groups_matches_reference():
    for b in (1, 7, 64, 192, 576, 1000, 4096):
        for target in (1, 4, 56, 2048):
            assert port.graph_pool_groups(b, target) == ref.graph_pool_groups(
                b, target)


def test_fused_matches_unfused_in_port():
    """Within the port, the fused-arena SGD step gives the unfused step's
    tables (same generator stream, zero-grad dead slots), as the reference's
    test_banded_fused_arena_matches_unfused holds for the JAX package."""
    from graphvite_tpu_torch.graph import Graph
    from graphvite_tpu_torch.solver import GraphSolver

    rng = np.random.default_rng(0)
    edges = [(str(rng.integers(300)), str(rng.integers(300)))
             for _ in range(4000)]
    g = Graph().load_edge_list(edges)

    def train(fused):
        os.environ["GRAPHVITE_TRUST"] = "0"       # trust off -> fused legal
        os.environ["GRAPHVITE_FUSED_ARENA"] = "1" if fused else "0"
        try:
            s = GraphSolver(dim=16, seed=11, device="cpu")
            s.build(g, num_negative=2, batch_size=2048, episode_size=3)
            s.train(model="DeepWalk", num_epoch=30, augmentation_step=2,
                    random_walk_length=6, log_frequency=10**9)
            assert s._banded_fused == fused
            return s.vertex_embeddings, s.context_embeddings
        finally:
            del os.environ["GRAPHVITE_TRUST"]
            del os.environ["GRAPHVITE_FUSED_ARENA"]

    v1, c1 = train(True)
    v0, c0 = train(False)
    np.testing.assert_allclose(v1, v0, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(c1, c0, rtol=1e-5, atol=1e-7)


def test_micro_step_matches_reference():
    """make_micro_step applies the batch as R sequential chunks; fed the
    reference's per-chunk pool draws (its key split R ways), the port's
    chunked steps give the reference's micro-step result. The port's own
    make_micro_step is the same loop over its generator."""
    R = 2
    r_opt, p_opt, lr = _opts("SGD")
    ct, pm = _walks(8, True)
    tables, _ = _state_np("SGD", 8)
    key = jax.random.PRNGKey(8)
    neg = _neg_state()
    args = (K, NW, AUG, True, M, 1)   # one pool group per chunk
    r_micro = ref.make_micro_step(
        ref.make_graph_banded_walk_step(r_opt, *args, trust=0.25), R)
    r_new, r_loss = r_micro(
        {"tables": tuple(jnp.asarray(t) for t in tables),
         "moments": ((), ())}, jnp.asarray(ct), jnp.asarray(ct), key,
        jnp.float32(lr), *(jnp.asarray(a) for a in neg),
        mask=jnp.asarray(pm))
    p_step = port.make_graph_banded_walk_step(p_opt, *args, trust=0.25)
    state = {"tables": tuple(_t(t) for t in tables), "moments": ((), ())}
    bm = W // R
    losses = []
    for r, k in enumerate(jax.random.split(key, R)):
        sl = slice(r * bm, (r + 1) * bm)
        draws = tuple(torch.as_tensor(np.array(jax.random.uniform(kk, (1, M))))
                      for kk in jax.random.split(k))
        state, loss = p_step(state, _t(ct[sl]).long(), _t(ct[sl]).long(), lr,
                             *(_t(a) for a in neg), mask=_t(pm[sl]),
                             draws=draws)
        losses.append(float(loss))
    np.testing.assert_allclose(np.mean(losses), float(r_loss), **LOSS_TOL)
    _compare_states(state, r_new)

    # the port's make_micro_step is that loop, drawing from its generator
    micro = port.make_micro_step(p_step, R)
    s1 = {"tables": tuple(_t(t) for t in tables), "moments": ((), ())}
    s2 = {"tables": tuple(_t(t) for t in tables), "moments": ((), ())}
    s1, l1 = micro(s1, _t(ct).long(), _t(ct).long(), lr,
                   *(_t(a) for a in neg), mask=_t(pm),
                   generator=torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(3)
    l2 = []
    for r in range(R):
        sl = slice(r * bm, (r + 1) * bm)
        s2, loss = p_step(s2, _t(ct[sl]).long(), _t(ct[sl]).long(), lr,
                          *(_t(a) for a in neg), mask=_t(pm[sl]),
                          generator=gen)
        l2.append(loss)
    assert float(l1) == float(torch.stack(l2).mean())
    for a, b in zip(s1["tables"], s2["tables"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["LINE", "DeepWalk", "node2vec"])
def test_graph_models_match_reference(name):
    from graphvite_tpu.models import GRAPH_MODELS as REF_MODELS
    from graphvite_tpu_torch.models import GRAPH_MODELS as PORT_MODELS

    rng = np.random.default_rng(10)
    v = rng.normal(size=(5, 3, D)).astype(np.float32)
    c = rng.normal(size=(5, 3, D)).astype(np.float32)
    g = rng.normal(size=(5, 3)).astype(np.float32)
    r, p = REF_MODELS[name], PORT_MODELS[name]
    assert p.name == r.name
    np.testing.assert_allclose(p.score(_t(v), _t(c)).numpy(),
                               np.asarray(r.score(jnp.asarray(v),
                                                  jnp.asarray(c))),
                               rtol=1e-6, atol=1e-6)
    for a, b in zip(p.backward(_t(v), _t(c), _t(g)),
                    r.backward(jnp.asarray(v), jnp.asarray(c),
                               jnp.asarray(g))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
