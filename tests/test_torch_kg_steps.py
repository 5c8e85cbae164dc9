"""The port's knowledge-graph steps (ops/steps.py) and the relation-carrying
edge sampler against the JAX package's, from the same numpy-seeded state,
triplets, mask and candidate ids (`negatives`, fed to both).

Tolerances (those of tests/test_pool_steps.py, float32): loss rtol 2e-5;
tables and moments rtol 3e-4, atol 3e-6 (each framework's own sum order
over D, over the pool and over a row's touches); Adam's first batch from
zero moments divides by sqrt(m2) ~ 1e-3 |g|, which amplifies the
gradients' last-digit differences, so its tables get atol 2e-5. bfloat16
tables: the reference rounds each delta to bf16 before its scatter sums
them in bf16, the port sums in float32 and rounds once (a recorded
divergence); the port's bf16 step is held to the reference's float32 step
from the same bf16-valued tables, within 1 bf16 ulp plus the float32
tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphvite_tpu.ops.steps as ref
import graphvite_tpu.optim as ref_optim
import graphvite_tpu_torch.ops.steps as port
import graphvite_tpu_torch.optim as port_optim
from graphvite_tpu.models import KG_MODELS as REF_MODELS
from graphvite_tpu.ops.device_sampler import \
    DeviceEdgeSampler as RefEdgeSampler
from graphvite_tpu_torch.graph import KnowledgeGraph
from graphvite_tpu_torch.models import KG_MODELS
from graphvite_tpu_torch.ops.device_sampler import DeviceEdgeSampler
from graphvite_tpu_torch.solver import state_from_numpy, state_to_numpy

LOSS_TOL = dict(rtol=2e-5)
TABLE_TOL = dict(rtol=3e-4, atol=3e-6)
V, R, D, B, K, M, G = 40, 6, 16, 24, 4, 8, 4
NAMES = ["TransE", "DistMult", "ComplEx", "SimplE", "RotatE", "QuatE"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the cores (see tests/test_torch_steps.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _opts(rule, wd=1e-3):
    lr = 0.05 if rule == "SGD" else 1e-3
    kw = dict(type=rule, lr=lr, weight_decay=wd)
    return ref_optim.Optimizer(**kw), port_optim.Optimizer(**kw), lr


def _hyper(name):
    return 6.0 if REF_MODELS[name].uses_margin else 2e-3


def _batch(seed=1, masked=False):
    rng = np.random.default_rng(seed)
    heads = rng.integers(0, V, B).astype(np.int32)
    tails = rng.integers(0, V, B).astype(np.int32)
    rels = rng.integers(0, R, B).astype(np.int32)
    mask = None
    if masked:
        mask = (rng.random(B) > 0.3).astype(np.float32)
        mask[: B // G] = 0.0          # one whole group masked
    return heads, tails, rels, mask


def _state_np(num_moment, seed=2, warm=False):
    rng = np.random.default_rng(seed)
    ent = (rng.normal(size=(V, D)) * 0.5).astype(np.float32)
    rel = (rng.normal(size=(R, D)) * 0.5).astype(np.float32)

    def moms(shape):
        if not warm:
            return tuple(np.zeros(shape, np.float32)
                         for _ in range(num_moment))
        return tuple((np.abs(rng.normal(size=shape)) * 1e-2 + 1e-3)
                     .astype(np.float32) for _ in range(num_moment))
    return {"tables": (ent, rel), "moments": (moms((V, D)), moms((R, D)))}


def _ref_state(state_np):
    return jax.tree_util.tree_map(jnp.asarray, state_np)


def _compare(got_state, want_state, got_loss, want_loss, table_tol=TABLE_TOL):
    np.testing.assert_allclose(float(got_loss), float(want_loss), **LOSS_TOL)
    got = state_to_numpy(got_state)
    for a, b in zip(got["tables"], want_state["tables"]):
        np.testing.assert_allclose(a, np.asarray(b), **table_tol)
    for ga, gb in zip(got["moments"], want_state["moments"]):
        assert len(ga) == len(gb)
        for a, b in zip(ga, gb):
            np.testing.assert_allclose(a, np.asarray(b), **TABLE_TOL)


def _t(x, dtype=None):
    return None if x is None else torch.as_tensor(np.array(x), dtype=dtype)


def _j(x):
    return None if x is None else jnp.asarray(x)


def _table_tol(rule, warm):
    # cold Adam/RMSprop/AdaGrad divide by the sqrt of a tiny second moment
    if rule != "SGD" and not warm:
        return dict(rtol=3e-4, atol=2e-5)
    return TABLE_TOL


# ---------------------------------------------------------------------------
# the classic per-draw step
# ---------------------------------------------------------------------------

def _classic_negatives(seed=5):
    rng = np.random.default_rng(seed)
    cand = rng.integers(0, V, (B, K)).astype(np.int32)
    side = rng.random((B, K)) < 0.5
    return cand, side


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("rule", ["SGD", "Adam", "AdaGrad"])
@pytest.mark.parametrize("masked", [False, True])
def test_kg_train_step_matches_reference(name, rule, masked):
    r_opt, p_opt, lr = _opts(rule)
    heads, tails, rels, mask = _batch(masked=masked)
    cand, side = _classic_negatives()
    warm = rule == "Adam"
    state_np = _state_np(r_opt.num_moment, warm=warm)
    temp = 2.0 if name != "DistMult" else 0.0      # uniform weights once
    r_step = ref.make_kg_train_step(REF_MODELS[name], r_opt, K, _hyper(name),
                                    temp, 0.5)
    p_step = port.make_kg_train_step(KG_MODELS[name], p_opt, K, _hyper(name),
                                     temp, 0.5)
    want_state, want_loss = r_step(
        _ref_state(state_np), _j(heads), _j(tails), _j(rels),
        jax.random.PRNGKey(0), jnp.float32(lr), mask=_j(mask),
        negatives=(_j(cand), _j(side)))
    got_state, got_loss = p_step(
        state_from_numpy(state_np, "cpu"), _t(heads), _t(tails), _t(rels),
        lr, mask=_t(mask), negatives=(_t(cand), _t(side)))
    _compare(got_state, want_state, got_loss, want_loss,
             _table_tol(rule, warm))


def test_kg_train_step_draws_split_ids():
    """Without `negatives` the step draws ids over [0, 2V): the table moves
    on candidate rows, and the same generator seed gives the same step."""
    _, p_opt, lr = _opts("SGD")
    heads, tails, rels, _ = _batch()
    step = port.make_kg_train_step(KG_MODELS["RotatE"], p_opt, K, 6.0, 2.0,
                                   1.0)
    outs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(3)
        state, loss = step(state_from_numpy(_state_np(0), "cpu"), _t(heads),
                           _t(tails), _t(rels), lr, generator=gen)
        outs.append((state["tables"][0].clone(), float(loss)))
    assert torch.equal(outs[0][0], outs[1][0]) and outs[0][1] == outs[1][1]
    before = _state_np(0)["tables"][0]
    moved = (outs[0][0].numpy() != before).any(axis=1)
    touched = np.zeros(V, bool)
    touched[heads] = touched[tails] = True
    assert moved[~touched].any()        # candidate rows beyond the positives


def test_kg_train_step_external_pool_not_ported():
    """external_pool=True, once a raise, is ported: candidate rows from a
    caller-owned pool, left out of the entity update, their [B, K, D]
    gradients returned. Held to the reference on the same pool rows,
    indices, sides and mask, SGD and warm Adam (the sharded KG engine's
    global pool)."""
    heads, tails, rels, mask = _batch(masked=True)
    rng = np.random.default_rng(9)
    N = 12
    pool_rows = (rng.normal(size=(N, D)) * 0.5).astype(np.float32)
    pool_idx = rng.integers(0, N, (B, K)).astype(np.int32)
    side = rng.random((B, K)) < 0.5
    for rule in ("SGD", "Adam"):
        r_opt, p_opt, lr = _opts(rule)
        state_np = _state_np(r_opt.num_moment, warm=rule == "Adam")
        r_step = ref.make_kg_train_step(REF_MODELS["RotatE"], r_opt, K, 6.0,
                                        2.0, 0.5, external_pool=True)
        p_step = port.make_kg_train_step(KG_MODELS["RotatE"], p_opt, K, 6.0,
                                         2.0, 0.5, external_pool=True)
        want_state, want_loss, want_grad = r_step(
            _ref_state(state_np), _j(heads), _j(tails), _j(rels),
            jax.random.PRNGKey(0), jnp.float32(lr), mask=_j(mask),
            pool=(_j(pool_rows), _j(pool_idx), _j(side)))
        got_state, got_loss, got_grad = p_step(
            state_from_numpy(state_np, "cpu"), _t(heads), _t(tails),
            _t(rels), lr, mask=_t(mask),
            pool=(_t(pool_rows), _t(pool_idx), _t(side)))
        _compare(got_state, want_state, got_loss, want_loss)
        assert got_grad.shape == (B, K, D)
        np.testing.assert_allclose(got_grad.numpy(), np.asarray(want_grad),
                                   **TABLE_TOL)


# ---------------------------------------------------------------------------
# the pooled step
# ---------------------------------------------------------------------------

def _pool_negatives(seed=6):
    return np.random.default_rng(seed).integers(0, V, (G, M)).astype(np.int32)


def _pool_steps(name, r_opt, p_opt, trust=None, **kw):
    args = (K, _hyper(name), 2.0, 0.5)
    r_step = ref.make_kg_pool_step(REF_MODELS[name], r_opt, *args,
                                   pool_size=M, pool_groups=G, trust=trust)
    p_step = port.make_kg_pool_step(KG_MODELS[name], p_opt, *args,
                                    pool_size=M, pool_groups=G, trust=trust,
                                    **kw)
    return r_step, p_step


def _run_pool(r_step, p_step, state_np, lr, masked, float_type=torch.float32):
    heads, tails, rels, mask = _batch(masked=masked)
    cand = _pool_negatives()
    want = r_step(_ref_state(state_np), _j(heads), _j(tails), _j(rels),
                  jax.random.PRNGKey(0), jnp.float32(lr), mask=_j(mask),
                  negatives=_j(cand))
    got = p_step(state_from_numpy(state_np, "cpu", float_type), _t(heads),
                 _t(tails), _t(rels), lr, mask=_t(mask), negatives=_t(cand))
    return got, want


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("rule", ["SGD", "Adam", "AdaGrad"])
@pytest.mark.parametrize("masked", [False, True])
def test_kg_pool_step_generic_body_matches_reference(name, rule, masked,
                                                     monkeypatch):
    monkeypatch.setenv("GRAPHVITE_KG_FAST", "0")
    r_opt, p_opt, lr = _opts(rule)
    warm = rule == "Adam"
    r_step, p_step = _pool_steps(name, r_opt, p_opt)
    assert not p_step.fast_rotate and p_step.pool_shape == (G, M)
    (got_state, got_loss), (want_state, want_loss) = _run_pool(
        r_step, p_step, _state_np(r_opt.num_moment, warm=warm), lr, masked)
    _compare(got_state, want_state, got_loss, want_loss,
             _table_tol(rule, warm))


@pytest.mark.parametrize("rule", ["SGD", "Adam", "AdaGrad"])
@pytest.mark.parametrize("masked", [False, True])
def test_kg_pool_step_fast_body_matches_reference(rule, masked, monkeypatch):
    monkeypatch.delenv("GRAPHVITE_KG_FAST", raising=False)
    r_opt, p_opt, lr = _opts(rule, wd=0.0)
    warm = rule == "Adam"
    r_step, p_step = _pool_steps("RotatE", r_opt, p_opt)
    assert p_step.fast_rotate
    (got_state, got_loss), (want_state, want_loss) = _run_pool(
        r_step, p_step, _state_np(r_opt.num_moment, warm=warm), lr, masked)
    _compare(got_state, want_state, got_loss, want_loss,
             _table_tol(rule, warm))


def test_fast_body_needs_zero_weight_decay_and_rotate(monkeypatch):
    monkeypatch.delenv("GRAPHVITE_KG_FAST", raising=False)
    _, with_wd, _ = _opts("SGD", wd=1e-3)
    _, no_wd, _ = _opts("SGD", wd=0.0)
    mk = lambda name, opt: port.make_kg_pool_step(
        KG_MODELS[name], opt, K, 6.0, 2.0, 1.0, pool_size=M, pool_groups=G)
    assert mk("RotatE", no_wd).fast_rotate
    assert not mk("RotatE", with_wd).fast_rotate
    assert not mk("TransE", no_wd).fast_rotate
    monkeypatch.setenv("GRAPHVITE_KG_FAST", "0")
    assert not mk("RotatE", no_wd).fast_rotate


@pytest.mark.parametrize("rule", ["SGD", "Adam"])
@pytest.mark.parametrize("masked", [False, True])
def test_kg_fast_body_matches_generic_body(rule, masked, monkeypatch):
    """As tests/test_pool_steps.py::test_kg_fast_rotate_body_matches_generic
    holds the reference's two bodies to each other (rtol 2e-4, atol 2e-5)."""
    _, p_opt, lr = _opts(rule, wd=0.0)
    heads, tails, rels, mask = _batch(masked=masked)
    cand = _pool_negatives()
    outs = {}
    for fast in ("0", "1"):
        monkeypatch.setenv("GRAPHVITE_KG_FAST", fast)
        step = port.make_kg_pool_step(KG_MODELS["RotatE"], p_opt, K, 9.0,
                                      2.0, 1.0, pool_size=M, pool_groups=G,
                                      trust=None)
        outs[fast] = step(state_from_numpy(_state_np(p_opt.num_moment),
                                           "cpu"),
                          _t(heads), _t(tails), _t(rels), lr, mask=_t(mask),
                          negatives=_t(cand))
    (st0, loss0), (st1, loss1) = outs["0"], outs["1"]
    np.testing.assert_allclose(float(loss0), float(loss1), rtol=2e-5)
    a, b = state_to_numpy(st0), state_to_numpy(st1)
    for x, y in zip(a["tables"] + sum(a["moments"], ()),
                    b["tables"] + sum(b["moments"], ())):
        np.testing.assert_allclose(x, y, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("fast", ["0", "1"])
@pytest.mark.parametrize("rule", ["SGD", "Adam"])
@pytest.mark.parametrize("gp", [2, 3, 4])
def test_groups_per_pass_matches_one_group_per_pass(fast, rule, gp,
                                                    monkeypatch):
    """Several groups batched into one [g, Bg, M/2, D] pass give what one
    group at a time gives (the reference's scan): the sums are per group
    either way; only their order inside a reduction may differ (rtol 1e-5,
    atol 1e-7). The step takes as many groups as keep one intermediate
    under GROUP_PASS_ELEMS, so the bound sets the count here; 3 does not
    divide G 4 and falls to 2."""
    monkeypatch.setenv("GRAPHVITE_KG_FAST", fast)
    _, p_opt, lr = _opts(rule, wd=0.0)
    heads, tails, rels, mask = _batch(masked=True)
    cand = _pool_negatives()
    one_group = (B // G) * (M // 2) * (D // 2 if fast == "1" else D)
    outs = []
    for groups in (1, gp):
        monkeypatch.setattr(port, "GROUP_PASS_ELEMS", groups * one_group)
        step = port.make_kg_pool_step(KG_MODELS["RotatE"], p_opt, K, 6.0,
                                      2.0, 1.0, pool_size=M, pool_groups=G)
        # one softplus per pass over the negatives, one for the positives
        calls = []
        softplus = port.F.softplus
        monkeypatch.setattr(port.F, "softplus",
                            lambda x: (calls.append(1), softplus(x))[1])
        outs.append(step(state_from_numpy(_state_np(p_opt.num_moment,
                                                    warm=True), "cpu"),
                         _t(heads), _t(tails), _t(rels), lr, mask=_t(mask),
                         negatives=_t(cand)))
        monkeypatch.setattr(port.F, "softplus", softplus)
        assert len(calls) == 1 + G // (groups if G % groups == 0 else 2)
    (st0, loss0), (st1, loss1) = outs
    np.testing.assert_allclose(float(loss0), float(loss1), rtol=1e-6)
    a, b = state_to_numpy(st0), state_to_numpy(st1)
    for x, y in zip(a["tables"] + sum(a["moments"], ()),
                    b["tables"] + sum(b["moments"], ())):
        np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-7)
    # the default bound holds every group of this small batch at once
    monkeypatch.undo()
    assert port.GROUP_PASS_ELEMS == 1 << 25 >= G * one_group


@pytest.mark.parametrize("fast", ["0", "1"])
def test_kg_pool_step_trust_clip_matches_reference(fast, monkeypatch):
    """A learning rate at which the clip on the candidate rows binds."""
    monkeypatch.setenv("GRAPHVITE_KG_FAST", fast)
    r_opt, p_opt, _ = _opts("SGD", wd=0.0)
    lr = 20.0
    r_step, p_step = _pool_steps("RotatE", r_opt, p_opt, trust=0.25)
    (got_state, got_loss), (want_state, want_loss) = _run_pool(
        r_step, p_step, _state_np(0), lr, masked=False)
    _compare(got_state, want_state, got_loss, want_loss,
             dict(rtol=3e-4, atol=3e-5))
    # the clip did bind: without it the candidate rows land elsewhere
    _, free_step = _pool_steps("RotatE", r_opt, p_opt, trust=None)
    (free_state, _), _ = _run_pool(r_step, free_step, _state_np(0), lr, False)
    assert not np.allclose(free_state["tables"][0].numpy(),
                           got_state["tables"][0].numpy(), atol=1e-3)


def _bf16_ulp(x):
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("fast", ["0", "1"])
@pytest.mark.parametrize("rule", ["SGD", "Adam"])
def test_kg_pool_step_bf16_tables(fast, rule, monkeypatch):
    monkeypatch.setenv("GRAPHVITE_KG_FAST", fast)
    r_opt, p_opt, lr = _opts(rule, wd=0.0)
    state_np = _state_np(r_opt.num_moment, warm=True)
    # both start from the same bf16-representable values
    rounded = tuple(torch.as_tensor(t).bfloat16().float().numpy()
                    for t in state_np["tables"])
    state_np = {"tables": rounded, "moments": state_np["moments"]}
    r_step, p_step = _pool_steps("RotatE", r_opt, p_opt)
    (got_state, got_loss), (want_state, want_loss) = _run_pool(
        r_step, p_step, state_np, lr, masked=False,
        float_type=torch.bfloat16)
    assert got_state["tables"][0].dtype == torch.bfloat16
    np.testing.assert_allclose(float(got_loss), float(want_loss), **LOSS_TOL)
    for a, b in zip(got_state["tables"], want_state["tables"]):
        a, b = a.float().numpy(), np.asarray(b)
        tol = (_bf16_ulp(np.maximum(np.abs(a), np.abs(b)))
               + 3e-6 + 3e-4 * np.abs(b))
        assert (np.abs(a - b) <= tol).all()
    for ga, gb in zip(got_state["moments"], want_state["moments"]):
        for a, b in zip(ga, gb):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TABLE_TOL)


def test_kg_pool_step_rejects_ragged_batch():
    _, p_opt, lr = _opts("SGD")
    step = port.make_kg_pool_step(KG_MODELS["TransE"], p_opt, K, 6.0, 2.0,
                                  1.0, pool_size=M, pool_groups=G)
    heads, tails, rels, _ = _batch()
    with pytest.raises(ValueError, match="pool groups"):
        step(state_from_numpy(_state_np(0), "cpu"), _t(heads[:-1]),
             _t(tails[:-1]), _t(rels[:-1]), lr)


@pytest.mark.parametrize("batch", [7424, 14848, 60928, 20000, 100000, 512,
                                   30, 6])
@pytest.mark.parametrize("target", [512, 128])
def test_kg_pool_groups_matches_reference(batch, target):
    assert (port.kg_pool_groups(batch, target_group=target)
            == ref.kg_pool_groups(batch, target_group=target))


def test_kg_predict_matches_reference():
    state_np = _state_np(0)
    heads, tails, rels, _ = _batch()
    for name in NAMES:
        want = ref.kg_predict(REF_MODELS[name], *map(_j, state_np["tables"]),
                              _j(heads), _j(tails), _j(rels), _hyper(name))
        got = port.kg_predict(KG_MODELS[name], *map(_t, state_np["tables"]),
                              _t(heads), _t(tails), _t(rels), _hyper(name))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# micro-steps and the episode runner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pooled", [False, True])
def test_micro_step_matches_sequential_chunks(pooled):
    """As tests/test_micro_step.py: R micro-steps are the step applied to
    the R chunks in turn, each from the state the last one left, the loss
    their mean; the same generator seed gives the same candidates."""
    _, p_opt, lr = _opts("Adam", wd=0.0)
    heads, tails, rels, mask = _batch(masked=True)
    if pooled:
        base = port.make_kg_pool_step(KG_MODELS["RotatE"], p_opt, K, 6.0,
                                      2.0, 1.0, pool_size=M, pool_groups=2)
    else:
        base = port.make_kg_train_step(KG_MODELS["RotatE"], p_opt, K, 6.0,
                                       2.0, 1.0)
    Rm = 3
    micro = port.make_micro_step(base, Rm, has_relation=True)
    assert port.make_micro_step(base, 1, has_relation=True) is base
    gen = torch.Generator().manual_seed(9)
    got_state, got_loss = micro(state_from_numpy(_state_np(2), "cpu"),
                                _t(heads), _t(tails), _t(rels), lr,
                                mask=_t(mask), generator=gen)
    gen = torch.Generator().manual_seed(9)
    state = state_from_numpy(_state_np(2), "cpu")
    bm = B // Rm
    losses = []
    for r in range(Rm):
        sl = slice(r * bm, (r + 1) * bm)
        state, loss = base(state, _t(heads[sl]), _t(tails[sl]), _t(rels[sl]),
                           lr, mask=_t(mask[sl]), generator=gen)
        losses.append(float(loss))
    np.testing.assert_allclose(float(got_loss), np.mean(losses), rtol=1e-6)
    for a, b in zip(got_state["tables"], state["tables"]):
        assert torch.equal(a, b)


def _kg(num_edge, seed=0, weighted=False):
    rng = np.random.default_rng(seed)
    g = KnowledgeGraph()
    g.num_vertex, g.num_relation, g.num_edge = V, R, num_edge
    g.edge_heads = rng.integers(0, V, num_edge)
    g.edge_tails = rng.integers(0, V, num_edge)
    g.edge_relations = rng.integers(0, R, num_edge)
    g.edge_weights = (rng.random(num_edge).astype(np.float32) + 0.1
                      if weighted else np.ones(num_edge, np.float32))
    return g


@pytest.mark.parametrize("mode", ["uniform", "weighted", "streamed"])
def test_edge_sampler_with_relations_matches_reference(mode, monkeypatch):
    """The reference's sample from a key, and the port's from the same
    draws (rebuilt from the key as the reference derives them)."""
    monkeypatch.setattr(RefEdgeSampler, "MIN_STREAM_BLOCKS", 2)
    monkeypatch.setattr(DeviceEdgeSampler, "MIN_STREAM_BLOCKS", 2)
    n = 5000 if mode == "streamed" else 300
    g = _kg(n, weighted=(mode == "weighted"))
    r_s = RefEdgeSampler.build(g, with_relation=True)
    p_s = DeviceEdgeSampler.build(g, with_relation=True)
    assert p_s.with_rel
    assert p_s.streamed == r_s.streamed == (mode == "streamed")
    np.testing.assert_array_equal(p_s.edges.numpy(), np.asarray(r_s.edges))
    assert p_s.edges.shape[-1] == 3
    batch = 1500 if mode == "streamed" else 64
    key = jax.random.PRNGKey(4)
    want = r_s.make_sample_fn(batch)(key, *r_s.arrays())
    if mode == "streamed":
        nb = -(-batch // 1024)
        draws = (_t(jax.random.randint(key, (nb,), 0, r_s.edges.shape[0]),
                    torch.long), None)
    elif mode == "uniform":
        draws = _t(jax.random.randint(key, (batch,), 0, n), torch.long)
    else:
        k1, k2 = jax.random.split(key)
        draws = (_t(jax.random.uniform(k1, (batch,))),
                 _t(jax.random.uniform(k2, (batch,))))
    got = p_s.make_sample_fn(batch)(*p_s.arrays(), draws=draws)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # and from a generator: triplets of the graph, a mask of ones
    gen = torch.Generator().manual_seed(1)
    h, t, r, m = p_s.make_sample_fn(batch)(*p_s.arrays(), generator=gen)
    trip = set(zip(g.edge_heads.tolist(), g.edge_tails.tolist(),
                   g.edge_relations.tolist()))
    assert set(zip(h.tolist(), t.tolist(), r.tolist())) <= trip
    assert bool((m == 1).all()) and m.shape == (batch,)


def test_fused_runner_trains_triplets():
    """The runner hands (heads, tails, rels) from the relation sampler to
    the KG step, with the scheduled learning rate and positive reuse."""
    _, p_opt, _ = _opts("SGD", wd=0.0)
    g = _kg(300)
    sampler = DeviceEdgeSampler.build(g, with_relation=True)
    step = port.make_kg_pool_step(KG_MODELS["RotatE"], p_opt, K, 6.0, 2.0,
                                  1.0, pool_size=M, pool_groups=G)
    seen = []

    def spy(state, heads, tails, rels, lr, mask=None, generator=None):
        seen.append((heads.clone(), rels.clone(), lr))
        return step(state, heads, tails, rels, lr, mask=mask,
                    generator=generator)

    run = port.make_fused_runner(spy, sampler.make_sample_fn(B), p_opt, 3, 2)
    gen = torch.Generator().manual_seed(0)
    state, losses = run(state_from_numpy(_state_np(0), "cpu"), 4, 100, gen,
                        sampler.arrays(), ())
    assert losses.shape == (6,) and bool(torch.isfinite(losses).all())
    assert len(seen) == 6
    assert torch.equal(seen[0][0], seen[1][0])          # reused positives
    assert not torch.equal(seen[0][0], seen[2][0])
    assert [s[2] for s in seen] == [p_opt.schedule_lr(4 + i, 100)
                                    for i in range(6)]
    assert seen[0][1].dtype == torch.int32
