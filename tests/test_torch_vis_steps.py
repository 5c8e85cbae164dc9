"""The port's LargeVis model and steps (models/visualization.py,
ops/steps.py: make_vis_pool_step, make_vis_train_step) against the JAX
package's, from the same numpy-seeded table, moments, batch, mask and
negative-sampler uniforms (the u1, u2 the reference draws from its key,
rebuilt here with the same splits and fed to the port as `draws`).

Tolerances: LargeVis score and backward rtol 1e-6. One step's table,
moments and loss rtol 1e-5, atol 1e-7 for float32 tables; a table entry
relative to the largest magnitude in its row, old or new (an entry's
update sums the row's touches, which can cancel to far less than the
terms summed, and keeps their rounding). bfloat16
tables: the reference rounds each delta to bf16 before its scatter sums
in bf16, the port sums in float32 and rounds once (a recorded
divergence), so a row touched n times may differ by n + 1 bf16 ulps, the
allowance of tests/test_torch_steps.py::test_fused_step_bf16. The pooled
step's hand gradients are held to torch.autograd at rtol 2e-4, atol 2e-5
(tests/test_pool_steps.py's tolerance against jax.grad)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphvite_tpu.ops.steps as ref
import graphvite_tpu.optim as ref_optim
import graphvite_tpu_torch.ops.steps as port
import graphvite_tpu_torch.optim as port_optim
from graphvite_tpu.models.visualization import LargeVis as RefLargeVis
from graphvite_tpu.ops.alias import AliasTable, device_alias_arrays
from graphvite_tpu_torch.models import SMOOTH_TERM, LargeVis
from graphvite_tpu_torch.solver import state_to_numpy

STEP_TOL = dict(rtol=1e-5, atol=1e-7)
V, D, B, K, M, G, NW = 60, 8, 32, 5, 8, 4, 3.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the cores (see tests/test_torch_steps.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x, dtype=None):
    return None if x is None else torch.as_tensor(np.array(x), dtype=dtype)


def _bf16(x):
    x = torch.as_tensor(np.asarray(x, np.float32))
    return x.bfloat16().float().numpy()


def _bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


def test_largevis_score_and_backward_match_reference():
    rng = np.random.default_rng(0)
    h, t = rng.normal(size=(2, 17, 6)).astype(np.float32)
    g = rng.normal(size=17).astype(np.float32)
    np.testing.assert_allclose(
        LargeVis.score(_t(h), _t(t)).numpy(),
        np.asarray(RefLargeVis.score(jnp.asarray(h), jnp.asarray(t))),
        rtol=1e-6)
    got = LargeVis.backward(_t(h), _t(t), _t(g))
    want = RefLargeVis.backward(jnp.asarray(h), jnp.asarray(t),
                                jnp.asarray(g))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    assert SMOOTH_TERM == 0.1


def _neg_state():
    w = np.random.default_rng(9).random(V) + 0.1
    return device_alias_arrays(AliasTable(w))


def _opts(rule):
    # SGD with the trust clip (the solver's default), Adam at the config's
    # lr and weight decay
    kw = (dict(type="SGD", lr=0.3, weight_decay=1e-5) if rule == "SGD"
          else dict(type="Adam", lr=0.5, weight_decay=1e-5))
    return ref_optim.Optimizer(**kw), port_optim.Optimizer(**kw), kw["lr"]


def _state_np(rule, seed=3, scale=1.0, dim=2):
    """A table of `dim` live columns padded to D with zeros; warm
    moments in the live columns (a cold Adam step divides by sqrt of a
    near-zero second moment, which amplifies last-digit differences),
    zero in the pad columns, as training leaves them."""
    rng = np.random.default_rng(seed)
    coord = np.zeros((V, D), np.float32)
    coord[:, :dim] = rng.normal(size=(V, dim)) * scale
    n_mom = 2 if rule == "Adam" else 0
    moms = tuple(np.zeros((V, D), np.float32) for _ in range(n_mom))
    for m in moms:
        m[:, :dim] = np.abs(rng.normal(size=(V, dim))) * 1e-2 + 1e-3
    return {"tables": (coord,), "moments": (moms,)}


def _batch(seed=1, masked=False):
    rng = np.random.default_rng(seed)
    heads = rng.integers(0, V, B).astype(np.int32)
    tails = rng.integers(0, V, B).astype(np.int32)
    heads[:4] = 7                     # a repeated head
    mask = None
    if masked:
        mask = (rng.random(B) > 0.3).astype(np.float32)
        mask[: B // G] = 0.0          # one whole group masked
    return heads, tails, mask


def _draws(key, shape):
    k1, k2 = jax.random.split(key)
    return tuple(np.asarray(jax.random.uniform(k, shape)) for k in (k1, k2))


def _run_both(kind, rule, masked, seed, port_dtype=torch.float32,
              ref_dtype=jnp.float32, table=None):
    ropt, popt, lr = _opts(rule)
    trust = 0.25 if rule == "SGD" else None
    if kind == "pool":
        rstep = ref.make_vis_pool_step(ropt, K, NW, pool_size=M,
                                       pool_groups=G, trust=trust)
        pstep = port.make_vis_pool_step(popt, K, NW, pool_size=M,
                                        pool_groups=G, trust=trust)
        shape = pstep.pool_shape
    else:
        rstep = ref.make_vis_train_step(RefLargeVis, ropt, K, NW,
                                        trust=trust)
        pstep = port.make_vis_train_step(LargeVis, popt, K, NW,
                                         trust=trust)
        shape = pstep.draw_shape(B)
    st = _state_np(rule, seed)
    if table is not None:
        st["tables"] = (table,)
    heads, tails, mask = _batch(seed + 1, masked)
    neg = _neg_state()
    key = jax.random.PRNGKey(seed)
    rstate = {"tables": (jnp.asarray(st["tables"][0], ref_dtype),),
              "moments": (tuple(jnp.asarray(m) for m in st["moments"][0]),)}
    r_new, r_loss = rstep(rstate, jnp.asarray(heads), jnp.asarray(tails),
                          key, jnp.float32(lr), *(jnp.asarray(a) for a in neg),
                          mask=None if mask is None else jnp.asarray(mask))
    pstate = {"tables": (_t(st["tables"][0]).to(port_dtype),),
              "moments": (tuple(_t(m) for m in st["moments"][0]),)}
    draws = tuple(_t(u) for u in _draws(key, shape))
    with torch.no_grad():
        p_new, p_loss = pstep(pstate, _t(heads), _t(tails), lr,
                              *(_t(a) for a in neg), mask=_t(mask),
                              draws=draws)
    got = state_to_numpy(p_new)
    p_tab = torch.as_tensor(p_new["tables"][0]).float().numpy()
    r_tab = np.asarray(jnp.asarray(r_new["tables"][0], jnp.float32))
    return dict(p_tab=p_tab, r_tab=r_tab, p_loss=float(p_loss),
                r_loss=float(r_loss), p_moms=got["moments"][0],
                r_moms=[np.asarray(m) for m in r_new["moments"][0]],
                heads=heads, tails=tails, neg=neg, draws=draws, st=st)


@pytest.mark.parametrize("kind", ["pool", "classic"])
@pytest.mark.parametrize("rule", ["SGD", "Adam"])
@pytest.mark.parametrize("masked", [False, True])
def test_vis_step_matches_reference(kind, rule, masked):
    out = _run_both(kind, rule, masked, seed=4)
    np.testing.assert_allclose(out["p_loss"], out["r_loss"], **STEP_TOL)
    old = out["st"]["tables"][0]
    scale = np.maximum(np.abs(out["r_tab"]), np.abs(old)).max(
        axis=1, keepdims=True)
    err = np.abs(out["p_tab"] - out["r_tab"])
    assert np.all(err <= STEP_TOL["atol"] + STEP_TOL["rtol"] * scale), \
        float((err / (scale + 1e-30)).max())
    assert len(out["p_moms"]) == len(out["r_moms"])
    for a, b in zip(out["p_moms"], out["r_moms"]):
        np.testing.assert_allclose(a, b, **STEP_TOL)
    # the pad columns stay exactly zero, weight decay included
    assert np.all(out["p_tab"][:, 2:] == 0.0)
    moved = np.abs(out["p_tab"] - out["st"]["tables"][0]).max(axis=1) > 0
    assert moved.any()


def _touches(kind, out):
    if kind == "pool":
        from graphvite_tpu_torch.ops.alias import device_sample
        pool = device_sample(*(_t(a) for a in out["neg"]),
                             *out["draws"]).numpy()
        ids = [out["heads"], out["tails"], pool.reshape(-1)]
    else:
        from graphvite_tpu_torch.ops.alias import device_sample
        negs = device_sample(*(_t(a) for a in out["neg"]),
                             *out["draws"]).numpy()
        # a head row takes K+1 touches
        ids = [np.repeat(out["heads"], K + 1), out["tails"],
               negs.reshape(-1)]
    return np.bincount(np.concatenate(ids), minlength=V)[:, None]


@pytest.mark.parametrize("kind", ["pool", "classic"])
@pytest.mark.parametrize("rule", ["SGD", "Adam"])
def test_vis_step_bf16_tables(kind, rule):
    """bfloat16 tables from the same bf16-valued start: within n + 1 bf16
    ulps of the reference's bf16 step for a row touched n times."""
    table = _bf16(_state_np(rule, 5, scale=3.0)["tables"][0])
    out = _run_both(kind, rule, False, seed=5, port_dtype=torch.bfloat16,
                    ref_dtype=jnp.bfloat16, table=table)
    np.testing.assert_allclose(out["p_loss"], out["r_loss"], rtol=1e-5)
    p, r = out["p_tab"], out["r_tab"]
    mag = np.maximum(np.maximum(np.abs(p), np.abs(r)), np.abs(table))
    touches = _touches(kind, out)
    assert np.all(np.abs(p - r) <= (touches + 1) * _bf16_ulp(mag))
    assert np.all(p[:, 2:] == 0.0)
    for a, b in zip(out["p_moms"], out["r_moms"]):
        np.testing.assert_allclose(a, b, rtol=1e-2, atol=1e-6)


def test_pool_step_gradients_match_autograd():
    """The pooled step's hand gradients against torch.autograd of the
    pooled LargeVis surrogate (SGD, wd 0, no clip): the positive term
    log1p(x_pos), and per pool row a stop-gradient factor times x / 2,
    whose derivative is the step's -2 prob / (x + SMOOTH) (h - P)."""
    rng = np.random.default_rng(3)
    v, d, b, k, m, g = 40, 8, 16, 5, 4, 2
    opt = port_optim.Optimizer(type="SGD", lr=0.1, weight_decay=0.0)
    step = port.make_vis_pool_step(opt, k, NW, pool_size=m, pool_groups=g,
                                   trust=None)
    coord = torch.as_tensor(rng.normal(size=(v, d)), dtype=torch.float32)
    heads = torch.as_tensor(rng.integers(0, v, b))
    tails = torch.as_tensor(rng.integers(0, v, b))
    pool = torch.as_tensor(rng.integers(0, v, (g, m)))
    # uniform alias table: the sampled id is floor(u1 * v)
    packed = torch.stack([torch.ones(v), torch.arange(v).float()], dim=1)
    draws = ((pool.float() + 0.5) / v, torch.zeros(g, m))
    with torch.no_grad():
        new, _ = step({"tables": (coord.clone(),), "moments": ((),)},
                      heads, tails, 0.1, packed, draws=draws)
    got = (coord - new["tables"][0]) / 0.1

    neg_w = NW * k / m
    table = coord.clone().requires_grad_(True)
    h = table[heads].reshape(g, b // g, d)
    t = table[tails].reshape(g, b // g, d)
    P = table[pool]
    x_pos = ((h - t) ** 2).sum(-1)
    x = ((h[:, :, None, :] - P[:, None, :, :]) ** 2).sum(-1)
    gfac = (-2.0 / (1.0 + x) / (x + SMOOTH_TERM)).detach()
    surrogate = torch.log1p(x_pos).sum() + neg_w * (0.5 * gfac * x).sum()
    surrogate.backward()
    np.testing.assert_allclose(got.numpy(), table.grad.numpy(), rtol=2e-4,
                               atol=2e-5)


def test_pool_step_is_exact_far_from_the_origin():
    """A spread layout's cluster far from the origin, where the pool terms'
    expanded products cancel (x = |h|^2 + |P|^2 - 2 h.P at |h| ~ 36 for x
    ~ 0.2; sum_m gneg (h - P_m) as gneg_sum h - gneg P): the pooled
    step's SGD gradient against the direct float64 form, to float32
    rounding. With float32 products (the reference's precision; ROADMAP.md
    queue 3) a fifth of the entries miss, by up to 7% of a gradient."""
    rng = np.random.default_rng(5)
    v, b, k, m, g = 400, 512, 5, 64, 4
    opt = port_optim.Optimizer(type="SGD", lr=1.0, weight_decay=0.0)
    step = port.make_vis_pool_step(opt, k, NW, pool_size=m, pool_groups=g,
                                   trust=None)
    coord = np.zeros((v, 8))
    coord[:, :2] = np.array([30.0, -20.0]) + rng.normal(size=(v, 2)) * 0.3
    coord = coord.astype(np.float32)
    heads, tails = rng.integers(0, v, b), rng.integers(0, v, b)
    pool = rng.integers(0, v, (g, m))
    packed = torch.stack([torch.ones(v), torch.arange(v).float()], dim=1)
    draws = (torch.as_tensor((pool + 0.5) / v, dtype=torch.float32),
             torch.zeros(g, m))
    with torch.no_grad():
        new, _ = step({"tables": (torch.tensor(coord),), "moments": ((),)},
                      torch.as_tensor(heads), torch.as_tensor(tails), 1.0,
                      packed, draws=draws)
    got = coord.astype(np.float64) - new["tables"][0].double().numpy()

    c = coord.astype(np.float64)
    h = c[heads].reshape(g, b // g, 8)
    t = c[tails].reshape(g, b // g, 8)
    P = c[pool]
    diff = h[:, :, None, :] - P[:, None, :, :]               # [g, bg, m, 8]
    x = (diff ** 2).sum(-1)
    gneg = -2.0 / (1.0 + x) / (x + SMOOTH_TERM) * (NW * k / m)
    x_pos = ((h - t) ** 2).sum(-1)
    gpos = (2.0 / (1.0 + x_pos))[..., None] * (h - t)
    want = np.zeros_like(c)
    np.add.at(want, heads, (gpos + (gneg[..., None] * diff).sum(2))
              .reshape(b, 8))
    np.add.at(want, tails, -gpos.reshape(b, 8))
    np.add.at(want, pool.reshape(-1), -(gneg[..., None] * diff).sum(1)
              .reshape(g * m, 8))
    # the table's own float32 rounding (|row| ~ 36) bounds the readout
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)


def test_pool_step_adam_stays_finite():
    """Adam at the config's lr over 40 pooled steps on one batch: the
    emulated K-draw counts keep the displacement bounded (the reference's
    regression test for the count = M + 1 divergence)."""
    rng = np.random.default_rng(0)
    v, d, b = 200, 8, 128
    opt = port_optim.Optimizer(type="Adam", lr=0.5, weight_decay=1e-5)
    step = port.make_vis_pool_step(opt, K, 5.0, pool_size=32, pool_groups=4)
    state = {"tables": (torch.as_tensor(rng.normal(size=(v, d)) * 1e-4,
                                        dtype=torch.float32),),
             "moments": (opt.init_moments((v, d)),)}
    heads = torch.as_tensor(rng.integers(0, v, b))
    tails = torch.as_tensor(rng.integers(0, v, b))
    neg = tuple(torch.as_tensor(a) for a in device_alias_arrays(
        AliasTable(np.ones(v))))
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for _ in range(40):
            state, loss = step(state, heads, tails, 0.5, *neg,
                               generator=gen)
    assert np.isfinite(float(loss))
    assert bool(torch.isfinite(state["tables"][0]).all())


def test_vis_steps_take_generator_draws():
    """Without `draws` the steps draw from the generator: the same seed
    gives the same step."""
    ropt, popt, lr = _opts("Adam")
    st = _state_np("Adam", 6)
    heads, tails, _ = _batch(7)
    neg = tuple(_t(a) for a in _neg_state())
    for step in (port.make_vis_pool_step(popt, K, NW, pool_size=M,
                                         pool_groups=G),
                 port.make_vis_train_step(LargeVis, popt, K, NW)):
        outs = []
        for _ in range(2):
            state = {"tables": (_t(st["tables"][0]),),
                     "moments": (tuple(_t(m) for m in st["moments"][0]),)}
            gen = torch.Generator().manual_seed(11)
            with torch.no_grad():
                new, loss = step(state, _t(heads), _t(tails), lr, *neg,
                                 generator=gen)
            outs.append((new["tables"][0], float(loss)))
        assert torch.equal(outs[0][0], outs[1][0])
        assert outs[0][1] == outs[1][1]


def test_pool_step_rejects_a_batch_the_groups_do_not_divide():
    _, popt, lr = _opts("SGD")
    step = port.make_vis_pool_step(popt, K, NW, pool_size=M, pool_groups=G)
    st = _state_np("SGD")
    with pytest.raises(ValueError, match="pool groups"):
        step({"tables": (_t(st["tables"][0]),), "moments": ((),)},
             torch.arange(G + 1), torch.arange(G + 1), lr,
             *(_t(a) for a in _neg_state()))
