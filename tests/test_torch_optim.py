"""The port's optimizer (optim.py) against the JAX package's: the closed-form
c-touch moment rules, dedup_rows, and every route of apply_row_updates.

Tolerance: rtol 1e-5, atol 1e-6 (float32; duplicate sums are taken in
another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphvite_tpu.optim as ref
import graphvite_tpu_torch.optim as port

TOL = dict(rtol=1e-5, atol=1e-6)
RULES = ["SGD", "Momentum", "AdaGrad", "RMSprop", "Adam"]


def _opts(rule):
    kw = dict(type=rule, lr=0.05, weight_decay=1e-3)
    return ref.Optimizer(**kw), port.Optimizer(**kw)


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.mark.parametrize("rule", RULES)
def test_moment_delta_matches_reference(rule):
    rng = np.random.default_rng(0)
    r_opt, p_opt = _opts(rule)
    g = rng.normal(size=(20, 8)).astype(np.float32)
    c = rng.integers(1, 50, (20, 1)).astype(np.float32)
    gsq = (g * g * rng.uniform(1, 3, (20, 8))).astype(np.float32)
    moms = [np.abs(rng.normal(size=(20, 8))).astype(np.float32)
            for _ in range(r_opt.num_moment)]
    d_ref, m_ref = ref.moment_delta(r_opt, 0.05, jnp.asarray(g),
                                    tuple(jnp.asarray(m) for m in moms),
                                    jnp.asarray(c), jnp.asarray(gsq))
    d_port, m_port = port.moment_delta(p_opt, 0.05, torch.as_tensor(g),
                                       tuple(torch.as_tensor(m) for m in moms),
                                       torch.as_tensor(c), torch.as_tensor(gsq))
    np.testing.assert_allclose(_np(d_port), np.asarray(d_ref), **TOL)
    for a, b in zip(m_port, m_ref):
        np.testing.assert_allclose(_np(a), np.asarray(b), **TOL)


def test_schedules_match_reference():
    for sched in ("linear", "constant"):
        r = ref.Optimizer(lr=0.025, schedule=sched)
        p = port.Optimizer(lr=0.025, schedule=sched)
        for bid, nb in ((0, 10), (3, 7), (9999, 10000), (12, 10)):
            assert p.schedule_lr(bid, nb) == float(
                r.schedule_lr(jnp.int32(bid), jnp.int32(nb)))


def test_make_optimizer_matches_reference():
    for spec in (0.1, "Adam", {"type": "RMSprop", "lr": 1e-3}):
        a = ref.make_optimizer(spec, ref.Optimizer(weight_decay=5e-3))
        b = port.make_optimizer(spec, port.Optimizer(weight_decay=5e-3))
        assert (a.type, a.lr, a.weight_decay, a.schedule) == (
            b.type, b.lr, b.weight_decay, b.schedule)


def _update_inputs(seed=1, v=30, d=8, n=90):
    rng = np.random.default_rng(seed)
    ids = (rng.random(n) ** 2 * v).astype(np.int32)
    ids[rng.choice(n, 7, replace=False)] = v        # dropped sentinels
    grads = rng.normal(size=(n, d)).astype(np.float32)
    table = rng.normal(size=(v, d)).astype(np.float32)
    counts = rng.integers(1, 6, n).astype(np.float32)
    sqs = (grads * grads * rng.uniform(1, 2, (n, d))).astype(np.float32)
    return table, ids, grads, counts, sqs


def test_dedup_rows_matches_reference():
    _, ids, grads, counts, sqs = _update_inputs()
    for ec, es in ((None, None), (counts, sqs)):
        r = ref.dedup_rows(jnp.asarray(ids), jnp.asarray(grads),
                           None if ec is None else jnp.asarray(ec),
                           None if es is None else jnp.asarray(es))
        p = port.dedup_rows(torch.as_tensor(ids), torch.as_tensor(grads),
                            None if ec is None else torch.as_tensor(ec),
                            None if es is None else torch.as_tensor(es))
        np.testing.assert_array_equal(p[0].numpy(), np.asarray(r[0]))
        for a, b in zip(p[1:], r[1:]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def _apply_both(rule, trust=None, entry=False, lr=0.05):
    r_opt, p_opt = _opts(rule)
    table, ids, grads, counts, sqs = _update_inputs()
    moms = [np.abs(np.random.default_rng(2).normal(size=table.shape))
            .astype(np.float32) for _ in range(r_opt.num_moment)]
    ec, es = (counts, sqs) if entry else (None, None)
    rt, rm = ref.apply_row_updates(
        jnp.asarray(table), tuple(jnp.asarray(m) for m in moms),
        jnp.asarray(ids), jnp.asarray(grads), r_opt, lr, lr_scale=0.5,
        entry_counts=None if ec is None else jnp.asarray(ec),
        entry_sqs=None if es is None else jnp.asarray(es), trust=trust)
    pt, pm = port.apply_row_updates(
        torch.as_tensor(table.copy()),
        tuple(torch.as_tensor(m.copy()) for m in moms),
        torch.as_tensor(ids), torch.as_tensor(grads), p_opt, lr,
        lr_scale=0.5,
        entry_counts=None if ec is None else torch.as_tensor(ec),
        entry_sqs=None if es is None else torch.as_tensor(es), trust=trust)
    np.testing.assert_allclose(pt.numpy(), np.asarray(rt), **TOL)
    assert len(pm) == len(rm)
    for a, b in zip(pm, rm):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    return pt


@pytest.mark.parametrize("trust", [None, 0.25])
def test_sgd_routes_match_reference(trust):
    """trust None: the plain scatter-add; trust 0.25: the dense clip, at a
    learning rate where the clip binds on most touched rows."""
    _apply_both("SGD", trust=trust, lr=1.0)


@pytest.mark.parametrize("rule", RULES[1:])
@pytest.mark.parametrize("entry", [False, True])
def test_moment_dense_route_matches_reference(rule, entry):
    _apply_both(rule, entry=entry)


@pytest.mark.parametrize("rule", RULES[1:])
def test_moment_dedup_route_matches_reference(rule, monkeypatch):
    monkeypatch.setattr(ref, "DENSE_UPDATE_ELEMS", 0)
    monkeypatch.setattr(port, "DENSE_UPDATE_ELEMS", 0)
    _apply_both(rule, entry=True)
