"""The port's moment-optimizer row update (ops/scatter.py:
scatter_update_sorted_ and scatter_update_) against the TPU kernel it
replaces, `sweep_scatter_update` / `sweep_scatter_update_unsorted` (Pallas
in interpret mode): per unique row one closed-form c-touch update, rows
with no touch untouched and their moments undecayed.

Tolerance: rtol 2e-5, atol 2e-5, the reference's own
(tests/test_pallas_scatter.py:247) for float32 tables; the two sum each
row's entries in other orders. A bfloat16 table is held to the same
float32 tolerance plus 1 bf16 ulp: both round the float32 delta to bf16
and round the difference once more."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphvite_tpu.optim as ref_optim
from graphvite_tpu.ops.pallas_scatter import (sweep_scatter_update,
                                              sweep_scatter_update_unsorted)
import graphvite_tpu_torch.optim as port_optim
from graphvite_tpu_torch.ops import scatter

TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(opt_type, v=2048, d=64, n=1024, seed=5, sort=True):
    rng = np.random.default_rng(seed)
    kw = dict(type=opt_type, lr=0.01, weight_decay=0.0)
    ids = (rng.random(n) ** 2 * v).astype(np.int32)
    if sort:
        ids = np.sort(ids)
    return dict(
        opts=(ref_optim.Optimizer(**kw), port_optim.Optimizer(**kw)),
        ids=ids,
        grads=rng.normal(size=(n, d)).astype(np.float32),
        counts=rng.integers(1, 4, n).astype(np.float32),
        sqs=np.abs(rng.normal(size=(n, d))).astype(np.float32),
        table=rng.normal(size=(v, d)).astype(np.float32),
        moms=[np.abs(rng.normal(size=(v, d))).astype(np.float32)
              for _ in range(port_optim.OPTIMIZER_MOMENTS[opt_type])])


def _t(x):
    return None if x is None else torch.as_tensor(np.array(x))


def _compare(got, want, tol=TOL):
    (gt, gm), (wt, wm) = got, want
    np.testing.assert_allclose(gt.float().numpy(),
                               np.asarray(wt, np.float32), **tol)
    assert len(gm) == len(wm)
    for a, b in zip(gm, wm):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)


@pytest.mark.parametrize("opt_type", ["Adam", "AdaGrad", "Momentum",
                                      "RMSprop"])
@pytest.mark.parametrize("lr_scale", [1.0, 0.37])
def test_sorted_matches_sweep_scatter_update(opt_type, lr_scale):
    x = _inputs(opt_type)
    r_opt, p_opt = x["opts"]
    want = sweep_scatter_update(
        jnp.asarray(x["table"]), tuple(jnp.asarray(m) for m in x["moms"]),
        jnp.asarray(x["ids"]), jnp.asarray(x["grads"]), r_opt,
        jnp.float32(0.01), entry_counts=jnp.asarray(x["counts"]),
        entry_sqs=jnp.asarray(x["sqs"]), lr_scale=lr_scale, tile_rows=512,
        chunk=256, interpret=True)
    table = _t(x["table"])
    moms = tuple(_t(m) for m in x["moms"])
    got = scatter.scatter_update_sorted_(
        table, moms, _t(x["ids"]), _t(x["grads"]), p_opt, 0.01,
        entry_counts=_t(x["counts"]), entry_sqs=_t(x["sqs"]),
        lr_scale=lr_scale)
    assert got[0] is table and all(a is b for a, b in zip(got[1], moms))
    _compare(got, want)


def test_zero_count_pads_leave_rows_untouched():
    """Entries with count 0 (the front ends' pads, parked at row V-1)
    register no touch: the row keeps its value and its moments; other
    entries' default squares are grad**2."""
    x = _inputs("Adam", v=1024, d=32, n=512, seed=3)
    r_opt, p_opt = x["opts"]
    v = 1024
    ids, counts, grads = x["ids"], x["counts"], x["grads"]
    ids[-256:] = v - 1            # a pad run at the last row
    counts[-256:] = 0.0
    grads[-256:] = 0.0
    want = sweep_scatter_update(
        jnp.asarray(x["table"]), tuple(jnp.asarray(m) for m in x["moms"]),
        jnp.asarray(ids), jnp.asarray(grads), r_opt, jnp.float32(0.01),
        entry_counts=jnp.asarray(counts), tile_rows=512, chunk=256,
        interpret=True)
    got = scatter.scatter_update_sorted_(
        _t(x["table"]), tuple(_t(m) for m in x["moms"]), _t(ids), _t(grads),
        p_opt, 0.01, entry_counts=_t(counts))
    _compare(got, want)
    np.testing.assert_array_equal(got[0][v - 1].numpy(), x["table"][v - 1])
    for m, m0 in zip(got[1], x["moms"]):
        np.testing.assert_array_equal(m[v - 1].numpy(), m0[v - 1])


@pytest.mark.parametrize("opt_type", ["Adam", "RMSprop"])
def test_unsorted_matches_sweep_scatter_update_unsorted(opt_type):
    """Unsorted ids, a count that is not a chunk multiple (the TPU front
    end pads with zero-count rows at V-1), default counts and squares:
    row V-1, never named, stays as it was."""
    v, d, n = 1024, 32, 700
    rng = np.random.default_rng(9)
    kw = dict(type=opt_type, lr=0.02, weight_decay=0.0)
    ids = (rng.random(n) ** 2 * (v - 1)).astype(np.int32)
    grads = rng.normal(size=(n, d)).astype(np.float32)
    table = rng.normal(size=(v, d)).astype(np.float32)
    n_mom = port_optim.OPTIMIZER_MOMENTS[opt_type]
    moms = [np.zeros((v, d), np.float32) for _ in range(n_mom)]
    want = sweep_scatter_update_unsorted(
        jnp.asarray(table), tuple(jnp.asarray(m) for m in moms),
        jnp.asarray(ids), jnp.asarray(grads), ref_optim.Optimizer(**kw),
        jnp.float32(0.02), tile_rows=512, chunk=256, interpret=True)
    got = scatter.scatter_update_(
        _t(table), tuple(_t(m) for m in moms), _t(ids), _t(grads),
        port_optim.Optimizer(**kw), 0.02)
    _compare(got, want)
    np.testing.assert_array_equal(got[0][v - 1].numpy(), table[v - 1])


def test_bf16_table():
    x = _inputs("Adam", seed=11)
    r_opt, p_opt = x["opts"]
    tb = jnp.asarray(x["table"]).astype(jnp.bfloat16)
    want = sweep_scatter_update(
        tb, tuple(jnp.asarray(m) for m in x["moms"]), jnp.asarray(x["ids"]),
        jnp.asarray(x["grads"]), r_opt, jnp.float32(0.01),
        entry_counts=jnp.asarray(x["counts"]),
        entry_sqs=jnp.asarray(x["sqs"]), tile_rows=512, chunk=256,
        interpret=True)
    got = scatter.scatter_update_sorted_(
        _t(x["table"]).bfloat16(), tuple(_t(m) for m in x["moms"]),
        _t(x["ids"]), _t(x["grads"]), p_opt, 0.01,
        entry_counts=_t(x["counts"]), entry_sqs=_t(x["sqs"]))
    assert got[0].dtype == torch.bfloat16
    g = got[0].float().numpy()
    w = np.asarray(want[0], np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.maximum(np.abs(g),
                                                         np.abs(w)),
                                              2.0 ** -126))) - 7)
    assert np.all(np.abs(g - w) <= 2e-5 + 2e-5 * np.abs(w) + ulp)
    for a, b in zip(got[1], want[1]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("sorted_entry", [True, False])
def test_sgd_hands_off_to_scatter_add(sorted_entry):
    """SGD: -(lr * lr_scale) * grads summed into the table (kernel 1),
    moments untouched, as sweep_scatter_update hands off to the scatter."""
    x = _inputs("SGD", v=512, d=16, n=512, seed=2, sort=sorted_entry)
    r_opt, p_opt = x["opts"]
    order = np.argsort(x["ids"], kind="stable")
    want = sweep_scatter_update(
        jnp.asarray(x["table"]), (), jnp.asarray(x["ids"][order]),
        jnp.asarray(x["grads"][order]), r_opt, jnp.float32(0.05),
        lr_scale=0.5, tile_rows=256, chunk=128, interpret=True)
    fn = (scatter.scatter_update_sorted_ if sorted_entry
          else scatter.scatter_update_)
    got = fn(_t(x["table"]), (), _t(x["ids"]), _t(x["grads"]), p_opt, 0.05,
             lr_scale=0.5)
    _compare(got, want, dict(rtol=1e-5, atol=1e-6))


def test_sorted_entry_rejects_unsorted_ids_on_cpu():
    """The sorted entry's contract: on the card, ids that are not
    ascending would lose updates, so the CPU path refuses them."""
    x = _inputs("Adam", v=64, d=8, n=32, sort=False)
    _, p_opt = x["opts"]
    with pytest.raises(ValueError, match="ascending"):
        scatter.scatter_update_sorted_(
            _t(x["table"]), tuple(_t(m) for m in x["moms"]), _t(x["ids"]),
            _t(x["grads"]), p_opt, 0.01)


def test_rejects_bad_moments_and_counts_no_cpu_launch():
    x = _inputs("Adam", v=64, d=8, n=32)
    _, p_opt = x["opts"]
    args = (_t(x["ids"]), _t(x["grads"]), p_opt, 0.01)
    with pytest.raises(ValueError, match="moment"):
        scatter.scatter_update_(_t(x["table"]), (_t(x["moms"][0]),), *args)
    with pytest.raises(ValueError, match="float32"):
        scatter.scatter_update_(_t(x["table"]),
                                tuple(_t(m).double() for m in x["moms"]),
                                *args)
    before = (scatter.scatter_update_.launches,
              scatter.scatter_update_sorted_.launches)
    scatter.scatter_update_(_t(x["table"]), tuple(_t(m) for m in x["moms"]),
                            *args)
    assert before == (scatter.scatter_update_.launches,
                      scatter.scatter_update_sorted_.launches)
