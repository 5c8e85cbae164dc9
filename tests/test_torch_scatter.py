"""The port's scatter-add (ops/scatter.py) against the TPU kernel it
replaces, `sweep_scatter_add` / `sweep_scatter_add_unsorted` (Pallas in
interpret mode), and against XLA's `.at[].add(mode="drop")`.

Tolerances: float32 results agree within rtol 1e-6 of the magnitude of
the terms each entry sums (|table| + sum of |upd| over its ids): the
summation orders differ, and reordering a float32 sum moves it by a few
ulps of that magnitude. bfloat16 tables are held to the float32 sum
rounded once to bfloat16, within 1 bf16 ulp (the kernel's contract:
float32 accumulation, one rounding)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphvite_tpu.ops.pallas_scatter import (sweep_scatter_add,
                                              sweep_scatter_add_unsorted)
from graphvite_tpu_torch.ops import scatter

F32_RTOL = 1e-6


def _inputs(v, w, n, seed=0, hub=True, sentinels=0):
    rng = np.random.default_rng(seed)
    if hub:   # power-law ids: long runs on low ids (hub rows)
        ids = (rng.random(n) ** 3 * v).astype(np.int32)
    else:
        ids = rng.integers(0, v, n).astype(np.int32)
    if sentinels:
        # dead slots routed out of range (the steps' sentinel V), dropped
        ids[rng.choice(n, size=sentinels, replace=False)] = v
    upd = rng.normal(size=(n, w)).astype(np.float32)
    table = rng.normal(size=(v, w)).astype(np.float32)
    return table, ids, upd


def _assert_f32_close(got, want, table, ids, upd):
    v = table.shape[0]
    keep = (ids >= 0) & (ids < v)
    mag = np.abs(table).astype(np.float64)
    np.add.at(mag, ids[keep], np.abs(upd[keep]))
    err = np.abs(got.astype(np.float64) - np.asarray(want, np.float64))
    assert np.all(err <= F32_RTOL * mag), np.max(err / mag)


def _port(table, ids, upd, dtype=torch.float32):
    t = torch.as_tensor(table).to(dtype)
    out = scatter.scatter_add_(t, torch.as_tensor(ids), torch.as_tensor(upd))
    assert out is t  # in place
    return out.float().numpy()


def _bf16_round(x):
    return torch.as_tensor(x).to(torch.bfloat16).float().numpy()


def _f32_sum_rounded_once(table_bf16, ids, upd):
    """float64 sum of the bf16 table values and the in-range updates,
    rounded once to bfloat16."""
    v = table_bf16.shape[0]
    keep = (ids >= 0) & (ids < v)
    acc = table_bf16.astype(np.float64)
    np.add.at(acc, ids[keep], upd[keep].astype(np.float64))
    return _bf16_round(acc.astype(np.float32))


def _assert_within_one_bf16_ulp(got, want):
    # bf16 keeps 8 significant bits: one ulp is 2^(e-7) for |x| in [2^e, 2^(e+1))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= ulp), np.max(np.abs(got - want) / ulp)


@pytest.mark.parametrize("v,w,n,hub", [
    (1024, 128, 2048, True),    # hub runs across many rows
    (700, 16, 512, True),       # narrow rows
    (300, 10, 640, False),      # ragged width (not a multiple of 4)
])
def test_matches_sweep_scatter_add(v, w, n, hub):
    """Sorted, in-range ids (the sweep's contract)."""
    table, ids, upd = _inputs(v, w, n, hub=hub)
    order = np.argsort(ids, kind="stable")
    sid, supd = ids[order], upd[order]
    want = sweep_scatter_add(jnp.asarray(table), jnp.asarray(sid),
                             jnp.asarray(supd), tile_rows=256, chunk=128,
                             interpret=True)
    _assert_f32_close(_port(table, ids, upd), want, table, ids, upd)


@pytest.mark.parametrize("n", [1000, 333])
def test_matches_sweep_scatter_add_unsorted(n):
    """Unsorted ids with a count that is not a chunk multiple (the TPU
    front end pads with zero rows at id V-1)."""
    table, ids, upd = _inputs(512, 16, n, seed=1)
    want = sweep_scatter_add_unsorted(jnp.asarray(table), jnp.asarray(ids),
                                      jnp.asarray(upd), tile_rows=256,
                                      chunk=128, interpret=True)
    _assert_f32_close(_port(table, ids, upd), want, table, ids, upd)


@pytest.mark.parametrize("w,sentinels", [(16, 37), (10, 5), (16, 0)])
def test_matches_xla_scatter_drop(w, sentinels):
    table, ids, upd = _inputs(400, w, 900, seed=2, sentinels=sentinels)
    want = jnp.asarray(table).at[jnp.asarray(ids)].add(jnp.asarray(upd),
                                                       mode="drop")
    _assert_f32_close(_port(table, ids, upd), want, table, ids, upd)


def test_int64_ids_and_out_of_int32_range_drop():
    table, ids, upd = _inputs(300, 16, 400, seed=3, sentinels=20)
    ids64 = ids.astype(np.int64)
    ids64[:3] = [2 ** 31 - 1, 2 ** 40, -(2 ** 35)]   # all dropped
    keep = (ids64 >= 0) & (ids64 < 300)
    want = jnp.asarray(table).at[jnp.asarray(ids64[keep].astype(np.int32))].add(
        jnp.asarray(upd[keep]))
    _assert_f32_close(_port(table, ids64, upd), want, table, ids64, upd)


def test_negative_ids_drop():
    """The port drops ids < 0 (XLA's scatter would wrap them to V + id;
    the steps never produce them)."""
    table, ids, upd = _inputs(200, 16, 500, seed=7, sentinels=9)
    ids[::7] = -1 - ids[::7]
    keep = (ids >= 0) & (ids < 200)
    want = table.astype(np.float64)
    np.add.at(want, ids[keep], upd[keep])
    _assert_f32_close(_port(table, ids, upd), want, table, ids, upd)


def test_empty_update_is_a_no_op():
    table, _, _ = _inputs(50, 16, 1)
    got = _port(table, np.zeros(0, np.int32), np.zeros((0, 16), np.float32))
    np.testing.assert_array_equal(got, table)


@pytest.mark.parametrize("w,sentinels", [(16, 11), (10, 0)])
def test_bf16_table_rounds_once(w, sentinels):
    table, ids, upd = _inputs(600, w, 1500, seed=4, sentinels=sentinels)
    table_bf16 = _bf16_round(table)
    want = _f32_sum_rounded_once(table_bf16, ids, upd)
    got = _port(table_bf16, ids, upd, dtype=torch.bfloat16)
    _assert_within_one_bf16_ulp(got, want)


def test_bf16_matches_sweep_scatter_add():
    """The TPU sweep also accumulates in float32 and rounds once."""
    table, ids, upd = _inputs(512, 16, 1024, seed=5)
    table_bf16 = _bf16_round(table)
    order = np.argsort(ids, kind="stable")
    want = sweep_scatter_add(
        jnp.asarray(table_bf16).astype(jnp.bfloat16), jnp.asarray(ids[order]),
        jnp.asarray(upd[order]), tile_rows=256, chunk=128, interpret=True)
    got = _port(table_bf16, ids, upd, dtype=torch.bfloat16)
    _assert_within_one_bf16_ulp(got, np.asarray(want, np.float32))


def test_rejects_bad_inputs():
    t = torch.zeros(10, 4)
    with pytest.raises(ValueError):
        scatter.scatter_add_(t, torch.zeros(3, dtype=torch.long),
                             torch.zeros(3, 5))
    with pytest.raises(TypeError):
        scatter.scatter_add_(t.double(), torch.zeros(3, dtype=torch.long),
                             torch.zeros(3, 4))
    with pytest.raises(TypeError):
        scatter.scatter_add_(t, torch.zeros(3), torch.zeros(3, 4))


def test_cpu_path_does_not_count_launches():
    before = scatter.scatter_add_.launches
    table, ids, upd = _inputs(64, 8, 32)
    _port(table, ids, upd)
    assert scatter.scatter_add_.launches == before

