"""The port's sorted-row gather (ops/gather.py) against the TPU kernel it
replaces, `sweep_gather_sorted` (Pallas in interpret mode), at the shapes
of tests/test_pallas_scatter.py: dense hub runs, chunks spanning many
tiles, the ragged last rows, bfloat16 tables. A gather copies values, so
every comparison is exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphvite_tpu.ops.pallas_scatter import sweep_gather_sorted
from graphvite_tpu_torch.ops import gather


def _port(table, ids, dtype=torch.float32, out_dtype=None):
    out = gather.gather_sorted(torch.as_tensor(table).to(dtype),
                               torch.as_tensor(ids), out_dtype=out_dtype)
    return out.float().numpy()


@pytest.mark.parametrize("v,d,n,tile,chunk", [
    (4096, 128, 2048, 512, 256),
    (4000, 128, 1024, 256, 128),    # ragged last tile (4000 % 256 != 0)
    (1024, 64, 4096, 1024, 512),    # v == tile; hub dups
])
def test_matches_sweep_gather(v, d, n, tile, chunk):
    rng = np.random.default_rng(6)
    ids = np.sort((rng.random(n) ** 3 * v).astype(np.int32))
    table = rng.normal(size=(v, d)).astype(np.float32)
    want = sweep_gather_sorted(jnp.asarray(table), jnp.asarray(ids),
                               tile_rows=tile, chunk=chunk, interpret=True)
    np.testing.assert_array_equal(_port(table, ids), np.asarray(want))


def test_sparse_spans_and_last_rows():
    """Ids that skip many rows between neighbours and ids in the last rows
    of the table (the reference's clamped last-tile window)."""
    v, d = 8192, 32
    ids = np.asarray(sorted([0, 1, 511, 1024, 3000, 5000, 7000, 8191] * 16),
                     np.int32)
    table = np.arange(v * d, dtype=np.float32).reshape(v, d)
    want = sweep_gather_sorted(jnp.asarray(table), jnp.asarray(ids),
                               tile_rows=256, chunk=128, interpret=True)
    got = _port(table, ids)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, table[ids])


@pytest.mark.parametrize("out_dtype", [None, "float32"])
def test_bf16_table(out_dtype):
    """bfloat16 rows come out as bfloat16, or converted to float32 (what
    the edge step asks for); either way the values are the table's."""
    v, d, n = 2048, 128, 1024
    rng = np.random.default_rng(8)
    ids = np.sort(rng.integers(0, v, n).astype(np.int32))
    table = rng.normal(size=(v, d)).astype(np.float32)
    tb = jnp.asarray(table).astype(jnp.bfloat16)
    want = sweep_gather_sorted(tb, jnp.asarray(ids), tile_rows=512,
                               chunk=256, interpret=True,
                               out_dtype=out_dtype and jnp.float32)
    got = gather.gather_sorted(torch.as_tensor(table).bfloat16(),
                               torch.as_tensor(ids),
                               out_dtype=out_dtype and torch.float32)
    assert got.dtype == (torch.float32 if out_dtype else torch.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_out_of_range_ids_clamp():
    """Ids past either end clamp to the first or last row, as
    jnp.take(mode="clip") does; int64 ids beyond the int32 range too."""
    rng = np.random.default_rng(2)
    v, d = 300, 12
    table = rng.normal(size=(v, d)).astype(np.float32)
    ids = np.array([-5, -1, 0, 7, 299, 300, 1000, 2 ** 40], np.int64)
    want = jnp.take(jnp.asarray(table), jnp.asarray(ids.clip(-2 ** 31, 2 ** 31 - 1)
                                                     .astype(np.int32)),
                    axis=0, mode="clip")
    np.testing.assert_array_equal(_port(table, ids), np.asarray(want))


def test_rejects_bad_inputs_and_counts_no_cpu_launch():
    t = torch.zeros(10, 4)
    with pytest.raises(TypeError):
        gather.gather_sorted(t.double(), torch.zeros(3, dtype=torch.long))
    with pytest.raises(TypeError):
        gather.gather_sorted(t, torch.zeros(3))
    with pytest.raises(ValueError):
        gather.gather_sorted(t, torch.zeros(3, 1, dtype=torch.long))
    before = gather.gather_sorted.launches
    out = gather.gather_sorted(t, torch.arange(5))
    assert out.shape == (5, 4) and gather.gather_sorted.launches == before
