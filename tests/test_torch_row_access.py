"""The port's row-access kernels (graphvite_tpu_torch/ops/row_access.py) and
their bench (graphvite_tpu_torch/tools/row_access_bench.py) against the
reference's own experiments, tools/pallas_bench.py, on the CPU.

The reference tool is loaded from its file under a private module name
with PB_V, PB_D and PB_N set (it reads them when it is imported), and its
`pl` is pointed at a namespace whose pallas_call runs in Pallas's TPU
interpret mode; nothing under tools/ changes. On the CPU the port's
wrappers run their plain versions, which the card's kernels are held to
bit for bit (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances: gather and RMW bit-equal on the rows the reference writes;
the sweep bit-equal where a tile's ids are unique (each row one add), and
within 1e-6 of the largest magnitude where ids repeat (the reference adds
a run's updates to the row one by one, the port sums the run first, then
adds it once). Cases the reference leaves out (the last N % chunk rows of
the gather and the RMW, the rows of a partial last sweep tile, pad rows
that push a tile past the reference's slab) are held to plain indexing
and table.index_add_."""
import functools
import importlib.util
import json
import os
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from graphvite_tpu_torch.ops import row_access
from graphvite_tpu_torch.tools import row_access_bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_tool(monkeypatch, v, d, n):
    """tools/pallas_bench.py at shape (V, D, N), its kernels interpreted."""
    monkeypatch.setenv("PB_V", str(v))
    monkeypatch.setenv("PB_D", str(d))
    monkeypatch.setenv("PB_N", str(n))
    spec = importlib.util.spec_from_file_location(
        "_reference_pallas_bench", os.path.join(REPO, "tools",
                                                "pallas_bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    interp = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl)
                                      if not k.startswith("__")})
    interp.pallas_call = functools.partial(
        pl.pallas_call, interpret=pltpu.InterpretParams())
    mod.pl = interp
    assert (mod.V, mod.D, mod.N) == (v, d, n)
    return mod


def _table(v, d, seed=0):
    return np.random.default_rng(seed).normal(size=(v, d)).astype(np.float32)


def _unique_ids(n, v, seed=1):
    """The reference experiment's unique ids: 3 i + jitter (< 3), mod V."""
    jitter = np.random.default_rng(seed).integers(0, 3, n)
    return ((np.arange(n) * 3 + jitter) % v).astype(np.int32)


# ---------------------------------------------------------------------------
# gather and read-modify-write
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,chunk,depth", [(1024, 512, 8), (1000, 512, 16)])
def test_gather_matches_reference(n, chunk, depth, monkeypatch):
    """Bit-equal on the N // chunk * chunk rows the reference gathers; the
    port also gathers the N % chunk rows its grid leaves out."""
    v, d = 4096, 128
    ref = _reference_tool(monkeypatch, v, d, n)
    table = _table(v, d)
    ids = np.random.default_rng(2).integers(0, v, n).astype(np.int32)
    got = np.asarray(ref.make_pallas_gather(chunk, depth)(
        jnp.asarray(table), jnp.asarray(ids)))
    port = row_access.gather_rows(torch.from_numpy(table),
                                  torch.from_numpy(ids)).numpy()
    covered = n // chunk * chunk
    np.testing.assert_array_equal(port[:covered], got[:covered])
    np.testing.assert_array_equal(port, table[ids])
    if covered < n:
        assert not np.array_equal(got, table[ids])


@pytest.mark.parametrize("n,chunk,depth", [(1024, 512, 8), (1000, 512, 8)])
def test_rmw_matches_reference(n, chunk, depth, monkeypatch):
    """Bit-equal on the rows of the N // chunk * chunk updates the
    reference applies (one add a row); the port applies all N."""
    v, d = 4096, 128
    ref = _reference_tool(monkeypatch, v, d, n)
    table = _table(v, d)
    ids = _unique_ids(n, v)
    upd = np.random.default_rng(3).normal(size=(n, d)).astype(np.float32)
    got = np.asarray(ref.make_pallas_rmw(chunk, depth)(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(upd)))
    port = row_access.rmw_rows_(torch.from_numpy(table.copy()),
                                torch.from_numpy(ids), torch.from_numpy(upd),
                                check_unique=True).numpy()
    covered = n // chunk * chunk
    want = table.copy()
    want[ids] += upd
    np.testing.assert_array_equal(port, want)
    np.testing.assert_array_equal(port[ids[:covered]], got[ids[:covered]])
    if covered < n:
        np.testing.assert_array_equal(got[ids[covered:]],
                                      table[ids[covered:]])


# ---------------------------------------------------------------------------
# the tile sweep
# ---------------------------------------------------------------------------

def _sweep_layout(unique, seed=4):
    """4 tiles of 1024 rows with exactly 256 sorted updates each: the layout
    under which the reference's 256-row slab stays in bounds."""
    rng = np.random.default_rng(seed)
    ids = np.concatenate([
        t * 1024 + np.sort(rng.choice(1024, 256, replace=False) if unique
                           else rng.integers(0, 1024, 256))
        for t in range(4)]).astype(np.int32)
    upd = rng.normal(size=(ids.size, 128)).astype(np.float32)
    return ids, upd


@pytest.mark.parametrize("unique", [True, False])
def test_sweep_matches_reference(unique, monkeypatch):
    v, d, n = 4096, 128, 1024
    ref = _reference_tool(monkeypatch, v, d, n)
    table = _table(v, d)
    ids, upd = _sweep_layout(unique)
    got = np.asarray(ref.make_pallas_sweep(1024, 256)(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(upd)))
    port = row_access.sweep_add_sorted_(
        torch.from_numpy(table.copy()), torch.from_numpy(ids),
        torch.from_numpy(upd)).numpy()
    if unique:
        np.testing.assert_array_equal(port, got)
    else:
        assert len(np.unique(ids)) < ids.size
        scale = np.abs(got).max()
        np.testing.assert_allclose(port, got, rtol=0, atol=1e-6 * scale)
    want = torch.from_numpy(table.copy()).index_add_(
        0, torch.from_numpy(ids).long(), torch.from_numpy(upd)).numpy()
    np.testing.assert_allclose(port, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_sweep_partial_last_tile(monkeypatch):
    """V = 4 x 1024 + 100: the reference's grid has V // tile = 4 tiles, so
    the last 100 rows have none (on the TPU their updates were dropped;
    interpreted here it does not even lower: its tiles do not cover the
    table). The port applies them: its plain version here, and on the card
    the kernel's partial last tile (tests/test_torch_cuda.py)."""
    v, d, n = 4196, 128, 1024
    ref = _reference_tool(monkeypatch, v, d, n)
    table = _table(v, d)
    ids, upd = _sweep_layout(True)
    ids[-20:] = np.arange(v - 20, v, dtype=np.int32)     # still ascending
    with pytest.raises(ValueError, match="doesn't match"):
        ref.make_pallas_sweep(1024, 256)(jnp.asarray(table),
                                         jnp.asarray(ids), jnp.asarray(upd))
    port = row_access.sweep_add_sorted_(
        torch.from_numpy(table.copy()), torch.from_numpy(ids),
        torch.from_numpy(upd)).numpy()
    want = table.copy()
    want[ids] += upd
    np.testing.assert_array_equal(port, want)


def test_sweep_slab_cap(monkeypatch):
    """The reference experiment's pad rows (zero updates at id V - 1) count
    into the last tile when V is a multiple of the tile, so its loop runs
    past the `cap` rows of its slab: interpreted, the read is out of
    bounds (on the TPU it was unchecked). The port has no slab: the pad
    rows add nothing."""
    v, d, n = 4096, 128, 1024
    ref = _reference_tool(monkeypatch, v, d, n)
    table = _table(v, d)
    ids, upd = _sweep_layout(True)
    ids = np.concatenate([ids, np.full(256, v - 1, np.int32)])
    upd = np.concatenate([upd, np.zeros((256, d), np.float32)])
    with pytest.raises(Exception, match="Out-of-bounds read"):
        np.asarray(ref.make_pallas_sweep(1024, 256)(
            jnp.asarray(table), jnp.asarray(ids), jnp.asarray(upd)))
    port = row_access.sweep_add_sorted_(
        torch.from_numpy(table.copy()), torch.from_numpy(ids),
        torch.from_numpy(upd)).numpy()
    want = table.copy()
    want[ids[:1024]] += upd[:1024]
    np.testing.assert_array_equal(port, want)


def test_sweep_pad_rows_and_repeats_against_index_add():
    """The reference experiment's pad rows (cap zero updates at id V - 1)
    and long runs of one id, any number in a tile, V not a multiple of the
    reference's tile: table.index_add_ within 1e-6 of the largest
    magnitude, and ids outside [0, V) dropped. The chunks are cut by
    position, dropped ones included, so the dropped head is one whole
    chunk: the live ids keep their parts and give the same bits."""
    rng = np.random.default_rng(5)
    v, d = 5000, 24
    ids = np.sort(np.concatenate([
        (rng.random(3000) ** 3 * v).astype(np.int64),
        np.full(700, 17), np.full(300, v - 1)]))
    upd = rng.normal(size=(ids.size, d)).astype(np.float32)
    upd[ids == v - 1] = 0.0
    table = torch.from_numpy(_table(v, d))
    want = table.clone().index_add_(0, torch.from_numpy(ids),
                                    torch.from_numpy(upd))
    got = row_access.sweep_add_sorted_(table.clone(), torch.from_numpy(ids),
                                       torch.from_numpy(upd))
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-6 * float(want.abs().max()))
    c = row_access.chunk_rows(d)
    head = np.repeat([-3, -1], [c - c // 2, c // 2])
    wide = np.concatenate([head, ids, [v, v + 9]])
    upd2 = np.concatenate([np.ones((c, d), np.float32), upd,
                           np.ones((2, d), np.float32)])
    again = row_access.sweep_add_sorted_(table.clone(),
                                         torch.from_numpy(wide),
                                         torch.from_numpy(upd2))
    torch.testing.assert_close(again, got, rtol=0, atol=0)


def test_chunk_rows():
    """The sweep's chunk follows the width alone: the largest of 256,
    128, 64, 32 positions whose rows (one pass of at most 128 columns)
    fit in one 32 KB stage."""
    got = {d: row_access.chunk_rows(d) for d in (1, 3, 20, 32, 64, 100,
                                                 128, 200, 2048)}
    assert got == {1: 256, 3: 256, 20: 256, 32: 256, 64: 128, 100: 64,
                   128: 64, 200: 64, 2048: 64}
    for d, c in got.items():
        assert c % 4 == 0 and c * min(d, 128) * 4 <= (
            row_access.SWEEP_STAGE_BYTES)


def _chunk_layout(layout, c, seed=6):
    """4 tiles of 1024 rows with exactly 384 sorted updates each (the
    reference's slab is 384 rows), N = 24 chunks of c = 64:
      long_run: tile 0 holds a run of 5 c + 3 positions of one id;
      inside_run: a run of 3 c from position c / 2, so chunks 1 and 2 lie
        wholly inside it;
      edge_runs: tiles 1-3 are runs of 4, so runs end on every chunk edge;
      dropped_tail: ids >= V after the 4 tiles (the reference has no tile
        for them)."""
    rng = np.random.default_rng(seed)
    tiles = [t * 1024 + np.sort(rng.integers(0, 1024, 384))
             for t in range(4)]
    if layout == "long_run":
        tiles[0] = np.sort(np.concatenate([np.full(5 * c + 3, 17),
                                           rng.integers(0, 1024,
                                                        384 - 5 * c - 3)]))
    elif layout == "inside_run":
        tiles[0] = np.concatenate([np.sort(rng.integers(0, 40, c // 2)),
                                   np.full(3 * c, 41),
                                   np.sort(rng.integers(42, 1024,
                                                        384 - 3 * c - c // 2))])
    elif layout == "edge_runs":
        tiles[1:] = [t * 1024 + np.repeat(np.sort(rng.choice(1024, 96,
                                                              replace=False)),
                                          4) for t in (1, 2, 3)]
    ids = np.concatenate(tiles)
    if layout == "dropped_tail":
        ids = np.concatenate([ids, [4096, 4096, 5000]])
    return ids.astype(np.int32)


@pytest.mark.parametrize("layout", ["long_run", "inside_run", "edge_runs",
                                    "dropped_tail"])
def test_sweep_chunks_against_reference(layout, monkeypatch):
    """The port's chunked order (parts summed per chunk, combined in chunk
    order) on runs that cross chunks, fill them, end on their edges, and
    on a dropped tail: within 1e-6 of the largest magnitude of the
    reference's interpreted sweep and of a float64 sum."""
    v, d = 4096, 128
    c = row_access.chunk_rows(d)
    ids = _chunk_layout(layout, c)
    n = ids.size
    if layout == "long_run":      # the run touches 6 or 7 chunks
        at = np.flatnonzero(ids == 17)
        assert at.size == 5 * c + 3 and at[-1] // c - at[0] // c >= 5
    if layout == "inside_run":
        assert (ids[c:3 * c] == 41).all() and ids[c - 1] == ids[3 * c] == 41
    if layout == "edge_runs":
        assert all(ids[k * c - 1] != ids[k * c] for k in range(7, 24))
    ref = _reference_tool(monkeypatch, v, d, n)
    table = _table(v, d)
    upd = np.random.default_rng(7).normal(size=(n, d)).astype(np.float32)
    kept = ids < v
    got = np.asarray(ref.make_pallas_sweep(1024, 384)(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(upd)))
    port = row_access.sweep_add_sorted_(
        torch.from_numpy(table.copy()), torch.from_numpy(ids),
        torch.from_numpy(upd)).numpy()
    want = table.astype(np.float64)
    np.add.at(want, ids[kept], upd[kept].astype(np.float64))
    scale = np.abs(want).max()
    np.testing.assert_allclose(port, got, rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(port, want, rtol=0, atol=1e-6 * scale)
    rows, counts = np.unique(ids[kept], return_counts=True)
    once = rows[counts == 1]          # one add each: bit-equal
    np.testing.assert_array_equal(port[once], got[once])


def test_sweep_same_bits_twice():
    """Two calls on the same inputs give the same bits: the order of the
    sums depends on the shape alone."""
    rng = np.random.default_rng(8)
    v, d = 3000, 20
    c = row_access.chunk_rows(d)
    ids = np.sort(np.concatenate([np.full(3 * c + 1, 5),
                                  rng.integers(0, v + 5, 2 * c)]))
    upd = torch.from_numpy(rng.normal(size=(ids.size, d)).astype(np.float32))
    table = torch.from_numpy(_table(v, d))
    a = row_access.sweep_add_sorted_(table.clone(), torch.from_numpy(ids),
                                     upd)
    b = row_access.sweep_add_sorted_(table.clone(), torch.from_numpy(ids),
                                     upd)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the wrappers' contract
# ---------------------------------------------------------------------------

def test_wrapper_contract():
    t = torch.zeros((10, 4))
    with pytest.raises(TypeError, match="float32"):
        row_access.gather_rows(t.double(), torch.tensor([1]))
    with pytest.raises(TypeError, match="float32"):
        row_access.rmw_rows_(t.bfloat16(), torch.tensor([1]),
                             torch.zeros((1, 4)))
    with pytest.raises(ValueError, match="unique"):
        row_access.rmw_rows_(t, torch.tensor([1, 2, 1]), torch.zeros((3, 4)),
                             check_unique=True)
    with pytest.raises(ValueError, match="ascending"):
        row_access.sweep_add_sorted_(t, torch.tensor([2, 1]),
                                     torch.zeros((2, 4)))
    with pytest.raises(ValueError, match="scratch"):   # before any launch
        row_access._launch_sweep(t, torch.tensor([1, 2]), torch.zeros((2, 4)),
                                 row_access.sweep_scratch(t, 1000))
    # out-of-range ids: the gather clamps, the RMW drops
    got = row_access.gather_rows(torch.arange(40.).reshape(10, 4),
                                 torch.tensor([-5, 3, 99]))
    assert got[:, 0].tolist() == [0.0, 12.0, 36.0]
    row_access.rmw_rows_(t, torch.tensor([-1, 4, 10]), torch.ones((3, 4)))
    assert t.sum().item() == 4.0 and t[4].tolist() == [1.0] * 4
    assert (row_access.gather_rows.launches == row_access.rmw_rows_.launches
            == row_access.sweep_add_sorted_.launches == 0)


# ---------------------------------------------------------------------------
# the bench on the CPU
# ---------------------------------------------------------------------------

def _bench(*args, env=None):
    env = dict(os.environ, PYTHONPATH=REPO, PB_V="3000", PB_D="16",
               PB_N="700", **(env or {}))
    return subprocess.run(
        [sys.executable, "-m", "graphvite_tpu_torch.tools.row_access_bench",
         "--device", "cpu", *args], capture_output=True, text=True, env=env,
        cwd=REPO, timeout=300)


def test_bench_prints_one_line_per_experiment():
    out = _bench()
    assert out.returncode == 0, out.stderr[-2000:]
    recs = [json.loads(line) for line in out.stdout.splitlines()]
    names = [r["experiment"] for r in recs]
    assert names == [
        "torch_gather", "cuda_gather", "torch_scatter", "cuda_rmw",
        "cuda_sweep", "kernel1_sorted_float32", "kernel1_presorted_float32",
        "kernel1_sorted_bfloat16", "kernel1_presorted_bfloat16",
        "sweep_verify", "kernel1_unsorted_float32",
        "kernel1_unsorted_bfloat16_bf16delta", "sweep_unsorted_verify"]
    for r in recs:
        assert r["device"] == "cpu" and "card" not in r
        if r["experiment"].endswith("verify"):
            assert r["ok"] and r["max_abs_err"] < 1e-3
        else:
            assert r["ms"] > 0 and r["ns_per_row"] > 0 and r["bound_ms"] > 0
    gather = recs[1]
    assert gather["bound_ms"] == pytest.approx(
        (2 * 700 * 16 * 4 + 4 * 700) / 3.35e12 * 1e3)


def test_bench_failures_exit_nonzero(monkeypatch):
    out = _bench("cuda_gather", "no_such_experiment")
    assert out.returncode != 0 and "no_such_experiment" in out.stderr
    assert out.stdout == ""

    def broken(b):
        raise RuntimeError("kernel failed")

    monkeypatch.setitem(row_access_bench.EXPERIMENTS, "cuda_rmw", broken)
    monkeypatch.setenv("PB_V", "300")
    monkeypatch.setenv("PB_D", "8")
    monkeypatch.setenv("PB_N", "50")
    with pytest.raises(RuntimeError, match="kernel failed"):
        row_access_bench.main(["--device", "cpu", "torch_gather", "cuda_rmw",
                               "cuda_sweep"])
