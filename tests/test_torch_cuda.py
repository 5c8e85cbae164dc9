"""Tests of the port that need an NVIDIA GPU (marked `cuda`; each skips
where torch sees no card), and three CPU tests of what they rest on: the
tile size rule, the plain scatter-add on the run layouts the kernels
are held to it on, and the horizon within which LargeVis Adam's replicas
can be held card against CPU. This file imports neither JAX nor the JAX package, so
it also runs on a host without them:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerances: scatter-add float32 results within rtol 1e-6 of the magnitude
of the terms summed (orders differ; the plain version's index_add_ uses
atomics, so its own order changes from launch to launch); bfloat16 within
that plus 1 bf16 ulp (both versions round one float32 sum once, but where
a row's terms nearly cancel, the two float32 sums lie many bf16 ulps of the
small result apart). The gather is exact. The moment
update within rtol 2e-5, atol 2e-5 (the CPU tests' tolerance against the
reference), plus 1 bf16 ulp for bfloat16 tables. The steps as the CPU
tests hold the port to the reference (loss rtol 2e-5; tables and moments
rtol 3e-4, atol 3e-6). The run layouts chosen against the tiles of the
segmented reduction (test_segmented_*) use values on a grid of 1/64, so
every order of a float32 sum gives the same bits: there the scatter-add
must equal its plain version exactly, in float32 and in bfloat16. The
pooled RotatE kernels (ops/rotate_pool.py) against their plain version:
float32 sums in another order, so logits within 2e-5 of the sum of the
moduli, E and B sums within 1e-5 of the sum of their terms' bound (|z| <=
gn, |z|^2 <= gn^2), and two calls the same bits; the whole step through
them within the CPU tests' tolerances."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import graphvite_tpu_torch.optim as optim_mod
from graphvite_tpu_torch.models import KG_MODELS
from graphvite_tpu_torch.ops import gather, rotate_pool, scatter, steps
from graphvite_tpu_torch.optim import Optimizer


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _bf16_ulp(x):
    e = torch.floor(torch.log2(torch.clamp(x.abs(), min=2.0 ** -126)))
    return torch.pow(2.0, e - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w", [256, 16, 10])
def test_kernel_matches_plain_version(dtype, w):
    dev = _cuda()
    rng = np.random.default_rng(6)
    v, n = 5000, 6000
    ids = (rng.random(n) ** 3 * v).astype(np.int64)   # hub runs
    ids[rng.choice(n, 50, replace=False)] = v         # dropped sentinels
    ids[:2] = -1
    ids = torch.as_tensor(ids, device=dev)
    upd = torch.as_tensor(rng.normal(size=(n, w)).astype(np.float32),
                          device=dev)
    table = torch.as_tensor(rng.normal(size=(v, w)).astype(np.float32),
                            device=dev).to(dtype)
    want = scatter.scatter_add_plain(table.clone(), ids, upd).float()
    before = scatter.scatter_add_.launches
    got = scatter.scatter_add_(table.clone(), ids, upd)
    torch.cuda.synchronize()
    assert scatter.scatter_add_.launches == before + 1
    err = (got.float() - want).abs()
    mag = scatter.scatter_add_plain(table.float().abs(), ids, upd.abs())
    if dtype == torch.float32:
        assert bool((err <= 1e-6 * mag).all())
    else:
        assert bool((err <= _bf16_ulp(want) + 1e-6 * mag).all())


@pytest.mark.cuda
def test_kernel_handles_empty_and_int32_ids():
    dev = _cuda()
    table = torch.zeros(100, 8, device=dev)
    scatter.scatter_add_(table, torch.zeros(0, dtype=torch.int32, device=dev),
                         torch.zeros(0, 8, device=dev))
    ids = torch.tensor([3, 3, 99, 100], dtype=torch.int32, device=dev)
    scatter.scatter_add_(table, ids, torch.ones(4, 8, device=dev))
    assert table[3].eq(2).all() and table[99].eq(1).all()
    assert float(table.sum()) == 24.0


@pytest.mark.cuda
def test_fused_step_on_card_matches_cpu():
    dev = _cuda()
    rng = np.random.default_rng(5)
    V, D, B, L1, aug, G, M = 3000, 16, 16, 11, 2, 4, 8
    vc = rng.normal(size=(V, 2 * D)).astype(np.float32) * 0.1
    chain = (rng.random((B, L1)) ** 2 * V).astype(np.int64)
    mask = (rng.random((B, L1, 2 * aug)) > 0.1).astype(np.float32)
    u1, u2 = rng.random((G, M), np.float32), rng.random((G, M), np.float32)
    packed = np.stack([np.ones(V, np.float32),
                       np.arange(V, dtype=np.float32)], axis=1)
    step = steps.make_graph_banded_fused_step(
        Optimizer(lr=0.025, weight_decay=5e-3), 1, 5.0, aug, True, M, G)
    out = []
    for d in (dev, torch.device("cpu")):
        t = lambda a: torch.as_tensor(a, device=d)
        table = t(vc.copy())
        with torch.no_grad():
            _, loss = step({"tables": (table,), "moments": ((),)}, t(chain),
                           t(chain), 0.025, t(packed), mask=t(mask),
                           draws=(t(u1), t(u2)))
        out.append((table.cpu().numpy(), float(loss)))
    (gpu, gl), (cpu, cl) = out
    np.testing.assert_allclose(gl, cl, rtol=2e-5)
    np.testing.assert_allclose(gpu, cpu, rtol=3e-4, atol=3e-6)


@pytest.mark.cuda
def test_sorted_entry_matches_plain_version():
    dev = _cuda()
    rng = np.random.default_rng(7)
    v, w, n = 5000, 128, 6000
    ids = np.sort((rng.random(n) ** 3 * v).astype(np.int64))
    ids[:2], ids[-3:] = -1, v                     # dropped at both ends
    ids = torch.as_tensor(ids, device=dev)
    upd = torch.randn(n, w, device=dev)
    table = torch.randn(v, w, device=dev)
    want = scatter.scatter_add_plain(table.clone(), ids, upd)
    before = scatter.scatter_add_sorted_.launches
    got = scatter.scatter_add_sorted_(table.clone(), ids, upd)
    torch.cuda.synchronize()
    assert scatter.scatter_add_sorted_.launches == before + 1
    mag = scatter.scatter_add_plain(table.abs(), ids, upd.abs())
    assert bool(((got - want).abs() <= 1e-6 * mag).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("w", [128, 10])
def test_gather_matches_plain_version(dtype, out_dtype, w):
    dev = _cuda()
    rng = np.random.default_rng(8)
    v, n = 5000, 7000
    ids = np.sort((rng.random(n) ** 3 * v).astype(np.int64))
    ids[:2], ids[-2:] = [-4, -1], [v, v + 9]      # clamped at both ends
    table = torch.randn(v, w, device=dev).to(dtype)
    for i in (torch.as_tensor(ids, device=dev),
              torch.as_tensor(ids, device=dev).to(torch.int32)):
        want = gather.gather_sorted_plain(table, i, out_dtype)
        before = gather.gather_sorted.launches
        got = gather.gather_sorted(table, i, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert gather.gather_sorted.launches == before + 1
        assert got.dtype == out_dtype and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("opt_type", ["Adam", "AdaGrad", "Momentum",
                                      "RMSprop"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sorted_entry", [True, False])
@pytest.mark.parametrize("w", [64, 10])
def test_scatter_update_matches_plain_version(opt_type, dtype, sorted_entry,
                                              w):
    dev = _cuda()
    rng = np.random.default_rng(9)
    v, n = 3000, 5000
    opt = Optimizer(type=opt_type, lr=0.01)
    ids = (rng.random(n) ** 3 * v).astype(np.int64)
    ids[rng.choice(n, 40, replace=False)] = v      # dropped
    if sorted_entry:
        ids = np.sort(ids)
    counts = rng.integers(0, 4, n).astype(np.float32)   # zeros: no touch

    def t(a):
        return torch.as_tensor(a, device=dev)

    ids, counts = t(ids), t(counts)
    grads = torch.randn(n, w, device=dev)
    sqs = torch.rand(n, w, device=dev)
    table = torch.randn(v, w, device=dev).to(dtype)
    moms = tuple(torch.rand(v, w, device=dev) * 1e-2
                 for _ in range(opt.num_moment))
    for c, q in ((counts, sqs), (None, None)):
        want_t, want_m = scatter.scatter_update_plain(
            table.clone(), tuple(m.clone() for m in moms), ids, grads, opt,
            0.01, c, q, lr_scale=0.5)
        fn = (scatter.scatter_update_sorted_ if sorted_entry
              else scatter.scatter_update_)
        before = fn.launches
        got_t, got_m = fn(table.clone(), tuple(m.clone() for m in moms), ids,
                          grads, opt, 0.01, entry_counts=c, entry_sqs=q,
                          lr_scale=0.5)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        err = (got_t.float() - want_t.float()).abs()
        tol = 2e-5 + 2e-5 * want_t.float().abs()
        if dtype == torch.bfloat16:
            tol = tol + _bf16_ulp(want_t.float())
        assert bool((err <= tol).all()), float(err.max())
        for a, b in zip(got_m, want_m):
            assert bool(((a - b).abs() <= 2e-5 + 2e-5 * b.abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("rule", ["SGD", "Adam"])
def test_pool_step_on_card_matches_cpu(rule):
    """The edge route's step with every sweep switch on: the three kernels
    on the card against the plain versions on the CPU."""
    dev = _cuda()
    rng = np.random.default_rng(10)
    V, D, B, G, M = 4000, 32, 2048, 8, 16
    heads = np.sort((rng.random(B) ** 2 * V).astype(np.int32))
    tails = (rng.random(B) ** 2 * V).astype(np.int32)
    mask = (rng.random(B) > 0.05).astype(np.float32)
    u1, u2 = rng.random((G, M), np.float32), rng.random((G, M), np.float32)
    packed = np.stack([np.ones(V, np.float32),
                       np.arange(V, dtype=np.float32)], axis=1)
    opt = Optimizer(type=rule, lr=0.025 if rule == "SGD" else 1e-3,
                    weight_decay=5e-3)
    tables = [rng.normal(0, 0.1, (V, D)).astype(np.float32)
              for _ in range(2)]
    moms = [[np.abs(rng.normal(0, 1e-3, (V, D))).astype(np.float32)
             for _ in range(opt.num_moment)] for _ in range(2)]
    step = steps.make_graph_pool_step(opt, 1, 5.0, M, G, sweep_vertex=True,
                                      sweep_context=True, sweep_gather=True)
    out = []
    for d in (dev, torch.device("cpu")):
        def t(a):
            return torch.as_tensor(np.array(a), device=d)
        state = {"tables": tuple(t(x) for x in tables),
                 "moments": tuple(tuple(t(m) for m in g) for g in moms)}
        with torch.no_grad():
            new, loss = step(state, t(heads), t(tails), opt.lr, t(packed),
                             mask=t(mask), draws=(t(u1), t(u2)))
        out.append(([x.cpu().numpy() for x in new["tables"]]
                    + [m.cpu().numpy() for g in new["moments"] for m in g],
                    float(loss)))
    (gpu, gl), (cpu, cl) = out
    np.testing.assert_allclose(gl, cl, rtol=2e-5)
    for a, b in zip(gpu, cpu):
        np.testing.assert_allclose(a, b, rtol=3e-4, atol=3e-6)


# ---------------------------------------------------------------------------
# kernels 1 and 2 on run layouts chosen against the tiles of the segmented
# reduction (csrc/segmented.cuh)
# ---------------------------------------------------------------------------

R = 8   # scatter.tile_rows at these small sizes
LAYOUTS = ("distinct", "all_equal", "tile_edges", "long_runs",
           "dropped_ends", "one_tile_runs")


def _layout_ids(layout, v):
    """Ascending ids (dropped ones where they sort to) for one layout."""
    if layout == "distinct":
        return np.arange(1000) * 3
    if layout == "all_equal":
        return np.full(50000, 7)
    runs = {
        # runs that end on, one before and one after a tile's edge, from
        # starts on, one after and one before an edge
        "tile_edges": [R, R - 1, R + 1, 1, R - 1, R, 2, R + 1, R - 2, R,
                       2 * R, 1, 2 * R - 1, 2 * R + 1],
        # runs over three and more tiles, whole tiles in their middle
        "long_runs": [3 * R, 1, 3 * R, R - 1, 4 * R + 2, 5 * R, 3, 7 * R + 1],
        "dropped_ends": [5, R, 3, 2 * R + 3, 1, 1, R],
        # every tile is one run, and neighbours differ
        "one_tile_runs": [R] * 9,
    }[layout]
    ids = np.repeat(np.arange(len(runs)) * 5 + 2, runs)
    if layout == "dropped_ends":
        ids = np.concatenate([np.full(R + 3, -1), [-9], ids,
                              np.full(2 * R + 1, v), [v + 5]])
        ids.sort()
    return ids


def _grid(rng, shape, lo, hi):
    """float32 multiples of 1/64 in [lo, hi): sums of them are exact."""
    return (rng.integers(lo * 64, hi * 64, shape) / 64.0).astype(np.float32)


def _segmented_case(dev, layout, w, sorted_entry, n=None):
    rng = np.random.default_rng(11)
    v = 4000
    if n is None:
        ids = _layout_ids(layout, v)
    else:               # hub runs over exactly n entries
        ids = np.sort((rng.random(n) ** 3 * 6).astype(np.int64))
    if not sorted_entry:
        ids = ids[rng.permutation(ids.size)]
    n = ids.size
    return (v, torch.as_tensor(ids.astype(np.int64), device=dev),
            torch.as_tensor(_grid(rng, (n, w), -2, 2), device=dev),
            torch.as_tensor(_grid(rng, (v, w), -4, 4), device=dev), rng)


def _check_segmented_add(dev, layout, w, dtype, sorted_entry, n=None):
    v, ids, upd, table, _ = _segmented_case(dev, layout, w, sorted_entry, n)
    table = table.to(dtype)
    if ids.numel() < 40000:
        assert scatter.tile_rows(ids.numel(), w) == R
    fn = scatter.scatter_add_sorted_ if sorted_entry else scatter.scatter_add_
    want = scatter.scatter_add_plain(table.clone(), ids, upd)
    for i in (ids, ids.to(torch.int32)):
        got = fn(table.clone(), i, upd)
        again = fn(table.clone(), i, upd)
        _sync(dev)
        assert torch.equal(got, want), float((got.float() - want.float())
                                             .abs().max())
        assert torch.equal(got, again)


def _check_segmented_update(dev, layout, w, dtype, sorted_entry, n=None,
                            delta_ulp=False):
    """`delta_ulp`: bfloat16 tables get one more bf16 ulp, of the row's old
    value: the plain version rounds the delta to bf16 before it subtracts
    (as the reference's route does), the kernel rounds the result once, so
    where an update nearly cancels its row the two lie an ulp of the
    larger operand apart."""
    v, ids, grads, table, rng = _segmented_case(dev, layout, w, sorted_entry, n)
    table = table.to(dtype)
    n = ids.numel()
    opt = Optimizer(type="Adam", lr=1e-3)
    sqs = torch.as_tensor(_grid(rng, (n, w), 0, 1), device=dev)
    counts = torch.as_tensor(rng.integers(0, 3, n).astype(np.float32),
                             device=dev)
    # whole runs of count 0 (the front ends' pads): ids 2 mod 10
    counts[(ids % 10 == 2) & (ids < v)] = 0.0
    moms = tuple(torch.as_tensor(_grid(rng, (v, w), 0, 1), device=dev) * 1e-2
                 for _ in range(2))
    fn = (scatter.scatter_update_sorted_ if sorted_entry
          else scatter.scatter_update_)
    for c, q in ((counts, sqs), (None, None)):
        want_t, want_m = scatter.scatter_update_plain(
            table.clone(), tuple(m.clone() for m in moms), ids, grads, opt,
            1e-3, c, q)
        got = [fn(table.clone(), tuple(m.clone() for m in moms), ids, grads,
                  opt, 1e-3, entry_counts=c, entry_sqs=q) for _ in range(2)]
        _sync(dev)
        (got_t, got_m), (again_t, again_m) = got
        assert torch.equal(got_t, again_t)
        assert all(torch.equal(a, b) for a, b in zip(got_m, again_m))
        err = (got_t.float() - want_t.float()).abs()
        tol = 2e-5 + 2e-5 * want_t.float().abs()
        if dtype == torch.bfloat16:
            tol = tol + _bf16_ulp(want_t.float())
            if delta_ulp:
                tol = tol + _bf16_ulp(table.float())
        assert bool((err <= tol).all()), float(err.max())
        for a, b in zip(got_m, want_m):
            assert bool(((a - b).abs() <= 2e-5 + 2e-5 * b.abs()).all())
        if c is not None:
            # rows of zero-count runs keep their value and moments
            idle = torch.unique(ids[(ids % 10 == 2) & (ids < v)])
            assert torch.equal(got_t[idle], table[idle])
            assert all(torch.equal(a[idle], m[idle])
                       for a, m in zip(got_m, moms))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sorted_entry", [True, False])
@pytest.mark.parametrize("w", [256, 128, 10])
def test_segmented_add_on_run_layouts(layout, dtype, sorted_entry, w):
    _check_segmented_add(_cuda(), layout, w, dtype, sorted_entry)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sorted_entry", [True, False])
@pytest.mark.parametrize("w", [256, 128, 10])
def test_segmented_update_on_run_layouts(layout, dtype, sorted_entry, w):
    _check_segmented_update(_cuda(), layout, w, dtype, sorted_entry)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, R - 1, R, R + 1])
@pytest.mark.parametrize("sorted_entry", [True, False])
@pytest.mark.parametrize("w", [256, 10])
def test_segmented_sizes_around_one_tile(n, sorted_entry, w):
    dev = _cuda()
    _check_segmented_add(dev, None, w, torch.float32, sorted_entry, n=n)
    _check_segmented_update(dev, None, w, torch.float32, sorted_entry, n=n)


@pytest.mark.cuda
def test_tiles_of_16_and_32_rows():
    """Shapes large enough for the wider tiles: runs of every length up to
    four tiles, exact against the plain version."""
    dev = _cuda()
    rng = np.random.default_rng(12)
    for n, w, r in ((70000, 128, 32), (40000, 128, 16), (34000, 256, 32)):
        assert scatter.tile_rows(n, w) == r
        lengths = rng.integers(1, 4 * r + 2, n)
        ids = np.repeat(np.arange(n) * 2, lengths)[:n]
        v = int(ids.max()) + 1
        ids = torch.as_tensor(ids, device=dev)
        upd = torch.as_tensor(_grid(rng, (n, w), -2, 2), device=dev)
        table = torch.as_tensor(_grid(rng, (v, w), -4, 4), device=dev)
        want = scatter.scatter_add_plain(table.clone(), ids, upd)
        got = scatter.scatter_add_sorted_(table.clone(), ids, upd)
        perm = torch.randperm(n, device=dev)
        got_u = scatter.scatter_add_(table.clone(), ids[perm], upd[perm])
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(got_u, want)


# ---------------------------------------------------------------------------
# the knowledge-graph paths' widths: 4, 8 and 16 passes of 128 columns per
# tile, a table whose every row is a hub, and the KG steps card against CPU
# ---------------------------------------------------------------------------

WIDE = [512, 1024, 2048]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sorted_entry", [True, False])
@pytest.mark.parametrize("w", WIDE)
def test_segmented_add_on_run_layouts_wide(layout, dtype, sorted_entry, w):
    _check_segmented_add(_cuda(), layout, w, dtype, sorted_entry)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sorted_entry", [True, False])
@pytest.mark.parametrize("w", WIDE)
def test_segmented_update_on_run_layouts_wide(layout, dtype, sorted_entry, w):
    _check_segmented_update(_cuda(), layout, w, dtype, sorted_entry,
                            delta_ulp=True)


@pytest.mark.cuda
@pytest.mark.parametrize("n,w,r", [(20000, 512, 32), (9000, 512, 16),
                                   (5000, 2048, 32), (2500, 2048, 16),
                                   (3000, 1024, 8)])
def test_wide_tiles_of_8_16_and_32_rows(n, w, r):
    """Runs of every length up to four tiles at the tile sizes the wide
    shapes take, exact against the plain version on the 1/64 grid."""
    dev = _cuda()
    rng = np.random.default_rng(13)
    assert scatter.tile_rows(n, w) == r
    lengths = rng.integers(1, 4 * r + 2, n)
    ids = np.repeat(np.arange(n) * 2, lengths)[:n]
    v = int(ids.max()) + 1
    ids = torch.as_tensor(ids, device=dev)
    upd = torch.as_tensor(_grid(rng, (n, w), -2, 2), device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        table = torch.as_tensor(_grid(rng, (v, w), -4, 4),
                                device=dev).to(dtype)
        want = scatter.scatter_add_plain(table.clone(), ids, upd)
        got = scatter.scatter_add_sorted_(table.clone(), ids, upd)
        perm = torch.randperm(n, device=dev)
        got_u = scatter.scatter_add_(table.clone(), ids[perm], upd[perm])
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(got_u, want)


def _hub_ids(rng, n, v):
    """Every row of a v-row table a hub: Zipf-skewed ids, any order."""
    p = (np.arange(v) + 3.0) ** -0.9
    return rng.choice(v, n, p=p / p.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sorted_entry", [True, False])
def test_all_hub_table_add(dtype, sorted_entry):
    """The relation update's shape: 60,928 ids over 822 rows of 512 columns
    (runs of ~74 rows, each over 2-3 tiles of 32): exact on the grid."""
    dev = _cuda()
    rng = np.random.default_rng(14)
    n, v, w = 60928, 822, 512
    assert scatter.tile_rows(n, w) == 32
    ids = _hub_ids(rng, n, v)
    if sorted_entry:
        ids.sort()
    ids = torch.as_tensor(ids, device=dev)
    upd = torch.as_tensor(_grid(rng, (n, w), -2, 2), device=dev)
    table = torch.as_tensor(_grid(rng, (v, w), -4, 4), device=dev).to(dtype)
    fn = scatter.scatter_add_sorted_ if sorted_entry else scatter.scatter_add_
    want = scatter.scatter_add_plain(table.clone(), ids, upd)
    got = fn(table.clone(), ids, upd)
    again = fn(table.clone(), ids, upd)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sorted_entry", [True, False])
def test_all_hub_table_update(dtype, sorted_entry):
    """Kernel 2 (Adam) on the same all-hub shape, with the pooled step's
    K + 1 = 65 touches per entry."""
    dev = _cuda()
    rng = np.random.default_rng(15)
    n, v, w = 60928, 822, 512
    ids = _hub_ids(rng, n, v)
    if sorted_entry:
        ids.sort()
    ids = torch.as_tensor(ids, device=dev)
    grads = torch.as_tensor(_grid(rng, (n, w), -2, 2), device=dev) * 1e-2
    sqs = grads * grads * 1.5
    counts = torch.full((n,), 65.0, device=dev)
    table = torch.as_tensor(_grid(rng, (v, w), -4, 4), device=dev).to(dtype)
    moms = tuple(torch.as_tensor(_grid(rng, (v, w), 0, 1), device=dev) * 1e-2
                 for _ in range(2))
    opt = Optimizer(type="Adam", lr=1e-3)
    fn = (scatter.scatter_update_sorted_ if sorted_entry
          else scatter.scatter_update_)
    want_t, want_m = scatter.scatter_update_plain(
        table.clone(), tuple(m.clone() for m in moms), ids, grads, opt, 1e-3,
        counts, sqs, 0.5)
    got = [fn(table.clone(), tuple(m.clone() for m in moms), ids, grads, opt,
              1e-3, entry_counts=counts, entry_sqs=sqs, lr_scale=0.5)
           for _ in range(2)]
    torch.cuda.synchronize()
    (got_t, got_m), (again_t, again_m) = got
    assert torch.equal(got_t, again_t)
    assert all(torch.equal(a, b) for a, b in zip(got_m, again_m))
    err = (got_t.float() - want_t.float()).abs()
    tol = 2e-5 + 2e-5 * want_t.float().abs()
    if dtype == torch.bfloat16:
        # one ulp of the result and one of the row's old value (the plain
        # version rounds the delta to bf16 before it subtracts)
        tol = tol + _bf16_ulp(want_t.float()) + _bf16_ulp(table.float())
    assert bool((err <= tol).all()), float(err.max())
    for a, b in zip(got_m, want_m):
        assert bool(((a - b).abs() <= 2e-5 + 2e-5 * b.abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("rule", ["SGD", "Adam"])
@pytest.mark.parametrize("step_kind", ["classic", "pool_generic", "pool_fast"])
@pytest.mark.parametrize("big_table", [False, True])
def test_kg_step_on_card_matches_cpu(rule, step_kind, big_table, monkeypatch):
    """The KG steps on the card against the CPU from the same state,
    triplets and candidate ids, at width 512; `big_table` shrinks the
    dense-update size so that Adam's entity update takes kernel 2 (SGD
    takes kernel 1 either way). Tolerances of the CPU tests."""
    dev = _cuda()
    monkeypatch.setenv("GRAPHVITE_KG_FAST",
                       "1" if step_kind == "pool_fast" else "0")
    if big_table:
        monkeypatch.setattr(optim_mod, "DENSE_UPDATE_ELEMS", 1000)
    rng = np.random.default_rng(16)
    v, r, d, b, k, G, M = 3000, 40, 512, 256, 8, 4, 16
    opt = Optimizer(type=rule, lr=0.05 if rule == "SGD" else 1e-3,
                    weight_decay=0.0)
    model = KG_MODELS["RotatE"]
    if step_kind == "classic":
        step = steps.make_kg_train_step(model, opt, k, 6.0, 2.0, 0.5)
        negatives = (rng.integers(0, v, (b, k)), rng.random((b, k)) < 0.5)
    else:
        step = steps.make_kg_pool_step(model, opt, k, 6.0, 2.0, 0.5,
                                       pool_size=M, pool_groups=G)
        assert step.fast_rotate == (step_kind == "pool_fast")
        negatives = rng.integers(0, v, (G, M))
    heads, tails = rng.integers(0, v, b), rng.integers(0, v, b)
    heads[: b // 4] = 3                      # a hub
    rels = rng.integers(0, r, b)
    mask = (rng.random(b) > 0.2).astype(np.float32)
    ent = (rng.normal(size=(v, d)) * 0.3).astype(np.float32)
    rel = (rng.normal(size=(r, d)) * 0.3).astype(np.float32)
    moms = [[(np.abs(rng.normal(size=shape)) * 1e-2 + 1e-3)
             .astype(np.float32) for _ in range(opt.num_moment)]
            for shape in ((v, d), (r, d))]
    out = []
    for device in (dev, torch.device("cpu")):
        t = lambda x: torch.as_tensor(x, device=device)
        state = {"tables": (t(ent.copy()), t(rel.copy())),
                 "moments": tuple(tuple(t(m.copy()) for m in g)
                                  for g in moms)}
        neg = (tuple(t(x) for x in negatives) if step_kind == "classic"
               else t(negatives))
        before = (scatter.scatter_add_.launches
                  + scatter.scatter_update_.launches)
        pool_before = rotate_pool.pool_sums.launches
        with torch.no_grad():
            new, loss = step(state, t(heads), t(tails), t(rels), opt.lr,
                             mask=t(mask), negatives=neg)
        _sync(device)
        after = (scatter.scatter_add_.launches
                 + scatter.scatter_update_.launches)
        # the RotatE body's two kernels, once for all G groups, on the card
        pool_want = 2 if (step_kind == "pool_fast"
                          and device.type == "cuda") else 0
        assert rotate_pool.pool_sums.launches - pool_before == pool_want
        if device.type == "cuda":
            # SGD: both tables on kernel 1; Adam: kernel 2 where the table
            # is above the dense-update size
            want = 2 if rule == "SGD" else (2 if big_table else 0)
            assert after - before == want
        out.append(([x.cpu().numpy() for x in new["tables"]]
                    + [m.cpu().numpy() for g in new["moments"] for m in g],
                    float(loss)))
    (gpu, gl), (cpu, cl) = out
    np.testing.assert_allclose(gl, cl, rtol=2e-5)
    for a, b_ in zip(gpu, cpu):
        np.testing.assert_allclose(a, b_, rtol=3e-4, atol=3e-6)


def _pool_inputs(G, Bg, M, Dh, seed, dev):
    """Frames u, w [G, Bg, Dh] and candidates [G, M, Dh] as halves, and a
    mask [G, Bg] with ~20% of the samples off."""
    rng = np.random.default_rng(seed)

    def f(*shape):
        return torch.as_tensor((rng.normal(size=shape) * 0.3)
                               .astype(np.float32), device=dev)
    x = [f(G, Bg, Dh) for _ in range(4)] + [f(G, M, Dh) for _ in range(2)]
    mask = torch.as_tensor((rng.random((G, Bg)) > 0.2).astype(np.float32),
                           device=dev)
    return x, mask


def _adversarial_outs(mask, M, seen, fixed=None):
    """The pooled step's negative_outs (temperature 2), recording the
    logits it gets; with `fixed` it returns those outputs instead, so both
    versions sum the same gn."""
    def outs(logits):
        seen.append(logits)
        if fixed is not None:
            return fixed
        w = steps._adversarial_weights(logits, 2.0, 1.0 / M)
        if mask is not None:
            w = w * mask[..., None]
        return (w, (w * F.softplus(logits)).sum(dim=-1),
                torch.sigmoid(logits) * w)
    return outs


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("G,Bg,M,Dh,need_sq", [
    (4, 476, 128, 256, False),    # rotate_wikidata5m.yaml's groups, SGD
    (2, 464, 128, 1024, True),    # rotate_fb15k.yaml's, Adam's squares
    (3, 37, 26, 19, True),        # ragged: Bg, M/2 13, odd Dh
    (2, 50, 160, 36, False),      # two candidate slices, ragged chunks
])
def test_rotate_pool_kernels_match_plain_version(G, Bg, M, Dh, need_sq,
                                                 masked):
    dev = _cuda()
    x, mask = _pool_inputs(G, Bg, M, Dh, 17, dev)
    mask = mask if masked else None
    seen_p = []
    loss_p, sh_p, st_p = rotate_pool.pool_sums_plain(
        *x, 6.0, _adversarial_outs(mask, M, seen_p), need_sq)
    fixed = _adversarial_outs(mask, M, [])(seen_p[0])
    gn = fixed[2]
    runs = []
    for _ in range(2):
        seen = []
        before = rotate_pool.pool_sums.launches
        out = rotate_pool.pool_sums(*x, 6.0,
                                    _adversarial_outs(mask, M, seen, fixed),
                                    need_sq)
        torch.cuda.synchronize()
        assert rotate_pool.pool_sums.launches - before == 2
        runs.append((seen[0],) + out)
    # two calls on the same inputs: the same bits
    (lg, loss, sh, st), (lg2, _, sh2, st2) = runs
    assert torch.equal(lg, lg2)
    for a, b in ((sh, sh2), (st, st2)):
        assert all(torch.equal(a[key], b[key]) for key in a)
    # logits: margin - a sum of Dh moduli
    lg_p = seen_p[0]
    err = (lg - lg_p).abs()
    assert bool((err <= 2e-5 * (6.0 - lg_p).abs() + 1e-6).all()), \
        float(err.max())
    assert torch.equal(loss, loss_p)          # `fixed` outputs
    M2 = M // 2
    for side, (got, want) in enumerate(((sh, sh_p), (st, st_p))):
        g_side = gn[..., side * M2:(side + 1) * M2]
        bound = {"E": g_side.sum(dim=2)[..., None],          # over cands
                 "S": (g_side * g_side).sum(dim=2)[..., None],
                 "B": g_side.sum(dim=1)[..., None],           # over samples
                 "B2": (g_side * g_side).sum(dim=1)[..., None]}
        assert sorted(got) == sorted(want)
        for key in want:
            kind = "B2" if key in ("B_rr", "B_ii") else key[0]
            err = (got[key] - want[key]).abs()
            assert got[key].shape == want[key].shape, key
            assert bool((err <= 1e-5 * bound[kind] + 1e-12).all()), \
                (side, key, float(err.max()))


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("rule", ["SGD", "Adam"])
def test_fast_rotate_step_kernels_match_plain_body_on_card(rule, masked,
                                                           monkeypatch):
    """The whole pooled RotatE step on the card through the kernels
    against the same step with the plain body on the card, from the same
    state, triplets and candidates (Bg 60, M 40, D 72: ragged tiles).
    Tolerances of the CPU tests. The kernel step twice gives the same bits
    on SGD (kernel 1 updates both tables); Adam's small tables take the
    dense moment route, whose index_add_ sums in no fixed order."""
    dev = _cuda()
    monkeypatch.delenv("GRAPHVITE_KG_FAST", raising=False)
    rng = np.random.default_rng(23)
    v, r, d, b, k, G, M = 2000, 30, 72, 240, 8, 4, 40
    opt = Optimizer(type=rule, lr=0.05 if rule == "SGD" else 1e-3,
                    weight_decay=0.0)
    step = steps.make_kg_pool_step(KG_MODELS["RotatE"], opt, k, 6.0, 2.0,
                                   0.5, pool_size=M, pool_groups=G)
    assert step.fast_rotate
    t = lambda a: torch.as_tensor(a, device=dev)
    heads, tails = t(rng.integers(0, v, b)), t(rng.integers(0, v, b))
    rels, cand = t(rng.integers(0, r, b)), t(rng.integers(0, v, (G, M)))
    mask = t((rng.random(b) > 0.2).astype(np.float32)) if masked else None
    ent = (rng.normal(size=(v, d)) * 0.3).astype(np.float32)
    rel = (rng.normal(size=(r, d)) * 0.3).astype(np.float32)
    moms = [[(np.abs(rng.normal(size=(n, d))) * 1e-2 + 1e-3)
             .astype(np.float32) for _ in range(opt.num_moment)]
            for n in (v, r)]

    def run():
        state = {"tables": (t(ent.copy()), t(rel.copy())),
                 "moments": tuple(tuple(t(m.copy()) for m in g)
                                  for g in moms)}
        with torch.no_grad():
            new, loss = step(state, heads, tails, rels, opt.lr, mask=mask,
                             negatives=cand)
        torch.cuda.synchronize()
        return ([x.cpu().numpy() for x in new["tables"]]
                + [m.cpu().numpy() for g in new["moments"] for m in g],
                float(loss))

    before = rotate_pool.pool_sums.launches
    kern, kern2 = run(), run()
    assert rotate_pool.pool_sums.launches - before == 4
    if rule == "SGD":
        assert kern[1] == kern2[1]
        assert all(np.array_equal(a, b_) for a, b_ in zip(kern[0], kern2[0]))
    monkeypatch.setattr(rotate_pool, "pool_sums",
                        rotate_pool.pool_sums_plain)
    plain = run()
    np.testing.assert_allclose(kern[1], plain[1], rtol=2e-5)
    for a, b_ in zip(kern[0], plain[0]):
        np.testing.assert_allclose(a, b_, rtol=3e-4, atol=3e-6)


@pytest.mark.parametrize("n,w,r", [
    (138240, 512, 32),    # the Wikidata5m-shaped entity update
    (60928, 512, 32),     # its relation update
    (16896, 2048, 32),    # the FB15k-shaped micro-step's ids
    (99328, 128, 32),     # the edge route's heads
    (107520, 128, 32),    # its context side
    (11968, 256, 8),      # DeepWalk, batch 100000
    (27712, 256, 16),     # DeepWalk, batch 250000
    (50000, 10, 16), (1, 128, 8), (0, 128, 8)])
def test_tile_rows_follow_the_shape(n, w, r):
    assert scatter.tile_rows(n, w) == r
    passes = -(-w // 128)
    # the largest tile that still gives the warps wanted, or the smallest
    assert r == 8 or -(-n // r) * passes >= scatter._WARPS_WANTED
    assert r == 32 or -(-n // (2 * r)) * passes < scatter._WARPS_WANTED


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("sorted_entry", [True, False])
def test_plain_scatter_add_on_run_layouts(layout, sorted_entry):
    """The plain version (what the card tests hold the kernel to) against
    a numpy loop on the same layouts; exact, the values being on a grid."""
    dev = torch.device("cpu")
    v, ids, upd, table, _ = _segmented_case(dev, layout, 10, sorted_entry)
    want = table.numpy().astype(np.float64)
    keep = ((ids >= 0) & (ids < v)).numpy()
    np.add.at(want, ids.numpy()[keep], upd.numpy()[keep].astype(np.float64))
    fn = scatter.scatter_add_sorted_ if sorted_entry else scatter.scatter_add_
    got = fn(table.clone(), ids, upd)
    np.testing.assert_array_equal(got.numpy().astype(np.float64), want)


# ---------------------------------------------------------------------------
# the LargeVis path: kernels 1 and 2 at 8 and 16 columns (one 128-column
# pass per warp, mostly idle lanes), the KNN search and the vis pool step,
# card against CPU
# ---------------------------------------------------------------------------

NARROW = [8, 16]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sorted_entry", [True, False])
@pytest.mark.parametrize("w", NARROW)
def test_segmented_add_on_run_layouts_narrow(layout, dtype, sorted_entry, w):
    _check_segmented_add(_cuda(), layout, w, dtype, sorted_entry)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sorted_entry", [True, False])
@pytest.mark.parametrize("w", NARROW)
def test_segmented_update_on_run_layouts_narrow(layout, dtype, sorted_entry,
                                                w):
    _check_segmented_update(_cuda(), layout, w, dtype, sorted_entry,
                            delta_ulp=True)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [R + 1, 5000, 60000])
@pytest.mark.parametrize("sorted_entry", [True, False])
@pytest.mark.parametrize("w", NARROW)
def test_narrow_hub_runs(n, sorted_entry, w):
    """Hub-skewed ids (a few rows take most entries) at 8 and 16 columns,
    exact on the grid and bit for bit on a second launch."""
    dev = _cuda()
    _check_segmented_add(dev, None, w, torch.float32, sorted_entry, n=n)
    _check_segmented_update(dev, None, w, torch.float32, sorted_entry, n=n)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vis_batch_shape_add(dtype):
    """The vis SGD update's shape: 2 x 99,840 heads and tails plus 64 x 256
    pool rows = 216,064 unsorted ids over a 70,000 x 8 accumulator (tiles
    of 32 rows)."""
    dev = _cuda()
    rng = np.random.default_rng(17)
    n, v, w = 216064, 70000, 8
    assert scatter.tile_rows(n, w) == 32
    ids = torch.as_tensor(_hub_ids(rng, n, v), device=dev)
    upd = torch.as_tensor(_grid(rng, (n, w), -2, 2), device=dev)
    table = torch.as_tensor(_grid(rng, (v, w), -4, 4), device=dev).to(dtype)
    want = scatter.scatter_add_plain(table.clone(), ids, upd)
    got = scatter.scatter_add_(table.clone(), ids, upd)
    again = scatter.scatter_add_(table.clone(), ids, upd)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got, again)


@pytest.mark.cuda
def test_exact_knn_on_card_matches_cpu():
    from graphvite_tpu_torch import knn

    dev = _cuda()
    rng = np.random.default_rng(18)
    x = rng.standard_normal((3000, 64)).astype(np.float32)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        dg, lg = knn.exact_knn(x, 30, row_chunk=700, device=dev)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    dc, lc = knn.exact_knn(x, 30, device="cpu")
    assert dg.device.type == "cuda"
    dg, lg = dg.cpu().numpy(), lg.cpu().numpy()
    dc, lc = dc.numpy(), lc.numpy()
    np.testing.assert_allclose(dg[:, 1:], dc[:, 1:], rtol=1e-4)
    assert (lg[:, 0] == np.arange(3000)).all()
    # labels wherever the neighbour's gap to both sides is over 1e-4
    gap = np.minimum(np.diff(dc, axis=1)[:, :-1], np.diff(dc, axis=1)[:, 1:])
    clear = gap > 1e-4 * dc[:, 1:-1]
    assert clear.mean() > 0.9
    assert np.array_equal(lg[:, 1:-1][clear], lc[:, 1:-1][clear])


@pytest.mark.cuda
def test_ivf_knn_on_card_matches_cpu():
    """bfloat16 rows with float32 products (cuBLAS with a float32 output on
    the card): the same neighbours as the CPU's float32 products of the
    same rows, but for near ties."""
    from graphvite_tpu_torch import knn

    dev = _cuda()
    rng = np.random.default_rng(19)
    centers = rng.standard_normal((24, 48)).astype(np.float32) * 5
    x = (centers[rng.integers(0, 24, 8000)]
         + rng.standard_normal((8000, 48)).astype(np.float32))
    kw = dict(nlist=64, nprobe=8, sample=4096, seed=0)
    a = torch.as_tensor(x[:64], device=dev).bfloat16()
    b = torch.as_tensor(x[64:160], device=dev).bfloat16()
    np.testing.assert_allclose(knn._mm_f32(a, b.T).cpu().numpy(),
                               (a.float() @ b.float().T).cpu().numpy(),
                               rtol=1e-5, atol=1e-3)
    dg, lg = knn.ivf_knn(x, 10, device=dev, **kw)
    dc, lc = knn.ivf_knn(x, 10, device="cpu", **kw)
    lg, lc = lg.cpu().numpy(), lc.numpy()
    overlap = np.mean([len(set(p) & set(q)) / len(set(q))
                       for p, q in zip(lg.tolist(), lc.tolist())])
    assert overlap >= 0.98
    np.testing.assert_allclose(np.sort(dg.cpu().numpy(), axis=1),
                               np.sort(dc.numpy(), axis=1), rtol=1e-3,
                               atol=1e-3)
    rg = knn.knn_recall(x, lg, nq=300, device=dev)
    rc = knn.knn_recall(x, lc, nq=300, device="cpu")
    assert abs(rg - rc) <= 0.02 and rg > 0.85


@pytest.mark.cuda
@pytest.mark.parametrize("rule", ["SGD", "Adam"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vis_pool_step_on_card_matches_cpu(rule, dtype):
    """One LargeVis pool step (G 8, M 64, 8 columns, 2 live) on the card
    against the CPU from the same state and draws. SGD with the trust
    clip launches kernel 1 once; Adam takes the dense route. The layout is
    a spread one (a cluster far from the origin beside one at it), where
    the step's pool products cancel; they run in float64, so the card is
    held to 1e-7 + 1e-5 x the row's largest magnitude (+ 1 bf16 ulp of
    the result on bf16 tables), moments the same."""
    dev = _cuda()
    rng = np.random.default_rng(20)
    v, b, G, M = 5000, 4096, 8, 64
    opt = Optimizer(type=rule, lr=0.3 if rule == "SGD" else 0.5,
                    weight_decay=1e-5)
    step = steps.make_vis_pool_step(opt, 5, 3.0, pool_size=M, pool_groups=G,
                                    trust=0.25 if rule == "SGD" else None)
    coord = np.zeros((v, 8), np.float32)
    coord[:, :2] = rng.normal(size=(v, 2))
    coord[v // 2:, :2] = coord[v // 2:, :2] * 0.3 + [30.0, -20.0]
    # moments as a run leaves them, m2 at or above the squared gradients:
    # beside a cold m2, Adam's weight w = 1 - exp(c log beta2) (the
    # reference's form, ~1e-3 at c = 1) turns the last-ulp difference of
    # the card's and the CPU's exp into ~1e-4 of a row
    moms = [np.zeros((v, 8), np.float32) for _ in range(opt.num_moment)]
    if moms:
        moms[0][:, :2] = rng.normal(size=(v, 2)) * 1e-2
        moms[1][:, :2] = np.abs(rng.normal(size=(v, 2))) * 4 + 4
    heads, tails = rng.integers(0, v, b), rng.integers(0, v, b)
    heads[:64] = 11                                    # a hub
    draws = (rng.random((G, M)).astype(np.float32),
             rng.random((G, M)).astype(np.float32))
    neg = np.stack([np.ones(v, np.float32), np.arange(v, dtype=np.float32)],
                   axis=1)
    out = []
    for device in (dev, torch.device("cpu")):
        # copies: the SGD route updates the table in place
        t = lambda x: torch.tensor(x, device=device)
        state = {"tables": (t(coord).to(dtype),),
                 "moments": (tuple(t(m) for m in moms),)}
        before = scatter.scatter_add_.launches
        with torch.no_grad():
            new, loss = step(state, t(heads), t(tails), opt.lr, t(neg),
                             draws=tuple(t(d) for d in draws))
        _sync(device)
        if device.type == "cuda":
            assert (scatter.scatter_add_.launches - before
                    == (1 if rule == "SGD" else 0))
        out.append((new["tables"][0].float().cpu(),
                    [m.cpu() for m in new["moments"][0]], float(loss)))
    (gt, gm, gl), (ct, cm, cl) = out
    np.testing.assert_allclose(gl, cl, rtol=1e-5)
    scale = torch.maximum(ct.abs(), torch.as_tensor(coord).abs()).amax(
        dim=1, keepdim=True)
    tol = 1e-7 + 1e-5 * scale
    if dtype == torch.bfloat16:
        tol = tol + _bf16_ulp(ct)
    assert bool(((gt - ct).abs() <= tol).all()), float((gt - ct).abs().max())
    assert bool((gt[:, 2:] == 0).all())
    for a, c in zip(gm, cm):
        scale = c.abs().amax(dim=1, keepdim=True)
        assert bool(((a - c).abs() <= 1e-7 + 1e-5 * scale).all())


# ---------------------------------------------------------------------------
# node2vec's biased walks, the multitail and classic steps
# ---------------------------------------------------------------------------

def _power_law_graph(v, e, seed):
    from graphvite_tpu_torch.graph import Graph

    rng = np.random.default_rng(seed)
    a = (rng.random(e) ** 2.5 * v).astype(np.int64)
    b = (rng.random(e) ** 2.5 * v).astype(np.int64)
    keep = a != b
    return Graph().load_edge_list([(str(x), str(y))
                                   for x, y in zip(a[keep], b[keep])])


@pytest.mark.cuda
@pytest.mark.parametrize("membership", ["cuckoo", "search"])
def test_biased_chain_on_card_matches_cpu(membership, monkeypatch):
    """node2vec's chain (p 4, q 2, aug 5, walk 40) on the card and on the
    CPU from the same draws: equal ids, validity and rounds."""
    from graphvite_tpu_torch.ops.device_sampler import DeviceWalkSampler

    dev = _cuda()
    monkeypatch.setenv("GRAPHVITE_N2V_CUCKOO",
                       "1" if membership == "cuckoo" else "0")
    g = _power_law_graph(20000, 150000, 21)
    samplers = [DeviceWalkSampler.build(g, 5, 40, 410 * 64, biased=True,
                                        p=4.0, q=2.0, banded=True,
                                        bidir=True, device=d)
                for d in (dev, torch.device("cpu"))]
    assert samplers[0].membership == membership
    fn = samplers[1].make_chain_fn()
    gen = torch.Generator().manual_seed(3)
    W, L, R, C = 64, 40, fn.proposals, fn.rounds_cap
    draws = (torch.rand(W, generator=gen), torch.rand(W, generator=gen),
             torch.rand((L - 1, C, 3, R, W), generator=gen))
    want = fn(*samplers[1].arrays(), draws=draws, with_rounds=True)
    got = samplers[0].make_chain_fn()(
        *samplers[0].arrays(), draws=tuple(d.to(dev) for d in draws),
        with_rounds=True)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("rule", ["SGD", "Adam"])
@pytest.mark.parametrize("kind", ["multitail", "classic"])
@pytest.mark.parametrize("big_table", [False, True])
def test_walk_steps_on_card_match_cpu(rule, kind, big_table, monkeypatch):
    """The multitail and classic steps on the card against the CPU from
    the same state, batch and draws; `big_table` shrinks the dense-update
    size so that SGD takes kernel 1 without the clip and Adam kernel 2.
    Tolerances of the CPU tests."""
    from graphvite_tpu_torch.models import GRAPH_MODELS

    dev = _cuda()
    if big_table:
        monkeypatch.setattr(optim_mod, "DENSE_UPDATE_ELEMS", 1000)
    rng = np.random.default_rng(22)
    V, D, B, T, G, M, K = 4000, 128, 2048, 10, 8, 64, 1
    opt = Optimizer(type=rule, lr=0.025 if rule == "SGD" else 1e-3,
                    weight_decay=5e-3)
    if kind == "multitail":
        step = steps.make_graph_pool_multitail_step(opt, K, 5.0, T, M, G)
        tails = (rng.random((B, T)) ** 2 * V).astype(np.int64)
        mask = (rng.random((B, T)) > 0.1).astype(np.float32)
        shape = (G, M)
    else:
        step = steps.make_graph_train_step(GRAPH_MODELS["node2vec"], opt, K,
                                           5.0, trust=0.25)
        tails = (rng.random(B) ** 2 * V).astype(np.int64)
        mask = (rng.random(B) > 0.1).astype(np.float32)
        shape = (B, K)
    heads = (rng.random(B) ** 2 * V).astype(np.int64)
    u1, u2 = rng.random(shape, np.float32), rng.random(shape, np.float32)
    packed = np.stack([np.ones(V, np.float32),
                       np.arange(V, dtype=np.float32)], axis=1)
    tables = [rng.normal(0, 0.1, (V, D)).astype(np.float32)
              for _ in range(2)]
    moms = [[np.abs(rng.normal(0, 1e-3, (V, D))).astype(np.float32)
             for _ in range(opt.num_moment)] for _ in range(2)]
    out = []
    for d in (dev, torch.device("cpu")):
        def t(a):
            return torch.tensor(a, device=d)
        state = {"tables": tuple(t(x) for x in tables),
                 "moments": tuple(tuple(t(m) for m in g) for g in moms)}
        before = (scatter.scatter_add_.launches
                  + scatter.scatter_update_.launches)
        with torch.no_grad():
            new, loss = step(state, t(heads), t(tails), opt.lr, t(packed),
                             mask=t(mask), draws=(t(u1), t(u2)))
        _sync(d)
        if d.type == "cuda":
            launched = (scatter.scatter_add_.launches
                        + scatter.scatter_update_.launches - before)
            assert launched == (2 if rule == "SGD" or big_table else 0)
        out.append(([x.cpu().numpy() for x in new["tables"]]
                    + [m.cpu().numpy() for g in new["moments"] for m in g],
                    float(loss)))
    (gpu, gl), (cpu, cl) = out
    np.testing.assert_allclose(gl, cl, rtol=2e-5)
    for a, b in zip(gpu, cpu):
        np.testing.assert_allclose(a, b, rtol=3e-4, atol=3e-6)


@pytest.mark.cuda
def test_cli_two_block_config_on_card(tmp_path):
    """A two-block edge-list config (LINE, the edge route) through the
    port's command line with no `device` in its resource section: it
    trains on the card, through kernel 1 (the small-table SGD update),
    and its link-prediction evaluation clears AUC 0.9."""
    _cuda()
    from graphvite_tpu_torch import cmd

    rng = np.random.default_rng(0)
    n, half = 60, 30
    edges = []
    for _ in range(n * 6):
        c = rng.integers(2)
        u, v = rng.integers(half, size=2) + c * half
        if u != v:
            edges.append((u, v))
    edges += [(rng.integers(half), rng.integers(half) + half)
              for _ in range(n // 10)]
    graph = tmp_path / "graph.txt"
    graph.write_text("".join("%d\t%d\n" % e for e in edges))
    picks = rng.choice(len(edges), 300, replace=False)
    links = ["%d\t%d\t1\n" % edges[i] for i in picks]
    links += ["%d\t%d\t0\n" % (rng.integers(half), rng.integers(half) + half)
              for _ in range(300)]
    (tmp_path / "links.txt").write_text("".join(links))
    config = tmp_path / "two_blocks.yaml"
    config.write_text("""application: graph
resource:
  dim: 16
graph:
  file_name: %s
  as_undirected: true
build:
  num_negative: 2
  batch_size: 512
  episode_size: 8
train:
  model: LINE
  num_epoch: 1000
  augmentation_step: 1
  negative_weight: 1
  log_frequency: 1000000000
evaluate:
  task: link prediction
  file_name: %s
save:
  file_name: %s
""" % (graph, tmp_path / "links.txt", tmp_path / "line.pkl"))
    before = scatter.scatter_add_.launches
    app, results = cmd.run_config(cmd.load_config(str(config)))
    assert app.solver.device.type == "cuda"
    assert scatter.scatter_add_.launches - before >= app.solver.batch_id
    assert results[0]["AUC"] > 0.9, results
    assert (tmp_path / "line.pkl").is_file()


def _two_block_edges(seed=0):
    """Two communities of 40 vertices (tests/test_blocked.py's graph)."""
    rng = np.random.default_rng(seed)
    edges = []
    for blk in range(2):
        nodes = np.arange(blk * 40, blk * 40 + 40)
        for _ in range(500):
            u, v = rng.choice(nodes, 2, replace=False)
            edges.append((str(u), str(v)))
    edges += [(str(rng.integers(0, 40)), str(40 + rng.integers(0, 40)))
              for _ in range(25)]
    return edges


@pytest.mark.cuda
@pytest.mark.parametrize("rule,float_type", [("SGD", "float32"),
                                             ("SGD", "bfloat16"),
                                             ("Adam", "float32")])
def test_host_master_on_card_matches_device_resident(rule, float_type,
                                                     monkeypatch):
    """Blocked episodes on the card (P = 4) with the host master on and
    off: bit-equal tables, moments and losses. The host master's tables
    stay in host memory, and predict scores them through the host-row path
    as manual scoring does. Every batch launches kernel 1 twice (SGD) or,
    with the dense-update size shrunk below a shard, kernel 2 twice
    (Adam)."""
    from graphvite_tpu_torch.graph import Graph
    from graphvite_tpu_torch.solver import GraphSolver

    _cuda()
    if rule == "Adam":
        monkeypatch.setattr(optim_mod, "DENSE_UPDATE_ELEMS", 64)
    g = Graph().load_edge_list(_two_block_edges())
    out = {}
    for hm in ("0", "1"):
        monkeypatch.setenv("GRAPHVITE_HOST_MASTER", hm)
        s = GraphSolver(dim=32, seed=0, float_type=float_type)
        s.build(g, optimizer={"type": rule,
                              "lr": 0.025 if rule == "SGD" else 1e-3,
                              "weight_decay": 5e-3 if rule == "SGD" else 0},
                num_partition=4, num_negative=1, batch_size=512,
                episode_size=8)
        before = (scatter.scatter_add_.launches,
                  scatter.scatter_update_.launches)
        s.train(model="LINE", num_epoch=200, augmentation_step=1,
                negative_weight=1.0, log_frequency=10**9)
        launched = (scatter.scatter_add_.launches - before[0],
                    scatter.scatter_update_.launches - before[1])
        assert launched == ((2 * s.batch_id, 0) if rule == "SGD"
                            else (0, 2 * s.batch_id))
        where = {t.device.type for t in s.state["tables"]}
        assert where == ({"cpu"} if hm == "1" else {"cuda"})
        out[hm] = ([t.float().cpu() for t in s.state["tables"]]
                   + [m.cpu() for grp in s.state["moments"] for m in grp],
                   s.batch_losses.cpu())
        if hm == "1":
            assert s.blocked_stats["misses"] > 0
            assert s.blocked_stats["master_memory"] == "pinned"
            pairs = np.random.default_rng(1).integers(0, g.num_vertex,
                                                      (500, 2))
            emb, ctx = s.vertex_embeddings, s.context_embeddings
            manual = (emb[pairs[:, 0]] * ctx[pairs[:, 1]]).sum(-1)
            np.testing.assert_allclose(s.predict(pairs), manual, rtol=1e-4,
                                       atol=1e-4)
    for a, b in zip(out["0"][0], out["1"][0]):
        assert torch.equal(a, b)
    assert torch.equal(out["0"][1], out["1"][1])


@pytest.mark.cuda
@pytest.mark.parametrize("rule", ["SGD", "Adam"])
def test_sharded_step_on_card_matches_cpu(rule, monkeypatch):
    """The per-block step on the card against the CPU from the same
    shards, batch and draws, at width 128 with the dense-update size
    shrunk below a shard (Adam on kernel 2). Tolerances of the CPU
    tests."""
    from graphvite_tpu_torch.models import GRAPH_MODELS
    from graphvite_tpu_torch.parallel.mesh import make_sharded_graph_step

    dev = _cuda()
    monkeypatch.setattr(optim_mod, "DENSE_UPDATE_ELEMS", 1000)
    rng = np.random.default_rng(8)
    cap, size, D, B, K = 5000, 4900, 128, 4096, 1
    opt = Optimizer(type=rule, lr=0.025 if rule == "SGD" else 1e-3,
                    weight_decay=5e-3 if rule == "SGD" else 0.0)
    step = make_sharded_graph_step(GRAPH_MODELS["LINE"], opt, K, 5.0)
    heads = (rng.random(B) ** 2 * size).astype(np.int32)
    tails = (rng.random(B) ** 2 * size).astype(np.int32)
    mask = (rng.random(B) > 0.05).astype(np.float32)
    u1, u2 = rng.random((B, K), np.float32), rng.random((B, K), np.float32)
    nprob = np.zeros(cap, np.float32)
    nprob[:size] = rng.random(size)
    nalias = np.zeros(cap, np.int32)
    nalias[:size] = rng.integers(0, size, size)
    tables = [rng.normal(0, 0.1, (cap, D)).astype(np.float32)
              for _ in range(2)]
    moms = [[np.abs(rng.normal(0, 1e-3, (cap, D))).astype(np.float32)
             for _ in range(opt.num_moment)] for _ in range(2)]
    out = []
    for d in (dev, torch.device("cpu")):
        def t(a):
            return torch.tensor(a, device=d)
        state = {"tables": tuple(t(x) for x in tables),
                 "moments": tuple(tuple(t(m) for m in g) for g in moms)}
        with torch.no_grad():
            new, loss = step(state, (t(heads), t(tails), t(mask)), opt.lr,
                             t(nprob), t(nalias), size, draws=(t(u1), t(u2)))
        _sync(d)
        out.append(([x.cpu().numpy() for x in new["tables"]]
                    + [m.cpu().numpy() for g in new["moments"] for m in g],
                    float(loss)))
    (gpu, gl), (cpu, cl) = out
    np.testing.assert_allclose(gl, cl, rtol=2e-5)
    for a, b in zip(gpu, cpu):
        np.testing.assert_allclose(a, b, rtol=3e-4, atol=3e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [100_000, 200_000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_on_shard_ids(n, dtype):
    """Kernels 1 and 2 on shard-local ids of the blocked path's shape:
    unsorted power-law ids over a 1,986,238 x 128 shard (friendster-small's
    7,944,949 vertices in 4 partitions), 100,000 (vertex side) or 200,000
    (context side, K = 1) of them, against their plain versions on the
    touched rows, renumbered."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(n)
    cap, w = 1_986_238, 128
    ids = (torch.rand(n, generator=gen, device=dev) ** 2.5 * cap).long()
    upd = torch.randn((n, w), generator=gen, device=dev) * 1e-2
    table = (torch.randn((cap, w), generator=gen, device=dev) * 0.1).to(dtype)
    rows, inv = torch.unique(ids, return_inverse=True)
    before = table[rows].clone()
    want = scatter.scatter_add_plain(before.clone(), inv, upd).float()
    mag = scatter.scatter_add_plain(before.float().abs(), inv, upd.abs())
    scatter.scatter_add_(table, ids, upd)
    got = table[rows].float()
    tol = 1e-6 * mag
    if dtype == torch.bfloat16:
        tol = tol + _bf16_ulp(want)
    assert bool(((got - want).abs() <= tol).all())
    del table, before, want, mag, got
    if dtype != torch.float32:
        return
    opt = Optimizer(type="Adam", lr=1e-3, weight_decay=0.0)
    table = torch.randn((cap, w), generator=gen, device=dev) * 0.1
    moms = tuple(torch.rand((cap, w), generator=gen, device=dev) * 1e-4
                 for _ in range(2))
    before = [x[rows].clone() for x in (table,) + moms]
    counts = torch.ones(n, device=dev)
    sqs = upd * upd
    want_t, want_m = scatter.scatter_update_plain(
        before[0].clone(), tuple(m.clone() for m in before[1:]), inv, upd,
        opt, 1e-3, counts, sqs)
    scatter.scatter_update_(table, moms, ids, upd, opt, 1e-3,
                            entry_counts=counts, entry_sqs=sqs)
    for got, want in zip((table,) + moms, (want_t,) + want_m):
        got = got[rows]
        assert bool(((got - want).abs() <= 2e-5 + 2e-5 * want.abs()).all())


def _mesh_engine_run(kind, devices, graph, draws, episodes=2, nudge=False):
    """One of the multi-device engines on `devices` (a worker per entry)
    over `graph` at dim 32: gathered tables (each replica) after
    `episodes` episodes, and the kernel launches of the run. `draws`: a
    list of per-episode draws, made on the CPU by the first call and
    reused by the next. `nudge`: LargeVis starts from coordinates one ulp
    above the usual ones."""
    from graphvite_tpu_torch.models import GRAPH_MODELS
    from graphvite_tpu_torch.ops.alias import AliasTable, device_alias_arrays
    from graphvite_tpu_torch.parallel import mesh

    dim, W = 32, len(devices)
    group = mesh.DeviceGroup(devices)
    gen = torch.Generator().manual_seed(5)

    def draws_gen(tr, e):
        if len(draws) <= e:
            draws.append(tr.episode_draws(torch.Generator().manual_seed(e)))
        return mesh.draws_to(draws[e], group.devices)
    before = (scatter.scatter_add_.launches, scatter.scatter_update_.launches)
    if kind.startswith("vis"):
        rule = "SGD" if kind == "vis_sgd" else "Adam"
        opt = Optimizer(type=rule, lr=0.5, weight_decay=1e-5)
        step = steps.make_vis_pool_step(opt, 5, 3.0, pool_size=64,
                                        pool_groups=8)
        tr = mesh.ReplicatedEdgeTrainer(group, step, opt, 4096, 3)
        coord = torch.zeros((graph.num_vertex, 8))
        coord[:, :2] = torch.randn((graph.num_vertex, 2), generator=gen) * 3
        if nudge:
            coord[:, :2] = torch.nextafter(coord[:, :2],
                                           torch.full_like(coord[:, :2], 1e9))
        w = np.maximum(np.asarray(graph.vertex_weights), 1e-12) ** 0.75
        neg = tuple(torch.from_numpy(a) for a in
                    device_alias_arrays(AliasTable(w)))
        warm = None
        if rule == "Adam":
            # warm moments in the live columns, zero in the pad columns,
            # as tests/test_torch_mesh.py starts Adam against the reference
            warm = tuple(torch.zeros((graph.num_vertex, 8)) for _ in range(2))
            for m in warm:
                m[:, :2] = torch.randn((graph.num_vertex, 2),
                                       generator=gen).abs() * 1e-2 + 1e-3
            warm = (warm,)
        tabs, moms = tr.init_state((coord,), warm)
        edges = tr.init_edges(graph)
        for e in range(episodes):
            tabs, moms, _ = tr.run_episode(tabs, moms, edges, neg, 3 * e,
                                           1000, 1, draws=draws_gen(tr, e))
        out = [tabs[i][0].cpu() for i in range(W)]
    else:
        mode, rule = kind.split("_")
        opt = Optimizer(type=rule.upper() if rule == "sgd" else "Adam",
                        lr=0.025 if rule == "sgd" else 1e-3,
                        weight_decay=5e-3, beta2=0.999)
        part = mesh.VertexPartition(np.asarray(graph.degrees), W)
        tr = mesh.ShardedGraphTrainer(
            group, part, dim, GRAPH_MODELS["LINE"], opt, num_negative=1,
            negative_weight=5.0,
            batch_size=4096 if mode == "edges" else 44 * 64, ep_batches=3,
            sampler_mode=mode, walk_cfg=dict(augmentation_step=2,
                                             walk_length=10, pool_size=64))
        sample = tr.build_sample_state(graph)
        vertex = (torch.rand((graph.num_vertex, dim), generator=gen)
                  - 0.5) / dim
        state = tr.init_state(vertex, torch.randn(
            (graph.num_vertex, dim), generator=gen) * 0.05)
        neg = tr.init_negative_state(np.asarray(graph.vertex_weights))
        losses = []
        for e in range(episodes):
            state, neg, ls = tr.run_episode(state, sample, neg, 6 * e, 1000,
                                            1, draws=draws_gen(tr, e))
            losses += [l.cpu() for l in ls]
        out = [t.cpu() for t in tr.gather_tables(state)]
        out.append(torch.stack(losses))
    for d in group.distinct:
        _sync(d)
    return out, (scatter.scatter_add_.launches - before[0],
                 scatter.scatter_update_.launches - before[1])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["edges_sgd", "edges_adam", "walks_sgd",
                                  "walks_adam", "vis_sgd", "vis_adam"])
def test_mesh_engine_two_workers_on_card_match_cpu(kind, monkeypatch):
    """Each multi-device engine with two workers on cuda:0 (device_ids
    [0, 0]) against two CPU workers from the same state and draws, over
    two episodes (the ring, the row routing and the replica merge on the
    card), at the steps' card-vs-CPU tolerance; the dense-update size
    shrunk for the graph engines and LargeVis Adam so their moment
    updates take kernel 2. The launches counted on the card: kernel 1
    twice per worker-batch on the edges engine's SGD, once on the walks
    engine's arena and on the LargeVis SGD replicas (the trust clip's
    accumulate); kernel 2 twice on both graph engines' Adam, once on
    LargeVis Adam. LargeVis Adam (lr 0.5, from warm moments) runs one
    episode: on this graph its hubs take hundreds of touches a batch,
    and on the CPU alone a 1-ulp change of the start coordinates grows
    to 0.012 of the tolerance after one episode and to 1.19 times it
    after two (test_replicated_adam_horizon_on_cpu), so two summation
    orders need not agree within it past one."""
    dev = _cuda()
    if kind != "vis_sgd":
        # LargeVis SGD keeps the trust clip of its small table: without
        # it lr 0.5 makes the layout chaotic within the few batches
        monkeypatch.setattr(optim_mod, "DENSE_UPDATE_ELEMS", 1000)
    graph = _power_law_graph(3000, 30000, 2)
    draws = []
    episodes = 1 if kind == "vis_adam" else 2
    gpu, launches = _mesh_engine_run(kind, [dev, dev], graph, draws,
                                     episodes)
    cpu, _ = _mesh_engine_run(kind, ["cpu", "cpu"], graph, draws, episodes)
    worker_batches = 2 * episodes * 3
    want = {"edges_sgd": (2, 0), "edges_adam": (0, 2), "walks_sgd": (1, 0),
            "walks_adam": (0, 2), "vis_sgd": (1, 0), "vis_adam": (0, 1)}[kind]
    assert launches == tuple(n * worker_batches for n in want)
    if not kind.startswith("vis"):
        # the per-batch losses, as the workers' streams computed them
        np.testing.assert_allclose(gpu.pop().numpy(), cpu.pop().numpy(),
                                   rtol=2e-5)
    for a, b in zip(gpu, cpu):
        if kind.startswith("vis"):
            scale = b.abs().amax(dim=1, keepdim=True)
            assert bool(((a - b).abs() <= 3e-6 + 3e-4 * scale).all())
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=3e-4,
                                       atol=3e-6)
    if kind.startswith("vis"):
        assert torch.equal(gpu[0], gpu[1])     # one merged replica


def test_replicated_adam_horizon_on_cpu(monkeypatch):
    """What the card test of LargeVis Adam rests on, on two CPU workers:
    from its state and draws, a 1-ulp change of the start coordinates
    stays below half its tolerance after one episode. Prints the worst
    |difference| over the tolerance after one and after two episodes
    (the hubs' Adam steps amplify it: 0.012 and 1.19 here)."""
    monkeypatch.setattr(optim_mod, "DENSE_UPDATE_ELEMS", 1000)
    graph = _power_law_graph(3000, 30000, 2)
    ratios = []
    for episodes in (1, 2):
        draws = []
        a, _ = _mesh_engine_run("vis_adam", ["cpu", "cpu"], graph, draws,
                                episodes)
        b, _ = _mesh_engine_run("vis_adam", ["cpu", "cpu"], graph, draws,
                                episodes, nudge=True)
        scale = a[0].abs().amax(dim=1, keepdim=True)
        ratios.append(float(((b[0] - a[0]).abs()
                             / (3e-6 + 3e-4 * scale)).max()))
    print("1-ulp start change over the tolerance, after 1 and 2 episodes:",
          ratios)
    assert ratios[0] < 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["edges_sgd", "walks_adam", "vis_sgd"])
def test_mesh_engine_across_cards_matches_cpu(kind, monkeypatch):
    """The same engines with one worker on each visible card (up to four):
    the collectives' peer copies between cards, against as many CPU
    workers from the same draws. Skips on a host with one card."""
    _cuda()
    n = min(torch.cuda.device_count(), 4)
    if n < 2:
        pytest.skip("needs two CUDA devices")
    if kind != "vis_sgd":
        monkeypatch.setattr(optim_mod, "DENSE_UPDATE_ELEMS", 1000)
    graph = _power_law_graph(3000, 30000, 2)
    draws = []
    gpu, _ = _mesh_engine_run(kind, [torch.device("cuda", i)
                                     for i in range(n)], graph, draws)
    cpu, _ = _mesh_engine_run(kind, ["cpu"] * n, graph, draws)
    if kind != "vis_sgd":
        np.testing.assert_allclose(gpu.pop().numpy(), cpu.pop().numpy(),
                                   rtol=2e-5)
    for a, b in zip(gpu, cpu):
        if kind == "vis_sgd":
            scale = b.abs().amax(dim=1, keepdim=True)
            assert bool(((a - b).abs() <= 3e-6 + 3e-4 * scale).all())
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=3e-4,
                                       atol=3e-6)


# ---------------------------------------------------------------------------
# the knowledge-graph engines for several workers, and the host backend
# ---------------------------------------------------------------------------

def _power_law_kg(v, r, e, seed):
    """An anonymous power-law KG of `e` triplets over `v` entities and `r`
    Zipf-skewed relations, straight into its arrays."""
    from graphvite_tpu_torch.graph import KnowledgeGraph

    rng = np.random.default_rng(seed)
    kg = KnowledgeGraph()
    kg.num_vertex, kg.num_relation, kg.num_edge = v, r, e
    kg.id2entity = kg.entity2id = kg.id2relation = kg.relation2id = None
    kg.edge_heads = (rng.random(e) ** 2.5 * v).astype(np.int64)
    kg.edge_tails = (rng.random(e) ** 2.5 * v).astype(np.int64)
    p = (np.arange(r) + 3.0) ** -0.9
    kg.edge_relations = rng.choice(r, e, p=p / p.sum()).astype(np.int64)
    kg.edge_weights = np.ones(e, dtype=np.float32)
    return kg


# per worker-batch: (kernel 1, kernel 2) launches of each mode and rule,
# with the dense-update size shrunk so the arenas take kernel 2 and the
# relation table (20 x 32) the dense route
KG_MESH_LAUNCHES = {("pooled", "SGD"): (2, 0), ("pooled", "Adam"): (0, 1),
                    ("global", "SGD"): (4, 0), ("global", "Adam"): (1, 2),
                    ("resident", "SGD"): (2, 0),
                    ("resident", "Adam"): (0, 1)}


def _kg_mesh_run(mode, rule, devices, kg, draws, episodes=2):
    """ShardedKGTrainer on `devices` (a worker per entry) over `kg` at dim
    32 (RotatE, K 8): the gathered entity table and moments, worker 0's
    relations and the losses after `episodes` rounds, and the kernel
    launches of the run. `draws`: per-episode draws made on the CPU by the
    first call and reused by the next."""
    from graphvite_tpu_torch.parallel import kg as kg_mod
    from graphvite_tpu_torch.parallel import mesh

    dim, W = 32, len(devices)
    group = mesh.DeviceGroup(devices)
    part = mesh.VertexPartition(np.asarray(kg.degrees), 2 * W)
    opt = Optimizer(type=rule, lr=0.01 if rule == "SGD" else 1e-4,
                    weight_decay=0.0)
    tr = kg_mod.ShardedKGTrainer(
        group, part, dim, KG_MODELS["RotatE"], opt, num_negative=8,
        margin_or_l3=6.0, adversarial_temperature=0.2, batch_size=512,
        ep_batches=3, negative_pool=mode)
    gen = torch.Generator().manual_seed(5)
    ent = (torch.rand((kg.num_vertex, dim), generator=gen) - 0.5) * 0.1
    rel = torch.rand((kg.num_relation, dim), generator=gen) * 6 - 3
    state = tr.init_state(ent, rel)
    trip = tr.init_triplets(kg)
    before = (scatter.scatter_add_.launches, scatter.scatter_update_.launches)
    losses = []
    for e in range(episodes):
        if len(draws) <= e:
            draws.append(tr.episode_draws(torch.Generator().manual_seed(e)))
        state, ls = tr.run_episode(state, trip, 6 * e, 1000, 1,
                                   draws=mesh.draws_to(draws[e],
                                                       group.devices))
        losses += [l.cpu() for l in ls]
    out = [tr.gather_entities(state).cpu(), state["rel"][0].cpu()]
    out += [m.cpu() for m in tr.gather_entity_moments(state)]
    out.append(torch.stack(losses))
    for d in group.distinct:
        _sync(d)
    return out, (scatter.scatter_add_.launches - before[0],
                 scatter.scatter_update_.launches - before[1])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["pooled", "global", "resident"])
@pytest.mark.parametrize("rule", ["SGD", "Adam"])
def test_kg_mesh_two_workers_on_card_match_cpu(mode, rule, monkeypatch):
    """ShardedKGTrainer with two workers on cuda:0 against two CPU
    workers from the same state and draws over two rounds (the seat
    rotation, the relation merge and, in global mode, the pool's
    all_gather and reduce_scatter on the card), at the steps'
    card-vs-CPU tolerance; the launches counted on the card
    (KG_MESH_LAUNCHES per worker-batch)."""
    dev = _cuda()
    monkeypatch.setattr(optim_mod, "DENSE_UPDATE_ELEMS", 1000)
    kg = _power_law_kg(2000, 20, 20000, 3)
    draws = []
    gpu, launches = _kg_mesh_run(mode, rule, [dev, dev], kg, draws)
    cpu, _ = _kg_mesh_run(mode, rule, ["cpu", "cpu"], kg, draws)
    worker_batches = 2 * 2 * 3
    want = KG_MESH_LAUNCHES[(mode, rule)]
    assert launches == tuple(n * worker_batches for n in want)
    np.testing.assert_allclose(gpu.pop().numpy(), cpu.pop().numpy(),
                               rtol=2e-5)
    for a, b in zip(gpu, cpu):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=3e-4,
                                   atol=3e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["graph", "knowledge graph",
                                    "visualization"])
def test_host_backend_on_card(solver):
    """sampler_backend="host" on the card, one case per solver: pools
    from the host samplers uploaded from pinned memory, the same step
    family as the reference's host route; two-block LINE AUC > 0.9, the
    math fixture's filtered tail MRR > 0.85, LargeVis 10-NN agreement >=
    0.9; the tables on the card and the kernels launched (kernel 1 on
    the small tables' SGD updates)."""
    from collections import defaultdict

    from graphvite_tpu_torch.application import evaluate as ev
    from graphvite_tpu_torch.application.evaluate import rank_sum_auc
    from graphvite_tpu_torch.graph import Graph, KnowledgeGraph
    from graphvite_tpu_torch.knn import KNNGraph
    from graphvite_tpu_torch.solver import (GraphSolver,
                                            KnowledgeGraphSolver,
                                            VisualizationSolver)

    _cuda()
    before = scatter.scatter_add_.launches
    if solver == "graph":
        s = GraphSolver(dim=16, sampler_backend="host")
        s.build(Graph().load_edge_list(_two_block_edges()), num_negative=2,
                batch_size=256, episode_size=4)
        s.train(model="LINE", num_epoch=200, augmentation_step=1,
                negative_weight=1.0, log_frequency=10**9)
        n2i = s.graph.name2id
        intra = np.asarray([(n2i[str(a)], n2i[str(b)])
                            for a in range(20) for b in range(20, 40)])
        cross = np.asarray([(n2i[str(a)], n2i[str(b)])
                            for a in range(20) for b in range(60, 80)])
        si, sc = s.predict(intra), s.predict(cross)
        score = rank_sum_auc(np.r_[si, sc], np.r_[np.ones(len(si)),
                                                 np.zeros(len(sc))])
        assert score > 0.9, score
        assert scatter.scatter_add_.launches - before == 2 * s.batch_id
    elif solver == "knowledge graph":
        rng = np.random.default_rng(0)
        trips = []
        for _ in range(2000):
            x, c = int(rng.integers(50)), int(rng.integers(1, 6))
            trips.append((str(x), "+%d" % c, str((x + c) % 50)))
        kg = KnowledgeGraph().load_triplet_list(trips)
        s = KnowledgeGraphSolver(dim=32, seed=0, sampler_backend="host")
        s.build(kg, optimizer=dict(type="Adam", lr=5e-3), num_negative=8,
                batch_size=256, episode_size=8)
        s.train(model="RotatE", num_epoch=150, margin=6.0,
                log_frequency=10**9)
        H = np.arange(100) % 50
        R = np.asarray([kg.relation2id["+%d" % (1 + i % 5)]
                        for i in range(100)])
        T = np.asarray([kg.entity2id[str((h + 1 + i % 5) % 50)]
                        for i, h in enumerate(H)])
        H = np.asarray([kg.entity2id[str(h)] for h in H])
        rk = ev.filtered_rankings("RotatE", s.entity_embeddings,
                                  s.relation_embeddings, H, R, T,
                                  defaultdict(set), defaultdict(set), 6.0,
                                  "tail")
        assert ev.ranking_metrics(rk)["MRR"] > 0.85
    else:
        rng = np.random.default_rng(0)
        centers = rng.standard_normal((5, 10)) * 8
        labels = np.repeat(np.arange(5), 300)
        x = (centers[labels]
             + rng.standard_normal((1500, 10))).astype(np.float32)
        s = VisualizationSolver(dim=2, sampler_backend="host")
        s.build(KNNGraph().load_numpy(x, num_neighbor=15, perplexity=10),
                optimizer=dict(type="Adam", lr=0.5, weight_decay=1e-5),
                num_negative=5, batch_size=2000, episode_size=50)
        s.train(num_epoch=50, negative_weight=3, log_frequency=10**9)
        c = s.coordinates
        d2 = ((c[:, None, :] - c[None, :, :]) ** 2).sum(-1)
        np.fill_diagonal(d2, np.inf)
        nn = np.argsort(d2, axis=1)[:, :10]
        assert float((labels[nn] == labels[:, None]).mean()) >= 0.9
    assert s.state["tables"][0].device.type == "cuda"
    assert s.host_stats["pools"] >= 1


# ---------------------------------------------------------------------------
# the worker group over two processes (GRAPHVITE_COORDINATOR), on the card
# ---------------------------------------------------------------------------

def _multihost():
    """tests/test_torch_multihost.py (its runs and its process launcher;
    it imports no JAX at its top), loaded by path."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "test_torch_multihost.py")
    spec = importlib.util.spec_from_file_location("torch_multihost", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
@pytest.mark.parametrize("across_cards", [False, True])
def test_two_processes_on_card_equal_one(across_cards, tmp_path):
    """Two processes with one worker each give the bits of one process
    with two workers, in edges and walks mode and the KG engine's pooled
    and resident modes: on
    cuda:0 for both (two ranks on one card: gloo, the tensors staged
    through pinned host buffers), or, where there are two cards, one
    process per card (NCCL). SGD: at these small tables the moment rules
    take the dense route, whose index_add_ adds with float atomics, so
    one process does not reproduce its own bits there."""
    from graphvite_tpu_torch.parallel import mesh

    _cuda()
    if across_cards and torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    mh = _multihost()
    devices = ["cuda:0", "cuda:1"] if across_cards else ["cuda:0"] * 2
    names = ["edges_sgd", "kg_pooled_sgd", "walks_sgd", "kg_resident"]
    # across cards each process takes the card of its index
    runs = mh.spawn(str(tmp_path), ["cuda:{pid}" if across_cards
                                    else "cuda:0", "1", ",".join(names)])
    for pid, (rc, out) in enumerate(runs):
        assert rc == 0, "process %d failed:\n%s" % (pid, out[-3000:])
        want = "transport %s" % ("nccl" if across_cards else "gloo")
        assert want in out, out[-2000:]
    for name in names:
        want = mh.RUNS[name](mesh.DeviceGroup(devices), None)
        for out in mh.outputs(str(tmp_path), runs, name):
            assert sorted(out) == sorted(want)
            for key in want:
                np.testing.assert_array_equal(out[key], want[key],
                                              err_msg="%s %s" % (name, key))


# ---------------------------------------------------------------------------
# the row-access kernels (csrc/row_access.cu) and the walk opt-ins
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("v,d,n", [(70000, 128, 20000), (4099, 20, 1001),
                                   (5000, 8, 1500)])
@pytest.mark.parametrize("wide", [False, True])
def test_row_access_kernels_match_plain_versions(v, d, n, wide):
    """gather_rows, rmw_rows_ (unique ids, 3 i + jitter) and
    sweep_add_sorted_ (repeated ids, ids >= V dropped) bit for bit against
    their plain versions on the card; N not a multiple of 512 nor of the
    sweep's chunk, widths with and without 4-column vectors."""
    from graphvite_tpu_torch.ops import row_access as ra

    dev = _cuda()
    rng = np.random.default_rng(v + d)
    it = torch.int64 if wide else torch.int32
    table = torch.as_tensor(rng.normal(size=(v, d)).astype(np.float32),
                            device=dev)
    upd = torch.as_tensor(rng.normal(size=(n, d)).astype(np.float32),
                          device=dev)
    ids = torch.as_tensor(rng.integers(-2, v + 2, n), device=dev).to(it)
    counts = (ra.gather_rows.launches, ra.rmw_rows_.launches,
              ra.sweep_add_sorted_.launches)
    got = ra.gather_rows(table, ids)
    assert torch.equal(got, ra.gather_rows_plain(table, ids))
    uniq = torch.as_tensor((np.arange(n) * 3 + rng.integers(0, 3, n)) % v,
                           device=dev).to(it)
    got = ra.rmw_rows_(table.clone(), uniq, upd, check_unique=True)
    assert torch.equal(got, ra.rmw_rows_plain(table.clone(), uniq, upd))
    rep = torch.sort(torch.as_tensor(
        np.concatenate([(rng.random(n - 64) ** 3 * (v + 10)).astype(
            np.int64), np.full(64, v - 1)]), device=dev).to(it))[0]
    got = ra.sweep_add_sorted_(table.clone(), rep, upd)
    torch.cuda.synchronize()
    assert torch.equal(got, ra.sweep_add_sorted_plain(table.clone(), rep,
                                                      upd))
    assert (ra.gather_rows.launches, ra.rmw_rows_.launches,
            ra.sweep_add_sorted_.launches) == tuple(c + 1 for c in counts)


def _chunked_sweep_ids(rng, v, c):
    """Ascending ids over chunks of c positions (c a multiple of 4):
    dropped ids at both ends; repeats in [0, 10) up to the first chunk's
    edge; a hub run of 7 c + 5 positions from there (chunks wholly inside
    it); repeats up to the edge at 9 c; runs of 4 over two chunks, so
    runs end on chunk edges; random repeats; N = 17 c + 10, not a
    multiple of c."""
    def rand(lo, hi, size):
        return np.sort(rng.integers(lo, hi, size))

    return np.concatenate([
        [-7, -1], rand(0, 10, c - 2), np.full(7 * c + 5, 11),
        rand(12, 100, c - 5), np.repeat(np.arange(100, 100 + c // 2), 4),
        rand(400, v, 6 * c + 7), [v, v, v + 3]])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 20, 3, 200, 130])
@pytest.mark.parametrize("wide", [False, True])
def test_sweep_chunks_match_plain_version(d, wide):
    """The sweep's chunked kernels bit for bit against
    sweep_add_sorted_plain: a hub run across many chunks, runs ending on
    chunk edges, dropped ids, a partial last chunk; widths with TMA
    staging (128, 200: two column passes) and without (20, 3, 130), int32
    and int64 ids; two calls give the same bits."""
    from graphvite_tpu_torch.ops import row_access as ra

    dev = _cuda()
    rng = np.random.default_rng(d + wide)
    v, c = 3000, ra.chunk_rows(d)
    it = torch.int64 if wide else torch.int32
    ids = torch.as_tensor(_chunked_sweep_ids(rng, v, c), device=dev).to(it)
    n = ids.numel()
    assert n % c and n > 16 * c
    table = torch.as_tensor(rng.normal(size=(v, d)).astype(np.float32),
                            device=dev)
    upd = torch.as_tensor(rng.normal(size=(n, d)).astype(np.float32),
                          device=dev)
    count = ra.sweep_add_sorted_.launches
    got = ra.sweep_add_sorted_(table.clone(), ids, upd)
    again = ra.sweep_add_sorted_(table.clone(), ids, upd)
    want = ra.sweep_add_sorted_plain(table.clone(), ids, upd)
    torch.cuda.synchronize()
    assert ra.sweep_add_sorted_.launches == count + 2
    assert torch.equal(got, want)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_sweep_chunks_unaligned_pointers():
    """Update rows and ids 4 bytes off 16-byte alignment at width 128: the
    kernel stages rows without TMA and reads the ids from device memory,
    bit-equal to the plain version all the same."""
    from graphvite_tpu_torch.ops import row_access as ra

    dev = _cuda()
    rng = np.random.default_rng(9)
    v, d = 3000, 128
    ids = _chunked_sweep_ids(rng, v, ra.chunk_rows(d))
    n = ids.size
    id_buf = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    id_buf[1:] = torch.as_tensor(ids, device=dev)
    upd_buf = torch.zeros(n * d + 1, device=dev)
    upd_buf[1:] = torch.as_tensor(rng.normal(size=n * d).astype(np.float32),
                                  device=dev)
    sid, upd = id_buf[1:], upd_buf[1:].view(n, d)
    assert sid.data_ptr() % 16 and upd.data_ptr() % 16
    table = torch.as_tensor(rng.normal(size=(v, d)).astype(np.float32),
                            device=dev)
    got = ra.sweep_add_sorted_(table.clone(), sid, upd)
    want = ra.sweep_add_sorted_plain(table.clone(), sid, upd)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_rmw_rows_check_unique_raises_on_card():
    from graphvite_tpu_torch.ops import row_access as ra

    dev = _cuda()
    table = torch.zeros((10, 4), device=dev)
    with pytest.raises(ValueError, match="unique"):
        ra.rmw_rows_(table, torch.tensor([1, 2, 1], device=dev),
                     torch.ones((3, 4), device=dev), check_unique=True)
    with pytest.raises(TypeError, match="float32"):
        ra.gather_rows(table.bfloat16(), torch.tensor([1], device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("rule", ["SGD", "Adam"])
def test_sort_heads_step_on_card_matches_cpu(rule):
    """GRAPHVITE_SWEEP_WALK's step: unsorted walk-pair heads with dead
    slots, sorted in the step, through the three kernels on the card
    against the plain versions on the CPU."""
    dev = _cuda()
    rng = np.random.default_rng(11)
    V, D, B, G, M = 4000, 32, 2048, 8, 16
    heads = (rng.random(B) ** 2 * V).astype(np.int32)
    tails = (rng.random(B) ** 2 * V).astype(np.int32)
    mask = (rng.random(B) > 0.1).astype(np.float32)
    u1, u2 = rng.random((G, M), np.float32), rng.random((G, M), np.float32)
    packed = np.stack([np.ones(V, np.float32),
                       np.arange(V, dtype=np.float32)], axis=1)
    opt = Optimizer(type=rule, lr=0.025 if rule == "SGD" else 1e-3,
                    weight_decay=5e-3 if rule == "SGD" else 0.0)
    tables = [rng.normal(0, 0.1, (V, D)).astype(np.float32)
              for _ in range(2)]
    moms = [[np.abs(rng.normal(0, 1e-3, (V, D))).astype(np.float32)
             for _ in range(opt.num_moment)] for _ in range(2)]
    step = steps.make_graph_pool_step(opt, 1, 5.0, M, G, sweep_vertex=True,
                                      sweep_context=True, sweep_gather=True,
                                      sort_heads=True)
    out = []
    for d in (dev, torch.device("cpu")):
        def t(a):
            return torch.as_tensor(np.array(a), device=d)
        state = {"tables": tuple(t(x) for x in tables),
                 "moments": tuple(tuple(t(m) for m in g) for g in moms)}
        with torch.no_grad():
            new, loss = step(state, t(heads), t(tails), opt.lr, t(packed),
                             mask=t(mask), draws=(t(u1), t(u2)))
        out.append(([x.cpu().numpy() for x in new["tables"]]
                    + [m.cpu().numpy() for g in new["moments"] for m in g],
                    float(loss)))
    (gpu, gl), (cpu, cl) = out
    np.testing.assert_allclose(gl, cl, rtol=2e-5)
    for a, b in zip(gpu, cpu):
        np.testing.assert_allclose(a, b, rtol=3e-4, atol=3e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sweep_banded_step_on_card_matches_cpu(dtype, monkeypatch):
    """GRAPHVITE_SWEEP_BANDED's walk step (SGD; bf16 deltas rounded before
    the sum) on the card against the CPU: float32 tables rtol 3e-4, atol
    3e-6; bfloat16 within 1 ulp."""
    monkeypatch.setenv("GRAPHVITE_SWEEP_BANDED", "1")
    dev = _cuda()
    rng = np.random.default_rng(12)
    V, D, Bw, L1, G, M = 4000, 32, 64, 9, 8, 16
    T = 4
    chain = (rng.random((Bw, L1)) ** 2 * V).astype(np.int64)
    mask = (rng.random((Bw, L1, T)) > 0.2).astype(np.float32)
    u1, u2 = rng.random((G, M), np.float32), rng.random((G, M), np.float32)
    packed = np.stack([np.ones(V, np.float32),
                       np.arange(V, dtype=np.float32)], axis=1)
    opt = Optimizer(type="SGD", lr=0.025, weight_decay=5e-3)
    tables = [rng.normal(0, 0.1, (V, D)).astype(np.float32)
              for _ in range(2)]
    step = steps.make_graph_banded_walk_step(opt, 1, 5.0, 2, True, M, G,
                                             trust=None)
    out = []
    for d in (dev, torch.device("cpu")):
        def t(a):
            return torch.as_tensor(np.array(a), device=d)
        state = {"tables": tuple(t(x).to(dtype) for x in tables),
                 "moments": ((), ())}
        before = scatter.scatter_add_.launches
        with torch.no_grad():
            new, loss = step(state, t(chain), t(chain), opt.lr, t(packed),
                             mask=t(mask), draws=(t(u1), t(u2)))
        if d.type == "cuda":
            assert scatter.scatter_add_.launches == before + 2
        out.append(([x.float().cpu() for x in new["tables"]], float(loss)))
    (gpu, gl), (cpu, cl) = out
    np.testing.assert_allclose(gl, cl, rtol=2e-5)
    for a, b in zip(gpu, cpu):
        if dtype == torch.float32:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=3e-4,
                                       atol=3e-6)
        else:
            assert bool(((a - b).abs() <= _bf16_ulp(b)).all())
