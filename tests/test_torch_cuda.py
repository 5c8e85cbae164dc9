"""Tests of the port that need an NVIDIA GPU (marked `cuda`; each skips
where torch sees no card). This file imports neither JAX nor the JAX
package, so it also runs on a host without them:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerances: scatter-add float32 results within rtol 1e-6 of the magnitude
of the terms summed (orders differ); bfloat16 within 1 bf16 ulp (both
versions round one float32 sum once). The gather is exact. The moment
update within rtol 2e-5, atol 2e-5 (the CPU tests' tolerance against the
reference), plus 1 bf16 ulp for bfloat16 tables. The steps as the CPU
tests hold the port to the reference (loss rtol 2e-5; tables and moments
rtol 3e-4, atol 3e-6)."""
import numpy as np
import pytest
import torch

from graphvite_tpu_torch.ops import gather, scatter, steps
from graphvite_tpu_torch.optim import Optimizer


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


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
    if dtype == torch.float32:
        mag = scatter.scatter_add_plain(table.abs(), ids, upd.abs())
        assert bool((err <= 1e-6 * mag).all())
    else:
        assert bool((err <= _bf16_ulp(want)).all())


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
