"""Tests of the port that need an NVIDIA GPU (marked `cuda`; each skips
where torch sees no card). This file imports neither JAX nor the JAX
package, so it also runs on a host without them:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerances: float32 results within rtol 1e-6 of the magnitude of the terms
summed (orders differ); bfloat16 within 1 bf16 ulp (both versions round
one float32 sum once); the fused step as the CPU tests hold the port to
the reference (loss rtol 2e-5; tables rtol 3e-4, atol 3e-6)."""
import numpy as np
import pytest
import torch

from graphvite_tpu_torch.ops import scatter, steps
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
