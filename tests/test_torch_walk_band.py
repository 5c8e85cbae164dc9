"""The banded core's positive band (ops/walk_band.py) on the CPU: the SGD
core, which takes `walk_band` (its plain version here), against the same
core's per-offset band, which the moment rules keep, and against the JAX
package's core, on walks with dead ends, dead slots inside walks and walk
ends, with and without weight decay and a pool mask. v and c go in as the
strided halves of one [B, L1, 2D] gather, as the fused step passes them.

Tolerances: the two port paths add the same float32 terms in the same
order but for the logits' sums over the columns and the loss's over the
positions, so dv, dc, dP and the loss within rtol 1e-5, atol 1e-5 (a few
float32 ulps of terms up to ~10); the counts are sums of 0/1 flags, so
exact. Against the JAX core, the CPU tests' steps tolerances (loss
rtol 2e-5; the rest rtol 3e-4, atol 3e-6), the atol scaled by the
array's largest magnitude where that passes 1: dP sums 164-328 terms of
up to ~70 in another order than the reference's einsum."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphvite_tpu.ops.steps as ref
import graphvite_tpu.optim as ref_optim
import graphvite_tpu_torch.ops.steps as port
import graphvite_tpu_torch.optim as port_optim
from graphvite_tpu_torch.ops import walk_band
from graphvite_tpu_torch.ops.device_sampler import (emit_walk_banded,
                                                    walk_offsets)

PATH_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_TOL = dict(rtol=2e-5)
TABLE_TOL = dict(rtol=3e-4, atol=3e-6)
W, L1, G, M, K, NW, LR = 8, 41, 2, 16, 1, 5.0, 0.025
EXACT = ("cnt", "cntc", "n_active")


def _inputs(T, D, pool_mask, seed=0):
    """rows [W, L1, 2D] (v, c its halves), pool rows, the pair flags of
    walks that die early with slots dropped inside them (a pair trains
    only if both its rows are there, as the walks engine's mask), and a
    pool mask or None."""
    rng = np.random.default_rng(seed)
    alive = rng.random((L1, W)) > 0.03
    alive[:2] = True
    valid = torch.as_tensor(np.cumprod(alive, axis=0) > 0)
    chain = torch.zeros((L1, W), dtype=torch.int64)
    _, mask = emit_walk_banded(chain, valid, T // 2, bidir=True)
    here = torch.as_tensor(rng.random((W, L1)) > 0.1, dtype=torch.float32)
    shifted = [torch.cat([here[:, k:], torch.zeros(W, k)], 1) if k > 0
               else torch.cat([torch.zeros(W, -k), here[:, :k]], 1)
               for k in walk_offsets(T // 2, True)]
    mask = mask * here[..., None] * torch.stack(shifted, -1)
    rows = torch.as_tensor(rng.normal(size=(W, L1, 2 * D)), dtype=torch.float32)
    P = torch.as_tensor(rng.normal(size=(G, M, D)), dtype=torch.float32)
    pm = (torch.as_tensor(rng.random((G, M)) > 0.25, dtype=torch.float32)
          if pool_mask else None)
    return rows, P, mask.contiguous(), pm


def _core(pkg, rule, T, wd):
    opt = (ref_optim if pkg is ref else port_optim).Optimizer(
        type=rule, lr=LR, weight_decay=wd)
    core, shape = pkg.make_graph_banded_core(opt, K, NW, T // 2, True, M, G,
                                             trust=None)
    return core


def _np(x):
    return np.asarray(x, dtype=np.float64)


@pytest.mark.parametrize("T", [4, 10])
@pytest.mark.parametrize("D", [96, 128])
@pytest.mark.parametrize("wd", [0.0, 0.005])
@pytest.mark.parametrize("pool_mask", [False, True])
def test_walk_band_matches_per_offset_core_and_reference(T, D, wd,
                                                         pool_mask):
    rows, P, mask, pm = _inputs(T, D, pool_mask)
    v, c = rows[..., :D], rows[..., D:]
    # walk ends: no pair past either end
    assert mask[:, -1, :T // 2].sum() == 0 == mask[:, 0, T // 2:].sum()
    assert 0 < mask.mean() < 0.9
    band = _core(port, "SGD", T, wd)(v, c, P, mask, LR, pool_mask=pm)
    per_offset = _core(port, "Adam", T, wd)(v, c, P, mask, LR, pool_mask=pm)
    want = _core(ref, "SGD", T, wd)(
        *(jnp.asarray(x.numpy()) for x in (v, c, P, mask)), LR,
        pool_mask=None if pm is None else jnp.asarray(pm.numpy()))
    assert set(band) == set(want)
    for key in want:
        if key in EXACT:
            np.testing.assert_array_equal(_np(band[key]),
                                          _np(per_offset[key]), err_msg=key)
        else:
            np.testing.assert_allclose(_np(band[key]), _np(per_offset[key]),
                                       err_msg=key, **PATH_TOL)
        tol = LOSS_TOL if key == "loss_sum" else dict(
            rtol=TABLE_TOL["rtol"],
            atol=TABLE_TOL["atol"] * max(1.0, np.abs(_np(want[key])).max()))
        np.testing.assert_allclose(_np(band[key]), _np(want[key]),
                                   err_msg=key, **tol)
    # the band's own outputs: the core passes dc, cnt and cntc on as they
    # are; each walk's pair count
    offs = walk_offsets(T // 2, True)
    neg_w = NW * K / M
    _, dc, cnt, cntc, sums = walk_band.walk_band_plain(
        v, c, mask, offs, wd, wd * (1.0 + M * neg_w))
    assert torch.equal(dc, band["dc"])
    assert torch.equal(cnt, band["cnt"]) and torch.equal(cntc, band["cntc"])
    assert torch.equal(sums[:, 1], mask.sum((1, 2)))


@pytest.mark.parametrize("rule", ["SGD", "Adam"])
@pytest.mark.parametrize("bf16_band", [False, True])
def test_core_takes_walk_band_on_sgd_only(rule, bf16_band, monkeypatch):
    """The SGD core calls `walk_band` once a call; a moment rule's core
    never does. With GRAPHVITE_BF16_BAND on bf16-valued rows both paths
    round each product to bf16 before the logit's sum, and agree."""
    calls = []
    plain = walk_band.walk_band

    def spy(*args):
        calls.append(args[-1])
        return plain(*args)

    monkeypatch.setattr(walk_band, "walk_band", spy)
    monkeypatch.setenv("GRAPHVITE_BF16_BAND", "1" if bf16_band else "0")
    T, D = 4, 96
    rows, P, mask, _ = _inputs(T, D, False, seed=1)
    rows = rows.bfloat16().float()
    v, c = rows[..., :D], rows[..., D:]
    got = _core(port, rule, T, 0.005)(v, c, P, mask, LR, table_bf16=True)
    assert calls == ([bf16_band] if rule == "SGD" else [])
    if rule == "SGD":
        other = _core(port, "Adam", T, 0.005)(v, c, P, mask, LR,
                                               table_bf16=True)
        for key in ("dv", "dc", "loss_sum"):
            np.testing.assert_allclose(_np(got[key]), _np(other[key]),
                                       err_msg=key, **PATH_TOL)


@pytest.mark.parametrize("case", ["dtype", "device", "columns", "mask",
                                  "shape", "offsets"])
def test_walk_band_refuses_what_the_kernel_does_not_take(case):
    """The checks the wrapper makes before a launch raise; a tensor on
    neither the CPU nor CUDA is refused whole."""
    T, D = 4, 8
    rows, _, mask, _ = _inputs(T, D, False)
    v, c = rows[..., :D], rows[..., D:]
    offs = tuple(walk_offsets(T // 2, True))
    walk_band._check(v, c, mask, offs)
    if case == "device":
        with pytest.raises(ValueError, match="CUDA or CPU"):
            walk_band.walk_band(v.to("meta"), c.to("meta"),
                                mask.to("meta"), offs, 0.0, 0.0)
        return
    if case == "dtype":
        v = v.double()
    elif case == "columns":
        v = rows[..., ::2]
    elif case == "mask":
        mask = mask.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "shape":
        c = c[:, :-1]
    else:
        offs = tuple(range(1, walk_band.MAX_OFFSETS + 2))
        mask = torch.zeros(W, L1, len(offs))
    with pytest.raises((TypeError, ValueError)):
        walk_band._check(v, c, mask, offs)
