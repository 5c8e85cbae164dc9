"""The pooled RotatE body's wrapper (ops/rotate_pool.py) on the CPU: its
plain path, its input checks, and the Python around the kernels (the
unpacking of their output layout), held to the plain version through an
emulation of the kernels' arithmetic in their own layout. The kernels
themselves run only on a card (tests/test_torch_cuda.py).

Tolerances: the emulation sums in another order than the plain version
(per slice of 64 candidates, then the slices), float32: rtol 1e-5, atol
1e-6."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from graphvite_tpu_torch.models import KG_MODELS
from graphvite_tpu_torch.ops import rotate_pool, steps
from graphvite_tpu_torch.optim import Optimizer
from graphvite_tpu_torch.utils.common import EPSILON


def _inputs(G, Bg, M, Dh, seed=0):
    rng = np.random.default_rng(seed)

    def f(*shape):
        return torch.as_tensor((rng.normal(size=shape) * 0.3)
                               .astype(np.float32))
    return [f(G, Bg, Dh) for _ in range(4)] + [f(G, M, Dh) for _ in range(2)]


def _fixed_outs(gn, seen=None):
    """An `outs` that records the logits it gets and returns a fixed gn."""
    def outs(logits):
        if seen is not None:
            seen.append(logits)
        loss = F.softplus(logits).sum(dim=-1)
        return torch.ones_like(logits), loss, gn
    return outs


def _kernel_layout(u_re, u_im, w_re, w_im, c_re, c_im, gn, need_sq):
    """What csrc/rotate_pool.cu's pool_grads writes, computed per slice of
    rotate_pool.SLICE candidates with d' = c - f and the side's sign on
    the finished E and B sums."""
    G, Bg, Dh = u_re.shape
    M2 = c_re.shape[1] // 2
    slices = -(-M2 // rotate_pool.SLICE)
    qe, qb = (5, 4) if need_sq else (2, 2)
    e_out = torch.full((qe, slices, 2, G, Bg, Dh), float("nan"))
    b_out = torch.full((qb, G, 2 * M2, Dh), float("nan"))
    for side, (fr, fi) in enumerate(((u_re, u_im), (w_re, w_im))):
        sign = -1.0 if side else 1.0
        for p in range(slices):
            lo = p * rotate_pool.SLICE
            cols = slice(side * M2 + lo,
                         side * M2 + min(lo + rotate_pool.SLICE, M2))
            dr = c_re[:, None, cols] - fr[:, :, None]
            di = c_im[:, None, cols] - fi[:, :, None]
            r = torch.rsqrt(torch.clamp(dr * dr + di * di,
                                        min=EPSILON * EPSILON))
            a = gn[:, :, cols, None] * r
            zr, zi = a * dr, a * di
            e_out[0, p, side] = sign * zr.sum(dim=2)
            e_out[1, p, side] = sign * zi.sum(dim=2)
            b_out[0, :, cols] = sign * zr.sum(dim=1)
            b_out[1, :, cols] = sign * zi.sum(dim=1)
            if need_sq:
                e_out[2, p, side] = (zr * zr).sum(dim=2)
                e_out[3, p, side] = (zi * zi).sum(dim=2)
                e_out[4, p, side] = (zr * zi).sum(dim=2)
                b_out[2, :, cols] = (zr * zr).sum(dim=1)
                b_out[3, :, cols] = (zi * zi).sum(dim=1)
    return e_out, b_out


@pytest.mark.parametrize("need_sq", [False, True])
@pytest.mark.parametrize("G,Bg,M,Dh", [
    (3, 7, 16, 8),       # one slice of 8 candidates a side
    (2, 5, 26, 19),      # 13 candidates a side, odd Dh
    (2, 6, 160, 12),     # 80 a side: two slices, the second of 16
])
def test_unpacked_kernel_layout_matches_plain_sums(G, Bg, M, Dh, need_sq):
    x = _inputs(G, Bg, M, Dh)
    gn = torch.rand(G, Bg, M, generator=torch.Generator().manual_seed(1))
    loss, sh, st = rotate_pool.pool_sums_plain(*x, 6.0, _fixed_outs(gn),
                                               need_sq)
    got = rotate_pool.unpack(*_kernel_layout(*x, gn, need_sq))
    for want, have in zip((sh, st), got):
        assert sorted(want) == sorted(have)
        for key in want:
            assert have[key].shape == want[key].shape, key
            torch.testing.assert_close(have[key], want[key], rtol=1e-5,
                                       atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("rule", ["SGD", "Adam"])
def test_cpu_body_takes_the_plain_path(rule, masked, monkeypatch):
    """The RotatE step on CPU tensors goes through pool_sums_plain and
    launches nothing."""
    monkeypatch.delenv("GRAPHVITE_KG_FAST", raising=False)
    rng = np.random.default_rng(3)
    v, r, d, b, k, G, M = 50, 5, 16, 24, 4, 4, 8
    opt = Optimizer(type=rule, lr=0.05, weight_decay=0.0)
    step = steps.make_kg_pool_step(KG_MODELS["RotatE"], opt, k, 6.0, 2.0,
                                   0.5, pool_size=M, pool_groups=G)
    assert step.fast_rotate
    calls = []
    plain = rotate_pool.pool_sums_plain
    monkeypatch.setattr(rotate_pool, "pool_sums_plain",
                        lambda *a: (calls.append(1), plain(*a))[1])
    t = torch.as_tensor
    state = {"tables": (t(rng.normal(size=(v, d)).astype(np.float32)),
                        t(rng.normal(size=(r, d)).astype(np.float32))),
             "moments": tuple(tuple(torch.zeros(n, d)
                                    for _ in range(opt.num_moment))
                              for n in (v, r))}
    mask = t((rng.random(b) > 0.3).astype(np.float32)) if masked else None
    before = rotate_pool.pool_sums.launches
    new, loss = step(state, t(rng.integers(0, v, b)),
                     t(rng.integers(0, v, b)), t(rng.integers(0, r, b)),
                     opt.lr, mask=mask, negatives=t(rng.integers(0, v, (G, M))))
    assert rotate_pool.pool_sums.launches == before == 0
    assert len(calls) == 1           # one pass holds these 4 groups
    assert torch.isfinite(loss) and all(torch.isfinite(x).all()
                                        for x in new["tables"])


def _bad_inputs(case):
    x = _inputs(2, 5, 8, 12)
    if case == "float64":
        x[2] = x[2].double()
    elif case == "bfloat16 candidates":
        x[4] = x[4].bfloat16()
    elif case == "non-contiguous frame":
        x[1] = x[1].transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "non-contiguous candidates":
        x[5] = torch.cat([x[5], x[5]], dim=2)[..., ::2]
    elif case == "frames differ":
        x[3] = x[3][:, :4].contiguous()
    elif case == "candidate width":
        x[4], x[5] = x[4][..., :8].contiguous(), x[5][..., :8].contiguous()
    elif case == "odd pool":
        x[4], x[5] = x[4][:, :7].contiguous(), x[5][:, :7].contiguous()
    elif case == "candidate groups":
        x[4], x[5] = x[4][:1].contiguous(), x[5][:1].contiguous()
    elif case == "no samples":
        x[:4] = [t[:, :0] for t in x[:4]]
    elif case == "two-dimensional":
        x[:4] = [t.reshape(10, 12) for t in x[:4]]
    return x


@pytest.mark.parametrize("case", [
    "float64", "bfloat16 candidates", "non-contiguous frame",
    "non-contiguous candidates", "frames differ", "candidate width",
    "odd pool", "candidate groups", "no samples", "two-dimensional"])
def test_wrapper_raises_before_any_launch(case):
    x = _bad_inputs(case)
    called = []
    before = rotate_pool.pool_sums.launches
    for fn in (rotate_pool.pool_sums, rotate_pool.pool_sums_plain):
        with pytest.raises((TypeError, ValueError)):
            fn(*x, 6.0, lambda lg: called.append(lg), False)
    assert rotate_pool.pool_sums.launches == before
    assert not called


def test_cpu_wrapper_is_the_plain_version():
    """pool_sums on CPU tensors gives the plain version's bits."""
    x = _inputs(2, 9, 20, 10, seed=5)
    gn = torch.rand(2, 9, 20, generator=torch.Generator().manual_seed(2))
    a = rotate_pool.pool_sums(*x, 4.0, _fixed_outs(gn), True)
    b = rotate_pool.pool_sums_plain(*x, 4.0, _fixed_outs(gn), True)
    assert torch.equal(a[0], b[0])
    for s, t in zip(a[1:], b[1:]):
        assert all(torch.equal(s[key], t[key]) for key in t)
