"""The plain references against a float64 computation by hand (explicit
loops over pairs, gradients by autograd) at a tiny size."""
import pytest
import torch
import torch.nn.functional as F

from benchmark.reference import deepwalk, rotate


def dw_cfg(aug=2, k=1, nw=5.0, wd=0.005):
    return {"build": {"num_negative": k,
                      "optimizer": {"weight_decay": wd}},
            "train": {"negative_weight": nw, "augmentation_step": aug}}


def test_deepwalk_step_against_a_hand_computation():
    g = torch.Generator().manual_seed(0)
    U, D, W, L1, G, M, aug = 9, 6, 4, 5, 2, 3, 2
    cfg = dw_cfg(aug)
    vt = torch.randn(U, D, generator=g, dtype=torch.float64) * 0.3
    ct = torch.randn(U, D, generator=g, dtype=torch.float64) * 0.3
    chain = torch.randint(0, U, (W, L1), generator=g)
    pool = torch.randint(0, U, (G, M), generator=g)
    deg = torch.ones(U, dtype=torch.long)
    mask = deepwalk.pair_mask(chain, deg, aug)
    mask[1, 2, 0] = False                       # a dropped pair
    lr = 0.05
    new_v, new_c, loss = deepwalk.sgd_step(vt, ct, chain, mask, pool, lr,
                                           cfg)

    k, nw, wd = 1, 5.0, 0.005
    neg_w, bg, T = nw * k / M, W // G, 2 * aug
    v = vt.clone().requires_grad_()
    c = ct.clone().requires_grad_()
    total = torch.zeros((), dtype=torch.float64)
    reg = torch.zeros((), dtype=torch.float64)
    pairs = 0
    for w in range(W):
        grp = w // bg
        for i in range(L1):
            for t, off in enumerate(deepwalk.offsets(aug)):
                j = i + off
                if not (0 <= j < L1) or not mask[w, i, t]:
                    continue
                pairs += 1
                h, tl = chain[w, i], chain[w, j]
                total = total + F.softplus(-(v[h] * c[tl]).sum())
                for m in range(M):
                    total = total + neg_w * F.softplus(
                        (v[h] * c[pool[grp, m]]).sum())
                reg = reg + (wd * (1 + k * nw) / 2 * (v[h] ** 2).sum()
                             + wd / 2 * (c[tl] ** 2).sum())
    for grp in range(G):
        for m in range(M):
            reg = reg + (wd * neg_w * bg * L1 * T / 2
                         * (c[pool[grp, m]] ** 2).sum())
    (total + reg).backward()
    assert abs(loss - float(total.detach()) / pairs / (1 + k * nw)) < 1e-12
    assert torch.allclose(new_v, vt - lr * v.grad, rtol=0, atol=1e-13)
    assert torch.allclose(new_c, ct - lr * c.grad, rtol=0, atol=1e-13)


def rotate_cfg():
    return {"train": {"margin": 2.0, "adversarial_temperature": 0.5,
                      "relation_lr_multiplier": 0.7}}


def test_rotate_step_against_a_hand_computation():
    g = torch.Generator().manual_seed(1)
    Ue, Ur, D, B, G, M = 10, 3, 8, 4, 2, 4
    et = torch.randn(Ue, D, generator=g, dtype=torch.float64) * 0.4
    rt = torch.rand(Ur, D, generator=g, dtype=torch.float64) * 6 - 3
    heads = torch.randint(0, Ue, (B,), generator=g)
    tails = torch.randint(0, Ue, (B,), generator=g)
    rels = torch.randint(0, Ur, (B,), generator=g)
    cand = torch.randint(0, Ue, (G, M), generator=g)
    lr, cfg = 1e-3, rotate_cfg()          # the candidate clip stays open
    new_e, new_r, loss = rotate.sgd_step(et, rt, heads, tails, rels, cand,
                                         lr, cfg)

    e = et.clone().requires_grad_()
    r = rt.clone().requires_grad_()

    def cplx(x):
        return torch.complex(x[0::2], x[1::2])

    def score(h, t, phase):
        rot = torch.polar(torch.ones_like(phase), phase)
        return 2.0 - (cplx(h) * rot - cplx(t)).abs().sum()

    total = torch.zeros((), dtype=torch.float64)
    report = 0.0
    bg = B // G
    for b in range(B):
        grp = b // bg
        phase = r[rels[b], :D // 2]
        s = score(e[heads[b]], e[tails[b]], phase)
        negs = torch.stack(
            [score(e[cand[grp, m]], e[tails[b]], phase) if m < M // 2
             else score(e[heads[b]], e[cand[grp, m]], phase)
             for m in range(M)])
        w = torch.clamp(torch.softmax(negs.detach() / 0.5, dim=0), max=1.0)
        one = F.softplus(-s) + (w * F.softplus(negs)).sum()
        total = total + one
        report += float(one) / 2
    total.backward()
    assert abs(loss - report / B) < 1e-12
    assert torch.allclose(new_e, et - lr * e.grad, rtol=0, atol=1e-13)
    assert torch.allclose(new_r, rt - lr * 0.7 * r.grad, rtol=0, atol=1e-13)


def test_rotate_candidate_clip():
    # at a large learning rate a candidate slot's summed gradient is
    # clipped to 0.25 (|c| + 1e-2) / lr before its update
    g = torch.Generator().manual_seed(2)
    et = torch.randn(6, 4, generator=g, dtype=torch.float64) * 0.4
    rt = torch.rand(2, 4, generator=g, dtype=torch.float64)
    args = (torch.tensor([0, 1]), torch.tensor([2, 3]), torch.tensor([0, 1]),
            torch.tensor([[4, 5]]))
    lr = 50.0
    new_e, _, _ = rotate.sgd_step(et, rt, *args, lr, rotate_cfg())
    for row in (4, 5):
        moved = float((new_e[row] - et[row]).norm())
        assert moved <= 0.25 * (float(et[row].norm()) + 1e-2) * (1 + 1e-9)


def test_norm_gaps_against_each_leafs_own_norm():
    from benchmark.reference import common

    ref = {"losses": [2.0], "grad_norms": [1000.0, 0.1],
           "change_norms": [500.0, 1e-6]}
    got = {"losses": [2.0], "grad_norms": [1000.0, 0.101],
           "change_norms": [500.0, 1.0]}
    gaps = common.gaps(got, ref)
    # the small leaf is held to its own norm, not to the median's
    assert gaps["grad_gap"] == pytest.approx(0.01)
    # a leaf whose reference gradient is under a thousandth of the
    # median's leaves the change comparison
    assert gaps["change_gap"] == 0.0


def test_window_readings_count_each_row_once():
    from benchmark.reference import common

    ids = torch.tensor([2, 0, 2, 5])
    before = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0], [2.0, 2.0]])
    after = before + torch.tensor([[0.3, 0.4], [0.0, 0.0], [0.3, 0.4],
                                   [0.0, 1.2]])
    rec = {"ids": [ids], "before": [before], "after": [after], "lr": 0.5,
           "loss": torch.tensor(0.25)}
    got = common.window_readings(rec)
    assert got["losses"] == [0.25]
    # rows 2 (read twice) and 5 moved: sqrt(0.5 ** 2 + 1.2 ** 2) / lr
    assert got["grad_norms"] == [pytest.approx(1.3 / 0.5)]
    gaps = common.window_gaps(got, {"losses": [0.2], "grad_norms": [2.5]})
    assert gaps["window_loss_gap"] == pytest.approx(0.25)
    assert gaps["window_grad_gap"] == pytest.approx(0.04)
