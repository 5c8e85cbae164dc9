"""Plain reference of DeepWalk on the walk route (GraphVite's
deepwalk_*.yaml jobs): walks of `random_walk_length` steps from uniformly
drawn edges, every pair (w_i, w_{i+k}) for 0 < |k| <= augmentation_step
on an undirected graph, and SGD on

    softplus(-v_h . c_t) + (K * negative_weight / M) * sum_m softplus(v_h . c_m)

per valid pair (h, t), the m running over the M context rows of the
negative pool shared by the walk's group, drawn with probability
proportional to degree ** 0.75. Per touch, weight decay adds wd * v_h
(times 1 + K * negative_weight) to the head, wd * c_t to the tail and
wd * (K * negative_weight / M) * (pair slots of the group) * c_m to a
pool row: the touch counts of the shared-pool emulation of K draws per
pair. The loss is the mean over valid pairs, divided by
1 + K * negative_weight. All of a batch's updates are taken at the
batch's starting point and summed per row.

The walks and the pool are the program's random draws: this reference
judges them (`check_sampler`) and then follows the program's steps on
them: the first steps from the initial tables that benchmark.init draws
(`follow`), and one step of a window call from the program's rows
before it (`follow_window`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark import init
from benchmark.reference import common


def offsets(aug):
    return list(range(1, aug + 1)) + [-k for k in range(1, aug + 1)]


def degrees(edges, num_vertex, device):
    u, v = (torch.as_tensor(a, device=device) for a in edges)
    return torch.bincount(torch.cat([u, v]), minlength=num_vertex)


def pair_mask(chain, deg, aug):
    """[W, L1, T] validity of each (position, offset) pair: both ends
    inside the walk and reached (a walk stops at a vertex of degree 0 and
    its later positions are not valid)."""
    W, L1 = chain.shape
    alive = torch.ones((W, L1), dtype=torch.bool, device=chain.device)
    alive[:, 2:] = torch.cumprod((deg[chain[:, 1:-1]] > 0).int(), dim=1) > 0
    masks = []
    for k in offsets(aug):
        m = torch.zeros_like(alive)
        if k > 0:
            m[:, :L1 - k] = alive[:, :L1 - k] & alive[:, k:]
        else:
            m[:, -k:] = alive[:, -k:] & alive[:, :L1 + k]
        masks.append(m)
    return torch.stack(masks, dim=-1)


def check_sampler(cfg, edges, steps):
    """The program's walks and negatives, judged: walk steps that are not
    edges of the graph, pair flags that differ from the walks' own, pool
    ids out of range, and |z| of the mean log degree of the walks' first
    vertices (a uniform edge's head: degree-proportional) and of the pool
    (degree ** 0.75)."""
    V = int(cfg["dataset"]["num_vertex"])
    aug = int(cfg["train"]["augmentation_step"])
    dev = steps[0]["chain"].device
    u, v = (torch.as_tensor(a, device=dev) for a in edges)
    keys = torch.sort(torch.cat([u * V + v, v * V + u])).values
    deg = degrees(edges, V, dev)
    bad_edges = mask_diff = out_of_range = 0
    starts, pools = [], []
    for s in steps:
        chain, pool = s["chain"].long(), s["pool"].long()
        out_of_range += int(((chain < 0) | (chain >= V)).sum()
                            + ((pool < 0) | (pool >= V)).sum())
        chain, pool = chain.clamp(0, V - 1), pool.clamp(0, V - 1)
        want = pair_mask(chain, deg, aug)
        mask_diff += int((want != (s["mask"] > 0)).sum())
        step_ok = want[..., 0][:, :-1]           # position i+1 reached
        k = chain[:, :-1] * V + chain[:, 1:]
        pos = torch.searchsorted(keys, k).clamp(max=keys.numel() - 1)
        bad_edges += int(((keys[pos] != k) & step_ok).sum())
        starts.append(chain[:, 0])
        pools.append(pool.reshape(-1))
    logd = torch.log(deg.double().clamp(min=1))
    has = deg > 0
    m0, v0 = common.weighted_moments(logd[has], deg[has].double())
    mp, vp = common.weighted_moments(logd[has], deg[has].double() ** 0.75)
    return {"walk_bad_edges": bad_edges, "pair_mask_diff": mask_diff,
            "ids_out_of_range": out_of_range,
            "walk_start_z": common.z_of_mean(logd[torch.cat(starts)], m0,
                                             v0),
            "pool_z": common.z_of_mean(logd[torch.cat(pools)], mp, vp)}


def sgd_step(vt, ct, chain, mask, pool, lr, cfg):
    """One batch on the local tables vt, ct [U, D] (in their own dtype):
    chain [W, L1] and pool [G, M] are local row ids. Returns the new
    tables and the batch's loss."""
    k = int(cfg["build"]["num_negative"])
    nw = float(cfg["train"]["negative_weight"])
    wd = float(cfg["build"]["optimizer"]["weight_decay"])
    aug = int(cfg["train"]["augmentation_step"])
    W, L1 = chain.shape
    G, M = pool.shape
    bg, D = W // G, vt.shape[1]
    T = 2 * aug
    neg_w = nw * k / M
    heads, tails = [], []
    for t, off in enumerate(offsets(aug)):
        i = torch.arange(L1, device=chain.device)
        j = i + off
        ok = (j >= 0) & (j < L1)
        m = mask[:, i[ok], t]
        heads.append(chain[:, i[ok]][m])
        tails.append(chain[:, j[ok]][m])
    h, t = torch.cat(heads), torch.cat(tails)
    v, c = vt[h], ct[t]
    pos = (v * c).sum(dim=-1)
    gpos = torch.sigmoid(pos) - 1
    cnt = mask.sum(dim=-1).to(vt.dtype).reshape(G, bg * L1, 1)
    vg = vt[chain].reshape(G, bg * L1, D)
    P = ct[pool]                                         # [G, M, D]
    neg = torch.bmm(vg, P.transpose(1, 2))              # [G, bg*L1, M]
    gneg = neg_w * torch.sigmoid(neg) * cnt
    loss = ((F.softplus(-pos).double().sum()
             + (cnt * neg_w * F.softplus(neg)).double().sum())
            / h.numel() / (1 + k * nw))
    dv = torch.zeros_like(vt)
    dc = torch.zeros_like(ct)
    dv.index_add_(0, h, gpos[:, None] * c + (wd * (1 + k * nw)) * v)
    dc.index_add_(0, t, gpos[:, None] * v + wd * c)
    dv.index_add_(0, chain.reshape(-1), torch.bmm(gneg, P).reshape(-1, D))
    dp = (torch.bmm(gneg.transpose(1, 2), vg)
          + (wd * neg_w * bg * L1 * T) * P)
    dc.index_add_(0, pool.reshape(-1), dp.reshape(-1, D))
    return vt - lr * dv, ct - lr * dc, float(loss)


def follow(cfg, seed, edges, steps, calls, dtype):
    """Follow the program's first steps on its walks and pools, from the
    initial tables, with tables and arithmetic in `dtype`. Returns the
    readings {"losses", "grad_norms", "change_norms"} (per table:
    vertex, context)."""
    V = int(cfg["dataset"]["num_vertex"])
    aug = int(cfg["train"]["augmentation_step"])
    dev = steps[0]["chain"].device
    deg = degrees(edges, V, dev)
    ids = torch.cat([torch.cat([s["chain"].reshape(-1).long(),
                                s["pool"].reshape(-1).long()])
                     for s in steps]).clamp(0, V - 1)
    rows, local = torch.unique(ids, return_inverse=True)
    start = [init.rows_of(cfg, i, seed, rows) for i in range(2)]
    vt, ct = (x.to(dtype) for x in start)
    lrs = common.schedule(calls, cfg["build"]["optimizer"]["lr"])
    losses, after_one = [], None
    at = 0
    for s, lr in zip(steps, lrs):
        chain = s["chain"].long().clamp(0, V - 1)
        n, m = chain.numel(), s["pool"].numel()
        lc = local[at:at + n].reshape(chain.shape)
        lp = local[at + n:at + n + m].reshape(s["pool"].shape)
        at += n + m
        vt, ct, loss = sgd_step(vt, ct, lc, pair_mask(chain, deg, aug),
                                lp, lr, cfg)
        losses.append(loss)
        if after_one is None:
            after_one = (vt.float(), ct.float())
    grads, changes = common.state_readings(start, after_one,
                                           (vt.float(), ct.float()), lrs[0])
    return {"losses": losses, "grad_norms": grads, "change_norms": changes}


def follow_window(cfg, edges, rec, dtype):
    """One step of a window call, the program's recorded step, from the
    program's rows before it (the state after the calls before), in
    `dtype`. Readings {"losses", "grad_norms"} (vertex, context)."""
    V = int(cfg["dataset"]["num_vertex"])
    aug = int(cfg["train"]["augmentation_step"])
    chain = rec["chain"].long().clamp(0, V - 1)
    deg = degrees(edges, V, chain.device)
    inv, vt = common.local_rows(rec["ids"][0], rec["before"][0])
    _, ct = common.local_rows(rec["ids"][1], rec["before"][1])
    n = chain.numel()
    lc = inv[:n].reshape(chain.shape)
    lp = inv[n:].reshape(rec["pool"].shape)
    nv, nc, loss = sgd_step(vt.to(dtype), ct.to(dtype), lc,
                            pair_mask(chain, deg, aug), lp, rec["lr"], cfg)
    return {"losses": [loss],
            "grad_norms": common.step_norms(
                (vt, ct), (nv.float(), nc.float()), rec["lr"])}
