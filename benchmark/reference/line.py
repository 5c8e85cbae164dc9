"""Plain reference of LINE on the walk route over W workers (GraphVite's
line_friendster.yaml job on its walks engine): every worker draws its own
walks of `random_walk_length` steps from uniformly drawn directed edges
and its own negative pool; every pair (w_i, w_{i+k}) for 0 < |k| <=
augmentation_step of an undirected graph trains as reference/deepwalk.py
states the objective, with SGD and weight decay, with two rules of the
engine:

* the rows: vertices are dealt to W partitions by degree (descending,
  ties by id, index i to bucket min(i mod 2W, 2W - 1 - i mod 2W)); a
  worker's N requests (its walk positions, then its pool slots, in that
  order) go to their owners, and an owner serves each worker at most C
  of them, C = min(N, max(ceil(N max(slack / W, 1.3 s_max)), 8)), s_max
  the largest partition's share of the degrees; requests past C are
  dropped. A pair trains only if both its rows arrived; a pool slot that
  did not is left out of the negatives and of the update;
* the trust radius: each pool slot's gradient is scaled down to at most
  trust (||c_m|| + 0.01) / lr.

A round is one batch on every worker, all reading the tables as they
were at the round's start; the owners add every worker's update.
`negative_weight`, `num_negative` and the pool act as in deepwalk.py.
The loss of a worker-batch is the mean over its trained pairs, divided
by 1 + K negative_weight.

The walks, the pair flags, the pools and the dropped requests are the
program's: `check_sampler` judges them; `follow` follows the program's
first rounds from the initial tables that benchmark.init draws, and
`follow_window` one round of a window call from the program's rows
before it. A graph of billions of edges is read in chunks, on the
device of the recorded tensors.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from benchmark import init
from benchmark.reference import common, deepwalk

CHUNK = 1 << 27        # edges read at a time


def _chunks(a, device):
    for s in range(0, a.size, CHUNK):
        yield torch.as_tensor(np.ascontiguousarray(a[s:s + CHUNK]),
                              device=device).long()


def degrees(edges, num_vertex, device):
    """Degree of every vertex in the symmetrized graph (int64)."""
    deg = torch.zeros(num_vertex, dtype=torch.long, device=device)
    for a in edges:
        for c in _chunks(a, device):
            deg += torch.bincount(c, minlength=num_vertex)
    return deg


def partition(deg, workers):
    """(owner of every vertex, s_max): the degree-dealt partition."""
    order = torch.sort(-deg, stable=True).indices
    slot = torch.arange(deg.numel(), device=deg.device) % (2 * workers)
    owner = torch.empty_like(deg)
    owner[order] = torch.minimum(slot, 2 * workers - 1 - slot)
    mass = torch.zeros(workers, dtype=torch.float64, device=deg.device)
    mass.index_add_(0, owner, deg.double())
    return owner, float(mass.max() / mass.sum().clamp(min=1e-12))


def capacity(n, workers, slack, s_max):
    return int(min(n, max(int(np.ceil(n * max(slack / workers,
                                               1.3 * s_max))), 8)))


def arrived(ids, owner, workers, cap):
    """[N] whether each request (in order) is within its owner's first
    `cap` requests of this worker."""
    o = owner[ids]
    rank = torch.zeros_like(ids)
    for p in range(workers):
        sel = o == p
        rank[sel] = torch.cumsum(sel.long(), 0)[sel] - 1
    return rank < cap


class Engine:
    """What the rounds need of the graph: degrees, owners, capacity."""

    def __init__(self, cfg, edges, device, shape):
        self.cfg = cfg
        V = int(cfg["dataset"]["num_vertex"])
        self.workers = int(cfg["mesh"]["num_worker"])
        self.deg = degrees(edges, V, device)
        self.owner, s_max = partition(self.deg, self.workers)
        (bw, l1), (g, m) = shape
        self.cap = capacity(bw * l1 + g * m, self.workers,
                            float(cfg["mesh"]["route_slack"]), s_max)

    def arrived(self, chain, pool):
        ids = torch.cat([chain.reshape(-1), pool.reshape(-1)]).long()
        return arrived(ids, self.owner, self.workers, self.cap)


def engine(cfg, edges, rounds):
    rec = rounds[0]
    return Engine(cfg, edges, rec["chains"][0].device,
                  (tuple(rec["chains"][0].shape), tuple(rec["pools"][0].shape)))


def _edge_found(queries, edges, num_vertex):
    """[Q] whether each directed pair (a, b) of `queries` [Q, 2] is an
    edge of the graph, found by one pass over the edge list."""
    V = num_vertex
    keys = queries[:, 0] * V + queries[:, 1]
    sk, order = torch.sort(keys)
    found = torch.zeros_like(sk, dtype=torch.bool)
    u, v = edges
    for cu, cv in zip(_chunks(u, keys.device), _chunks(v, keys.device)):
        for k in (cu * V + cv, cv * V + cu):
            pos = torch.searchsorted(sk, k).clamp(max=sk.numel() - 1)
            hit = sk[pos] == k
            found[pos[hit]] = True
    # equal queries share the first position's answer
    first = torch.searchsorted(sk, sk)
    out = torch.empty_like(found)
    out[order] = found[first]
    return out


def check_sampler(cfg, edges, rounds):
    """The program's walks, pools and dropped requests, judged: walk steps
    that are not edges, pair flags that differ from the walks' own, ids
    out of range, dropped requests that differ from the rule's (per
    worker-batch), and |z| of the mean log degree of the walks' first
    vertices and of the pools."""
    V = int(cfg["dataset"]["num_vertex"])
    aug = int(cfg["train"]["augmentation_step"])
    eng = engine(cfg, edges, rounds)
    deg = eng.deg
    mask_diff = out_of_range = drop_diff = 0
    steps, starts, pools = [], [], []
    for rec in rounds:
        for chain, mask, pool, drops in zip(rec["chains"], rec["masks"],
                                            rec["pools"], rec["drops"]):
            chain, pool = chain.long(), pool.long()
            out_of_range += int(((chain < 0) | (chain >= V)).sum()
                                + ((pool < 0) | (pool >= V)).sum())
            chain, pool = chain.clamp(0, V - 1), pool.clamp(0, V - 1)
            want = deepwalk.pair_mask(chain, deg, aug)
            mask_diff += int((want != (mask > 0)).sum())
            step_ok = want[..., 0][:, :-1]       # position i+1 reached
            steps.append(torch.stack([chain[:, :-1][step_ok],
                                      chain[:, 1:][step_ok]], dim=1))
            got = eng.arrived(chain, pool)
            drop_diff += abs(int((~got).sum()) - int(drops))
            starts.append(chain[:, 0])
            pools.append(pool.reshape(-1))
    bad_edges = int((~_edge_found(torch.cat(steps), edges, V)).sum())
    logd = torch.log(deg.double().clamp(min=1))
    has = deg > 0
    m0, v0 = common.weighted_moments(logd[has], deg[has].double())
    mp, vp = common.weighted_moments(logd[has], deg[has].double() ** 0.75)
    return {"walk_bad_edges": bad_edges, "pair_mask_diff": mask_diff,
            "ids_out_of_range": out_of_range, "row_drop_diff": drop_diff,
            "walk_start_z": common.z_of_mean(logd[torch.cat(starts)], m0,
                                             v0),
            "pool_z": common.z_of_mean(logd[torch.cat(pools)], mp, vp)}


def worker_grads(vt, ct, chain, mask, pool, got, lr, cfg):
    """One worker-batch on the local tables vt, ct [U, D] (their dtype):
    chain [W, L1] and pool [G, M] local row ids, mask [W, L1, T] the pair
    flags, got [N] the requests that arrived. Returns (dv, dc) [U, D] and
    the loss."""
    k = int(cfg["build"]["num_negative"])
    nw = float(cfg["train"]["negative_weight"])
    wd = float(cfg["build"]["optimizer"]["weight_decay"])
    aug = int(cfg["train"]["augmentation_step"])
    trust = float(cfg["mesh"]["trust"])
    W, L1 = chain.shape
    G, M = pool.shape
    bg, D = W // G, vt.shape[1]
    T = 2 * aug
    neg_w = nw * k / M
    fpos = got[:W * L1].reshape(W, L1)
    fpool = got[W * L1:].reshape(G, M).to(vt.dtype)
    offs = deepwalk.offsets(aug)
    # a pair trains only if both its rows arrived
    mask = mask.clone()
    for t, off in enumerate(offs):
        i = torch.arange(L1, device=chain.device)
        j = i + off
        ok = (j >= 0) & (j < L1)
        reach = torch.zeros_like(fpos)
        reach[:, i[ok]] = fpos[:, i[ok]] & fpos[:, j[ok]]
        mask[..., t] = mask[..., t] * reach
    heads, tails = [], []
    for t, off in enumerate(offs):
        i = torch.arange(L1, device=chain.device)
        j = i + off
        ok = (j >= 0) & (j < L1)
        m = mask[:, i[ok], t] > 0
        heads.append(chain[:, i[ok]][m])
        tails.append(chain[:, j[ok]][m])
    h, t = torch.cat(heads), torch.cat(tails)
    v, c = vt[h], ct[t]
    pos = (v * c).sum(dim=-1)
    gpos = torch.sigmoid(pos) - 1
    cnt = mask.sum(dim=-1).to(vt.dtype).reshape(G, bg * L1, 1)
    vg = vt[chain].reshape(G, bg * L1, D)
    P = ct[pool] * fpool[..., None]                      # [G, M, D]
    neg = torch.bmm(vg, P.transpose(1, 2))              # [G, bg*L1, M]
    gneg = neg_w * torch.sigmoid(neg) * cnt * fpool[:, None, :]
    sp = torch.nn.functional.softplus(neg) * fpool[:, None, :]
    loss = ((torch.nn.functional.softplus(-pos).double().sum()
             + (cnt * neg_w * sp).double().sum())
            / max(h.numel(), 1) / (1 + k * nw))
    dv = torch.zeros_like(vt)
    dc = torch.zeros_like(ct)
    dv.index_add_(0, h, gpos[:, None] * c + (wd * (1 + k * nw)) * v)
    dc.index_add_(0, t, gpos[:, None] * v + wd * c)
    dv.index_add_(0, chain.reshape(-1), torch.bmm(gneg, P).reshape(-1, D))
    dp = (torch.bmm(gneg.transpose(1, 2), vg)
          + (wd * neg_w * bg * L1 * T) * P)
    # the trust radius of a pool slot's gradient
    limit = trust * (torch.linalg.vector_norm(P, dim=-1, keepdim=True)
                     + 1e-2) / max(lr, 1e-15)
    norm = torch.linalg.vector_norm(dp, dim=-1, keepdim=True)
    dp = dp * torch.clamp(limit / torch.clamp(norm, min=1e-15), max=1.0)
    dp = dp * fpool[..., None]
    dc.index_add_(0, pool.reshape(-1), dp.reshape(-1, D))
    return dv, dc, float(loss)


def round_step(vt, ct, local, rec, got, lr, cfg, deg):
    """One round on the local tables: every worker's gradients at the
    round's start, added. `local` maps the round's ids to local rows."""
    aug = int(cfg["train"]["augmentation_step"])
    V = int(cfg["dataset"]["num_vertex"])
    dv_all = torch.zeros_like(vt)
    dc_all = torch.zeros_like(ct)
    losses = []
    for w, (chain, pool) in enumerate(zip(rec["chains"], rec["pools"])):
        chain = chain.long().clamp(0, V - 1)
        mask = deepwalk.pair_mask(chain, deg, aug).to(vt.dtype)
        lc = local(chain)
        lp = local(pool.long().clamp(0, V - 1))
        dv, dc, loss = worker_grads(vt, ct, lc, mask, lp, got[w], lr, cfg)
        dv_all += dv
        dc_all += dc
        losses.append(loss)
    return vt - lr * dv_all, ct - lr * dc_all, losses


def _round_ids(rec):
    return torch.cat([torch.cat([c.reshape(-1), p.reshape(-1)]).long()
                      for c, p in zip(rec["chains"], rec["pools"])])


def follow(cfg, seed, edges, rounds, calls, dtype):
    """Follow the program's first rounds on its walks and pools, from the
    initial tables, with tables and arithmetic in `dtype`. Readings
    {"losses" (per worker-batch), "grad_norms", "change_norms"} (per
    table: vertex, context)."""
    V = int(cfg["dataset"]["num_vertex"])
    W = int(cfg["mesh"]["num_worker"])
    eng = engine(cfg, edges, rounds)
    ids = torch.cat([_round_ids(r) for r in rounds]).clamp(0, V - 1)
    rows = torch.unique(ids)
    start = [init.rows_of(cfg, i, seed, rows) for i in range(2)]
    vt, ct = (x.to(dtype) for x in start)

    def local(x):
        return torch.searchsorted(rows, x)

    # the engine's schedule: every worker of a round at its first batch id
    lrs = common.schedule(calls, cfg["build"]["optimizer"]["lr"])[::W]
    losses, after_one = [], None
    for rec, lr in zip(rounds, lrs):
        got = [eng.arrived(c.long().clamp(0, V - 1),
                           p.long().clamp(0, V - 1))
               for c, p in zip(rec["chains"], rec["pools"])]
        vt, ct, ls = round_step(vt, ct, local, rec, got, lr, cfg, eng.deg)
        losses += ls
        if after_one is None:
            after_one = (vt.float(), ct.float())
    grads, changes = common.state_readings(start, after_one,
                                           (vt.float(), ct.float()), lrs[0])
    return {"losses": losses, "grad_norms": grads, "change_norms": changes}


def follow_window(cfg, edges, rec, dtype):
    """One round of a window call, the program's recorded round, from the
    program's rows before it, in `dtype`. Readings {"losses" (per
    worker-batch), "grad_norms"} (vertex, context)."""
    V = int(cfg["dataset"]["num_vertex"])
    eng = engine(cfg, edges, [rec])
    inv, vt = common.local_rows(rec["ids"], rec["before"][0])
    _, ct = common.local_rows(rec["ids"], rec["before"][1])
    rows = torch.unique(rec["ids"])

    def local(x):
        return torch.searchsorted(rows, x)

    got = [eng.arrived(c.long().clamp(0, V - 1), p.long().clamp(0, V - 1))
           for c, p in zip(rec["chains"], rec["pools"])]
    nv, nc, losses = round_step(vt.to(dtype), ct.to(dtype), local, rec, got,
                                rec["lr"], cfg, eng.deg)
    return {"losses": losses,
            "grad_norms": common.step_norms(
                (vt, ct), (nv.float(), nc.float()), rec["lr"])}


def window_gaps(program, reference):
    """The window round's worst relative loss gap over its worker-batches
    and its worst table's gradient gap, against that table's reference
    norm."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(program["losses"],
                                                       reference["losses"]))
    grad_gap = max(abs(a - b) / b if b > 0 else
                   (0.0 if a == 0 else math.inf)
                   for a, b in zip(program["grad_norms"],
                                   reference["grad_norms"]))
    return {"window_loss_gap": loss_gap, "window_grad_gap": grad_gap}
