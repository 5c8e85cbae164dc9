"""Plain reference of RotatE with self-adversarial negatives (GraphVite's
rotate_*.yaml jobs) on shared candidate pools.

Rows hold dim/2 complex numbers, interleaved (re, im); a relation row
holds dim/2 phases in its first half (its second half is unused). The
score is margin - sum_i |h_i e^{i phi_i} - t_i|. A batch of B triplets is
split into G groups that share a pool of M candidate entities: the first
M/2 score as corrupted heads, score(c, t, r), the rest as corrupted tails,
score(h, c, r). Per triplet the loss is

    softplus(-s) + sum_m w_m softplus(l_m),
    w = min(softmax(l / adversarial_temperature), 1), held constant,

and the reported loss is its batch mean halved. SGD sums the per-triplet
gradients per row at the batch's starting point; a candidate slot's
gradient (summed over its group) is first clipped to
trust * (|c| + 1e-2) / lr, and relation rows move by lr times
relation_lr_multiplier.

The triplets and the candidates are the program's draws: `check_sampler`
judges the triplets, and the reference follows the program's steps on
them: the first steps from the initial tables that benchmark.init draws
(`follow`), and one step of a window call from the program's rows
before it (`follow_window`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark import init
from benchmark.reference import common

TRUST = 0.25


def triplet_keys(cfg, heads, rels, tails):
    V = int(cfg["dataset"]["num_vertex"])
    R = int(cfg["dataset"]["num_relation"])
    return (heads.long() * R + rels.long()) * V + tails.long()


def check_sampler(cfg, graph, steps):
    """The program's positive triplets, judged: triplets that are not in
    the graph, ids out of range, and |z| of their mean rank in the sorted
    triplet list (uniform draws from the list: mean 1/2)."""
    V = int(cfg["dataset"]["num_vertex"])
    R = int(cfg["dataset"]["num_relation"])
    dev = steps[0]["heads"].device
    h, t, r = (torch.as_tensor(a, device=dev) for a in graph)
    keys = torch.sort(triplet_keys(cfg, h, r, t)).values
    E = keys.numel()
    missing = out_of_range = 0
    ranks = []
    for s in steps:
        sh, st, sr = (s[k].long() for k in ("heads", "tails", "rels"))
        out_of_range += int(((sh < 0) | (sh >= V) | (st < 0) | (st >= V)
                             | (sr < 0) | (sr >= R)).sum())
        k = triplet_keys(cfg, sh.clamp(0, V - 1), sr.clamp(0, R - 1),
                         st.clamp(0, V - 1))
        lo = torch.searchsorted(keys, k)
        hi = torch.searchsorted(keys, k, right=True)
        missing += int((hi == lo).sum())
        ranks.append((lo + hi - 1).double() / 2 / max(E - 1, 1))
    return {"triplets_missing": missing, "ids_out_of_range": out_of_range,
            "triplet_rank_z": common.z_of_mean(torch.cat(ranks), 0.5,
                                               1.0 / 12)}


def _cplx(x):
    return x[..., 0::2], x[..., 1::2]


def _interleave(re, im):
    return torch.stack([re, im], dim=-1).reshape(re.shape[:-1] + (-1,))


def sgd_step(et, rt, heads, tails, rels, cand, lr, cfg):
    """One batch on the local tables et [Ue, D], rt [Ur, D] (in their own
    dtype); heads, tails, rels [B] and cand [G, M] are local row ids.
    Returns the new tables and the batch's loss."""
    margin = float(cfg["train"]["margin"])
    temp = float(cfg["train"]["adversarial_temperature"])
    rel_mult = float(cfg["train"].get("relation_lr_multiplier", 1.0))
    G, M = cand.shape
    B = heads.numel()
    bg, M2, Dh = B // G, M // 2, et.shape[1] // 2
    de, dr = torch.zeros_like(et), torch.zeros_like(rt)
    loss_sum = 0.0
    for g in range(G):
        sl = slice(g * bg, (g + 1) * bg)
        hr, hi = _cplx(et[heads[sl]])                    # [bg, Dh]
        tr, ti = _cplx(et[tails[sl]])
        phi = rt[rels[sl], :Dh]
        cos, sin = torch.cos(phi), torch.sin(phi)
        crow = et[cand[g]]
        cr, ci = _cplx(crow)                             # [M, Dh]
        wr, wi = hr * cos - hi * sin, hr * sin + hi * cos    # h e^{i phi}

        # positive: d = h e^{i phi} - t
        d_r, d_i = wr - tr, wi - ti
        dist = torch.sqrt(d_r * d_r + d_i * d_i).clamp(min=1e-30)
        s = margin - dist.sum(dim=-1)
        a = (torch.sigmoid(s) - 1)[:, None] / dist
        gh_r = -a * (d_r * cos + d_i * sin)
        gh_i = -a * (d_i * cos - d_r * sin)
        gt_r, gt_i = a * d_r, a * d_i
        gphi = -a * (d_i * wr - d_r * wi)

        # corrupted heads: d = c e^{i phi} - t
        cos3, sin3 = cos[:, None], sin[:, None]
        xr = cr[None, :M2] * cos3 - ci[None, :M2] * sin3     # [bg, M2, Dh]
        xi = cr[None, :M2] * sin3 + ci[None, :M2] * cos3
        eh_r, eh_i = xr - tr[:, None], xi - ti[:, None]
        dh = torch.sqrt(eh_r * eh_r + eh_i * eh_i).clamp(min=1e-30)
        # corrupted tails: d = h e^{i phi} - c
        et_r, et_i = wr[:, None] - cr[None, M2:], wi[:, None] - ci[None, M2:]
        dt = torch.sqrt(et_r * et_r + et_i * et_i).clamp(min=1e-30)
        logits = torch.cat([margin - dh.sum(dim=-1),
                            margin - dt.sum(dim=-1)], dim=-1)   # [bg, M]
        w = torch.clamp(torch.softmax(logits / temp, dim=-1), max=1.0)
        gn = torch.sigmoid(logits) * w

        ah = gn[:, :M2, None] / dh
        gc_r = -(ah * (eh_r * cos3 + eh_i * sin3)).sum(dim=0)  # [M2, Dh]
        gc_i = -(ah * (eh_i * cos3 - eh_r * sin3)).sum(dim=0)
        gt_r = gt_r + (ah * eh_r).sum(dim=1)
        gt_i = gt_i + (ah * eh_i).sum(dim=1)
        gphi = gphi - (ah * (eh_i * xr - eh_r * xi)).sum(dim=1)

        at = gn[:, M2:, None] / dt
        gc_r = torch.cat([gc_r, (at * et_r).sum(dim=0)])
        gc_i = torch.cat([gc_i, (at * et_i).sum(dim=0)])
        gh_r = gh_r - (at * (et_r * cos3 + et_i * sin3)).sum(dim=1)
        gh_i = gh_i - (at * (et_i * cos3 - et_r * sin3)).sum(dim=1)
        gphi = gphi - (at * (et_i * wr[:, None]
                             - et_r * wi[:, None])).sum(dim=1)

        gc = _interleave(gc_r, gc_i)                          # [M, D]
        limit = TRUST * (torch.linalg.vector_norm(crow, dim=-1) + 1e-2) / lr
        norm = torch.linalg.vector_norm(gc, dim=-1).clamp(min=1e-15)
        gc = gc * torch.clamp(limit / norm, max=1.0)[:, None]
        de.index_add_(0, cand[g], gc)
        de.index_add_(0, heads[sl], _interleave(gh_r, gh_i))
        de.index_add_(0, tails[sl], _interleave(gt_r, gt_i))
        dr.index_add_(0, rels[sl],
                      torch.cat([gphi, torch.zeros_like(gphi)], dim=-1))
        loss = F.softplus(-s) + (w * F.softplus(logits)).sum(dim=-1)
        loss_sum += float(loss.double().sum()) / 2
    return et - lr * de, rt - (lr * rel_mult) * dr, loss_sum / B


def follow(cfg, seed, steps, calls, dtype):
    """Follow the program's first steps on its triplets and the
    step's candidates, from the initial tables, with tables and
    arithmetic in `dtype`. Readings per table: entity, relation."""
    V = int(cfg["dataset"]["num_vertex"])
    R = int(cfg["dataset"]["num_relation"])
    ents = torch.cat([torch.cat([s["heads"].long(), s["tails"].long(),
                                 s["negatives"].reshape(-1).long()])
                      for s in steps]).clamp(0, V - 1)
    rels = torch.cat([s["rels"].long() for s in steps]).clamp(0, R - 1)
    erows, elocal = torch.unique(ents, return_inverse=True)
    rrows, rlocal = torch.unique(rels, return_inverse=True)
    start = [init.rows_of(cfg, 0, seed, erows),
             init.rows_of(cfg, 1, seed, rrows)]
    et, rt = (x.to(dtype) for x in start)
    lrs = common.schedule(calls, cfg["build"]["optimizer"]["lr"])
    losses, after_one = [], None
    ea = ra = 0
    for s, lr in zip(steps, lrs):
        b, m = s["heads"].numel(), s["negatives"].numel()
        h = elocal[ea:ea + b]
        t = elocal[ea + b:ea + 2 * b]
        c = elocal[ea + 2 * b:ea + 2 * b + m].reshape(s["negatives"].shape)
        r = rlocal[ra:ra + b]
        ea, ra = ea + 2 * b + m, ra + b
        et, rt, loss = sgd_step(et, rt, h, t, r, c, lr, cfg)
        losses.append(loss)
        if after_one is None:
            after_one = (et.float(), rt.float())
    grads, changes = common.state_readings(start, after_one,
                                           (et.float(), rt.float()), lrs[0])
    return {"losses": losses, "grad_norms": grads, "change_norms": changes}


def follow_window(cfg, rec, dtype):
    """One step of a window call, the program's recorded step, from the
    program's rows before it (the state after the calls before), in
    `dtype`. Readings {"losses", "grad_norms"} (entity, relation)."""
    b = rec["heads"].numel()
    einv, et = common.local_rows(rec["ids"][0], rec["before"][0])
    rinv, rt = common.local_rows(rec["ids"][1], rec["before"][1])
    c = einv[2 * b:].reshape(rec["negatives"].shape)
    ne, nr, loss = sgd_step(et.to(dtype), rt.to(dtype), einv[:b],
                            einv[b:2 * b], rinv, c, rec["lr"], cfg)
    return {"losses": [loss],
            "grad_norms": common.step_norms(
                (et, rt), (ne.float(), nr.float()), rec["lr"])}
