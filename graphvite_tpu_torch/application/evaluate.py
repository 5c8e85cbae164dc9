"""Evaluation (the port of graphvite_tpu/application/evaluate.py). Node
embedding: the linear-probe node classification runs in torch on the
solver's device, the link-prediction AUC is host numpy. Knowledge graphs:
one-vs-all scoring, streaming top-k and filtered ranking run in torch on
the device of the tables they are given (numpy tables stay on the CPU)."""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from graphvite_tpu_torch.models import KG_MODELS


def linear_classification(embeddings, labels, portion, normalization=False,
                          times=1, patience=100, seed=0, device="cpu"):
    """Frozen-embedding linear probe with the reference's protocol: per
    positive label the sample is duplicated with a one-hot target;
    full-batch SGD(lr=1, momentum=0.9, wd=2e-5) on the logistic loss with
    loss-patience early stop; prediction thresholds at each node's true
    label count (top-|labels| trick).

    labels: dense (num_sample, num_class) 0/1 matrix.
    Returns a dict with macro/micro F1 at this portion."""
    rng = np.random.default_rng(seed)
    embeddings = np.asarray(embeddings, dtype=np.float32)
    if normalization:
        embeddings = embeddings / np.linalg.norm(embeddings, axis=1, keepdims=True)
    num_sample, num_class = labels.shape
    num_train = int(num_sample * portion)
    dim = embeddings.shape[1]
    chunk = max(patience, 1)

    def train_chunk(x, y, w, b, mw, mb):
        """`chunk` epochs of the probe; returns their losses (on device)."""
        losses = []
        for _ in range(chunk):
            logits = x @ w + b
            losses.append(torch.mean(
                torch.clamp(logits, min=0) - logits * y
                + torch.log1p(torch.exp(-logits.abs()))))
            # d(mean logistic loss)/d(logits)
            gl = (torch.sigmoid(logits) - y) / logits.numel()
            gw = x.t() @ gl + 2e-5 * w
            gb = gl.sum(dim=0) + 2e-5 * b
            mw = 0.9 * mw + gw
            mb = 0.9 * mb + gb
            w = w - mw
            b = b - mb
        return torch.stack(losses), w, b, mw, mb

    macro, micro = [], []
    for _ in range(max(times, 1)):
        perm = rng.permutation(num_sample)
        train_idx = perm[:num_train]
        test_idx = perm[num_train:]
        # one-vs-rest duplication: one training row per positive label
        rows, cls = np.nonzero(labels[train_idx])
        x = torch.as_tensor(embeddings[train_idx][rows], device=device)
        y = torch.zeros((rows.size, num_class), dtype=torch.float32,
                        device=device)
        y[torch.arange(rows.size, device=device),
          torch.as_tensor(cls, device=device)] = 1.0

        w = torch.zeros((dim, num_class), dtype=torch.float32, device=device)
        b = torch.zeros((num_class,), dtype=torch.float32, device=device)
        mw = torch.zeros_like(w)
        mb = torch.zeros_like(b)
        best_loss, best_epoch, epoch0 = np.inf, -1, 0
        for _ in range(max(100000 // chunk, 1)):
            losses, w, b, mw, mb = train_chunk(x, y, w, b, mw, mb)
            hist = losses.cpu().numpy()
            i = int(np.argmin(hist))
            if hist[i] < best_loss:
                best_loss, best_epoch = float(hist[i]), epoch0 + i
            epoch0 += hist.size
            if epoch0 - 1 >= best_epoch + patience:
                break

        x_test = torch.as_tensor(embeddings[test_idx], device=device)
        logits = (x_test @ w + b).cpu().numpy()
        test_labels = labels[test_idx]
        num_labels = test_labels.sum(axis=1, keepdims=True).astype(int)
        srt = np.sort(logits, axis=1)[:, ::-1]
        thresholds = np.take_along_axis(srt, np.maximum(num_labels - 1, 0), axis=1)
        predictions = (logits >= thresholds).astype(np.int32)
        tp_c = (predictions & test_labels).sum(axis=0).astype(float)
        t_c = test_labels.sum(axis=0).astype(float)
        p_c = predictions.sum(axis=0).astype(float)
        macro.append(np.mean(2 * tp_c / np.maximum(t_c + p_c, 1e-12)))
        micro.append(2 * tp_c.sum() / max(t_c.sum() + p_c.sum(), 1e-12))
    return {
        "macro-F1@%g%%" % (portion * 100): float(np.mean(macro)),
        "micro-F1@%g%%" % (portion * 100): float(np.mean(micro)),
    }


def rank_sum_auc(scores, labels):
    """Link-prediction AUC by the rank-sum estimator."""
    order = np.argsort(-np.asarray(scores), kind="stable")
    y = np.asarray(labels)[order]
    hit = np.cumsum(y)
    denom = float((y == 0).sum()) * float((y == 1).sum())
    return float(hit[y == 0].sum() / denom)


# ---------------------------------------------------------------------------
# KG filtered ranking (ref application.py:829-856, 979-996)
# ---------------------------------------------------------------------------

# models whose score is LINEAR in the candidate side: one-vs-all scoring
# is q @ entity^T (q = d(score)/d(candidate) at gradient 1, from the
# hand-derived backward)
BILINEAR_MODELS = {"DistMult", "ComplEx", "SimplE", "QuatE"}


@contextlib.contextmanager
def _full_float32_matmul():
    """Ranks compare `score >= truth`, so the one-vs-all product runs in
    full float32 on the card (TF32 keeps about three decimal digits)."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _tables(entity, relation):
    """float32 tables on the entity table's device (numpy arrays: the
    CPU)."""
    ent = torch.as_tensor(entity).float()
    return ent, torch.as_tensor(relation).to(device=ent.device,
                                             dtype=torch.float32)


def _ids(x, device):
    return torch.as_tensor(np.asarray(x, dtype=np.int64), device=device)


def _query(model, hrow, trow, rrow, side):
    """[b, D] query of a bilinear model: the score's gradient wrt the
    candidate row at gradient 1 (no l3 term)."""
    ones = torch.ones(hrow.shape[0], dtype=hrow.dtype, device=hrow.device)
    gh, gt, _ = model.backward(hrow, trow, rrow, ones, 0.0)
    return gh if side == "head" else gt


def _block_scores(model, block, fixed, rrow, side, margin_or_l3):
    """[b, Vc] scores of every row of `block` [Vc, D] as the `side`
    candidate against fixed [b, D] and rrow [b, D], by broadcast."""
    c, f, r = block[None], fixed[:, None], rrow[:, None]
    if side == "head":
        return model.score(c, f, r, margin_or_l3)
    return model.score(f, c, r, margin_or_l3)


def _pair_scores(model, cand, fixed, rrow, side, margin_or_l3):
    """[p] scores of cand [p, D] as the `side` entity of each pair."""
    if side == "head":
        return model.score(cand, fixed, rrow, margin_or_l3)
    return model.score(fixed, cand, rrow, margin_or_l3)


def _batch_shape(model_name, dim):
    """(candidate block, query batch) of the streaming scorers: ~512 MB of
    float32 intermediates for the broadcast models."""
    if model_name in BILINEAR_MODELS:
        return 8192, 1024
    cand_block = 2048
    return cand_block, max(min(int(512e6 / (cand_block * dim * 4)), 512), 16)


@torch.no_grad()
def kg_score_all(model_name, entity, relation, h, r, t, target,
                 margin_or_l3, chunk=None):
    """Score each triplet against ALL candidate entities in the `target`
    role. Returns a (len(h), num_entity) float32 numpy array. Bilinear
    models take one matrix product per chunk; distance models (TransE,
    RotatE) a chunked broadcast."""
    model = KG_MODELS[model_name]
    ent, rel = _tables(entity, relation)
    num_entity, dim = ent.shape
    bilinear = model_name in BILINEAR_MODELS
    if chunk is None:
        chunk = (max(int(512e6 / (num_entity * 4)), 16) if bilinear
                 else max(int(256e6 / (num_entity * dim * 4)), 1))
    out = []
    with _full_float32_matmul():
        for i in range(0, len(h), chunk):
            hh, rr, tt = (_ids(x[i:i + chunk], ent.device)
                          for x in (h, r, t))
            if bilinear:
                q = _query(model, ent[hh], ent[tt], rel[rr], target)
                s = q @ ent.T
            else:
                s = _block_scores(model, ent,
                                  ent[tt if target == "head" else hh],
                                  rel[rr], target, margin_or_l3)
            out.append(s.cpu().numpy())
    return np.concatenate(out)


@torch.no_grad()
def kg_topk(model_name, entity, relation, H, R, T, target, margin_or_l3,
            k=10):
    """Top-k candidate entities per query, streamed in bounded memory: the
    candidate blocks are scanned with a running [b, k] merge, so the
    [n, V] score matrix never exists. Returns (values [n, k] float32, ids
    [n, k] int32), best first."""
    model = KG_MODELS[model_name]
    ent, rel = _tables(entity, relation)
    num_entity, dim = ent.shape
    bilinear = model_name in BILINEAR_MODELS
    cand_block, b = _batch_shape(model_name, dim)
    n = len(R)
    vals = np.empty((n, k), np.float32)
    ids = np.empty((n, k), np.int32)
    with _full_float32_matmul():
        for i in range(0, n, b):
            hh, rr, tt = (_ids(x[i:i + b], ent.device) for x in (H, R, T))
            m = rr.shape[0]
            fixed = ent[tt if target == "head" else hh]
            rrow = rel[rr]
            if bilinear:
                q = _query(model, ent[hh], ent[tt], rrow, target)
            tv = torch.full((m, k), -torch.inf, device=ent.device)
            ti = torch.zeros((m, k), dtype=torch.long, device=ent.device)
            for base in range(0, num_entity, cand_block):
                block = ent[base:base + cand_block]
                s = (q @ block.T if bilinear else
                     _block_scores(model, block, fixed, rrow, target,
                                   margin_or_l3))
                gidx = torch.arange(base, base + block.shape[0],
                                    device=ent.device)
                cat_v = torch.cat([tv, s], dim=1)
                cat_i = torch.cat([ti, gidx[None].expand(m, -1)], dim=1)
                tv, sel = torch.topk(cat_v, k, dim=1)
                ti = torch.gather(cat_i, 1, sel)
            vals[i:i + m] = tv.cpu().numpy()
            ids[i:i + m] = ti.cpu().numpy()
    return vals, ids


@torch.no_grad()
def filtered_rankings(model_name, entity, relation, H, R, T, exclude_H,
                      exclude_T, margin_or_l3, target="both"):
    """Optimistic filtered rank per triplet: rank = #(candidates with score
    >= truth) with the known true triplets (except the test one) left out
    (ref application.py:842-855). The positive counts once by rule, not by
    comparing two roundings of its own score (the reference counts it by
    the comparison and clips the rank at 1). Streaming: candidate blocks
    are scanned on the device and the excluded candidates are scored
    directly, so only per-triplet counts return to the host. `exclude_H[(t, r)]` and
    `exclude_T[(h, r)]` are the sets of known heads and tails. Returns a
    float64 array: all head-side ranks, then all tail-side ranks."""
    model = KG_MODELS[model_name]
    ent, rel = _tables(entity, relation)
    num_entity, dim = ent.shape
    dev = ent.device
    bilinear = model_name in BILINEAR_MODELS
    cand_block, b = _batch_shape(model_name, dim)
    H = np.asarray(H, dtype=np.int64)
    R = np.asarray(R, dtype=np.int64)
    T = np.asarray(T, dtype=np.int64)
    sides = [s for s in ("head", "tail") if target in (s, "both")]
    rankings = []
    with _full_float32_matmul():
        for side in sides:
            positives, fixed_all, exclude = (
                (H, T, exclude_H) if side == "head" else (T, H, exclude_T))
            for i in range(0, len(H), b):
                sl = slice(i, i + b)
                pos = _ids(positives[sl], dev)
                fixed = ent[_ids(fixed_all[sl], dev)]
                rrow = rel[_ids(R[sl], dev)]
                posrow = ent[pos]
                m = pos.shape[0]
                if bilinear:
                    hrow, trow = ((posrow, fixed) if side == "head"
                                  else (fixed, posrow))
                    q = _query(model, hrow, trow, rrow, side)
                    truth = (q * posrow).sum(dim=-1)
                else:
                    truth = _pair_scores(model, posrow, fixed, rrow, side,
                                         margin_or_l3)
                total_ge = torch.zeros(m, dtype=torch.long, device=dev)
                for base in range(0, num_entity, cand_block):
                    block = ent[base:base + cand_block]
                    s = (q @ block.T if bilinear else
                         _block_scores(model, block, fixed, rrow, side,
                                       margin_or_l3))
                    total_ge += (s >= truth[:, None]).sum(dim=1)
                    # the positive itself counts once whatever the two
                    # roundings of its score say: its own comparison out
                    # here, 1 in below
                    at = pos - base
                    inside = (at >= 0) & (at < block.shape[0])
                    own = s.gather(1, at.clamp(0, block.shape[0] - 1)[:, None])
                    total_ge -= ((own[:, 0] >= truth) & inside).long()
                total_ge += 1

                # excluded candidates, scored directly
                rows, ents = [], []
                for j, key in enumerate(zip(fixed_all[sl].tolist(),
                                            R[sl].tolist())):
                    known = exclude.get(key, ())
                    rows.extend([j] * len(known))
                    ents.extend(known)
                if rows:
                    ex_rows = _ids(rows, dev)
                    ex_ents = _ids(ents, dev)
                    cand = ent[ex_ents]
                    if bilinear:
                        es = (q[ex_rows] * cand).sum(dim=-1)
                    else:
                        es = _pair_scores(model, cand, fixed[ex_rows],
                                          rrow[ex_rows], side, margin_or_l3)
                    hit = (es >= truth[ex_rows]) & (ex_ents != pos[ex_rows])
                    total_ge -= torch.zeros_like(total_ge).index_add_(
                        0, ex_rows, hit.long())
                # the positive itself always counts: at least 1
                rankings.append(torch.clamp(total_ge, min=1).cpu().numpy())
    if not rankings:
        return np.zeros(0, dtype=np.float64)
    return np.concatenate(rankings).astype(np.float64)


def ranking_metrics(rankings):
    r = np.asarray(rankings, dtype=np.float64)
    return {
        "MR": float(np.mean(r)),
        "MRR": float(np.mean(1.0 / r)),
        "HITS@1": float(np.mean(r <= 1)),
        "HITS@3": float(np.mean(r <= 3)),
        "HITS@10": float(np.mean(r <= 10)),
    }
