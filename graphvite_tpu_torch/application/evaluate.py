"""Node-embedding evaluation (the port of the graph tasks of
graphvite_tpu/application/evaluate.py): the linear-probe node
classification runs in torch on the solver's device, the link-prediction
AUC is host numpy."""
from __future__ import annotations

import numpy as np
import torch


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
