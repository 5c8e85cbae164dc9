"""What the references share: the linear learning-rate schedule, the
readings of a followed run, the gaps between two sets of readings, and
the z statistic of a sample mean."""
from __future__ import annotations

import math
import statistics

import numpy as np
import torch


def linear_lr(lr, batch_id, num_batch):
    """GraphVite's linear schedule, in float32: lr * max(1 - b / N, 1e-4)."""
    f = np.maximum(np.float32(1.0) - np.float32(batch_id)
                   / np.float32(num_batch), np.float32(1e-4))
    return float(np.float32(lr) * f)


def schedule(calls, lr):
    """The learning rate of each batch of `calls` [(batch ids, num_batch)]."""
    return [linear_lr(lr, b, n) for ids, n in calls for b in ids]


def state_readings(start, after_one, after_all, lr):
    """Per table: the first gradient as the optimizer got it, from the
    state after one step, ||start - after_one|| / lr, and the change
    after all followed steps, ||after_all - start||, in float64. `start`
    holds the float32 initial rows."""
    def dist(a, b):
        return float(torch.linalg.vector_norm((a.double() - b.double())))
    return ([dist(s, a) / lr for s, a in zip(start, after_one)],
            [dist(a, s) for s, a in zip(start, after_all)])


def _gap(p, r):
    """|p - r| against r: a norm's gap measured against its own leaf."""
    if r > 0:
        return abs(p - r) / r
    return 0.0 if p == 0 else math.inf


def gaps(program, reference):
    """The numbers compared: the worst step's relative loss gap, and per
    table the gap between the program's norm and the reference's,
    measured against that table's reference norm. Tables whose reference
    gradient is under a thousandth of the median table's leave the
    change comparison (round-off alone moves them)."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(program["losses"],
                                                       reference["losses"]))

    def worst(key, keep):
        return max((_gap(p, r) for p, r, k in zip(program[key],
                                                  reference[key], keep)
                    if k), default=0.0)

    grads = reference["grad_norms"]
    med_grad = statistics.median(grads)
    moved = [g >= 1e-3 * med_grad for g in grads]
    return {"loss_gap": loss_gap,
            "grad_gap": worst("grad_norms", [True] * len(grads)),
            "change_gap": worst("change_norms", moved)}


def local_rows(ids, rows):
    """Rows read at `ids` [n] with repeats ([n, D]) as a local table:
    (inverse [n] into it, the table [U, D] over the sorted distinct ids)."""
    distinct, inv = torch.unique(ids, return_inverse=True)
    table = rows.new_empty((distinct.numel(), rows.shape[1]))
    table[inv] = rows
    return inv, table


def step_norms(before, after, lr):
    """Per table: ||after - before|| / lr in float64, the step's gradient
    as the optimizer applied it."""
    return [float(torch.linalg.vector_norm(a.double() - b.double())) / lr
            for b, a in zip(before, after)]


def window_readings(rec):
    """The program's readings of a recorded window step: its loss, and per
    table ||after - before|| / lr over the distinct rows it read."""
    before = [local_rows(i, r)[1] for i, r in zip(rec["ids"],
                                                   rec["before"])]
    after = [local_rows(i, r)[1] for i, r in zip(rec["ids"], rec["after"])]
    return {"losses": [float(rec["loss"])],
            "grad_norms": step_norms(before, after, rec["lr"])}


def window_gaps(program, reference):
    """The window step's relative loss gap and its worst table's gradient
    gap, against that table's reference norm."""
    (p,), (r,) = program["losses"], reference["losses"]
    return {"window_loss_gap": abs(p - r) / abs(r),
            "window_grad_gap": max(_gap(a, b) for a, b in zip(
                program["grad_norms"], reference["grad_norms"]))}


def z_of_mean(values, mean, var):
    """|z| of the sample mean of `values` against a distribution of mean
    `mean` and variance `var`."""
    n = values.numel()
    if n == 0 or var <= 0:
        return 0.0
    return abs(float(values.double().mean()) - mean) / math.sqrt(var / n)


def weighted_moments(x, w):
    """Mean and variance of x [n] under weights w [n] (float64)."""
    w = w.double() / w.double().sum()
    x = x.double()
    m = float((w * x).sum())
    return m, float((w * (x - m) ** 2).sum())
