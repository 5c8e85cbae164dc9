"""Row-sparse first-order optimizers (the port of graphvite_tpu/optim.py).

A batched step computes per-touch regularized gradients

    reg = weight * (model_grad + weight_decay * param)

and applies them row-wise:

* 0-moment (SGD): scatter-add of ``-lr * reg``, duplicate touches summed
  (ops.scatter.scatter_add_, the port of the Pallas sweep scatter-add);
* 1/2-moment (Momentum/AdaGrad/RMSprop/Adam): duplicate touches are summed
  per unique row, then ONE closed-form c-touch moment update is applied per
  touched row. Tables up to DENSE_UPDATE_ELEMS take a dense accumulate in
  plain torch, as the reference runs it in XLA; larger tables take the
  moment kernel (ops.scatter.scatter_update_, the port of the Pallas sweep
  scatter-update, whose contract the reference's sort-based route states:
  entry counts, entry squares, lr_scale, out-of-range ids dropped), in
  place.

Update rules mirror the reference exactly, including GraphVite's Adam
defaults (beta1=0.999, beta2=0.99999, no bias correction).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from graphvite_tpu_torch.ops.scatter import scatter_add_, scatter_update_
from graphvite_tpu_torch.utils.common import auto

OPTIMIZER_MOMENTS = {
    "SGD": 0,
    "Momentum": 1,
    "AdaGrad": 1,
    "RMSprop": 1,
    "Adam": 2,
}


def linear_schedule(batch_id, num_batch):
    """lr multiplier, in float32 like the reference's traced schedule."""
    return np.maximum(np.float32(1.0)
                      - np.float32(batch_id) / np.float32(num_batch),
                      np.float32(1e-4))


def constant_schedule(batch_id, num_batch):
    return np.float32(1.0)


SCHEDULES = {"linear": linear_schedule, "constant": constant_schedule}


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """Static optimizer hyperparameters."""

    type: str = "SGD"
    lr: float = 0.025
    weight_decay: float = 0.0
    schedule: str = "linear"
    # per-type extras (union-style, like the reference's anonymous union)
    momentum: float = 0.999
    alpha: float = 0.999  # RMSprop
    beta1: float = 0.999  # Adam (GraphVite default)
    beta2: float = 0.99999
    epsilon: float = 1e-8

    def __post_init__(self):
        if self.type not in OPTIMIZER_MOMENTS:
            raise ValueError("Unknown optimizer `%s`" % self.type)
        if self.schedule not in SCHEDULES:
            raise ValueError("Invalid schedule `%s`" % self.schedule)

    @property
    def num_moment(self) -> int:
        return OPTIMIZER_MOMENTS[self.type]

    def schedule_lr(self, batch_id, num_batch):
        """Scheduled learning rate as a Python float (a float32 value)."""
        return float(np.float32(self.lr)
                     * SCHEDULES[self.schedule](batch_id, num_batch))

    def init_moments(self, shape, device="cpu"):
        """Allocate zero float32 moment tables for a table of `shape`."""
        return tuple(torch.zeros(shape, dtype=torch.float32, device=device)
                     for _ in range(self.num_moment))

    def info(self):
        """The optimizer's settings as the reference prints them."""
        s = ("optimizer: %s\nlearning rate: %g, lr schedule: %s\n"
             "weight decay: %g" % (self.type, self.lr, self.schedule,
                                   self.weight_decay))
        if self.type == "Momentum":
            s += "\nmomentum: %g" % self.momentum
        if self.type in ("AdaGrad", "RMSprop"):
            s += "\nepsilon: %g" % self.epsilon
        if self.type == "RMSprop":
            s += "\nalpha: %g" % self.alpha
        if self.type == "Adam":
            s += "\nbeta1: %g, beta2: %g, epsilon: %g" % (
                self.beta1, self.beta2, self.epsilon)
        return s


def make_optimizer(spec, default: Optional[Optimizer] = None, **kwargs) -> Optimizer:
    """Resolve user input (auto | float lr | name | dict | Optimizer)."""
    if isinstance(spec, Optimizer):
        return spec
    if spec is None or (isinstance(spec, (int, float)) and spec == auto and not isinstance(spec, bool)):
        if default is None:
            raise ValueError("no default optimizer available")
        return default
    if isinstance(spec, (int, float)):
        base = default if default is not None else Optimizer()
        return dataclasses.replace(base, lr=float(spec), **kwargs)
    if isinstance(spec, str):
        base = default if default is not None else Optimizer()
        lr = kwargs.pop("lr", base.lr)
        wd = kwargs.pop("weight_decay", base.weight_decay)
        return Optimizer(type=spec, lr=lr, weight_decay=wd, **kwargs)
    if isinstance(spec, dict):
        spec = dict(spec)
        name = spec.pop("type", default.type if default else "SGD")
        base = default if default is not None else Optimizer()
        merged = {"lr": base.lr, "weight_decay": base.weight_decay, "schedule": base.schedule}
        merged.update(spec)
        merged.update(kwargs)
        merged = {k: v for k, v in merged.items() if v != auto or k == "weight_decay"}
        return Optimizer(type=name, **merged)
    raise TypeError("cannot build an optimizer from %r" % (spec,))


# ---------------------------------------------------------------------------
# moment update rules (per unique row): each rule applies c sequential
# touch-updates in closed form, treating the c per-touch gradients as equal
# to the mean ghat = g / c:
#     m' = beta^c m + (1 - beta^c) ghat        (EMA rules)
#     delta_total ~= c * per_touch_delta(ghat, m')
# ---------------------------------------------------------------------------

def _sgd_delta(opt, lr, g, c):
    return lr * g, ()


def _one_minus_pow(beta, c):
    """1 - beta**c without the f32 cancellation (beta ~ 1): the series
    -x(1 + x/2 + x^2/6) for |x| < 1e-4, x = c*log(beta), else the direct
    form (the reference's formula, kept bit for bit)."""
    x = c * math.log(beta)
    return torch.where(x > -1e-4,
                       -x * (1.0 + x / 2.0 + x * x / 6.0),
                       1.0 - torch.exp(x))


def _momentum_delta(opt, lr, g, c, m1):
    ghat = g / c
    w = _one_minus_pow(opt.momentum, c)
    new_m1 = (1 - w) * m1 + w * ghat
    return lr * c * new_m1, (new_m1,)


def _adagrad_delta(opt, lr, g, c, gsq, m1):
    ghat = g / c
    new_m1 = m1 + gsq  # exact: sum of per-touch squared gradients
    return lr * c * ghat / (torch.sqrt(new_m1) + opt.epsilon), (new_m1,)


def _rmsprop_delta(opt, lr, g, c, gsq, m1):
    ghat = g / c
    w = _one_minus_pow(opt.alpha, c)
    new_m1 = (1 - w) * m1 + w * gsq / c
    return lr * c * ghat / torch.sqrt(new_m1 + opt.epsilon), (new_m1,)


def _adam_delta(opt, lr, g, c, gsq, m1, m2):
    ghat = g / c
    w1 = _one_minus_pow(opt.beta1, c)
    w2 = _one_minus_pow(opt.beta2, c)
    new_m1 = (1 - w1) * m1 + w1 * ghat
    new_m2 = (1 - w2) * m2 + w2 * gsq / c  # mean of per-touch squares
    return lr * c * new_m1 / (torch.sqrt(new_m2) + opt.epsilon), (new_m1, new_m2)


def moment_delta(opt: Optimizer, lr, g, moments, c=1.0, gsq=None):
    """delta such that param_new = param - lr_scale * delta; also new moments.

    g:   summed regularized gradient over the row's touches
    c:   touch count (a number or a tensor broadcastable to g)
    gsq: summed per-touch SQUARED gradients (defaults to g*g/c)."""
    if not torch.is_tensor(c):
        c = torch.full((), float(c), dtype=torch.float32, device=g.device)
    if opt.type == "SGD":
        return _sgd_delta(opt, lr, g, c)
    if opt.type == "Momentum":
        return _momentum_delta(opt, lr, g, c, *moments)
    if gsq is None:
        gsq = g * g / c
    if opt.type == "AdaGrad":
        return _adagrad_delta(opt, lr, g, c, gsq, *moments)
    if opt.type == "RMSprop":
        return _rmsprop_delta(opt, lr, g, c, gsq, *moments)
    if opt.type == "Adam":
        return _adam_delta(opt, lr, g, c, gsq, *moments)
    raise ValueError(opt.type)


# ---------------------------------------------------------------------------
# row-sparse application with duplicate accumulation
# ---------------------------------------------------------------------------

INT32_MAX = 2 ** 31 - 1


def dedup_rows(ids, grads, entry_counts=None, entry_sqs=None):
    """Sum `grads` over duplicate `ids`.

    `entry_counts` [N] gives each entry's touch count and `entry_sqs`
    [N, D] the sum of its per-touch squared gradients (defaults: count 1,
    sq = grad**2). Returns (uids, gsum, counts, gsq), each of length N;
    slots beyond the number of unique ids carry the sentinel uid
    INT32_MAX, zero grads and count 1."""
    n = ids.shape[0]
    order = torch.argsort(ids, stable=True)
    sid = ids[order]
    sg = grads[order]
    head = torch.ones(n, dtype=torch.bool, device=ids.device)
    head[1:] = sid[1:] != sid[:-1]
    seg = torch.cumsum(head.long(), 0) - 1  # segment index of each touch
    gsum = torch.zeros_like(sg).index_add_(0, seg, sg)
    sq = sg * sg if entry_sqs is None else entry_sqs[order]
    gsq = torch.zeros_like(sq).index_add_(0, seg, sq)
    cnt = (torch.ones(n, dtype=grads.dtype, device=grads.device)
           if entry_counts is None else entry_counts[order].to(grads.dtype))
    counts = torch.zeros_like(cnt).index_add_(0, seg, cnt).clamp(min=1.0)
    uids = torch.full((n,), INT32_MAX, dtype=sid.dtype,
                      device=ids.device).scatter_(0, seg, sid)
    return uids, gsum, counts, gsq


# tables up to this many elements use the dense accumulate path for moment
# optimizers (one [V, 2D+1] accumulate + a dense moment pass); beyond it
# the moment kernel
DENSE_UPDATE_ELEMS = 1 << 26


def _in_range(ids, v):
    """(ids clamped into range, 0/1 float mask of the in-range entries):
    out-of-range entries are dropped by zeroing what they scatter, with no
    host synchronization."""
    ok = (ids >= 0) & (ids < v)
    return torch.where(ok, ids, torch.zeros_like(ids)).long(), ok.float()


def _apply_row_updates_dense(table, moments, ids, reg_grads, opt: Optimizer,
                             lr, lr_scale, entry_counts, entry_sqs):
    """Accumulate gsum/gsq/counts densely over the whole table, then apply
    ONE vectorized moment update on touched rows."""
    v, d = table.shape
    f32 = torch.float32
    g32 = reg_grads.to(f32)
    sq = g32 * g32 if entry_sqs is None else entry_sqs.to(f32)
    cnt = (torch.ones(ids.shape, dtype=f32, device=ids.device)
           if entry_counts is None else entry_counts.to(f32))
    safe_ids, ok = _in_range(ids, v)
    upd = torch.cat([g32, sq, cnt[:, None]], dim=1) * ok[:, None]
    acc = torch.zeros((v, 2 * d + 1), dtype=f32,
                      device=table.device).index_add_(0, safe_ids, upd)
    gsum = acc[:, :d]
    gsq = acc[:, d:2 * d]
    counts = acc[:, 2 * d]
    touched = (counts > 0)[:, None]
    c = counts.clamp(min=1.0)[:, None]
    delta, new_moments = moment_delta(opt, lr, gsum, moments, c, gsq)
    new_table = torch.where(touched,
                            table - (lr_scale * delta).to(table.dtype),
                            table)
    out_moments = tuple(torch.where(touched, nm.to(m.dtype), m)
                        for m, nm in zip(moments, new_moments))
    return new_table, out_moments


def apply_row_updates(table, moments, ids, reg_grads, opt: Optimizer, lr,
                      lr_scale=1.0, entry_counts=None, entry_sqs=None,
                      trust=None):
    """Apply optimizer updates for per-touch regularized gradients.

    table:      [V, D] parameter table (the SGD routes and the big-table
                moment route update it in place)
    moments:    tuple of [V, D] moment tables (len == opt.num_moment; the
                big-table route updates them in place)
    ids:        [N] row ids (duplicates allowed; out-of-range ids are
                dropped — steps route masked slots to a sentinel)
    reg_grads:  [N, D] per-touch regularized gradients
    lr:         scheduled learning rate
    lr_scale:   extra multiplier on the applied delta only
    entry_counts / entry_sqs: see dedup_rows.
    trust:      optional trust-ratio clip for SGD: a row's accumulated
                per-batch displacement is clipped to trust * (|row| + 1e-2);
                applied through a dense [V, D] accumulate, so only for
                tables <= DENSE_UPDATE_ELEMS.
    Returns (table, moments)."""
    if opt.num_moment == 0:
        delta = (lr * lr_scale) * reg_grads
        if (trust is not None
                and table.shape[0] * table.shape[1] <= DENSE_UPDATE_ELEMS):
            acc = scatter_add_(
                torch.zeros(table.shape, dtype=torch.float32,
                            device=table.device),
                ids, delta.float())
            dnorm = torch.linalg.vector_norm(acc, dim=-1, keepdim=True)
            limit = trust * (torch.linalg.vector_norm(
                table.float(), dim=-1, keepdim=True) + 1e-2)
            acc = acc * torch.clamp(limit / torch.clamp(dnorm, min=1e-30),
                                    max=1.0)
            return table.sub_(acc.to(table.dtype)), moments
        # pure scatter-add; duplicates accumulate, out-of-range ids drop
        return scatter_add_(table, ids, -delta.float()), moments

    if table.shape[0] * table.shape[1] <= DENSE_UPDATE_ELEMS:
        return _apply_row_updates_dense(table, moments, ids, reg_grads, opt,
                                        lr, lr_scale, entry_counts,
                                        entry_sqs)

    # big tables: the moment kernel (the plain version on CPU tensors), in
    # place on the table and its moments
    return scatter_update_(table, moments, ids, reg_grads, opt, lr,
                           entry_counts=entry_counts, entry_sqs=entry_sqs,
                           lr_scale=lr_scale)
