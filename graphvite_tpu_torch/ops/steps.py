"""Training steps and the episode runner (the port of the node-embedding
shared-negative-pool steps, the knowledge-graph steps and the LargeVis
steps of graphvite_tpu/ops/steps.py).

Each step takes a state dict {"tables": (...), "moments": (...)} and one
batch, samples its negatives (a shared pool per sample group, or K draws
per sample in the classic steps), computes hand-derived gradients (no
autograd) and applies the row updates. Node-embedding batch layouts: whole
walks (chain [B, L+1] plus a pair mask [B, L+1, T]; the banded steps),
walk positions (heads [B], tails [B, T], mask [B, T];
`make_graph_pool_multitail_step`) and pairs (heads [B], tails [B], mask
[B]; `make_graph_pool_step` for edges and walk pairs, and the classic
`make_graph_train_step`). Table updates go through the hand-written CUDA
kernels on the card (ops/scatter.py, ops/gather.py). Tables are updated
in place where the update is a scatter-add, and by the moment kernel.

Knowledge-graph steps take (heads, tails, rels) triplets over a tied entity
table and a relation table: the classic per-draw step
(`make_kg_train_step`) and the shared-candidate-pool step
(`make_kg_pool_step`, with a generic body for every model and the RotatE
isometry body). LargeVis steps take edges over one coordinate table: the
classic K-draw step (`make_vis_train_step`) and the shared-pool step
(`make_vis_pool_step`).

Random draws: the pool draws (u1, u2) [G, M] are optional inputs
(`draws`; [B, K] for the classic graph and LargeVis steps; the knowledge-graph steps
take their candidate ids as `negatives`); otherwise they come from the
`generator` on the tables' device.

Loss conventions match the reference's gpu/graph.cuh:73-92.
"""
from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from graphvite_tpu_torch.ops import rotate_pool, walk_band
from graphvite_tpu_torch.ops.alias import alias_draws, device_sample
from graphvite_tpu_torch.ops.device_sampler import walk_offsets
from graphvite_tpu_torch.ops.gather import gather_sorted
from graphvite_tpu_torch.ops.scatter import (scatter_add_,
                                             scatter_add_sorted_,
                                             scatter_update_,
                                             scatter_update_sorted_)
from graphvite_tpu_torch.ops.walk_band import walk_shift_fwd
from graphvite_tpu_torch.optim import Optimizer, apply_row_updates
from graphvite_tpu_torch.models.visualization import SMOOTH_TERM
from graphvite_tpu_torch.utils import tracing
from graphvite_tpu_torch.utils.common import EPSILON


def _mask_ids(ids, mask, sentinel):
    """Route masked slots' scatter ids out of range so apply_row_updates
    drops them entirely (a zero-gradient touch would still count as a
    touch for the moment rules)."""
    if mask is None:
        return ids
    dead = mask <= 0
    while dead.dim() < ids.dim():
        dead = dead[..., None]
    return torch.where(dead, torch.full_like(ids, sentinel), ids)


def _logistic_terms(logits, num_negative, negative_weight, mask=None):
    """Per-subsample gradient (dL/dlogit), weight and per-sample loss for
    the layout [negatives..., positive] along the last axis; `mask` [B]
    zeroes padded sample slots."""
    k = num_negative
    prob = torch.sigmoid(logits)
    label = torch.zeros_like(logits)
    label[..., k:] = 1.0
    gradient = prob - label
    weight = torch.where(label > 0, 1.0, float(negative_weight)).to(
        logits.dtype)
    if mask is not None:
        gradient = gradient * mask[:, None]
        weight = weight * mask[:, None]
    # stable logistic loss: -log sigmoid(z) = softplus(-z),
    # -log(1 - sigmoid(z)) = softplus(z)
    loss = torch.where(label > 0, F.softplus(-logits), F.softplus(logits))
    sample_loss = (weight * loss).sum(dim=-1) / (1.0 + k * negative_weight)
    return gradient, weight, sample_loss


def make_graph_train_step(model, opt: Optimizer, num_negative: int,
                          negative_weight: float, trust=None):
    """The classic node-embedding step (GRAPHVITE_NEG_SHARING=0): K
    negative draws per sample from the degree^0.75 alias sampler, scored
    with the model's <vertex, context>. The vertex row gets K+1 touches
    (accumulated before its update), the tail and the negative rows one
    each. `trust`: the SGD displacement clip of optim.apply_row_updates.

    step(state, heads [B], tails [B], lr, *neg_state, mask=None,
    generator=None, draws=None) -> (state, loss); `draws` = (u1, u2)
    [B, K] negative-sampler uniforms (`step.draw_shape(B)`)."""
    k = num_negative

    def step(state, heads, tails, lr, *neg_state, mask=None,
             generator=None, draws=None):
        vertex, context = state["tables"]
        v_moms, c_moms = state["moments"]
        b = heads.shape[0]
        dev = vertex.device
        with tracing.span(tracing.NEGATIVES):
            if draws is None:
                draws = alias_draws(neg_state, (b, k), generator, dev)
            negs = device_sample(*neg_state, *draws)         # [B, K]

        v = vertex[heads].float()                            # [B, D]
        ctx_ids = torch.cat([negs, tails[:, None].long()], dim=1)
        c = context[ctx_ids].float()                         # [B, K+1, D]
        logits = model.score(v[:, None, :], c)               # [B, K+1]
        gradient, weight, sample_loss = _logistic_terms(
            logits, k, negative_weight, mask)

        gv, gc = model.backward(v[:, None, :], c, gradient)
        with tracing.span(tracing.UPDATE):
            w = weight[..., None]
            wd = opt.weight_decay
            per_touch_v = w * (gv + wd * v[:, None, :])          # [B, K+1, D]
            reg_v = per_touch_v.sum(dim=1)
            reg_c = w * gc + wd * w * c
            v_counts = v_sqs = None
            if opt.num_moment > 0:
                v_counts = torch.full((b,), k + 1.0, device=dev)
                v_sqs = (per_touch_v * per_touch_v).sum(dim=1)
            new_vertex, new_v_moms = apply_row_updates(
                vertex, v_moms, _mask_ids(heads.long(), mask, vertex.shape[0]),
                reg_v, opt, lr, entry_counts=v_counts, entry_sqs=v_sqs,
                trust=trust)
            new_context, new_c_moms = apply_row_updates(
                context, c_moms,
                _mask_ids(ctx_ids, mask, context.shape[0]).reshape(-1),
                reg_c.reshape(b * (k + 1), -1), opt, lr, trust=trust)
        new_state = {"tables": (new_vertex, new_context),
                     "moments": (new_v_moms, new_c_moms)}
        return new_state, _mean_sample_loss(sample_loss, mask)

    step.draw_shape = lambda b: (b, k)
    return step


def graph_pool_groups(batch_size: int, target_group: int = 2048,
                      lo: int = 8, hi: int = 256):
    """Pool-group count for a batch: bound the per-group sample count so a
    pool row's batch-accumulated update stays a small multiple of lr times
    its own norm."""
    g = lo
    while g < hi and batch_size // g > target_group:
        g *= 2
    while batch_size % g and g > 1:
        g //= 2
    return max(g, 1)


def make_graph_pool_step(opt: Optimizer, num_negative: int,
                         negative_weight: float, pool_size: int = 256,
                         pool_groups: int = 8, trust: float = 0.25,
                         sweep_vertex: bool = False,
                         sweep_context: bool = False,
                         sweep_gather: bool = False,
                         sort_heads: bool = False):
    """Shared-negative-pool step over a batch of pairs: edges (the edge
    route) or walk pairs (the pair layout, GRAPHVITE_WALK_STEP=pair or
    GRAPHVITE_MULTITAIL=0, with the sweeps off).

    Each of `pool_groups` sample groups draws ONE pool of `pool_size`
    negative rows, and every sample of the group scores against the whole
    pool, weighted negative_weight * K / pool_size per pool row, so the
    expected negative gradient mass per sample matches K per-sample draws.
    All graph models score <v, c>, so scoring is a batched matmul. Moment
    optimizers get the emulated K-draw touch counts and squared-gradient
    sums of the reference.

    Switches (the solver sets them, as the reference's solver sets its
    sweep switches):
    * sweep_gather: the heads are ascending; gather their vertex rows with
      kernel 3 (ops/gather.py), converted to float32 in the kernel;
    * sweep_vertex: the heads are ascending; the vertex update runs the
      sorted entry of kernel 1 (SGD) or kernel 2 (moment rules);
    * sweep_context: the context update (tails and pool rows, any order)
      runs the unsorted front end of kernel 1 or kernel 2;
    * sort_heads: walk pairs arrive in emission order, so the step sorts
      the batch by head first (the reference's front end for the sweeps,
      GRAPHVITE_SWEEP_WALK=1): masked slots park at row V-1, and a stable
      argsort of the heads carries the tails and the mask along;
    * off: `optim.apply_row_updates` (kernel 1 for SGD).
    The trust clip on pool-row gradients applies on every route. On the
    sweep routes masked slots carry zeroed gradients, and masked tails
    park at row V-1 with no touch count.

    GRAPHVITE_BF16_COMPUTE=1 (the reference's experimental switch, read
    when the step is built) rounds the operands of the three pool products
    to bf16 on bf16 tables and multiplies them in float32: the product of
    two bf16 values is exact in float32, so this is the reference's "bf16
    operands, float32 accumulation" up to the order of the sums (a bf16
    matmul would round its output too).

    step(state, heads [B], tails [B], lr, *neg_state, mask=None,
    generator=None, draws=None) -> (state, loss); B % pool_groups == 0;
    `draws` = (u1, u2) [G, M] pool uniforms (`step.pool_shape`)."""
    k = num_negative
    M = int(pool_size)
    G = int(pool_groups)
    neg_w = float(negative_weight) * k / M
    # the reference's switch (ops/steps.py:185 there), read when the step
    # is built; it takes effect on bf16 tables only
    bf16_mm = os.environ.get("GRAPHVITE_BF16_COMPUTE", "0") == "1"

    def step(state, heads, tails, lr, *neg_state, mask=None,
             generator=None, draws=None):
        vertex, context = state["tables"]
        v_moms, c_moms = state["moments"]
        if bf16_mm and vertex.dtype == torch.bfloat16:
            def mm(x):
                return x.bfloat16().float()
        else:
            def mm(x):
                return x
        b = heads.shape[0]
        if b % G:
            raise ValueError("batch %d must divide into %d pool groups"
                             % (b, G))
        bg = b // G
        if sort_heads:
            if mask is not None:
                heads = heads.masked_fill(mask <= 0, vertex.shape[0] - 1)
            order = torch.argsort(heads, stable=True)
            heads, tails = heads[order], tails[order]
            if mask is not None:
                mask = mask[order]
        pool_ids = _pool_ids(neg_state, G, M, vertex.device, generator,
                             draws)

        if sweep_gather:
            v = gather_sorted(vertex, heads, out_dtype=torch.float32)
        else:
            v = vertex[heads].float()
        v = v.reshape(G, bg, -1)
        c = context[tails].reshape(G, bg, -1).float()
        P = context[pool_ids].float()                        # [G, M, D]

        pos_logit = (v * c).sum(dim=-1)                      # [G, Bg]
        neg_logits = torch.bmm(mm(v), mm(P).transpose(1, 2))  # [G, Bg, M]
        gpos = torch.sigmoid(pos_logit) - 1.0
        gneg = torch.sigmoid(neg_logits) * neg_w
        if mask is not None:
            m2 = mask.reshape(G, bg)
            gpos = gpos * m2
            gneg = gneg * m2[..., None]
            n_active = mask.sum()
            tracing.count(tracing.VALID_PAIRS, n_active)
        else:
            m2 = None
            n_active = torch.full((), float(b), device=vertex.device)
            tracing.count(tracing.VALID_PAIRS, b)
        # reported loss on the K-draw scale
        loss_terms = (F.softplus(-pos_logit)
                      + neg_w * F.softplus(neg_logits).sum(dim=-1))
        if m2 is not None:
            loss_terms = loss_terms * m2
        mean_loss = (loss_terms.sum() / torch.clamp(n_active, min=1.0)
                     / (1.0 + k * negative_weight))

        wd = opt.weight_decay
        dv = (gpos[..., None] * c + torch.bmm(mm(gneg), mm(P))
              + wd * (1.0 + M * neg_w) * v)
        dc = gpos[..., None] * v + wd * c
        dP = (torch.bmm(mm(gneg).transpose(1, 2), mm(v))
              + wd * (neg_w * bg) * P)
        if mask is not None and (sweep_vertex or sweep_context):
            # the sweep routes keep masked slots in range, so their weight
            # decay residue (the only unmasked term) is zeroed here
            dv = dv * m2[..., None]
            dc = dc * m2[..., None]
        if trust is not None:
            # a pool row moves by at most `trust` x (its norm + 1e-2)
            dnorm = torch.linalg.vector_norm(dP, dim=-1, keepdim=True)
            limit = (trust * (torch.linalg.vector_norm(P, dim=-1,
                                                       keepdim=True)
                              + 1e-2)
                     / max(lr, EPSILON))
            dP = dP * torch.clamp(limit / torch.clamp(dnorm, min=EPSILON),
                                  max=1.0)

        with tracing.span(tracing.UPDATE):
            v_counts = v_sqs = c_counts = c_sqs = None
            if opt.num_moment > 0:
                # emulated K-draw touch counts (v: K+1, tail: 1, pool row:
                # Bg*K/M expected draws); squares rescale by M/K
                sq_scale = M / max(k, 1)
                v_counts = torch.full((b,), k + 1.0, device=vertex.device)
                p_counts = torch.full((G, M), bg * k / M,
                                      device=vertex.device)
                tail_cnt = torch.ones((b,), device=vertex.device)
                if mask is not None:
                    v_counts = v_counts * mask
                    p_counts = (m2.sum(dim=1)[:, None]
                                * (k / M)).expand(G, M)
                    tail_cnt = mask.float()
                v_sqs = ((gpos[..., None] * c) ** 2
                         + sq_scale * torch.bmm(gneg ** 2, P ** 2)
                         ).reshape(b, -1)
                c_counts = torch.cat([tail_cnt, p_counts.reshape(-1)])
                p_sqs = sq_scale * torch.bmm((gneg ** 2).transpose(1, 2),
                                             v ** 2)
                c_sqs = torch.cat([(dc ** 2).reshape(b, -1),
                                   p_sqs.reshape(G * M, -1)])

            dv = dv.reshape(b, -1)
            if sweep_vertex:
                new_vertex, new_v_moms = scatter_update_sorted_(
                    vertex, v_moms, heads, dv, opt, lr,
                    entry_counts=v_counts, entry_sqs=v_sqs)
            else:
                new_vertex, new_v_moms = apply_row_updates(
                    vertex, v_moms, _mask_ids(heads, mask, vertex.shape[0]),
                    dv, opt, lr, entry_counts=v_counts, entry_sqs=v_sqs,
                    trust=trust)
            if sweep_context and mask is not None:
                # sweep ids stay in range: masked tails park at row V-1
                # (zeroed rows, zero counts) instead of the drop sentinel
                tails = tails.masked_fill(mask <= 0, context.shape[0] - 1)
            elif not sweep_context:
                tails = _mask_ids(tails, mask, context.shape[0])
            ctx_ids = torch.cat([tails,
                                 pool_ids.reshape(-1).to(tails.dtype)])
            ctx_grads = torch.cat([dc.reshape(b, -1),
                                   dP.reshape(G * M, -1)])
            if sweep_context:
                new_context, new_c_moms = scatter_update_(
                    context, c_moms, ctx_ids, ctx_grads, opt, lr,
                    entry_counts=c_counts, entry_sqs=c_sqs)
            else:
                new_context, new_c_moms = apply_row_updates(
                    context, c_moms, ctx_ids, ctx_grads, opt, lr,
                    entry_counts=c_counts, entry_sqs=c_sqs, trust=trust)
        new_state = {"tables": (new_vertex, new_context),
                     "moments": (new_v_moms, new_c_moms)}
        return new_state, mean_loss

    step.pool_shape = (G, M)   # the shape of each of the `draws`
    return step


def make_graph_pool_multitail_step(opt: Optimizer, num_negative: int,
                                   negative_weight: float, num_tail: int,
                                   pool_size: int = 128,
                                   pool_groups: int = 8,
                                   trust: float = 0.25):
    """Shared-negative-pool step over position-major walk samples
    (GRAPHVITE_WALK_STEP=multitail): each sample is one walk position
    (head) with `num_tail` augmentation tails. The exact regrouping of
    make_graph_pool_step over the expanded (head, tail) pairs (same
    gradients, moment counts and squares), but the head row is gathered
    and updated once for its T pairs and the pool is scored once per head.
    Updates go through optim.apply_row_updates (kernel 1 on SGD; kernel 2
    for moment rules on tables above DENSE_UPDATE_ELEMS).

    step(state, heads [B], tails [B, T], lr, *neg_state, mask [B, T],
    generator=None, draws=None) -> (state, loss); B % pool_groups == 0;
    `draws` = (u1, u2) [G, M] pool uniforms (`step.pool_shape`)."""
    k = num_negative
    M = int(pool_size)
    G = int(pool_groups)
    T = int(num_tail)
    neg_w = float(negative_weight) * k / M

    def step(state, heads, tails, lr, *neg_state, mask=None,
             generator=None, draws=None):
        vertex, context = state["tables"]
        v_moms, c_moms = state["moments"]
        b = heads.shape[0]
        if b % G:
            raise ValueError("batch %d must divide into %d pool groups"
                             % (b, G))
        bg = b // G
        dev = vertex.device
        pool_ids = _pool_ids(neg_state, G, M, dev, generator, draws)
        if mask is None:
            mask = torch.ones((b, T), dtype=torch.float32, device=dev)
        m3 = mask.reshape(G, bg, T)
        cnt = m3.sum(dim=-1)                                 # [G, Bg]

        v = vertex[heads].reshape(G, bg, -1).float()
        c = context[tails.reshape(-1)].reshape(G, bg, T, -1).float()
        P = context[pool_ids].float()                        # [G, M, D]

        pos_logit = (v[:, :, None, :] * c).sum(dim=-1)       # [G, Bg, T]
        neg_logits = torch.bmm(v, P.transpose(1, 2))         # [G, Bg, M]
        gpos = (torch.sigmoid(pos_logit) - 1.0) * m3
        # a head's negative gradient: each of its cnt pairs contributes
        # sigmoid(v.P) * neg_w
        gneg_u = torch.sigmoid(neg_logits) * neg_w
        gneg = gneg_u * cnt[..., None]
        n_active = mask.sum()
        tracing.count(tracing.VALID_PAIRS, n_active)
        loss_terms = ((m3 * F.softplus(-pos_logit)).sum(dim=-1)
                      + cnt * (neg_w * F.softplus(neg_logits).sum(dim=-1)))
        mean_loss = (loss_terms.sum() / torch.clamp(n_active, min=1.0)
                     / (1.0 + k * negative_weight))

        wd = opt.weight_decay
        dv = ((gpos[..., None] * c).sum(dim=2) + torch.bmm(gneg, P)
              + (wd * (1.0 + M * neg_w)) * cnt[..., None] * v)
        dc = gpos[..., None] * v[:, :, None, :] + wd * c     # [G,Bg,T,D]
        dc = torch.where(m3[..., None] > 0, dc, 0.0)
        dP = (torch.bmm(gneg.transpose(1, 2), v)
              + wd * (neg_w * bg * T) * P)
        if trust is not None:
            dnorm = torch.linalg.vector_norm(dP, dim=-1, keepdim=True)
            limit = (trust * (torch.linalg.vector_norm(P, dim=-1,
                                                       keepdim=True)
                              + 1e-2)
                     / max(lr, EPSILON))
            dP = dP * torch.clamp(limit / torch.clamp(dnorm, min=EPSILON),
                                  max=1.0)

        with tracing.span(tracing.UPDATE):
            v_counts = v_sqs = c_counts = c_sqs = None
            if opt.num_moment > 0:
                sq_scale = M / max(k, 1)
                v_counts = ((k + 1.0) * cnt).reshape(b)
                v_sqs = (((gpos * gpos)[..., None] * (c * c)).sum(dim=2)
                         + sq_scale * cnt[..., None]
                         * torch.bmm(gneg_u ** 2, P ** 2)).reshape(b, -1)
                p_counts = (cnt.sum(dim=1)[:, None] * (k / M)).expand(G, M)
                c_counts = torch.cat([mask.reshape(-1), p_counts.reshape(-1)])
                p_sqs = sq_scale * torch.bmm(
                    (gneg_u ** 2 * cnt[..., None]).transpose(1, 2), v ** 2)
                c_sqs = torch.cat([(dc ** 2).reshape(b * T, -1),
                                   p_sqs.reshape(G * M, -1)])

            head_mask = (cnt > 0).reshape(b).float()
            new_vertex, new_v_moms = apply_row_updates(
                vertex, v_moms, _mask_ids(heads, head_mask, vertex.shape[0]),
                dv.reshape(b, -1), opt, lr, entry_counts=v_counts,
                entry_sqs=v_sqs, trust=trust)
            flat_tails = _mask_ids(tails.reshape(-1), mask.reshape(-1),
                                   context.shape[0])
            ctx_ids = torch.cat([flat_tails,
                                 pool_ids.reshape(-1).to(flat_tails.dtype)])
            ctx_grads = torch.cat([dc.reshape(b * T, -1),
                                   dP.reshape(G * M, -1)])
            new_context, new_c_moms = apply_row_updates(
                context, c_moms, ctx_ids, ctx_grads, opt, lr,
                entry_counts=c_counts, entry_sqs=c_sqs, trust=trust)
        new_state = {"tables": (new_vertex, new_context),
                     "moments": (new_v_moms, new_c_moms)}
        return new_state, mean_loss

    step.pool_shape = (G, M)   # the shape of each of the `draws`
    return step


def _pool_ids(neg_state, G, M, device, generator, draws):
    """[G, M] negative-pool ids from the alias tensors `neg_state` (a
    `negatives` span)."""
    with tracing.span(tracing.NEGATIVES):
        if draws is None:
            draws = alias_draws(neg_state, (G, M), generator, device)
        u1, u2 = draws
        return device_sample(*neg_state, u1, u2)


def make_graph_banded_core(opt: Optimizer, num_negative: int,
                           negative_weight: float, aug: int, bidir: bool,
                           pool_size: int = 128, pool_groups: int = 8,
                           trust: float = 0.25):
    """The banded whole-walk math on pre-gathered float32 rows: given the
    chain's vertex-role rows v [B, L1, D], context-role rows c [B, L1, D],
    the shared negative pool rows P [G, M, D] and the pair-validity mask
    [B, L1, T], compute every gradient/count/square the banded step needs.

    Returns (core, (k, M, G, T, neg_w)); core(v, c, P, mask, lr,
    table_bf16=False, pool_mask=None) returns a dict (`pool_mask` [G, M]
    zeroes the pool slots whose rows could not be fetched, as the
    multi-device engine's dropped requests): dv [B,L1,D], dc [B,L1,D], dP
    [G,M,D] (trust-clipped), cnt/cntc [B,L1] head/context touch counts,
    loss_sum, n_active, and (moment rules only) v_counts/v_sqs,
    c_counts_main/c_sqs_main, p_counts/p_sqs.

    The positive band (each position's pairs at the walk offsets): on SGD
    `walk_band` (ops/walk_band.py; one kernel launch on the card); the
    moment rules, which also need each offset's squares, take it offset
    by offset here.

    GRAPHVITE_BF16_BAND=1 (the reference's experimental switch, read when
    the core is built) rounds each band product v * c_shifted to bf16
    before its float32 row sum, where the caller's `table_bf16` says the
    rows came from bf16 tables. Such rows are exact in bf16 and the
    product of two bf16 values is exact in float32, so rounding the
    float32 product gives the reference's bf16 product."""
    k = num_negative
    M = int(pool_size)
    G = int(pool_groups)
    offs = walk_offsets(int(aug), bool(bidir))
    T = len(offs)
    neg_w = float(negative_weight) * k / M
    bf16_band = os.environ.get("GRAPHVITE_BF16_BAND", "0") == "1"
    wd = opt.weight_decay
    head_wd = wd * (1.0 + M * neg_w)

    def core(v, c, P, mask, lr, table_bf16=False, pool_mask=None):
        B, L1 = v.shape[0], v.shape[1]
        if B % G:
            raise ValueError("walk batch %d must divide into %d pool groups"
                             % (B, G))
        bg = B // G
        npos = B * L1
        D = v.shape[-1]
        band_bf16 = bf16_band and table_bf16

        if opt.num_moment == 0:
            dv, dc, cnt, cntc, walk_sums = walk_band.walk_band(
                v, c, mask, offs, wd, head_wd, band_bf16)
            pos_loss, n_active = walk_sums.sum(dim=0).unbind()
        else:
            # positive band: per offset, shifted elementwise product
            gpos_list, csh_list = [], []
            pos_loss = 0.0
            for t_i, kk in enumerate(offs):
                csh = walk_shift_fwd(c, kk)
                prod = v * csh
                if band_bf16:
                    prod = prod.bfloat16().float()
                logit = prod.sum(dim=-1)
                m = mask[..., t_i]
                gpos_list.append((torch.sigmoid(logit) - 1.0) * m)
                csh_list.append(csh)
                pos_loss = pos_loss + (m * F.softplus(-logit)).sum()
            cnt = mask.sum(dim=-1)                           # [B, L1]
            n_active = mask.sum()
            dv = sum(g[..., None] * csh
                     for g, csh in zip(gpos_list, csh_list))
            # context side: head i's positive gradient g*v lands at tail
            # i+kk
            gv_list = [g[..., None] * v for g in gpos_list]
            dc_main = sum(walk_shift_fwd(gv, -kk)
                          for gv, kk in zip(gv_list, offs))
            cntc = sum(walk_shift_fwd(mask[..., t_i], -kk)
                       for t_i, kk in enumerate(offs))       # [B, L1]
            dc = dc_main + wd * cntc[..., None] * c

        v4 = v.reshape(G, bg * L1, D)
        neg_logits = torch.bmm(v4, P.transpose(1, 2))        # [G, Pg, M]
        gneg_u = torch.sigmoid(neg_logits) * neg_w
        if pool_mask is not None:
            gneg_u = gneg_u * pool_mask[:, None, :]
        cnt_g = cnt.reshape(G, bg * L1)
        gneg = gneg_u * cnt_g[..., None]
        sp = F.softplus(neg_logits)
        if pool_mask is not None:
            sp = sp * pool_mask[:, None, :]
        neg_loss = (cnt_g * (neg_w * sp.sum(dim=-1))).sum()

        if opt.num_moment == 0:
            dv.view(G, bg * L1, D).baddbmm_(gneg, P)
        else:
            dv = (dv + torch.bmm(gneg, P).reshape(B, L1, D)
                  + head_wd * cnt[..., None] * v)
        dP = (torch.bmm(gneg.transpose(1, 2), v4)
              + wd * (neg_w * bg * L1 * T) * P)
        if trust is not None:
            dnorm = torch.linalg.vector_norm(dP, dim=-1, keepdim=True)
            limit = (trust * (torch.linalg.vector_norm(P, dim=-1,
                                                       keepdim=True)
                              + 1e-2)
                     / max(lr, EPSILON))
            dP = dP * torch.clamp(limit / torch.clamp(dnorm, min=EPSILON),
                                  max=1.0)

        outs = {"dv": dv, "dc": dc, "dP": dP, "cnt": cnt, "cntc": cntc,
                "loss_sum": pos_loss + neg_loss, "n_active": n_active}
        if opt.num_moment > 0:
            sq_scale = M / max(k, 1)
            outs["v_counts"] = ((k + 1.0) * cnt).reshape(npos)
            outs["v_sqs"] = (
                sum((g * g)[..., None] * (csh * csh)
                    for g, csh in zip(gpos_list, csh_list))
                + sq_scale * cnt[..., None]
                * torch.bmm(gneg_u ** 2, P ** 2).reshape(B, L1, D)
            ).reshape(npos, D)
            p_counts = (cnt_g.sum(dim=1)[:, None] * (k / M)).expand(G, M)
            if pool_mask is not None:
                p_counts = p_counts * pool_mask
            outs["p_counts"] = p_counts
            # per-touch tail sq (g v + wd c)^2 summed over valid touches:
            # sum(g^2 v^2) + 2 wd c . sum(g v) + cntc (wd c)^2
            s2 = sum(walk_shift_fwd(gv * gv, -kk)
                     for gv, kk in zip(gv_list, offs))
            outs["c_counts_main"] = cntc.reshape(npos)
            outs["c_sqs_main"] = (s2 + 2.0 * wd * c * dc_main
                                  + (wd * c) ** 2 * cntc[..., None]
                                  ).reshape(npos, D)
            outs["p_sqs"] = sq_scale * torch.bmm(
                (gneg_u ** 2 * cnt_g[..., None]).transpose(1, 2), v4 ** 2)
        return outs

    return core, (k, M, G, T, neg_w)


def _mean_loss(o, k, negative_weight):
    tracing.count(tracing.VALID_PAIRS, o["n_active"])
    return (o["loss_sum"] / torch.clamp(o["n_active"], min=1.0)
            / (1.0 + k * negative_weight))


def make_graph_banded_fused_step(opt: Optimizer, num_negative: int,
                                 negative_weight: float, aug: int,
                                 bidir: bool, pool_size: int = 128,
                                 pool_groups: int = 8):
    """SGD path of the banded walk step over a FUSED (vertex|context) arena:
    state = {"tables": (vc [V, 2D],), "moments": ((),)}. One [B*L1, 2D]
    gather and ONE scatter-add (the kernel) per batch. The core runs with
    trust=None, as in the reference (its clip is per table, not per fused
    row)."""
    if opt.num_moment != 0:
        raise ValueError("the fused arena is the SGD path")
    core, (k, M, G, T, _) = make_graph_banded_core(
        opt, num_negative, negative_weight, aug, bidir, pool_size,
        pool_groups, trust=None)

    def step(state, chain, _tails, lr, *neg_state, mask=None,
             generator=None, draws=None):
        (vc,) = state["tables"]
        D = vc.shape[1] // 2
        B, L1 = chain.shape
        npos = B * L1
        pool_ids = _pool_ids(neg_state, G, M, vc.device, generator, draws)
        if mask is None:
            mask = torch.ones((B, L1, T), dtype=torch.float32,
                              device=vc.device)
        rows = vc[chain].float()                             # [B, L1, 2D]
        v = rows[..., :D]
        c = rows[..., D:]
        P = vc[:, D:][pool_ids].float()                      # [G, M, D]

        o = core(v, c, P, mask, lr, table_bf16=vc.dtype == torch.bfloat16)
        with tracing.span(tracing.UPDATE):
            # dead slots carry exactly-zero grads (masked in the core), so
            # in-range ids scatter-add as no-ops — no sentinel routing needed
            delta = torch.zeros((npos + G * M, 2 * D), dtype=torch.float32,
                                device=vc.device)
            delta[:npos, :D] = o["dv"].reshape(npos, D)
            delta[:npos, D:] = o["dc"].reshape(npos, D)
            delta[npos:, D:] = o["dP"].reshape(G * M, D)
            ids = torch.cat([chain.reshape(npos), pool_ids.reshape(-1)])
            scatter_add_(vc, ids, delta.mul_(-lr))
        return state, _mean_loss(o, k, negative_weight)

    step.pool_shape = (G, M)   # the shape of each of the `draws`
    return step


def banded_fused_pack(state):
    """Canonical graph state -> fused-arena state (one concat per episode)."""
    vertex, context = state["tables"]
    return {"tables": (torch.cat([vertex, context], dim=-1),),
            "moments": ((),)}


def banded_fused_unpack(state):
    (vc,) = state["tables"]
    D = vc.shape[1] // 2
    return {"tables": (vc[:, :D].contiguous(), vc[:, D:].contiguous()),
            "moments": ((), ())}


def make_graph_banded_walk_step(opt: Optimizer, num_negative: int,
                                negative_weight: float, aug: int,
                                bidir: bool, pool_size: int = 128,
                                pool_groups: int = 8, trust: float = 0.25):
    """Shared-negative-pool graph step over WHOLE WALKS on separate vertex
    and context tables (moment optimizers, or SGD with the trust clip):
    each chain vertex is gathered once as head and once as context and
    receives ONE accumulated update for all pairs it takes part in. Updates
    go through optim.apply_row_updates (the scatter kernel on SGD).

    GRAPHVITE_SWEEP_BANDED=1 (the reference's experimental switch, read
    when the step is built; SGD only): the vertex update, and the context
    update over chain and pool rows, take kernel 1's unsorted front end
    directly, ids unmasked (dead slots carry exactly-zero gradients). On
    bf16 tables each delta is rounded to bf16 before the sum, as the
    reference's front end permutes bf16 deltas.

    step(state, chain [B, L1], _ (chain again, ignored), lr, *neg_state,
         mask [B, L1, T]) -> (state, loss); B % pool_groups == 0."""
    core, (k, M, G, T, _) = make_graph_banded_core(
        opt, num_negative, negative_weight, aug, bidir, pool_size,
        pool_groups, trust)
    sweep_banded = (os.environ.get("GRAPHVITE_SWEEP_BANDED", "0") == "1"
                    and opt.num_moment == 0)

    def step(state, chain, _tails, lr, *neg_state, mask=None,
             generator=None, draws=None):
        vertex, context = state["tables"]
        v_moms, c_moms = state["moments"]
        B, L1 = chain.shape
        npos = B * L1
        pool_ids = _pool_ids(neg_state, G, M, vertex.device, generator,
                             draws)
        if mask is None:
            mask = torch.ones((B, L1, T), dtype=torch.float32,
                              device=vertex.device)
        v = vertex[chain].float()                            # [B, L1, D]
        c = context[chain].float()
        P = context[pool_ids].float()                        # [G, M, D]

        o = core(v, c, P, mask, lr,
                 table_bf16=vertex.dtype == torch.bfloat16)
        D = v.shape[-1]

        with tracing.span(tracing.UPDATE):
            v_counts = v_sqs = c_counts = c_sqs = None
            if opt.num_moment > 0:
                v_counts = o["v_counts"]
                v_sqs = o["v_sqs"]
                c_counts = torch.cat([o["c_counts_main"],
                                      o["p_counts"].reshape(-1)])
                c_sqs = torch.cat([o["c_sqs_main"],
                                   o["p_sqs"].reshape(G * M, D)])

            flat_ids = chain.reshape(npos)
            if sweep_banded:
                def delta(x):
                    x = x.reshape(-1, D) * -lr
                    return (x.bfloat16().float()
                            if vertex.dtype == torch.bfloat16 else x)

                scatter_add_(vertex, flat_ids, delta(o["dv"]))
                scatter_add_(context,
                             torch.cat([flat_ids, pool_ids.reshape(-1)]),
                             delta(torch.cat([o["dc"].reshape(npos, D),
                                              o["dP"].reshape(G * M, D)])))
                return state, _mean_loss(o, k, negative_weight)
            head_mask = (o["cnt"] > 0).reshape(npos).float()
            new_vertex, new_v_moms = apply_row_updates(
                vertex, v_moms,
                _mask_ids(flat_ids, head_mask, vertex.shape[0]),
                o["dv"].reshape(npos, D), opt, lr,
                entry_counts=v_counts, entry_sqs=v_sqs, trust=trust)
            ctx_mask = (o["cntc"] > 0).reshape(npos).float()
            ctx_ids = torch.cat(
                [_mask_ids(flat_ids, ctx_mask, context.shape[0]),
                 pool_ids.reshape(-1)])
            ctx_grads = torch.cat(
                [o["dc"].reshape(npos, D), o["dP"].reshape(G * M, D)])
            new_context, new_c_moms = apply_row_updates(
                context, c_moms, ctx_ids, ctx_grads, opt, lr,
                entry_counts=c_counts, entry_sqs=c_sqs, trust=trust)
        new_state = {"tables": (new_vertex, new_context),
                     "moments": (new_v_moms, new_c_moms)}
        return new_state, _mean_loss(o, k, negative_weight)

    step.pool_shape = (G, M)   # the shape of each of the `draws`
    return step


# ---------------------------------------------------------------------------
# knowledge graph (tied entity table + global relation table)
# ---------------------------------------------------------------------------

def _adversarial_weights(logits, temperature, uniform):
    """Self-adversarial softmax over a sample's negatives (the reference's
    stale-normalizer clip min(., 1) kept for parity), or uniform mass."""
    if temperature > EPSILON:
        return torch.clamp(torch.softmax(logits / temperature, dim=-1),
                           max=1.0)
    return torch.full_like(logits, uniform)


def _mean_sample_loss(sample_loss, mask):
    """The mean loss over the valid samples, which it counts."""
    if mask is None:
        tracing.count(tracing.VALID_PAIRS, sample_loss.numel())
        return sample_loss.mean()
    n_active = mask.sum()
    tracing.count(tracing.VALID_PAIRS, n_active)
    return sample_loss.sum() / torch.clamp(n_active, min=1.0)


def make_kg_train_step(model, opt: Optimizer, num_negative: int,
                       margin_or_l3: float, adversarial_temperature: float,
                       relation_lr_multiplier: float, external_pool=False):
    """The classic per-draw step. state tables: (entity, relation).
    Negatives are uniform over 2 * num_entity ids: id < V corrupts the
    head, else the tail (the split-id trick of the reference's
    gpu/knowledge_graph.cuh:65-69 over the whole entity table).

    step(state, heads [B], tails [B], rels [B], lr, mask=None,
    negatives=None, generator=None) -> (state, loss); `negatives` =
    (cand_ids [B, K], corrupt_head [B, K] bool) replaces the draw.

    With `external_pool=True` the candidate ROWS come from a caller-owned
    negative pool (the sharded trainer's global pool): step(...,
    pool=(pool_rows [N, D], pool_idx [B, K], corrupt_head [B, K])) ->
    (state, loss, cand_grad), the candidates left out of the entity
    update and their [B, K, D] regularized gradients returned for the
    caller to route back to the rows' owners."""
    k = num_negative

    def step(state, heads, tails, rels, lr, mask=None, negatives=None,
             generator=None, pool=None):
        entity, relation = state["tables"]
        e_moms, r_moms = state["moments"]
        b = heads.shape[0]
        num_entity = entity.shape[0]
        if external_pool:
            pool_rows, pool_idx, corrupt_head = pool
            cand_ids = None
        elif negatives is None:
            neg_ids = torch.randint(0, 2 * num_entity, (b, k),
                                    generator=generator,
                                    device=entity.device)
            corrupt_head = neg_ids < num_entity
            cand_ids = torch.where(corrupt_head, neg_ids,
                                   neg_ids - num_entity)
        else:
            cand_ids, corrupt_head = negatives

        # gather only the K+2 distinct rows per sample (positive head,
        # positive tail, K candidates): the corrupted side takes the
        # candidate row, the other side the positive row
        h_pos = entity[heads][:, None, :].float()            # [B, 1, D]
        t_pos = entity[tails][:, None, :].float()
        if external_pool:
            cand = pool_rows[pool_idx].float()               # [B, K, D]
        else:
            cand = entity[cand_ids].float()
        ch = corrupt_head[..., None]
        h = torch.cat([torch.where(ch, cand, h_pos), h_pos], dim=1)
        t = torch.cat([torch.where(ch, t_pos, cand), t_pos], dim=1)
        r = relation[rels][:, None, :].float()               # [B, 1, D]
        logits = model.score(h, t, r, margin_or_l3)          # [B, K+1]

        prob = torch.sigmoid(logits)
        pos_loss = F.softplus(-logits[:, -1])
        neg_logits = logits[:, :k]
        neg_w = _adversarial_weights(neg_logits, adversarial_temperature,
                                     1.0 / k)
        neg_loss = (neg_w * F.softplus(neg_logits)).sum(dim=-1)
        sample_loss = (pos_loss + neg_loss) / 2.0

        label = torch.zeros_like(logits)
        label[:, k] = 1.0
        gradient = prob - label
        weight = torch.cat([neg_w, torch.ones_like(logits[:, :1])], dim=1)
        if mask is not None:
            gradient = gradient * mask[:, None]
            weight = weight * mask[:, None]
            sample_loss = sample_loss * mask

        gh, gt, gr = model.backward(h, t, r, gradient, margin_or_l3)
        w = weight[..., None]
        wd = opt.weight_decay
        reg_h = w * (gh + wd * h)                            # [B, K+1, D]
        reg_t = w * (gt + wd * t)
        # relation row: one touch per subsample s = 0..K
        per_touch_r = w * (gr + wd * r)
        reg_r = per_touch_r.sum(dim=1)                       # [B, D]

        # scatter K+2 rows per sample: candidate rows get the corrupted
        # side's gradient; the positive rows their positive-pair gradient
        # plus every negative subsample where they stayed in place, with
        # true touch counts and per-touch squares for the moment rules
        cand_grad = torch.where(ch, reg_h[:, :k], reg_t[:, :k])
        chf = ch.to(reg_h.dtype)
        head_touch = reg_h[:, :k] * (1 - chf)                # [B, K, D]
        tail_touch = reg_t[:, :k] * chf
        head_grad = reg_h[:, k] + head_touch.sum(dim=1)
        tail_grad = reg_t[:, k] + tail_touch.sum(dim=1)
        ent_ids = [_mask_ids(heads, mask, num_entity).long(),
                   _mask_ids(tails, mask, num_entity).long()]
        ent_grads = [head_grad, tail_grad]
        if not external_pool:
            ent_ids.append(
                _mask_ids(cand_ids, mask, num_entity).reshape(-1).long())
            ent_grads.append(cand_grad.reshape(b * k, -1))
        ent_ids = torch.cat(ent_ids)
        ent_grads = torch.cat(ent_grads)
        ent_counts = ent_sqs = r_counts = r_sqs = None
        if opt.num_moment > 0:
            chn = corrupt_head.float()                       # [B, K]
            ent_counts = [1 + (1 - chn).sum(dim=1), 1 + chn.sum(dim=1)]
            ent_sqs = [
                reg_h[:, k] ** 2 + (head_touch * head_touch).sum(dim=1),
                reg_t[:, k] ** 2 + (tail_touch * tail_touch).sum(dim=1)]
            if not external_pool:
                ent_counts.append(torch.ones(b * k, device=entity.device))
                ent_sqs.append((cand_grad * cand_grad).reshape(b * k, -1))
            ent_counts = torch.cat(ent_counts)
            ent_sqs = torch.cat(ent_sqs)
            r_counts = torch.full((b,), k + 1.0, device=entity.device)
            r_sqs = (per_touch_r * per_touch_r).sum(dim=1)
        new_entity, new_e_moms = apply_row_updates(
            entity, e_moms, ent_ids, ent_grads, opt, lr,
            entry_counts=ent_counts, entry_sqs=ent_sqs)
        new_relation, new_r_moms = apply_row_updates(
            relation, r_moms, _mask_ids(rels, mask, relation.shape[0]),
            reg_r, opt, lr, lr_scale=relation_lr_multiplier,
            entry_counts=r_counts, entry_sqs=r_sqs)
        new_state = {"tables": (new_entity, new_relation),
                     "moments": (new_e_moms, new_r_moms)}
        if external_pool:
            return new_state, _mean_sample_loss(sample_loss, mask), cand_grad
        return new_state, _mean_sample_loss(sample_loss, mask)

    step.num_negative = k
    return step


def kg_pool_groups(batch_size: int, target_group: int = 512,
                   lo: int = 2, hi: int = 1024):
    """Group count for the pooled KG step: bounds the per-group sample
    count Bg so a shared candidate row's emulated touch count (Bg * K / M)
    stays near the staleness bound. Always even (half the pool corrupts
    heads, half tails)."""
    g = lo
    while g < hi and batch_size // g > target_group:
        g *= 2
    while (batch_size % g or g % 2) and g > 2:
        g //= 2
    return max(g, 2)


# the pooled step scores several groups in one pass while one
# [g, Bg, M/2, D/2] intermediate stays under this many elements (128 MiB
# in float32): one group per pass at the rotate_fb15k.yaml shape (464 x 64
# x 1024), four at rotate_wikidata5m.yaml's (476 x 64 x 256). The RotatE
# body's kernels on the card hold no such intermediate: one pass.
GROUP_PASS_ELEMS = 1 << 25


def _halves(x):
    """Interleaved (re, im) -> contiguous (re, im) halves."""
    re, im = x.reshape(x.shape[:-1] + (x.shape[-1] // 2, 2)).unbind(-1)
    return re.contiguous(), im.contiguous()


def _interleave(re, im):
    out = torch.stack([re, im], dim=-1)
    return out.reshape(out.shape[:-2] + (-1,))


def make_kg_pool_step(model, opt: Optimizer, num_negative: int,
                      margin_or_l3: float, adversarial_temperature: float,
                      relation_lr_multiplier: float, pool_size: int = 0,
                      pool_groups: int = 8, trust: float = 0.25):
    """Shared-candidate-pool KG step with mixed-side pools.

    Each group of Bg samples shares ONE pool of M candidate rows; the
    first M/2 slots score as head corruptions and the rest as tail
    corruptions, so negative scoring is two broadcasts, score(cand, t) and
    score(h, cand), while each sample's self-adversarial softmax still
    normalizes over a mixed candidate set, as the reference's
    uniform-over-2V draw does. Candidate gather and scatter drop from B*K
    rows to G*M. Moment rules get emulated K-draw touch counts (a pool
    slot stands for K/M draws per active sample; positive rows 1 + K/2)
    and M/K-rescaled squared-gradient sums. The accumulated candidate-row
    displacement is clipped to `trust` x (its norm + 1e-2).

    Bodies: the generic one calls the model's score and backward on
    [g, Bg, M/2, D] broadcasts. For RotatE with weight_decay 0 (unless
    GRAPHVITE_KG_FAST=0) the isometry body: |c e^{i phi} - t| = |c - t
    e^{-i phi}|, so the negative chains are ONE complex difference d = c -
    u per pair with u rotated once per sample, and every gradient and
    square factors through sums of z = gn/rho * d over the samples or the
    candidates, on half-width [g, Bg, M/2, D/2] tensors. The generic body
    adds EPSILON to the distance (the model's backward), the isometry
    body clamps the squared distance at EPSILON^2 under an rsqrt, as the
    reference's bodies do.

    Where the reference scans the G groups one at a time, this step takes
    several per pass: as many as keep one intermediate under
    GROUP_PASS_ELEMS elements (a divisor of G). The sums are per group
    either way. On the card the isometry body's pair work runs in two
    hand-written kernels over all G groups at once (ops/rotate_pool.py),
    with no [g, Bg, M/2, D/2] tensor in device memory: one pass.

    step(state, heads [B], tails [B], rels [B], lr, mask=None,
    negatives=None, generator=None) -> (state, loss); B % pool_groups ==
    0; `negatives` = candidate ids [G, M] (`step.pool_shape`)."""
    k = num_negative
    # default pool: every group gets at least 64 distinct candidates and
    # never fewer than 2K (the reference's quality finding on its math
    # fixture)
    M = int(pool_size) if pool_size else max(2 * int(num_negative), 64)
    M += M % 2
    G = int(pool_groups)
    M2 = M // 2
    uses_margin = bool(getattr(model, "uses_margin", False))
    bw_hyper = margin_or_l3 if uses_margin else 0.0
    l3 = 0.0 if uses_margin else margin_or_l3
    sq_scale = M / max(k, 1)
    need_sq = opt.num_moment > 0
    fast_rotate = (getattr(model, "name", "") == "RotatE"
                   and opt.weight_decay == 0.0
                   and os.environ.get("GRAPHVITE_KG_FAST", "1") != "0")
    wd = opt.weight_decay

    def _reg(p):
        r = wd * p
        if not uses_margin and l3:
            r = r + (3.0 * l3) * p.abs() * p
        return r

    def negative_outs(logits, m_g):
        """Shared tail of both bodies: weights, loss and the per-pair
        gradient scale gn [g, Bg, M] from the logits."""
        w = _adversarial_weights(logits, adversarial_temperature, 1.0 / M)
        if m_g is not None:
            w = w * m_g[..., None]
        loss_neg = (w * F.softplus(logits)).sum(dim=-1)
        return w, loss_neg, torch.sigmoid(logits) * w

    def fast_rotate_body(h, t, r, cand, m_g):
        """RotatE negatives of g groups: h, t, r [g, Bg, D], cand
        [g, M, D], m_g [g, Bg] or None."""
        Dh = h.shape[-1] // 2
        h_re, h_im = _halves(h)                              # [g, Bg, Dh]
        t_re, t_im = _halves(t)
        phase = r[..., :Dh]
        cosp, sinp = torch.cos(phase), torch.sin(phase)      # per SAMPLE
        # u = t * e^{-i phi} (head-corrupt frame), w = h * e^{i phi}
        u_re = t_re * cosp + t_im * sinp
        u_im = t_im * cosp - t_re * sinp
        w_re = h_re * cosp - h_im * sinp
        w_im = h_re * sinp + h_im * cosp
        c_re, c_im = _halves(cand)                           # [g, M, Dh]
        # logits, the adversarial tail and the gradient sums of every
        # (sample, candidate) pair: the kernels on the card, plain
        # PyTorch on the CPU
        loss_neg, sh, st = rotate_pool.pool_sums(
            u_re, u_im, w_re, w_im, c_re, c_im, margin_or_l3,
            lambda logits: negative_outs(logits, m_g), need_sq)

        # head-corrupt: d = c - u, dL/dc = -z, dL/dt = +R^{+phi}(z);
        # tail-corrupt: d = w - c, dL/dc = +z, dL/dh = -R^{-phi}(z)
        tail_g = _interleave(sh["E_re"] * cosp - sh["E_im"] * sinp,
                             sh["E_re"] * sinp + sh["E_im"] * cosp)
        head_g = -_interleave(st["E_re"] * cosp + st["E_im"] * sinp,
                              st["E_im"] * cosp - st["E_re"] * sinp)
        # phase gradient per pair: z_re * f_im - z_im * f_re, f the frame
        gphase = ((sh["E_re"] * u_im - sh["E_im"] * u_re)
                  + (st["E_re"] * w_im - st["E_im"] * w_re))
        outs = {
            "cand": torch.cat([_interleave(-sh["B_re"], -sh["B_im"]),
                               _interleave(st["B_re"], st["B_im"])], dim=1),
            "head": head_g, "tail": tail_g,
            "rel": torch.cat([gphase, torch.zeros_like(gphase)], dim=-1),
            "loss": loss_neg,
        }
        if need_sq:
            outs["cand_sqs"] = sq_scale * torch.cat(
                [_interleave(sh["B_rr"], sh["B_ii"]),
                 _interleave(st["B_rr"], st["B_ii"])], dim=1)
            # staying-side squares: the per-pair gradient is a rotation of
            # z, which mixes re and im BEFORE the square
            c2, s2, cs = cosp * cosp, sinp * sinp, cosp * sinp
            outs["tail_sqs"] = sq_scale * _interleave(
                c2 * sh["S_rr"] - 2.0 * cs * sh["S_ri"] + s2 * sh["S_ii"],
                s2 * sh["S_rr"] + 2.0 * cs * sh["S_ri"] + c2 * sh["S_ii"])
            outs["head_sqs"] = sq_scale * _interleave(
                c2 * st["S_rr"] + 2.0 * cs * st["S_ri"] + s2 * st["S_ii"],
                s2 * st["S_rr"] - 2.0 * cs * st["S_ri"] + c2 * st["S_ii"])
            ph_h = (u_im * u_im * sh["S_rr"] - 2.0 * u_re * u_im * sh["S_ri"]
                    + u_re * u_re * sh["S_ii"])
            ph_t = (w_im * w_im * st["S_rr"] - 2.0 * w_re * w_im * st["S_ri"]
                    + w_re * w_re * st["S_ii"])
            outs["rel_sqs"] = sq_scale * torch.cat(
                [ph_h + ph_t, torch.zeros_like(ph_h)], dim=-1)
        return outs

    def body(h, t, r, cand, m_g):
        """Negatives of g groups through the model's own score and
        backward; same contract as fast_rotate_body."""
        ch = cand[:, None, :M2]                              # [g, 1, M2, D]
        ct = cand[:, None, M2:]
        h4, t4, r4 = h[:, :, None], t[:, :, None], r[:, :, None]
        lg_h = model.score(ch, t4, r4, margin_or_l3)         # [g, Bg, M2]
        lg_t = model.score(h4, ct, r4, margin_or_l3)
        logits = torch.cat([lg_h, lg_t], dim=-1)             # [g, Bg, M]
        w, loss_neg, gn = negative_outs(logits, m_g)
        gc_h, gs_h, gr_h = model.backward(ch, t4, r4, gn[..., :M2], bw_hyper)
        gs_t, gc_t, gr_t = model.backward(h4, ct, r4, gn[..., M2:], bw_hyper)
        # per-entry regularized gradients [g, Bg, M2, D]; the weights are
        # in gn already, the reg terms scale by w per touch
        w_h = w[..., :M2, None]
        w_t = w[..., M2:, None]
        reg_ch = gc_h + w_h * _reg(ch)
        reg_ct = gc_t + w_t * _reg(ct)
        reg_sh = gs_h + w_h * _reg(t4)                       # tail stays
        reg_st = gs_t + w_t * _reg(h4)                       # head stays
        rel_h = gr_h + w_h * _reg(r4)
        rel_t = gr_t + w_t * _reg(r4)
        outs = {
            "cand": torch.cat([reg_ch.sum(dim=1), reg_ct.sum(dim=1)], dim=1),
            "head": reg_st.sum(dim=2),                       # [g, Bg, D]
            "tail": reg_sh.sum(dim=2),
            "rel": rel_h.sum(dim=2) + rel_t.sum(dim=2),
            "loss": loss_neg,
        }
        if need_sq:
            outs["cand_sqs"] = sq_scale * torch.cat(
                [(reg_ch * reg_ch).sum(dim=1), (reg_ct * reg_ct).sum(dim=1)],
                dim=1)
            outs["head_sqs"] = sq_scale * (reg_st * reg_st).sum(dim=2)
            outs["tail_sqs"] = sq_scale * (reg_sh * reg_sh).sum(dim=2)
            outs["rel_sqs"] = sq_scale * ((rel_h * rel_h).sum(dim=2)
                                          + (rel_t * rel_t).sum(dim=2))
        return outs

    def step(state, heads, tails, rels, lr, mask=None, negatives=None,
             generator=None):
        entity, relation = state["tables"]
        e_moms, r_moms = state["moments"]
        b = heads.shape[0]
        num_entity, dim = entity.shape
        if b % G:
            raise ValueError("batch %d must divide into %d pool groups"
                             % (b, G))
        bg = b // G
        dev = entity.device
        maskf = None if mask is None else mask.float()
        if negatives is not None:
            cand_ids = negatives
        else:
            with tracing.span(tracing.NEGATIVES):
                cand_ids = torch.randint(0, num_entity, (G, M),
                                         generator=generator, device=dev)

        # ---- positive pairs: one [B, D]-wide pass, no K dimension ------
        h_pos = entity[heads].float()
        t_pos = entity[tails].float()
        r_pos = relation[rels].float()
        cand = entity[cand_ids].float()                      # [G, M, D]
        pos_logit = model.score(h_pos, t_pos, r_pos, margin_or_l3)
        g_pos = torch.sigmoid(pos_logit) - 1.0
        pos_loss = F.softplus(-pos_logit)
        if maskf is not None:
            g_pos = g_pos * maskf
            pos_loss = pos_loss * maskf
        # backward(margin_or_l3) already includes the l3 term; add only wd
        ghp, gtp, grp = model.backward(h_pos, t_pos, r_pos, g_pos,
                                       margin_or_l3)
        wp = 1.0 if maskf is None else maskf[:, None]
        reg_hp = ghp + wp * (wd * h_pos)
        reg_tp = gtp + wp * (wd * t_pos)
        reg_rp = grp + wp * (wd * r_pos)

        # ---- negatives, `gp` groups per pass ---------------------------
        if fast_rotate and dev.type == "cuda":
            gp = G      # the kernels hold no [g, Bg, M/2, D/2] tensor
        else:
            width = dim // 2 if fast_rotate else dim
            gp = min(max(GROUP_PASS_ELEMS // max(bg * M2 * width, 1), 1), G)
            while G % gp:
                gp -= 1
        h3 = h_pos.reshape(G, bg, dim)
        t3 = t_pos.reshape(G, bg, dim)
        r3 = r_pos.reshape(G, bg, dim)
        m3 = None if maskf is None else maskf.reshape(G, bg)
        run = fast_rotate_body if fast_rotate else body
        parts = []
        for g0 in range(0, G, gp):
            sl = slice(g0, g0 + gp)
            parts.append(run(h3[sl], t3[sl], r3[sl], cand[sl],
                             None if m3 is None else m3[sl]))
        outs = parts[0] if len(parts) == 1 else {
            key: torch.cat([p[key] for p in parts]) for key in parts[0]}
        # active samples per group (touch counts are NOT weight-scaled:
        # each draw is one optimizer touch however small its weight)
        msum = (torch.full((G,), float(bg), device=dev) if m3 is None
                else m3.sum(dim=1))

        with tracing.span(tracing.UPDATE):
            # ---- assemble entity updates -------------------------------
            head_grad = reg_hp + outs["head"].reshape(b, -1)
            tail_grad = reg_tp + outs["tail"].reshape(b, -1)
            cand_grad = outs["cand"].reshape(G * M, -1)
            if trust is not None:
                # a shared candidate row accumulates Bg coherent sample
                # gradients at one stale point
                dnorm = torch.linalg.vector_norm(cand_grad, dim=-1,
                                                 keepdim=True)
                limit = (trust * (torch.linalg.vector_norm(
                    cand.reshape(G * M, -1), dim=-1, keepdim=True) + 1e-2)
                    / max(lr, EPSILON))
                cand_grad = cand_grad * torch.clamp(
                    limit / torch.clamp(dnorm, min=EPSILON), max=1.0)
            ent_ids = torch.cat([
                _mask_ids(heads, mask, num_entity).long(),
                _mask_ids(tails, mask, num_entity).long(),
                cand_ids.reshape(-1).long()])
            ent_grads = torch.cat([head_grad, tail_grad, cand_grad])
            rel_grad = reg_rp + outs["rel"].reshape(b, -1)

            ent_counts = ent_sqs = r_counts = r_sqs = None
            if need_sq:
                kf = float(k)
                # positives: 1 own touch + K/2 expected stay-side touches;
                # each pool slot stands for msum * K / M emulated draws
                ent_counts = torch.cat([
                    torch.full((2 * b,), 1.0 + kf / 2.0, device=dev),
                    (msum * (kf / M)).repeat_interleave(M)])
                ent_sqs = torch.cat([
                    reg_hp * reg_hp + outs["head_sqs"].reshape(b, -1),
                    reg_tp * reg_tp + outs["tail_sqs"].reshape(b, -1),
                    outs["cand_sqs"].reshape(G * M, -1)])
                r_counts = torch.full((b,), kf + 1.0, device=dev)
                r_sqs = reg_rp * reg_rp + outs["rel_sqs"].reshape(b, -1)

            new_entity, new_e_moms = apply_row_updates(
                entity, e_moms, ent_ids, ent_grads, opt, lr,
                entry_counts=ent_counts, entry_sqs=ent_sqs)
            new_relation, new_r_moms = apply_row_updates(
                relation, r_moms, _mask_ids(rels, mask, relation.shape[0]),
                rel_grad, opt, lr, lr_scale=relation_lr_multiplier,
                entry_counts=r_counts, entry_sqs=r_sqs)
        new_state = {"tables": (new_entity, new_relation),
                     "moments": (new_e_moms, new_r_moms)}
        sample_loss = (pos_loss + outs["loss"].reshape(b)) / 2.0
        return new_state, _mean_sample_loss(sample_loss, mask)

    step.pool_shape = (G, M)   # the shape of `negatives`
    step.fast_rotate = fast_rotate
    return step


def kg_predict(model, entity, relation, heads, tails, rels, margin_or_l3):
    return model.score(entity[heads], entity[tails], relation[rels],
                       margin_or_l3)


# ---------------------------------------------------------------------------
# visualization / LargeVis: one shared coordinate table (ref
# gpu/visualization.cuh)
# ---------------------------------------------------------------------------

def make_vis_train_step(model, opt: Optimizer, num_negative: int,
                        negative_weight: float, trust=None):
    """The classic LargeVis step: K negative draws per sample, each scored
    with the student-t kernel 1/(1+x), x = ||h - t||^2, and the
    reference's smoothed negative gradient -2 prob / (x + SMOOTH_TERM).
    Head rows get K+1 touches, tail and negative rows one each.

    step(state, heads [B], tails [B], lr, *neg_state, mask=None,
    generator=None, draws=None) -> (state, loss); `draws` = (u1, u2)
    [B, K] negative-sampler uniforms (`step.draw_shape(B)`)."""
    k = num_negative

    def step(state, heads, tails, lr, *neg_state, mask=None,
             generator=None, draws=None):
        (coord,) = state["tables"]
        (moms,) = state["moments"]
        b = heads.shape[0]
        v = coord.shape[0]
        dev = coord.device
        if draws is None:
            draws = alias_draws(neg_state, (b, k), generator, dev)
        negs = device_sample(*neg_state, *draws)             # [B, K]

        h = coord[heads][:, None, :].float()                 # [B, 1, D]
        t_ids = torch.cat([negs, tails[:, None].long()], dim=1)
        t = coord[t_ids].float()                             # [B, K+1, D]
        x = model.score(h, t)                                # [B, K+1]
        prob = 1.0 / (1.0 + x)
        gradient = torch.cat([-2.0 * prob[:, :k] / (x[:, :k] + SMOOTH_TERM),
                              2.0 * prob[:, k:]], dim=1)
        weight = torch.cat([torch.full((b, k), float(negative_weight),
                                       device=dev),
                            torch.ones((b, 1), device=dev)], dim=1)
        if mask is not None:
            gradient = gradient * mask[:, None]
            weight = weight * mask[:, None]
        # prob = 1/(1+x): -log(prob) = log1p(x); -log(1-prob) = log1p(x) -
        # log(x), with an epsilon floor on x only
        log1px = torch.log1p(x)
        loss = torch.cat([log1px[:, :k] - torch.log(x[:, :k] + EPSILON),
                          log1px[:, k:]], dim=1)
        sample_loss = ((weight * loss).sum(dim=-1)
                       / (1.0 + k * negative_weight))

        gh, gt = model.backward(h, t, gradient)
        w = weight[..., None]
        wd = opt.weight_decay
        per_touch_h = w * (gh + wd * h)                      # [B, K+1, D]
        reg_h = per_touch_h.sum(dim=1)
        reg_t = w * (gt + wd * t)
        ids = torch.cat([_mask_ids(heads.long(), mask, v),
                         _mask_ids(t_ids, mask, v).reshape(-1)])
        grads = torch.cat([reg_h, reg_t.reshape(b * (k + 1), -1)])
        counts = sqs = None
        if opt.num_moment > 0:
            counts = torch.cat([torch.full((b,), k + 1.0, device=dev),
                                torch.ones(b * (k + 1), device=dev)])
            sqs = torch.cat([(per_touch_h * per_touch_h).sum(dim=1),
                             (reg_t * reg_t).reshape(b * (k + 1), -1)])
        new_coord, new_moms = apply_row_updates(
            coord, moms, ids, grads, opt, lr, entry_counts=counts,
            entry_sqs=sqs, trust=trust)
        return ({"tables": (new_coord,), "moments": (new_moms,)},
                _mean_sample_loss(sample_loss, mask))

    step.draw_shape = lambda b: (b, k)
    return step


def make_vis_pool_step(opt: Optimizer, num_negative: int,
                       negative_weight: float, pool_size: int = 256,
                       pool_groups: int = 8, trust: float = 0.25):
    """Shared-negative-pool LargeVis step (make_graph_pool_step's structure
    with the student-t kernel, gpu/visualization.cuh:38-240).

    Each of `pool_groups` groups draws ONE pool of `pool_size` rows and
    every sample of the group scores the whole pool through pairwise
    squared distances ||h||^2 + ||P||^2 - 2 h.P (a batched product),
    weighted negative_weight * K / pool_size per pool row, so the
    expected negative gradient mass per sample matches K draws. Row
    traffic per batch drops from B*(2+K) entries to 2B + G*M, all in one
    `apply_row_updates` call (kernel 1 at the table's width on SGD with
    `trust`; the dense moment route on small tables). Moment optimizers
    get the emulated K-draw touch counts (head K+1, tail 1, pool row
    Bg*K/M) and M/K-rescaled squared-gradient sums.

    step(state, heads [B], tails [B], lr, *neg_state, mask=None,
    generator=None, draws=None) -> (state, loss); B % pool_groups == 0;
    `draws` = (u1, u2) [G, M] pool uniforms (`step.pool_shape`)."""
    k = num_negative
    M = int(pool_size)
    G = int(pool_groups)
    neg_w = float(negative_weight) * k / M

    def step(state, heads, tails, lr, *neg_state, mask=None,
             generator=None, draws=None):
        (coord,) = state["tables"]
        (moms,) = state["moments"]
        b = heads.shape[0]
        v = coord.shape[0]
        dev = coord.device
        if b % G:
            raise ValueError("batch %d must divide into %d pool groups"
                             % (b, G))
        bg = b // G
        pool_ids = _pool_ids(neg_state, G, M, dev, generator, draws)

        h = coord[heads].reshape(G, bg, -1).float()
        t = coord[tails].reshape(G, bg, -1).float()
        P = coord[pool_ids].float()                          # [G, M, D]

        d = h - t
        x_pos = (d * d).sum(dim=-1)                          # [G, Bg]
        gpos = 2.0 / (1.0 + x_pos)                           # 2 * prob
        # x, the gradients and the squared sums below are differences of
        # batched products whose terms cancel where a pool row's weight
        # sits on the heads nearest it (x -> 0 far from the origin, once a
        # layout spreads): in float32 their rounding, and so the order of
        # the sums, would move the result by up to ~1e-4 of a row. The
        # products and the differences run in float64 (the reference's are
        # float32); the elementwise passes stay in float32.
        h64, P64 = h.double(), P.double()
        hh = (h64 * h64).sum(dim=-1)
        pp = (P64 * P64).sum(dim=-1)
        x = (hh[:, :, None] + pp[:, None, :]
             - 2.0 * torch.bmm(h64, P64.transpose(1, 2))).float()
        x = torch.clamp(x, min=0.0)
        prob = 1.0 / (1.0 + x)
        gneg = -2.0 * prob / (x + SMOOTH_TERM) * neg_w       # [G, Bg, M]
        if mask is not None:
            m2 = mask.reshape(G, bg)
            gpos = gpos * m2
            gneg = gneg * m2[..., None]
            n_active = mask.sum()
            tracing.count(tracing.VALID_PAIRS, n_active)
        else:
            m2 = None
            n_active = torch.full((), float(b), device=dev)
            tracing.count(tracing.VALID_PAIRS, b)

        # loss on the K-draw scale (as make_vis_train_step reports it)
        loss_terms = (torch.log1p(x_pos)
                      + neg_w * (torch.log1p(x)
                                 - torch.log(x + EPSILON)).sum(dim=-1))
        if m2 is not None:
            loss_terms = loss_terms * m2
        mean_loss = (loss_terms.sum() / torch.clamp(n_active, min=1.0)
                     / (1.0 + k * negative_weight))

        with tracing.span(tracing.UPDATE):
            wd = opt.weight_decay
            gneg64 = gneg.double()
            # sum_m gneg (h - P_m) and sum_b gneg (P - h_b), in float64
            h_neg = (gneg64.sum(dim=-1)[..., None] * h64
                     - torch.bmm(gneg64, P64)).float()
            p_neg = (gneg64.sum(dim=1)[..., None] * P64
                     - torch.bmm(gneg64.transpose(1, 2), h64)).float()
            dh = gpos[..., None] * d + h_neg + wd * (1.0 + M * neg_w) * h
            dt = -gpos[..., None] * d + wd * t
            dP = p_neg + wd * (neg_w * bg) * P

            counts = sqs = None
            if opt.num_moment > 0:
                # EMULATED K-draw touch counts: a moment rule moves a row by
                # ~lr * count, so counts follow the K-draw scheme this step
                # emulates, not its M pool terms. Per-draw grad = (M/K) x
                # per-term grad, so summed squares rescale by M/K.
                sq_scale = M / max(k, 1)
                g2 = gneg64 * gneg64
                h_neg_sqs = (g2.sum(dim=-1)[..., None] * (h64 * h64)
                             - 2.0 * h64 * torch.bmm(g2, P64)
                             + torch.bmm(g2, P64 * P64)).float()
                t_sqs = (gpos[..., None] * d) ** 2
                h_sqs = t_sqs + sq_scale * h_neg_sqs
                g2T = g2.transpose(1, 2)
                p_sqs = sq_scale * (g2.sum(dim=1)[..., None] * (P64 * P64)
                                    - 2.0 * P64 * torch.bmm(g2T, h64)
                                    + torch.bmm(g2T, h64 * h64)).float()
                if m2 is None:
                    p_counts = torch.full((G, M), bg * k / M, device=dev)
                else:
                    p_counts = (m2.sum(dim=1)[:, None] * (k / M)).expand(G, M)
                counts = torch.cat([torch.full((b,), k + 1.0, device=dev),
                                    torch.ones(b, device=dev),
                                    p_counts.reshape(-1)])
                # squared-gradient sums are nonnegative by construction; the
                # expanded (a-b)^2 forms can dip below zero in floating point
                sqs = torch.clamp(torch.cat([h_sqs.reshape(b, -1),
                                             t_sqs.reshape(b, -1),
                                             p_sqs.reshape(G * M, -1)]),
                                  min=0.0)

            ids = torch.cat([_mask_ids(heads.long(), mask, v),
                             _mask_ids(tails.long(), mask, v),
                             pool_ids.reshape(-1)])
            grads = torch.cat([dh.reshape(b, -1), dt.reshape(b, -1),
                               dP.reshape(G * M, -1)])
            new_coord, new_moms = apply_row_updates(
                coord, moms, ids, grads, opt, lr, entry_counts=counts,
                entry_sqs=sqs, trust=trust)
        return ({"tables": (new_coord,), "moments": (new_moms,)},
                mean_loss)

    step.pool_shape = (G, M)   # the shape of each of the `draws`
    return step


def make_micro_step(step_fn, num_micro: int, has_relation: bool = False):
    """Split each batch into `num_micro` sequential micro-steps: chunk i's
    row updates are applied before chunk i+1 is scored (bounds the touches
    per row per application; the batch size stays the configured one for
    the LR schedule and accounting). `has_relation`: the knowledge-graph
    signature step(state, heads, tails, rels, lr, mask=, generator=)."""
    R = int(num_micro)
    if R <= 1:
        return step_fn

    def step(state, heads, tails, *rest, mask=None, generator=None):
        # rest = (rels, lr) with relations, else (lr, *neg_state)
        bm = heads.shape[0] // R
        losses = []
        for r in range(R):
            sl = slice(r * bm, (r + 1) * bm)
            args = ((rest[0][sl],) + rest[1:]) if has_relation else rest
            state, loss = step_fn(state, heads[sl], tails[sl], *args,
                                  mask=None if mask is None else mask[sl],
                                  generator=generator)
            losses.append(loss)
        return state, torch.stack(losses).mean()

    step.base = step_fn        # the step of one chunk, for replays
    return step


def make_fused_runner(step_fn, sample_fn, opt: Optimizer, ep_groups: int,
                      positive_reuse: int = 1, state_pack=None,
                      state_unpack=None, bulk_sample_fn=None):
    """Episode runner: trains `ep_groups * positive_reuse` batches per call,
    generating each group's positives on the device with `sample_fn` and
    reusing them `positive_reuse` times with fresh negatives. The sample
    is (heads, tails, mask), or (heads, tails, rels, mask) for the
    knowledge-graph steps: its ids go to the step as they come, where the
    reference's runner branches on `has_relation`. With `bulk_sample_fn`
    (a walk sampler's make_episode_sample_fn, GRAPHVITE_BULK_WALKS=1) all
    groups' positives are drawn in one call before the loop, and group g
    takes slice g.

    run(state, batch_id0, num_batch_total, generator, sampler_arrays,
    neg_state) -> (state, losses [ep_groups * positive_reuse]). Losses stay
    on the device: nothing in the loop waits for the card. Each call is an
    `episode` span, each group's sampling a `sample` span and each batch a
    `step` span (utils/tracing.py); each batch counts its pair slots (the
    mask's entries, or the batch's samples)."""
    R = max(int(positive_reuse), 1)

    def run(state, batch_id0, num_batch_total, generator, sampler_arrays,
            neg_state):
        with torch.no_grad(), tracing.span(tracing.EPISODE):
            if state_pack is not None:
                state = state_pack(state)
            losses = []
            if bulk_sample_fn is not None:
                with tracing.span(tracing.SAMPLE, batch=batch_id0):
                    pool = bulk_sample_fn(*sampler_arrays,
                                          generator=generator)
            for g in range(ep_groups):
                b0 = batch_id0 + g * R
                if bulk_sample_fn is not None:
                    *ids, mask = (x[g] for x in pool)
                else:
                    with tracing.span(tracing.SAMPLE, batch=b0):
                        *ids, mask = sample_fn(*sampler_arrays,
                                               generator=generator)
                slots = ids[0].shape[0] if mask is None else mask.numel()
                for r in range(R):
                    lr = opt.schedule_lr(b0 + r, num_batch_total)
                    tracing.count(tracing.PAIR_SLOTS, slots)
                    with tracing.span(tracing.STEP, batch=b0 + r):
                        state, loss = step_fn(state, *ids, lr, *neg_state,
                                              mask=mask, generator=generator)
                    losses.append(loss)
            if state_unpack is not None:
                state = state_unpack(state)
            return state, torch.stack(losses)

    return run


def make_pool_runner(step_fn, num_batch_total: int, opt: Optimizer,
                     has_relation: bool = False):
    """Runner over a pool of stacked batches (the host sampler backend;
    the reference's scan over a pool, steps.py:1730).

    run(state, pool, batch_id0, generator, *neg_state, draws=None) ->
    (state, losses [N]): `pool` = (heads, tails) or (heads, tails, rels),
    each [N, B] on the device; batch i trains at lr = schedule(batch_id0
    + i, num_batch_total) with no mask. `draws`: per batch, the step's own
    draws (a KG step's `negatives`, otherwise its `draws`), or None for
    draws from `generator`. Losses stay on the device. Spans and counters
    as make_fused_runner's, without `sample` (the pool is made on the
    host)."""

    def run(state, pool, batch_id0, generator, *neg_state, draws=None):
        with torch.no_grad(), tracing.span(tracing.EPISODE):
            losses = []
            slots = pool[0].shape[1]
            for i in range(pool[0].shape[0]):
                lr = opt.schedule_lr(batch_id0 + i, num_batch_total)
                d = None if draws is None else draws[i]
                tracing.count(tracing.PAIR_SLOTS, slots)
                with tracing.span(tracing.STEP, batch=batch_id0 + i):
                    if has_relation:
                        state, loss = step_fn(state, pool[0][i], pool[1][i],
                                              pool[2][i], lr, negatives=d,
                                              generator=generator)
                    else:
                        state, loss = step_fn(state, pool[0][i], pool[1][i],
                                              lr, *neg_state,
                                              generator=generator, draws=d)
                losses.append(loss)
            return state, torch.stack(losses)

    return run
