"""Node-embedding training steps and the episode runner (the port of the
shared-negative-pool parts of graphvite_tpu/ops/steps.py).

Each step takes a state dict {"tables": (...), "moments": (...)} and one
batch, samples a shared negative pool per sample group, computes
hand-derived gradients (no autograd) and applies the row updates. Two
batch layouts: whole walks (chain [B, L+1] plus a pair mask [B, L+1, T];
the banded steps, augmentation_step >= 2) and edges (heads [B], tails [B],
mask [B]; `make_graph_pool_step`, augmentation_step 1). Table updates go
through the hand-written CUDA kernels on the card (ops/scatter.py,
ops/gather.py). Tables are updated in place where the update is a
scatter-add, and by the moment kernel.

Random draws: the pool draws (u1, u2) [G, M] are optional inputs
(`draws`); otherwise they come from the `generator` on the tables' device.

Loss conventions match the reference's gpu/graph.cuh:73-92.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from graphvite_tpu_torch.ops.alias import device_sample
from graphvite_tpu_torch.ops.device_sampler import walk_offsets
from graphvite_tpu_torch.ops.gather import gather_sorted
from graphvite_tpu_torch.ops.scatter import (scatter_add_,
                                             scatter_add_sorted_,
                                             scatter_update_,
                                             scatter_update_sorted_)
from graphvite_tpu_torch.optim import Optimizer, apply_row_updates
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
    """Shared-negative-pool step over a batch of edges (the edge route).

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
    * off: `optim.apply_row_updates` (kernel 1 for SGD).
    The trust clip on pool-row gradients applies on every route. On the
    sweep routes masked slots carry zeroed gradients, and masked tails
    park at row V-1 with no touch count.

    step(state, heads [B], tails [B], lr, *neg_state, mask=None,
    generator=None, draws=None) -> (state, loss); B % pool_groups == 0;
    `draws` = (u1, u2) [G, M] pool uniforms (`step.pool_shape`)."""
    if sort_heads:
        raise NotImplementedError(
            "sort_heads (the walk-pair sweep front end, "
            "GRAPHVITE_SWEEP_WALK=1) is not ported yet (ROADMAP queue 1, "
            "item 11)")
    k = num_negative
    M = int(pool_size)
    G = int(pool_groups)
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
        neg_logits = torch.bmm(v, P.transpose(1, 2))         # [G, Bg, M]
        gpos = torch.sigmoid(pos_logit) - 1.0
        gneg = torch.sigmoid(neg_logits) * neg_w
        if mask is not None:
            m2 = mask.reshape(G, bg)
            gpos = gpos * m2
            gneg = gneg * m2[..., None]
            n_active = mask.sum()
        else:
            m2 = None
            n_active = torch.tensor(float(b), device=vertex.device)
        # reported loss on the K-draw scale
        loss_terms = (F.softplus(-pos_logit)
                      + neg_w * F.softplus(neg_logits).sum(dim=-1))
        if m2 is not None:
            loss_terms = loss_terms * m2
        mean_loss = (loss_terms.sum() / torch.clamp(n_active, min=1.0)
                     / (1.0 + k * negative_weight))

        wd = opt.weight_decay
        dv = (gpos[..., None] * c + torch.bmm(gneg, P)
              + wd * (1.0 + M * neg_w) * v)
        dc = gpos[..., None] * v + wd * c
        dP = torch.bmm(gneg.transpose(1, 2), v) + wd * (neg_w * bg) * P
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

        v_counts = v_sqs = c_counts = c_sqs = None
        if opt.num_moment > 0:
            # emulated K-draw touch counts (v: K+1, tail: 1, pool row:
            # Bg*K/M expected draws); squares rescale by M/K
            sq_scale = M / max(k, 1)
            v_counts = torch.full((b,), k + 1.0, device=vertex.device)
            p_counts = torch.full((G, M), bg * k / M, device=vertex.device)
            tail_cnt = torch.ones((b,), device=vertex.device)
            if mask is not None:
                v_counts = v_counts * mask
                p_counts = (m2.sum(dim=1)[:, None] * (k / M)).expand(G, M)
                tail_cnt = mask.float()
            v_sqs = ((gpos[..., None] * c) ** 2
                     + sq_scale * torch.bmm(gneg ** 2, P ** 2)).reshape(b, -1)
            c_counts = torch.cat([tail_cnt, p_counts.reshape(-1)])
            p_sqs = sq_scale * torch.bmm((gneg ** 2).transpose(1, 2), v ** 2)
            c_sqs = torch.cat([(dc ** 2).reshape(b, -1),
                               p_sqs.reshape(G * M, -1)])

        dv = dv.reshape(b, -1)
        if sweep_vertex:
            new_vertex, new_v_moms = scatter_update_sorted_(
                vertex, v_moms, heads, dv, opt, lr, entry_counts=v_counts,
                entry_sqs=v_sqs)
        else:
            new_vertex, new_v_moms = apply_row_updates(
                vertex, v_moms, _mask_ids(heads, mask, vertex.shape[0]), dv,
                opt, lr, entry_counts=v_counts, entry_sqs=v_sqs, trust=trust)
        if sweep_context and mask is not None:
            # sweep ids stay in range: masked tails park at row V-1
            # (zeroed rows, zero counts) instead of the drop sentinel
            tails = tails.masked_fill(mask <= 0, context.shape[0] - 1)
        elif not sweep_context:
            tails = _mask_ids(tails, mask, context.shape[0])
        ctx_ids = torch.cat([tails, pool_ids.reshape(-1).to(tails.dtype)])
        ctx_grads = torch.cat([dc.reshape(b, -1), dP.reshape(G * M, -1)])
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


def walk_shift_fwd(x, kk):
    """result[:, i] = x[:, i + kk] along the walk axis (dim 1), zero-padded."""
    if kk == 0:
        return x
    out = torch.zeros_like(x)
    if kk > 0:
        out[:, :-kk] = x[:, kk:]
    else:
        out[:, -kk:] = x[:, :kk]
    return out


def _pool_ids(neg_state, G, M, device, generator, draws):
    """[G, M] negative-pool ids from the alias tensors `neg_state`."""
    if draws is None:
        draws = (torch.rand((G, M), generator=generator, device=device),
                 torch.rand((G, M), generator=generator, device=device))
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

    Returns (core, (k, M, G, T, neg_w)); core(v, c, P, mask, lr) returns a
    dict: dv [B,L1,D], dc [B,L1,D], dP [G,M,D] (trust-clipped), cnt/cntc
    [B,L1] head/context touch counts, loss_sum, n_active, and (moment rules
    only) v_counts/v_sqs, c_counts_main/c_sqs_main, p_counts/p_sqs."""
    k = num_negative
    M = int(pool_size)
    G = int(pool_groups)
    offs = walk_offsets(int(aug), bool(bidir))
    T = len(offs)
    neg_w = float(negative_weight) * k / M

    def core(v, c, P, mask, lr):
        B, L1 = v.shape[0], v.shape[1]
        if B % G:
            raise ValueError("walk batch %d must divide into %d pool groups"
                             % (B, G))
        bg = B // G
        npos = B * L1
        D = v.shape[-1]

        # positive band: per offset, shifted elementwise product
        gpos_list, csh_list = [], []
        pos_loss = 0.0
        for t_i, kk in enumerate(offs):
            csh = walk_shift_fwd(c, kk)
            logit = (v * csh).sum(dim=-1)
            m = mask[..., t_i]
            gpos_list.append((torch.sigmoid(logit) - 1.0) * m)
            csh_list.append(csh)
            pos_loss = pos_loss + (m * F.softplus(-logit)).sum()
        cnt = mask.sum(dim=-1)                               # [B, L1]

        v4 = v.reshape(G, bg * L1, D)
        neg_logits = torch.bmm(v4, P.transpose(1, 2))        # [G, Pg, M]
        gneg_u = torch.sigmoid(neg_logits) * neg_w
        cnt_g = cnt.reshape(G, bg * L1)
        gneg = gneg_u * cnt_g[..., None]
        n_active = mask.sum()
        sp = F.softplus(neg_logits)
        neg_loss = (cnt_g * (neg_w * sp.sum(dim=-1))).sum()

        wd = opt.weight_decay
        dv = sum(g[..., None] * csh for g, csh in zip(gpos_list, csh_list))
        dv = (dv + torch.bmm(gneg, P).reshape(B, L1, D)
              + (wd * (1.0 + M * neg_w)) * cnt[..., None] * v)
        # context side: head i's positive gradient g*v lands at tail i+kk
        gv_list = [g[..., None] * v for g in gpos_list]
        dc_main = sum(walk_shift_fwd(gv, -kk)
                      for gv, kk in zip(gv_list, offs))
        cntc = sum(walk_shift_fwd(mask[..., t_i], -kk)
                   for t_i, kk in enumerate(offs))           # [B, L1]
        dc = dc_main + wd * cntc[..., None] * c
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
            outs["p_counts"] = (cnt_g.sum(dim=1)[:, None]
                                * (k / M)).expand(G, M)
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

        o = core(v, c, P, mask, lr)
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

    step(state, chain [B, L1], _ (chain again, ignored), lr, *neg_state,
         mask [B, L1, T]) -> (state, loss); B % pool_groups == 0."""
    core, (k, M, G, T, _) = make_graph_banded_core(
        opt, num_negative, negative_weight, aug, bidir, pool_size,
        pool_groups, trust)

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

        o = core(v, c, P, mask, lr)
        D = v.shape[-1]

        v_counts = v_sqs = c_counts = c_sqs = None
        if opt.num_moment > 0:
            v_counts = o["v_counts"]
            v_sqs = o["v_sqs"]
            c_counts = torch.cat([o["c_counts_main"],
                                  o["p_counts"].reshape(-1)])
            c_sqs = torch.cat([o["c_sqs_main"], o["p_sqs"].reshape(G * M, D)])

        flat_ids = chain.reshape(npos)
        head_mask = (o["cnt"] > 0).reshape(npos).float()
        new_vertex, new_v_moms = apply_row_updates(
            vertex, v_moms, _mask_ids(flat_ids, head_mask, vertex.shape[0]),
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

    return step


def make_micro_step(step_fn, num_micro: int):
    """Split each batch into `num_micro` sequential micro-steps: chunk i's
    row updates are applied before chunk i+1 is scored (bounds the touches
    per row per application; the batch size stays the configured one for
    the LR schedule and accounting)."""
    R = int(num_micro)
    if R <= 1:
        return step_fn

    def step(state, heads, tails, lr, *neg_state, mask=None,
             generator=None):
        bm = heads.shape[0] // R
        losses = []
        for r in range(R):
            sl = slice(r * bm, (r + 1) * bm)
            state, loss = step_fn(state, heads[sl], tails[sl], lr,
                                  *neg_state,
                                  mask=None if mask is None else mask[sl],
                                  generator=generator)
            losses.append(loss)
        return state, torch.stack(losses).mean()

    return step


def make_fused_runner(step_fn, sample_fn, opt: Optimizer, ep_groups: int,
                      positive_reuse: int = 1, state_pack=None,
                      state_unpack=None):
    """Episode runner: trains `ep_groups * positive_reuse` batches per call,
    generating each group's walks on the device with `sample_fn` and
    reusing them `positive_reuse` times with fresh negatives.

    run(state, batch_id0, num_batch_total, generator, sampler_arrays,
    neg_state) -> (state, losses [ep_groups * positive_reuse]). Losses stay
    on the device: nothing in the loop waits for the card."""
    R = max(int(positive_reuse), 1)

    def run(state, batch_id0, num_batch_total, generator, sampler_arrays,
            neg_state):
        with torch.no_grad():
            if state_pack is not None:
                state = state_pack(state)
            losses = []
            for g in range(ep_groups):
                heads, tails, mask = sample_fn(*sampler_arrays,
                                               generator=generator)
                for r in range(R):
                    lr = opt.schedule_lr(batch_id0 + g * R + r,
                                         num_batch_total)
                    state, loss = step_fn(state, heads, tails, lr,
                                          *neg_state, mask=mask,
                                          generator=generator)
                    losses.append(loss)
            if state_unpack is not None:
                state = state_unpack(state)
            return state, torch.stack(losses)

    return run
