"""Smoke run of graphvite_tpu_torch on one NVIDIA GPU (an H100 is the target).

    python3 chip_smoke.py [--seed N] [--main-batches N] [--edge-batches N]

Phases, in order (any failure exits non-zero and prints no result line):

1. device   require CUDA; print the card's name and power limit; TF32 off.
2. build    compile the hand-written CUDA kernels (csrc/*.cu: scatter_add,
            gather_sorted, scatter_update) with nvcc, one process each, all
            started together, from the checkout's sources.
3. main     DeepWalk through GraphSolver.build/train at the
            config/graph/deepwalk_youtube.yaml hyperparameters (dim 128,
            SGD lr 0.025 wd 5e-3, K 1, negative_weight 5, aug 5, walk 40,
            batch 100000) on a Youtube-sized synthetic power-law graph
            (1,138,499 vertices, ~4.9M undirected edges) made from --seed:
            float32 (the kernels' launch counts are set to 0 just before
            and read just after), a torch.profiler trace of 10 more
            batches, a shorter bfloat16 run, and one batch at batch 250000.
            Checks the fused arena path, one scatter-add launch per batch,
            finite and falling losses, finite tables; prints pair-slot and
            valid-pair rates. From each run one batch is captured (the
            solver's own walk sampler, pool shape and negative sampler) and
            replayed: the fused step on the card against the same step on
            the CPU, over the whole 1,138,499 x 256 arena.
4. edge     LINE through GraphSolver.build/train at the
            config/graph/line_flickr.yaml hyperparameters (dim 128, SGD lr
            0.025 wd 5e-3, K 1, negative_weight 5, aug 1, batch 100000,
            episode 1000) on a Flickr-sized synthetic power-law graph
            (1,715,256 vertices, ~22.6M undirected edges) made from --seed:
            the sorted edge stream and the sweep routes. float32 SGD (rate,
            ms/batch, a torch.profiler trace of 10 batches, a falling
            loss; per batch one gather_sorted launch and one launch of each
            scatter-add entry), a shorter bfloat16 SGD run, and a float32
            Adam run (per batch one launch of each scatter_update entry;
            the moments move). From each run one batch is captured and
            replayed through the pool step on the card and on the CPU from
            the same tables and moments; its heads must ascend and, in
            float32, every head's vertex row must move.
5. kernel   each kernel against its plain torch version on the card, on the
            ids the main paths drew: scatter_add on the DeepWalk update ids
            (batch 100000 and 250000, with dropped ids added, float32 and
            bfloat16 tables) and on the edge route's sorted heads;
            gather_sorted on the edge route's 99,328 sorted heads (float32
            and bfloat16 tables, float32 out); scatter_update (Adam) on its
            vertex side (sorted heads) and context side (107,520 unsorted
            tail and pool ids); both sorted entries again on 99,328 equal
            ids (one run over every tile of the segmented reduction).
            Times each wrapper, each kernel alone (both of its passes,
            without the sort), the plain version and, where one PyTorch
            call computes the same function, that call (the yardstick,
            never called by the port), beside the bytes bound. Then the
            entries' breakdown: CUDA launches per wrapper call, device
            time of the sort and of the kernel (torch.profiler) and host
            time per call, for scatter_add_ at 11,968 x 256, both sorted
            entries at 99,328 x 128 and scatter_update_ at 107,520 x 128.
6. quality  GraphApplication on a small two-block graph on the card:
            DeepWalk (the unfused trust-clip route) and LINE on the edge
            route (the small-table route, the trust clip on the
            scatter-add): link-prediction AUC > 0.9.
7. summary  the card line, the kernels line, and the result line.

Imports nothing of JAX or of the JAX package.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

# the H100's published peaks (NVIDIA data sheet, SXM, 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
YOUTUBE_V = 1_138_499
YOUTUBE_E = 4_945_382
FLICKR_V = 1_715_256
FLICKR_E = 22_613_981
WIDTH = 256          # the fused (vertex|context) arena row: 2 x dim 128
DIM = 128


def log(*args):
    print(*args, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=20, warmup=3):
    """Median time of fn() on the current stream, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bf16_ulp(x):
    import torch

    e = torch.floor(torch.log2(torch.clamp(x.abs(), min=2.0 ** -126)))
    return torch.pow(2.0, e - 7)


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def power_law_graph(num_vertex, num_edge, seed):
    """Power-law random graph: `num_edge` undirected input edges (self
    loops dropped) over `num_vertex` vertices, symmetrized, unweighted."""
    from graphvite_tpu_torch.graph import Graph

    rng = np.random.default_rng(seed)
    u = (rng.random(num_edge) ** 2.5 * num_vertex).astype(np.int64)
    v = (rng.random(num_edge) ** 2.5 * num_vertex).astype(np.int64)
    keep = u != v
    u, v = u[keep], v[keep]
    g = Graph()
    g.num_vertex = num_vertex
    g.num_edge = int(u.size)
    g.id2name = g.name2id = None   # anonymous: the samplers use the arrays
    g.as_undirected = True
    g.edge_heads = np.concatenate([u, v])
    g.edge_tails = np.concatenate([v, u])
    g.edge_weights = np.ones(g.edge_heads.size, dtype=np.float32)
    g._finalize(normalization=False)
    return g


DEEPWALK_YOUTUBE = dict(model="DeepWalk", augmentation_step=5,
                        random_walk_length=40, negative_weight=5.0,
                        log_frequency=10**9)
SGD_YOUTUBE = {"type": "SGD", "lr": 0.025, "weight_decay": 5e-3}


def wrappers():
    """Every kernel wrapper of the port, by name: each counts its own
    kernel launches (scatter_add_ and scatter_add_sorted_ launch kernel 1,
    scatter_update_ and scatter_update_sorted_ kernel 2, gather_sorted
    kernel 3)."""
    from graphvite_tpu_torch.ops import gather, scatter

    fns = (scatter.scatter_add_, scatter.scatter_add_sorted_,
           scatter.scatter_update_, scatter.scatter_update_sorted_,
           gather.gather_sorted)
    return {fn.__name__: fn for fn in fns}


def reset_launches():
    for fn in wrappers().values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in wrappers().items()}


def valid_fraction(solver, probes=8, seed=123):
    """Mean pair-mask of the sampler the solver trained with: dead-walk
    and boundary slots carry mask 0 and are not pairs."""
    import torch

    gen = torch.Generator(device=solver.device).manual_seed(seed)
    arrays = solver._active_sampler.arrays()
    fr = [solver._active_sample_fn(*arrays, generator=gen)[2].mean()
          for _ in range(probes)]
    return float(torch.stack(fr).mean())


def replay_batch(solver, seed):
    """Capture one batch as the solver's runner makes it (a walk batch from
    its own sampler, pool draws of the shape its step takes, its negative
    sampler) and run it through the solver's fused step on the card and on
    the CPU from the same whole (vertex|context) arena.

    Tolerances: float32 tables rtol 3e-4, atol 3e-6 and loss rtol 2e-5
    (those the CPU tests hold the port's steps to the reference with).
    bfloat16 tables: the same float32 tolerance plus 1 bf16 ulp, since
    each device rounds its own float32 result once, and where a row's
    update nearly cancels its value, the devices' float32 roundings
    (~1e-11 apart) round to bf16 values many ulps apart near zero. Loss
    rtol 2e-5. Returns the record, the batch's update ids and a list of
    problems."""
    import torch
    from graphvite_tpu_torch.ops import steps
    from graphvite_tpu_torch.ops.alias import device_sample

    dev = solver.device
    step, neg = solver._active_step_fn, solver._active_neg_state
    gen = torch.Generator(device=dev).manual_seed(seed)
    chain, tails, mask = solver._active_sample_fn(
        *solver._active_sampler.arrays(), generator=gen)
    G, M = step.pool_shape
    draws = tuple(torch.rand((G, M), generator=gen, device=dev)
                  for _ in range(2))
    lr = solver.optimizer.schedule_lr(0, solver.num_batch)
    arena = steps.banded_fused_pack(solver.state)["tables"][0]
    D = arena.shape[1] // 2
    before = arena.clone()
    cpu_arena = arena.to("cpu", copy=True)
    with torch.no_grad():
        _, loss = step({"tables": (arena,), "moments": ((),)}, chain, tails,
                       lr, *neg, mask=mask, draws=draws)
        _, cpu_loss = step({"tables": (cpu_arena,), "moments": ((),)},
                           chain.cpu(), tails.cpu(), lr,
                           *(t.cpu() for t in neg), mask=mask.cpu(),
                           draws=tuple(d.cpu() for d in draws))
    want = cpu_arena.to(dev).float()
    got = arena.float()
    diff = (got - want).abs()
    tol_f32 = 3e-6 + 3e-4 * want.abs()
    if arena.dtype == torch.float32:
        ok = bool((diff <= tol_f32).all())
        tol = "rtol 3e-4, atol 3e-6"
    else:
        ulp = bf16_ulp(torch.maximum(got.abs(), want.abs()))
        ok = bool((diff <= tol_f32 + ulp).all())
        tol = "rtol 3e-4, atol 3e-6, + 1 bf16 ulp"
    loss, cpu_loss = float(loss), float(cpu_loss)
    # every row with a pair in the batch gets a vertex update (its own
    # band and pool gradient plus weight decay)
    heads = chain.reshape(-1)[mask.sum(dim=-1).reshape(-1) > 0].unique()
    v_moved = int((arena[heads, :D] != before[heads, :D]).any(dim=1).sum())
    pool_ids = device_sample(*neg, *draws)
    ids = torch.cat([chain.reshape(-1), pool_ids.reshape(-1)])
    c_rows = ids.unique()
    c_moved = int((arena[c_rows, D:] != before[c_rows, D:]).any(dim=1).sum())
    rec = {"float_type": str(arena.dtype).replace("torch.", ""),
           "walks": chain.shape[0], "update_rows": int(ids.numel()),
           "loss": loss, "cpu_loss": cpu_loss,
           "max_abs_diff": float(diff.max()), "tolerance": tol,
           "heads": int(heads.numel()), "vertex_rows_moved": v_moved,
           "context_rows": int(c_rows.numel()), "context_rows_moved": c_moved}
    del arena, before, cpu_arena, want, got, diff
    problems = []
    if not ok:
        problems.append("card and CPU disagree on a batch: %r" % rec)
    if abs(loss - cpu_loss) > 2e-5 * abs(cpu_loss):
        problems.append("card loss %r vs CPU loss %r" % (loss, cpu_loss))
    # float32 keeps every head's update; bfloat16 may round small ones away
    if v_moved == 0 or (rec["float_type"] == "float32"
                        and v_moved != rec["heads"]):
        problems.append("vertex rows did not move: %r" % rec)
    return rec, ids, problems


def train_main_path(graph, float_type, batches, batch_size=100000,
                    falling=True):
    """A few warm-up batches (sampler build, first launches), then the
    measured call; returns the solver, the measured call's record and a
    list of problems. `falling` asks for a falling loss (a run of many
    batches)."""
    import torch
    from graphvite_tpu_torch.solver import GraphSolver

    solver = GraphSolver(dim=DIM, float_type=float_type)
    solver.build(graph, optimizer=SGD_YOUTUBE, num_negative=1,
                 batch_size=batch_size, episode_size=25)
    # train() runs int(num_epoch * num_edge // effective_batch) batches
    t0 = time.perf_counter()
    solver.train(num_epoch=5 * batch_size / graph.num_edge,
                 **DEEPWALK_YOUTUBE)
    warm_s = time.perf_counter() - t0
    eff = solver.effective_batch

    reset_launches()
    t0 = time.perf_counter()
    solver.train(num_epoch=batches * eff / graph.num_edge + 1e-9,
                 **DEEPWALK_YOUTUBE)
    elapsed = time.perf_counter() - t0      # train() ends synchronized
    counts = read_launches()
    launches = counts["scatter_add_"]

    run = solver.batch_id
    # at this graph size the loss moves slowly from ln 2 (context rows
    # start at zero): compare the first and last tenth in float64
    losses = solver.batch_losses.double()
    k = max(run // 10, 5)
    tables_finite = all(bool(torch.isfinite(t.float()).all())
                        for t in solver.state["tables"])
    vf = valid_fraction(solver)
    # context rows start at zero: how many the run has updated
    touched = int((solver.state["tables"][1].float().abs().sum(dim=1) > 0)
                  .sum())
    rec = {"float_type": float_type, "batches": run,
           "effective_batch": eff, "warmup_s": warm_s, "elapsed_s": elapsed,
           "ms_per_batch": elapsed / run * 1e3,
           "pair_slots_per_s": run * eff / elapsed,
           "valid_fraction": vf,
           "valid_pairs_per_s": run * eff * vf / elapsed,
           "launches": launches, "fused_arena": solver._banded_fused,
           "context_rows_touched": touched,
           "loss_first": float(losses[:k].mean()),
           "loss_last": float(losses[-k:].mean()),
           "losses_finite": bool(torch.isfinite(losses).all()),
           "tables_finite": tables_finite,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    problems = []
    if not rec["fused_arena"]:
        problems.append("the fused arena was not chosen")
    if launches != run or sum(counts.values()) != launches:
        problems.append("kernel launches %r for %d batches" % (counts, run))
    if not rec["losses_finite"]:
        problems.append("losses not finite")
    if falling and not rec["loss_last"] < rec["loss_first"]:
        problems.append("losses not falling")
    if not tables_finite:
        problems.append("tables not finite")
    return solver, rec, problems


def trace_episode(solver, ms_per_batch, train_kwargs, batches=10):
    """Device kernel time per batch over a short training call
    (torch.profiler), and its share of the unprofiled batch time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        solver.train(num_epoch=batches * solver.effective_batch
                     / solver.graph.num_edge + 1e-9, **train_kwargs)
        torch.cuda.synchronize()
    run = solver.batch_id
    rows = []
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total:
            rows.append((ev.self_device_time_total, ev.count, ev.key))
    if not rows:
        raise AssertionError("the profiler recorded no device time")
    rows.sort(reverse=True)
    launches = sum(r[1] for r in rows) / run
    device_ms = sum(r[0] for r in rows) / 1e3 / run
    return {"batches": run, "device_ms_per_batch": device_ms,
            "kernels_per_batch": launches,
            "busy_share": device_ms / ms_per_batch,
            "top": [{"kernel": name[:70], "ms_per_batch": us / 1e3 / run,
                     "calls_per_batch": c / run}
                    for us, c, name in rows[:15]]}


# ---------------------------------------------------------------------------
# phase 4: the edge route
# ---------------------------------------------------------------------------

LINE_FLICKR = dict(model="LINE", augmentation_step=1, negative_weight=5.0,
                   log_frequency=10**9)
SGD_FLICKR = {"type": "SGD", "lr": 0.025, "weight_decay": 5e-3}
# Adam's closed-form c-touch update (GraphVite's beta1 0.999, beta2
# 0.99999) moves a row by up to ~6 lr c in one batch once c reaches ~2000:
# the sorted stream hands the synthetic graph's hub (vertex 0) whole
# 1024-edge blocks, c = 2048 per block. lr 1e-6 keeps that step ~0.01.
# No weight decay: the squared gradients leave it out (as the reference's
# do), so with zero-initialized context rows it would be divided by
# ~epsilon and run away.
ADAM_FLICKR = {"type": "Adam", "lr": 1e-6, "weight_decay": 0.0}
# launches per batch each edge run must show, by wrapper (others 0)
EDGE_SGD_LAUNCHES = {"gather_sorted": 1, "scatter_add_sorted_": 1,
                     "scatter_add_": 1}
EDGE_ADAM_LAUNCHES = {"gather_sorted": 1, "scatter_update_sorted_": 1,
                      "scatter_update_": 1}


def train_edge_path(graph, float_type, optimizer, batches, per_batch,
                    falling):
    """LINE at the line_flickr.yaml shape: 5 warm-up batches (sampler
    build, first launches), then the measured call with the launch counts
    set to 0 just before it and read just after. Returns the solver, the
    record and a list of problems."""
    import torch
    from graphvite_tpu_torch.solver import GraphSolver

    solver = GraphSolver(dim=DIM, float_type=float_type)
    solver.build(graph, optimizer=optimizer, num_negative=1,
                 batch_size=100000, episode_size=1000)
    t0 = time.perf_counter()
    solver.train(num_epoch=5 * 100000 / graph.num_edge, **LINE_FLICKR)
    warm_s = time.perf_counter() - t0
    eff = solver.effective_batch

    reset_launches()
    t0 = time.perf_counter()
    solver.train(num_epoch=batches * eff / graph.num_edge + 1e-9,
                 **LINE_FLICKR)
    elapsed = time.perf_counter() - t0      # train() ends synchronized
    counts = read_launches()
    run = solver.batch_id
    losses = solver.batch_losses.double()
    k = max(run // 10, 5)
    tables_finite = all(bool(torch.isfinite(t.float()).all())
                        for t in solver.state["tables"])
    moment_rows = [int((m != 0).any(dim=1).sum())
                   for group in solver.state["moments"] for m in group]
    rec = {"float_type": float_type, "optimizer": optimizer["type"],
           "batches": run, "effective_batch": eff, "warmup_s": warm_s,
           "elapsed_s": elapsed, "ms_per_batch": elapsed / run * 1e3,
           "samples_per_s": run * eff / elapsed,
           "pool_shape": list(solver._active_step_fn.pool_shape),
           "sweeps": [solver._sweep_gather, solver._sweep_scatter,
                      solver._sweep_context],
           "launches": counts,
           "loss_first": float(losses[:k].mean()),
           "loss_last": float(losses[-k:].mean()),
           "losses_finite": bool(torch.isfinite(losses).all()),
           "tables_finite": tables_finite,
           "max_abs_table": max(float(t.float().abs().max())
                                for t in solver.state["tables"]),
           "nonzero_moment_rows": moment_rows,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    problems = []
    if rec["sweeps"] != [True, True, True]:
        problems.append("the sweep routes were not chosen: %r"
                        % rec["sweeps"])
    if eff != 99328 or rec["pool_shape"] != [64, 128]:
        problems.append("batch plan %d, pool %r (want 99328, [64, 128])"
                        % (eff, rec["pool_shape"]))
    want = {name: per_batch.get(name, 0) * run for name in counts}
    if counts != want:
        problems.append("kernel launches %r, want %r" % (counts, want))
    if not rec["losses_finite"] or not tables_finite:
        problems.append("losses or tables not finite")
    if falling and not rec["loss_last"] < rec["loss_first"]:
        problems.append("losses not falling")
    if optimizer["type"] == "Adam" and not all(moment_rows):
        problems.append("a moment table did not move: %r" % moment_rows)
    return solver, rec, problems


def replay_edge_batch(solver, seed):
    """Capture one batch as the solver's runner makes it (its sorted edge
    stream, pool draws of the shape its step takes, its negative sampler)
    and run it through the solver's pool step on the card (in place on the
    solver's state, whose run is over) and on the CPU from a copy of the
    same tables and moments.

    Tolerances: those of replay_batch (float32 rtol 3e-4, atol 3e-6, the
    CPU tests' tolerance against the reference; bfloat16 tables that plus
    1 bf16 ulp; loss rtol 2e-5); moments are float32. The captured heads
    must ascend (the sorted entries' contract), and in float32 every
    head's vertex row must move. Returns the record, the batch's ids and a
    list of problems."""
    import torch
    from graphvite_tpu_torch.ops.alias import device_sample

    dev = solver.device
    step, neg = solver._active_step_fn, solver._active_neg_state
    gen = torch.Generator(device=dev).manual_seed(seed)
    heads, tails, mask = solver._active_sample_fn(
        *solver._active_sampler.arrays(), generator=gen)
    G, M = step.pool_shape
    draws = tuple(torch.rand((G, M), generator=gen, device=dev)
                  for _ in range(2))
    lr = solver.optimizer.schedule_lr(0, solver.num_batch)
    ascending = bool((heads[1:] >= heads[:-1]).all())
    state = solver.state
    cpu_state = {"tables": tuple(t.to("cpu", copy=True)
                                 for t in state["tables"]),
                 "moments": tuple(tuple(m.to("cpu", copy=True) for m in g)
                                  for g in state["moments"])}
    uh = heads.unique()
    before = state["tables"][0][uh].clone()
    with torch.no_grad():
        new, loss = step(state, heads, tails, lr, *neg, mask=mask,
                         draws=draws)
        cpu_new, cpu_loss = step(cpu_state, heads.cpu(), tails.cpu(), lr,
                                 *(t.cpu() for t in neg), mask=mask.cpu(),
                                 draws=tuple(d.cpu() for d in draws))
    solver.state = new
    ok, max_diff = True, 0.0
    pairs = list(zip(new["tables"], cpu_new["tables"]))
    pairs += [(a, b) for ga, gb in zip(new["moments"], cpu_new["moments"])
              for a, b in zip(ga, gb)]
    for got, want in pairs:
        bf16 = got.dtype == torch.bfloat16
        got, want = got.cpu().float(), want.float()
        diff = (got - want).abs()
        tol = 3e-6 + 3e-4 * want.abs()
        if bf16:
            tol = tol + bf16_ulp(torch.maximum(got.abs(), want.abs()))
        ok = ok and bool((diff <= tol).all())
        max_diff = max(max_diff, float(diff.max()))
        del got, want, diff, tol
    v_moved = int((new["tables"][0][uh] != before).any(dim=1).sum())
    pool_ids = device_sample(*neg, *draws)
    ctx_ids = torch.cat([tails, pool_ids.reshape(-1).to(tails.dtype)])
    loss, cpu_loss = float(loss), float(cpu_loss)
    rec = {"float_type": str(state["tables"][0].dtype).replace("torch.", ""),
           "optimizer": solver.optimizer.type, "heads_ascending": ascending,
           "batch": int(heads.numel()), "context_rows": int(ctx_ids.numel()),
           "loss": loss, "cpu_loss": cpu_loss, "max_abs_diff": max_diff,
           "tolerance": "rtol 3e-4, atol 3e-6 (+ 1 bf16 ulp on bf16 tables)",
           "heads": int(uh.numel()), "vertex_rows_moved": v_moved}
    del cpu_state, cpu_new, before
    problems = []
    if not ascending:
        problems.append("the captured heads are not ascending")
    if not ok:
        problems.append("card and CPU disagree on a batch: %r" % rec)
    if abs(loss - cpu_loss) > 2e-5 * abs(cpu_loss):
        problems.append("card loss %r vs CPU loss %r" % (loss, cpu_loss))
    if v_moved == 0 or (rec["float_type"] == "float32"
                        and v_moved != rec["heads"]):
        problems.append("vertex rows did not move: %r" % rec)
    ids = {"heads": heads, "ctx": ctx_ids, "G": G, "M": M}
    return rec, ids, problems


# ---------------------------------------------------------------------------
# phase 5: each kernel against its plain version
# ---------------------------------------------------------------------------

def check_kernel(ids, dtype, gen):
    """Kernel vs plain version on one batch's update ids: returns the case
    record."""
    import torch
    from graphvite_tpu_torch.ops import scatter

    dev = torch.device("cuda")
    v, w, n = YOUTUBE_V, WIDTH, ids.numel()
    upd = torch.randn((n, w), generator=gen, device=dev) * 1e-2
    table = (torch.randn((v, w), generator=gen, device=dev) * 0.1).to(dtype)

    # correctness, with dropped ids: 1% sentinels == V and a few negatives
    bad = ids.clone()
    bad[torch.randperm(n, generator=gen, device=dev)[: n // 100]] = v
    bad[:3] = -1
    plain = scatter.scatter_add_plain(table.clone(), bad, upd)
    got = scatter.scatter_add_(table.clone(), bad, upd)
    torch.cuda.synchronize()
    diff = (got.float() - plain.float()).abs()
    # summation orders differ (the plain version's index_add_ uses
    # atomics): rtol 1e-6 of the magnitude of the summed terms
    mag = scatter.scatter_add_plain(table.float().abs(), bad, upd.abs())
    if dtype == torch.float32:
        ok = bool((diff <= 1e-6 * mag).all())
        tol = "|err| <= 1e-6 * (|table| + sum|upd|)"
    else:
        # both round one float32 sum once: 1 bf16 ulp more (where a row's
        # terms nearly cancel, the float32 sums themselves lie many bf16
        # ulps of the small result apart)
        ok = bool((diff <= bf16_ulp(plain.float()) + 1e-6 * mag).all())
        tol = "|err| <= 1 bf16 ulp + 1e-6 * (|table| + sum|upd|)"
    max_err = float(diff.max())
    del plain, got, bad
    if not ok:
        raise AssertionError("kernel disagrees with its plain version at "
                             "n=%d %s: max |err| %g" % (n, dtype, max_err))

    # timing on the batch's own ids (all in range, as the step passes them)
    t_kernel = table.clone()
    ms = cuda_ms(lambda: scatter.scatter_add_(t_kernel, ids, upd))
    # the kernel's two passes alone: ids sorted beforehand, rows read
    # through the sort's permutation
    sid, order = torch.sort(ids.to(torch.int32), stable=True)
    order = order.to(torch.int32)
    kernel_only_ms = cuda_ms(lambda: scatter._launch_add(
        t_kernel, sid, upd, sort=False, order=order))
    plain_ms = cuda_ms(lambda: scatter.scatter_add_plain(t_kernel, ids, upd))
    upd_t = upd.to(dtype)
    library_ms = cuda_ms(lambda: t_kernel.index_add_(0, ids, upd_t))
    del t_kernel, table

    uniq = int(torch.unique(ids).numel())
    s = 4 if dtype == torch.float32 else 2
    nbytes = n * w * 4 + 2 * uniq * w * s + 4 * n
    bound_ms = max(nbytes / HBM_BYTES_PER_S, n * w / FP32_OPS_PER_S) * 1e3
    return {"entry": "scatter_add_", "n": n,
            "dtype": str(dtype).replace("torch.", ""),
            "tile_rows": scatter.tile_rows(n, w),
            "unique_rows": uniq, "max_abs_err": max_err, "tolerance": tol,
            "ms": ms, "kernel_only_ms": kernel_only_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
            >= n * w / FP32_OPS_PER_S else "operations"}


def bytes_bound(nbytes, ops=0):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the float32 operations over the card's float32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_sorted_add(heads, gen):
    """Kernel 1's sorted entry on sorted ids at the edge route's shape (the
    batch's own heads, or one id repeated): a float32 [1,715,256, 128]
    table, the vertex update's shape. Two launches on the same inputs must
    give the same bits."""
    import torch
    from graphvite_tpu_torch.ops import scatter

    dev = torch.device("cuda")
    v, w, n = FLICKR_V, DIM, heads.numel()
    upd = torch.randn((n, w), generator=gen, device=dev) * 1e-2
    table = torch.randn((v, w), generator=gen, device=dev) * 0.1
    plain = scatter.scatter_add_plain(table.clone(), heads, upd)
    got = scatter.scatter_add_sorted_(table.clone(), heads, upd)
    again = scatter.scatter_add_sorted_(table.clone(), heads, upd)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError("two launches of scatter_add_sorted_ on the "
                             "same inputs differ")
    del again
    mag = scatter.scatter_add_plain(table.abs(), heads, upd.abs())
    diff = (got - plain).abs()
    max_err = float(diff.max())
    if not bool((diff <= 1e-6 * mag).all()):
        raise AssertionError("sorted scatter_add disagrees with its plain "
                             "version: max |err| %g" % max_err)
    del plain, got, mag, diff
    t = table.clone()
    ids32 = heads.to(torch.int32).contiguous()
    ms = cuda_ms(lambda: scatter.scatter_add_sorted_(t, ids32, upd))
    plain_ms = cuda_ms(lambda: scatter.scatter_add_plain(t, heads, upd))
    ids64 = heads.long()
    library_ms = cuda_ms(lambda: t.index_add_(0, ids64, upd))
    uniq = int(torch.unique(heads).numel())
    bound_ms, bound_by = bytes_bound(n * w * 4 + 2 * uniq * w * 4 + 4 * n,
                                     n * w)
    del t, table
    return {"entry": "scatter_add_sorted_", "n": n, "dtype": "float32",
            "tile_rows": scatter.tile_rows(n, w), "unique_rows": uniq,
            "max_abs_err": max_err, "tolerance": "|err| <= 1e-6 * (|table| "
            "+ sum|upd|)", "ms": ms, "kernel_only_ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def check_gather(heads, dtype, gen):
    """Kernel 3 on the edge route's sorted heads, float32 out (what the
    step asks for), from a [1,715,256, 128] table of `dtype`."""
    import torch
    from graphvite_tpu_torch.ops import gather

    dev = torch.device("cuda")
    v, d, n = FLICKR_V, DIM, heads.numel()
    table = torch.randn((v, d), generator=gen, device=dev).to(dtype)
    want = gather.gather_sorted_plain(table, heads, torch.float32)
    got = gather.gather_sorted(table, heads, out_dtype=torch.float32)
    torch.cuda.synchronize()
    max_err = float((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError("gather_sorted disagrees with its plain "
                             "version at %s: max |err| %g" % (dtype, max_err))
    ms = cuda_ms(lambda: gather.gather_sorted(table, heads,
                                              out_dtype=torch.float32))
    ids32 = heads.to(torch.int32).contiguous()
    out = torch.empty((n, d), device=dev)
    lib = gather._library()
    code = 0 if dtype == torch.float32 else 1
    stream = torch.cuda.current_stream().cuda_stream
    kernel_only_ms = cuda_ms(lambda: lib.gv_gather_sorted(
        table.data_ptr(), code, ids32.data_ptr(), out.data_ptr(), 0, n, v, d,
        1, stream))
    plain_ms = cuda_ms(lambda: gather.gather_sorted_plain(table, heads,
                                                          torch.float32))
    ids64 = heads.long()
    # one PyTorch call computes the same function only for float32 rows
    library_ms = (cuda_ms(lambda: torch.index_select(table, 0, ids64))
                  if dtype == torch.float32 else None)
    uniq = int(torch.unique(heads).numel())
    s = table.element_size()
    bound_ms, bound_by = bytes_bound(uniq * d * s + n * d * 4 + 4 * n)
    del table, want, got, out
    return {"n": n, "dtype": str(dtype).replace("torch.", ""),
            "out_dtype": "float32", "unique_rows": uniq,
            "max_abs_err": max_err, "tolerance": "exact", "ms": ms,
            "kernel_only_ms": kernel_only_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def check_update(ids, counts, sorted_entry, gen):
    """Kernel 2 (Adam, float32 table and moments of [1,715,256, 128]) on
    one side of an edge batch: the sorted heads with their K+1 touch
    counts, or the unsorted tail and pool ids with theirs. Gradients and
    squares are random; the ids and counts are the batch's."""
    import torch
    from graphvite_tpu_torch.ops import scatter
    from graphvite_tpu_torch.optim import Optimizer

    dev = torch.device("cuda")
    v, d, n = FLICKR_V, DIM, ids.numel()
    opt = Optimizer(type="Adam", lr=1e-3, weight_decay=5e-3)
    grads = torch.randn((n, d), generator=gen, device=dev) * 1e-2
    sqs = grads * grads * (1.0 + torch.rand((n, d), generator=gen,
                                            device=dev))
    table = torch.randn((v, d), generator=gen, device=dev) * 0.1
    moms = tuple(torch.rand((v, d), generator=gen, device=dev) * 1e-4
                 for _ in range(2))
    fn = (scatter.scatter_update_sorted_ if sorted_entry
          else scatter.scatter_update_)
    kw = dict(entry_counts=counts, entry_sqs=sqs)
    want_t, want_m = scatter.scatter_update_plain(
        table.clone(), tuple(m.clone() for m in moms), ids, grads, opt, 1e-3,
        counts, sqs)
    got_t, got_m = fn(table.clone(), tuple(m.clone() for m in moms), ids,
                      grads, opt, 1e-3, **kw)
    again_t, again_m = fn(table.clone(), tuple(m.clone() for m in moms), ids,
                          grads, opt, 1e-3, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip((got_t,) + got_m,
                                                 (again_t,) + again_m)):
        raise AssertionError("two launches of %s on the same inputs differ"
                             % fn.__name__)
    del again_t, again_m
    max_err = 0.0
    for a, b in zip((got_t,) + got_m, (want_t,) + want_m):
        diff = (a - b).abs()
        max_err = max(max_err, float(diff.max()))
        if not bool((diff <= 2e-5 + 2e-5 * b.abs()).all()):
            raise AssertionError("scatter_update disagrees with its plain "
                                 "version: max |err| %g" % float(diff.max()))
        del diff
    del want_t, want_m, got_t, got_m
    t, m = table.clone(), tuple(x.clone() for x in moms)
    ms = cuda_ms(lambda: fn(t, m, ids, grads, opt, 1e-3, **kw))
    # the kernel's two passes alone: ids sorted beforehand, entries read
    # through the sort's permutation
    sid, order = torch.sort(ids.to(torch.int32), stable=True)
    order = order.to(torch.int32)
    kernel_only_ms = cuda_ms(lambda: scatter._launch_update(
        t, m, sid, grads, opt, 1e-3, counts, sqs, 1.0, sort=False,
        order=order))
    plain_ms = cuda_ms(lambda: scatter.scatter_update_plain(
        t, m, ids, grads, opt, 1e-3, counts, sqs), reps=5, warmup=1)
    uniq = int(torch.unique(ids).numel())
    # entries: grads, squares, counts, ids; rows: table + 2 moments, read
    # and written once each
    bound_ms, bound_by = bytes_bound(n * d * 8 + 8 * n + 2 * uniq * d * 12,
                                     n * d * 3 + uniq * d * 20)
    del t, m, table, moms
    return {"entry": fn.__name__, "n": n, "sorted": sorted_entry,
            "tile_rows": scatter.tile_rows(n, d), "optimizer": "Adam",
            "dtype": "float32", "unique_rows": uniq, "max_abs_err": max_err,
            "tolerance": "|err| <= 2e-5 + 2e-5 |want|", "ms": ms,
            "kernel_only_ms": kernel_only_ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}


def front_end_breakdown(name, call, calls=20):
    """What one call of an entry costs: CUDA launches per call and device
    time of the sort (the key kernel and the radix sort's; none in a sorted
    entry) and of the hand-written kernel's two passes, from torch.profiler
    over `calls` calls; host time per call from the host clock over as many
    calls enqueued without a wait (unprofiled)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        call()
    host_ms = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    launches, seen, sort_us, kernel_us, other = 0, 0, 0.0, 0.0, []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or not ev.self_device_time_total:
            continue
        launches += ev.count
        if "scatter_add_" in ev.key or "scatter_update_" in ev.key:
            kernel_us += ev.self_device_time_total
            if "_tiles" in ev.key:
                seen += ev.count     # one first-pass launch per call
        elif "sort" in ev.key.lower() or "Memset" in ev.key:
            # the key kernel, the radix sort's passes and its counters' fill
            sort_us += ev.self_device_time_total
        else:
            other.append(ev.key[:60])
    if not seen:
        raise AssertionError("the profiler recorded no device time")
    if other:
        raise AssertionError("%s launched kernels that are neither the sort "
                             "nor the kernel: %r" % (name, other))
    # the trace may miss some of the calls: divide by those it holds
    return {"entry": name, "calls_traced": seen,
            "launches_per_call": launches / seen,
            "sort_device_ms": sort_us / 1e3 / seen,
            "kernel_device_ms": kernel_us / 1e3 / seen,
            "host_ms_per_call": host_ms}


# ---------------------------------------------------------------------------
# phase 6: quality
# ---------------------------------------------------------------------------

def two_blocks(n=60, seed=0):
    """Two dense communities, sparse cross links (tests/test_solver.py)."""
    rng = np.random.default_rng(seed)
    edges = []
    half = n // 2
    for _ in range(n * 6):
        c = rng.integers(2)
        u = rng.integers(half) + c * half
        v = rng.integers(half) + c * half
        if u != v:
            edges.append((str(u), str(v)))
    for _ in range(n // 10):
        edges.append((str(rng.integers(half)), str(rng.integers(half) + half)))
    return edges


def quality(model="DeepWalk", device=None):
    """Two-block link prediction and node classification through
    GraphApplication: DeepWalk (augmentation 2, the unfused trust-clip
    walk route) or LINE (augmentation 1, the edge route on a table below
    the dense-update size: the trust clip on the scatter-add), with the
    protocols of tests/test_solver.py."""
    from graphvite_tpu_torch import GraphApplication

    edges = two_blocks()
    app = GraphApplication(dim=16, device=device)
    app.load(edge_list=edges)
    if model == "DeepWalk":
        app.build(optimizer={"type": "SGD", "lr": 0.1, "weight_decay": 5e-3},
                  num_negative=1, batch_size=2048, episode_size=8)
        kw = dict(num_epoch=2000, augmentation_step=2, random_walk_length=8)
    else:
        app.build(num_negative=2, batch_size=512, episode_size=8)
        kw = dict(num_epoch=1000, augmentation_step=1)
    reset_launches()
    app.train(model=model, negative_weight=1.0, log_frequency=10**9, **kw)
    launches = read_launches()
    g = app.graph
    rng = np.random.default_rng(1)
    half = g.num_vertex // 2
    k = 300
    sel = rng.choice(g.num_directed_edge, size=k, replace=False)
    H = [g.id2name[i] for i in g.edge_heads[sel]]
    T = [g.id2name[i] for i in g.edge_tails[sel]]
    H += [str(x) for x in rng.integers(half, size=k)]
    T += [str(x) for x in rng.integers(half, size=k) + half]
    Y = [1] * k + [0] * k
    auc = app.evaluate("link prediction", H=H, T=T, Y=Y)["AUC"]
    labels = [str(i) for i in range(g.num_vertex)]
    classes = ["a" if int(x) < half else "b" for x in labels]
    nc = app.evaluate("node classification", X=labels, Y=classes,
                      portions=(0.5,), patience=20)
    s = app.solver
    return {"model": model, "auc": auc, "micro_f1": nc["micro-F1@50%"],
            "fused_arena": s._banded_fused,
            "sweeps": [s._sweep_gather, s._sweep_scatter, s._sweep_context],
            "batches": s.batch_id, "launches": launches}


# ---------------------------------------------------------------------------

def front_ends(walk_ids, heads, v_counts, ctx, c_counts, gen):
    """The four entries' breakdown at the main paths' shapes: scatter_add_
    on the DeepWalk batch's 11,968 x 256 update; on the edge batch,
    scatter_add_sorted_ and scatter_update_sorted_ (Adam) on the 99,328
    sorted heads and scatter_update_ on the 107,520 x 128 context side."""
    import torch
    from graphvite_tpu_torch.ops import scatter
    from graphvite_tpu_torch.optim import Optimizer

    dev = torch.device("cuda")
    out = []
    n = walk_ids.numel()
    table = torch.randn((YOUTUBE_V, WIDTH), generator=gen, device=dev) * 0.1
    upd = torch.randn((n, WIDTH), generator=gen, device=dev) * 1e-2
    out.append(front_end_breakdown(
        "scatter_add_ %d x %d" % (n, WIDTH),
        lambda: scatter.scatter_add_(table, walk_ids, upd)))
    del table, upd
    opt = Optimizer(type="Adam", lr=1e-3, weight_decay=5e-3)
    table = torch.randn((FLICKR_V, DIM), generator=gen, device=dev) * 0.1
    moms = tuple(torch.rand((FLICKR_V, DIM), generator=gen, device=dev) * 1e-4
                 for _ in range(2))
    grads = torch.randn((ctx.numel(), DIM), generator=gen, device=dev) * 1e-2
    sqs = grads * grads
    n = heads.numel()
    out.append(front_end_breakdown(
        "scatter_add_sorted_ %d x %d" % (n, DIM),
        lambda: scatter.scatter_add_sorted_(table, heads, grads[:n])))
    out.append(front_end_breakdown(
        "scatter_update_sorted_ %d x %d" % (n, DIM),
        lambda: scatter.scatter_update_sorted_(
            table, moms, heads, grads[:n], opt, 1e-3, entry_counts=v_counts,
            entry_sqs=sqs[:n])))
    out.append(front_end_breakdown(
        "scatter_update_ %d x %d" % (ctx.numel(), DIM),
        lambda: scatter.scatter_update_(table, moms, ctx, grads, opt, 1e-3,
                                        entry_counts=c_counts,
                                        entry_sqs=sqs)))
    return out


def kernel_row(name, source, replaces, launches, by_path, cases, case):
    """One kernel's entry of the kernels line: `case` gives the top-level
    times, `cases` every case's by entry."""
    per_case = [{"entry": c.get("entry", name), "n": c["n"],
                 "dtype": c["dtype"], "unique_rows": c["unique_rows"],
                 "ms": c["ms"], "kernel_ms": c["kernel_only_ms"],
                 "bound_ms": c["bound_ms"], "plain_ms": c["plain_ms"],
                 "library_ms": c["library_ms"]} for c in cases]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "launches_by_path": by_path,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": case["ms"], "kernel_ms": case["kernel_only_ms"],
            "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"], "library_ms": case["library_ms"],
            "cases": per_case}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--main-batches", type=int, default=1000)
    ap.add_argument("--edge-batches", type=int, default=1000)
    args = ap.parse_args()

    try:
        import torch
    except ImportError:
        sys.stderr.write("chip_smoke: torch is not installed\n")
        return 2
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: CUDA is not available; this script "
                         "runs on a GPU only\n")
        return 2
    try:
        from graphvite_tpu_torch.ops import gather, kernels, scatter
    except ImportError as e:
        sys.stderr.write("chip_smoke: run from the root of a checkout of "
                         "the repository (%s)\n" % e)
        return 2

    failures = []
    results = {}

    def phase(name, fn):
        log("== phase %s" % name)
        t0 = time.perf_counter()
        try:
            results[name] = fn()
            log("   %s done in %.1f s" % (name, time.perf_counter() - t0))
            return True
        except Exception:  # noqa: BLE001 - report every phase, then fail
            traceback.print_exc()
            failures.append(name)
            log("   %s FAILED" % name)
            return False

    # 1. device
    def device():
        line = card_line()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        log("card:", line)
        log("torch %s, CUDA %s, %s; TF32 off for matmul and cuDNN"
            % (torch.__version__, torch.version.cuda,
               torch.cuda.get_device_name(0)))
        return line
    if not phase("device", device):
        return 1

    # 2. build: every kernel, one nvcc each, in parallel
    def build():
        t0 = time.perf_counter()
        paths, reports = kernels.build(verbose=True)
        secs = time.perf_counter() - t0
        for name, path in sorted(paths.items()):
            log("built %s" % path)
            for line in reports[name].splitlines():
                if "registers" in line or "spill" in line:
                    log("   ptxas:", line.strip())
        log("built %d kernels in %.1f s" % (len(paths), secs))
        if sorted(paths) != ["gather_sorted", "scatter_add",
                             "scatter_update"]:
            raise AssertionError("kernels built: %r" % sorted(paths))
        scatter._library("scatter_add")
        scatter._library("scatter_update")
        gather._library()
        return secs
    if not phase("build", build):
        return 1

    # 3. main path (DeepWalk)
    def main_path():
        t0 = time.perf_counter()
        graph = power_law_graph(YOUTUBE_V, YOUTUBE_E, args.seed)
        log("graph: %d vertices, %d input edges, %d directed, built in %.1f s"
            % (graph.num_vertex, graph.num_edge, graph.num_directed_edge,
               time.perf_counter() - t0))
        out = {"batch_ids": []}
        problems = []

        def replay(solver, name):
            rec, ids, bad = replay_batch(solver, args.seed + 1)
            log("   %s batch, card vs CPU:" % name, json.dumps(rec))
            out["replay_" + name] = rec
            problems.extend(name + ": " + p for p in bad)
            return ids

        solver, rec, bad = train_main_path(graph, "float32",
                                           args.main_batches)
        log("   float32:", json.dumps(rec))
        out["float32"] = rec
        problems += ["float32: " + p for p in bad]
        out["trace"] = trace_episode(solver, rec["ms_per_batch"],
                                     DEEPWALK_YOUTUBE)
        log("   trace:", json.dumps(out["trace"]))
        out["batch_ids"].append(replay(solver, "float32"))
        del solver
        torch.cuda.empty_cache()

        solver, rec16, bad = train_main_path(
            graph, "bfloat16", max(args.main_batches // 2, 10))
        log("   bfloat16:", json.dumps(rec16))
        out["bfloat16"] = rec16
        problems += ["bfloat16: " + p for p in bad]
        replay(solver, "bfloat16")
        del solver
        torch.cuda.empty_cache()

        # the config's width at a larger batch: one batch, for its update
        # shape (the kernel phase's second case)
        solver, rec_big, bad = train_main_path(graph, "float32", 1,
                                               batch_size=250000,
                                               falling=False)
        log("   float32, batch 250000:", json.dumps(rec_big))
        problems += ["batch 250000: " + p for p in bad]
        out["batch_ids"].append(replay(solver, "float32_batch250000"))
        del solver
        torch.cuda.empty_cache()
        if problems:
            raise AssertionError("; ".join(problems))
        return out
    phase("main", main_path)

    # 4. the edge route (LINE)
    def edge_path():
        t0 = time.perf_counter()
        graph = power_law_graph(FLICKR_V, FLICKR_E, args.seed)
        log("graph: %d vertices, %d input edges, %d directed, built in %.1f s"
            % (graph.num_vertex, graph.num_edge, graph.num_directed_edge,
               time.perf_counter() - t0))
        torch.cuda.reset_peak_memory_stats()
        out = {}
        problems = []
        n = args.edge_batches
        runs = (("float32", "float32", SGD_FLICKR, n, EDGE_SGD_LAUNCHES),
                ("bfloat16", "bfloat16", SGD_FLICKR, max(n // 2, 10),
                 EDGE_SGD_LAUNCHES),
                ("adam", "float32", ADAM_FLICKR, max(n // 5, 10),
                 EDGE_ADAM_LAUNCHES))
        for name, float_type, opt, batches, per_batch in runs:
            solver, rec, bad = train_edge_path(
                graph, float_type, opt, batches, per_batch,
                falling=(name == "float32"))
            log("   %s:" % name, json.dumps(rec))
            out[name] = rec
            problems += ["%s: %s" % (name, p) for p in bad]
            if name == "float32":
                out["trace"] = trace_episode(solver, rec["ms_per_batch"],
                                             LINE_FLICKR)
                log("   trace:", json.dumps(out["trace"]))
            rep, ids, bad = replay_edge_batch(solver, args.seed + 1)
            log("   %s batch, card vs CPU:" % name, json.dumps(rep))
            out["replay_" + name] = rep
            problems += ["%s replay: %s" % (name, p) for p in bad]
            if name == "float32":
                out["ids"] = ids
            del solver
            torch.cuda.empty_cache()
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        log("   edge phase peak device memory %.2f GB" % out["peak_mem_gb"])
        if problems:
            raise AssertionError("; ".join(problems))
        return out
    phase("edge", edge_path)

    # 5. each kernel against its plain version, on the paths' own ids
    def kernel():
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        cases = {"scatter_add": [], "gather_sorted": [],
                 "scatter_update": []}
        for ids in results["main"]["batch_ids"]:
            for dtype in (torch.float32, torch.bfloat16):
                rec = check_kernel(ids, dtype, gen)
                log("   scatter_add", json.dumps(rec))
                cases["scatter_add"].append(rec)
        e = results["edge"]["ids"]
        heads, ctx = e["heads"], e["ctx"]
        rec = check_sorted_add(heads, gen)
        log("   scatter_add_sorted_ (edge heads)", json.dumps(rec))
        cases["scatter_add"].append(rec)
        for dtype in (torch.float32, torch.bfloat16):
            rec = check_gather(heads, dtype, gen)
            log("   gather_sorted", json.dumps(rec))
            cases["gather_sorted"].append(rec)
        G, M = e["G"], e["M"]
        b = heads.numel()
        v_counts = torch.full((b,), 2.0, device="cuda")      # K + 1
        c_counts = torch.cat([torch.ones(b, device="cuda"),
                              torch.full((G * M,), b // G / M,
                                         device="cuda")])
        for ids, counts, sorted_entry in ((heads, v_counts, True),
                                          (ctx, c_counts, False)):
            rec = check_update(ids, counts, sorted_entry, gen)
            log("   scatter_update", json.dumps(rec))
            cases["scatter_update"].append(rec)
        # one id repeated over the whole batch: every tile lies inside one
        # run, so the second pass adds one partial per tile
        equal = torch.full_like(heads, 5)
        rec = check_sorted_add(equal, gen)
        log("   scatter_add_sorted_ (99,328 equal ids)", json.dumps(rec))
        cases["scatter_add"].append(rec)
        rec = check_update(equal, v_counts, True, gen)
        log("   scatter_update_sorted_ (99,328 equal ids)", json.dumps(rec))
        cases["scatter_update"].append(rec)
        cases["front_end"] = front_ends(results["main"]["batch_ids"][0],
                                        heads, v_counts, ctx, c_counts, gen)
        return cases
    if "main" in results and "edge" in results:
        phase("kernel", kernel)
    else:
        failures.append("kernel (needs the main paths' ids)")

    # 6. quality
    def quality_phase():
        out = {}
        for model in ("DeepWalk", "LINE"):
            q = quality(model)
            log("   two-block %s on the card:" % model, json.dumps(q))
            if not q["auc"] > 0.9:
                raise AssertionError("%s link-prediction AUC %.4f <= 0.9"
                                     % (model, q["auc"]))
            others = sum(q["launches"].values()) - q["launches"]["scatter_add_"]
            if (q["launches"]["scatter_add_"] != 2 * q["batches"] or others
                    or q["fused_arena"] or any(q["sweeps"])):
                raise AssertionError("the small-table route did not launch "
                                     "the scatter-add twice per batch: %r"
                                     % q)
            out[model] = q
        return out
    phase("quality", quality_phase)

    if failures:
        log("FAILED phases: %s" % ", ".join(failures))
        return 1

    # 7. summary: the card line, the kernels line, the result line
    main_rec = results["main"]["float32"]
    edge = results["edge"]
    cases = results["kernel"]
    k1 = {"deepwalk_float32": main_rec["launches"],
          "edge_float32": (edge["float32"]["launches"]["scatter_add_"]
                           + edge["float32"]["launches"]
                           ["scatter_add_sorted_"])}
    k2 = {"edge_adam": (edge["adam"]["launches"]["scatter_update_"]
                        + edge["adam"]["launches"]["scatter_update_sorted_"])}
    k3 = {"edge_float32": edge["float32"]["launches"]["gather_sorted"]}
    kernels_line = {"kernels": [
        # the DeepWalk batch-100000 update, float32 table
        kernel_row("scatter_add", "graphvite_tpu_torch/csrc/scatter_add.cu",
                   "graphvite_tpu/ops/pallas_scatter.py:146",
                   sum(k1.values()), k1, cases["scatter_add"],
                   cases["scatter_add"][0]),
        # the edge route's sorted heads, float32 table
        kernel_row("gather_sorted",
                   "graphvite_tpu_torch/csrc/gather_sorted.cu",
                   "graphvite_tpu/ops/pallas_scatter.py:342",
                   sum(k3.values()), k3, cases["gather_sorted"],
                   cases["gather_sorted"][0]),
        # Adam on the edge route's sorted heads
        kernel_row("scatter_update",
                   "graphvite_tpu_torch/csrc/scatter_update.cu",
                   "graphvite_tpu/ops/pallas_scatter.py:530",
                   sum(k2.values()), k2, cases["scatter_update"],
                   cases["scatter_update"][0]),
    ]}
    log(json.dumps({"front_end": cases["front_end"]}))
    log(card_line())
    log(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
