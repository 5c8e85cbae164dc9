"""Smoke run of graphvite_tpu_torch on one NVIDIA GPU (an H100 is the target).

    python3 chip_smoke.py [--seed N] [--main-batches N]

Phases, in order (any failure exits non-zero and prints no result line):

1. device   require CUDA; print the card's name and power limit; TF32 off.
2. build    compile the hand-written CUDA kernel (csrc/scatter_add.cu) with
            nvcc, from the checkout's sources.
3. main     DeepWalk through GraphSolver.build/train at the
            config/graph/deepwalk_youtube.yaml hyperparameters (dim 128,
            SGD lr 0.025 wd 5e-3, K 1, negative_weight 5, aug 5, walk 40,
            batch 100000) on a Youtube-sized synthetic power-law graph
            (1,138,499 vertices, ~4.9M undirected edges) made from --seed:
            float32 (the kernel's launch count is set to 0 just before and
            read just after), a torch.profiler trace of 10 more batches,
            a shorter bfloat16 run, and one batch at batch 250000. Checks
            the fused arena path, one kernel launch per batch, finite and
            falling losses, finite tables; prints pair-slot and valid-pair
            rates. From each run one batch is captured (the solver's own
            walk sampler, pool shape and negative sampler) and replayed:
            the fused step on the card against the same step on the CPU,
            over the whole 1,138,499 x 256 arena.
4. kernel   the scatter-add kernel against its plain torch version on the
            card, on the update ids of the captured float32 batches (batch
            100000 and 250000: the ids and their count come from the main
            path), with dropped ids added, float32 and bfloat16 tables;
            times the kernel, the plain version and torch's index_add_
            (the yardstick, never called by the port), beside the bytes
            bound.
5. quality  GraphApplication on a small two-block graph on the card (the
            unfused trust-clip route): link-prediction AUC > 0.9.
6. summary  the card line, the kernels line, and the result line.

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
WIDTH = 256          # the fused (vertex|context) arena row: 2 x dim 128


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

def youtube_graph(seed):
    """Power-law random graph at Youtube scale: 1,138,499 vertices and
    ~4.9M undirected input edges (self loops dropped), symmetrized."""
    from graphvite_tpu_torch.graph import Graph

    rng = np.random.default_rng(seed)
    u = (rng.random(YOUTUBE_E) ** 2.5 * YOUTUBE_V).astype(np.int64)
    v = (rng.random(YOUTUBE_E) ** 2.5 * YOUTUBE_V).astype(np.int64)
    keep = u != v
    u, v = u[keep], v[keep]
    g = Graph()
    g.num_vertex = YOUTUBE_V
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
    from graphvite_tpu_torch.ops import scatter
    from graphvite_tpu_torch.solver import GraphSolver

    solver = GraphSolver(dim=128, float_type=float_type)
    solver.build(graph, optimizer=SGD_YOUTUBE, num_negative=1,
                 batch_size=batch_size, episode_size=25)
    # train() runs int(num_epoch * num_edge // effective_batch) batches
    t0 = time.perf_counter()
    solver.train(num_epoch=5 * batch_size / graph.num_edge,
                 **DEEPWALK_YOUTUBE)
    warm_s = time.perf_counter() - t0
    eff = solver.effective_batch

    scatter.scatter_add_.launches = 0
    t0 = time.perf_counter()
    solver.train(num_epoch=batches * eff / graph.num_edge + 1e-9,
                 **DEEPWALK_YOUTUBE)
    elapsed = time.perf_counter() - t0      # train() ends synchronized
    launches = scatter.scatter_add_.launches

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
    if launches != run:
        problems.append("%d kernel launches for %d batches" % (launches, run))
    if not rec["losses_finite"]:
        problems.append("losses not finite")
    if falling and not rec["loss_last"] < rec["loss_first"]:
        problems.append("losses not falling")
    if not tables_finite:
        problems.append("tables not finite")
    return solver, rec, problems


def trace_episode(solver, ms_per_batch, batches=10):
    """Device kernel time per batch over a short training call
    (torch.profiler), and its share of the unprofiled batch time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        solver.train(num_epoch=batches * solver.effective_batch
                     / solver.graph.num_edge + 1e-9, **DEEPWALK_YOUTUBE)
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
# phase 4: the kernel against its plain version
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
    if dtype == torch.float32:
        # summation orders differ (the plain version's index_add_ uses
        # atomics): rtol 1e-6 of the magnitude of the summed terms
        mag = scatter.scatter_add_plain(table.float().abs(), bad, upd.abs())
        ok = bool((diff <= 1e-6 * mag).all())
        tol = "|err| <= 1e-6 * (|table| + sum|upd|)"
    else:
        # both round one float32 sum once: within 1 bf16 ulp
        ok = bool((diff <= bf16_ulp(plain.float())).all())
        tol = "|err| <= 1 bf16 ulp"
    max_err = float(diff.max())
    del plain, got, bad
    if not ok:
        raise AssertionError("kernel disagrees with its plain version at "
                             "n=%d %s: max |err| %g" % (n, dtype, max_err))

    # timing on the batch's own ids (all in range, as the step passes them)
    t_kernel = table.clone()
    ms = cuda_ms(lambda: scatter.scatter_add_(t_kernel, ids, upd))
    sid, order = torch.sort(ids.to(torch.int32), stable=True)
    supd = upd.index_select(0, order)
    lib = scatter._library()
    code = 0 if dtype == torch.float32 else 1
    stream = torch.cuda.current_stream().cuda_stream
    kernel_only_ms = cuda_ms(lambda: lib.gv_scatter_add(
        t_kernel.data_ptr(), code, sid.data_ptr(), supd.data_ptr(), n, v, w,
        1, stream))
    plain_ms = cuda_ms(lambda: scatter.scatter_add_plain(t_kernel, ids, upd))
    upd_t = upd.to(dtype)
    library_ms = cuda_ms(lambda: t_kernel.index_add_(0, ids, upd_t))
    del t_kernel, table

    uniq = int(torch.unique(ids).numel())
    s = 4 if dtype == torch.float32 else 2
    nbytes = n * w * 4 + 2 * uniq * w * s + 4 * n
    bound_ms = max(nbytes / HBM_BYTES_PER_S, n * w / FP32_OPS_PER_S) * 1e3
    return {"n": n, "dtype": str(dtype).replace("torch.", ""),
            "unique_rows": uniq, "max_abs_err": max_err, "tolerance": tol,
            "ms": ms, "kernel_only_ms": kernel_only_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
            >= n * w / FP32_OPS_PER_S else "operations"}


# ---------------------------------------------------------------------------
# phase 5: quality
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


def quality(device=None):
    from graphvite_tpu_torch import GraphApplication
    from graphvite_tpu_torch.ops import scatter

    edges = two_blocks()
    app = GraphApplication(dim=16, device=device)
    app.load(edge_list=edges)
    app.build(optimizer={"type": "SGD", "lr": 0.1, "weight_decay": 5e-3},
              num_negative=1, batch_size=2048, episode_size=8)
    before = scatter.scatter_add_.launches
    app.train(model="DeepWalk", num_epoch=2000, augmentation_step=2,
              random_walk_length=8, negative_weight=1.0, log_frequency=10**9)
    launches = scatter.scatter_add_.launches - before
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
    return {"auc": auc, "micro_f1": nc["micro-F1@50%"],
            "fused_arena": app.solver._banded_fused,
            "batches": app.solver.batch_id, "launches": launches}


# ---------------------------------------------------------------------------

def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--main-batches", type=int, default=1000)
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
        from graphvite_tpu_torch.ops import scatter
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

    # 2. build
    def build():
        t0 = time.perf_counter()
        path, report = scatter.build(verbose=True)
        secs = time.perf_counter() - t0
        log("built %s in %.1f s" % (path, secs))
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log("   ptxas:", line.strip())
        scatter._library()
        return secs
    if not phase("build", build):
        return 1

    # 3. main path
    def main_path():
        t0 = time.perf_counter()
        graph = youtube_graph(args.seed)
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
        out["trace"] = trace_episode(solver, rec["ms_per_batch"])
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

    # 4. kernel against its plain version, on the main path's update ids
    def kernel():
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        cases = []
        for ids in results["main"]["batch_ids"]:
            for dtype in (torch.float32, torch.bfloat16):
                rec = check_kernel(ids, dtype, gen)
                log("   scatter_add", json.dumps(rec))
                cases.append(rec)
        return cases
    if "main" in results:
        phase("kernel", kernel)
    else:
        failures.append("kernel (needs the main path's update ids)")

    # 5. quality
    def quality_phase():
        q = quality()
        log("   two-block DeepWalk on the card:", json.dumps(q))
        if not q["auc"] > 0.9:
            raise AssertionError("link-prediction AUC %.4f <= 0.9" % q["auc"])
        if q["launches"] != 2 * q["batches"] or q["fused_arena"]:
            raise AssertionError("the unfused route did not launch the "
                                 "kernel twice per batch: %r" % q)
        return q
    phase("quality", quality_phase)

    if failures:
        log("FAILED phases: %s" % ", ".join(failures))
        return 1

    # 6. summary: the card line, the kernels line, the result line
    main_rec = results["main"]["float32"]
    cases = results["kernel"]
    case = cases[0]     # the batch-100000 update, float32 table
    kernels = {"kernels": [{
        "name": "scatter_add",
        "route": "cuda",
        "source": "graphvite_tpu_torch/csrc/scatter_add.cu",
        "replaces": "graphvite_tpu/ops/pallas_scatter.py:146",
        "launches": main_rec["launches"],
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": case["ms"],
        "kernel_ms": case["kernel_only_ms"],
        "plain_ms": case["plain_ms"],
        "bound_ms": case["bound_ms"],
        "bound_by": case["bound_by"],
        "library_ms": case["library_ms"],
    }]}
    log(card_line())
    log(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
