"""Smoke run of graphvite_tpu_torch on one NVIDIA GPU (an H100 is the target).

    python3 chip_smoke.py [--seed N] [--main-batches N]
                          [--node2vec-batches N] [--layout-batches N]
                          [--edge-batches N] [--kg-batches N]
                          [--kg-big-batches N]
                          [--only multihost|opt_ins|rotate_pool|walk_chain|
                                  walk_band]

(--only multihost runs the device and build phases, builds the three
graphs that phase reads, runs it, and prints no result line; --only
opt_ins the same for phases row_access and opt_ins; --only rotate_pool
the same for phase rotate_pool, which needs no graph; --only walk_chain
for phase walk_chain on the Youtube clone; --only walk_band the same for
phase walk_band.)

Phases, in order (any failure exits non-zero and prints no result line):

1. device   require CUDA; print the card's name and power limit; TF32 off.
2. build    compile the hand-written CUDA kernels (csrc/*.cu: scatter_add,
            gather_sorted, scatter_update, row_access, rotate_pool,
            walk_chain, walk_band) with
            nvcc, one
            process each, all started together, from the checkout's
            sources.
3. row_access the row-access bench
            (graphvite_tpu_torch/tools/row_access_bench.py, the
            counterpart of tools/pallas_bench.py) at the reference's shape
            (1,000,000 x 128 float32, N 325,520): every experiment in this
            process, the launch counts set to 0 just before and read just
            after (70 of each row-access kernel, 281 and 141 of kernel 1's
            sorted and unsorted entries); then gather_rows, rmw_rows_ and
            sweep_add_sorted_ bit for bit against their plain versions on
            the card at that shape (the sweep also on hub-skewed ids) and
            at the shapes the reference's kernels leave out (N 325,519,
            not a multiple of 512 nor of the sweep's 64-position chunk;
            4,099 x 20 with N 1,001: no 4-column vectors, so the sweep
            stages rows without TMA; repeated ids and ids >= V for the
            sweep), each timed at the reference's shape beside its plain
            version, index_select or index_add_ and its bytes bound (the
            sweep also beside kernel 1's sorted entry on the same ids);
            rmw_rows_(check_unique=True) must raise on a repeated id.
4. main     DeepWalk through GraphSolver.build/train at the
            config/graph/deepwalk_youtube.yaml hyperparameters (dim 128,
            SGD lr 0.025 wd 5e-3, K 1, negative_weight 5, aug 5, walk 40,
            batch 100000) on a Youtube-sized synthetic power-law graph
            (1,138,499 vertices, ~4.9M undirected edges) made from --seed:
            float32, --main-batches (600) batches (the
            kernels' launch counts are set to 0 just before
            and read just after), a torch.profiler trace of 10 more
            batches, a shorter bfloat16 run, and one batch at batch 250000.
            Checks the fused arena path, one scatter-add, one walk chain
            and one band kernel launch per batch,
            finite and falling losses, finite tables; prints pair-slot and
            valid-pair rates. From each run one batch is captured (the
            solver's own walk sampler, pool shape and negative sampler) and
            replayed: the fused step on the card against the same step on
            the CPU, over the whole 1,138,499 x 256 arena.
            Then phase walk_chain: the first-order chain's kernel
            (csrc/walk_chain.cu) on this graph at 192 walks (this batch),
            576 with the CSR start (a line_friendster.mesh4 worker-batch)
            and 96,000 (GRAPHVITE_BULK_WALKS's episode): bit-equal to the
            plain chain from integer and float start draws, and the ms of
            the chain function, the wrapper, the kernel alone and the
            plain chain beside its latency bound (one lane's chain on the
            same tables) and its bytes bound.
            Then phase walk_band: the banded step's positive band kernel
            (csrc/walk_band.cu) at deepwalk_youtube's batch (192 x 41 x
            128, 10 offsets) and a line_friendster.mesh4 worker-batch's
            (576 x 41 x 96, 4): against its plain version (relative gaps
            of dv, dc and the loss at most 1e-6, the counts the same
            bits), the ms of the wrapper, the kernel alone, the plain
            version and the SGD core with either, and one walk's time,
            beside its bound (the larger of its bytes at the HBM peak and
            the latency floor of a launch of its grid: a load, a warp sum,
            a barrier and a store a block); and one launch a step in 20
            DeepWalk batches on this graph (graphvite::walk_band_kernel).
5. node2vec node2vec through GraphApplication at the
            config/graph/node2vec_youtube.yaml hyperparameters (p 4, q 2,
            dim 128, SGD lr 0.025 wd 5e-3, K 1, negative_weight 5, aug 5,
            walk 40, batch 100000) on the same graph: the cuckoo table's
            host build (seconds, bytes), --node2vec-batches (600) measured
            batches (ms/batch, valid pairs/s, one scatter-add launch per
            batch on the fused arena, finite and falling losses, host
            syncs per batch of the loop's body and their call sites by
            torch's sync debug mode, peak memory, a trace of 10 batches:
            kernels per batch), the chain's R, round cap, proposal rounds
            per step and time; the chain on the card against the CPU from
            the same draws (ids equal), and one batch's step replayed on
            the card against the CPU.
6. layouts  DeepWalk at the deepwalk_youtube.yaml shape on the pair layout
            (GRAPHVITE_WALK_STEP=pair), the multitail layout
            (GRAPHVITE_WALK_STEP=multitail) and the classic K-draw step
            (GRAPHVITE_NEG_SHARING=0), --layout-batches each: ms/batch,
            kernels per batch (a trace of 5), kernel 1 on the vertex and
            the context table per step, one batch replayed on the card
            against the CPU.
7. edge     LINE through GraphSolver.build/train at the
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
8. opt_ins  the reference's experimental walk opt-ins, each with its switch
            set, on the Youtube and Flickr clones of phases main and edge
            at the configs' widths (3 warm-up batches, then the measured
            call with the launch counts set to 0 just before and read just
            after; ms/batch, launches per batch, finite losses, a falling
            loss on the pool-step runs; one batch replayed on the card
            against the CPU at the steps' tolerances): (a)
            GRAPHVITE_SWEEP_WALK=1, DeepWalk SGD on the pair step with
            sort_heads, 50 batches of 99,328 pairs (gather_sorted, kernel
            1 sorted and unsorted once per batch); (b) Adam lr 1e-6 wd 0,
            20 (gather_sorted once, kernel 2 sorted and unsorted once);
            (c) GRAPHVITE_BULK_WALKS=1, DeepWalk, 50 batches in episodes
            of 25, the episode sample on the card equal to the CPU's from
            the same draws; (d) node2vec, 20; (e) GRAPHVITE_BF16_BAND=1 on
            bfloat16 tables: the fused arena, 50, then the walks engine
            with two workers on the card, 10 worker-batches, and the
            engine at W = 2 on the card against the CPU on a
            20,000-vertex graph; (f) GRAPHVITE_SWEEP_BANDED=1, float32 and
            bfloat16 SGD, 50 each (kernel 1 twice per batch); (g)
            GRAPHVITE_BF16_COMPUTE=1, LINE bfloat16 at the line_flickr.yaml
            shape, 50 (the edge route's three launches).
9. kg       RotatE through KnowledgeGraphApplication.load/build/train/
            evaluate at the config/knowledge_graph/rotate_fb15k.yaml
            hyperparameters (dim 2048, Adam lr 2e-4, K 64, batch 100000,
            margin 24, adversarial temperature 2, episode 1) on a graph of
            FB15k's published size made from --seed (14,951 entities,
            1,345 relations, 483,142 / 50,000 / 59,071 triplets;
            deterministic maps mod the prime 14,951). --kg-batches (50)
            measured batches. The pooled step,
            batch 14,848 as 2 micro-steps of 7,424, 16 groups of 464
            sharing 128 candidates, the RotatE isometry body (its two
            kernels once per micro-step, checked), the dense moment
            route (so no update kernel of the port is on this path, and
            the run checks that none launched). Falling loss, finite
            tables, moving moments; a torch.profiler trace of 10 batches;
            one captured micro-step replayed on the card against the CPU
            from the same state and candidate ids; filtered ranking of
            the first 2,000 test triplets, both sides, on the card, and
            filtered_rankings on the card against the CPU on 64 of them.
10. kg_big   RotatE at the config/knowledge_graph/rotate_wikidata5m.yaml
            hyperparameters (dim 512, SGD lr 0.01, K 64, batch 100000,
            margin 6, adversarial temperature 0.2, episode 200) on a
            graph of Wikidata5m's published size made from --seed
            (4,594,485 power-law entities, 822 relations, 20,614,279
            triplets), --kg-big-batches (50) measured float32 batches
            (half as many bfloat16, a quarter Adam, at least 10). The
            pooled step, batch 60,928, 128 groups of 476.
            float32 and bfloat16 SGD: every batch ends in scatter_add_ on
            the entity table (138,240 unsorted ids x 512) and on the
            relation table (60,928 ids over 822 rows); then a float32
            Adam run (not the config's optimizer: kernel 2's path), whose
            every batch ends in scatter_update_ on the entity table. From
            each run one batch is captured and replayed on the card
            against the CPU, which holds a renumbered copy of the touched
            rows. Every run: the RotatE body's two kernels once a batch.
            Then phase rotate_pool: the body's kernels
            (ops/rotate_pool.py) at this batch (128 groups of 476, pools
            of 128, Dh 256, SGD) and at kg's micro-step (16 groups of
            464, Dh 1024, Adam's squared sums), against the plain version
            on the groups of its first pass, two calls the same bits;
            event-timed wrapper, kernels alone, the plain version over
            the step's passes, and the bound (benchmark/counts/rotate.py's
            14 operations a pair and dimension at the float32 peak).
11. vis      LargeVis through VisualizationApplication.load/build/train at
            the config/visualization/largevis_mnist_2d.yaml
            hyperparameters (dim 2 padded to 8 columns, num_neighbor 200,
            perplexity 20, Adam lr 0.5 wd 1e-5, K 5, negative_weight 3,
            batch 100000, episode 200) on the MNIST clone of
            tools/largevis_mnist.py (70,000 x 784, 10 classes) made from
            --seed: the exact KNN graph on the card (14,000,000 edges;
            seconds of products and top-k, perplexity, reciprocal), all
            50 epochs (7,011 batches of 99,840, 64 pools of 256; the dense
            moment route, so no kernel launches), the tools' 10-NN label
            agreement probe (>= 0.95), a torch.profiler trace of 20
            batches; a float32 SGD run of 500 batches (one scatter_add_
            launch per batch: the trust clip's accumulate at 8 columns)
            and a bfloat16 Adam run of 200; one batch of the Adam and of
            the SGD run replayed on the card against the CPU over the
            whole 70,000 x 8 table.
12. vis_big LargeVis at config/visualization/largevis_imagenet.yaml
            (perplexity 50) on a clone of tools/largevis_imagenet.py's
            statistics drawn on the card (1,331,167 x 2048, 1000
            classes): KNNGraph's auto route is the
            IVF search (bfloat16 rows, 2,307 lists, nprobe 16, 266M
            edges), with seconds of k-means, assignment, queries,
            perplexity, reciprocal and the host alias build; recall@200 on
            512 queries (>= 0.75, on the raw vectors as the tool scores
            it, and on the normalized ones the search used); 200 Adam
            batches with a trace of 10.
13. blocked LINE through GraphApplication at the
            config/graph/line_friendster-small.yaml hyperparameters (dim
            128, SGD lr 0.025 wd 5e-3, K 1, negative_weight 5, aug 1,
            batch 100000, episode 3500) on a power-law graph of
            friendster-small's 7,944,949 vertices and 32M input edges made
            from --seed, on blocked episodes with GRAPHVITE_MIN_SWEEPS=1
            (16 episodes of 64 of 1,024 batches): (a) num_partition=4 with
            the shards on the card (GRAPHVITE_HOST_MASTER=0); (b) the auto
            rule under a gpu_memory_limit of 0.9 x the tables' and edges'
            demand, which must pick P = 4 and the host master, give (a)'s
            tables and losses bit for bit and keep its peak device memory
            under the limit; predict on (b)'s host tables (the host-row
            path) against manual scoring within 1e-4; (c) Adam (lr 1e-6,
            wd 0) with the host master. Each run: kernel 1 (SGD) or
            kernel 2 (Adam) exactly twice per batch and nothing else,
            ms/batch, samples/s, episodes, cache hits and misses, staging
            bytes and seconds per episode, set-up seconds by stage, peak
            memory; one more episode of (a) and of (b) traced.
14. mesh    the multi-device engines with two workers on the card
            (GraphApplication / VisualizationApplication with gpus [0, 0])
            on the graphs the phases above built: (a) LINE in edges mode
            on the friendster-small clone, SGD (512 worker-batches of
            99,840) and Adam lr 1e-6 wd 0 (256), the block tables built
            once; (b) DeepWalk in walks mode on the Youtube clone at the
            deepwalk_youtube.yaml hyperparameters, SGD (100 of 78,720)
            and Adam (50), node2vec p 4 q 2 (20), and one worker through
            the engine (50) against phase main's ms/batch; (c) LargeVis
            replicas on the MNIST clone, Adam for 20 of the config's 50
            epochs (10-NN agreement >= 0.95) and SGD (200). Each run:
            kernel 1 (SGD: twice per worker-batch in edges mode, once on
            the walks arena and the replicas) or kernel 2 (Adam, twice)
            and nothing else, ms per worker-batch, samples or valid pairs
            per second, the drop share (< 1%), set-up seconds, peak
            memory; two more episodes of 2 batches per worker: host syncs
            per worker-batch (none allowed) with the update ids of a
            worker-batch, and a torch.profiler trace (kernels and device
            time per worker-batch, the collectives' device time). Then
            two-block LINE and DeepWalk at W = 2 (AUC > 0.9), and each
            engine with four workers on the card against four on the CPU
            from the same draws and state (a 20,000-vertex graph, dim 32:
            tables rtol 3e-4, atol 3e-6, losses rtol 2e-5).
15. kg_mesh the knowledge-graph engines with two workers on the card
            (KnowledgeGraphApplication with gpus [0, 0], GRAPHVITE_MIN_SWEEPS=1)
            on kg_big's Wikidata5m-shaped graph at the
            rotate_wikidata5m.yaml hyperparameters (dim 512, K 64, margin
            6, adversarial temperature 0.2) with episodes of 16: (a)
            pooled negatives by the auto rule, SGD lr 0.01, 96
            worker-batches of 60,928 (one sweep of three rounds); (b)
            pooled, Adam lr 1e-6 wd 0, 96; (c) global negatives
            (GRAPHVITE_KG_NEG_POOL=global), SGD, 48 of 1,792; (d) resident
            negatives, SGD, 48. Each run: kernel 1 twice per worker-batch
            (SGD; four times with the global pool's sum and owner update)
            or kernel 2 once (Adam) and nothing else, ms per
            worker-batch, triplets/s over both workers, set-up seconds,
            peak memory; two more rounds of 2 batches per worker: host
            syncs per worker-batch (none allowed) with the update ids of
            a worker-batch, and a torch.profiler trace (kernels, device
            time and busy share per worker-batch, the collectives'
            device time). Then on a 2,000-entity power-law KG at dim 32:
            five rounds at lr 0 give back the tables bit for bit (W 2
            and 4, each mode), and each mode with SGD and Adam at W 2
            and 4 on the card against as many CPU workers from the same
            draws (tables rtol 3e-4, atol 3e-6, losses rtol 2e-5); then
            config/demo/math.yaml with gpus [0, 0] at dim 128, 500
            epochs through the CLI (global negatives by the auto rule):
            filtered tail MRR >= the JAX package's at W = 2 on the CPU
            less 0.05 (KG_MESH_MATH_GATE).
16. multihost the multi-device engines over two processes
            (GRAPHVITE_COORDINATOR=localhost:<free port>; this script run
            twice with --multihost-child, one worker each on cuda:0, so
            the gloo transport, each tensor that crosses staged through
            pinned host buffers), on the graphs of phases edge, main and
            kg_big, which the parent writes once as .npy with the Flickr
            clone's block edge tables and the Wikidata5m clone's
            block-sorted triplets; the initial tables are drawn on the
            card from --seed in every process. Cases, each also run as
            one process with two workers on cuda:0 from the same seed:
            (a) LINE edges mode at the line_flickr.yaml hyperparameters
            (dim 128, SGD lr 0.025 wd 5e-3, K 1, negative_weight 5), 128
            worker-batches of 99,840 in two episodes; (b) Adam lr 1e-6
            wd 0, 32; (c) DeepWalk walks mode at the deepwalk_youtube.yaml
            hyperparameters, 10 of 78,720 (three all_to_alls across the
            processes a batch); (d) RotatE pooled at the
            rotate_wikidata5m.yaml width (dim 512, SGD lr 0.01, K 64), 24
            of 60,928 in two rounds; (e) global negatives, 8 of 1,792 (an
            all_gather and a reduce_scatter across the processes a
            batch). Each case: the sha256 digests of every worker's
            tables, moments and losses (and of the gathered tables in
            edges and walks mode) equal to the one-process group's, the
            kernels' launches per worker-batch equal to it (kernel 1
            twice in (a) and (d), once in (c), four times in (e); kernel
            2 twice in (b)), ms per worker-batch of both, and the
            cross-process seconds and bytes per episode. With two cards
            or more, (a) again with one process per card (NCCL) against
            one process with a worker on each; with one, the phase says
            NCCL was not exercised. A process that fails or outlasts
            MH_TIMEOUT_S fails the phase.
17. host    sampler_backend="host" (the host samplers' pools from a
            background thread, uploaded from pinned memory; episodes of
            8): LINE at the line_flickr.yaml shape (100 batches of
            100,000; the pair pool step, kernel 1 on each table),
            DeepWalk at the deepwalk_youtube.yaml shape (24; the pair
            step, kernel 1 twice), RotatE at the rotate_wikidata5m.yaml
            shape (SGD, 24 of 100,000; kernel 1 twice; Adam lr 1e-6 wd
            0, 8: kernel 2 once), LargeVis on the MNIST clone (Adam, 100;
            the dense route): ms/batch, the
            seconds the sampler thread spent making pools against the
            loop's, the wait share on PrefetchingPool.next, launches per
            batch; node2vec's second-order entries at the Youtube shape,
            counted (the table is not built).
18. kernel  each kernel against its plain torch version on the card, on the
            ids the main paths drew: scatter_add on the DeepWalk update ids
            (batch 100000 and 250000, with dropped ids added, float32 and
            bfloat16 tables), on the node2vec batch's (float32) and on the
            edge route's sorted heads;
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
            Then the KG paths' ids at 512 and 2048 columns, float32 and
            bfloat16 tables: scatter_add_ on the 138,240 entity ids and
            the 60,928 relation ids of the Wikidata5m-shaped batch and on
            the 16,896 x 2048 ids of the FB15k-shaped micro-step;
            scatter_update_ (Adam, the pooled step's touch counts) on the
            entity and the relation ids. The plain version runs on a
            renumbered copy of the touched rows. Then 8 columns:
            scatter_add_ on the vis SGD batch's 216,064 update ids and
            scatter_update_ (Adam, the pooled step's touch counts) on
            the same ids, float32 and bfloat16 tables. Then the blocked
            path's shard-local ids (100,000 heads and 200,000 context ids
            of one batch over a ~1.99M x 128 shard): scatter_add_ float32
            and bfloat16, scatter_update_ (Adam, one touch per entry).
            Then the mesh engines' update ids of one worker-batch:
            scatter_add_ on the edges engine's vertex and context shards
            (~3.97M x 128) and the walks engine's fused arena (~569k x
            256), scatter_update_ (Adam, the engines' counts) on both
            engines' shards. Then the KG engines' worker-batch:
            scatter_add_ on the entity arena (2,297,244 x 512) and the
            relations (822 x 512), scatter_update_ (Adam, the pooled
            step's counts) on the arena; the global pool's pool-space
            sum (8,192 x 512 + counts) and owner update. Then the host
            backend's first batch: scatter_add_ on LINE's vertex and
            context tables (1,715,256 x 128, unsorted) and RotatE's
            entity and relation tables, scatter_update_ on RotatE
            Adam's entity table.
19. quality  GraphApplication on a small two-block graph on the card:
            DeepWalk (the unfused trust-clip route), node2vec (p 4, q 2,
            the same route), the classic step (GRAPHVITE_NEG_SHARING=0),
            LINE on the edge route (the small-table route, the trust clip
            on the scatter-add) and LINE on blocked episodes (P 4, the
            host master; evaluated on the tables in host memory), and
            LINE, DeepWalk and node2vec (its second-order table built on
            the host, the entries counted) on sampler_backend="host":
            link-prediction AUC > 0.9.
20. cli     the port's command line: `python3 -m graphvite_tpu_torch.cmd
            list` in a process of its own (the total of baselines), then
            three shipped configs through cmd.load_config and
            cmd.run_config, each copied with its save: path moved into a
            temporary dataset directory (GRAPHVITE_DATASET_PATH, removed
            at the end; the phase downloads nothing), the kernels' launch
            counts set to 0 just before each run and read just after:
            config/demo/quick_start.yaml cut to 600 of its 2000
            epochs on this script's copy of the BlogCatalog clone of
            tools/blogcatalog_clone.py (10,312 vertices, 39 communities;
            206,311 distinct edges at seed 0, about 62% of BlogCatalog's
            333,983) written as the registry's raw files, so the
            registry makes the config's 100:1:1 link-prediction split
            (LINE, aug 2, the unfused walk step, kernel 1 on each table):
            link-prediction AUC >= 0.85, micro-F1@20% recorded;
            config/demo/math.yaml cut to dim 128 and 500 epochs (the
            offline math fixture): filtered tail MRR >= 0.60;
            config/word_graph/line_wikipedia.yaml at its 80 epochs on a
            planted-topic corpus of 3M tokens (this script's
            copy of tools/word_graph_e2e.py:write_corpus: 50 topics, a
            Zipf vocabulary of 100,000): the word graph's host build,
            LINE on the edge route (kernel 1 on the small-table update),
            same-topic minus random-pair cosine >= 0.2, the saved model
            reloaded through load_model giving the same predict scores.
            Every run: stage seconds, ms/batch, samples/s, kernel 1
            launches per batch (>= 1 on the two graph configs), a falling
            loss, finite tables, peak memory, a trace of 10 batches. Then
            kernel 1 against its plain version (and timed, beside
            index_add_ and its bound) on the vertex and the context ids
            of one more batch of each graph config.
21. summary the card line, the kernels line (every kernel's launches by
            path, with the walk chain's kernel once a batch's sample on the
            first-order walk routes and the band's once a micro-step on
            the banded SGD walk steps: every measured walk-route call
            above checks those counts, the band's read from a recording
            session around the call), and the result line.

Imports nothing of JAX or of the JAX package.
"""
import argparse
import concurrent.futures
import contextlib
import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
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
HERE = os.path.dirname(os.path.abspath(__file__))
# the program's spans, whose device-side copies a profile lists beside the
# kernels (utils/tracing.py): no device activity of their own
SPANS = ("graphvite::", "mesh::")


def log(*args):
    print(*args, flush=True)


@contextlib.contextmanager
def environ(env):
    """Set the variables of `env` for the block, then restore each to its
    earlier value (or remove it)."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


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


def queued_ms(launch, n=20, reps=5):
    """Device ms of one of `n` launches in a row, the median of `reps`:
    the card first spins (torch.cuda._sleep) while the host queues them
    all, so the launches run back to back and the host's pace drops
    out."""
    import torch

    launch()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(n):
            launch()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
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
    kernel 3; gather_rows, rmw_rows_ and sweep_add_sorted_ the row-access
    kernels; walk_chain the first-order walk chain's kernel)."""
    from graphvite_tpu_torch.ops import device_sampler, gather, row_access
    from graphvite_tpu_torch.ops import scatter

    fns = (scatter.scatter_add_, scatter.scatter_add_sorted_,
           scatter.scatter_update_, scatter.scatter_update_sorted_,
           gather.gather_sorted, row_access.gather_rows,
           row_access.rmw_rows_, row_access.sweep_add_sorted_,
           device_sampler.walk_chain)
    return {fn.__name__: fn for fn in fns}


_band_count = None    # the recording session reset_launches() opened


def reset_launches():
    """Set every wrapper's launch count to 0 and open a recording session
    for read_launches() to read the band kernel's launches from (the
    graphvite::walk_band_kernel counter: the band's wrapper keeps no count
    of its own)."""
    global _band_count
    from graphvite_tpu_torch.utils import tracing

    for fn in wrappers().values():
        fn.launches = 0
    if _band_count is not None:
        _band_count[0].__exit__(None, None, None)
    cm = tracing.recording()
    _band_count = (cm, cm.__enter__())


def read_launches():
    """Each wrapper's launches since reset_launches(), and the band
    kernel's under "walk_band" (the session closed)."""
    from graphvite_tpu_torch.utils import tracing

    global _band_count
    counts = {name: fn.launches for name, fn in wrappers().items()}
    cm, session = _band_count
    _band_count = None
    cm.__exit__(None, None, None)
    counts["walk_band"] = session.counters.get(tracing.WALK_BAND_KERNEL, 0)
    return counts


def walk_chain_launches(solver, run):
    """The walk chain kernel's launches that a solver's last train() call
    of `run` batches should show: one a batch's sample on the card's
    first-order walk routes, one an episode's with GRAPHVITE_BULK_WALKS
    (its chain of W * n lanes), none for node2vec's biased chain or off
    the walk route."""
    sampler = getattr(solver, "_active_sampler", None)
    if (not hasattr(sampler, "make_chain_fn")
            or getattr(sampler, "biased", False)):
        return 0
    bulk = getattr(solver, "_active_bulk_fn", None)
    return run if bulk is None else run * sampler.num_walk // bulk.lanes


def walk_band_launches(solver, run):
    """The band kernel's launches that a solver's last train() call of
    `run` batches should show: one a micro-step on the banded walk steps
    (make_graph_banded_fused_step, make_graph_banded_walk_step) with SGD,
    none with a moment rule (its per-offset band) or on another step."""
    step = getattr(solver, "_active_step_fn", None)
    base = getattr(step, "base", step)
    if (solver.optimizer.num_moment
            or not getattr(base, "__qualname__", "").startswith(
                "make_graph_banded_")):
        return 0
    return run * solver._batch_plan()[2]


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
    chains = counts["walk_chain"]
    bands = counts["walk_band"]

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
           "launches": launches, "chain_launches": chains,
           "band_launches": bands,
           "fused_arena": solver._banded_fused,
           "context_rows_touched": touched,
           "loss_first": float(losses[:k].mean()),
           "loss_last": float(losses[-k:].mean()),
           "losses_finite": bool(torch.isfinite(losses).all()),
           "tables_finite": tables_finite,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    problems = []
    if not rec["fused_arena"]:
        problems.append("the fused arena was not chosen")
    # kernel 1, the walk chain's kernel and the band's once a batch
    if (launches != run or chains != run or bands != run
            or sum(counts.values()) != launches + chains + bands):
        problems.append("kernel launches %r for %d batches" % (counts, run))
    if not rec["losses_finite"]:
        problems.append("losses not finite")
    if falling and not rec["loss_last"] < rec["loss_first"]:
        problems.append("losses not falling")
    if not tables_finite:
        problems.append("tables not finite")
    return solver, rec, problems


def trace_episode(solver, train_kwargs, batches=10):
    """Device kernel time per batch over a short training call
    (torch.profiler)."""
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
        if (ev.device_type == DeviceType.CUDA and ev.self_device_time_total
                and not ev.key.startswith(SPANS)):
            rows.append((ev.self_device_time_total, ev.count, ev.key))
    if not rows:
        raise AssertionError("the profiler recorded no device time")
    rows.sort(reverse=True)
    launches = sum(r[1] for r in rows) / run
    device_ms = sum(r[0] for r in rows) / 1e3 / run
    return {"batches": run, "device_ms_per_batch": device_ms,
            "kernels_per_batch": launches,
            "top": [{"kernel": name[:70], "ms_per_batch": us / 1e3 / run,
                     "calls_per_batch": c / run}
                    for us, c, name in rows[:15]]}


# ---------------------------------------------------------------------------
# phases 4-5: node2vec and the walk layouts
# ---------------------------------------------------------------------------

NODE2VEC_YOUTUBE = dict(model="node2vec", augmentation_step=5,
                        random_walk_length=40, p=4.0, q=2.0,
                        negative_weight=5.0, log_frequency=10**9)
# the other walk layouts and the classic step, each picked by the
# reference's switch, DeepWalk at the same shape
WALK_LAYOUTS = (("pair", {"GRAPHVITE_WALK_STEP": "pair"}),
                ("multitail", {"GRAPHVITE_WALK_STEP": "multitail"}),
                ("classic", {"GRAPHVITE_NEG_SHARING": "0"}))


def syncs_per_call(fn, calls=3):
    """Host syncs that `fn` makes, per call, and their call sites: the
    warnings of torch's sync debug mode (an explicit
    torch.cuda.synchronize is not one), each attributed to the innermost
    frame of this checkout and the frame that made the synchronizing call,
    as {"file:line -> file:line": count}."""
    import traceback
    import warnings

    import torch

    sites = {}

    def show(message, category, filename, lineno, *args, **kwargs):
        if "called a synchronizing CUDA operation" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()[:-1]
                if os.path.abspath(f.filename).startswith(HERE + os.sep)]
        site = "%s:%d -> %s:%d" % (
            os.path.relpath(ours[-1].filename, HERE), ours[-1].lineno,
            os.path.basename(filename), lineno)
        sites[site] = sites.get(site, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(calls):
                fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum(sites.values()) / calls, sites


def chain_record(solver, seed):
    """node2vec's chain on the solver's sampler: R, the round cap, the
    rounds a lockstep loop (the reference's while_loop) runs per step and
    each live lane's rounds, the chain's time and host syncs, and the
    chain on the card against the CPU from the same draws (ids, validity
    and rounds must be equal)."""
    import torch

    sampler = solver._active_sampler
    arrays = sampler.arrays()
    fn = sampler.make_chain_fn()
    R, C = fn.proposals, fn.rounds_cap
    W, L = sampler.num_walk, sampler.walk_length
    dev = solver.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    lockstep, lanes = [], []
    for _ in range(8):
        draws = (torch.rand(W, generator=gen, device=dev),
                 torch.rand(W, generator=gen, device=dev),
                 torch.rand((L - 1, C, 3, R, W), generator=gen, device=dev))
        chain, valid, rounds = fn(*arrays, draws=draws, with_rounds=True)
        lockstep.append(rounds.amax(dim=1).double().mean())
        lanes.append(rounds[rounds > 0].double().mean())
    cpu = fn(*(a.cpu() for a in arrays), draws=tuple(d.cpu() for d in draws),
             with_rounds=True)
    equal = all(torch.equal(a.cpu(), b) for a, b in zip((chain, valid,
                                                         rounds), cpu))
    rec = {"proposals": R, "round_cap": C, "walks": W,
           "membership": sampler.membership,
           "table_bytes": sampler.memb.numel() * 4,
           "lockstep_rounds_per_step": float(torch.stack(lockstep).mean()),
           "lane_rounds_per_step": float(torch.stack(lanes).mean()),
           "capped_lanes": int((rounds == C).sum()),
           "chain_equal_card_cpu": equal}
    rec["chain_ms"] = cuda_ms(lambda: fn(*arrays, draws=draws), reps=10)
    rec["chain_syncs"], rec["chain_sync_sites"] = syncs_per_call(
        lambda: fn(*arrays, draws=draws))
    return rec


def loop_syncs_per_batch(solver, seed):
    """Host syncs of the episode loop's body, per batch, and their call
    sites: one batch drawn by the solver's sampler and trained by its step
    on a packed copy of the state (torch's sync debug mode)."""
    import torch
    from graphvite_tpu_torch.ops import steps

    gen = torch.Generator(device=solver.device).manual_seed(seed)
    state = steps.banded_fused_pack(solver.state)
    arrays = solver._active_sampler.arrays()
    step, neg = solver._active_step_fn, solver._active_neg_state

    def one_batch():
        *ids, mask = solver._active_sample_fn(*arrays, generator=gen)
        step(state, *ids, 1e-3, *neg, mask=mask, generator=gen)

    with torch.no_grad():
        return syncs_per_call(one_batch)


def node2vec_path(graph, batches, seed):
    """node2vec through GraphApplication at the node2vec_youtube.yaml
    shape: the cuckoo table's host build (timed alone, then the solver's
    own), 5 warm-up batches, the measured call with the launch counts set
    to 0 just before and read just after, host syncs per batch, a trace,
    the chain record, and one batch replayed on the card against the CPU
    (replay_batch: the fused arena). Returns (record, update ids,
    problems)."""
    import torch
    from graphvite_tpu_torch import GraphApplication
    from graphvite_tpu_torch.ops.device_sampler import DeviceWalkSampler

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    table = DeviceWalkSampler._build_cuckoo(graph)
    cuckoo_s = time.perf_counter() - t0
    if table is None:
        raise AssertionError("the cuckoo table was not built")
    del table
    app = GraphApplication(dim=DIM)
    app.graph = graph
    app.build(optimizer=SGD_YOUTUBE, num_negative=1, batch_size=100000,
              episode_size=25)
    solver = app.solver
    t0 = time.perf_counter()
    app.train(num_epoch=5 * 100000 / graph.num_edge, **NODE2VEC_YOUTUBE)
    warm_s = time.perf_counter() - t0
    eff = solver.effective_batch

    reset_launches()
    t0 = time.perf_counter()
    app.train(num_epoch=batches * eff / graph.num_edge + 1e-9,
              **NODE2VEC_YOUTUBE)
    elapsed = time.perf_counter() - t0          # train() ends synchronized
    counts = read_launches()
    run = solver.batch_id
    # as in the main phase: the loss moves slowly from ln 2 (context rows
    # start at zero), so compare the first and last tenth in float64
    losses = solver.batch_losses.double()
    k = max(run // 10, 5)
    vf = valid_fraction(solver)
    sampler = solver._active_sampler
    syncs, sync_sites = loop_syncs_per_batch(solver, seed)
    rec = {"batches": run, "effective_batch": eff,
           "cuckoo_build_s": cuckoo_s, "warmup_s": warm_s,
           "elapsed_s": elapsed, "ms_per_batch": elapsed / run * 1e3,
           "pair_slots_per_s": run * eff / elapsed, "valid_fraction": vf,
           "valid_pairs_per_s": run * eff * vf / elapsed,
           "launches": counts,
           "host_syncs_per_batch": syncs, "host_sync_sites": sync_sites,
           "fused_arena": solver._banded_fused, "biased": sampler.biased,
           "p": sampler.p, "q": sampler.q,
           "loss_first": float(losses[:k].mean()),
           "loss_last": float(losses[-k:].mean()),
           "losses_finite": bool(torch.isfinite(losses).all()),
           "tables_finite": all(bool(torch.isfinite(t.float()).all())
                                for t in solver.state["tables"]),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    problems = []
    if not (rec["biased"] and (rec["p"], rec["q"]) == (4.0, 2.0)
            and rec["fused_arena"]):
        problems.append("not the biased sampler on the fused arena: %r"
                        % rec)
    # kernel 1 and the band's once a batch; node2vec's chain is torch's
    if (counts["scatter_add_"] != run or counts["walk_band"] != run
            or sum(counts.values()) != 2 * run):
        problems.append("kernel launches %r for %d batches" % (counts, run))
    if not rec["losses_finite"] or not rec["tables_finite"]:
        problems.append("losses or tables not finite")
    if not rec["loss_last"] < rec["loss_first"]:
        problems.append("losses not falling")
    rec["trace"] = trace_episode(solver, NODE2VEC_YOUTUBE)
    rec["chain"] = chain_record(solver, seed)
    if sampler.membership != "cuckoo":
        problems.append("membership %r, not the cuckoo table"
                        % sampler.membership)
    if not rec["chain"]["chain_equal_card_cpu"]:
        problems.append("chains differ: %r" % rec["chain"])
    rep, ids, bad = replay_batch(solver, seed + 1)
    rec["replay"] = rep
    problems += ["replay: " + p for p in bad]
    return rec, ids, problems


def replay_walk_step(solver, seed):
    """One batch of a separate-table walk step (pair, multitail, classic,
    the unfused banded step) on the card and on the CPU from the same
    tables, batch and draws. Tolerances of the CPU tests: tables rtol
    3e-4, atol 3e-6 (plus 1 bf16 ulp on bf16 tables, as replay_batch);
    loss rtol 2e-5. Returns (record, problems)."""
    import torch

    dev = solver.device
    step, neg = solver._active_step_fn, solver._active_neg_state
    step = getattr(step, "base", step)       # one micro-step's chunk
    gen = torch.Generator(device=dev).manual_seed(seed)
    *ids, mask = solver._active_sample_fn(*solver._active_sampler.arrays(),
                                          generator=gen)
    shape = (step.pool_shape if hasattr(step, "pool_shape")
             else step.draw_shape(ids[0].shape[0]))
    draws = tuple(torch.rand(shape, generator=gen, device=dev)
                  for _ in range(2))
    lr = solver.optimizer.schedule_lr(0, solver.num_batch)
    tables = [t.clone() for t in solver.state["tables"]]
    cpu_tables = [t.to("cpu", copy=True) for t in tables]
    with torch.no_grad():
        new, loss = step({"tables": tuple(tables), "moments": ((), ())},
                         *ids, lr, *neg, mask=mask, draws=draws)
        cpu_new, cpu_loss = step(
            {"tables": tuple(cpu_tables), "moments": ((), ())},
            *(i.cpu() for i in ids), lr, *(t.cpu() for t in neg),
            mask=mask.cpu(), draws=tuple(d.cpu() for d in draws))
    diff = 0.0
    ok = True
    for got, want in zip(new["tables"], cpu_new["tables"]):
        got, want = got.float(), want.to(dev).float()
        d = (got - want).abs()
        tol = 3e-6 + 3e-4 * want.abs()
        if new["tables"][0].dtype == torch.bfloat16:
            tol = tol + bf16_ulp(torch.maximum(got.abs(), want.abs()))
        ok = ok and bool((d <= tol).all())
        diff = max(diff, float(d.max()))
    rec = {"rows": int(ids[0].numel()), "loss": float(loss),
           "cpu_loss": float(cpu_loss), "max_abs_diff": diff,
           "tolerance": "rtol 3e-4, atol 3e-6 (+ 1 bf16 ulp on bf16 "
                        "tables)"}
    problems = []
    if not ok:
        problems.append("card and CPU disagree on a batch: %r" % rec)
    if abs(rec["loss"] - rec["cpu_loss"]) > 2e-5 * abs(rec["cpu_loss"]):
        problems.append("card loss vs CPU loss: %r" % rec)
    return rec, problems


def walk_layout_path(graph, name, env, batches, seed):
    """DeepWalk at the deepwalk_youtube.yaml shape on one more walk layout
    (its switch set in the environment for the run): 5 warm-up batches,
    the measured call (launch counts set to 0 just before, read just
    after: kernel 1 on the vertex and the context table, per micro-step),
    a trace of 5 batches and one replay. Returns (record, problems)."""
    import torch
    from graphvite_tpu_torch.solver import GraphSolver

    with environ(env):
        solver = GraphSolver(dim=DIM)
        solver.build(graph, optimizer=SGD_YOUTUBE, num_negative=1,
                     batch_size=100000, episode_size=25)
        solver.train(num_epoch=5 * 100000 / graph.num_edge,
                     **DEEPWALK_YOUTUBE)
        eff = solver.effective_batch
        reset_launches()
        t0 = time.perf_counter()
        solver.train(num_epoch=batches * eff / graph.num_edge + 1e-9,
                     **DEEPWALK_YOUTUBE)
        elapsed = time.perf_counter() - t0
        counts = read_launches()
        run = solver.batch_id
        vf = valid_fraction(solver)
        step = solver._active_step_fn
        micro = solver._batch_plan()[2]
        rec = {"layout": name, "env": env, "batches": run,
               "effective_batch": eff, "micro_steps": micro,
               "step": getattr(step, "base", step).__qualname__.split(".")[0],
               "ms_per_batch": elapsed / run * 1e3,
               "pair_slots_per_s": run * eff / elapsed,
               "valid_fraction": vf,
               "valid_pairs_per_s": run * eff * vf / elapsed,
               "launches": counts,
               "losses_finite": bool(torch.isfinite(
                   solver.batch_losses).all())}
        rec["trace"] = trace_episode(solver, DEEPWALK_YOUTUBE, batches=5)
        rep, problems = replay_walk_step(solver, seed)
        rec["replay"] = rep
    want = {n: (2 * micro * run if n == "scatter_add_" else 0)
            for n in counts}
    want["walk_chain"] = run
    want["walk_band"] = walk_band_launches(solver, run)
    if counts != want:
        problems.append("kernel launches %r, want %r" % (counts, want))
    if not rec["losses_finite"]:
        problems.append("losses not finite")
    return rec, problems


# ---------------------------------------------------------------------------
# phase 6: the edge route
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
                    falling, sampler_cache=None):
    """LINE at the line_flickr.yaml shape: 5 warm-up batches (sampler
    build, first launches), then the measured call with the launch counts
    set to 0 just before it and read just after. `sampler_cache`: an
    earlier run's samplers on the same graph (the sorted stream's host
    build is most of a warm-up). Returns the solver, the record and a
    list of problems."""
    import torch
    from graphvite_tpu_torch.solver import GraphSolver

    solver = GraphSolver(dim=DIM, float_type=float_type)
    solver.build(graph, optimizer=optimizer, num_negative=1,
                 batch_size=100000, episode_size=1000)
    if sampler_cache is not None:
        solver._sampler_cache = sampler_cache
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


def replay_edge_batch(solver, seed, sorted_heads=True):
    """Capture one batch as the solver's runner makes it (its sorted edge
    stream, or with `sorted_heads` False the walk pairs the step sorts
    itself; pool draws of the shape its step takes, its negative sampler)
    and run it through the solver's pool step on the card (in place on the
    solver's state, whose run is over) and on the CPU from a copy of the
    same tables and moments.

    Tolerances: those of replay_batch (float32 rtol 3e-4, atol 3e-6, the
    CPU tests' tolerance against the reference; bfloat16 tables that plus
    1 bf16 ulp; loss rtol 2e-5); moments are float32. The captured heads
    must ascend where the stream sorts them (the sorted entries'
    contract), and in float32 every live head's vertex row must move.
    Returns the record, the batch's ids and a list of problems."""
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
    uh = (heads if mask is None else heads[mask > 0]).unique()
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
    if sorted_heads and not ascending:
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
# phases 7 and 8: knowledge graphs
# ---------------------------------------------------------------------------

FB15K_ENT = 14951            # prime: multiplicative maps are bijections
FB15K_SPLITS = (483_142, 50_000, 59_071)
WIKIDATA5M_ENT = 4_594_485
WIKIDATA5M_REL = 822
WIKIDATA5M_TRAIN = 20_614_279
KG_DIM, KG_BIG_DIM = 2048, 512

# config/knowledge_graph/rotate_fb15k.yaml
ADAM_FB15K = {"type": "Adam", "lr": 2.0e-4, "weight_decay": 0}
BUILD_FB15K = dict(num_negative=64, batch_size=100000, episode_size=1)
ROTATE_FB15K = dict(model="RotatE", margin=24, adversarial_temperature=2,
                    log_frequency=10**9)
# config/knowledge_graph/rotate_wikidata5m.yaml
SGD_WIKIDATA5M = {"type": "SGD", "lr": 0.01, "weight_decay": 0}
BUILD_WIKIDATA5M = dict(num_negative=64, batch_size=100000, episode_size=200)
ROTATE_WIKIDATA5M = dict(model="RotatE", margin=6,
                         adversarial_temperature=0.2,
                         relation_lr_multiplier=1.0, log_frequency=10**9)
# not the config's optimizer: kernel 2's path on the same graph. The
# closed-form c-touch update moves a hub row by ~6 lr c per batch (c = 33
# touches per positive, hundreds of positives per hub), so lr stays small.
ADAM_WIKIDATA5M = {"type": "Adam", "lr": 1e-6, "weight_decay": 0}


def fb15k_clone(seed):
    """A graph of FB15k's published size (14,951 entities, 1,345 relations,
    483,142 / 50,000 / 59,071 train / valid / test triplets): this
    script's copy of the generator of tools/fb15k_clone.py. Relations are
    deterministic maps mod the prime 14,951 ("+c"/"-c" inverse pairs and
    odd multipliers), so every (h, r) has one true tail; entities and
    relations are drawn with Zipf-skewed propensities, deduplicated.
    Returns {split: [(head, relation, tail) names]}."""
    rng = np.random.default_rng(seed)
    names, adds, muls = [], [], []
    for c in range(1, 501):
        names.append("+%d" % c), adds.append(c), muls.append(0)
    for c in range(1, 501):
        names.append("-%d" % c), adds.append(-c), muls.append(0)
    a = 3
    while len(names) < 1345:
        names.append("*%d" % a), adds.append(0), muls.append(a)
        a += 2
    adds, muls = np.array(adds, np.int64), np.array(muls, np.int64)
    ent_p = (rng.permutation(FB15K_ENT) + 10.0) ** -0.8
    ent_p /= ent_p.sum()
    rel_p = (rng.permutation(len(names)) + 3.0) ** -0.9
    rel_p /= rel_p.sum()
    need = sum(FB15K_SPLITS)
    draw = int(need * 2.2)
    h = rng.choice(FB15K_ENT, draw, p=ent_p)
    r = rng.choice(len(names), draw, p=rel_p)
    _, first = np.unique(h * np.int64(len(names)) + r, return_index=True)
    first = rng.permutation(first)
    if first.size < need:
        raise AssertionError("only %d distinct (h, r) pairs" % first.size)
    h, r = h[first[:need]], r[first[:need]]
    t = np.where(muls[r] > 0, (h * muls[r]) % FB15K_ENT,
                 (h + adds[r]) % FB15K_ENT)
    out, lo = {}, 0
    for split, n in zip(("train", "valid", "test"), FB15K_SPLITS):
        sl = slice(lo, lo + n)
        out[split] = [(str(a), names[b], str(c))
                      for a, b, c in zip(h[sl].tolist(), r[sl].tolist(),
                                         t[sl].tolist())]
        lo += n
    return out


def fill_power_law_kg(kg, num_entity, num_relation, num_triplet, seed):
    """Fill a KnowledgeGraph with `num_triplet` anonymous triplets over
    power-law entities (the skew of power_law_graph) and Zipf-skewed
    relations, straight into its arrays: 41M names would take minutes to
    factorize, and the solver reads only the arrays."""
    rng = np.random.default_rng(seed)
    kg.clear()
    kg.num_vertex, kg.num_relation = num_entity, num_relation
    kg.num_edge = num_triplet
    kg.id2entity = kg.entity2id = kg.id2relation = kg.relation2id = None
    kg.edge_heads = (rng.random(num_triplet) ** 2.5
                     * num_entity).astype(np.int64)
    kg.edge_tails = (rng.random(num_triplet) ** 2.5
                     * num_entity).astype(np.int64)
    rel_p = (np.arange(num_relation) + 3.0) ** -0.9
    kg.edge_relations = rng.choice(num_relation, num_triplet,
                                   p=rel_p / rel_p.sum()).astype(np.int64)
    kg.edge_weights = np.ones(num_triplet, dtype=np.float32)
    return kg


def train_kg_path(app, train_kw, batches, per_batch, want_plan, falling):
    """Two warm-up batches (sampler build, first launches), then the
    measured call of KnowledgeGraphSolver.train with the launch counts set
    to 0 just before it and read just after. `want_plan` = (effective
    batch, micro batch, micro steps, G, M). Returns the record and a list
    of problems."""
    import torch
    from graphvite_tpu_torch.ops import rotate_pool

    solver, graph = app.solver, app.graph
    t0 = time.perf_counter()
    app.train(num_epoch=2 * solver.batch_size / graph.num_edge, **train_kw)
    warm_s = time.perf_counter() - t0
    eff = solver.effective_batch
    torch.cuda.reset_peak_memory_stats()

    reset_launches()
    pool_sums = rotate_pool.pool_sums
    pool_before = pool_sums.launches
    t0 = time.perf_counter()
    app.train(num_epoch=batches * eff / graph.num_edge + 1e-9, **train_kw)
    elapsed = time.perf_counter() - t0      # train() ends synchronized
    counts = read_launches()
    pool_launches = pool_sums.launches - pool_before
    peak_mem_gb = torch.cuda.max_memory_allocated() / 1e9
    run = solver.batch_id
    losses = solver.batch_losses.double()
    k = max(run // 10, 5)
    # min and max say whether a table is finite (NaN propagates) without a
    # float32 copy of a table that may be a tenth of the card's memory
    extremes = [float(x) for t in solver.state["tables"]
                for x in t.aminmax()]
    tables_finite = all(np.isfinite(x) for x in extremes)
    moment_rows = [int((m != 0).any(dim=1).sum())
                   for group in solver.state["moments"] for m in group]
    step = solver._active_step_fn
    base = getattr(step, "base", step)
    plan = solver._batch_plan() + tuple(base.pool_shape)
    rec = {"float_type": str(solver.float_type).replace("torch.", ""),
           "optimizer": solver.optimizer.type, "batches": run,
           "plan": list(plan), "pooled": solver._pooled_step,
           "fast_body": base.fast_rotate, "warmup_s": warm_s,
           "elapsed_s": elapsed, "ms_per_batch": elapsed / run * 1e3,
           "triplets_per_s": run * eff / elapsed, "launches": counts,
           "rotate_pool_launches": pool_launches,
           "loss_first": float(losses[:k].mean()),
           "loss_last": float(losses[-k:].mean()),
           "losses_finite": bool(torch.isfinite(losses).all()),
           "tables_finite": tables_finite,
           "max_abs_table": max(abs(x) for x in extremes),
           "nonzero_moment_rows": moment_rows, "peak_mem_gb": peak_mem_gb}
    problems = []
    if plan != tuple(want_plan) or not rec["pooled"] or not rec["fast_body"]:
        problems.append("plan %r pooled %r fast %r (want %r, pooled, the "
                        "RotatE body)" % (plan, rec["pooled"],
                                          rec["fast_body"], want_plan))
    want = {name: per_batch.get(name, 0) * run for name in counts}
    if counts != want:
        problems.append("kernel launches %r, want %r" % (counts, want))
    # the RotatE body: its two kernels once per micro-step
    if pool_launches != 2 * plan[2] * run:
        problems.append("rotate_pool launches %d, want %d"
                        % (pool_launches, 2 * plan[2] * run))
    if not rec["losses_finite"] or not tables_finite:
        problems.append("losses or tables not finite")
    if falling and not rec["loss_last"] < rec["loss_first"]:
        problems.append("losses not falling")
    if solver.optimizer.num_moment and not all(moment_rows):
        problems.append("a moment table did not move: %r" % moment_rows)
    return rec, problems


def replay_kg_batch(solver, seed, compact):
    """Capture one micro-batch as the solver's runner makes it (its own
    triplet sampler; candidate ids of the shape its step takes) and run it
    through the solver's step on the card (on the solver's state, whose
    run is over) and on the CPU from a copy of the same rows, with the
    same candidate ids. `compact`: the CPU copy holds only the entity rows
    the batch touches, renumbered (the step reads and writes no other
    row); else the whole tables. Tolerances: those of replay_batch
    (float32 rtol 3e-4, atol 3e-6; bfloat16 tables that plus 1 bf16 ulp;
    loss rtol 2e-5); moments are float32. Returns the record, the batch's
    ids and a list of problems."""
    import torch

    dev = solver.device
    step = solver._active_step_fn
    step = getattr(step, "base", step)
    micro = solver._batch_plan()[1]
    gen = torch.Generator(device=dev).manual_seed(seed)
    heads, tails, rels, mask = solver._active_sample_fn(
        *solver._active_sampler.arrays(), generator=gen)
    heads, tails, rels, mask = (x[:micro] for x in (heads, tails, rels, mask))
    G, M = step.pool_shape
    state = solver.state
    entity, relation = state["tables"]
    cand = torch.randint(0, entity.shape[0], (G, M), generator=gen,
                         device=dev)
    lr = solver.optimizer.schedule_lr(0, solver.num_batch)
    ent_ids = torch.cat([heads.long(), tails.long(), cand.reshape(-1)])
    if compact:
        rows, inv = torch.unique(ent_ids, return_inverse=True)
        b = heads.numel()
        c_heads, c_tails, c_cand = (inv[:b].cpu(), inv[b:2 * b].cpu(),
                                    inv[2 * b:].reshape(G, M).cpu())
    else:
        rows = torch.arange(entity.shape[0], device=dev)
        c_heads, c_tails, c_cand = heads.cpu(), tails.cpu(), cand.cpu()
    cpu_state = {
        "tables": (entity[rows].cpu(), relation.to("cpu", copy=True)),
        "moments": (tuple(m[rows].cpu() for m in state["moments"][0]),
                    tuple(m.to("cpu", copy=True)
                          for m in state["moments"][1]))}
    before = entity[rows].clone()
    with torch.no_grad():
        new, loss = step(state, heads, tails, rels, lr, mask=mask,
                         negatives=cand)
        cpu_new, cpu_loss = step(cpu_state, c_heads, c_tails, rels.cpu(), lr,
                                 mask=mask.cpu(), negatives=c_cand)
    solver.state = new
    got_all = [new["tables"][0][rows], new["tables"][1]]
    got_all += [m[rows] for m in new["moments"][0]]
    got_all += list(new["moments"][1])
    want_all = list(cpu_new["tables"]) + [m for g in cpu_new["moments"]
                                          for m in g]
    ok, max_diff = True, 0.0
    for got, want in zip(got_all, want_all):
        bf16 = got.dtype == torch.bfloat16
        got, want = got.cpu().float(), want.float()
        diff = (got - want).abs()
        tol = 3e-6 + 3e-4 * want.abs()
        if bf16:
            tol = tol + bf16_ulp(torch.maximum(got.abs(), want.abs()))
        ok = ok and bool((diff <= tol).all())
        max_diff = max(max_diff, float(diff.max()))
        del got, want, diff, tol
    moved = int((new["tables"][0][rows] != before).any(dim=1).sum())
    loss, cpu_loss = float(loss), float(cpu_loss)
    rec = {"float_type": str(entity.dtype).replace("torch.", ""),
           "optimizer": solver.optimizer.type, "batch": int(heads.numel()),
           "pool_shape": [G, M], "entity_ids": int(ent_ids.numel()),
           "entity_rows": int(torch.unique(ent_ids).numel()),
           "compact_cpu_copy": compact, "loss": loss, "cpu_loss": cpu_loss,
           "max_abs_diff": max_diff,
           "tolerance": "rtol 3e-4, atol 3e-6 (+ 1 bf16 ulp on bf16 tables)",
           "entity_rows_moved": moved}
    del cpu_state, cpu_new, before, got_all, want_all
    problems = []
    if not ok:
        problems.append("card and CPU disagree on a batch: %r" % rec)
    if abs(loss - cpu_loss) > 2e-5 * abs(cpu_loss):
        problems.append("card loss %r vs CPU loss %r" % (loss, cpu_loss))
    if moved == 0:
        problems.append("no entity row moved: %r" % rec)
    return rec, {"entity": ent_ids, "relation": rels.long()}, problems


def kg_ranking(app, data, triplets, cpu_check):
    """Filtered ranking through the application on the card (the first
    `triplets` test triplets, both sides, filtered by every split), and
    ops-level: filtered_rankings on the card equal to the CPU's on the
    first `cpu_check` of them."""
    from graphvite_tpu_torch.application import evaluate as ev

    test = data["test"][:triplets]
    known = data["train"] + data["valid"] + data["test"]
    fH, fR, fT = (list(x) for x in zip(*known))
    H, R, T = (list(x) for x in zip(*test))
    t0 = time.perf_counter()
    metrics = app.evaluate("link prediction", H=H, R=R, T=T, filter_H=fH,
                           filter_R=fR, filter_T=fT, target="both")
    elapsed = time.perf_counter() - t0
    g = app.graph
    e2i, r2i = g.entity2id, g.relation2id
    ex_h, ex_t = {}, {}
    for h, r, t in known:
        if h in e2i and t in e2i and r in r2i:
            h, r, t = e2i[h], r2i[r], e2i[t]
            ex_h.setdefault((t, r), set()).add(h)
            ex_t.setdefault((h, r), set()).add(t)
    sub = [(e2i[h], r2i[r], e2i[t]) for h, r, t in test
           if h in e2i and t in e2i and r in r2i][:cpu_check]
    h, r, t = (np.array(x) for x in zip(*sub))
    s = app.solver
    entity, relation = s.state["tables"]
    hyper = app._margin_or_l3()
    on_card = ev.filtered_rankings(s.model, entity, relation, h, r, t, ex_h,
                                   ex_t, hyper)
    on_cpu = ev.filtered_rankings(s.model, entity.cpu(), relation.cpu(), h,
                                  r, t, ex_h, ex_t, hyper)
    diff = np.abs(on_card - on_cpu)
    rec = {"triplets": len(test), "sides": 2, "elapsed_s": elapsed,
           "triplets_per_s": len(test) / elapsed, "metrics": metrics,
           "cpu_check_triplets": len(sub),
           "ranks_compared": int(diff.size),
           "ranks_equal": int((diff == 0).sum()),
           "max_rank_diff": float(diff.max())}
    problems = []
    # a rank counts `score >= truth` over 14,951 candidates whose float32
    # scores (sums of 1,024 distances, ~1e3, spacing ~1e-4) the two devices
    # add up in different orders: a candidate within an ulp of the truth
    # flips. So: at most 2 apart, and 9 in 10 equal.
    if rec["max_rank_diff"] > 2 or rec["ranks_equal"] < 0.9 * diff.size:
        problems.append("filtered ranks differ between card and CPU: %r"
                        % rec)
    if not all(np.isfinite(v) for v in metrics.values()):
        problems.append("ranking metrics not finite: %r" % metrics)
    return rec, problems


def _touched(ids, v):
    """(unique in-range ids, each entry's index among them; dropped ids get
    the out-of-range index len(unique))."""
    import torch

    ok = (ids >= 0) & (ids < v)
    rows = torch.unique(ids[ok])
    inv = torch.searchsorted(rows, ids.clamp(0, v - 1))
    return rows, torch.where(ok, inv, torch.full_like(inv, rows.numel()))


def check_add_rows(name, ids, v, w, dtype, gen):
    """Kernel 1's unsorted entry on the ids a KG path drew, at its table's
    shape [v, w]. The table may be most of the card's memory, so the plain
    version runs on a copy of the touched rows, renumbered, and is held
    against the same rows of the kernel's table; two launches on the same
    inputs must give the same bits."""
    import torch
    from graphvite_tpu_torch.ops import scatter

    dev = torch.device("cuda")
    n = ids.numel()
    upd = torch.randn((n, w), generator=gen, device=dev) * 1e-2
    table = torch.empty((v, w), device=dev).normal_(
        generator=gen).mul_(0.1).to(dtype)
    rows, inv = _touched(ids, v)
    before = table[rows].clone()
    want = scatter.scatter_add_plain(before.clone(), inv, upd).float()
    mag = scatter.scatter_add_plain(before.float().abs(), inv, upd.abs())
    scatter.scatter_add_(table, ids, upd)
    got = table[rows].float()
    table[rows] = before
    scatter.scatter_add_(table, ids, upd)
    torch.cuda.synchronize()
    if not torch.equal(got, table[rows].float()):
        raise AssertionError("two launches of scatter_add_ on the same "
                             "inputs differ (%s)" % name)
    diff = (got - want).abs()
    max_err = float(diff.max())
    if dtype == torch.float32:
        ok = bool((diff <= 1e-6 * mag).all())
        tol = "|err| <= 1e-6 * (|table| + sum|upd|)"
    else:
        ok = bool((diff <= bf16_ulp(want) + 1e-6 * mag).all())
        tol = "|err| <= 1 bf16 ulp + 1e-6 * (|table| + sum|upd|)"
    if not ok:
        raise AssertionError("scatter_add_ disagrees with its plain version "
                             "at %s %s: max |err| %g" % (name, dtype, max_err))
    del before, want, mag, got, diff
    ms = cuda_ms(lambda: scatter.scatter_add_(table, ids, upd))
    sid, order = torch.sort(ids.to(torch.int32), stable=True)
    order = order.to(torch.int32)
    kernel_only_ms = cuda_ms(lambda: scatter._launch_add(
        table, sid, upd, sort=False, order=order))
    plain_ms = cuda_ms(lambda: scatter.scatter_add_plain(table, ids, upd),
                       reps=5, warmup=1)
    # index_add_ takes no out-of-range id: the yardstick adds the entries
    # the kernel keeps (the mesh engines' dropped slots carry id V), and
    # the bound counts the same work: every entry's id, the kept entries'
    # update rows and adds, each touched row read and written once
    keep = (ids >= 0) & (ids < v)
    upd_t = upd[keep].to(dtype)
    ids64 = ids[keep].long()
    library_ms = cuda_ms(lambda: table.index_add_(0, ids64, upd_t))
    uniq, kept = int(rows.numel()), int(ids64.numel())
    bound_ms, bound_by = bytes_bound(
        kept * w * 4 + 2 * uniq * w * table.element_size() + 4 * n,
        kept * w)
    del table
    return {"entry": "scatter_add_", "case": name, "n": n, "width": w,
            "table_rows": v, "dtype": str(dtype).replace("torch.", ""),
            "tile_rows": scatter.tile_rows(n, w), "unique_rows": uniq,
            "kept": kept, "max_abs_err": max_err, "tolerance": tol, "ms": ms,
            "kernel_only_ms": kernel_only_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def check_update_rows(name, ids, counts, v, d, dtype, gen):
    """Kernel 2's unsorted entry (Adam) on the ids a KG path drew, with its
    touch counts and random squares, at its table's shape [v, d] (the
    table and two float32 moment tables). The plain version runs on a copy
    of the touched rows, renumbered, as in check_add_rows."""
    import torch
    from graphvite_tpu_torch.ops import scatter
    from graphvite_tpu_torch.optim import Optimizer

    dev = torch.device("cuda")
    n = ids.numel()
    opt = Optimizer(type="Adam", lr=1e-3, weight_decay=0.0)
    grads = torch.randn((n, d), generator=gen, device=dev) * 1e-2
    sqs = grads * grads * (1.0 + torch.rand((n, d), generator=gen,
                                            device=dev))
    table = torch.empty((v, d), device=dev).normal_(
        generator=gen).mul_(0.1).to(dtype)
    moms = tuple(torch.empty((v, d), device=dev).uniform_(
        generator=gen).mul_(1e-4) for _ in range(2))
    rows, inv = _touched(ids, v)
    before = [t[rows].clone() for t in (table,) + moms]
    kw = dict(entry_counts=counts, entry_sqs=sqs)
    want_t, want_m = scatter.scatter_update_plain(
        before[0].clone(), tuple(m.clone() for m in before[1:]), inv, grads,
        opt, 1e-3, counts, sqs)
    scatter.scatter_update_(table, moms, ids, grads, opt, 1e-3, **kw)
    got = [t[rows].clone() for t in (table,) + moms]
    for t, b in zip((table,) + moms, before):
        t[rows] = b
    scatter.scatter_update_(table, moms, ids, grads, opt, 1e-3, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(a, t[rows]) for a, t in zip(got, (table,) + moms)):
        raise AssertionError("two launches of scatter_update_ on the same "
                             "inputs differ (%s)" % name)
    max_err = 0.0
    for i, (a, b) in enumerate(zip(got, (want_t,) + want_m)):
        a, b = a.float(), b.float()
        diff = (a - b).abs()
        tol = 2e-5 + 2e-5 * b.abs()
        if dtype == torch.bfloat16 and i == 0:
            # one ulp of the result and one of the row's old value: the
            # plain version rounds the delta to bf16 before it subtracts,
            # the kernel rounds the result once
            tol = tol + bf16_ulp(b) + bf16_ulp(before[0].float())
        max_err = max(max_err, float(diff.max()))
        if not bool((diff <= tol).all()):
            raise AssertionError("scatter_update_ disagrees with its plain "
                                 "version at %s: max |err| %g"
                                 % (name, float(diff.max())))
    del before, want_t, want_m, got
    ms = cuda_ms(lambda: scatter.scatter_update_(table, moms, ids, grads, opt,
                                                 1e-3, **kw))
    sid, order = torch.sort(ids.to(torch.int32), stable=True)
    order = order.to(torch.int32)
    kernel_only_ms = cuda_ms(lambda: scatter._launch_update(
        table, moms, sid, grads, opt, 1e-3, counts, sqs, 1.0, sort=False,
        order=order))
    plain_ms = cuda_ms(lambda: scatter.scatter_update_plain(
        table, moms, ids, grads, opt, 1e-3, counts, sqs), reps=3, warmup=1)
    # the bound counts every entry's id and the kept (in-range) entries'
    # counts, gradients and squares (the mesh engines' dropped slots carry
    # id V), each touched row of the table and its moments read and
    # written once
    uniq = int(rows.numel())
    kept = int(((ids >= 0) & (ids < v)).sum())
    s = table.element_size()
    bound_ms, bound_by = bytes_bound(
        kept * d * 8 + 4 * n + 4 * kept + 2 * uniq * d * (s + 8),
        kept * d * 3 + uniq * d * 20)
    del table, moms
    return {"entry": "scatter_update_", "case": name, "n": n, "width": d,
            "table_rows": v, "sorted": False,
            "tile_rows": scatter.tile_rows(n, d), "optimizer": "Adam",
            "dtype": str(dtype).replace("torch.", ""), "unique_rows": uniq,
            "kept": kept,
            "max_abs_err": max_err,
            "tolerance": "|err| <= 2e-5 + 2e-5 |want| (+ 1 bf16 ulp of the "
            "result and 1 of the old row)",
            "ms": ms, "kernel_only_ms": kernel_only_ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}


# ---------------------------------------------------------------------------
# phase 16: each kernel against its plain version
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
    # a trace of a window this short (20 sorted calls are ~1 ms) may hold
    # few of its calls, or none: trace longer windows until one holds some
    for attempt in range(4):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            for _ in range(calls << (2 * attempt)):
                call()
            torch.cuda.synchronize()
        launches, seen, sort_us, kernel_us, other = 0, 0, 0.0, 0.0, []
        for ev in prof.key_averages():
            if (ev.device_type != DeviceType.CUDA
                    or not ev.self_device_time_total
                    or ev.key.startswith(SPANS)):
                continue
            launches += ev.count
            if "scatter_add_" in ev.key or "scatter_update_" in ev.key:
                kernel_us += ev.self_device_time_total
                if "_tiles" in ev.key:
                    seen += ev.count     # one first-pass launch per call
            elif "sort" in ev.key.lower() or "Memset" in ev.key:
                # the key kernel, the radix sort's passes, its counters' fill
                sort_us += ev.self_device_time_total
            else:
                other.append(ev.key[:60])
        if seen:
            break
    else:
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
# phases 9 and 10 (vis, vis_big): LargeVis
# ---------------------------------------------------------------------------

MNIST_N, MNIST_DIMS, MNIST_CLASSES = 70_000, 784, 10
IMAGENET_N, IMAGENET_DIMS, IMAGENET_CLASSES = 1_331_167, 2048, 1000
# config/visualization/largevis_mnist_2d.yaml and largevis_imagenet.yaml
ADAM_VIS = {"type": "Adam", "lr": 0.5, "weight_decay": 1e-5}
BUILD_VIS = dict(num_negative=5, batch_size=100000, episode_size=200)
LARGEVIS = dict(model="LargeVis", negative_weight=3, log_frequency=10**9)
# not the configs' optimizer: kernel 1's path (the trust clip's
# accumulate at 8 columns); the clip bounds a row's step, so the
# config's lr is stable
SGD_VIS = {"type": "SGD", "lr": 0.5, "weight_decay": 1e-5}
VIS_PLAN = (99840, 64, 256)           # batch, pool groups, pool size
VIS_BIG_BATCHES = 200


def mnist_clone(seed):
    """The statistics-matched MNIST clone of tools/largevis_mnist.py: 70,000
    x 784, 10 Gaussian classes in a 40-dim latent subspace projected up,
    plus pixel-scale noise."""
    rng = np.random.default_rng(seed)
    latent = 40
    means = rng.normal(size=(MNIST_CLASSES, latent)) * 4.0
    proj = rng.normal(size=(latent, MNIST_DIMS)) / np.sqrt(latent)
    labels = rng.integers(0, MNIST_CLASSES, MNIST_N)
    z = means[labels] + rng.normal(size=(MNIST_N, latent))
    x = z @ proj + rng.normal(size=(MNIST_N, MNIST_DIMS)) * 0.3
    return x.astype(np.float32), labels


def imagenet_clone(n, seed, device="cuda"):
    """The statistics of tools/largevis_imagenet.py's clone, drawn on the
    card from a seeded generator: 1000 Gaussian classes in a 256-dim
    latent subspace projected to 2048, feature-scale noise, ReLU'd like
    penultimate ResNet activations. Returns (x [n, 2048] float32 on the
    card, labels [n] on the host)."""
    import torch

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    latent = 256
    means = torch.randn((IMAGENET_CLASSES, latent), generator=gen,
                        device=dev) * 3.0
    proj = torch.randn((latent, IMAGENET_DIMS), generator=gen,
                       device=dev) / latent ** 0.5
    labels = torch.randint(0, IMAGENET_CLASSES, (n,), generator=gen,
                           device=dev)
    x = torch.empty((n, IMAGENET_DIMS), device=dev)
    chunk = 65536
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        z = means[labels[lo:hi]] + torch.randn((hi - lo, latent),
                                               generator=gen, device=dev)
        f = z @ proj
        f += torch.randn(f.shape, generator=gen, device=dev) * 0.3
        x[lo:hi] = f.clamp_(min=0.0)
    return x, labels.cpu().numpy()


def layout_agreement(coords, labels, seed=1, sample=4000):
    """The tools' quality probe: 10-NN label agreement of the 2-D layout on
    a 4,000-point subsample."""
    sub = np.random.default_rng(seed).choice(len(coords), sample,
                                             replace=False)
    c = np.asarray(coords, np.float64)[sub]
    d2 = ((c[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    nn = np.argsort(d2, axis=1)[:, :10]
    return float((labels[sub][nn] == labels[sub][:, None]).mean())


def build_knn(app, vectors, **kw):
    """KNNGraph through the application's load; checks the graph. Returns
    (record, problems)."""
    import torch

    t0 = time.perf_counter()
    app.load(vectors=vectors, **kw)
    secs = time.perf_counter() - t0
    g = app.graph
    n, k = g.num_vertex, g.num_neighbor
    rec = {"vertices": n, "neighbors": k, "edges": g.num_edge,
           "build_s": secs, "stages_s": dict(g.build_seconds),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    problems = []
    if g.num_edge != n * k:
        problems.append("%d edges, want %d" % (g.num_edge, n * k))
    if not bool((g.edge_heads != g.edge_tails).all()):
        problems.append("self edges in the KNN graph")
    w = g.edge_weights
    if not bool(torch.isfinite(w).all()) or not bool((w >= 0).all()):
        problems.append("KNN weights not finite and nonnegative")
    if not g.edge_heads.is_cuda:
        problems.append("the KNN graph's edges left the card")
    return rec, problems


def train_vis(graph, optimizer, float_type, batches, labels=None,
              falling=True, launches_per_batch=None):
    """A LargeVis run through VisualizationApplication.build/train on a
    built KNN graph: the alias-weighted edge sampler is built first (its
    seconds stand alone), then the measured call, with the kernels'
    launch counts set to 0 just before it and read just after (`batches`
    None: the config's 50 epochs). Returns the application, the record and
    a list of problems."""
    import torch
    from graphvite_tpu_torch import VisualizationApplication
    from graphvite_tpu_torch.ops.device_sampler import DeviceEdgeSampler

    app = VisualizationApplication(dim=2, float_type=float_type)
    app.graph = graph
    app.build(optimizer=optimizer, **BUILD_VIS)
    solver = app.solver
    t0 = time.perf_counter()
    solver._get_sampler(("edge", str(solver.device)),
                        lambda: DeviceEdgeSampler.build(graph,
                                                        device=solver.device))
    torch.cuda.synchronize()
    sampler_s = time.perf_counter() - t0
    epochs = 50 if batches is None else (batches * VIS_PLAN[0]
                                         / graph.num_edge + 1e-9)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    app.train(num_epoch=epochs, **LARGEVIS)
    elapsed = time.perf_counter() - t0         # train() ends synchronized
    counts = read_launches()
    run = solver.batch_id
    eff = solver.effective_batch
    losses = solver.batch_losses.double()
    k = max(run // 10, 5)
    table = solver.state["tables"][0]
    rec = {"optimizer": optimizer["type"], "float_type": float_type,
           "batches": run, "effective_batch": eff,
           "pool_shape": list(solver._active_step_fn.pool_shape),
           "sampler_build_s": sampler_s, "elapsed_s": elapsed,
           "ms_per_batch": elapsed / run * 1e3,
           "samples_per_s": run * eff / elapsed, "launches": counts,
           "loss_first": float(losses[:k].mean()),
           "loss_last": float(losses[-k:].mean()),
           "losses_finite": bool(torch.isfinite(losses).all()),
           "pad_columns_zero": bool((table[:, 2:] == 0).all()),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    if labels is not None:
        rec["agreement_10nn"] = layout_agreement(solver.coordinates, labels)
    problems = []
    if [eff] + rec["pool_shape"] != list(VIS_PLAN):
        problems.append("batch plan %d, pool %r (want %r)"
                        % (eff, rec["pool_shape"], VIS_PLAN))
    want = {name: (launches_per_batch or {}).get(name, 0) * run
            for name in counts}
    if counts != want:
        problems.append("kernel launches %r, want %r" % (counts, want))
    if not rec["losses_finite"] or not bool(torch.isfinite(
            table.float()).all()):
        problems.append("losses or coordinates not finite")
    if falling and not rec["loss_last"] < rec["loss_first"]:
        problems.append("losses not falling")
    if not rec["pad_columns_zero"]:
        problems.append("the pad columns moved")
    return app, rec, problems


def replay_vis_batch(solver, seed):
    """Capture one batch as the solver's runner makes it (its alias-weighted
    edge sampler, pool draws of its step's shape, its negative sampler)
    and run it through the pool step on the card (in place on the
    solver's state) and on the CPU from a copy of the whole table and
    moments.

    Tolerance: |err| <= 1e-7 + 1e-5 x the row's largest magnitude (+ 1
    bf16 ulp on bf16 tables); moments the same. (The step's cancelling
    products run in float64, so the order of the sums does not move the
    result.) Returns the record, the batch's update ids and counts, and a
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
    state = solver.state
    old = state["tables"][0].to("cpu", torch.float32, copy=True)

    cpu_state = {"tables": (state["tables"][0].to("cpu", copy=True),),
                 "moments": (tuple(m.to("cpu", copy=True)
                                   for m in state["moments"][0]),)}
    with torch.no_grad():
        cpu_new, cpu_loss = step(cpu_state, heads.cpu(), tails.cpu(), lr,
                                 *(t.cpu() for t in neg), mask=mask.cpu(),
                                 draws=tuple(d.cpu() for d in draws))
        new, loss = step(state, heads, tails, lr, *neg, mask=mask,
                         draws=draws)
    solver.state = new

    got = new["tables"][0].float().cpu()
    want = cpu_new["tables"][0].float()
    scale = torch.maximum(want.abs(), old.abs()).amax(dim=1, keepdim=True)
    diff = (got - want).abs()
    tol = 1e-7 + 1e-5 * scale
    if new["tables"][0].dtype == torch.bfloat16:
        tol = tol + bf16_ulp(want)
    ok = bool((diff <= tol).all())
    mom_diff = 0.0
    for a, b in zip(new["moments"][0], cpu_new["moments"][0]):
        d = (a.cpu() - b).abs()
        ok = ok and bool((d <= 1e-7 + 1e-5 * b.abs().amax(
            dim=1, keepdim=True)).all())
        mom_diff = max(mom_diff, float(d.max()))
    moved = int((got != old).any(dim=1).sum())
    loss, cpu_loss = float(loss), float(cpu_loss)
    rec = {"optimizer": solver.optimizer.type,
           "float_type": str(new["tables"][0].dtype).replace("torch.", ""),
           "table": list(got.shape), "loss": loss, "cpu_loss": cpu_loss,
           "max_abs_diff": float(diff.max()),
           "max_rel_diff": float((diff / scale.clamp(min=1e-30)).max()),
           "max_abs_table": float(scale.max()),
           "max_moment_diff": mom_diff, "rows_moved": moved,
           "tolerance": "1e-7 + 1e-5 x the row's largest magnitude (+ 1 "
                        "bf16 ulp on bf16 tables); moments the same"}
    problems = []
    if not ok:
        problems.append("card and CPU disagree on a batch: %r" % rec)
    if abs(loss - cpu_loss) > 1e-5 * abs(cpu_loss):
        problems.append("card loss %r vs CPU loss %r" % (loss, cpu_loss))
    if moved == 0:
        problems.append("no row moved")
    pool = device_sample(*neg, *draws).reshape(-1)
    b, k = heads.numel(), solver.num_negative
    ids = torch.cat([heads.long(), tails.long(), pool])
    counts = torch.cat([torch.full((b,), k + 1.0, device=dev),
                        torch.ones(b, device=dev),
                        torch.full((G * M,), b // G * k / M, device=dev)])
    return rec, {"ids": ids, "counts": counts}, problems


def vis_phase(seed, shared=None):
    """LargeVis at the largevis_mnist_2d.yaml shape, full depth. The KNN
    graph and the labels are left in `shared` for the mesh phase."""
    import torch
    from graphvite_tpu_torch import VisualizationApplication

    out, problems = {}, []
    t0 = time.perf_counter()
    x, labels = mnist_clone(seed)
    log("   MNIST clone %r made in %.1f s" % (x.shape,
                                              time.perf_counter() - t0))
    app = VisualizationApplication(dim=2)
    torch.cuda.reset_peak_memory_stats()
    rec, bad = build_knn(app, x, num_neighbor=200, perplexity=20)
    log("   KNN graph (exact):", json.dumps(rec))
    out["knn"] = rec
    problems += ["knn: " + p for p in bad]
    if rec["edges"] != 14_000_000:
        problems.append("knn: %d edges, want 14,000,000" % rec["edges"])
    runs = (("adam", ADAM_VIS, "float32", None, {}),
            ("sgd", SGD_VIS, "float32", 500, {"scatter_add_": 1}),
            ("adam_bf16", ADAM_VIS, "bfloat16", 200, {}))
    graph = app.graph
    del app
    for name, opt, ft, batches, per_batch in runs:
        app, rec, bad = train_vis(graph, opt, ft, batches,
                                  labels=labels if name == "adam" else None,
                                  launches_per_batch=per_batch)
        log("   %s:" % name, json.dumps(rec))
        out[name] = rec
        problems += ["%s: %s" % (name, p) for p in bad]
        if name == "adam" and not rec["agreement_10nn"] >= 0.95:
            problems.append("10-NN label agreement %.4f < 0.95"
                            % rec["agreement_10nn"])
        if name in ("adam", "sgd"):
            # a batch from the state the run ended in
            rep, ids, bad = replay_vis_batch(app.solver, seed + 1)
            log("   %s batch, card vs CPU:" % name, json.dumps(rep))
            out["replay_" + name] = rep
            problems += ["%s replay: %s" % (name, p) for p in bad]
            if name == "sgd":
                out["ids"] = ids
        if name == "adam":
            out["trace"] = trace_episode(app.solver, LARGEVIS, batches=20)
            log("   trace:", json.dumps(out["trace"]))
        del app
    if shared is not None:
        shared["mnist"] = (graph, labels)
    del graph
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("; ".join(problems))
    return out


def vis_big_phase(seed):
    """LargeVis at the largevis_imagenet.yaml shape: the IVF route."""
    import torch
    from graphvite_tpu_torch import VisualizationApplication, knn

    out, problems = {}, []
    t0 = time.perf_counter()
    x, _ = imagenet_clone(IMAGENET_N, seed)
    torch.cuda.synchronize()
    log("   ImageNet clone %r made on the card in %.1f s"
        % (tuple(x.shape), time.perf_counter() - t0))
    app = VisualizationApplication(dim=2)
    torch.cuda.reset_peak_memory_stats()
    rec, bad = build_knn(app, x, num_neighbor=200, perplexity=50)
    g = app.graph
    problems += ["knn: " + p for p in bad]
    if "queries" not in rec["stages_s"]:
        problems.append("the IVF route was not taken")
    t0 = time.perf_counter()
    nbrs = g.edge_tails.view(g.num_vertex, g.num_neighbor)
    rec["recall_at_200"] = knn.knn_recall(x, nbrs, nq=512, seed=seed)
    rec["recall_s"] = time.perf_counter() - t0
    # the tools' protocol scores the raw vectors; the graph was searched
    # over the normalized ones, which this one scores
    xn = g._normalize(x)
    rec["recall_at_200_normalized"] = knn.knn_recall(xn, nbrs, nq=512,
                                                     seed=seed)
    del xn
    if not rec["recall_at_200"] >= 0.75:
        problems.append("recall@200 %.4f < 0.75" % rec["recall_at_200"])
    log("   KNN graph (IVF):", json.dumps(rec))
    out["knn"] = rec
    graph = app.graph
    del app, x, nbrs
    torch.cuda.empty_cache()
    app, rec, bad = train_vis(graph, ADAM_VIS, "float32", VIS_BIG_BATCHES,
                              falling=False)
    log("   adam:", json.dumps(rec))
    out["adam"] = rec
    out["knn"]["stages_s"]["alias"] = rec["sampler_build_s"]
    problems += ["adam: " + p for p in bad]
    out["trace"] = trace_episode(app.solver, LARGEVIS, batches=10)
    log("   trace:", json.dumps(out["trace"]))
    del app, graph
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# phase 11: blocked episodes and the host master
# ---------------------------------------------------------------------------

# config/graph/line_friendster-small.yaml: friendster-small's vertex count
# (SURVEY.md: 7.9M vertices, 447M edges); the edges are cut to what keeps
# the phase's set-up near a minute
FRIENDSTER_SMALL_V = 7_944_949
BLOCKED_E = 32_000_000
BLOCKED_BATCHES = 1024
SGD_FRIENDSTER = {"type": "SGD", "lr": 0.025, "weight_decay": 5e-3}
BUILD_FRIENDSTER = dict(num_negative=1, batch_size=100000, episode_size=3500)
LINE_FRIENDSTER = dict(model="LINE", augmentation_step=1, negative_weight=5.0,
                       log_frequency=10**9)
# kernel 2's path on the shards (not the config's optimizer), with the
# edge phase's Adam settings
ADAM_BLOCKED = {"type": "Adam", "lr": 1e-6, "weight_decay": 0.0}
# what a solver caches of the blocked set-up (partition, block tables,
# alias arrays on the card): handed on to the next run on the same graph
BLOCKED_PREP = ("_blocked_key", "_blocked_part", "_blocked_tables",
                "_blocked_edges", "_blocked_neg", "_blocked_setup_s")


def train_blocked(graph, optimizer, app_kw, build_kw, env, per_batch,
                  prep=None, batches=BLOCKED_BATCHES):
    """LINE at the line_friendster-small.yaml shape through GraphApplication
    on blocked episodes, GRAPHVITE_MIN_SWEEPS=1 (episodes of 64 of the 1024
    batches): the launch counts set to 0 just before train() and read just
    after, the peak device memory from a reset just before. `prep`: an
    earlier run's blocked set-up on the same graph. Returns the
    application, the record and a list of problems."""
    import torch
    from graphvite_tpu_torch import GraphApplication

    env = dict(env, GRAPHVITE_MIN_SWEEPS="1")
    with environ(env):
        app = GraphApplication(dim=DIM, **app_kw)
        app.graph = graph
        app.build(optimizer=optimizer, **BUILD_FRIENDSTER, **build_kw)
        s = app.solver
        for name in (BLOCKED_PREP if prep else ()):
            setattr(s, name, prep[name])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_gb = torch.cuda.memory_allocated() / 1e9
        reset_launches()
        t0 = time.perf_counter()
        app.train(num_epoch=batches * s.batch_size / graph.num_edge + 1e-9,
                  **LINE_FRIENDSTER)
        elapsed = time.perf_counter() - t0     # train() ends synchronized
        counts = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    st = s.blocked_stats
    run = s.batch_id
    eps = max(st["episodes"], 1)
    losses = s.batch_losses.double()
    k = max(run // 10, 5)
    tables_finite = all(bool(torch.isfinite(t.float()).all())
                        for t in s.state["tables"])
    moment_rows = [int((m != 0).any(dim=1).sum())
                   for group in s.state["moments"] for m in group]
    rec = {"optimizer": optimizer["type"], "batches": run,
           "batch": s.batch_size, "num_partition": st["num_partition"],
           "host_master": st["host_master"],
           "master_memory": st.get("master_memory"),
           "master_gb": st.get("master_gb"), "ep_batches": st["ep_batches"],
           "episodes": st["episodes"], "hits": st["hits"],
           "misses": st["misses"], "elapsed_s": elapsed,
           "split_s": st["split_s"], "loop_s": st["loop_s"],
           "join_s": st["join_s"],
           "ms_per_batch": st["loop_s"] / run * 1e3,
           "samples_per_s": run * s.batch_size / st["loop_s"],
           "h2d_gb_per_episode": st["h2d_bytes"] / eps / 1e9,
           "h2d_s_per_episode": st["h2d_s"] / eps,
           "d2h_gb_per_episode": st["d2h_bytes"] / eps / 1e9,
           "d2h_s_per_episode": st["d2h_s"] / eps,
           "launches": counts,
           "launches_per_batch": {n: c / run for n, c in counts.items() if c},
           "loss_first": float(losses[:k].mean()),
           "loss_last": float(losses[-k:].mean()),
           "losses_finite": bool(torch.isfinite(losses).all()),
           "tables_finite": tables_finite,
           "nonzero_moment_rows": moment_rows,
           "state_device": s.state["tables"][0].device.type,
           "base_mem_gb": base_gb, "peak_mem_gb": peak_gb}
    problems = []
    want = {name: per_batch.get(name, 0) * run for name in counts}
    if counts != want:
        problems.append("kernel launches %r, want %r" % (counts, want))
    if run != batches or st["ep_batches"] != 64:
        problems.append("%d batches in episodes of %d (want %d in 64)"
                        % (run, st["ep_batches"], batches))
    if not rec["losses_finite"] or not tables_finite:
        problems.append("losses or tables not finite")
    if optimizer["type"] == "Adam" and not all(moment_rows):
        problems.append("a moment table did not move: %r" % moment_rows)
    if st["host_master"] and (rec["state_device"] != "cpu" or not
                              st["misses"] or not st["h2d_bytes"]
                              or not st["d2h_bytes"]):
        problems.append("the host master staged nothing or left its state "
                        "on the card: %r" % rec)
    return app, rec, problems


def trace_blocked_episode(app, env):
    """One more episode of a blocked run (resumed, 68 batches: the
    episode length of 1,092 batches at GRAPHVITE_MIN_SWEEPS=1) under
    torch.profiler: kernels (copies not counted) and device time per
    batch, with and without the staging copies (a resumed host-master
    run stages both shards in and out: two misses in 68 batches)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    s = app.solver
    n0 = s.batch_id
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with environ(dict(env, GRAPHVITE_MIN_SWEEPS="1")):
        with profile(activities=acts) as prof:
            app.train(num_epoch=(n0 + 68) * s.batch_size / s.graph.num_edge
                      + 1e-9, resume=True, **LINE_FRIENDSTER)
            torch.cuda.synchronize()
    run = s.batch_id - n0
    rows = [(ev.self_device_time_total, ev.count, ev.key)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total
            and not ev.key.startswith(SPANS)]
    if not rows:
        raise AssertionError("the profiler recorded no device time")
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows) / 1e3 / run
    copy_ms = sum(r[0] for r in rows if r[2].startswith("Memcpy")) / 1e3 / run
    copies = sum(r[1] for r in rows if r[2].startswith("Memcpy"))
    return {"batches": run, "episodes": s.blocked_stats["episodes"],
            "misses": s.blocked_stats["misses"],
            "device_ms_per_batch": device_ms,
            "copy_ms_per_batch": copy_ms,
            "kernels_per_batch": (sum(r[1] for r in rows) - copies) / run,
            "top": [{"kernel": name[:70], "ms_per_batch": us / 1e3 / run,
                     "calls_per_batch": c / run}
                    for us, c, name in rows[:12]]}


def blocked_batch_ids(solver, seed):
    """One batch's update ids as the blocked runner draws them, on the
    block with the most edges: the vertex shard's local heads [B] and the
    context shard's K negatives and tail per sample [B (K + 1)]."""
    import torch
    from graphvite_tpu_torch.ops.blocked import _pick_edges

    dev = solver.device
    tables = solver._blocked_tables
    P_ = solver._blocked_part.num_partition
    counts = np.diff(tables.offsets.astype(np.int64))
    blk = int(np.argmax(counts))
    j = blk % P_
    B, K = solver.batch_size, solver.num_negative
    gen = torch.Generator(device=dev).manual_seed(seed)
    idx = torch.randint(0, int(counts[blk]), (B,), generator=gen, device=dev)
    u = torch.rand((B,), generator=gen, device=dev)
    heads, tails = _pick_edges(int(tables.offsets[blk]), idx, u,
                               *solver._blocked_edges)
    nprob, nalias, nsizes = (x[j] for x in solver._blocked_neg)
    u1, u2 = (torch.rand((B, K), generator=gen, device=dev) for _ in range(2))
    nidx = torch.clamp((u1 * nsizes).long(), max=nsizes - 1)
    negs = torch.where(u2 < nprob[nidx], nidx, nalias[nidx].long())
    ctx = torch.cat([negs, tails.long()[:, None]], dim=1).reshape(-1)
    return {"vertex": heads.long(), "context": ctx,
            "rows": solver._blocked_part.capacity}


def blocked_phase(seed, shared=None):
    """Blocked episodes at the line_friendster-small.yaml shape (the graph
    is left in `shared` for the mesh phase): (a)
    num_partition=4 with the shards on the card, (b) the auto rule under a
    gpu_memory_limit below the demand (P = 4 and the host master), which
    must give (a)'s tables bit for bit inside the limit, (c) Adam with the
    host master; one episode of (b) traced; predict on (b)'s host tables
    against manual scoring."""
    import torch

    if os.environ.get("GRAPHVITE_HBM_BYTES") or os.environ.get(
            "GRAPHVITE_HOST_MASTER"):
        raise AssertionError("GRAPHVITE_HBM_BYTES and GRAPHVITE_HOST_MASTER "
                             "must be unset: the phase sets what it needs")
    t0 = time.perf_counter()
    graph = power_law_graph(FRIENDSTER_SMALL_V, BLOCKED_E, seed)
    graph_s = time.perf_counter() - t0
    log("graph: %d vertices, %d input edges, %d directed, built in %.1f s"
        % (graph.num_vertex, graph.num_edge, graph.num_directed_edge,
           graph_s))
    from graphvite_tpu_torch.utils.common import hbm_budget_bytes

    # the budget the auto rule reads on this card without a limit
    out = {"graph_s": graph_s,
           "card_budget_gb": hbm_budget_bytes(0, "cuda") / 1e9}
    log("   the card's budget for the auto rule: %.3f GB"
        % out["card_budget_gb"])
    problems = []
    torch.cuda.empty_cache()

    # (a) shards on the card
    app, rec, bad = train_blocked(graph, SGD_FRIENDSTER, {},
                                  {"num_partition": 4},
                                  {"GRAPHVITE_HOST_MASTER": "0"},
                                  {"scatter_add_": 2})
    s = app.solver
    rec["setup_s"] = dict(s.blocked_stats["setup_s"])
    log("   (a) P 4, shards on the card:", json.dumps(rec))
    out["a"] = rec
    problems += ["a: " + p for p in bad]
    if not rec["loss_last"] < rec["loss_first"]:
        problems.append("a: losses not falling")
    want = [t.cpu() for t in s.state["tables"]]
    want_losses = s.batch_losses.cpu()
    out["trace_a"] = trace_blocked_episode(app, {"GRAPHVITE_HOST_MASTER": "0"})
    log("   (a) trace of one episode:", json.dumps(out["trace_a"]))
    prep = {name: getattr(s, name) for name in BLOCKED_PREP}
    out["ids"] = blocked_batch_ids(s, seed + 1)
    del app, s
    torch.cuda.empty_cache()

    # (b) the auto rule below the demand: P = 4 and the host master
    demand = FRIENDSTER_SMALL_V * DIM * 8 + 16 * graph.num_edge
    limit = int(0.9 * demand)
    app, rec, bad = train_blocked(graph, SGD_FRIENDSTER,
                                  {"gpu_memory_limit": limit}, {}, {},
                                  {"scatter_add_": 2}, prep)
    rec["gpu_memory_limit_gb"] = limit / 1e9
    rec["demand_gb"] = demand / 1e9
    s = app.solver
    rec["equal_to_a"] = (all(torch.equal(a, b) for a, b in
                             zip(want, s.state["tables"]))
                         and torch.equal(want_losses, s.batch_losses.cpu()))
    del want
    # predict through the host-row path against manual host scoring
    rng = np.random.default_rng(seed)
    pairs = rng.integers(0, graph.num_vertex, (100000, 2))
    vertex, context = s.state["tables"]
    ph, pt = torch.from_numpy(pairs[:, 0]), torch.from_numpy(pairs[:, 1])
    manual = (vertex[ph].float() * context[pt].float()).sum(-1).numpy()
    scores = s.predict(pairs)
    rec["predict_max_abs_diff"] = float(np.abs(scores - manual).max())
    log("   (b) auto rule, host master:", json.dumps(rec))
    out["b"] = rec
    problems += ["b: " + p for p in bad]
    if (rec["num_partition"], rec["host_master"]) != (4, True):
        problems.append("b: the auto rule chose P %d, host master %s (want "
                        "4, True)" % (rec["num_partition"],
                                      rec["host_master"]))
    if not rec["equal_to_a"]:
        problems.append("b: tables or losses differ from (a)'s")
    if rec["peak_mem_gb"] * 1e9 > limit:
        problems.append("b: peak device memory %.2f GB above the limit "
                        "%.2f GB" % (rec["peak_mem_gb"], limit / 1e9))
    if not np.allclose(scores, manual, rtol=1e-4, atol=1e-4):
        problems.append("b: host-row predict differs from manual scoring "
                        "by %g" % rec["predict_max_abs_diff"])
    out["trace_b"] = trace_blocked_episode(app, {})
    log("   (b) trace of one episode:", json.dumps(out["trace_b"]))
    del app, s, vertex, context
    torch.cuda.empty_cache()

    # (c) Adam with the host master: kernel 2 on the shards
    app, rec, bad = train_blocked(graph, ADAM_BLOCKED, {},
                                  {"num_partition": 4},
                                  {"GRAPHVITE_HOST_MASTER": "1"},
                                  {"scatter_update_": 2}, prep)
    log("   (c) Adam, host master:", json.dumps(rec))
    out["c"] = rec
    problems += ["c: " + p for p in bad]
    if shared is not None:
        shared["friendster"] = graph
    del app, prep, graph
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# phase 12: the multi-device engines, W workers on one card
# ---------------------------------------------------------------------------

MESH_IDS = [0, 0]              # device_ids: two workers on cuda:0
MESH_EDGE_BATCH = 99840        # per worker: 100000 in whole units of 256
MESH_WALK_BATCH = 78720        # per worker: 192 walks of 41 x 10 slots
MESH_EDGE_RUNS = (("sgd", SGD_FRIENDSTER, 512, {"scatter_add_": 2}),
                  ("adam", ADAM_BLOCKED, 256, {"scatter_update_": 2}))
MESH_WALK_RUNS = (("sgd", "DeepWalk", SGD_YOUTUBE, 100,
                   {"scatter_add_": 1, "walk_chain": 1, "walk_band": 1}),
                  ("adam", "DeepWalk", ADAM_FLICKR, 50,
                   {"scatter_update_": 2, "walk_chain": 1}),
                  ("node2vec", "node2vec", SGD_YOUTUBE, 20,
                   {"scatter_add_": 1, "walk_band": 1}))
MESH_W1_BATCHES = 50
MESH_CHECK_BATCHES = 2         # per worker, in the sync and traced episodes
MESH_VIS_EPOCHS = 20           # of the config's 50: a depth cut
MESH_VIS_SGD_BATCHES = 200
MESH_REPLAY_W = 4


@contextlib.contextmanager
def recording_updates(calls, limit=None):
    """Record the (entry, table rows, width, ids, counts) of every table
    update the engines make while the block runs (the first `limit`):
    the port's modules call the kernel wrappers through their own names,
    so those names are wrapped, and restored after."""
    import graphvite_tpu_torch.optim as optim_mod
    import graphvite_tpu_torch.parallel.kg as kg_mod
    import graphvite_tpu_torch.parallel.mesh as mesh_mod

    saved = []

    def wrap(mod, name):
        fn = getattr(mod, name)

        def rec(table, *args, **kw):
            if limit is not None and len(calls) >= limit:
                return fn(table, *args, **kw)
            ids = args[1] if name == "scatter_update_" else args[0]
            calls.append({"entry": name, "rows": table.shape[0],
                          "width": table.shape[1], "ids": ids.clone(),
                          "counts": (kw.get("entry_counts").clone()
                                     if kw.get("entry_counts") is not None
                                     else None)})
            return fn(table, *args, **kw)
        saved.append((mod, name, fn))
        setattr(mod, name, rec)

    wrap(optim_mod, "scatter_add_")
    wrap(optim_mod, "scatter_update_")
    wrap(mesh_mod, "scatter_add_")
    wrap(kg_mod, "scatter_add_")
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def mesh_episode_checks(solver, seed):
    """Two more episodes of MESH_CHECK_BATCHES batches per worker of a
    mesh run's engine from its gathered state: host syncs per
    worker-batch (torch's sync debug mode) and the update ids of its
    first worker-batch (kernel cases); then a traced one."""
    import torch

    tr = solver._mesh_trainer
    # two batches per worker: the sync debug mode and the profiler cost
    # host time per launch, and node2vec launches ~10,000 per batch
    ep_batches, tr.ep_batches = tr.ep_batches, MESH_CHECK_BATCHES
    state = tr.init_state(*solver.state["tables"],
                          moments=solver.state["moments"])
    neg = tr.init_negative_state(np.asarray(solver.graph.vertex_weights))
    sample = solver._mesh_sample_state
    calls = []

    def episode():
        with recording_updates(calls):
            tr.run_episode(state, sample, neg, 0, solver.num_batch, seed)

    per_episode, sites = syncs_per_call(episode, calls=1)
    torch.cuda.synchronize()
    per_batch = per_episode / (tr.ep_batches * tr.num_partition)
    trace = trace_mesh_episode(
        lambda: tr.run_episode(state, sample, neg, 0, solver.num_batch,
                               seed), tr.ep_batches * tr.num_partition)
    tr.ep_batches = ep_batches
    del state
    return per_batch, sites, calls, trace


def trace_mesh_episode(episode, worker_batches):
    """One engine episode under torch.profiler: kernels and device time
    per worker-batch, and the collectives' device time (their mesh::
    ranges: the copies of all_to_all, ring_shift and sum) per episode."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        episode()
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    rows, ranges = [], {}
    for ev in prof.key_averages():
        if ev.key.startswith("mesh::"):
            ranges[ev.key] = {"calls": ev.count,
                              "device_s": ev.device_time_total / 1e6,
                              "host_s": ev.cpu_time_total / 1e6}
        elif (ev.device_type == DeviceType.CUDA
              and ev.self_device_time_total
              and not ev.key.startswith(SPANS)):
            rows.append((ev.self_device_time_total, ev.count, ev.key))
    if not rows:
        raise AssertionError("the profiler recorded no device time")
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows) / 1e3 / worker_batches
    return {"worker_batches": worker_batches, "wall_s_profiled": wall_s,
            "device_ms_per_worker_batch": device_ms,
            "kernels_per_worker_batch": sum(r[1] for r in rows)
            / worker_batches,
            "collectives_per_episode": ranges,
            "top": [{"kernel": name[:70],
                     "ms_per_worker_batch": us / 1e3 / worker_batches,
                     "calls_per_worker_batch": c / worker_batches}
                    for us, c, name in rows[:8]]}


def train_mesh_graph(graph, model, optimizer, batches, build_kw, train_kw,
                     per_batch, env, eff, seed, blocks=None):
    """Node embedding through GraphApplication with `gpus` = MESH_IDS (two
    workers on one card): the launch counts set to 0 just before train()
    and read just after, the peak device memory from a reset just before;
    then one more episode for host syncs and update ids. `blocks`: an
    earlier run's block tables on this graph (the solver's
    `_mesh_blocks`). Returns the application, the record, the recorded
    updates and a list of problems."""
    import torch
    from graphvite_tpu_torch import GraphApplication

    with environ(env):
        app = GraphApplication(dim=DIM, gpus=MESH_IDS)
        app.graph = graph
        app.build(optimizer=optimizer, **build_kw)
        s = app.solver
        if blocks is not None:
            s._mesh_blocks = blocks
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        app.train(model=model, num_epoch=batches * eff / graph.num_edge
                  + 1e-9, log_frequency=10**9, **train_kw)
        elapsed = time.perf_counter() - t0     # train() ends synchronized
        counts = read_launches()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        syncs, sites, calls, trace = mesh_episode_checks(s, seed)
    st = s.mesh_stats
    run = s.batch_id
    losses = s.batch_losses.double()
    k = max(run // 10, 5)
    rec = {"model": model, "optimizer": optimizer["type"],
           "workers": st["workers"], "device_ids": MESH_IDS,
           "batches": run, "batch": s.effective_batch,
           "ep_batches": st["ep_batches"], "episodes": st["episodes"],
           "elapsed_s": elapsed, "loop_s": st["loop_s"],
           "setup_s": st["setup_s"],
           "ms_per_worker_batch": st["loop_s"] / run * 1e3,
           "samples_per_s": run * s.effective_batch / st["loop_s"],
           "launches": counts,
           "launches_per_worker_batch": {n: c / run for n, c in
                                         counts.items() if c},
           "host_syncs_per_worker_batch": syncs, "sync_sites": sites,
           "trace": trace,
           "loss_first": float(losses[:k].mean()),
           "loss_last": float(losses[-k:].mean()),
           "losses_finite": bool(torch.isfinite(losses).all()),
           "tables_finite": all(bool(torch.isfinite(t.float()).all())
                                for t in s.state["tables"]),
           "peak_mem_gb": peak_gb}
    if st["requests"]:
        rec.update(requests=st["requests"], dropped=st["dropped"],
                   drop_share=st["dropped"] / st["requests"],
                   valid_pairs_per_s=st["valid_pairs"] / st["loop_s"])
    problems = []
    want = {name: per_batch.get(name, 0) * run for name in counts}
    if counts != want:
        problems.append("kernel launches %r, want %r" % (counts, want))
    if s.effective_batch != eff:
        problems.append("batch %d per worker, want %d"
                        % (s.effective_batch, eff))
    if not rec["losses_finite"] or not rec["tables_finite"]:
        problems.append("losses or tables not finite")
    if syncs:
        problems.append("%g host syncs per worker-batch: %r"
                        % (syncs, sites))
    if st["requests"] and not rec["drop_share"] < 0.01:
        problems.append("drop share %.4f >= 1%%" % rec["drop_share"])
    return app, rec, calls, problems


def mesh_w1_walks(graph, batches, seed):
    """DeepWalk at the deepwalk_youtube.yaml shape through the walks
    engine with ONE worker (the solver routes W = 1 to the flat path, so
    its mesh loop is called directly): the engine's overhead against the
    flat route's ms/batch of phase main."""
    from graphvite_tpu_torch.solver import GraphSolver

    s = GraphSolver(dim=DIM)
    s.build(graph, optimizer=SGD_YOUTUBE, num_negative=1,
            batch_size=100000, episode_size=25)
    s.worker_devices = [s.device]
    s.model = "DeepWalk"
    s.init_embeddings()
    s.batch_id = 0
    reset_launches()
    s._train_loop_mesh("DeepWalk", batches * MESH_WALK_BATCH
                       / graph.num_edge + 1e-9, 5, 40, 1.0, 1.0, 5.0, 0.75,
                       10**9)
    counts = read_launches()
    st = s.mesh_stats
    run = s.batch_id
    return {"workers": 1, "batches": run, "batch": s.effective_batch,
            "ms_per_batch": st["loop_s"] / run * 1e3,
            "valid_pairs_per_s": st["valid_pairs"] / st["loop_s"],
            "launches": counts}


def sink_graph(num_vertex):
    """Directed edges of `num_vertex` sources into one sink, and a third of
    them on to the next source: most walks reach the sink and stay there
    (a dead end repeats its vertex), so its owner gets most row requests
    while its degree share (no out-edges) sizes the routing capacity
    small. Anonymous and unweighted, as power_law_graph."""
    from graphvite_tpu_torch.graph import Graph

    src = np.arange(num_vertex, dtype=np.int64)
    g = Graph()
    g.num_vertex = num_vertex + 1
    g.edge_heads = np.concatenate([src, src[::3]])
    g.edge_tails = np.concatenate([np.full(num_vertex, num_vertex),
                                   (src[::3] + 1) % num_vertex])
    g.num_edge = int(g.edge_heads.size)
    g.id2name = g.name2id = None
    g.as_undirected = False
    g.edge_weights = np.ones(g.edge_heads.size, dtype=np.float32)
    g._finalize(normalization=False)
    return g


def replay_mesh_engines(seed, W=MESH_REPLAY_W, device="cuda"):
    """Each engine with W workers on the card and W on the CPU from the
    same draws and state at a small size (a power-law graph of 20,000
    vertices, dim 32): edges (SGD and Adam), walks (SGD on the arena,
    Adam, and SGD at route slack 0.3 on a 20,000-source sink graph, where
    about 40% of the row requests overflow the capacity and are dropped),
    LargeVis replicas (SGD with the trust clip; Adam at lr 0.5 from warm
    moments, as the CPU test against the reference starts it). Tolerance,
    as the steps' replays: rtol 3e-4, atol 3e-6 of the gathered tables
    (replicas: of each row's largest magnitude); the graph engines' losses
    rtol 2e-5; the drop counts equal."""
    import torch
    from graphvite_tpu_torch.models import GRAPH_MODELS
    from graphvite_tpu_torch.ops import steps
    from graphvite_tpu_torch.optim import Optimizer
    from graphvite_tpu_torch.parallel import mesh

    graph = power_law_graph(20000, 150000, seed)
    sink = sink_graph(20000)
    dim = 32
    gen = torch.Generator().manual_seed(seed)
    groups = {"cuda": mesh.DeviceGroup([torch.device(device)] * W),
              "cpu": mesh.DeviceGroup(["cpu"] * W)}
    out, problems = {}, []
    cases = (("edges_sgd", "edges", "SGD"), ("edges_adam", "edges", "Adam"),
             ("walks_sgd", "walks", "SGD"), ("walks_adam", "walks", "Adam"),
             ("walks_drop", "walks", "SGD"))
    for name, mode, rule in cases:
        g = sink if name == "walks_drop" else graph
        vertex = (torch.rand((g.num_vertex, dim), generator=gen) - 0.5) / dim
        context = torch.randn((g.num_vertex, dim), generator=gen) * 0.05
        part = mesh.VertexPartition(np.asarray(g.degrees), W)
        opt = Optimizer(type=rule, lr=0.025 if rule == "SGD" else 1e-3,
                        weight_decay=5e-3, beta2=0.999)
        walk_cfg = dict(augmentation_step=2, walk_length=10, bidir=True,
                        pool_size=64)
        if name == "walks_drop":
            walk_cfg["route_slack"] = 0.3
        tables, trainers, drops = {}, {}, {}
        for where, group in groups.items():
            tr = mesh.ShardedGraphTrainer(
                group, part, dim, GRAPH_MODELS["LINE"], opt,
                num_negative=1, negative_weight=5.0,
                batch_size=4096 if mode == "edges" else 4 * 22 * 64,
                ep_batches=3, sampler_mode=mode, walk_cfg=dict(walk_cfg))
            sample = tr.build_sample_state(g)
            state = tr.init_state(vertex, context)
            neg = tr.init_negative_state(np.asarray(g.vertex_weights))
            trainers[where] = (tr, sample, state, neg)
        losses = {"cuda": [], "cpu": []}
        for e in range(2):
            draws = trainers["cpu"][0].episode_draws(gen)
            for where, (tr, sample, state, neg) in trainers.items():
                d = mesh.draws_to(draws, tr.group.devices)
                state, neg, ls = tr.run_episode(state, sample, neg, 6 * e,
                                                1000, seed, draws=d)
                losses[where] += [l.cpu() for l in ls]
                trainers[where] = (tr, sample, state, neg)
        for where, (tr, _, state, _) in trainers.items():
            tables[where] = [t.cpu().float() for t in tr.gather_tables(state)]
            drops[where] = tr.drop_counts()
        lc, lp = (torch.cat(losses[k]).double() for k in ("cuda", "cpu"))
        if not bool(((lc - lp).abs() <= 2e-5 * lp.abs()).all()):
            problems.append("%s: card and CPU losses differ: %r against %r"
                            % (name, lc.tolist(), lp.tolist()))
        err = max(float((a - b).abs().max()) for a, b in
                  zip(tables["cuda"], tables["cpu"]))
        ok = all(bool(((a - b).abs() <= 3e-6 + 3e-4 * b.abs()).all())
                 for a, b in zip(tables["cuda"], tables["cpu"]))
        moved = float((tables["cpu"][1] - context).abs().max())
        out[name] = {"workers": W, "max_abs_err": err, "moved": moved}
        if not ok or not moved > 0:
            problems.append("%s: card and CPU disagree (max |err| %g) or "
                            "nothing moved" % (name, err))
        if mode == "walks":
            out[name]["drops"] = list(drops["cuda"])
            if drops["cuda"] != drops["cpu"]:
                problems.append("%s: card drops %r, CPU drops %r"
                                % (name, drops["cuda"], drops["cpu"]))
            if name == "walks_drop" and not drops["cuda"][0] > 0:
                problems.append("walks_drop: no request was dropped (%r)"
                                % (drops["cuda"],))
        del trainers, tables
    # LargeVis replicas, the pooled step: SGD with the trust clip (kernel
    # 1 at 8 columns); Adam from warm moments in the live columns (the
    # dense route), as tests/test_torch_mesh.py starts it against the
    # reference
    w = np.maximum(np.asarray(graph.vertex_weights, np.float64), 1e-12) ** 0.75
    from graphvite_tpu_torch.ops.alias import AliasTable, device_alias_arrays
    neg_np = device_alias_arrays(AliasTable(w))
    coord = torch.zeros((graph.num_vertex, 8))
    coord[:, :2] = torch.randn((graph.num_vertex, 2), generator=gen) * 3
    warm = tuple(torch.zeros((graph.num_vertex, 8)) for _ in range(2))
    for m in warm:
        m[:, :2] = torch.randn((graph.num_vertex, 2),
                               generator=gen).abs() * 1e-2 + 1e-3
    nudged = coord.clone()
    nudged[:, :2] = torch.nextafter(coord[:, :2],
                                    torch.full_like(coord[:, :2], 1e9))
    for rule in ("SGD", "Adam"):
        name = "vis_" + rule.lower()
        opt = Optimizer(type=rule, lr=0.5, weight_decay=1e-5)
        res = {}
        draws = None
        # the CPU once more from coordinates one ulp above: how far the
        # episode itself carries a last-bit difference
        for where, group, start in (("cuda", groups["cuda"], coord),
                                    ("cpu", groups["cpu"], coord),
                                    ("cpu_nudged", groups["cpu"], nudged)):
            step = steps.make_vis_pool_step(opt, 5, 3.0, pool_size=64,
                                            pool_groups=8)
            tr = mesh.ReplicatedEdgeTrainer(group, step, opt, 4096, 3)
            if draws is None:
                draws = tr.episode_draws(gen)
            tabs, moms = tr.init_state((start,),
                                       (warm,) if rule == "Adam" else None)
            edges = tr.init_edges(graph)
            neg = tuple(torch.from_numpy(a) for a in neg_np)
            tabs, moms, _ = tr.run_episode(
                tabs, moms, edges, neg, 0, 1000, seed,
                draws=mesh.draws_to(draws, group.devices))
            res[where] = tabs[0][0].cpu()
        scale = res["cpu"].abs().amax(dim=1, keepdim=True)
        diff = (res["cuda"] - res["cpu"]).abs()
        err = float(diff.max())
        tol = 3e-6 + 3e-4 * scale
        out[name] = {"workers": W, "max_abs_err": err,
                     "worst_err_over_tol": float((diff / tol).max()),
                     "cpu_ulp_over_tol": float(
                         ((res["cpu_nudged"] - res["cpu"]).abs()
                          / tol).max()),
                     "moved": float((res["cpu"] - coord).abs().max())}
        if not bool((diff <= tol).all()):
            problems.append("%s: card and CPU disagree (max |err| %g)"
                            % (name, err))
    return out, problems


def mesh_quality(model):
    """quality()'s two-block graph through GraphApplication with gpus
    [0, 0]: two workers on the card."""
    from graphvite_tpu_torch import GraphApplication

    app = GraphApplication(dim=16, gpus=MESH_IDS)
    app.load(edge_list=two_blocks())
    if model == "DeepWalk":
        app.build(optimizer={"type": "SGD", "lr": 0.1, "weight_decay": 5e-3},
                  num_negative=1, batch_size=2048, episode_size=8)
        kw = dict(num_epoch=2000, augmentation_step=2, random_walk_length=8)
    else:
        app.build(num_negative=2, batch_size=512, episode_size=8)
        kw = dict(num_epoch=1000, augmentation_step=1)
    app.train(model=model, negative_weight=1.0, log_frequency=10**9, **kw)
    g = app.graph
    rng = np.random.default_rng(1)
    half = g.num_vertex // 2
    k = 300
    sel = rng.choice(g.num_directed_edge, size=k, replace=False)
    H = [g.id2name[i] for i in g.edge_heads[sel]]
    T = [g.id2name[i] for i in g.edge_tails[sel]]
    H += [str(x) for x in rng.integers(half, size=k)]
    T += [str(x) for x in rng.integers(half, size=k) + half]
    auc = app.evaluate("link prediction", H=H, T=T, Y=[1] * k + [0] * k)
    return {"model": model, "workers": app.solver.num_worker,
            "batches": app.solver.batch_id, "auc": auc["AUC"]}


def mesh_phase(seed, shared):
    """The multi-device engines at W = 2 on the one card (device_ids
    [0, 0]), on the graphs earlier phases built: (a) LINE in edges mode at
    the line_friendster-small.yaml shape (SGD at the config's
    hyperparameters, Adam lr 1e-6 wd 0); (b) DeepWalk in walks mode at the
    deepwalk_youtube.yaml shape (SGD, Adam, a short node2vec p 4 q 2), and
    W = 1 through the engine against the flat route; (c) LargeVis
    replicas at the largevis_mnist_2d.yaml shape (Adam, 10-NN agreement
    >= 0.95; SGD); two-block LINE and DeepWalk AUC > 0.9; each engine at
    W = 4 on the card against the CPU from the same draws."""
    import torch

    out, problems = {"ids": {}}, []

    def keep_ids(tag, calls):
        """The first worker-batch's update ids of a run's extra episode."""
        n = {"edges": 2, "walks": 1}[tag.split("_")[0]]
        if tag.endswith("adam"):
            n = 2
        out["ids"][tag] = calls[:n]

    # (a) edges mode
    graph = shared["friendster"]
    blocks = None
    for name, opt, batches, per_batch in MESH_EDGE_RUNS:
        app, rec, calls, bad = train_mesh_graph(
            graph, "LINE", opt, batches, BUILD_FRIENDSTER,
            dict(augmentation_step=1, negative_weight=5.0), per_batch,
            {"GRAPHVITE_MIN_SWEEPS": "1"}, MESH_EDGE_BATCH, seed,
            blocks=blocks)
        blocks = app.solver._mesh_blocks
        log("   (a) LINE edges %s:" % name, json.dumps(rec))
        out["edges_" + name] = rec
        problems += ["edges %s: %s" % (name, p) for p in bad]
        if name == "sgd" and not rec["loss_last"] < rec["loss_first"]:
            problems.append("edges sgd: losses not falling")
        keep_ids("edges_" + name, calls)
        del app, calls
        torch.cuda.empty_cache()
    del blocks

    # (b) walks mode
    graph = shared["youtube"]
    build = dict(num_negative=1, batch_size=100000, episode_size=25)
    walk_kw = dict(augmentation_step=5, random_walk_length=40,
                   negative_weight=5.0)
    for name, model, opt, batches, per_batch in MESH_WALK_RUNS:
        kw = dict(walk_kw, **({"p": 4.0, "q": 2.0} if model == "node2vec"
                              else {}))
        app, rec, calls, bad = train_mesh_graph(
            graph, model, opt, batches, build, kw, per_batch, {},
            MESH_WALK_BATCH, seed)
        log("   (b) %s walks %s:" % (model, name), json.dumps(rec))
        out["walks_" + name] = rec
        problems += ["walks %s: %s" % (name, p) for p in bad]
        if name != "node2vec":
            keep_ids("walks_" + name, calls)
        del app, calls
        torch.cuda.empty_cache()
    rec = mesh_w1_walks(graph, MESH_W1_BATCHES, seed)
    flat = shared.get("main_ms_per_batch")
    rec["flat_ms_per_batch"] = flat
    rec["overhead_vs_flat"] = rec["ms_per_batch"] / flat if flat else None
    log("   (b) DeepWalk walks, W = 1 through the engine:", json.dumps(rec))
    out["walks_w1"] = rec
    la = rec["launches"]
    if (la["scatter_add_"] != rec["batches"]
            or la["walk_chain"] != rec["batches"]
            or la["walk_band"] != rec["batches"]
            or sum(la.values()) != 3 * rec["batches"]):
        problems.append("walks W 1: %r launches" % la)
    torch.cuda.empty_cache()

    # (c) LargeVis replicas
    graph, labels = shared["mnist"]
    for name, opt, batches, per_batch in (
            ("adam", ADAM_VIS, None, {}),
            ("sgd", SGD_VIS, MESH_VIS_SGD_BATCHES, {"scatter_add_": 1})):
        rec, bad = train_mesh_vis(graph, opt, batches, labels, per_batch)
        log("   (c) LargeVis %s:" % name, json.dumps(rec))
        out["vis_" + name] = rec
        problems += ["vis %s: %s" % (name, p) for p in bad]
        torch.cuda.empty_cache()
    if not out["vis_adam"]["agreement_10nn"] >= 0.95:
        problems.append("vis adam: 10-NN label agreement %.4f < 0.95"
                        % out["vis_adam"]["agreement_10nn"])

    # quality on the card, and the replays
    for model in ("LINE", "DeepWalk"):
        q = mesh_quality(model)
        log("   two-block %s at W = 2 on the card:" % model, json.dumps(q))
        out["quality_" + model] = q
        if not q["auc"] > 0.9:
            problems.append("two-block %s AUC %.4f <= 0.9" % (model,
                                                               q["auc"]))
    rec, bad = replay_mesh_engines(seed)
    log("   replays, W = %d on the card vs the CPU:" % MESH_REPLAY_W,
        json.dumps(rec))
    out["replays"] = rec
    problems += bad
    if problems:
        raise AssertionError("; ".join(problems))
    return out


def train_mesh_vis(graph, optimizer, batches, labels, per_batch):
    """LargeVis through VisualizationApplication with gpus [0, 0] on the
    MNIST clone's KNN graph: MESH_VIS_EPOCHS of the config's 50 (Adam) or
    `batches` batches, the launch counts set to 0 just before train() and
    read just after."""
    import torch
    from graphvite_tpu_torch import VisualizationApplication

    app = VisualizationApplication(dim=2, gpus=MESH_IDS)
    app.graph = graph
    app.build(optimizer=optimizer, **BUILD_VIS)
    s = app.solver
    epochs = (MESH_VIS_EPOCHS if batches is None
              else batches * VIS_PLAN[0] / graph.num_edge + 1e-9)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    app.train(num_epoch=epochs, **LARGEVIS)
    elapsed = time.perf_counter() - t0
    counts = read_launches()
    st = s.mesh_stats
    run = s.batch_id
    losses = s.batch_losses.double()
    k = max(run // 10, 5)
    table = s.state["tables"][0]
    rec = {"optimizer": optimizer["type"], "workers": st["workers"],
           "batches": run, "batch": s.effective_batch,
           "ep_batches": st["ep_batches"], "elapsed_s": elapsed,
           "loop_s": st["loop_s"],
           "ms_per_worker_batch": st["loop_s"] / run * 1e3,
           "samples_per_s": run * s.effective_batch / st["loop_s"],
           "launches": counts,
           "loss_first": float(losses[:k].mean()),
           "loss_last": float(losses[-k:].mean()),
           "pad_columns_zero": bool((table[:, 2:] == 0).all()),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    problems = []
    if optimizer["type"] == "Adam":
        rec["agreement_10nn"] = layout_agreement(s.coordinates, labels)
    want = {name: per_batch.get(name, 0) * run for name in counts}
    if counts != want:
        problems.append("kernel launches %r, want %r" % (counts, want))
    if not bool(torch.isfinite(losses).all()) or not bool(
            torch.isfinite(table).all()):
        problems.append("losses or coordinates not finite")
    if not rec["pad_columns_zero"]:
        problems.append("the pad columns moved")
    return rec, problems


# ---------------------------------------------------------------------------
# phase 13: the knowledge-graph engines on several workers
# ---------------------------------------------------------------------------

# config/knowledge_graph/rotate_wikidata5m.yaml's build, episodes of 16
BUILD_KG_MESH = dict(num_negative=64, batch_size=100000, episode_size=16)
# (case, GRAPHVITE_KG_NEG_POOL or None for the auto rule, optimizer,
# worker-batches, batch per worker, launches per worker-batch): kernel 1
# twice (entity arena, relations) on SGD, kernel 2 once (the arena; the
# 822 x 512 relation table takes the dense route) on Adam; the global
# pool adds the pool-space sum and the owners' update, kernel 1 each
KG_MESH_RUNS = (("a_pooled_sgd", None, SGD_WIKIDATA5M, 96, 60928,
                 {"scatter_add_": 2}),
                ("b_pooled_adam", "pooled", ADAM_WIKIDATA5M, 96, 60928,
                 {"scatter_update_": 1}),
                ("c_global_sgd", "global", SGD_WIKIDATA5M, 48, 1792,
                 {"scatter_add_": 4}),
                ("d_resident_sgd", "resident", SGD_WIKIDATA5M, 48, 1792,
                 {"scatter_add_": 2}))
KG_MESH_REPLAY = dict(entities=2000, relations=20, triplets=20000, dim=32)
# the JAX package's filtered tail MRR on math.yaml at dim 128, 500 epochs,
# W = 2 on the CPU (tools/kg_mesh_math_gate.py: 0.4810), less 0.05
KG_MESH_MATH_GATE = 0.4810 - 0.05


def kg_mesh_episode_checks(solver, seed):
    """Two more rounds of MESH_CHECK_BATCHES batches per worker of a KG
    mesh run's engine from its gathered state: host syncs per
    worker-batch (torch's sync debug mode) with the update ids of the
    first round's first worker-batch (kernel cases), then a traced one."""
    import torch

    tr = solver._kgmesh_trainer
    blocks = solver._kgmesh_prep[2]
    ep_batches, tr.ep_batches = tr.ep_batches, MESH_CHECK_BATCHES
    state = tr.init_state(*solver.state["tables"],
                          moments=solver.state["moments"])
    calls = []
    box = [state]

    def episode():
        with recording_updates(calls):
            box[0], _ = tr.run_episode(box[0], blocks, 0, solver.num_batch,
                                       seed)

    per_episode, sites = syncs_per_call(episode, calls=1)
    torch.cuda.synchronize()
    worker_batches = tr.ep_batches * tr.num_worker

    def traced():
        box[0], _ = tr.run_episode(box[0], blocks, 0, solver.num_batch,
                                   seed)

    trace = trace_mesh_episode(traced, worker_batches)
    tr.ep_batches = ep_batches
    del box, state
    return per_episode / worker_batches, sites, calls, trace


def train_kg_mesh(graph, name, neg_pool, optimizer, batches, eff, per_batch,
                  seed, prep=None):
    """RotatE at the rotate_wikidata5m.yaml shape through
    KnowledgeGraphApplication with `gpus` = MESH_IDS (two workers on one
    card), GRAPHVITE_MIN_SWEEPS=1 (rounds of 16 batches per worker), the
    launch counts set to 0 just before train() and read just after, the
    peak device memory from a reset just before; then the episode checks.
    `prep`: an earlier run's partition and block-sorted triplets on this
    graph. Returns the solver's prep, the record, the recorded updates
    and a list of problems."""
    import torch
    from graphvite_tpu_torch import KnowledgeGraphApplication

    env = {"GRAPHVITE_MIN_SWEEPS": "1"}
    if neg_pool:
        env["GRAPHVITE_KG_NEG_POOL"] = neg_pool
    with environ(env):
        app = KnowledgeGraphApplication(dim=KG_BIG_DIM, gpus=MESH_IDS)
        app.graph = graph
        app.build(optimizer=optimizer, **BUILD_KG_MESH)
        s = app.solver
        if prep is not None:
            s._kgmesh_prep = prep
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        app.train(num_epoch=batches * eff / graph.num_edge + 1e-9,
                  **ROTATE_WIKIDATA5M)
        elapsed = time.perf_counter() - t0     # train() ends synchronized
        counts = read_launches()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        syncs, sites, calls, trace = kg_mesh_episode_checks(s, seed)
    st = s.mesh_stats
    run = s.batch_id
    losses = s.batch_losses.double()
    k = max(run // 10, 5)
    extremes = [float(x) for t in s.state["tables"] for x in t.aminmax()]
    rec = {"case": name, "negative_pool": st["negative_pool"],
           "optimizer": optimizer["type"], "workers": st["workers"],
           "device_ids": MESH_IDS, "batches": run,
           "batch": s.effective_batch, "ep_batches": st["ep_batches"],
           "episodes": st["episodes"], "elapsed_s": elapsed,
           "loop_s": st["loop_s"], "setup_s": st["setup_s"],
           "ms_per_worker_batch": st["loop_s"] / run * 1e3,
           "triplets_per_s": run * s.effective_batch / st["loop_s"],
           "launches": counts,
           "launches_per_worker_batch": {n: c / run for n, c in
                                         counts.items() if c},
           "host_syncs_per_worker_batch": syncs, "sync_sites": sites,
           "trace": trace,
           "loss_first": float(losses[:k].mean()),
           "loss_last": float(losses[-k:].mean()),
           "losses_finite": bool(torch.isfinite(losses).all()),
           "tables_finite": all(np.isfinite(x) for x in extremes),
           "peak_mem_gb": peak_gb}
    problems = []
    want = {n: per_batch.get(n, 0) * run for n in counts}
    if counts != want:
        problems.append("kernel launches %r, want %r" % (counts, want))
    if s.effective_batch != eff or run != batches:
        problems.append("%d worker-batches of %d, want %d of %d"
                        % (run, s.effective_batch, batches, eff))
    if st["negative_pool"] != (neg_pool or "pooled"):
        problems.append("negative pool %r" % st["negative_pool"])
    if not rec["losses_finite"] or not rec["tables_finite"]:
        problems.append("losses or tables not finite")
    if syncs:
        problems.append("%g host syncs per worker-batch: %r"
                        % (syncs, sites))
    return s._kgmesh_prep, rec, calls, problems


@contextlib.contextmanager
def dense_update_elems(n):
    """optim.DENSE_UPDATE_ELEMS set to n while the block runs."""
    import graphvite_tpu_torch.optim as optim_mod

    saved = optim_mod.DENSE_UPDATE_ELEMS
    optim_mod.DENSE_UPDATE_ELEMS = n
    try:
        yield
    finally:
        optim_mod.DENSE_UPDATE_ELEMS = saved


def kg_mesh_engine_run(kg, mode, rule, devices, draws, episodes, lr=None):
    """ShardedKGTrainer on `devices` (a worker per entry) over the small
    KG at KG_MESH_REPLAY's dim (RotatE, K 8, batch 512, rounds of 3):
    the gathered entity table and moments, every worker's relations and
    the losses. `draws`: per-round draws made on the CPU by the first
    call and reused by the next (None: the workers' own generators)."""
    import torch
    from graphvite_tpu_torch.models import KG_MODELS
    from graphvite_tpu_torch.optim import Optimizer
    from graphvite_tpu_torch.parallel import kg as kg_mod
    from graphvite_tpu_torch.parallel import mesh

    dim = KG_MESH_REPLAY["dim"]
    W = len(devices)
    group = mesh.DeviceGroup(devices)
    part = mesh.VertexPartition(np.asarray(kg.degrees), 2 * W)
    if lr is None:
        lr = 0.01 if rule == "SGD" else 1e-4
    opt = Optimizer(type=rule, lr=lr, weight_decay=0.0)
    tr = kg_mod.ShardedKGTrainer(
        group, part, dim, KG_MODELS["RotatE"], opt, num_negative=8,
        margin_or_l3=6.0, adversarial_temperature=0.2, batch_size=512,
        ep_batches=3, negative_pool=mode)
    gen = torch.Generator().manual_seed(5)
    ent = (torch.rand((kg.num_vertex, dim), generator=gen) - 0.5) * 0.1
    rel = torch.rand((kg.num_relation, dim), generator=gen) * 6 - 3
    state = tr.init_state(ent, rel)
    blocks = tr.init_triplets(kg)
    losses = []
    for e in range(episodes):
        d = None
        if draws is not None:
            if len(draws) <= e:
                draws.append(tr.episode_draws(
                    torch.Generator().manual_seed(e)))
            d = mesh.draws_to(draws[e], group.devices)
        state, ls = tr.run_episode(state, blocks, 6 * e, 1000, 1, draws=d)
        losses += [l.cpu() for l in ls]
    out = {"entity": tr.gather_entities(state).cpu(),
           "relations": [r.cpu() for r in state["rel"]],
           "moments": [m.cpu() for m in tr.gather_entity_moments(state)],
           "losses": torch.stack(losses)}
    return out, (ent, rel)


def kg_mesh_replays(seed, device="cuda"):
    """On a small power-law KG (KG_MESH_REPLAY): (1) lr = 0, five rounds at
    W = 2 and W = 4 on `device`, each mode: the entity and relation tables
    come back bit for bit; (2) each mode with SGD and Adam at W = 2 and
    W = 4 on `device` against as many CPU workers from the same state and
    draws over two rounds, the dense-update size shrunk so the arenas
    take kernel 2: tables, moments and relations within rtol 3e-4, atol
    3e-6, losses rtol 2e-5 (the steps' card-vs-CPU tolerance)."""
    import torch
    from graphvite_tpu_torch.graph import KnowledgeGraph

    kg = fill_power_law_kg(KnowledgeGraph(), KG_MESH_REPLAY["entities"],
                           KG_MESH_REPLAY["relations"],
                           KG_MESH_REPLAY["triplets"], seed)
    out, problems = {"roundtrip": {}, "replays": {}}, []
    for W in (2, 4):
        for mode in ("pooled", "global", "resident"):
            got, (ent, rel) = kg_mesh_engine_run(
                kg, mode, "SGD", [torch.device(device)] * W, None, 5,
                lr=0.0)
            same = (torch.equal(got["entity"], ent)
                    and all(torch.equal(r, rel) for r in got["relations"]))
            out["roundtrip"]["%s_w%d" % (mode, W)] = same
            if not same:
                problems.append("lr 0, %s, W %d: the tables changed"
                                % (mode, W))
    with dense_update_elems(1000):
        for W in (2, 4):
            for mode in ("pooled", "global", "resident"):
                for rule in ("SGD", "Adam"):
                    draws = []
                    card, (ent, _) = kg_mesh_engine_run(
                        kg, mode, rule, [torch.device(device)] * W, draws, 2)
                    cpu, _ = kg_mesh_engine_run(kg, mode, rule, ["cpu"] * W,
                                                draws, 2)
                    pairs = ([(card["entity"], cpu["entity"])]
                             + list(zip(card["relations"],
                                        cpu["relations"]))
                             + list(zip(card["moments"], cpu["moments"])))
                    err = max(float((a - b).abs().max()) for a, b in pairs)
                    ok = all(bool(((a - b).abs()
                                   <= 3e-6 + 3e-4 * b.abs()).all())
                             for a, b in pairs)
                    lc, lp = card["losses"].double(), cpu["losses"].double()
                    lerr = float(((lc - lp).abs() / lp.abs()).max())
                    name = "%s_%s_w%d" % (mode, rule.lower(), W)
                    out["replays"][name] = {
                        "max_abs_err": err, "loss_rel_err": lerr,
                        "moved": float((cpu["entity"] - ent).abs().max())}
                    if not ok or not lerr <= 2e-5:
                        problems.append("%s: card and CPU disagree (max "
                                        "|err| %g, loss %g)"
                                        % (name, err, lerr))
                    if not out["replays"][name]["moved"] > 0:
                        problems.append("%s: nothing moved" % name)
    return out, problems


def kg_mesh_math_cli(root):
    """config/demo/math.yaml through the CLI with `gpus: [0, 0]` (two
    workers on the card; global negatives by the auto rule at this
    shape), cut to dim 128 and 500 epochs: filtered tail MRR against
    KG_MESH_MATH_GATE."""
    cfg, app, results, rec, problems = run_cli(cli_config(
        "demo/math.yaml", root, (("dim: 512", "dim: 128\n  gpus: [0, 0]"),
                                 ("num_epoch: 2000", "num_epoch: 500"))))
    s = app.solver
    st = s.mesh_stats
    rec.update({"model": s.model, "dim": s.dim, "workers": st["workers"],
                "negative_pool": st["negative_pool"],
                "batch": s.effective_batch, "ep_batches": st["ep_batches"],
                "ms_per_worker_batch": st["loop_s"] / s.batch_id * 1e3,
                "gate": KG_MESH_MATH_GATE, **results[0]})
    if st["workers"] != 2 or st["negative_pool"] != "global":
        problems.append("trained on %d workers with %s negatives, want 2, "
                        "global" % (st["workers"], st["negative_pool"]))
    if not rec["MRR"] >= KG_MESH_MATH_GATE:
        problems.append("filtered tail MRR %.4f < %.4f"
                        % (rec["MRR"], KG_MESH_MATH_GATE))
    return rec, problems


def kg_mesh_phase(seed, shared):
    """The KG engines at W = 2 on the one card (device_ids [0, 0]) on
    kg_big's Wikidata5m-shaped graph: (a) pooled by the auto rule, SGD,
    96 worker-batches (one sweep of three rounds); (b) pooled, Adam (lr
    1e-6, wd 0), one sweep; (c) global and (d) resident negatives, SGD,
    48 each. Then the lr = 0 round trips and the card-vs-CPU replays at
    W = 2 and 4 on a small KG, and math.yaml through the CLI at W = 2."""
    import torch

    graph = shared["wikidata5m"]
    out, problems = {"ids": {}}, []
    prep = None
    for name, neg_pool, opt, batches, eff, per_batch in KG_MESH_RUNS:
        prep, rec, calls, bad = train_kg_mesh(graph, name, neg_pool, opt,
                                              batches, eff, per_batch, seed,
                                              prep)
        log("   (%s):" % name, json.dumps(rec))
        out[name] = rec
        problems += ["%s: %s" % (name, p) for p in bad]
        if name.startswith("a") and not rec["loss_last"] < rec["loss_first"]:
            problems.append("%s: losses not falling" % name)
        if name.startswith(("a", "b")):
            # worker 0's first batch: the arena's and (SGD) the relations'
            # updates
            whats = ("arena", "relation")[:2 if opt["type"] == "SGD"
                                          else 1]
            out["ids"][name] = list(zip(whats, calls))
        elif name.startswith("c"):
            # the global pool's first batch: worker 0's pool-space sum
            # (after its step's two updates) and its owner update (after
            # both workers' steps and sums, and the reduce_scatter)
            W = len(MESH_IDS)
            out["ids"][name] = [("pool sum", calls[2]),
                                ("owner update", calls[3 * W])]
        del calls
        torch.cuda.empty_cache()
    del prep
    torch.cuda.empty_cache()
    rec, bad = kg_mesh_replays(seed)
    log("   lr 0 round trips and replays, card vs CPU:", json.dumps(rec))
    out["replays"] = rec
    problems += bad
    with no_downloads():
        rec, bad = kg_mesh_math_cli(os.environ["GRAPHVITE_DATASET_PATH"])
    log("   math.yaml, gpus [0, 0]:", json.dumps(rec))
    out["math"] = rec
    problems += ["math: " + p for p in bad]
    if problems:
        raise AssertionError("; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# phase 14: the engines over two processes (GRAPHVITE_COORDINATOR)
# ---------------------------------------------------------------------------

# what a process of a multi-process run may not load (the card's host has
# none of these; the children check it before they exit)
FORBIDDEN = ("jax", "jaxlib", "graphvite_tpu", "ml_dtypes", "yaml", "pandas")
# (case, worker-batches over both workers, episodes, launches per
# worker-batch): (a) LINE edges SGD at line_flickr.yaml's
# hyperparameters, (b) Adam, (c) DeepWalk walks SGD at
# deepwalk_youtube.yaml's, (d) RotatE pooled SGD at
# rotate_wikidata5m.yaml's, (e) global negatives at 1,792
MH_CASES = (("a_edges_sgd", 128, 2, {"scatter_add_": 2}),
            ("b_edges_adam", 32, 2, {"scatter_update_": 2}),
            ("c_walks_sgd", 10, 1, {"scatter_add_": 1, "walk_chain": 1,
                                    "walk_band": 1}),
            ("d_kg_pooled_sgd", 24, 2, {"scatter_add_": 2}),
            ("e_kg_global_sgd", 8, 2, {"scatter_add_": 4}))
MH_WORKERS = 2
MH_DEVICE = "cuda:0"           # both processes' workers: two ranks, one card
MH_KG_BATCH = {"d": 60928, "e": 1792}   # per worker: pooled, global
MH_TIMEOUT_S = 300


def mh_write_inputs(root, shared):
    """The graphs of phases edge, main and kg_big as .npy under `root`,
    with the Flickr clone's block edge tables and the Wikidata5m clone's
    block-sorted triplets built once here: the processes load them.
    Returns the set-up seconds."""
    from graphvite_tpu_torch.parallel import kg as kg_mod
    from graphvite_tpu_torch.parallel import mesh

    out = {}

    def save(name, a):
        np.save(os.path.join(root, name + ".npy"), np.asarray(a))

    fl = shared["flickr"]
    t0 = time.perf_counter()
    part = mesh.VertexPartition(np.asarray(fl.degrees), MH_WORKERS)
    tables = mesh.BlockEdgeTables(fl, part)
    out["flickr_block_tables_s"] = time.perf_counter() - t0
    for name in ("prob", "alias", "heads", "tails", "offsets"):
        save("flickr_" + name, getattr(tables, name))
    save("flickr_uniform", tables.uniform)
    save("flickr_degrees", fl.degrees)
    save("flickr_vertex_weights", fl.vertex_weights)
    del tables
    yt = shared["youtube"]
    for name in ("degrees", "vertex_weights", "edge_weights", "csr_weights",
                 "indptr", "indices", "edge_heads", "edge_tails"):
        save("youtube_" + name, getattr(yt, name))
    kg = shared["wikidata5m"]
    t0 = time.perf_counter()
    part = mesh.VertexPartition(np.asarray(kg.degrees), 2 * MH_WORKERS)
    blocks = kg_mod.TripletBlocks(kg, part, ["cpu"])
    out["kg_triplet_sort_s"] = time.perf_counter() - t0
    save("kg_block_off", blocks.block_off)
    for name, a in zip(("heads", "tails", "relations"), blocks.arrays["cpu"]):
        save("kg_" + name, a.numpy())
    save("kg_degrees", kg.degrees)
    save("kg_sizes", [kg.num_vertex, kg.num_relation])
    return out


def mh_load_inputs(root):
    """The arrays `mh_write_inputs` saved, with the block edge tables as a
    BlockEdgeTables, the walk graph as the attributes the walks engine
    reads, and the triplets' block offsets and arrays."""
    import types

    from graphvite_tpu_torch.parallel import mesh

    def load(name):
        return np.load(os.path.join(root, name + ".npy"))

    tables = mesh.BlockEdgeTables.__new__(mesh.BlockEdgeTables)
    for name in ("prob", "alias", "heads", "tails", "offsets"):
        setattr(tables, name, load("flickr_" + name))
    tables.uniform = bool(load("flickr_uniform"))
    tables.capacity = tables.heads.shape[1]
    youtube = types.SimpleNamespace(**{
        name: load("youtube_" + name)
        for name in ("degrees", "vertex_weights", "edge_weights",
                     "csr_weights", "indptr", "indices", "edge_heads",
                     "edge_tails")})
    return {"flickr_tables": tables,
            "flickr_degrees": load("flickr_degrees"),
            "flickr_vertex_weights": load("flickr_vertex_weights"),
            "youtube": youtube,
            "kg_block_off": load("kg_block_off"),
            "kg_arrays": tuple(load("kg_" + n)
                               for n in ("heads", "tails", "relations")),
            "kg_degrees": load("kg_degrees"),
            "kg_sizes": tuple(int(x) for x in load("kg_sizes"))}


def mh_table(rows, dim, seed, lo, hi, device):
    """A [rows, dim] float32 table uniform in [lo, hi) on `device`, made
    from `seed`: every process makes the same bits."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    t = torch.rand((rows, dim), generator=gen, device=device)
    return t.mul_(hi - lo).add_(lo)


def digest(t, chunk=1 << 28):
    """sha256 of a tensor's bytes (equal digests, equal bits), fed from a
    pinned host buffer `chunk` bytes at a time."""
    import hashlib

    import torch

    flat = t.detach().contiguous().reshape(-1).view(torch.uint8)
    h = hashlib.sha256()
    buf = torch.empty(min(chunk, flat.numel()), dtype=torch.uint8,
                      pin_memory=flat.is_cuda)
    for lo in range(0, flat.numel(), chunk):
        part = buf[:min(chunk, flat.numel() - lo)]
        part.copy_(flat[lo:lo + chunk])
        h.update(memoryview(part.numpy()))
    return h.hexdigest()


def mh_engine(name, group, inputs, ep_batches):
    """Case `name`'s engine on `group` and its sample state, as the solvers
    configure them at these shapes (as in phases mesh and kg_mesh)."""
    from graphvite_tpu_torch.models import GRAPH_MODELS, KG_MODELS
    from graphvite_tpu_torch.optim import Optimizer
    from graphvite_tpu_torch.parallel import kg as kg_mod
    from graphvite_tpu_torch.parallel import mesh

    W = group.size
    if name.startswith(("a_", "b_")):
        part = mesh.VertexPartition(inputs["flickr_degrees"], W)
        opt = Optimizer(**(SGD_FLICKR if name.startswith("a_")
                           else ADAM_FLICKR))
        tr = mesh.ShardedGraphTrainer(
            group, part, DIM, GRAPH_MODELS["LINE"], opt, num_negative=1,
            negative_weight=5.0, batch_size=MESH_EDGE_BATCH,
            ep_batches=ep_batches, sampler_mode="edges", pool_size=128,
            trust=0.25)
        return tr, tr.build_blocks(None, inputs["flickr_tables"])
    if name.startswith("c_"):
        yt = inputs["youtube"]
        part = mesh.VertexPartition(yt.degrees, W)
        tr = mesh.ShardedGraphTrainer(
            group, part, DIM, GRAPH_MODELS["DeepWalk"],
            Optimizer(**SGD_YOUTUBE), num_negative=1, negative_weight=5.0,
            batch_size=MESH_WALK_BATCH, ep_batches=ep_batches,
            sampler_mode="walks", trust=0.25,
            walk_cfg=dict(augmentation_step=5, walk_length=40,
                          batch_walks=MESH_WALK_BATCH // 410, bidir=True,
                          pool_size=64))
        return tr, tr.build_sample_state(yt)
    import torch

    part = mesh.VertexPartition(inputs["kg_degrees"], 2 * W)
    pooled = name.startswith("d_")
    tr = kg_mod.ShardedKGTrainer(
        group, part, KG_BIG_DIM, KG_MODELS["RotatE"],
        Optimizer(**SGD_WIKIDATA5M), num_negative=64, margin_or_l3=6.0,
        adversarial_temperature=0.2, relation_lr_multiplier=1.0,
        batch_size=MH_KG_BATCH[name[0]], ep_batches=ep_batches,
        negative_pool="pooled" if pooled else "global",
        pool_size=0 if pooled else None, trust=0.25)
    blocks = kg_mod.TripletBlocks.__new__(kg_mod.TripletBlocks)
    blocks.block_off = inputs["kg_block_off"]
    blocks.arrays = {d: tuple(torch.from_numpy(a).to(d)
                              for a in inputs["kg_arrays"])
                     for d in group.distinct}
    return tr, blocks


def mh_run_case(case, group, inputs, seed):
    """One case of MH_CASES on `group` (W = 2 workers in this process, or
    this process's share of them): the episodes timed from a synchronized
    start to a synchronized end, the kernels' launch counts set to 0 just
    before and read just after, the cross-process traffic, and the
    digests of every local worker's state and losses and of the gathered
    tables (edges and walks)."""
    import torch

    name, worker_batches, episodes, _ = case
    W = group.size
    per_worker = worker_batches // W
    ep = per_worker // episodes
    t0 = time.perf_counter()
    tr, sample = mh_engine(name, group, inputs, ep)
    kg = name.startswith(("d_", "e_"))
    if kg:
        v, r = inputs["kg_sizes"]
        ent = mh_table(v, KG_BIG_DIM, seed, -0.05, 0.05, group.home)
        rel = mh_table(r, KG_BIG_DIM, seed + 1, -3.0, 3.0, group.home)
        state = tr.init_state(ent, rel)
        del ent, rel
        neg = None
    else:
        v = int(np.asarray(tr.partition.part_of).size)
        state = tr.init_state(
            mh_table(v, DIM, seed, -0.5 / DIM, 0.5 / DIM, group.home),
            mh_table(v, DIM, seed + 1, -0.5 / DIM, 0.5 / DIM, group.home))
        weights = (inputs["youtube"].vertex_weights if name.startswith("c_")
                   else inputs["flickr_vertex_weights"])
        neg = tr.init_negative_state(weights)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    comm0 = dict(group.comm)
    reset_launches()
    losses = []
    t0 = time.perf_counter()
    for e in range(episodes):
        if kg:
            state, ls = tr.run_episode(state, sample, e * ep * W,
                                       worker_batches, seed)
        else:
            state, neg, ls = tr.run_episode(state, sample, neg, e * ep * W,
                                            worker_batches, seed)
        losses.append(ls)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    counts = read_launches()
    comm = {k: group.comm[k] - comm0[k] for k in comm0}
    workers = {}
    hashing = concurrent.futures.ThreadPoolExecutor(4)  # sha256 frees the GIL
    for i in group.local:
        if kg:
            tensors = ([state["arena"][i], state["rel"][i]]
                       + list(state["arena_moms"][i]))
        else:
            s = state[i]
            tensors = (list(s["tables"]) + [m for side in s["moments"]
                                            for m in side])
        tensors += [ls[i] for ls in losses]
        workers[str(i)] = list(hashing.map(digest, tensors))
    rec = {"case": name, "workers": W, "local": list(group.local),
           "transport": group.transport, "worker_batches": worker_batches,
           "episodes": episodes, "setup_s": setup_s, "loop_s": loop_s,
           "launches": counts, "comm": comm, "digests": workers,
           "losses_finite": all(bool(torch.isfinite(ls[i]).all())
                                for ls in losses for i in group.local)}
    if name.startswith(("a_", "c_")):
        rec["gathered"] = list(hashing.map(digest, tr.gather_tables(state)))
    hashing.shutdown()
    if name.startswith("c_"):
        rec["requests"] = list(tr.drop_counts())
        rec["valid_pairs"] = tr.valid_pairs()
    del state, sample, tr
    torch.cuda.empty_cache()
    return rec


def multihost_child(root, pid, port, device, cases, seed):
    """A process of the multihost phase: `device` ("{pid}" in it stands for
    this process's index) holds its one worker; every case named in
    `cases` in order; the records written to root/child_PID.json."""
    os.environ["GRAPHVITE_COORDINATOR"] = "localhost:%s" % port
    os.environ["GRAPHVITE_NUM_PROCESSES"] = str(MH_WORKERS)
    os.environ["GRAPHVITE_PROCESS_ID"] = str(pid)
    from graphvite_tpu_torch.parallel import mesh

    inputs = mh_load_inputs(root)
    recs = {}
    for case in MH_CASES:
        if case[0] in cases.split(","):
            group = mesh.DeviceGroup([device.format(pid=pid)])
            recs[case[0]] = mh_run_case(case, group, inputs, seed)
            log("   process %d, %s: %.1f s, transport %s" % (
                pid, case[0], recs[case[0]]["loop_s"],
                recs[case[0]]["transport"]))
    recs["gloo_probe"] = mh_gloo_probe()
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
    if loaded:
        raise AssertionError("a process loaded %r" % loaded)
    with open(os.path.join(root, "child_%d.json" % pid), "w") as f:
        json.dump(recs, f)
    return 0


def mh_gloo_probe(nbytes=256 << 20, reps=2):
    """gloo's own rate between the two processes: a host buffer of
    `nbytes` sent and sent back `reps` times, pageable and pinned
    (GB/s of one direction)."""
    import torch
    import torch.distributed as dist

    out = {}
    rank = dist.get_rank()
    for pinned in (False, True)[:1 + torch.cuda.is_available()]:
        x = torch.zeros(nbytes, dtype=torch.uint8, pin_memory=pinned)
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            if rank == 0:
                dist.send(x, 1)
                dist.recv(x, 1)
            else:
                dist.recv(x, 0)
                dist.send(x, 0)
        out["pinned" if pinned else "pageable"] = (
            2 * reps * nbytes / (time.perf_counter() - t0) / 1e9)
    return out


def mh_spawn(root, device, cases, seed):
    """Run the two processes of the phase (this script with
    --multihost-child) to their end: a shared deadline, and the other
    killed as soon as one fails. Returns [(exit code, log tail)] and
    their records."""
    import socket

    s = socket.socket()
    s.bind(("localhost", 0))
    port = str(s.getsockname()[1])
    s.close()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("GRAPHVITE_COORDINATOR")}
    env["PYTHONPATH"] = HERE
    logs = [open(os.path.join(root, "child_%d.log" % pid), "w+")
            for pid in range(MH_WORKERS)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "chip_smoke.py"), "--seed",
         str(seed), "--multihost-child", root, str(pid), port, device,
         ",".join(cases)], stdout=logs[pid], stderr=subprocess.STDOUT,
        env=env, cwd=HERE) for pid in range(MH_WORKERS)]
    deadline = time.monotonic() + MH_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            if (any(p.poll() not in (None, 0) for p in procs)
                    or time.monotonic() > deadline):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    runs, recs = [], []
    for pid, (p, f) in enumerate(zip(procs, logs)):
        f.seek(0)
        runs.append((p.returncode, f.read()[-4000:]))
        f.close()
        path = os.path.join(root, "child_%d.json" % pid)
        if os.path.exists(path):
            with open(path) as fh:
                recs.append(json.load(fh))
        else:
            recs.append({})
    return runs, recs


def mh_compare(case, one, recs):
    """The two processes' records of `case` against the one-process
    group's: the same digests worker by worker and of the gathered tables,
    the same launches per worker-batch. Returns (record, problems)."""
    name, worker_batches, episodes, per_batch = case
    problems = []
    got = [r.get(name) for r in recs]
    if any(g is None for g in got):
        return {}, ["%s: a process made no record" % name]
    equal = all(g["digests"][str(i)] == one["digests"][str(i)]
                for g in got for i in g["local"])
    if "gathered" in one:
        equal = equal and all(g["gathered"] == one["gathered"] for g in got)
    if name.startswith("c_"):
        equal = equal and all(g["requests"] == one["requests"]
                              and g["valid_pairs"] == one["valid_pairs"]
                              for g in got)
    launches = {}
    for fn in one["launches"]:
        launches[fn] = sum(g["launches"][fn] for g in got)
    want = {fn: per_batch.get(fn, 0) * worker_batches for fn in launches}
    if launches != want:
        problems.append("%s: launches %r over both processes, want %r"
                        % (name, launches, want))
    if one["launches"] != want:
        problems.append("%s: one process launched %r, want %r"
                        % (name, one["launches"], want))
    if not equal:
        problems.append("%s: two processes differ from one" % name)
    if not all(g["losses_finite"] for g in got) or not one["losses_finite"]:
        problems.append("%s: losses not finite" % name)
    loop_s = max(g["loop_s"] for g in got)
    rec = {"bit_equal": equal, "transport": got[0]["transport"],
           "worker_batches": worker_batches, "episodes": episodes,
           "one_process": {
               "ms_per_worker_batch": one["loop_s"] / worker_batches * 1e3,
               "loop_s": one["loop_s"], "setup_s": one["setup_s"]},
           "two_processes": {
               "ms_per_worker_batch": loop_s / worker_batches * 1e3,
               "loop_s": [g["loop_s"] for g in got],
               "setup_s": [g["setup_s"] for g in got],
               "cross_process_s_per_episode": [
                   g["comm"]["seconds"] / episodes for g in got],
               "staging_s_per_episode": [
                   g["comm"]["stage_s"] / episodes for g in got],
               "cross_process_bytes_per_episode": [
                   g["comm"]["bytes"] / episodes for g in got],
               "exchanges": [g["comm"]["exchanges"] for g in got]},
           "launches": launches,
           "launches_per_worker_batch": {fn: c / worker_batches
                                         for fn, c in launches.items() if c}}
    return rec, problems


def multihost_phase(seed, shared):
    """The multi-device engines over two processes on the card
    (GRAPHVITE_COORDINATOR; two ranks on cuda:0, so the gloo transport
    with pinned host staging), each case against the same engine as one
    process with two workers on cuda:0 from the same seed: bit for bit,
    the same launches per worker-batch. Where there are two cards, case
    (a) again with one process per card (NCCL) against one process with
    a worker on each."""
    import torch
    from graphvite_tpu_torch.parallel import mesh

    root = tempfile.mkdtemp(prefix="chip_smoke_multihost_")
    out, problems = {}, []
    try:
        t0 = time.perf_counter()
        out["setup"] = mh_write_inputs(root, shared)
        out["setup"]["write_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        inputs = mh_load_inputs(root)
        one = {}
        for case in MH_CASES:
            group = mesh.DeviceGroup([MH_DEVICE] * MH_WORKERS)
            one[case[0]] = mh_run_case(case, group, inputs, seed)
        del inputs
        torch.cuda.empty_cache()
        out["setup"]["one_process_s"] = time.perf_counter() - t0
        names = [c[0] for c in MH_CASES]
        t0 = time.perf_counter()
        runs, recs = mh_spawn(root, MH_DEVICE, names, seed)
        out["setup"]["two_processes_s"] = time.perf_counter() - t0
        out["gloo_probe_gb_per_s"] = [r.get("gloo_probe") for r in recs]
        log("   set-up and wall seconds:", json.dumps(out["setup"]))
        log("   gloo between the processes, GB/s one way:",
            json.dumps(out["gloo_probe_gb_per_s"]))
        for pid, (rc, tail) in enumerate(runs):
            if rc != 0:
                problems.append("process %d exited %s:\n%s" % (pid, rc,
                                                              tail))
        for case in MH_CASES:
            rec, bad = mh_compare(case, one[case[0]], recs)
            log("   (%s) two processes on cuda:0:" % case[0],
                json.dumps(rec))
            out[case[0]] = rec
            problems += bad
        out["transport"] = "gloo: two processes on cuda:0"
        log("   transport: %s" % out["transport"])
        if torch.cuda.device_count() >= 2:
            inputs = mh_load_inputs(root)
            group = mesh.DeviceGroup(["cuda:0", "cuda:1"])
            one_nccl = mh_run_case(MH_CASES[0], group, inputs, seed)
            del inputs
            torch.cuda.empty_cache()
            runs, recs = mh_spawn(root, "cuda:{pid}", [MH_CASES[0][0]],
                                  seed)
            for pid, (rc, tail) in enumerate(runs):
                if rc != 0:
                    problems.append("NCCL process %d exited %s:\n%s"
                                    % (pid, rc, tail))
            rec, bad = mh_compare(MH_CASES[0], one_nccl, recs)
            log("   (%s) one process per card:" % MH_CASES[0][0],
                json.dumps(rec))
            out["nccl_" + MH_CASES[0][0]] = rec
            problems += ["NCCL " + p for p in bad]
            if rec and rec["transport"] != "nccl":
                problems.append("one process per card took %s"
                                % rec["transport"])
        else:
            out["nccl"] = "not exercised: one card"
            log("   NCCL not exercised: torch sees one card")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if problems:
        raise AssertionError("; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# phase 15: the host sampler backend
# ---------------------------------------------------------------------------

HOST_EPISODE = 8


def train_host(app_cls, graph, app_kw, build_kw, train_kw, batches, eff,
               per_batch, record=0):
    """`batches` batches of a solver on sampler_backend="host" (episodes
    of HOST_EPISODE), the launch counts set to 0 just before train() and
    read just after: ms/batch, the seconds the sampler thread spent making
    pools against the loop's, the share of the loop spent waiting on
    PrefetchingPool.next, kernel launches per batch against `per_batch`
    (the step family the reference's host route trains); the first
    `record` table updates of the run (kernel cases)."""
    import torch

    app = app_cls(**app_kw)
    app.solver.sampler_backend = "host"
    app.graph = graph
    app.build(episode_size=HOST_EPISODE, **build_kw)
    s = app.solver
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    calls = []
    t0 = time.perf_counter()
    with recording_updates(calls, limit=record):
        app.train(num_epoch=batches * eff / graph.num_edge + 1e-9,
                  **train_kw)
    elapsed = time.perf_counter() - t0
    counts = read_launches()
    st = s.host_stats
    run = s.batch_id
    losses = s.batch_losses.double()
    rec = {"batches": run, "batch": s.effective_batch,
           "ep_batches": st["ep_batches"], "pools": st["pools"],
           "elapsed_s": elapsed, "loop_s": st["loop_s"],
           "ms_per_batch": st["loop_s"] / run * 1e3,
           "samples_per_s": run * s.effective_batch / st["loop_s"],
           "pool_produce_s": st["produce_s"], "wait_s": st["wait_s"],
           "wait_share": st["wait_s"] / st["loop_s"],
           "launches": counts,
           "launches_per_batch": {n: c / run for n, c in counts.items()
                                  if c},
           "loss_first": float(losses[:3].mean()),
           "loss_last": float(losses[-3:].mean()),
           "losses_finite": bool(torch.isfinite(losses).all()),
           "tables_on": str(s.state["tables"][0].device),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    # the device's share: the loop less what it waited for pools
    rec["device_s"] = rec["loop_s"] - rec["wait_s"]
    rec["host_bound"] = rec["pool_produce_s"] > rec["device_s"]
    problems = []
    want = {n: per_batch.get(n, 0) * run for n in counts}
    if counts != want:
        problems.append("kernel launches %r, want %r" % (counts, want))
    if s.effective_batch != eff or run < batches:
        problems.append("%d batches of %d, want %d of %d"
                        % (run, s.effective_batch, batches, eff))
    if not rec["losses_finite"] or rec["tables_on"] != "cuda:0":
        problems.append("losses not finite, or tables on %s"
                        % rec["tables_on"])
    return app, rec, calls, problems


def host_phase(seed, shared):
    """sampler_backend="host" (episodes of HOST_EPISODE batches) on the
    graphs earlier phases built: LINE at the line_flickr.yaml shape (100
    batches), DeepWalk at the deepwalk_youtube.yaml shape (24), RotatE at
    the rotate_wikidata5m.yaml shape (SGD, 24; and Adam lr 1e-6 wd 0, 8:
    kernel 2's path), LargeVis on the MNIST clone (100). Each on the step
    family of the reference's host route: the pair pool step (kernel 1
    on each table, no sweeps), the KG pooled step (kernel 1 twice, or
    kernel 2 once with the relations on the dense route), the LargeVis
    pooled step (Adam: the dense route). The first batch's updates of
    LINE and RotatE are kept for the kernel phase. node2vec's
    second-order table at the Youtube shape is only counted: it has one
    entry per (edge, neighbour of the tail)."""
    from graphvite_tpu_torch import (GraphApplication,
                                     KnowledgeGraphApplication,
                                     VisualizationApplication)
    from graphvite_tpu_torch.sampler import second_order_entries

    import torch

    out, problems = {"ids": {}}, []
    runs = (
        ("line_flickr", GraphApplication, shared["flickr"], dict(dim=DIM),
         dict(optimizer=SGD_FLICKR, num_negative=1, batch_size=100000),
         dict(model="LINE", augmentation_step=1, negative_weight=5.0,
              log_frequency=10**9), 100, 100000, {"scatter_add_": 2},
         ("vertex", "context")),
        ("deepwalk_youtube", GraphApplication, shared["youtube"],
         dict(dim=DIM), dict(optimizer=SGD_YOUTUBE, num_negative=1,
                             batch_size=100000),
         dict(model="DeepWalk", augmentation_step=5, random_walk_length=40,
              negative_weight=5.0, log_frequency=10**9), 24, 100000,
         {"scatter_add_": 2}, ()),
        ("rotate_wikidata5m", KnowledgeGraphApplication,
         shared["wikidata5m"], dict(dim=KG_BIG_DIM),
         dict(optimizer=SGD_WIKIDATA5M, num_negative=64,
              batch_size=100000), ROTATE_WIKIDATA5M, 24, 100000,
         {"scatter_add_": 2}, ("entity", "relation")),
        ("rotate_wikidata5m_adam", KnowledgeGraphApplication,
         shared["wikidata5m"], dict(dim=KG_BIG_DIM),
         dict(optimizer=ADAM_WIKIDATA5M, num_negative=64,
              batch_size=100000), ROTATE_WIKIDATA5M, 8, 100000,
         {"scatter_update_": 1}, ("entity",)),
        ("largevis_mnist", VisualizationApplication, shared["mnist"][0],
         dict(dim=2), dict(optimizer=ADAM_VIS, num_negative=5,
                           batch_size=100000),
         dict(LARGEVIS), 100, 100000, {}, ()))
    for (name, cls, graph, app_kw, build_kw, train_kw, n, eff, per,
         keep) in runs:
        app, rec, calls, bad = train_host(cls, graph, app_kw, build_kw,
                                          train_kw, n, eff, per,
                                          record=len(keep))
        log("   %s:" % name, json.dumps(rec))
        out[name] = rec
        problems += ["%s: %s" % (name, p) for p in bad]
        if keep:
            out["ids"]["host " + name] = list(zip(keep, calls))
        del app, calls
        torch.cuda.empty_cache()
    entries = second_order_entries(shared["youtube"])
    out["node2vec_youtube_second_order_entries"] = entries
    log("   node2vec at the Youtube shape: %d second-order entries (%.1f GB "
        "of float64 weights and int64 aliases): not built"
        % (entries, entries * 16 / 1e9))
    if problems:
        raise AssertionError("; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# phase 17: quality
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


def quality(model="DeepWalk", device=None, classic=False, blocked=False,
            host=False):
    """Two-block link prediction and node classification through
    GraphApplication: DeepWalk or node2vec (p 4, q 2; augmentation 2, the
    unfused trust-clip walk route), or LINE (augmentation 1, the edge route
    on a table below the dense-update size: the trust clip on the
    scatter-add), with the protocols of tests/test_solver.py. `classic`:
    the classic K-draw step (GRAPHVITE_NEG_SHARING=0) on walk pairs.
    `blocked` (LINE): blocked episodes over 4 partitions with the host
    master (GRAPHVITE_HOST_MASTER=1), so evaluation scores the tables in
    host memory. `host`: sampler_backend="host" (the pair step over
    batch_size, no micro-steps; node2vec's second-order table built on
    the host, its entries counted)."""
    from graphvite_tpu_torch import GraphApplication
    from graphvite_tpu_torch.sampler import second_order_entries

    edges = two_blocks()
    app = GraphApplication(dim=16, device=device)
    if host:
        app.solver.sampler_backend = "host"
    app.load(edge_list=edges)
    if model in ("DeepWalk", "node2vec"):
        app.build(optimizer={"type": "SGD", "lr": 0.1, "weight_decay": 5e-3},
                  num_negative=1, batch_size=2048, episode_size=8)
        kw = dict(num_epoch=2000, augmentation_step=2, random_walk_length=8)
        if model == "node2vec":
            kw.update(p=4.0, q=2.0)
    else:
        app.build(num_negative=2, batch_size=512, episode_size=8,
                  num_partition=4 if blocked else 0)
        kw = dict(num_epoch=1000, augmentation_step=1)
    env = {"GRAPHVITE_NEG_SHARING": "0"} if classic else {}
    if blocked:
        env["GRAPHVITE_HOST_MASTER"] = "1"
    reset_launches()
    with environ(env):
        app.train(model=model, negative_weight=1.0, log_frequency=10**9,
                  **kw)
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
    return {"model": model, "classic": classic, "auc": auc,
            "micro_f1": nc["micro-F1@50%"], "fused_arena": s._banded_fused,
            "sweeps": [s._sweep_gather, s._sweep_scatter, s._sweep_context],
            "batches": s.batch_id,
            "micro_steps": 1 if host else s._batch_plan()[2],
            "blocked": blocked, "host": host,
            "second_order_entries": (second_order_entries(g)
                                     if host and model == "node2vec"
                                     else None),
            "state_device": s.state["tables"][0].device.type,
            "launches": launches,
            "chain_launches_want": (s.batch_id if model == "DeepWalk"
                                    and not host else 0),
            "band_launches_want": walk_band_launches(s, s.batch_id)}


# ---------------------------------------------------------------------------
# phase 18: the command line
# ---------------------------------------------------------------------------

# tools/blogcatalog_clone.py: BlogCatalog's published statistics
BLOGCATALOG_V = 10_312
BLOGCATALOG_E = 333_983
BLOGCATALOG_COMMUNITIES = 39
BLOGCATALOG_MIXING = 0.25     # fraction of stubs wired to the background
# tools/word_graph_e2e.py: the planted-topic corpus
# 5M tokens (the gate holds at 5M and at 10M): a corpus that keeps the
# whole smoke, blocked phase included, under 1,000 s on a slow host
CORPUS_TOKENS = 3_000_000
CORPUS_VOCAB = 100_000
CORPUS_TOPICS = 50


def blogcatalog_clone(seed):
    """A planted-community graph with BlogCatalog's statistics (10,312
    vertices, 39 overlapping communities, power-law degrees scaled to
    333,983 undirected edges, of which 206,311 are distinct at seed 0, a
    quarter of the stubs wired globally): this script's copy of
    tools/blogcatalog_clone.py:generate. Returns the sorted (u < v) edges
    [E, 2] and the memberships [V, 39]."""
    V, C = BLOGCATALOG_V, BLOGCATALOG_COMMUNITIES
    rng = np.random.default_rng(seed)
    deg = np.maximum((rng.pareto(1.2, V) + 1) * 2, 2)
    deg = np.floor(deg * (2.0 * BLOGCATALOG_E / deg.sum())).astype(np.int64)
    deg = np.maximum(deg, 2)
    comm_w = np.arange(1, C + 1) ** -0.7
    comm_w /= comm_w.sum()
    labels = np.zeros((V, C), np.int64)
    for v in range(V):
        k = 1 + (rng.random() < 0.4)
        labels[v, rng.choice(C, size=k, replace=False, p=comm_w)] = 1
    num_member = labels.sum(axis=1)
    edges = set()

    def add_pairs(pool_v, pool_deg, n_pairs):
        if pool_v.size < 2 or n_pairs <= 0:
            return
        p = pool_deg / pool_deg.sum()
        a = rng.choice(pool_v, size=n_pairs, p=p)
        b = rng.choice(pool_v, size=n_pairs, p=p)
        for u, w in zip(a.tolist(), b.tolist()):
            if u != w:
                edges.add((min(u, w), max(u, w)))

    for c in range(C):
        m = np.nonzero(labels[:, c])[0]
        if m.size < 2:
            continue
        intra = deg[m] * (1 - BLOGCATALOG_MIXING) / np.maximum(
            num_member[m], 1)
        add_pairs(m, deg[m].astype(np.float64), int(intra.sum() / 2))
    add_pairs(np.arange(V), deg.astype(np.float64),
              int(deg.sum() * BLOGCATALOG_MIXING / 2))
    return np.asarray(sorted(edges), dtype=np.int64), labels


def topic_corpus(path, n_tokens, vocab, seed, sent_len=20,
                 topic_purity=0.7):
    """A corpus with planted topics: sentences of `sent_len` words, each
    sentence of one of 50 topics, each word's topic drawn once, Zipf
    unigram frequencies, 70% of a sentence's words from its topic: this
    script's copy of tools/word_graph_e2e.py:write_corpus. Returns each
    word's topic."""
    rng = np.random.default_rng(seed)
    freq = 1.0 / (np.arange(1, vocab + 1) ** 1.05)
    freq /= freq.sum()
    word_topic = rng.integers(0, CORPUS_TOPICS, vocab)
    topic_words = [np.flatnonzero(word_topic == t)
                   for t in range(CORPUS_TOPICS)]
    topic_p = [freq[tw] / freq[tw].sum() for tw in topic_words]
    n_sent = n_tokens // sent_len
    chunk = 20000
    with open(path, "w") as f:
        for lo in range(0, n_sent, chunk):
            m = min(chunk, n_sent - lo)
            topics = rng.integers(0, CORPUS_TOPICS, m)
            rows = []
            for t in range(CORPUS_TOPICS):
                idx = np.flatnonzero(topics == t)
                if not idx.size:
                    continue
                pure = rng.random((idx.size, sent_len)) < topic_purity
                in_topic = topic_words[t][rng.choice(
                    topic_words[t].size, (idx.size, sent_len),
                    p=topic_p[t])]
                backgr = rng.choice(vocab, (idx.size, sent_len), p=freq)
                words = np.where(pure, in_topic, backgr)
                rows += zip(idx.tolist(), words.tolist())
            rows.sort()
            f.write("".join(" ".join("w%d" % w for w in row) + "\n"
                            for _, row in rows))
    return word_topic


def topic_probe(emb, name2id, word_topic, seed):
    """The word-graph tool's probe: mean cosine of same-topic pairs among
    each topic's 200 most frequent words, and of random word pairs."""
    emb = np.asarray(emb, np.float64)
    emb = emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-9)
    rng = np.random.default_rng(seed)
    same, rand = [], []
    for _ in range(2000):
        tw = np.flatnonzero(word_topic == rng.integers(CORPUS_TOPICS))[:200]
        a, b = ("w%d" % x for x in rng.choice(tw, 2, replace=False))
        if a in name2id and b in name2id:
            same.append(float(emb[name2id[a]] @ emb[name2id[b]]))
        x, y = ("w%d" % x for x in rng.choice(word_topic.size, 2,
                                              replace=False))
        if x in name2id and y in name2id:
            rand.append(float(emb[name2id[x]] @ emb[name2id[y]]))
    return float(np.mean(same)), float(np.mean(rand))


@contextlib.contextmanager
def no_downloads():
    """Every split the cli phase reads is written or generated locally
    first; a download would mean a misplaced file, so it fails the run
    instead of reaching for the network."""
    from graphvite_tpu_torch import dataset

    def refuse(self, url):
        raise AssertionError("the smoke downloads nothing (%s: %s is not "
                             "under %s)" % (self.name, url, self.path))
    old = dataset.Dataset.download
    dataset.Dataset.download = refuse
    try:
        yield
    finally:
        dataset.Dataset.download = old


def cli_config(name, root, cuts=()):
    """Copy config/<name> into `root` with its `save:` path moved there and
    each (old, new) of `cuts` replaced (each must occur once); returns the
    copy's path."""
    with open(os.path.join(HERE, "config", name)) as f:
        text = f.read()
    save = re.search(r"^save:\n  file_name: (\S+)$", text, re.M)
    cuts = list(cuts) + [(save.group(0), "save:\n  file_name: %s"
                          % os.path.join(root, save.group(1)))]
    for old, new in cuts:
        if text.count(old) != 1:
            raise AssertionError("%r occurs %d times in %s"
                                 % (old, text.count(old), name))
        text = text.replace(old, new)
    path = os.path.join(root, os.path.basename(name))
    with open(path, "w") as f:
        f.write(text)
    return path


def run_cli(path):
    """One config through the port's CLI on the card: cmd.load_config (the
    dataset splits are made there), then cmd.run_config with the kernels'
    launch counts set to 0 just before it and read just after. Returns
    the loaded config, the application, the evaluation results and the
    record."""
    import torch
    from graphvite_tpu_torch import cmd

    t0 = time.perf_counter()
    cfg = cmd.load_config(path)
    config_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    app, results = cmd.run_config(cfg)
    run_s = time.perf_counter() - t0
    launches = read_launches()
    s = app.solver
    stages = {k: v["total_s"] for k, v in app.monitor.summary().items()}
    losses = s.batch_losses.double()
    k = max(s.batch_id // 10, 5)
    k1 = launches["scatter_add_"] + launches["scatter_add_sorted_"]
    rec = {"config": os.path.basename(path), "load_config_s": config_s,
           "run_config_s": run_s, "stages_s": stages,
           "batches": s.batch_id, "effective_batch": s.effective_batch,
           "ms_per_batch": stages["train"] / s.batch_id * 1e3,
           "samples_per_s": s.batch_id * s.effective_batch / stages["train"],
           "launches": launches, "k1_per_batch": k1 / s.batch_id,
           "loss_first": float(losses[:k].mean()),
           "loss_last": float(losses[-k:].mean()),
           "losses_finite": bool(torch.isfinite(losses).all()),
           "tables_finite": all(bool(torch.isfinite(t.float()).all())
                                for t in s.state["tables"]),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "saved": os.path.isfile(cfg["save"]["file_name"])}
    problems = []
    if not (rec["losses_finite"] and rec["tables_finite"]):
        problems.append("losses or tables not finite")
    if not rec["loss_last"] < rec["loss_first"]:
        problems.append("the loss did not fall")
    if not rec["saved"]:
        problems.append("no model saved at %s" % cfg["save"]["file_name"])
    return cfg, app, results, rec, problems


def trace_and_update_ids(app, cfg, rec, batches=10):
    """A trace of `batches` more batches of the config's own training
    call (it starts the tables afresh, so it runs after the checks), then
    the ids of kernel 1's calls in one more batch: [(ids, table rows)],
    recorded where optim.apply_row_updates launches it."""
    from graphvite_tpu_torch import optim

    s = app.solver
    kw = {k: v for k, v in cfg["train"].items() if k != "num_epoch"}
    rec["trace"] = trace_episode(s, kw, batches)
    calls, launch = [], optim.scatter_add_

    def record(table, ids, upd):
        calls.append((ids.clone(), table.shape[0]))
        return launch(table, ids, upd)
    optim.scatter_add_ = record
    try:
        s.train(num_epoch=s.effective_batch / s.graph.num_edge + 1e-9, **kw)
    finally:
        optim.scatter_add_ = launch
    return calls


def quick_start_cli(root, seed):
    """config/demo/quick_start.yaml cut to 600 of its 2000 epochs (a
    depth cut; the AUC gate stays at 0.85)
    through the CLI, on the BlogCatalog clone written as the registry's
    raw graph and label files: the registry makes <blogcatalog.train|test>
    with its 100:1:1 link-prediction split, the config evaluates link
    prediction and node classification."""
    t0 = time.perf_counter()
    edges, labels = blogcatalog_clone(seed)
    data = os.path.join(root, "blogcatalog")
    os.makedirs(data, exist_ok=True)
    with open(os.path.join(data, "blogcatalog_graph.txt"), "w") as f:
        f.write("".join("%d\t%d\n" % e for e in map(tuple, edges.tolist())))
    vs, cs = np.nonzero(labels)
    with open(os.path.join(data, "blogcatalog_label.txt"), "w") as f:
        f.write("".join("%d\t%d\n" % x
                        for x in zip(vs.tolist(), cs.tolist())))
    clone_s = time.perf_counter() - t0
    cfg, app, results, rec, problems = run_cli(
        cli_config("demo/quick_start.yaml", root,
                   cuts=[("num_epoch: 2000", "num_epoch: 600")]))
    s = app.solver
    rec.update({"clone_s": clone_s, "edges": int(len(edges)),
                "vertices": app.graph.num_vertex,
                "train_edges": app.graph.num_edge,
                "fused_arena": s._banded_fused,
                "auc": results[0]["AUC"],
                "micro_f1_20": results[1]["micro-F1@20%"],
                "macro_f1_20": results[1]["macro-F1@20%"]})
    if not rec["auc"] >= 0.85:
        problems.append("link-prediction AUC %.4f < 0.85" % rec["auc"])
    if not rec["k1_per_batch"] >= 1:
        problems.append("kernel 1 launched %r in %d batches"
                        % (rec["launches"], rec["batches"]))
    chains = walk_chain_launches(s, s.batch_id)
    if not chains or rec["launches"]["walk_chain"] != chains:
        problems.append("walk chain launched %r in %d batches, want %d"
                        % (rec["launches"], rec["batches"], chains))
    bands = walk_band_launches(s, s.batch_id)
    if rec["launches"]["walk_band"] != bands:
        problems.append("band launched %r in %d batches, want %d"
                        % (rec["launches"], rec["batches"], bands))
    return rec, problems, trace_and_update_ids(app, cfg, rec)


def math_cli(root):
    """config/demo/math.yaml through the CLI, cut to dim 128 and 500
    epochs: filtered tail ranking of the offline math fixture's test
    split."""
    cfg, app, results, rec, problems = run_cli(cli_config(
        "demo/math.yaml", root, (("dim: 512", "dim: 128"),
                                 ("num_epoch: 2000", "num_epoch: 500"))))
    s = app.solver
    rec.update({"model": s.model, "dim": s.dim,
                "plan": list(s._batch_plan()), "pooled": s._pooled_step,
                **results[0]})
    if not rec["MRR"] >= 0.60:
        problems.append("filtered tail MRR %.4f < 0.60" % rec["MRR"])
    return rec, problems, []


def word_graph_cli(root, seed, tokens):
    """config/word_graph/line_wikipedia.yaml at its 80 epochs through the
    CLI, on a planted-topic corpus written as the registry's Wikipedia
    corpus: the word graph's host build, LINE on the edge route (kernel 1
    on the small-table SGD update), the saved model reloaded through
    load_model."""
    from graphvite_tpu_torch import Application

    data = os.path.join(root, "wikipedia")
    os.makedirs(data, exist_ok=True)
    t0 = time.perf_counter()
    word_topic = topic_corpus(os.path.join(data, "wikipedia_graph.txt"),
                              tokens, CORPUS_VOCAB, seed)
    corpus_s = time.perf_counter() - t0
    cfg, app, results, rec, problems = run_cli(
        cli_config("word_graph/line_wikipedia.yaml", root))
    g, s = app.graph, app.solver
    same, rand = topic_probe(s.vertex_embeddings, g.name2id, word_topic,
                             seed + 1)
    rec.update({"tokens": tokens, "corpus_s": corpus_s,
                "graph_s": rec["stages_s"]["load"],
                "vocabulary": g.num_vertex, "edges": g.num_edge,
                "sweeps": [s._sweep_gather, s._sweep_scatter,
                           s._sweep_context],
                "same_topic_cos": same, "random_pair_cos": rand})
    if not same - rand >= 0.2:
        problems.append("same-topic cosine %.4f - random %.4f < 0.2"
                        % (same, rand))
    if not rec["k1_per_batch"] >= 1:
        problems.append("kernel 1 launched %r in %d batches"
                        % (rec["launches"], rec["batches"]))
    # the saved model, reloaded on the card over the same graph
    again = Application(cfg["application"], **cfg["resource"])
    again.graph = g
    again.solver.build(g)
    again.load_model(cfg["save"]["file_name"])
    pairs = np.random.default_rng(seed).integers(g.num_vertex, size=(4096, 2))
    rec["reload_equal"] = bool(np.array_equal(s.predict(pairs),
                                              again.solver.predict(pairs)))
    if not rec["reload_equal"]:
        problems.append("the reloaded model predicts other scores")
    del again
    return rec, problems, trace_and_update_ids(app, cfg, rec)


def cli_list():
    """`python3 -m graphvite_tpu_torch.cmd list` in a process of its own:
    argv, the module's entry point and the baseline walk."""
    out = subprocess.run([sys.executable, "-m", "graphvite_tpu_torch.cmd",
                          "list"], cwd=HERE, capture_output=True, text=True,
                         timeout=300, check=True).stdout
    want = sum(len([f for f in files if f.endswith(".yaml")])
               for path, _, files in os.walk(os.path.join(HERE, "config"))
               if os.path.basename(path) != "template")
    last = out.strip().splitlines()[-1]
    if last != "total: %d baselines" % want or "quick_start.yaml" not in out:
        raise AssertionError("cmd list printed %r" % out[-500:])
    return {"baselines": want}


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


# ---------------------------------------------------------------------------
# phase row_access: the row-access bench and its three kernels
# ---------------------------------------------------------------------------

# the reference experiment's shape (tools/pallas_bench.py: V, D, N)
ROW_ACCESS_SHAPE = (1_000_000, 128, 325_520)
# the shapes its kernels leave out: N not a multiple of 512; V not a
# multiple of 8192 (as at the reference's own V) with a width below one
# 4-column vector pass
ROW_ACCESS_EDGES = ((1_000_000, 128, 325_519), (4_099, 20, 1_001))


def row_access_bench_run():
    """Every experiment of graphvite_tpu_torch.tools.row_access_bench at
    the reference's shape (PB_V, PB_D, PB_N unset), in this process, the
    launch counts set to 0 just before and read just after. Returns (the
    bench's records, the counts)."""
    import io
    import torch
    from graphvite_tpu_torch.tools import row_access_bench as rab

    for name in ("PB_V", "PB_D", "PB_N"):
        os.environ.pop(name, None)
    out = io.StringIO()
    bench = rab.Bench("cuda", out=out)
    if (bench.V, bench.D, bench.N) != ROW_ACCESS_SHAPE:
        raise AssertionError("bench shape %r" % ((bench.V, bench.D,
                                                  bench.N),))
    reset_launches()
    with torch.no_grad():
        for fn in rab.EXPERIMENTS.values():
            fn(bench)
    counts = read_launches()
    recs = [json.loads(line) for line in out.getvalue().splitlines()]
    return recs, counts


def row_access_case(name, v, d, n, gen, timed, skewed=False):
    """One kernel against its plain version on the card, bit for bit, on
    ids of its contract: gather on random ids (a few outside [0, V),
    which clamp), RMW on the reference's unique ids (3 i + jitter), the
    sweep on the reference's sorted random ids or, `skewed`, on sorted
    hub-skewed ids (runs of up to ~1,300, ~15% of the ids in the first
    8192 rows, ids >= V dropped). With `timed`: the wrapper, the kernel
    alone (the sweep's two kernels on scratch allocated once), the plain
    version and the library call, beside the bytes bound; for the sweep
    also kernel 1's sorted entry on the same ids, wrapper and alone."""
    import torch
    from graphvite_tpu_torch.ops import row_access as ra
    from graphvite_tpu_torch.ops import scatter

    dev = torch.device("cuda")
    table = torch.randn((v, d), generator=gen, device=dev)
    upd = torch.randn((n, d), generator=gen, device=dev) * 1e-2
    if name == "gather_rows":
        ids = torch.randint(0, v, (n,), generator=gen, device=dev,
                            dtype=torch.int32)
        bad = ids.clone()
        bad[:2] = torch.tensor([-3, v + 5], device=dev)
        want = ra.gather_rows_plain(table, bad)
        got = ra.gather_rows(table, bad)
        call = (lambda: ra.gather_rows(table, ids))
        kernel = call
        plain = (lambda: ra.gather_rows_plain(table, ids))
        library = (lambda: torch.index_select(table, 0, ids))
    elif name == "rmw_rows":
        jitter = torch.randint(0, 3, (n,), generator=gen, device=dev,
                               dtype=torch.int32)
        ids = (torch.arange(n, device=dev, dtype=torch.int32) * 3
               + jitter) % v
        want = ra.rmw_rows_plain(table.clone(), ids, upd)
        got = ra.rmw_rows_(table.clone(), ids, upd, check_unique=True)
        call = (lambda: ra.rmw_rows_(table, ids, upd))
        kernel = call
        plain = (lambda: ra.rmw_rows_plain(table, ids, upd))
        library = (lambda: table.index_add_(0, ids, upd))
    else:
        if skewed:
            u = torch.rand((n,), generator=gen, device=dev)
            ids = (u ** 2.5 * (v + 3)).to(torch.int32)
        else:
            ids = torch.randint(0, v, (n,), generator=gen, device=dev,
                                dtype=torch.int32)
        ids = torch.sort(ids)[0]
        want = ra.sweep_add_sorted_plain(table.clone(), ids, upd)
        got = ra.sweep_add_sorted_(table.clone(), ids, upd)
        scratch = ra.sweep_scratch(table, n)
        call = (lambda: ra.sweep_add_sorted_(table, ids, upd))
        kernel = (lambda: ra._launch_sweep(table, ids, upd, scratch))
        plain = (lambda: ra.sweep_add_sorted_plain(table, ids, upd))
        keep = ids < v
        ids_in, upd_in = ids[keep], upd[keep]
        library = (lambda: table.index_add_(0, ids_in, upd_in))
        # kernel 1's sorted entry computes the same function
        kernel1 = (lambda: scatter.scatter_add_sorted_(table, ids, upd))
        kernel1_alone = (lambda: scatter._launch_add(table, ids, upd,
                                                     sort=False))
    torch.cuda.synchronize()
    max_err = float((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError("%s disagrees with its plain version at %d x "
                             "%d, N %d: max |err| %g" % (name, v, d, n,
                                                         max_err))
    uniq = int(torch.unique(ids[(ids >= 0) & (ids < v)]).numel())
    rec = {"entry": name, "n": n, "v": v, "d": d, "dtype": "float32",
           "ids": "hub-skewed" if skewed else "random",
           "unique_rows": uniq, "max_abs_err": max_err,
           "tolerance": "exact"}
    del got, want
    if not timed:
        return rec
    if name == "gather_rows":
        nbytes, ops = uniq * d * 4 + n * d * 4 + 4 * n, 0
    elif name == "rmw_rows":
        nbytes, ops = 3 * n * d * 4 + 4 * n, n * d
    else:
        nbytes, ops = 2 * uniq * d * 4 + n * d * 4 + 4 * n, n * d
    bound_ms, bound_by = bytes_bound(nbytes, ops)
    rec.update(ms=cuda_ms(call), kernel_only_ms=cuda_ms(kernel),
               plain_ms=cuda_ms(plain, reps=5, warmup=1),
               library_ms=cuda_ms(library), bound_ms=bound_ms,
               bound_by=bound_by)
    if name == "sweep_add_sorted":
        rec.update(kernel1_ms=cuda_ms(kernel1),
                   kernel1_kernel_ms=cuda_ms(kernel1_alone))
    return rec


ROTATE_POOL_SHAPES = (
    # name, G, Bg, M, Dh, need_sq, groups per pass of the plain version
    ("rotate_wikidata5m", 128, 476, 128, 256, False, 4),
    ("rotate_fb15k", 16, 464, 128, 1024, True, 1))


def rotate_pool_phase(seed):
    """The pooled RotatE body's two kernels (ops/rotate_pool.py) at
    rotate_wikidata5m.yaml's batch and rotate_fb15k.yaml's micro-step:
    against the plain version on the groups of its first pass (largest
    errors over their tolerances), two calls for the same bits, then
    event-timed ms of the wrapper (a fixed gn: the step's adversarial tail
    is left out), of its two kernels alone (their C functions on
    preallocated outputs), of the plain version over all of the step's
    passes, and the bound: the body's share of benchmark/counts/rotate.py
    (14 operations a pair and complex dimension) at the float32 peak."""
    import torch
    from graphvite_tpu_torch.ops import kernels
    from graphvite_tpu_torch.ops import rotate_pool as rp
    from graphvite_tpu_torch.utils.common import EPSILON

    out, problems = {}, []
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for name, G, Bg, M, Dh, need_sq, per_pass in ROTATE_POOL_SHAPES:
        x = [torch.randn(G, n, Dh, device="cuda", generator=gen) * 0.3
             for n in (Bg, Bg, Bg, Bg, M, M)]
        gn = torch.rand(G, Bg, M, device="cuda", generator=gen) / M
        fixed = (None, gn.sum(dim=-1), gn)
        seen = []

        def outs(logits):
            seen.append(logits)
            return fixed

        before = rp.pool_sums.launches
        got = [rp.pool_sums(*x, 6.0, outs, need_sq) for _ in range(2)]
        torch.cuda.synchronize()
        same = (torch.equal(seen[0], seen[1])
                and all(torch.equal(a[k], b[k]) for a, b
                        in zip(got[0][1:], got[1][1:]) for k in a))
        first = [t[:per_pass].contiguous() for t in x]
        plain_seen = []
        _, sh, st = rp.pool_sums_plain(
            *first, 6.0, lambda lg: (plain_seen.append(lg), fixed[0],
                                     fixed[1][:per_pass],
                                     gn[:per_pass])[1:], need_sq)
        lg_err = float(((seen[0][:per_pass] - plain_seen[0]).abs()
                        / (2e-5 * (6.0 - plain_seen[0]).abs() + 1e-6))
                       .max())
        sum_err = 0.0
        M2 = M // 2
        for side, want in enumerate((sh, st)):
            g = gn[:per_pass, :, side * M2:(side + 1) * M2]
            bound = {"E": g.sum(dim=2)[..., None],
                     "S": (g * g).sum(dim=2)[..., None],
                     "B": g.sum(dim=1)[..., None],
                     "B2": (g * g).sum(dim=1)[..., None]}
            for key, ref in want.items():
                kind = "B2" if key in ("B_rr", "B_ii") else key[0]
                err = (got[0][1 + side][key][:per_pass] - ref).abs()
                sum_err = max(sum_err, float(
                    (err / (1e-5 * bound[kind] + 1e-12)).max()))
        del sh, st, plain_seen
        lib = rp._library()
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [t.data_ptr() for t in x]
        eps2 = EPSILON * EPSILON
        logits = torch.empty(G, Bg, M, device="cuda")
        qe, qb = (5, 4) if need_sq else (2, 2)
        e_out = torch.empty(qe, -(-M2 // rp.SLICE), 2, G, Bg, Dh,
                            device="cuda")
        b_out = torch.empty(qb, G, M, Dh, device="cuda")

        def kernels_alone():
            kernels.check_launch(lib, lib.gv_rotate_pool_logits(
                *ptrs, logits.data_ptr(), G, Bg, M2, Dh, 6.0, eps2,
                int(Dh % 4 == 0), stream), "logits")
            kernels.check_launch(lib, lib.gv_rotate_pool_grads(
                *ptrs, gn.data_ptr(), e_out.data_ptr(), b_out.data_ptr(), G,
                Bg, M2, Dh, eps2, int(need_sq), stream), "grads")

        def plain_passes():
            for g0 in range(0, G, per_pass):
                sl = slice(g0, g0 + per_pass)
                rp.pool_sums_plain(*[t[sl] for t in x], 6.0,
                                   lambda lg: (None, None, gn[sl]), need_sq)

        rec = {"shape": [G, Bg, M, Dh], "need_sq": need_sq,
               "same_bits": same, "logits_err_over_tol": lg_err,
               "sums_err_over_tol": sum_err,
               "ms": cuda_ms(lambda: rp.pool_sums(*x, 6.0, outs, need_sq)),
               "kernel_ms": cuda_ms(kernels_alone),
               "plain_ms": cuda_ms(plain_passes, reps=3, warmup=1)}
        seen.clear()
        rec["launches"] = rp.pool_sums.launches - before
        ops = 14 * Dh * G * Bg * M
        rec["bound_ms"], rec["bound_by"] = bytes_bound(0, ops)
        rec["kernel_share_of_bound"] = rec["bound_ms"] / rec["kernel_ms"]
        log("   %s:" % name, json.dumps(rec))
        out[name] = rec
        if not same or lg_err > 1 or sum_err > 1:
            problems.append("%s: same bits %r, errors over tolerance %.3g, "
                            "%.3g" % (name, same, lg_err, sum_err))
        del x, gn, got, logits, e_out, b_out
        torch.cuda.empty_cache()
    if problems:
        raise AssertionError("; ".join(problems))
    return out


def row_access_phase(seed):
    """The bench's experiments (the path of this phase), then each kernel
    bit for bit against its plain version at the reference's shape and at
    the shapes its kernels leave out, timed at the reference's shape, and
    rmw_rows_(check_unique=True) raising on a repeated id."""
    import torch
    from graphvite_tpu_torch.ops import row_access as ra

    recs, counts = row_access_bench_run()
    for r in recs:
        log("   bench:", json.dumps(r))
    problems = []
    chains = 7 * 10                  # 2 warm + 5 timed chains of EP = 10
    want = {"gather_rows": chains, "rmw_rows_": chains,
            "sweep_add_sorted_": chains,
            "scatter_add_sorted_": 4 * chains + 1,
            "scatter_add_": 2 * chains + 1}
    got = {k: counts[k] for k in want}
    if got != want or sum(counts.values()) != sum(want.values()):
        problems.append("bench launches %r, want %r" % (counts, want))
    if not all(r["ok"] for r in recs if "ok" in r):
        problems.append("a bench verify failed")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cases = {"gather_rows": [], "rmw_rows": [], "sweep_add_sorted": []}
    for name in cases:
        cases[name].append(row_access_case(name, *ROW_ACCESS_SHAPE, gen,
                                           timed=True))
        sweep = name == "sweep_add_sorted"
        if sweep:
            cases[name].append(row_access_case(name, *ROW_ACCESS_SHAPE, gen,
                                               timed=True, skewed=True))
        for v, d, n in ROW_ACCESS_EDGES:
            cases[name].append(row_access_case(name, v, d, n, gen,
                                               timed=False, skewed=sweep))
        for c in cases[name]:
            log("   %s:" % name, json.dumps(c))
    dev = torch.device("cuda")
    try:
        ra.rmw_rows_(torch.zeros((10, 4), device=dev),
                     torch.tensor([1, 2, 1], device=dev),
                     torch.ones((3, 4), device=dev), check_unique=True)
        problems.append("rmw_rows_ took a repeated id with check_unique")
    except ValueError:
        pass
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("; ".join(problems))
    return {"bench": recs, "launches": counts, "cases": cases}


# ---------------------------------------------------------------------------
# phase opt_ins: the reference's experimental walk opt-ins
# ---------------------------------------------------------------------------

WALK_SWEEP_SGD_LAUNCHES = EDGE_SGD_LAUNCHES       # sorted heads, as edges
WALK_SWEEP_ADAM_LAUNCHES = EDGE_ADAM_LAUNCHES
# name, switch, graph, float type, optimizer, model, batches, launches per
# batch, replay, whether the run is long enough for its loss to fall:
# widths and hyperparameters are the configs'. The banded runs' losses
# stay at ln 2 for hundreds of batches (the context rows start at zero;
# phase main shows the fall over 600), the pair and edge pool steps'
# leave it within tens
OPT_IN_RUNS = (
    ("a_sweep_walk_sgd", {"GRAPHVITE_SWEEP_WALK": "1"}, "youtube",
     "float32", SGD_YOUTUBE, DEEPWALK_YOUTUBE, 50, WALK_SWEEP_SGD_LAUNCHES,
     "state", True),
    ("b_sweep_walk_adam", {"GRAPHVITE_SWEEP_WALK": "1"}, "youtube",
     "float32", ADAM_FLICKR, DEEPWALK_YOUTUBE, 20, WALK_SWEEP_ADAM_LAUNCHES,
     "state", False),
    ("c_bulk_deepwalk", {"GRAPHVITE_BULK_WALKS": "1"}, "youtube", "float32",
     SGD_YOUTUBE, DEEPWALK_YOUTUBE, 50, {"scatter_add_": 1}, "arena",
     False),
    ("d_bulk_node2vec", {"GRAPHVITE_BULK_WALKS": "1"}, "youtube", "float32",
     SGD_YOUTUBE, NODE2VEC_YOUTUBE, 20, {"scatter_add_": 1}, "arena", False),
    ("e_bf16_band", {"GRAPHVITE_BF16_BAND": "1"}, "youtube", "bfloat16",
     SGD_YOUTUBE, DEEPWALK_YOUTUBE, 50, {"scatter_add_": 1}, "arena", False),
    ("f_sweep_banded_float32", {"GRAPHVITE_SWEEP_BANDED": "1"}, "youtube",
     "float32", SGD_YOUTUBE, DEEPWALK_YOUTUBE, 50, {"scatter_add_": 2},
     "walk", False),
    ("f_sweep_banded_bfloat16", {"GRAPHVITE_SWEEP_BANDED": "1"}, "youtube",
     "bfloat16", SGD_YOUTUBE, DEEPWALK_YOUTUBE, 50, {"scatter_add_": 2},
     "walk", False),
    ("g_bf16_compute", {"GRAPHVITE_BF16_COMPUTE": "1"}, "flickr",
     "bfloat16", SGD_FLICKR, LINE_FLICKR, 50, EDGE_SGD_LAUNCHES, "edge",
     True),
)
OPT_IN_ENGINE_BATCHES = 10         # worker-batches of (e)'s walks engine


def train_opt_in(graph, env, float_type, optimizer, train_kw, batches,
                 per_batch, episode, samplers, falling):
    """One opt-in at its config's shape with its switch set: 3 warm-up
    batches, then the measured call, the launch counts set to 0 just
    before and read just after; `falling` asks for a falling loss (first
    against last tenth in float64). Returns the solver (the switch's step
    and samplers kept for the replays), the record and a list of
    problems."""
    import torch
    from graphvite_tpu_torch.solver import GraphSolver

    with environ(env):
        solver = GraphSolver(dim=DIM, float_type=float_type)
        solver.build(graph, optimizer=optimizer, num_negative=1,
                     batch_size=100000, episode_size=episode)
        if samplers is not None:
            solver._sampler_cache = samplers
        t0 = time.perf_counter()
        solver.train(num_epoch=3 * 100000 / graph.num_edge, **train_kw)
        warm_s = time.perf_counter() - t0
        eff = solver.effective_batch
        reset_launches()
        t0 = time.perf_counter()
        solver.train(num_epoch=batches * eff / graph.num_edge + 1e-9,
                     **train_kw)
        elapsed = time.perf_counter() - t0
        counts = read_launches()
    run = solver.batch_id
    micro = solver._batch_plan()[2]
    losses = solver.batch_losses.double()
    k = max(run // 10, 5)
    step = getattr(solver._active_step_fn, "base", solver._active_step_fn)
    rec = {"env": env, "float_type": float_type,
           "optimizer": optimizer["type"], "model": train_kw["model"],
           "batches": run, "effective_batch": eff, "micro_steps": micro,
           "step": step.__qualname__.split(".")[0],
           "sweeps": [solver._sweep_gather, solver._sweep_scatter,
                      solver._sweep_context],
           "fused_arena": solver._banded_fused,
           "bulk": getattr(solver, "_active_bulk_fn", None) is not None,
           "warmup_s": warm_s, "ms_per_batch": elapsed / run * 1e3,
           "samples_per_s": run * eff / elapsed, "launches": counts,
           "launches_per_batch": {n: c / run for n, c in counts.items()
                                  if c},
           "loss_first": float(losses[:k].mean()),
           "loss_last": float(losses[-k:].mean()),
           "losses_finite": bool(torch.isfinite(losses).all()),
           "tables_finite": all(bool(torch.isfinite(t.float()).all())
                                for t in solver.state["tables"]),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    problems = []
    want = {n: per_batch.get(n, 0) * micro * run for n in counts}
    want["walk_chain"] = walk_chain_launches(solver, run)
    want["walk_band"] = walk_band_launches(solver, run)
    if counts != want:
        problems.append("kernel launches %r, want %r" % (counts, want))
    if not rec["losses_finite"] or not rec["tables_finite"]:
        problems.append("losses or tables not finite")
    if falling and not rec["loss_last"] < rec["loss_first"]:
        problems.append("losses not falling: %r" % rec)
    return solver, rec, problems


def bulk_check(solver, seed):
    """The episode sampler of a GRAPHVITE_BULK_WALKS run on the card
    against the same function on the CPU from the same draws (the chain's
    uniforms for W * n lanes): every batch's ids and masks equal."""
    import torch

    fn = solver._active_bulk_fn
    sampler = solver._active_sampler
    gen = torch.Generator().manual_seed(seed)
    lanes, L = fn.lanes, sampler.walk_length
    if sampler.biased:
        R, C = fn.chain_fn.proposals, fn.chain_fn.rounds_cap
        draws = (torch.rand(lanes, generator=gen),
                 torch.rand(lanes, generator=gen),
                 torch.rand((L - 1, C, 3, R, lanes), generator=gen))
    else:
        draws = tuple(torch.rand(shape, generator=gen) for shape in
                      ((lanes,), (lanes,), (L - 1, lanes), (L - 1, lanes)))
    with torch.no_grad():
        card = fn(*sampler.arrays(),
                  draws=tuple(d.to(solver.device) for d in draws))
        cpu = fn(*(a.cpu() for a in sampler.arrays()), draws=draws)
    equal = all(torch.equal(a.cpu(), b) for a, b in zip(card, cpu))
    rec = {"batches": int(card[0].shape[0]), "lanes": lanes,
           "shapes": [list(a.shape) for a in card], "equal": equal,
           "valid_fraction": float(card[2].mean())}
    return rec, ([] if equal else ["bulk sample differs card vs CPU"])


def replay_band_engine(seed, W=2, dim=32, device="cuda"):
    """GRAPHVITE_BF16_BAND in the walks engine on bf16 tables: W workers on
    the card against W on the CPU from the same draws and state, one
    batch each on a 20,000-vertex power-law graph: losses rtol 2e-5,
    tables rtol 3e-4, atol 3e-6 plus 1 bf16 ulp (each device rounds its
    own float32 sums once)."""
    import torch
    from graphvite_tpu_torch.models import GRAPH_MODELS
    from graphvite_tpu_torch.optim import Optimizer
    from graphvite_tpu_torch.parallel import mesh

    graph = power_law_graph(20000, 150000, seed)
    gen = torch.Generator().manual_seed(seed)
    vertex = ((torch.rand((graph.num_vertex, dim), generator=gen) - 0.5)
              * 2).bfloat16()
    context = (torch.randn((graph.num_vertex, dim), generator=gen)
               * 0.5).bfloat16()
    part = mesh.VertexPartition(np.asarray(graph.degrees), W)
    opt = Optimizer(type="SGD", lr=0.025, weight_decay=5e-3)
    res = {}
    draws = None
    with environ({"GRAPHVITE_BF16_BAND": "1"}):
        for where, dev in (("cuda", device), ("cpu", "cpu")):
            group = mesh.DeviceGroup([torch.device(dev)] * W)
            tr = mesh.ShardedGraphTrainer(
                group, part, dim, GRAPH_MODELS["DeepWalk"], opt,
                num_negative=1, negative_weight=5.0, batch_size=4 * 22 * 64,
                ep_batches=1, sampler_mode="walks",
                walk_cfg=dict(augmentation_step=2, walk_length=10,
                              bidir=True, pool_size=64))
            sample = tr.build_sample_state(graph)
            state = tr.init_state(vertex, context)
            neg = tr.init_negative_state(np.asarray(graph.vertex_weights))
            if draws is None:
                draws = tr.episode_draws(gen)
            state, neg, ls = tr.run_episode(
                state, sample, neg, 0, 1000, seed,
                draws=mesh.draws_to(draws, group.devices))
            res[where] = ([t.cpu().float() for t in tr.gather_tables(state)],
                          torch.stack([l.cpu() for l in ls]).double())
    (gt, gl), (ct, cl) = res["cuda"], res["cpu"]
    ok = bool(((gl - cl).abs() <= 2e-5 * cl.abs()).all())
    err = 0.0
    for a, b in zip(gt, ct):
        d = (a - b).abs()
        tol = 3e-6 + 3e-4 * b.abs() + bf16_ulp(torch.maximum(a.abs(),
                                                           b.abs()))
        ok = ok and bool((d <= tol).all())
        err = max(err, float(d.max()))
    rec = {"workers": W, "dim": dim, "losses": gl.tolist(),
           "cpu_losses": cl.tolist(), "max_abs_err": err,
           "tolerance": "losses rtol 2e-5; tables rtol 3e-4, atol 3e-6, "
                        "+ 1 bf16 ulp"}
    return rec, ([] if ok else ["card and CPU disagree: %r" % rec])


def opt_in_engine(graph, batches, device=None):
    """(e)'s walks engine: DeepWalk at the deepwalk_youtube.yaml shape with
    two workers on the card (GraphApplication gpus MESH_IDS), bf16 tables,
    GRAPHVITE_BF16_BAND=1: kernel 1, the walk chain's and the band's
    kernels once per worker-batch."""
    import torch
    from graphvite_tpu_torch import GraphApplication

    with environ({"GRAPHVITE_BF16_BAND": "1"}):
        app = GraphApplication(dim=DIM, gpus=MESH_IDS, float_type="bfloat16",
                               device=device)
        app.graph = graph
        app.build(optimizer=SGD_YOUTUBE, num_negative=1, batch_size=100000,
                  episode_size=25)
        reset_launches()
        app.train(num_epoch=batches * MESH_WALK_BATCH / graph.num_edge
                  + 1e-9, log_frequency=10**9,
                  **{k: v for k, v in DEEPWALK_YOUTUBE.items()
                     if k != "log_frequency"})
        counts = read_launches()
    s = app.solver
    run, st = s.batch_id, s.mesh_stats
    losses = s.batch_losses.double()
    rec = {"workers": st["workers"], "float_type": "bfloat16",
           "batches": run, "batch": s.effective_batch,
           "ms_per_worker_batch": st["loop_s"] / run * 1e3,
           "valid_pairs_per_s": st["valid_pairs"] / st["loop_s"],
           "launches": counts,
           "losses_finite": bool(torch.isfinite(losses).all()),
           "tables_finite": all(bool(torch.isfinite(t.float()).all())
                                for t in s.state["tables"])}
    problems = []
    want = {n: (run if n in ("scatter_add_", "walk_chain", "walk_band")
                else 0) for n in counts}
    if counts != want:
        problems.append("engine launches %r, want %r" % (counts, want))
    if not rec["losses_finite"] or not rec["tables_finite"]:
        problems.append("engine losses or tables not finite")
    del app, s
    return rec, problems


def opt_ins_phase(seed, shared):
    """Each opt-in on the clones the earlier phases built, then its
    replays. Returns the records."""
    import torch

    out, problems = {}, []
    samplers = {"youtube": None,
                "flickr": shared.pop("flickr_samplers", None)}
    for (name, env, gname, float_type, opt, train_kw, batches, per_batch,
         replay, falling) in OPT_IN_RUNS:
        t0 = time.perf_counter()
        graph = shared[gname]
        solver, rec, bad = train_opt_in(
            graph, env, float_type, opt, train_kw, batches, per_batch,
            1000 if gname == "flickr" else 25, samplers[gname], falling)
        samplers[gname] = solver._sampler_cache
        bad = ["%s: %s" % (name, p) for p in bad]
        if replay == "state":
            rec["replay"], _, b = replay_edge_batch(solver, seed + 1,
                                                    sorted_heads=False)
        elif replay == "arena":
            rec["replay"], _, b = replay_batch(solver, seed + 1)
        elif replay == "walk":
            rec["replay"], b = replay_walk_step(solver, seed + 1)
        else:
            rec["replay"], _, b = replay_edge_batch(solver, seed + 1)
        bad += ["%s replay: %s" % (name, p) for p in b]
        if rec["bulk"]:
            rec["bulk_sample"], b = bulk_check(solver, seed + 2)
            bad += ["%s: %s" % (name, p) for p in b]
        elif name.startswith(("c_", "d_")):
            bad.append("%s: no bulk sampler" % name)
        del solver
        torch.cuda.empty_cache()
        if name == "e_bf16_band":
            rec["engine"], b = opt_in_engine(graph, OPT_IN_ENGINE_BATCHES)
            bad += ["%s engine: %s" % (name, p) for p in b]
            rec["engine_replay"], b = replay_band_engine(seed)
            bad += ["%s engine replay: %s" % (name, p) for p in b]
            torch.cuda.empty_cache()
        rec["phase_s"] = time.perf_counter() - t0
        log("   %s:" % name, json.dumps(rec))
        out[name] = rec
        problems += bad
    if problems:
        raise AssertionError("; ".join(problems))
    return out


WALK_CHAIN_CASES = (
    # name, walks, start_csr, augmentation, bidir: deepwalk_youtube's
    # batch, a line_friendster.mesh4 worker-batch's (its CSR start, here
    # over the Youtube clone), and GRAPHVITE_BULK_WALKS's episode of 500
    ("deepwalk_youtube", 192, False, 5, False),
    ("line_friendster_worker", 576, True, 2, True),
    ("bulk_walks", 96_000, False, 5, False))


def walk_chain_phase(seed, graph):
    """The first-order walk chain's kernel (ops/device_sampler.py:
    walk_chain, csrc/walk_chain.cu) on the Youtube clone at walk length 40,
    for each of WALK_CHAIN_CASES: bit-equal to the plain chain on the card
    from integer and float start draws; event-timed ms of the chain
    function drawing for itself (what a batch's `sample` pays), of the
    wrapper, of the kernel alone (20 launches on preallocated outputs), of
    the plain chain, and the kernel's latency bound: one lane's chain of
    dependent loads on the same tables (the kernel at W = 1, 20 launches
    in a row, the median over 32 draws), beside the bytes bound. One
    launch a wrapper call."""
    import torch
    from graphvite_tpu_torch.ops import device_sampler as ds

    out, problems = {}, []
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for name, W, csr, aug, bidir in WALK_CHAIN_CASES:
        T = aug * (2 if bidir else 1)
        s = ds.DeviceWalkSampler.build(graph, aug, 40, W * T * 41,
                                       banded=True, bidir=bidir,
                                       start_csr=csr, device="cuda")
        arrays, L = s.arrays(), s.walk_length
        n_start = ds._num_starts(s.heads, s.indices, csr)

        def rand(*shape):
            return torch.rand(shape, generator=gen, device="cuda")

        same = {}
        before = ds.walk_chain.launches
        for kind in ("int_u1", "float_u1"):
            u1 = (torch.randint(0, n_start, (W,), generator=gen,
                                device="cuda") if kind == "int_u1"
                  else rand(W))
            draws = (u1, None, rand(L - 1, W), rand(L - 1, W))
            got = ds.walk_chain(*arrays, *draws, csr)
            want = ds.walk_chain_plain(*arrays, *draws, csr)
            same[kind] = all(torch.equal(a, b) for a, b in zip(got, want))
        launches = ds.walk_chain.launches - before
        chain = torch.empty_like(got[0])
        valid = torch.empty_like(got[1])
        fn = s.make_chain_fn()

        def kernel_alone(n=20):
            for _ in range(n):
                ds._launch_chain(chain, valid, *arrays, *draws, csr)

        c1 = torch.empty((L + 1, 1), dtype=torch.int64, device="cuda")
        v1 = torch.empty((L + 1, 1), dtype=torch.bool, device="cuda")
        one = []
        for _ in range(32):
            lane = (torch.randint(0, n_start, (1,), generator=gen,
                                  device="cuda"), None, rand(L - 1, 1),
                    rand(L - 1, 1))

            def one_lane(n=20):
                for _ in range(n):
                    ds._launch_chain(c1, v1, *arrays, *lane, csr)
            one.append(cuda_ms(one_lane, reps=5, warmup=1) / 20)
        # per step a lane reads its 16-byte row and a 4-byte neighbour and
        # its two draws; the chain and valid written once
        nbytes = W * ((L - 1) * (16 + 4 + 8) + (L + 1) * 9 + 8)
        rec = {"walks": W, "walk_length": L,
               "start": "csr" if csr else "flat",
               "same_bits": same, "launches": launches,
               "chain_fn_ms": cuda_ms(lambda: fn(*arrays, generator=gen)),
               "ms": cuda_ms(lambda: ds.walk_chain(*arrays, *draws, csr)),
               "kernel_ms": cuda_ms(kernel_alone) / 20,
               "plain_ms": cuda_ms(lambda: ds.walk_chain_plain(
                   *arrays, *draws, csr), reps=5, warmup=1),
               "bound_ms": statistics.median(one),
               "bound_by": "latency (one lane)",
               "bytes_bound_ms": bytes_bound(nbytes)[0]}
        log("   walk_chain %s:" % name, json.dumps(rec))
        out[name] = rec
        if not all(same.values()) or launches != 2:
            problems.append("%s: same bits %r, launches %d"
                            % (name, same, launches))
        del s, arrays, got, want, chain, valid
        torch.cuda.empty_cache()
    if problems:
        raise AssertionError("; ".join(problems))
    return out


WALK_BAND_CASES = (
    # name, walks, positions, dim, augmentation (both directions):
    # deepwalk_youtube's batch and a line_friendster.mesh4 worker-batch's
    ("deepwalk_youtube", 192, 41, 128, 5),
    ("line_friendster_worker", 576, 41, 96, 2))


def walk_band_phase(seed, graph):
    """The banded step's positive band kernel (ops/walk_band.py:walk_band,
    csrc/walk_band.cu), for each of WALK_BAND_CASES: v and c the strided
    halves of one [B, L1, 2D] tensor, pair flags with walk ends and dead
    slots; against walk_band_plain on the card (relative gaps of dv, dc
    and the walks' losses, the counts the same bits); event-timed ms of
    the wrapper, of the kernel alone (20 launches on preallocated
    outputs, queued), of the plain version, and of the SGD core through
    the kernel against the same core with the plain band forced in its
    place; one walk's time (the kernel at B = 1, the median over 32 draws:
    a measurement, not a bound); the bound: the larger of the bytes (v, c
    and the mask read, dv, dc, the counts and sums written, once, at the
    card's HBM peak) and the latency floor of one launch of the same grid
    (walk_band.cu's floor_kernel: a load, a warp sum, a barrier and a
    store a block), not this kernel's own time. Then 20 DeepWalk batches
    on the graph under a recording session: one
    graphvite::walk_band_kernel a `step`."""
    import torch
    from graphvite_tpu_torch.ops import kernels, steps, walk_band
    from graphvite_tpu_torch.optim import Optimizer
    from graphvite_tpu_torch.solver import GraphSolver
    from graphvite_tpu_torch.utils import tracing

    out, problems = {}, []
    gen = torch.Generator(device="cuda").manual_seed(seed)
    lib = walk_band._library()
    vp, i64, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.gv_walk_band_floor.argtypes = [vp, i64, i64, i, i, i, vp, vp]
    lib.gv_walk_band_floor.restype = i

    def inputs(B, L1, D, offs):
        rows = torch.randn((B, L1, 2 * D), generator=gen, device="cuda") \
            * (1.5 / D ** 0.5)
        mask = (torch.rand((B, L1, len(offs)), generator=gen,
                           device="cuda") > 0.05).float()
        for t, off in enumerate(offs):
            if off > 0:
                mask[:, L1 - off:, t] = 0
            else:
                mask[:, :-off, t] = 0
        return rows[..., :D], rows[..., D:], mask

    def gap(a, b):
        return float(torch.linalg.vector_norm((a - b).double())
                     / torch.linalg.vector_norm(b.double()))

    for name, B, L1, D, aug in WALK_BAND_CASES:
        offs = tuple(steps.walk_offsets(aug, True))
        T = len(offs)
        v, c, mask = inputs(B, L1, D, offs)
        wd = SGD_YOUTUBE["weight_decay"]
        args = (v, c, mask, offs, wd, wd * 6.0)
        with tracing.recording() as rec:
            got = walk_band.walk_band(*args)
        launches = rec.summary()["counters"].get(tracing.WALK_BAND_KERNEL, 0)
        want = walk_band.walk_band_plain(*args)
        torch.cuda.synchronize()
        gaps = {"dv": gap(got[0], want[0]), "dc": gap(got[1], want[1]),
                "loss": gap(got[4][:, 0], want[4][:, 0])}
        counts_same = (torch.equal(got[2], want[2])
                       and torch.equal(got[3], want[3])
                       and torch.equal(got[4][:, 1], want[4][:, 1]))
        outs = [torch.empty_like(x) for x in got]
        one = []
        for _ in range(32):
            lane = inputs(1, L1, D, offs)
            o1 = [torch.empty_like(x[:1]) for x in got]
            one.append(queued_ms(lambda: walk_band._launch(
                *lane, offs, wd, wd * 6.0, False, *o1), reps=1))
        floor_out = torch.empty((B, 16), device="cuda")

        def floor():
            kernels.check_launch(lib, lib.gv_walk_band_floor(
                v.data_ptr(), v.stride(0), v.stride(1), B, L1, D,
                floor_out.data_ptr(),
                torch.cuda.current_stream().cuda_stream), "walk_band floor")
        G = steps.graph_pool_groups(B, target_group=max(2048 // (T * L1), 1))
        core, _ = steps.make_graph_banded_core(
            Optimizer(**SGD_YOUTUBE), 1, 5.0, aug, True,
            pool_size=128 if name == "deepwalk_youtube" else 64,
            pool_groups=G, trust=None if name == "deepwalk_youtube" else 0.25)
        P = torch.randn((G, 128 if name == "deepwalk_youtube" else 64, D),
                        generator=gen, device="cuda") * 0.1
        core_ms = cuda_ms(lambda: core(v, c, P, mask, 0.025))
        kernel_fn = walk_band.walk_band
        walk_band.walk_band = walk_band.walk_band_plain
        try:
            core_plain_ms = cuda_ms(lambda: core(v, c, P, mask, 0.025),
                                    reps=5, warmup=1)
        finally:
            walk_band.walk_band = kernel_fn
        nbytes = 4 * B * L1 * (4 * D + T + 2) + 8 * B
        bytes_ms = bytes_bound(nbytes)[0]
        floor_ms = queued_ms(floor)
        rec = {"walks": B, "positions": L1, "dim": D, "offsets": T,
               "gaps": gaps, "counts_same_bits": counts_same,
               "launches": launches,
               "ms": cuda_ms(lambda: walk_band.walk_band(*args)),
               "kernel_ms": queued_ms(lambda: walk_band._launch(
                   *args, False, *outs)),
               "one_walk_ms": statistics.median(one),
               "plain_ms": cuda_ms(lambda: walk_band.walk_band_plain(*args),
                                   reps=5, warmup=1),
               "core_ms": core_ms, "core_plain_band_ms": core_plain_ms,
               "bytes_bound_ms": bytes_ms, "latency_floor_ms": floor_ms,
               "bound_ms": max(bytes_ms, floor_ms),
               "bound_by": ("bytes" if bytes_ms >= floor_ms else
                            "latency floor (a launch, a load, a warp sum, "
                            "a barrier, a store a block)"),
               "library_ms": "none: no PyTorch call computes it"}
        log("   walk_band %s:" % name, json.dumps(rec))
        out[name] = rec
        if (max(gaps.values()) > 1e-6 or not counts_same
                or launches != 1):
            problems.append("%s: gaps %r, counts %r, launches %d"
                            % (name, gaps, counts_same, launches))
        del v, c, mask, got, want, outs
        torch.cuda.empty_cache()

    solver = GraphSolver(dim=DIM)
    solver.build(graph, optimizer=SGD_YOUTUBE, num_negative=1,
                 batch_size=100000, episode_size=25)
    eff = solver.effective_batch
    solver.train(num_epoch=3 * eff / graph.num_edge + 1e-9,
                 **DEEPWALK_YOUTUBE)
    with tracing.recording() as rec:
        solver.train(num_epoch=20 * eff / graph.num_edge + 1e-9,
                     **DEEPWALK_YOUTUBE)
    summary = rec.summary()
    n_steps = summary["spans"][tracing.STEP]["count"]
    kernels_run = summary["counters"].get(tracing.WALK_BAND_KERNEL, 0)
    out["deepwalk_call"] = {"batches": solver.batch_id, "steps": n_steps,
                            "walk_band_kernel": kernels_run}
    log("   walk_band in a DeepWalk call:", json.dumps(out["deepwalk_call"]))
    if not kernels_run == n_steps == solver.batch_id > 0:
        problems.append("DeepWalk call: %r" % out["deepwalk_call"])
    del solver
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("; ".join(problems))
    return out


def training_launches(results):
    """Each wrapper's launches summed over every run record of the phases
    that train (each dict under a "launches" key, nested records
    included); the bench and the kernel comparisons are left out."""
    total = dict.fromkeys(wrappers(), 0)

    def walk(node):
        if isinstance(node, dict):
            got = node.get("launches")
            if isinstance(got, dict):
                for fn in total:
                    total[fn] += got.get(fn, 0)
            for value in node.values():
                walk(value)
        elif isinstance(node, (list, tuple)):
            for value in node:
                walk(value)

    for phase, rec in results.items():
        if phase not in ("device", "build", "row_access", "kernel"):
            walk(rec)
    return total


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
    ap.add_argument("--main-batches", type=int, default=600)
    ap.add_argument("--node2vec-batches", type=int, default=600)
    ap.add_argument("--layout-batches", type=int, default=50)
    ap.add_argument("--edge-batches", type=int, default=1000)
    ap.add_argument("--kg-batches", type=int, default=50)
    ap.add_argument("--kg-big-batches", type=int, default=50)
    ap.add_argument("--only", choices=["multihost", "opt_ins",
                                       "rotate_pool", "walk_chain",
                                       "walk_band"],
                    help="run the device and build phases and this phase "
                    "alone (its graphs built here; opt_ins after "
                    "row_access), print its record and no result line")
    # a process of the multihost phase: ROOT PID PORT DEVICE CASES
    ap.add_argument("--multihost-child", nargs=5, help=argparse.SUPPRESS)
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
    if args.multihost_child:
        root, pid, port, device, cases = args.multihost_child
        return multihost_child(root, int(pid), port, device, cases,
                               args.seed)
    # the cli phase's datasets live in a directory of their own, removed
    # at the end; the registry reads its path when it is first imported
    data_dir = tempfile.mkdtemp(prefix="chip_smoke_data_")
    os.environ["GRAPHVITE_DATASET_PATH"] = data_dir
    try:
        return run(args)
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)


def run(args):
    import torch

    try:
        from graphvite_tpu_torch.ops import (device_sampler, gather, kernels,
                                             rotate_pool, row_access,
                                             scatter, walk_band)
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
        if sorted(paths) != ["gather_sorted", "rotate_pool", "row_access",
                             "scatter_add", "scatter_update", "walk_band",
                             "walk_chain"]:
            raise AssertionError("kernels built: %r" % sorted(paths))
        scatter._library("scatter_add")
        scatter._library("scatter_update")
        gather._library()
        row_access._library()
        rotate_pool._library()
        device_sampler._chain_library()
        walk_band._library()
        return secs
    if not phase("build", build):
        return 1

    if args.only == "rotate_pool":
        ok = phase("rotate_pool", lambda: rotate_pool_phase(args.seed))
        log(card_line())
        return 0 if ok else 1
    if args.only == "walk_chain":
        ok = phase("walk_chain", lambda: walk_chain_phase(
            args.seed, power_law_graph(YOUTUBE_V, YOUTUBE_E, args.seed)))
        log(card_line())
        return 0 if ok else 1
    if args.only == "walk_band":
        ok = phase("walk_band", lambda: walk_band_phase(
            args.seed, power_law_graph(YOUTUBE_V, YOUTUBE_E, args.seed)))
        log(card_line())
        return 0 if ok else 1

    # 3. the row-access bench and its kernels
    if args.only != "multihost":
        phase("row_access", lambda: row_access_phase(args.seed))

    shared = {}
    if args.only == "opt_ins":
        def graphs():
            shared["flickr"] = power_law_graph(FLICKR_V, FLICKR_E, args.seed)
            shared["youtube"] = power_law_graph(YOUTUBE_V, YOUTUBE_E,
                                                args.seed)
        ok = (phase("graphs", graphs)
              and phase("opt_ins", lambda: opt_ins_phase(args.seed, shared))
              and "row_access" in results)
        log(card_line())
        return 0 if ok else 1
    if args.only == "multihost":
        def graphs():
            from graphvite_tpu_torch.graph import KnowledgeGraph

            shared["flickr"] = power_law_graph(FLICKR_V, FLICKR_E, args.seed)
            shared["youtube"] = power_law_graph(YOUTUBE_V, YOUTUBE_E,
                                                args.seed)
            shared["wikidata5m"] = fill_power_law_kg(
                KnowledgeGraph(), WIKIDATA5M_ENT, WIKIDATA5M_REL,
                WIKIDATA5M_TRAIN, args.seed)
        ok = (phase("graphs", graphs)
              and phase("multihost",
                        lambda: multihost_phase(args.seed, shared)))
        log(card_line())
        return 0 if ok else 1

    def youtube_graph():
        """The Youtube-sized graph of the walk phases, built once."""
        if "youtube" not in shared:
            t0 = time.perf_counter()
            graph = power_law_graph(YOUTUBE_V, YOUTUBE_E, args.seed)
            log("graph: %d vertices, %d input edges, %d directed, built in "
                "%.1f s" % (graph.num_vertex, graph.num_edge,
                            graph.num_directed_edge,
                            time.perf_counter() - t0))
            shared["youtube"] = graph
        return shared["youtube"]

    # 4. main path (DeepWalk)
    def main_path():
        graph = youtube_graph()
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
        out["trace"] = trace_episode(solver, DEEPWALK_YOUTUBE)
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
    # the first-order chain's kernel on the same graph
    phase("walk_chain", lambda: walk_chain_phase(args.seed, youtube_graph()))
    torch.cuda.empty_cache()
    # the banded step's positive band kernel, and its launches a step
    phase("walk_band", lambda: walk_band_phase(args.seed, youtube_graph()))
    torch.cuda.empty_cache()

    # 5. node2vec at the node2vec_youtube.yaml shape
    def node2vec_phase():
        rec, ids, problems = node2vec_path(youtube_graph(),
                                           args.node2vec_batches, args.seed)
        log("   node2vec:", json.dumps(rec))
        torch.cuda.empty_cache()
        if problems:
            raise AssertionError("; ".join(problems))
        return {"record": rec, "ids": ids}
    phase("node2vec", node2vec_phase)

    # 6. the pair and multitail layouts and the classic step (DeepWalk)
    def layouts_phase():
        out, problems = {}, []
        for name, env in WALK_LAYOUTS:
            rec, bad = walk_layout_path(youtube_graph(), name, env,
                                        args.layout_batches, args.seed + 2)
            log("   %s:" % name, json.dumps(rec))
            out[name] = rec
            problems += ["%s: %s" % (name, p) for p in bad]
            torch.cuda.empty_cache()
        if problems:
            raise AssertionError("; ".join(problems))
        return out
    phase("layouts", layouts_phase)
    if "main" in results:
        shared["main_ms_per_batch"] = results["main"]["float32"][
            "ms_per_batch"]

    # 7. the edge route (LINE)
    def edge_path():
        t0 = time.perf_counter()
        graph = power_law_graph(FLICKR_V, FLICKR_E, args.seed)
        log("graph: %d vertices, %d input edges, %d directed, built in %.1f s"
            % (graph.num_vertex, graph.num_edge, graph.num_directed_edge,
               time.perf_counter() - t0))
        shared["flickr"] = graph            # for phase host
        torch.cuda.reset_peak_memory_stats()
        out = {}
        problems = []
        n = args.edge_batches
        runs = (("float32", "float32", SGD_FLICKR, n, EDGE_SGD_LAUNCHES),
                ("bfloat16", "bfloat16", SGD_FLICKR, max(n // 2, 10),
                 EDGE_SGD_LAUNCHES),
                ("adam", "float32", ADAM_FLICKR, max(n // 5, 10),
                 EDGE_ADAM_LAUNCHES))
        samplers = None
        for name, float_type, opt, batches, per_batch in runs:
            solver, rec, bad = train_edge_path(
                graph, float_type, opt, batches, per_batch,
                falling=(name == "float32"), sampler_cache=samplers)
            samplers = solver._sampler_cache
            log("   %s:" % name, json.dumps(rec))
            out[name] = rec
            problems += ["%s: %s" % (name, p) for p in bad]
            if name == "float32":
                out["trace"] = trace_episode(solver, LINE_FLICKR)
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
        shared["flickr_samplers"] = samplers    # for phase opt_ins
        if problems:
            raise AssertionError("; ".join(problems))
        return out
    phase("edge", edge_path)

    # 8. the reference's experimental walk opt-ins
    def opt_ins():
        if "flickr" not in shared:
            shared["flickr"] = power_law_graph(FLICKR_V, FLICKR_E, args.seed)
        youtube_graph()
        return opt_ins_phase(args.seed, shared)
    phase("opt_ins", opt_ins)

    # 9. knowledge graphs: RotatE at the rotate_fb15k.yaml shape
    def kg_path():
        from graphvite_tpu_torch import KnowledgeGraphApplication

        t0 = time.perf_counter()
        data = fb15k_clone(args.seed)
        app = KnowledgeGraphApplication(dim=KG_DIM)
        app.load(triplet_list=data["train"])
        g = app.graph
        log("graph: %d entities, %d relations, %d train triplets, built in "
            "%.1f s" % (g.num_vertex, g.num_relation, g.num_edge,
                        time.perf_counter() - t0))
        app.build(optimizer=ADAM_FB15K, **BUILD_FB15K)
        out, problems = {}, []
        # the dense moment route (14,951 x 2048 < 2^26 elements): no
        # kernel of the port is on this path
        rec, bad = train_kg_path(app, ROTATE_FB15K, args.kg_batches, {},
                                 (14848, 7424, 2, 16, 128), falling=True)
        log("   float32 Adam:", json.dumps(rec))
        out["float32"] = rec
        problems += bad
        out["trace"] = trace_episode(app.solver, ROTATE_FB15K)
        log("   trace:", json.dumps(out["trace"]))
        rep, ids, bad = replay_kg_batch(app.solver, args.seed + 1,
                                        compact=False)
        log("   micro-step, card vs CPU:", json.dumps(rep))
        out["replay"] = rep
        out["ids"] = ids
        problems += ["replay: " + p for p in bad]
        rank, bad = kg_ranking(app, data, 2000, 64)
        log("   filtered ranking:", json.dumps(rank))
        out["ranking"] = rank
        problems += bad
        if problems:
            raise AssertionError("; ".join(problems))
        return out
    phase("kg", kg_path)
    torch.cuda.empty_cache()

    # 10. knowledge graphs: RotatE at the rotate_wikidata5m.yaml shape
    def kg_big_path():
        from graphvite_tpu_torch import KnowledgeGraphApplication

        out, problems = {}, []
        n = args.kg_big_batches
        plan = (60928, 60928, 1, 128, 128)
        runs = (("float32", "float32", SGD_WIKIDATA5M, n,
                 {"scatter_add_": 2}),
                ("bfloat16", "bfloat16", SGD_WIKIDATA5M, max(n // 2, 10),
                 {"scatter_add_": 2}),
                # the relation table (822 x 512) takes the dense route
                ("adam", "float32", ADAM_WIKIDATA5M, max(n // 4, 10),
                 {"scatter_update_": 1}))
        graph = None
        for name, float_type, opt, batches, per_batch in runs:
            app = KnowledgeGraphApplication(dim=KG_BIG_DIM,
                                            float_type=float_type)
            if graph is None:
                t0 = time.perf_counter()
                graph = fill_power_law_kg(app.graph, WIKIDATA5M_ENT,
                                          WIKIDATA5M_REL, WIKIDATA5M_TRAIN,
                                          args.seed)
                log("graph: %d entities, %d relations, %d triplets, built "
                    "in %.1f s" % (graph.num_vertex, graph.num_relation,
                                   graph.num_edge, time.perf_counter() - t0))
                shared["wikidata5m"] = graph    # for kg_mesh and host
            app.graph = graph
            app.build(optimizer=opt, **BUILD_WIKIDATA5M)
            rec, bad = train_kg_path(app, ROTATE_WIKIDATA5M, batches,
                                     per_batch, plan,
                                     falling=(name == "float32"))
            log("   %s:" % name, json.dumps(rec))
            out[name] = rec
            problems += ["%s: %s" % (name, p) for p in bad]
            if name == "float32":
                out["trace"] = trace_episode(app.solver, ROTATE_WIKIDATA5M,
                                             batches=5)
                log("   trace:", json.dumps(out["trace"]))
            rep, ids, bad = replay_kg_batch(app.solver, args.seed + 1,
                                            compact=True)
            log("   %s batch, card vs CPU:" % name, json.dumps(rep))
            out["replay_" + name] = rep
            problems += ["%s replay: %s" % (name, p) for p in bad]
            if name == "float32":
                out["ids"] = ids
                out["pool_shape"] = rep["pool_shape"]
            del app
            torch.cuda.empty_cache()
        if problems:
            raise AssertionError("; ".join(problems))
        return out
    phase("kg_big", kg_big_path)
    torch.cuda.empty_cache()
    phase("rotate_pool", lambda: rotate_pool_phase(args.seed))
    torch.cuda.empty_cache()

    # 11. LargeVis at the largevis_mnist_2d.yaml shape (exact KNN)
    phase("vis", lambda: vis_phase(args.seed, shared))
    torch.cuda.empty_cache()

    # 12. LargeVis at the largevis_imagenet.yaml shape (IVF KNN)
    phase("vis_big", lambda: vis_big_phase(args.seed))
    torch.cuda.empty_cache()

    # 13. blocked episodes and the host master (LINE, friendster-small)
    phase("blocked", lambda: blocked_phase(args.seed, shared))
    torch.cuda.empty_cache()

    # 14. the multi-device engines, two workers on the card, on the
    # graphs of main, vis and blocked
    phase("mesh", lambda: mesh_phase(args.seed, shared))
    torch.cuda.empty_cache()

    # 15. the KG engines, two workers on the card, on kg_big's graph
    phase("kg_mesh", lambda: kg_mesh_phase(args.seed, shared))
    torch.cuda.empty_cache()

    # 16. the engines over two processes on the graphs of edge, main and
    # kg_big
    phase("multihost", lambda: multihost_phase(args.seed, shared))
    torch.cuda.empty_cache()

    # 17. the host sampler backend on the graphs of edge, main, kg_big
    # and vis
    phase("host", lambda: host_phase(args.seed, shared))
    shared.clear()
    torch.cuda.empty_cache()

    # 18. each kernel against its plain version, on the paths' own ids
    def kernel():
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        cases = {"scatter_add": [], "gather_sorted": [],
                 "scatter_update": []}
        for ids in results["main"]["batch_ids"]:
            for dtype in (torch.float32, torch.bfloat16):
                rec = check_kernel(ids, dtype, gen)
                log("   scatter_add", json.dumps(rec))
                cases["scatter_add"].append(rec)
        rec = check_kernel(results["node2vec"]["ids"], torch.float32, gen)
        log("   scatter_add (node2vec batch)", json.dumps(rec))
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
        del heads, ctx, equal, v_counts, c_counts
        torch.cuda.empty_cache()
        # the KG paths' ids, at widths 512 and 2048: the entity update of
        # the Wikidata5m-shaped batch (138,240 unsorted ids), its relation
        # update (60,928 ids over 822 rows: every row a hub), and the
        # FB15k-shaped micro-step's ids (that shape's own route is the
        # dense one)
        big = results["kg_big"]["ids"]
        small = results["kg"]["ids"]
        adds = (("kg_big entity", big["entity"], WIKIDATA5M_ENT, KG_BIG_DIM),
                ("kg_big relation", big["relation"], WIKIDATA5M_REL,
                 KG_BIG_DIM),
                ("kg entity", small["entity"], FB15K_ENT, KG_DIM))
        for name, ids, v, w in adds:
            for dtype in (torch.float32, torch.bfloat16):
                rec = check_add_rows(name, ids, v, w, dtype, gen)
                log("   scatter_add_ (%s)" % name, json.dumps(rec))
                cases["scatter_add"].append(rec)
                torch.cuda.empty_cache()
        # Adam's touch counts of the pooled step: positives 1 + K/2, pool
        # slots Bg K / M; relations K + 1
        G, M = results["kg_big"]["pool_shape"]
        b = big["relation"].numel()
        e_counts = torch.cat([torch.full((2 * b,), 33.0, device="cuda"),
                              torch.full((G * M,), b // G * 64 / M,
                                         device="cuda")])
        r_counts = torch.full((b,), 65.0, device="cuda")
        updates = (("kg_big entity", big["entity"], e_counts,
                    WIKIDATA5M_ENT, torch.float32),
                   ("kg_big entity", big["entity"], e_counts,
                    WIKIDATA5M_ENT, torch.bfloat16),
                   ("kg_big relation", big["relation"], r_counts,
                    WIKIDATA5M_REL, torch.float32))
        for name, ids, counts, v, dtype in updates:
            rec = check_update_rows(name, ids, counts, v, KG_BIG_DIM, dtype,
                                    gen)
            log("   scatter_update_ (%s)" % name, json.dumps(rec))
            cases["scatter_update"].append(rec)
            torch.cuda.empty_cache()
        # the vis SGD batch's update ids at 8 columns (one 128-column pass
        # per warp, 8 live lanes of 32); kernel 2 at the same shape with
        # the pooled step's touch counts (no vis route takes it: the table
        # is below the dense-update size)
        vis = results["vis"]["ids"]
        for dtype in (torch.float32, torch.bfloat16):
            rec = check_add_rows("vis SGD", vis["ids"], MNIST_N, 8, dtype,
                                 gen)
            log("   scatter_add_ (vis SGD, W 8)", json.dumps(rec))
            cases["scatter_add"].append(rec)
            rec = check_update_rows("vis ids, W 8", vis["ids"],
                                    vis["counts"], MNIST_N, 8, dtype, gen)
            log("   scatter_update_ (vis ids, W 8)", json.dumps(rec))
            cases["scatter_update"].append(rec)
        # the blocked path's shard-local ids: unsorted, over a ~1.99M x 128
        # shard; kernel 2 with the sharded step's count of 1 per entry
        blk = results["blocked"]["ids"]
        for side in ("vertex", "context"):
            ids = blk[side]
            name = "blocked %s shard" % side
            for dtype in (torch.float32, torch.bfloat16):
                rec = check_add_rows(name, ids, blk["rows"], DIM, dtype, gen)
                log("   scatter_add_ (%s)" % name, json.dumps(rec))
                cases["scatter_add"].append(rec)
            ones = torch.ones(ids.numel(), device="cuda")
            rec = check_update_rows(name, ids, ones, blk["rows"], DIM,
                                    torch.float32, gen)
            log("   scatter_update_ (%s)" % name, json.dumps(rec))
            cases["scatter_update"].append(rec)
            torch.cuda.empty_cache()
        # the mesh engines' updates, as one worker made them in its first
        # batch of an extra episode: the edges engine's vertex and context
        # shards (~3.97M x 128), the walks engine's fused arena (~569k x
        # 256, requests of both workers, dropped slots at id cap) and its
        # Adam shards (~569k x 128), with the counts the engines passed
        for tag, calls in sorted(results["mesh"]["ids"].items()):
            for side, c in zip(("vertex", "context"), calls):
                name = "mesh %s %s" % (tag, side if c["width"] == DIM
                                       else "arena")
                if c["entry"] == "scatter_add_":
                    rec = check_add_rows(name, c["ids"], c["rows"],
                                         c["width"], torch.float32, gen)
                    cases["scatter_add"].append(rec)
                else:
                    rec = check_update_rows(name, c["ids"], c["counts"],
                                            c["rows"], c["width"],
                                            torch.float32, gen)
                    cases["scatter_update"].append(rec)
                log("   %s (%s)" % (c["entry"], name), json.dumps(rec))
                torch.cuda.empty_cache()
        # the KG engines' updates in worker 0's first batch of an extra
        # round: the entity arena (2 cap = 2,297,244 x 512; kernel 1 on
        # SGD, kernel 2 with the pooled step's counts on Adam), the
        # relations (822 x 512, SGD), the global pool's pool-space sum
        # (W Q = 8,192 rows) and its owner update (Q ids over the arena);
        # then the host backend's first batch: LINE's vertex and context
        # tables (1,715,256 x 128), RotatE's entity (4,594,485 x 512)
        # and relation tables, and RotatE Adam's entity table
        kg_calls = [("kg_mesh " + tag, calls) for tag, calls
                    in sorted(results["kg_mesh"]["ids"].items())]
        kg_calls += sorted(results["host"]["ids"].items())
        for tag, calls in kg_calls:
            for what, c in calls:
                name = "%s %s" % (tag, what)
                if c["entry"] == "scatter_add_":
                    rec = check_add_rows(name, c["ids"], c["rows"],
                                         c["width"], torch.float32, gen)
                    cases["scatter_add"].append(rec)
                else:
                    rec = check_update_rows(name, c["ids"], c["counts"],
                                            c["rows"], c["width"],
                                            torch.float32, gen)
                    cases["scatter_update"].append(rec)
                log("   %s (%s)" % (c["entry"], name), json.dumps(rec))
                torch.cuda.empty_cache()
        return cases
    needed = ("main", "node2vec", "edge", "kg", "kg_big", "vis", "blocked",
              "mesh", "kg_mesh", "host")
    if all(name in results for name in needed):
        phase("kernel", kernel)
    else:
        failures.append("kernel (needs the paths' ids)")

    # 19. quality
    def quality_phase():
        out = {}
        for name, model, classic, blocked, host in (
                ("DeepWalk", "DeepWalk", False, False, False),
                ("LINE", "LINE", False, False, False),
                ("node2vec", "node2vec", False, False, False),
                ("classic", "DeepWalk", True, False, False),
                ("LINE blocked, host master", "LINE", False, True, False),
                ("LINE, host sampler", "LINE", False, False, True),
                ("DeepWalk, host sampler", "DeepWalk", False, False, True),
                ("node2vec, host sampler", "node2vec", False, False, True)):
            q = quality(model, classic=classic, blocked=blocked, host=host)
            log("   two-block %s on the card:" % name, json.dumps(q))
            if not q["auc"] > 0.9:
                raise AssertionError("%s link-prediction AUC %.4f <= 0.9"
                                     % (name, q["auc"]))
            if q["state_device"] != ("cpu" if blocked else "cuda"):
                raise AssertionError("%s: the tables ended on the %s"
                                     % (name, q["state_device"]))
            la = q["launches"]
            others = (sum(la.values()) - la["scatter_add_"]
                      - la["walk_chain"] - la["walk_band"])
            if (la["scatter_add_"] != 2 * q["micro_steps"] * q["batches"]
                    or others or q["fused_arena"] or any(q["sweeps"])):
                raise AssertionError("the small-table route did not launch "
                                     "the scatter-add twice per step: %r"
                                     % q)
            if la["walk_chain"] != q["chain_launches_want"]:
                raise AssertionError("%s: walk chain launches %d, want %d"
                                     % (name, la["walk_chain"],
                                        q["chain_launches_want"]))
            if la["walk_band"] != q["band_launches_want"]:
                raise AssertionError("%s: band launches %d, want %d"
                                     % (name, la["walk_band"],
                                        q["band_launches_want"]))
            out[name] = q
        return out
    phase("quality", quality_phase)

    # 20. the command line: three shipped configs through cmd, in process,
    # and `cmd list` in a process of its own
    def cli_phase():
        root = os.environ["GRAPHVITE_DATASET_PATH"]
        out, problems = {"list": cli_list()}, []
        runs = (("quick_start", lambda: quick_start_cli(root, args.seed)),
                ("math", lambda: math_cli(root)),
                ("line_wikipedia",
                 lambda: word_graph_cli(root, args.seed, CORPUS_TOKENS)))
        calls = []
        with no_downloads():
            for name, drive in runs:
                rec, bad, ids = drive()
                log("   %s:" % name, json.dumps(rec))
                out[name] = rec
                problems += ["%s: %s" % (name, p) for p in bad]
                calls += [("%s %s" % (name, side), c)
                          for side, c in zip(("vertex", "context"), ids)]
                torch.cuda.empty_cache()
        # kernel 1 at these paths' shapes: one batch's vertex and context
        # updates (the trust clip's float32 accumulator), against its
        # plain version
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        out["kernel_cases"] = []
        for name, (ids, rows) in calls:
            rec = check_add_rows(name, ids, rows, DIM, torch.float32, gen)
            log("   scatter_add_ (%s)" % name, json.dumps(rec))
            out["kernel_cases"].append(rec)
        if len(calls) != 4:
            problems.append("%d kernel 1 calls in the two configs' batches, "
                            "want 2 each" % len(calls))
        if problems:
            raise AssertionError("; ".join(problems))
        return out
    phase("cli", cli_phase)

    if failures:
        log("FAILED phases: %s" % ", ".join(failures))
        return 1

    # 21. summary: the card line, the kernels line, the result line
    main_rec = results["main"]["float32"]
    edge = results["edge"]
    cases = results["kernel"]
    k1 = {"deepwalk_float32": main_rec["launches"],
          "node2vec_float32": (results["node2vec"]["record"]["launches"]
                               ["scatter_add_"])}
    for name, _ in WALK_LAYOUTS:
        k1["walk_" + name] = (results["layouts"][name]["launches"]
                              ["scatter_add_"])
    k1["edge_float32"] = (edge["float32"]["launches"]["scatter_add_"]
                          + edge["float32"]["launches"]["scatter_add_sorted_"])
    kg_big = results["kg_big"]
    for name in ("float32", "bfloat16"):
        k1["kg_big_" + name] = kg_big[name]["launches"]["scatter_add_"]
    k1["vis_sgd"] = results["vis"]["sgd"]["launches"]["scatter_add_"]
    blocked = results["blocked"]
    k1["blocked_a_sgd"] = blocked["a"]["launches"]["scatter_add_"]
    k1["blocked_b_sgd_host_master"] = blocked["b"]["launches"]["scatter_add_"]
    for name in ("quick_start", "line_wikipedia"):
        k1["cli_" + name] = results["cli"][name]["launches"]["scatter_add_"]
    mesh = results["mesh"]
    for name in ("edges_sgd", "walks_sgd", "walks_node2vec", "vis_sgd"):
        k1["mesh_" + name] = mesh[name]["launches"]["scatter_add_"]
    k1["mesh_walks_w1"] = mesh["walks_w1"]["launches"]["scatter_add_"]
    kg_mesh = results["kg_mesh"]
    for name in ("a_pooled_sgd", "c_global_sgd", "d_resident_sgd"):
        k1["kg_mesh_" + name] = kg_mesh[name]["launches"]["scatter_add_"]
    multihost = results["multihost"]
    for name in ("a_edges_sgd", "c_walks_sgd", "d_kg_pooled_sgd",
                 "e_kg_global_sgd"):
        k1["multihost_" + name] = multihost[name]["launches"]["scatter_add_"]
    host = results["host"]
    for name in ("line_flickr", "deepwalk_youtube", "rotate_wikidata5m"):
        k1["host_" + name] = host[name]["launches"]["scatter_add_"]
    k1["host_largevis_mnist"] = host["largevis_mnist"]["launches"][
        "scatter_add_"]
    k2 = {"edge_adam": (edge["adam"]["launches"]["scatter_update_"]
                        + edge["adam"]["launches"]["scatter_update_sorted_"]),
          "kg_big_adam": kg_big["adam"]["launches"]["scatter_update_"],
          # the vis tables take the dense moment route
          "vis_adam": results["vis"]["adam"]["launches"]["scatter_update_"],
          "vis_big_adam": (results["vis_big"]["adam"]["launches"]
                           ["scatter_update_"]),
          "blocked_c_adam_host_master": (blocked["c"]["launches"]
                                         ["scatter_update_"]),
          "mesh_edges_adam": mesh["edges_adam"]["launches"]["scatter_update_"],
          "mesh_walks_adam": mesh["walks_adam"]["launches"]["scatter_update_"],
          # the replicas' tables take the dense moment route
          "mesh_vis_adam": mesh["vis_adam"]["launches"]["scatter_update_"],
          "kg_mesh_b_pooled_adam": (kg_mesh["b_pooled_adam"]["launches"]
                                    ["scatter_update_"]),
          "multihost_b_edges_adam": (multihost["b_edges_adam"]["launches"]
                                     ["scatter_update_"]),
          "host_rotate_wikidata5m_adam": (
              host["rotate_wikidata5m_adam"]["launches"]["scatter_update_"]),
          # the MNIST table takes the dense moment route
          "host_largevis_mnist": (host["largevis_mnist"]["launches"]
                                  ["scatter_update_"])}
    k3 = {"edge_float32": edge["float32"]["launches"]["gather_sorted"]}
    # the opt-ins' runs and the row-access bench's kernel 1 experiments
    bench = results["row_access"]["launches"]
    k1["row_access_bench"] = (bench["scatter_add_"]
                              + bench["scatter_add_sorted_"])
    for name, rec in results["opt_ins"].items():
        la = rec["launches"]
        if la["scatter_add_"] or la["scatter_add_sorted_"]:
            k1["opt_ins_" + name] = (la["scatter_add_"]
                                     + la["scatter_add_sorted_"])
        if la["scatter_update_"] or la["scatter_update_sorted_"]:
            k2["opt_ins_" + name] = (la["scatter_update_"]
                                     + la["scatter_update_sorted_"])
        if la["gather_sorted"]:
            k3["opt_ins_" + name] = la["gather_sorted"]
        if "engine" in rec:
            k1["opt_ins_%s_engine" % name] = rec["engine"]["launches"][
                "scatter_add_"]
    # the walk chain's kernel: once a batch's sample on the first-order
    # walk routes (once an episode with GRAPHVITE_BULK_WALKS)
    kc = {"deepwalk_float32": main_rec["chain_launches"],
          "deepwalk_bfloat16": results["main"]["bfloat16"]["chain_launches"]}
    for name, _ in WALK_LAYOUTS:
        kc["walk_" + name] = (results["layouts"][name]["launches"]
                              ["walk_chain"])
    for name, rec in results["opt_ins"].items():
        if rec["launches"]["walk_chain"]:
            kc["opt_ins_" + name] = rec["launches"]["walk_chain"]
        if "engine" in rec:
            kc["opt_ins_%s_engine" % name] = rec["engine"]["launches"][
                "walk_chain"]
    for name in ("walks_sgd", "walks_adam", "walks_w1"):
        kc["mesh_" + name] = mesh[name]["launches"]["walk_chain"]
    kc["multihost_c_walks_sgd"] = (multihost["c_walks_sgd"]["launches"]
                                   ["walk_chain"])
    for name in ("DeepWalk", "classic"):
        kc["quality_" + name] = (results["quality"][name]["launches"]
                                 ["walk_chain"])
    kc["cli_quick_start"] = results["cli"]["quick_start"]["launches"][
        "walk_chain"]
    # the band's kernel: once a micro-step on the banded SGD walk steps,
    # once a worker-batch in the walks engine's SGD runs
    kb = {"deepwalk_float32": main_rec["band_launches"],
          "deepwalk_bfloat16": results["main"]["bfloat16"]["band_launches"],
          "node2vec_float32": (results["node2vec"]["record"]["launches"]
                               ["walk_band"])}
    for name, _ in WALK_LAYOUTS:
        kb["walk_" + name] = results["layouts"][name]["launches"]["walk_band"]
    for name, rec in results["opt_ins"].items():
        if rec["launches"]["walk_band"]:
            kb["opt_ins_" + name] = rec["launches"]["walk_band"]
        if "engine" in rec:
            kb["opt_ins_%s_engine" % name] = rec["engine"]["launches"][
                "walk_band"]
    for name in ("walks_sgd", "walks_adam", "walks_node2vec", "walks_w1"):
        kb["mesh_" + name] = mesh[name]["launches"]["walk_band"]
    kb["multihost_c_walks_sgd"] = (multihost["c_walks_sgd"]["launches"]
                                   ["walk_band"])
    for name in ("DeepWalk", "node2vec", "classic"):
        kb["quality_" + name] = (results["quality"][name]["launches"]
                                 ["walk_band"])
    kb["cli_quick_start"] = results["cli"]["quick_start"]["launches"][
        "walk_band"]
    chain = results["walk_chain"]
    band = results["walk_band"]
    # the row-access kernels run on the bench's path only: every training
    # phase's runs hold them at 0, and the line shows the sum it read
    trained = training_launches(results)
    rows = {name: {"row_access_bench": bench[wrapper],
                   "training_paths": trained[wrapper]}
            for name, wrapper in (("gather_rows", "gather_rows"),
                                  ("rmw_rows", "rmw_rows_"),
                                  ("sweep_add_sorted", "sweep_add_sorted_"))}
    ra_cases = results["row_access"]["cases"]
    kernels_line = {"kernels": [
        # the DeepWalk batch-100000 update, float32 table
        kernel_row("scatter_add", "graphvite_tpu_torch/csrc/scatter_add.cu",
                   "graphvite_tpu/ops/pallas_scatter.py:146",
                   sum(k1.values()), k1,
                   cases["scatter_add"] + results["cli"]["kernel_cases"],
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
    ] + [
        # the reference experiment's shape, float32 table
        kernel_row(name, "graphvite_tpu_torch/csrc/row_access.cu",
                   "tools/pallas_bench.py:%d" % line,
                   sum(rows[name].values()), rows[name],
                   [c for c in ra_cases[name] if "ms" in c],
                   ra_cases[name][0])
        for name, line in (("gather_rows", 86), ("rmw_rows", 170),
                           ("sweep_add_sorted", 265))] + [
        # the deepwalk_youtube batch's 192 walks; the JAX chain is jnp
        # that XLA fuses, so no TPU kernel is replaced
        {"name": "walk_chain", "route": "cuda",
         "source": "graphvite_tpu_torch/csrc/walk_chain.cu",
         "replaces": None, "launches": sum(kc.values()),
         "launches_by_path": kc,
         "same_bits": all(all(c["same_bits"].values())
                          for c in chain.values()),
         **{k: chain["deepwalk_youtube"][k]
            for k in ("ms", "kernel_ms", "plain_ms", "bound_ms")},
         "cases": [{"case": name, "walks": c["walks"], "start": c["start"],
                    "ms": c["ms"], "kernel_ms": c["kernel_ms"],
                    "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"]}
                   for name, c in chain.items()]},
        # the deepwalk_youtube batch's band; the JAX core is jnp that XLA
        # fuses, so no TPU kernel is replaced
        {"name": "walk_band", "route": "cuda",
         "source": "graphvite_tpu_torch/csrc/walk_band.cu",
         "replaces": None,
         "launches": sum(kb.values()), "launches_by_path": kb,
         **{k: band["deepwalk_youtube"][k]
            for k in ("ms", "kernel_ms", "plain_ms", "bound_ms",
                      "library_ms")},
         "cases": [{"case": name, **{k: c[k] for k in (
             "walks", "dim", "offsets", "gaps", "ms", "kernel_ms",
             "one_walk_ms", "plain_ms", "core_ms", "core_plain_band_ms",
             "latency_floor_ms", "bound_ms", "bound_by")}}
                   for name, c in band.items() if name != "deepwalk_call"]}]}
    log(json.dumps({"front_end": cases["front_end"]}))
    log(card_line())
    log(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
