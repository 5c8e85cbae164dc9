"""KNN graph construction for LargeVis (the port of graphvite_tpu/knn.py).

The reference's FAISS-based KNNGraph (include/instance/visualization.cuh:
59-412) becomes matrix products and top-k on the device: exact search is
a chunked ``|x|^2 + |y|^2 - 2 x.y^T`` product with `torch.topk`; past
`KNNGraph.IVF_THRESHOLD` rows an inverted-file search takes over (k-means
centroids, one assignment product, per-cluster probing of shared candidate
sets). Per-dim normalization (visualization.cuh:179-193),
perplexity-calibrated Gaussian weights by bisection on beta (:196-237) and
reciprocal-edge weight averaging (:240-253) keep the reference's
statistics.

Everything runs on one device: the vectors' own when they come as a
tensor, else `device` (CUDA unless the caller asks for the CPU). Results
stay there as tensors; the graph's edge arrays are device tensors too, so
the sampler takes them without a host round trip.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from graphvite_tpu_torch.solver import resolve_device
from graphvite_tpu_torch.utils.common import EPSILON, auto, logger


def _device_of(vectors, device):
    if torch.is_tensor(vectors) and device is None:
        return vectors.device
    return resolve_device(device)


def _upload(vectors, device, dtype, chunk=1 << 16):
    """[n, d] vectors (numpy or tensor) as `dtype` on `device`, converted
    chunk by chunk: a whole float32 copy beside a bfloat16 one would hold
    both at once."""
    if torch.is_tensor(vectors) and vectors.device == device:
        return vectors.to(dtype)
    n = vectors.shape[0]
    out = torch.empty(tuple(vectors.shape), dtype=dtype, device=device)
    for lo in range(0, n, chunk):
        part = vectors[lo:lo + chunk]
        if not torch.is_tensor(part):
            part = torch.from_numpy(np.ascontiguousarray(part,
                                                         dtype=np.float32))
        out[lo:lo + chunk] = part.to(device=device, dtype=dtype)
    return out


def _sq_norms(x, chunk=1 << 16):
    """Row squared norms in float32, chunk by chunk (a bfloat16 table is
    never converted whole)."""
    out = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    for lo in range(0, x.shape[0], chunk):
        r = x[lo:lo + chunk].float()
        out[lo:lo + chunk] = (r * r).sum(dim=1)
    return out


def _mm_f32(a, b):
    """a @ b with float32 results, as the reference's
    preferred_element_type=float32: bfloat16 operands keep their exact
    products and a float32 sum (cuBLAS' bf16 GEMM with float32 output on
    the card; the products in float32 on the CPU)."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def exact_knn(vectors, k: int, row_chunk: int = 4096, device=None):
    """Top-(k+1) nearest neighbors by squared L2, including self.

    Returns (distances [n, k+1] float32, labels [n, k+1] int64) on the
    device, ascending distance: the contract of faiss' L2 search
    (visualization.cuh:89-93). Rows are scored in chunks against every
    column; there are no padded rows, so none can win a slot."""
    dev = _device_of(vectors, device)
    x = _upload(vectors, dev, torch.float32)
    n = x.shape[0]
    kk = min(k + 1, n)
    sq = (x * x).sum(dim=1)
    # bound one chunk's [rows, n] distances at 2^28 elements
    row_chunk = max(min(int(row_chunk), (1 << 28) // max(n, 1)), 1)
    dist = torch.empty((n, kk), dtype=torch.float32, device=dev)
    labels = torch.empty((n, kk), dtype=torch.int64, device=dev)
    for lo in range(0, n, row_chunk):
        hi = min(lo + row_chunk, n)
        d2 = sq[lo:hi, None] + sq[None, :] - 2.0 * (x[lo:hi] @ x.T)
        neg, idx = torch.topk(-d2, kk, dim=1)
        dist[lo:hi] = -neg
        labels[lo:hi] = idx
    return dist, labels


def _kmeans_device(x, nlist: int, sample: int, iters: int, seed: int):
    """Lloyd k-means on a sample of the rows: assign by argmin squared L2
    (one product), update by segment sums (`index_add_`). The sample and
    the first centroids are the reference's host draws
    (default_rng(seed)). Returns centroids [nlist, D] float32; an empty
    cluster keeps its previous centroid."""
    n = x.shape[0]
    rng = np.random.default_rng(seed)
    sample = min(sample, n)
    sidx = np.sort(rng.choice(n, sample, replace=False))
    xs = x[torch.as_tensor(sidx, device=x.device)].float()      # [S, D]
    cidx = rng.choice(sample, nlist, replace=False)
    cent = xs[torch.as_tensor(cidx, device=x.device)]
    ones = torch.ones(sample, dtype=torch.float32, device=x.device)
    for _ in range(iters):
        d2 = (cent * cent).sum(dim=1)[None, :] - 2.0 * (xs @ cent.T)
        a = torch.argmin(d2, dim=1)
        ssum = torch.zeros_like(cent).index_add_(0, a, xs)
        cnt = torch.zeros(nlist, dtype=torch.float32,
                          device=x.device).index_add_(0, a, ones)
        new = ssum / torch.clamp(cnt, min=1.0)[:, None]
        cent = torch.where((cnt > 0)[:, None], new, cent)
    return cent


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def ivf_knn(vectors, k: int, nlist: int = 0, nprobe: int = 16,
            sample: int = 131072, kmeans_iters: int = 10, seed: int = 0,
            row_chunk: int = 8192, dtype="bfloat16", device=None,
            timings=None):
    """Approximate KNN by inverted-file cluster probing, for row counts
    where brute force is O(n^2 d) (ImageNet's 1.33M x 2048 would be ~7e18
    operations).

    k-means centroids on a sample, one chunked assignment product over all
    rows, then per CLUSTER: its members share one candidate set, the
    members of its `nprobe` nearest clusters (own cluster first), each
    cluster's list truncated to the 98th percentile of list sizes; one
    [m_c, D] x [D, ccap] product and a top-k per chunk of members. The
    rows are held in bfloat16 (`dtype`) and every product keeps float32
    results; squared norms are float32 sums of the bfloat16 rows.

    Returns (dist [n, k], labels [n, k]) EXCLUDING self (masked by id),
    on the device. A slot no candidate filled (clusters smaller than the
    probes provide) takes the row's largest finite distance and its first
    label (the reference's fallback, kept as it is). `timings`: an
    optional dict that receives the seconds of each stage."""
    dev = _device_of(vectors, device)
    n = vectors.shape[0]
    if nlist <= 0:
        nlist = max(int(np.sqrt(n) * 2), 64)
    nprobe = min(nprobe, nlist)
    tdtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    t = {}
    t0 = time.perf_counter()
    x = _upload(vectors, dev, tdtype)
    sq = _sq_norms(x)
    row_chunk = min(row_chunk, n)
    logger.info("IVF KNN: %d rows, %d clusters, %d probes", n, nlist, nprobe)
    cent = _kmeans_device(x, nlist, sample, kmeans_iters, seed)
    _sync(dev)
    t["kmeans"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    cent_t = cent.to(tdtype)
    cent_sq = (cent * cent).sum(dim=1)
    assign = torch.empty(n, dtype=torch.int64, device=dev)
    for lo in range(0, n, row_chunk):
        d2 = cent_sq[None, :] - 2.0 * _mm_f32(x[lo:lo + row_chunk], cent_t.T)
        assign[lo:lo + row_chunk] = torch.argmin(d2, dim=1)
    # per-cluster probe lists (own cluster first), sorted on the host as
    # the reference sorts them
    cc = (cent_sq[None, :] - 2.0 * (cent @ cent.T)).cpu().numpy()
    probe = np.argsort(cc, axis=1)[:, :nprobe]                   # [nlist, np]
    assign_h = assign.cpu().numpy()
    del assign
    # member lists truncated to mcap (truncation only affects the
    # CANDIDATE role; every row is processed as a query below)
    counts = np.bincount(assign_h, minlength=nlist)
    mcap = max(int(np.quantile(counts, 0.98)), 8)
    order = np.argsort(assign_h, kind="stable")
    offs = np.concatenate([[0], np.cumsum(counts)])
    trunc = int(np.maximum(counts - mcap, 0).sum())
    if trunc:
        logger.info("IVF: %d rows truncated from candidate lists (%.2f%%)",
                    trunc, 100.0 * trunc / n)
    kk = min(k, n - 1)
    # each cluster's candidates: the members of its probes, in probe
    # order. The reference pads every member list to mcap with the id n,
    # which scores +inf; here only a candidate set shorter than k + 1
    # keeps pads, the one case where they can fill a slot
    cand_parts, cand_offs = [], [0]
    for c in range(nlist):
        part = np.concatenate([order[offs[p]:offs[p] + min(counts[p], mcap)]
                               for p in probe[c]])
        if part.size < kk + 1:
            part = np.concatenate([part, np.full(kk + 1 - part.size, n)])
        cand_parts.append(part)
        cand_offs.append(cand_offs[-1] + part.size)
    _sync(dev)
    t["assign"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    cand_all = torch.as_tensor(np.concatenate(cand_parts), device=dev)
    del cand_parts
    order_dev = torch.as_tensor(order, device=dev)
    sq_pad = torch.cat([sq, torch.full((1,), float("inf"), device=dev)])
    q_chunk = 2048
    dist = torch.empty((n, kk), dtype=torch.float32, device=dev)
    labels = torch.empty((n, kk), dtype=torch.int64, device=dev)
    for c in range(nlist):
        if c % 256 == 0:
            logger.debug("IVF queries: cluster %d of %d, %.1f s", c, nlist,
                         time.perf_counter() - t0)
        if counts[c] == 0:
            continue
        cand = cand_all[cand_offs[c]:cand_offs[c + 1]]           # [ccap]
        crows_t = x[torch.clamp(cand, max=n - 1)].T              # [D, ccap]
        csq = sq_pad[cand]
        for lo in range(offs[c], offs[c + 1], q_chunk):
            q = order_dev[lo:min(lo + q_chunk, offs[c + 1])]
            d2 = sq[q][:, None] + csq[None, :] - 2.0 * _mm_f32(x[q], crows_t)
            d2 = d2.masked_fill(cand[None, :] == q[:, None], float("inf"))
            neg, idx = torch.topk(-d2, kk, dim=1)
            dist[q] = -neg
            labels[q] = cand[idx]
    # unfilled slots carry inf: clamp them to the largest finite distance
    # so downstream weights vanish, and give them the row's first label
    bad = ~torch.isfinite(dist)
    if bool(bad.any()):
        dist[bad] = dist[~bad].max()
        labels = torch.where(bad, labels[:, :1].expand_as(labels), labels)
    _sync(dev)
    t["queries"] = time.perf_counter() - t0
    if timings is not None:
        timings.update(t)
    return dist, labels


def knn_recall(vectors, labels, nq: int = 1000, seed: int = 0, device=None):
    """recall@k of `labels` [n, k] against exact brute force (bfloat16 rows,
    float32 products, self excluded) on `nq` random queries."""
    dev = _device_of(vectors, device)
    n = vectors.shape[0]
    labels = torch.as_tensor(labels)
    k = labels.shape[1]
    rng = np.random.default_rng(seed)
    q = rng.choice(n, min(nq, n), replace=False)
    x = _upload(vectors, dev, torch.bfloat16)
    sq = _sq_norms(x)
    hits = 0
    for lo in range(0, q.size, 256):
        chunk = torch.as_tensor(q[lo:lo + 256], device=dev)
        d2 = sq[None, :] - 2.0 * _mm_f32(x[chunk], x.T)
        d2[torch.arange(chunk.numel(), device=dev), chunk] = float("inf")
        ex = torch.topk(-d2, k, dim=1).indices.cpu().numpy()
        got = labels[chunk.to(labels.device)].cpu().numpy()
        for i in range(ex.shape[0]):
            hits += len(set(ex[i].tolist()) & set(got[i].tolist()))
    return hits / (q.size * k)


def perplexity_weights_device(distances, perplexity: float,
                              num_iteration: int = 100, tol: float = 1e-5,
                              device=None):
    """Device version of the per-row beta bisection: a 100-step loop over
    [n, k] float32 tensors; returns normalized weights [n, k] float32 on
    the device."""
    dev = _device_of(distances, device)
    d = torch.as_tensor(distances).to(device=dev, dtype=torch.float32)
    target = float(np.log(perplexity))
    n = d.shape[0]
    beta = torch.ones(n, device=dev)
    low = torch.full((n,), -1.0, device=dev)
    high = torch.full((n,), -1.0, device=dev)
    for _ in range(num_iteration):
        w = torch.exp(-beta[:, None] * d)
        norm = w.sum(dim=1)
        entropy = (beta * (d * w).sum(dim=1)) / norm + torch.log(norm)
        done = torch.abs(entropy - target) < tol
        too_high = (entropy > target) & ~done
        new_low = torch.where(too_high, beta, low)
        new_high = torch.where(~too_high & ~done, beta, high)
        # entropy decreases in beta: overshoot -> bisect toward high,
        # undershoot -> bisect toward low (visualization.cuh:218-231)
        beta_up = torch.where(high < 0, beta * 2, (beta + high) / 2)
        beta_dn = torch.where(low < 0, beta / 2, (low + beta) / 2)
        beta = torch.where(done, beta, torch.where(too_high, beta_up,
                                                   beta_dn))
        low, high = new_low, new_high
    w = torch.exp(-beta[:, None] * d)
    return w / w.sum(dim=1, keepdim=True)


def perplexity_weights(distances: np.ndarray, perplexity: float,
                       num_iteration: int = 100, tol: float = 1e-5):
    """Per-row Gaussian kernel calibration: find beta_i such that the entropy
    of w_ij = exp(-beta_i * d_ij) matches log(perplexity); 100-iteration
    bisection, vectorized over rows (visualization.cuh:196-237)."""
    d = np.asarray(distances, dtype=np.float64)
    n = d.shape[0]
    beta = np.ones(n)
    low = np.full(n, -1.0)
    high = np.full(n, -1.0)
    target = np.log(perplexity)
    done = np.zeros(n, dtype=bool)
    norm = np.ones(n)
    for _ in range(num_iteration):
        w = np.exp(-beta[:, None] * d)
        norm = w.sum(axis=1)
        entropy = (beta[:, None] * d * w).sum(axis=1) / norm + np.log(norm)
        newly = np.abs(entropy - target) < tol
        done |= newly
        if done.all():
            break
        too_high = (entropy > target) & ~done
        too_low = ~too_high & ~done
        low[too_high] = beta[too_high]
        beta[too_high] = np.where(high[too_high] < 0, beta[too_high] * 2,
                                  (beta[too_high] + high[too_high]) / 2)
        # bisect toward `low` (the reference midpoints (low + beta) / 2,
        # visualization.cuh:228-230; using the just-assigned high would
        # leave beta unchanged)
        high[too_low] = beta[too_low]
        beta[too_low] = np.where(low[too_low] < 0, beta[too_low] / 2,
                                 (low[too_low] + beta[too_low]) / 2)
    w = np.exp(-beta[:, None] * d)
    return (w / norm[:, None]).astype(np.float32)


def reciprocal_average(heads, tails, weights, n):
    """Average each edge's weight with its reverse edge's, where the
    reverse exists (visualization.cuh:240-253), on the arrays' device in
    float64: a stable sort of the (head, tail) keys and a binary search
    for each reversed key. Returns float32 weights. Where a key repeats,
    the search lands on its first copy in edge order."""
    key = heads * n + tails
    rkey = tails * n + heads
    skey, order = torch.sort(key, stable=True)
    pos = torch.clamp(torch.searchsorted(skey, rkey), max=skey.numel() - 1)
    has_recip = skey[pos] == rkey
    w = weights.double()
    recip_w = torch.where(has_recip, w[order[pos]], torch.zeros_like(w))
    return torch.where(has_recip, (w + recip_w) / 2.0, w).float()


class KNNGraph:
    """KNN graph consumed by VisualizationSolver.

    The same flat directed-edge arrays as Graph, as device tensors
    (edge_heads, edge_tails int64; edge_weights float32); vertex_weights
    are all 1 (the uniform negative sampling base, visualization.cuh:235).
    `build_seconds` holds the last build's stage times."""

    # past this row count, brute force is O(n^2 d) and the IVF
    # cluster-probe search takes over (method="auto")
    IVF_THRESHOLD = 200_000

    def __init__(self, device_ids=None, num_thread_per_worker=auto,
                 device=None):
        # device_ids and num_thread_per_worker are accepted for parity
        self.device = resolve_device(device)
        self.clear()

    def clear(self):
        self.num_vertex = 0
        self.num_edge = 0
        self.dim = 0
        self.num_neighbor = 200
        self.perplexity = 50.0
        self.vector_normalization = True
        self.id2name = []
        self.name2id = {}
        self.edge_heads = torch.zeros(0, dtype=torch.int64,
                                      device=self.device)
        self.edge_tails = torch.zeros(0, dtype=torch.int64,
                                      device=self.device)
        self.edge_weights = torch.zeros(0, dtype=torch.float32,
                                        device=self.device)
        self.vertex_weights = np.zeros(0, dtype=np.float64)
        self.build_seconds = {}

    def load_numpy(self, vectors, num_neighbor=200, perplexity=50,
                   vector_normalization=True, method="auto", nprobe=16):
        """Build from [n, d] vectors: a numpy array, or a tensor (moved to
        the graph's device)."""
        if not torch.is_tensor(vectors):
            vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        if vectors.ndim != 2:
            vectors = vectors.reshape(len(vectors), -1)
        self.clear()
        self.num_vertex, self.dim = (int(s) for s in vectors.shape)
        self.num_neighbor = min(int(num_neighbor), self.num_vertex - 1)
        self.perplexity = float(perplexity)
        self.vector_normalization = bool(vector_normalization)
        self.id2name = [str(i) for i in range(self.num_vertex)]
        self.name2id = {n: i for i, n in enumerate(self.id2name)}
        if method == "auto":
            method = ("ivf" if self.num_vertex > self.IVF_THRESHOLD
                      else "exact")
        self._build(vectors, method=method, nprobe=nprobe)
        return self

    load_vectors = load_numpy

    def load_file(self, file_name, num_neighbor=200, perplexity=50,
                  vector_normalization=True, delimiters=None, comment="#"):
        from graphvite_tpu_torch.graph import _make_tokenizer
        tokenize = _make_tokenizer(delimiters)
        rows = []
        with open(file_name) as f:
            for line in f:
                ci = line.find(comment)
                if ci >= 0:
                    line = line[:ci]
                parts = tokenize(line)
                if parts:
                    rows.append([float(p) for p in parts])
        return self.load_numpy(np.asarray(rows, dtype=np.float32),
                               num_neighbor, perplexity, vector_normalization)

    def _normalize(self, vectors):
        """Per dim: subtract the mean, divide by the max |.|
        (visualization.cuh:179-193), in float32 on the device, in place on
        the uploaded copy."""
        x = _upload(vectors, self.device, torch.float32)
        if x is vectors:
            x = x.clone()
        n = x.shape[0]
        chunk = 1 << 16
        mean = sum(x[lo:lo + chunk].double().sum(dim=0)
                   for lo in range(0, n, chunk)) / n
        x -= mean.float()[None, :]
        amax = torch.stack([x[lo:lo + chunk].abs().amax(dim=0)
                            for lo in range(0, n, chunk)]).amax(dim=0)
        x /= (amax + EPSILON)[None, :]
        return x

    def _build(self, vectors, method="exact", nprobe=16):
        k = self.num_neighbor
        n = self.num_vertex
        secs = {}
        t0 = time.perf_counter()
        if self.vector_normalization:
            vectors = self._normalize(vectors)
        logger.info("building %d-NN graph over %d x %d vectors (%s)",
                    k, n, self.dim, method)
        if method == "ivf":
            dist, labels = ivf_knn(vectors, k, nprobe=nprobe,
                                   device=self.device, timings=secs)
        else:
            dist, labels = exact_knn(vectors, k, device=self.device)
            # drop self (first column)
            dist = dist[:, 1:k + 1]
            labels = labels[:, 1:k + 1]
        del vectors
        _sync(self.device)
        secs["knn"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        weights = perplexity_weights_device(dist, self.perplexity)
        del dist
        _sync(self.device)
        secs["perplexity"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        heads = torch.arange(n, device=self.device).repeat_interleave(k)
        tails = labels.reshape(-1)
        self.edge_weights = reciprocal_average(heads, tails,
                                               weights.reshape(-1), n)
        self.edge_heads = heads
        self.edge_tails = tails
        self.num_edge = int(heads.numel())
        self.vertex_weights = np.ones(n, dtype=np.float64)
        _sync(self.device)
        secs["reciprocal"] = time.perf_counter() - t0
        self.build_seconds = secs

    def info(self):
        return ("#vertex: %d, #nearest neighbor: %d\nperplexity: %g, "
                "vector normalization: %s"
                % (self.num_vertex, self.num_neighbor, self.perplexity,
                   "yes" if self.vector_normalization else "no"))

    def __repr__(self):
        return "KNNGraph<%d vertices, %d-NN>" % (self.num_vertex,
                                                 self.num_neighbor)
