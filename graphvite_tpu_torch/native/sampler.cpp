// Native host-side sampling kernels, the port's own copy of
// graphvite_tpu/native/sampler.cpp (graphvite_tpu_torch never imports the
// JAX package, so it builds this file itself; the functions the two share
// must stay equal). The CSR builder at the end is the port's own.
//
// Alias-table construction and bulk host sampling are CPU work, written in
// C++ because the pure-numpy fallback is a Python-speed loop. The alias
// consumers run on the device (graphvite_tpu_torch/ops/device_sampler.py).
//
// Exposed via a plain C ABI and loaded with ctypes. All arrays are
// caller-allocated.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <random>
#include <thread>
#include <vector>

extern "C" {

// Walker alias construction, two-stack O(n).
// weights: n doubles (need not be normalized). Outputs:
//   prob[n]  — keep probability for column i
//   alias[n] — donor column
// Returns 0 on success, -1 on invalid weights.
int gv_build_alias(const double* weights, int64_t n, double* prob,
                   int64_t* alias) {
  if (n <= 0) return 0;
  double total = 0.0;
  for (int64_t i = 0; i < n; ++i) total += weights[i];
  if (!(total > 0.0)) return -1;
  const double scale = (double)n / total;
  std::vector<double> scaled((size_t)n);
  std::vector<int64_t> small, large;
  small.reserve((size_t)n);
  large.reserve((size_t)n);
  for (int64_t i = 0; i < n; ++i) {
    scaled[(size_t)i] = weights[i] * scale;
    prob[i] = 1.0;
    alias[i] = i;
    if (scaled[(size_t)i] < 1.0)
      small.push_back(i);
    else
      large.push_back(i);
  }
  while (!small.empty() && !large.empty()) {
    int64_t s = small.back();
    small.pop_back();
    int64_t l = large.back();
    large.pop_back();
    prob[s] = scaled[(size_t)s];
    alias[s] = l;
    scaled[(size_t)l] -= (1.0 - scaled[(size_t)s]);
    if (scaled[(size_t)l] < 1.0)
      small.push_back(l);
    else
      large.push_back(l);
  }
  // leftovers are 1 within float error
  return 0;
}

// Many packed alias tables delimited by offsets[0..m] over flat weights.
// Parallelized over tables (the reference builds per-vertex tables with a
// thread pool, graph.cuh:687-721).
int gv_build_alias_packed(const double* weights, const int64_t* offsets,
                          int64_t m, double* prob, int64_t* alias) {
  std::atomic<int64_t> next(0);
  std::atomic<int> err(0);
  unsigned hw = std::thread::hardware_concurrency();
  unsigned n_threads = hw ? hw : 4;
  if ((int64_t)n_threads > m) n_threads = (unsigned)(m > 0 ? m : 1);
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (unsigned t = 0; t < n_threads; ++t) {
    pool.emplace_back([&]() {
      for (;;) {
        int64_t i = next.fetch_add(1);
        if (i >= m) break;
        int64_t lo = offsets[i], hi = offsets[i + 1];
        if (hi <= lo) continue;
        if (gv_build_alias(weights + lo, hi - lo, prob + lo, alias + lo) != 0)
          err.store(1);
      }
    });
  }
  for (auto& th : pool) th.join();
  return err.load() ? -1 : 0;
}

// Vectorized batch alias sampling (host positive stream for the numpy
// sampler path): out[i] = alias_sample(prob, alias, u1[i], u2[i]).
void gv_alias_sample(const double* prob, const int64_t* alias, int64_t n,
                     const double* u1, const double* u2, int64_t m,
                     int64_t* out) {
  for (int64_t i = 0; i < m; ++i) {
    int64_t idx = (int64_t)(u1[i] * (double)n);
    if (idx >= n) idx = n - 1;
    out[i] = (u2[i] < prob[idx]) ? idx : alias[idx];
  }
}

// First-order random walks over CSR (DeepWalk/LINE augmentation,
// graph.cuh:399-449): W walks of length L+1 starting from given edges.
// chains: [W, L+1] int64 (pre-filled rows), lengths: [W].
// If nbr_prob == nullptr the neighbor choice is uniform.
void gv_random_walks(const int64_t* indptr, const int64_t* indices,
                     const double* nbr_prob, const int64_t* nbr_alias,
                     const int64_t* start_heads, const int64_t* start_tails,
                     int64_t num_walk, int64_t walk_length, uint64_t seed,
                     int64_t* chains, int64_t* lengths) {
  unsigned hw = std::thread::hardware_concurrency();
  unsigned n_threads = hw ? hw : 4;
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  int64_t chunk = (num_walk + n_threads - 1) / n_threads;
  for (unsigned t = 0; t < n_threads; ++t) {
    int64_t lo = (int64_t)t * chunk;
    int64_t hi = lo + chunk < num_walk ? lo + chunk : num_walk;
    if (lo >= hi) break;
    pool.emplace_back([=]() {
      std::mt19937_64 rng(seed + (uint64_t)lo * 0x9E3779B97F4A7C15ull);
      std::uniform_real_distribution<double> uni(0.0, 1.0);
      for (int64_t w = lo; w < hi; ++w) {
        int64_t* chain = chains + w * (walk_length + 1);
        chain[0] = start_heads[w];
        chain[1] = start_tails[w];
        int64_t cur = start_tails[w];
        int64_t len = walk_length;
        for (int64_t j = 2; j <= walk_length; ++j) {
          int64_t lo_e = indptr[cur], deg = indptr[cur + 1] - lo_e;
          if (deg <= 0) {
            len = j - 1;
            break;
          }
          int64_t k = (int64_t)(uni(rng) * (double)deg);
          if (k >= deg) k = deg - 1;
          if (nbr_prob != nullptr) {
            int64_t flat = lo_e + k;
            if (!(uni(rng) < nbr_prob[flat])) k = nbr_alias[flat];
          }
          cur = indices[lo_e + k];
          chain[j] = cur;
        }
        lengths[w] = len;
      }
    });
  }
  for (auto& th : pool) th.join();
}

// Bucketized cuckoo hash over directed edges (u -> v), for O(1) lockstep
// membership tests on the device (node2vec rejection sampling needs
// "candidate in N(prev)" per proposal; a binary search costs
// ceil(log2(max_degree)) sequential gathers per test, this costs exactly
// TWO [4]-int32 row gathers). 2 hash choices x 2 slots per bucket keeps
// insertion safe to ~0.9 load. The hash MUST match the device side
// (ops/device_sampler.py _cuckoo_hashes) bit for bit.
static inline uint32_t gv_mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

static inline uint32_t gv_h1(uint32_t u, uint32_t v, uint32_t mask) {
  return (gv_mix32(u * 0x9E3779B9u ^ gv_mix32(v))) & mask;
}

static inline uint32_t gv_h2(uint32_t u, uint32_t v, uint32_t mask) {
  return (gv_mix32(v * 0x85EBCA6Bu ^ gv_mix32(u ^ 0x5bd1e995u))) & mask;
}

// table: [num_buckets * 4] int32, pre-filled with -1; bucket b holds up
// to two (u, v) pairs at [4b, 4b+1] and [4b+2, 4b+3]. num_buckets must
// be a power of two. Returns 0 on success, 1 if an eviction chain
// exceeded the kick budget (caller doubles num_buckets and retries).
int gv_build_cuckoo(const int32_t* us, const int32_t* vs, int64_t n,
                    int32_t* table, int64_t num_buckets) {
  uint32_t mask = (uint32_t)(num_buckets - 1);
  std::mt19937_64 rng(0x5eedc0ffeeull);
  for (int64_t i = 0; i < n; ++i) {
    int32_t ku = us[i], kv = vs[i];
    bool placed = false;
    for (int kick = 0; kick < 500 && !placed; ++kick) {
      uint32_t b1 = gv_h1((uint32_t)ku, (uint32_t)kv, mask);
      uint32_t b2 = gv_h2((uint32_t)ku, (uint32_t)kv, mask);
      const uint32_t buckets[2] = {b1, b2};
      for (int c = 0; c < 2 && !placed; ++c) {
        int32_t* slot = table + (int64_t)buckets[c] * 4;
        for (int s = 0; s < 2; ++s) {
          if (slot[2 * s] == -1) {
            slot[2 * s] = ku;
            slot[2 * s + 1] = kv;
            placed = true;
            break;
          }
          if (slot[2 * s] == ku && slot[2 * s + 1] == kv) {
            placed = true;  // duplicate edge, already present
            break;
          }
        }
      }
      if (!placed) {
        // evict a random occupant of a random candidate bucket
        uint32_t b = buckets[rng() & 1];
        int s = (int)(rng() & 1);
        int32_t* slot = table + (int64_t)b * 4 + 2 * s;
        int32_t eu = slot[0], ev = slot[1];
        slot[0] = ku;
        slot[1] = kv;
        ku = eu;
        kv = ev;
      }
    }
    if (!placed) return 1;
  }
  return 0;
}

}  // extern "C"

// Stable counting sort of n directed edges by head (the CSR over sources,
// each vertex's edges in their flat order), over `threads` contiguous
// chunks of the edges: per-chunk counts, then each chunk's start in every
// row, then each chunk writes its edges in order. Outputs (caller-
// allocated): indptr[V + 1]; indices[n] (the tails in CSR order) unless
// null; order[n] (the flat edge id at each CSR position) unless null.
// Returns 0, or -1 when a head lies outside [0, V).
template <typename T>
static int gv_csr(const T* heads, const T* tails, int64_t n, int64_t V,
                  int64_t* indptr, T* indices, int64_t* order,
                  int64_t threads) {
  int64_t nt = std::max<int64_t>(1, std::min<int64_t>(threads, 64));
  if (n < (int64_t)1 << 20) nt = 1;
  std::vector<std::vector<int64_t>> cnt(nt);
  std::atomic<int> bad(0);
  auto chunk = [&](int64_t t, int64_t* lo, int64_t* hi) {
    *lo = n * t / nt;
    *hi = n * (t + 1) / nt;
  };
  std::vector<std::thread> pool;
  for (int64_t t = 0; t < nt; ++t) {
    pool.emplace_back([&, t] {
      cnt[t].assign(V, 0);
      int64_t lo, hi;
      chunk(t, &lo, &hi);
      int64_t* c = cnt[t].data();
      for (int64_t e = lo; e < hi; ++e) {
        int64_t h = (int64_t)heads[e];
        if (h < 0 || h >= V) {
          bad = 1;
          return;
        }
        ++c[h];
      }
    });
  }
  for (auto& th : pool) th.join();
  pool.clear();
  if (bad) return -1;
  // per row: each chunk's offset inside the row, the row's length
  std::vector<int64_t> total(V);
  for (int64_t t = 0; t < nt; ++t) {
    pool.emplace_back([&, t] {
      int64_t lo = V * t / nt, hi = V * (t + 1) / nt;
      for (int64_t h = lo; h < hi; ++h) {
        int64_t run = 0;
        for (int64_t k = 0; k < nt; ++k) {
          int64_t c = cnt[k][h];
          cnt[k][h] = run;
          run += c;
        }
        total[h] = run;
      }
    });
  }
  for (auto& th : pool) th.join();
  pool.clear();
  indptr[0] = 0;
  for (int64_t h = 0; h < V; ++h) indptr[h + 1] = indptr[h] + total[h];
  std::vector<int64_t>().swap(total);
  for (int64_t t = 0; t < nt; ++t) {
    pool.emplace_back([&, t] {
      int64_t lo, hi;
      chunk(t, &lo, &hi);
      int64_t* c = cnt[t].data();
      for (int64_t e = lo; e < hi; ++e) {
        int64_t h = (int64_t)heads[e];
        int64_t pos = indptr[h] + c[h]++;
        if (indices) indices[pos] = tails[e];
        if (order) order[pos] = e;
      }
    });
  }
  for (auto& th : pool) th.join();
  return 0;
}

extern "C" {

int gv_csr_i32(const int32_t* heads, const int32_t* tails, int64_t n,
               int64_t V, int64_t* indptr, int32_t* indices, int64_t* order,
               int64_t threads) {
  return gv_csr<int32_t>(heads, tails, n, V, indptr, indices, order,
                         threads);
}

int gv_csr_i64(const int64_t* heads, const int64_t* tails, int64_t n,
               int64_t V, int64_t* indptr, int64_t* indices, int64_t* order,
               int64_t threads) {
  return gv_csr<int64_t>(heads, tails, n, V, indptr, indices, order,
                         threads);
}

}  // extern "C"
