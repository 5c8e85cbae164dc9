// Segmented moment-optimizer row update for Hopper (sm_90a): per unique
// sorted id, sum the gradients (gsum), the squared gradients (gsq) and the
// touch counts of its entries, then apply ONE closed-form c-touch update
// of Momentum, AdaGrad, RMSprop or Adam to the row and its moment rows.
//
// Replaces the TPU kernel graphvite_tpu/ops/pallas_scatter.py:
// sweep_scatter_update (and its front end sweep_scatter_update_unsorted).
// The TPU version streams the whole table and its moments through VMEM and
// accumulates [gsum | gsq | count] per tile row with one-hot MXU matmuls;
// this kernel touches only the rows the ids name.
//
// Contract (the callers are in graphvite_tpu_torch/ops/scatter.py):
//   table   [V, W] float32 or bfloat16, contiguous, updated in place;
//   m1, m2  [V, W] float32 moment tables, in place (m2 only for Adam);
//   ids     [N] int32 or int64; ids < 0 or >= V are dropped. Ascending
//           (scatter_update_sorted_), or in any order with `sort` set
//           (scatter_update_), or ascending with the permutation `order`
//           that made them so;
//   grads   [N, W] float32 summed regularized gradient of each entry;
//   counts  [N] float32 touch count of each entry, or null for 1 each;
//   sqs     [N, W] float32 summed squared gradients, or null for grad^2.
// With a sort or an order, row r of the sorted order is entry order[r] of
// grads, counts and sqs alike, read in place, never copied.
// A row whose counts sum to 0 or less (the front ends' pads) passes through
// untouched, its moments undecayed. Otherwise, with c = max(count, 1) and
// ghat = gsum / c, the update is graphvite_tpu_torch/optim.py:
// moment_delta, written out per element below:
//   1 Momentum  m1 = (1 - w1) m1 + w1 ghat;       d = lr c m1
//   2 AdaGrad   m1 = m1 + gsq;                    d = lr c ghat / (sqrt(m1) + eps)
//   3 RMSprop   m1 = (1 - w1) m1 + w1 gsq / c;    d = lr c ghat / sqrt(m1 + eps)
//   4 Adam      m1 as Momentum, m2 = (1 - w2) m2 + w2 gsq / c;
//                                                 d = lr c m1 / (sqrt(m2) + eps)
// with w = 1 - beta^c computed as optim._one_minus_pow does (its series for
// x = c log(beta) > -1e-4; log(beta) comes from the host, in double), and
// table -= round_to_table_type(lr_scale * d). One warp writes each touched
// row and each of its moment rows once: no float atomics, and the same
// inputs give the same bits.
//
// What bounds it: memory. It must read the entries (N*W*4 bytes of grads,
// as many of squares when given, 4*N of counts and the ids) and read and
// write the U touched rows of the table and of each moment
// (2*U*W*(s + 4*n_moment) bytes); its arithmetic (a few dozen operations
// per element, one expf per row) is far below the card's float rate. What
// held the first version (one warp per run of equal ids) 8x from that bound
// was one warp's latency chain over a hub id's run of 1024-2048 rows. The
// design is segmented.cuh's, as in scatter_add.cu: tiles of R rows, one
// warp per tile and 128-column pass, 4 rows' loads of grads and squares in
// flight; a run inside a tile is updated at once; a run across tile edges
// leaves partial gsum, gsq and count, and the second small kernel adds them
// in tile order, one warp per such run, and only then knows the run's count
// and applies its update. R as in scatter_add.cu (ops/scatter.py:
// tile_rows).

#include "segmented.cuh"

namespace {

using gv::Cols;
using gv::Frag;
using gv::Ids;
using gv::kFullMask;
using gv::kWarp;
using gv::kWarpsPerBlock;

constexpr int kRowsInFlight = 4;
constexpr int kPartsInFlight = 8;

enum MomentType { kMomentum = 1, kAdaGrad = 2, kRMSprop = 3, kAdam = 4 };

struct Moment {
  int type;
  float lr, lr_scale, log_b1, log_b2, eps;
};

// 1 - beta^c for beta ~ 1 without float32 cancellation (optim.py)
__device__ __forceinline__ float one_minus_pow(float log_beta, float c) {
  const float x = c * log_beta;
  return x > -1e-4f ? -x * (1.0f + x / 2.0f + x * x / 6.0f)
                    : 1.0f - expf(x);
}

// One element: updates m1 (and m2) in place and returns lr_scale * delta.
__device__ __forceinline__ float update(const Moment& o, float g, float gsq,
                                        float c, float w1, float w2,
                                        float& m1, float& m2) {
  const float ghat = g / c;
  float delta;
  switch (o.type) {
    case kMomentum:
      m1 = (1.0f - w1) * m1 + w1 * ghat;
      delta = o.lr * c * m1;
      break;
    case kAdaGrad:
      m1 = m1 + gsq;
      delta = o.lr * c * ghat / (sqrtf(m1) + o.eps);
      break;
    case kRMSprop:
      m1 = (1.0f - w1) * m1 + w1 * gsq / c;
      delta = o.lr * c * ghat / sqrtf(m1 + o.eps);
      break;
    default:  // kAdam
      m1 = (1.0f - w1) * m1 + w1 * ghat;
      m2 = (1.0f - w2) * m2 + w2 * gsq / c;
      delta = o.lr * c * m1 / (sqrtf(m2) + o.eps);
      break;
  }
  return o.lr_scale * delta;
}

// The update of row `id` from its run's sums, by the warp that owns the
// run: reads and writes the row and its moment rows once. A run whose
// counts sum to 0 or less registers no touch.
template <typename T, bool kVec>
__device__ __forceinline__ void update_row(T* __restrict__ table,
                                           float* __restrict__ m1,
                                           float* __restrict__ m2, int32_t id,
                                           int64_t w, const Cols<kVec>& cols,
                                           const Frag& g, const Frag& q,
                                           float cnt, const Moment& o) {
  if (!(cnt > 0.f)) return;
  const float c = fmaxf(cnt, 1.f);
  const float w1 = o.type == kAdaGrad ? 0.f : one_minus_pow(o.log_b1, c);
  const float w2 = o.type == kAdam ? one_minus_pow(o.log_b2, c) : 0.f;
  const bool has_m2 = o.type == kAdam;
  const int64_t base = static_cast<int64_t>(id) * w;
  T* row = table + base;
  Frag t = cols.load(row);
  Frag a = cols.load(m1 + base);
  Frag b = has_m2 ? cols.load(m2 + base) : gv::zero_frag();
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    t.x[k] -= gv::round_as(
        update(o, g.x[k], q.x[k], c, w1, w2, a.x[k], b.x[k]), row);
  }
  cols.store(row, t);
  cols.store(m1 + base, a);
  if (has_m2) cols.store(m2 + base, b);
}

struct Partials {
  float* g;          // [tiles, 2, w] partial gsum
  float* q;          // [tiles, 2, w] partial gsq
  float* c;          // [tiles, 2] partial count
  int32_t* id;       // [tiles, 2] the slot's id, -1 when empty
};

// First kernel: one warp per (tile, pass). Runs inside the tile update
// their rows; the runs that cross its edges go to the tile's slots.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
scatter_update_tiles(T* __restrict__ table, float* __restrict__ m1,
                     float* __restrict__ m2, Ids ids,
                     const uint32_t* __restrict__ order,
                     const float* __restrict__ grads,
                     const float* __restrict__ counts,
                     const float* __restrict__ sqs, int64_t n, int64_t v,
                     int64_t w, int r, int passes, int64_t tiles, Moment o,
                     Partials part) {
  // warp-uniform branches: tile, pass, ids and counts are the same in
  // every lane
  const gv::WarpJob job(passes);
  if (job.tile >= tiles) return;
  const gv::Tile tile(ids, order, n, v, job.tile, r, job.lane);
  const Cols<kVec> cols(job.pass, job.lane, w);
  const float lane_count = counts ? counts[tile.src] : 1.f;

  int32_t slot_id[2] = {-1, -1};
  float slot_c[2] = {0.f, 0.f};
  auto close = [&](int32_t id, const Frag& g, const Frag& q, float c,
                   int slot) {
    if (id < 0) return;   // a run of dropped ids
    if (slot < 0) {
      update_row(table, m1, m2, id, w, cols, g, q, c, o);
    } else {
      const int64_t at = (2 * job.tile + slot) * w;
      cols.store(part.g + at, g);
      cols.store(part.q + at, q);
      slot_id[slot] = id;
      slot_c[slot] = c;
    }
  };

  Frag g = gv::zero_frag(), q = g;
  float c = 0.f;
  int32_t cur = tile.first_id;
  bool first_run = true;
  for (int i0 = 0; i0 < tile.rows; i0 += kRowsInFlight) {
    Frag x[kRowsInFlight], s[kRowsInFlight];
    int32_t id[kRowsInFlight];
    float cnt[kRowsInFlight];
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      const int i = (i0 + u) % kWarp;
      id[u] = __shfl_sync(kFullMask, tile.id, i);
      cnt[u] = __shfl_sync(kFullMask, lane_count, i);
      const int64_t src = __shfl_sync(kFullMask, tile.src, i);
      const bool live = i0 + u < tile.rows && id[u] >= 0;
      x[u] = live ? cols.load(grads + src * w) : gv::zero_frag();
      if (sqs) s[u] = live ? cols.load(sqs + src * w) : gv::zero_frag();
    }
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      if (i0 + u < tile.rows) {
        if (id[u] != cur) {
          close(cur, g, q, c, first_run && tile.first_open ? 0 : -1);
          first_run = false;
          cur = id[u];
          g = q = gv::zero_frag();
          c = 0.f;
        }
        gv::add(g, x[u]);
        if (sqs) {
          gv::add(q, s[u]);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) q.x[k] += x[u].x[k] * x[u].x[k];
        }
        c += cnt[u];
      }
    }
  }
  // a tile that lies whole inside a longer run stores its sums once, as a
  // head partial
  close(cur, g, q, c,
        first_run && tile.first_open ? 0 : (tile.last_open ? 1 : -1));
  if (job.pass == 0 && job.lane == 0) {
    for (int slot = 0; slot < 2; ++slot) {
      part.id[2 * job.tile + slot] = slot_id[slot];
      part.c[2 * job.tile + slot] = slot_c[slot];
    }
  }
}

// Second kernel: the warp of a tile whose tail slot is live owns that run.
// It adds the head partials of the tiles after it, in tile order, for as
// long as they carry the run's id, and applies the run's one update.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
scatter_update_runs(T* __restrict__ table, float* __restrict__ m1,
                    float* __restrict__ m2, int64_t w, int passes,
                    int64_t tiles, Moment o, Partials part) {
  const gv::WarpJob job(passes);
  if (job.tile >= tiles) return;
  const int64_t first = 2 * job.tile + 1;
  const int32_t id = part.id[first];
  if (id < 0) return;
  const Cols<kVec> cols(job.pass, job.lane, w);
  Frag g = cols.load(part.g + first * w);
  Frag q = cols.load(part.q + first * w);
  float c = part.c[first];
  for (int64_t t = job.tile + 1;; t += kWarp) {
    const int m = gv::continuing(part.id, t, tiles, id, job.lane);
    for (int k0 = 0; k0 < m; k0 += kPartsInFlight) {
      Frag x[kPartsInFlight], s[kPartsInFlight];
      float cnt[kPartsInFlight];
#pragma unroll
      for (int u = 0; u < kPartsInFlight; ++u) {
        if (k0 + u < m) {
          const int64_t slot = 2 * (t + k0 + u);
          x[u] = cols.load(part.g + slot * w);
          s[u] = cols.load(part.q + slot * w);
          cnt[u] = part.c[slot];
        }
      }
#pragma unroll
      for (int u = 0; u < kPartsInFlight; ++u) {
        if (k0 + u < m) {
          gv::add(g, x[u]);
          gv::add(q, s[u]);
          c += cnt[u];
        }
      }
    }
    if (m < kWarp) break;
  }
  update_row(table, m1, m2, id, w, cols, g, q, c, o);
}

struct Entries {
  const float* grads;
  const float* counts;
  const float* sqs;
};

template <typename T, bool kVec>
void launch(void* table, float* m1, float* m2, const Ids& ids,
            const uint32_t* order, const Entries& e, int64_t n, int64_t v,
            int64_t w, int r, const Moment& o, char* base,
            const gv::Scratch& s, cudaStream_t stream) {
  const int64_t tiles = gv::num_tiles(n, r);
  const int passes = gv::num_passes(w);
  const dim3 block(kWarp * kWarpsPerBlock);
  const dim3 grid(gv::num_blocks(tiles, passes));
  T* t = static_cast<T*>(table);
  const Partials part{reinterpret_cast<float*>(base + s.part[0]),
                      reinterpret_cast<float*>(base + s.part[1]),
                      reinterpret_cast<float*>(base + s.part_c),
                      reinterpret_cast<int32_t*>(base + s.part_id)};
  scatter_update_tiles<T, kVec><<<grid, block, 0, stream>>>(
      t, m1, m2, ids, order, e.grads, e.counts, e.sqs, n, v, w, r, passes,
      tiles, o, part);
  scatter_update_runs<T, kVec><<<grid, block, 0, stream>>>(
      t, m1, m2, w, passes, tiles, o, part);
}

}  // namespace

extern "C" {

// Bytes of scratch gv_scatter_update needs at this shape (the wrapper
// allocates them with torch.empty), or -1 - (a CUDA error code).
long long gv_scatter_update_scratch(long long n, long long v, long long w,
                                    int r, int sort) {
  if (n <= 0 || w <= 0) return 0;
  return gv::scratch_bytes(n, v, w, r, 2, sort != 0);
}

// dtype: 0 = float32 table, 1 = bfloat16 table. ids64, sort, order, r,
// scratch: as gv_scatter_add takes them (scratch_bytes >=
// gv_scatter_update_scratch(n, v, w, r, sort)). type: 1 Momentum,
// 2 AdaGrad, 3 RMSprop, 4 Adam. log_b1: log of momentum (Momentum), alpha
// (RMSprop) or beta1 (Adam); log_b2: log of beta2 (Adam). m2, counts and
// sqs may be null (m2 must not be for Adam). vec: 1 when w % 4 == 0 and
// every row pointer is aligned for 4-element vectors. Returns the first
// CUDA error of the launches (0 on success).
int gv_scatter_update(void* table, int dtype, void* m1, void* m2,
                      const void* ids, int ids64, int sort, const void* order,
                      const void* grads, const void* counts, const void* sqs,
                      long long n, long long v, long long w, int r, int type,
                      float lr, float lr_scale, float log_b1, float log_b2,
                      float eps, int vec, void* scratch,
                      long long scratch_bytes, void* stream) {
  if (n <= 0 || w <= 0) return 0;
  if (type < kMomentum || type > kAdam || m1 == nullptr ||
      (type == kAdam && m2 == nullptr) || r < 1 || r > gv::kMaxTileRows ||
      v <= 0 || v >= (1ll << 31) || n >= (1ll << 31) ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const gv::Scratch s = gv::plan_scratch(n, w, r, 2, sort != 0);
  if (scratch == nullptr || static_cast<size_t>(scratch_bytes) < s.temp) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  char* base = static_cast<char*>(scratch);
  Ids sid{ids, ids64};
  const uint32_t* ord = static_cast<const uint32_t*>(order);
  if (sort) {
    const cudaError_t err = gv::sort_ids(Ids{ids, ids64}, n, v, base,
                                         scratch_bytes, s, st, sid, ord);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Moment o{type, lr, lr_scale, log_b1, log_b2, eps};
  float* a = static_cast<float*>(m1);
  float* b = static_cast<float*>(m2);
  const Entries e{static_cast<const float*>(grads),
                  static_cast<const float*>(counts),
                  static_cast<const float*>(sqs)};
  auto fn = dtype == 0 ? (vec ? launch<float, true> : launch<float, false>)
                       : (vec ? launch<__nv_bfloat16, true>
                              : launch<__nv_bfloat16, false>);
  fn(table, a, b, sid, ord, e, n, v, w, r, o, base, s, st);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
