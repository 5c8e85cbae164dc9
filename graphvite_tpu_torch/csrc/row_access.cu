// Random row access for Hopper (sm_90a): three kernels of the row-access
// bench (graphvite_tpu_torch/tools/row_access_bench.py), on float32
// tables [V, D]:
//
//   gather_rows        out[j] = table[ids[j]]
//   rmw_rows           table[ids[j]] += upd[j]      ids unique in the call
//   sweep_add_sorted   table[ids[j]] += upd[j]      ids ascending, repeats
//                                                   summed in a fixed order
//
// They replace the TPU kernels of tools/pallas_bench.py, the reference's
// experiments on whether hand-rolled DMA pipelines beat XLA's gather and
// scatter: make_pallas_gather (per-row DMAs HBM -> VMEM with `depth` in
// flight), make_pallas_rmw (per-row DMA in, add, DMA out) and
// make_pallas_sweep (one grid step per 8192-row table tile in VMEM, the
// tile's sorted update slab DMA'd in, a scalar loop adding rows). A TPU
// core reaches device memory through DMAs it must keep in flight itself;
// a Hopper SM keeps its warps' loads in flight, so the gather and the RMW
// are plain warp-per-row loops and the hardware does the pipelining.
//
// Contract (the callers are in graphvite_tpu_torch/ops/row_access.py):
//   table  [V, D] float32, contiguous (updated in place by the two adds);
//   ids    [N] int32 or int64;
//   upd    [N, D] float32, contiguous;
//   gather: ids outside [0, V) clamp to the nearest row;
//   rmw: ids outside [0, V) are dropped; repeated ids lose updates (the
//        reference's contract; the wrapper can check it);
//   sweep: ids ascending; ids outside [0, V) are dropped; no float
//        atomics, each distinct row written once, and a result that
//        depends only on the inputs.
//
// What bounds them: memory. gather moves N rows in and N rows out; rmw
// reads N rows and N update rows and writes N rows; sweep reads and
// writes the U distinct rows and reads the N update rows (2 U D 4 + N D 4
// + 4 N bytes); each also reads the ids. They do at most N*D adds, far
// below the card's rate. One warp moves a 128-column float32 row as one
// 16-byte load a lane (4-column vectors where D % 4 == 0 and the pointers
// allow).
//
// The sweep. Work is split by sorted position, not by table row, so every
// CTA moves the same bytes whatever the lengths of the runs of equal ids
// (a tile-per-CTA split gave the first table tile ~15% of hub-skewed ids,
// and one warp summed a hub's ~1,300 update rows one dependent load after
// another). The N positions are cut into chunks of C (ops/row_access.py:
// chunk_rows, from the width alone: C * min(D, 128) * 4 <= 32 KB, so C = 64
// at D = 128, 256 at D <= 32); an item is one chunk and one pass of 128
// columns (one pass for D <= 128).
//   * Persistent CTAs of 8 warps (2 per SM, as registers allow: 264)
//     walk the items b, b + G, b + 2G, ... through a ring of 3 stages in
//     shared memory. Each stage holds an item's update rows (C * min(D,
//     128) floats) and its ids, brought in by TMA bulk copies
//     (cp.async.bulk, completion on the stage's mbarrier) that warp 0
//     keeps 3 items in flight, so no warp waits on an update row. At D = 128
//     a stage is 33,280 bytes, a CTA ~100 KB of shared memory.
//   * Run boundaries are found in shared memory (one thread a position, a
//     ballot and a prefix over the 8 warps), and the two neighbouring ids
//     beyond the chunk's edges are loaded before the stage is waited on.
//   * Each warp owns whole runs of the chunk (run r to warp r % 8) and
//     takes them 8 at a time: it issues the 8 table-row loads first, then
//     sums the runs' update rows from shared memory, then adds and stores.
//     8 warps x 8 rows x 512 bytes x 2 CTAs is 64 KB of table rows in
//     flight per SM besides ~130 KB of TMA stages, above the ~40 KB that
//     Little's law asks at 3.35 TB/s and ~1.5 us of loaded latency.
//   * A run that crosses a chunk's edge is not written by the chunk. Its
//     part is stored in scratch in one of the chunk's two slots, as in
//     segmented.cuh: slot 0 (head) for the run that came in from the chunk
//     before, slot 1 (tail) for the run that starts here and goes on; a
//     chunk wholly inside one run stores it once, in slot 0. Both slots'
//     ids are written for every chunk (-1: empty), so the scratch needs no
//     zero fill. A second kernel on the same stream has one warp per tail
//     slot add the run's head parts in chunk order and write the row once.
//   * The order of every sum is fixed by the shape: a run's part in a
//     chunk is summed in float32 from zero in sorted order; parts are
//     combined in chunk order; the total is added to the row once.
//     sweep_add_sorted_plain does the same adds in the same order.
// Where D % 4 != 0 or a pointer is not 16-byte aligned, the same kernel
// stages each item's rows with coalesced loads by all its threads (one
// stage, no TMA) and reads columns one at a time.

#include "common.cuh"

namespace {

using gv::kWarp;
using gv::kWarpsPerBlock;

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

template <typename Id, bool kVec>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
gather_rows_kernel(const float* __restrict__ table, const Id* __restrict__ ids,
                   float* __restrict__ out, int64_t n, int64_t v, int64_t d) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                    threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (j >= n) return;
  int64_t id = static_cast<int64_t>(ids[j]);
  id = id < 0 ? 0 : (id >= v ? v - 1 : id);
  const float* row = table + id * d;
  float* dst = out + j * d;
  if (kVec) {
    for (int64_t c = 4 * lane; c < d; c += 4 * kWarp) {
      gv::store4(dst + c, gv::load4(row + c));
    }
  } else {
    for (int64_t c = lane; c < d; c += kWarp) dst[c] = row[c];
  }
}

template <typename Id, bool kVec>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
rmw_rows_kernel(float* __restrict__ table, const Id* __restrict__ ids,
                const float* __restrict__ upd, int64_t n, int64_t v,
                int64_t d) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                    threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (j >= n) return;
  const int64_t id = static_cast<int64_t>(ids[j]);
  if (id < 0 || id >= v) return;
  float* row = table + id * d;
  const float* u = upd + j * d;
  if (kVec) {
    for (int64_t c = 4 * lane; c < d; c += 4 * kWarp) {
      gv::store4(row + c, add4(gv::load4(row + c), gv::load4(u + c)));
    }
  } else {
    for (int64_t c = lane; c < d; c += kWarp) row[c] = row[c] + u[c];
  }
}

// ---------------------------------------------------------------------------
// the sweep
// ---------------------------------------------------------------------------

constexpr int kSweepThreads = 256;
constexpr int kSweepWarps = kSweepThreads / kWarp;
constexpr int kMaxChunk = kSweepThreads;   // one thread a position
constexpr int kStages = 3;                 // ring depth of the TMA route
constexpr int kBatch = 8;                  // runs whose rows a warp loads at once
constexpr int kPassCols = 4 * kWarp;       // columns of one pass
constexpr int kBarBytes = 128;             // the stages' mbarriers
constexpr int kSweepMinCtas = 2;          // CTAs per SM: <= 128 registers

struct SweepShape {
  int64_t n, v, d, chunks, items;
  int chunk, passes, pcols;   // pcols: floats of a staged row, min(D, 128)
  int64_t ids_bytes, stage_bytes;
};

inline int64_t align128(int64_t x) { return (x + 127) & ~static_cast<int64_t>(127); }

SweepShape sweep_shape(int64_t n, int64_t v, int64_t d, int chunk) {
  SweepShape s;
  s.n = n;
  s.v = v;
  s.d = d;
  s.chunk = chunk;
  s.passes = static_cast<int>((d + kPassCols - 1) / kPassCols);
  s.pcols = static_cast<int>(d < kPassCols ? d : kPassCols);
  s.chunks = (n + chunk - 1) / chunk;
  s.items = s.chunks * s.passes;
  s.ids_bytes = align128(static_cast<int64_t>(chunk) * 8);
  s.stage_bytes = s.ids_bytes + align128(static_cast<int64_t>(chunk) * s.pcols * 4);
  return s;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// TMA bulk copy global -> shared; completion counted on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

template <typename Id>
__device__ __forceinline__ int32_t live_id(Id x, int64_t v) {
  const int64_t y = static_cast<int64_t>(x);
  return (y < 0 || y >= v) ? -1 : static_cast<int32_t>(y);
}

// The 4 columns a lane owns in one pass of width w (<= 128): with vectors
// 4 neighbours (one 16-byte access), without 4 columns a warp apart.
// `row` points at the pass's first column; columns >= w read 0 and are not
// written.
template <bool kVec>
struct Lane4 {
  int c0, w;
  __device__ __forceinline__ Lane4(int lane, int width)
      : c0(kVec ? 4 * lane : lane), w(width) {}
  __device__ __forceinline__ int col(int k) const {
    return kVec ? c0 + k : c0 + kWarp * k;
  }
  __device__ __forceinline__ float4 load(const float* row) const {
    if constexpr (kVec) {
      return c0 < w ? gv::load4(row + c0) : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      float f[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) f[k] = col(k) < w ? row[col(k)] : 0.f;
      return make_float4(f[0], f[1], f[2], f[3]);
    }
  }
  __device__ __forceinline__ void store(float* row, float4 x) const {
    if constexpr (kVec) {
      if (c0 < w) gv::store4(row + c0, x);
    } else {
      const float f[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (col(k) < w) row[col(k)] = f[k];
      }
    }
  }
};

// One item: chunk `chunk` (positions [start, start + rows)) and column
// pass `pass` (columns [pass * 128, pass * 128 + w)).
struct Item {
  int64_t chunk, start;
  int pass, rows, w;
  __device__ __forceinline__ Item(int64_t it, const SweepShape& s) {
    chunk = it / s.passes;
    pass = static_cast<int>(it % s.passes);
    start = chunk * s.chunk;
    rows = static_cast<int>(s.n - start < s.chunk ? s.n - start : s.chunk);
    const int64_t left = s.d - static_cast<int64_t>(pass) * kPassCols;
    w = static_cast<int>(left < kPassCols ? left : kPassCols);
  }
};

// part_id [chunks, 2]: the ids of each chunk's head and tail slots (-1:
// empty); part [chunks, 2, D]: their partial sums.
template <typename Id, bool kTma>
__global__ void __launch_bounds__(kSweepThreads, kSweepMinCtas)
sweep_chunks_kernel(float* __restrict__ table, const Id* __restrict__ ids,
                    const float* __restrict__ upd,
                    int32_t* __restrict__ part_id, float* __restrict__ part,
                    SweepShape s) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int32_t cid[kMaxChunk];          // the chunk's ids, -1 dropped
  __shared__ int32_t rstart[kMaxChunk + 1];   // first position of each run
  __shared__ int32_t wcount[kSweepWarps];
  __shared__ int32_t open[2];                 // head, tail run goes on
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  const int tid = threadIdx.x;
  const int warp = tid / kWarp, lane = tid % kWarp;
  // the ids come by TMA too where their slab is 16-byte aligned
  const bool ids_staged =
      kTma && reinterpret_cast<uintptr_t>(ids) % 16 == 0;
  auto stage_ids = [&](int st) {
    return reinterpret_cast<Id*>(smem + kBarBytes + st * s.stage_bytes);
  };
  auto stage_rows = [&](int st) {
    return reinterpret_cast<float*>(smem + kBarBytes + st * s.stage_bytes +
                                    s.ids_bytes);
  };
  auto staged_ids = [&](const Item& x) {
    return ids_staged ? static_cast<int>(
                            (static_cast<uint32_t>(x.rows) * sizeof(Id)) & ~15u) /
                            static_cast<int>(sizeof(Id))
                      : 0;
  };
  // warp 0: bring item `it` into stage `st`
  auto issue = [&](int64_t it, int st) {
    const Item x(it, s);
    const uint32_t id_bytes = staged_ids(x) * sizeof(Id);
    const uint32_t row_bytes = static_cast<uint32_t>(x.w) * 4;
    if (lane == 0) {
      mbar_expect_tx(&bars[st], id_bytes + row_bytes * x.rows);
    }
    __syncwarp();
    float* dst = stage_rows(st);
    const float* src = upd + x.start * s.d + x.pass * kPassCols;
    if (s.passes == 1) {   // the rows are one contiguous slab
      if (lane == 0) bulk_load(dst, src, row_bytes * x.rows, &bars[st]);
    } else {
      for (int r = lane; r < x.rows; r += kWarp) {
        bulk_load(dst + r * s.pcols, src + r * s.d, row_bytes, &bars[st]);
      }
    }
    if (lane == 1 && id_bytes) {
      bulk_load(stage_ids(st), ids + x.start, id_bytes, &bars[st]);
    }
  };

  if (kTma) {
    if (tid == 0) {
      for (int st = 0; st < kStages; ++st) mbar_init(&bars[st]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (warp == 0) {
      for (int st = 0; st < kStages; ++st) {
        const int64_t it = blockIdx.x + static_cast<int64_t>(st) * gridDim.x;
        if (it < s.items) issue(it, st);
      }
    }
  }

  int64_t k = 0;
  for (int64_t it = blockIdx.x; it < s.items; it += gridDim.x, ++k) {
    const int st = kTma ? static_cast<int>(k % kStages) : 0;
    const Item x(it, s);
    // the ids just beyond the chunk's edges, loaded before the wait
    int32_t edge = -1;
    if (tid == 0 && x.start > 0) edge = live_id(ids[x.start - 1], s.v);
    if (tid == kWarp && x.start + x.rows < s.n) {
      edge = live_id(ids[x.start + x.rows], s.v);
    }
    float* rows = stage_rows(st);
    int staged = 0;
    if (kTma) {
      mbar_wait(&bars[st], static_cast<uint32_t>((k / kStages) & 1));
      staged = staged_ids(x);
    } else {
      const float* src = upd + x.start * s.d + x.pass * kPassCols;
      for (int e = tid; e < x.rows * x.w; e += kSweepThreads) {
        const int r = e / x.w, c = e % x.w;
        rows[r * s.pcols + c] = src[r * s.d + c];
      }
    }

    // the chunk's runs: rstart[0 .. runs), rstart[runs] = rows
    if (tid < x.rows) {
      cid[tid] = live_id(tid < staged ? stage_ids(st)[tid] : ids[x.start + tid],
                         s.v);
    }
    __syncthreads();
    const bool first = tid < x.rows && (tid == 0 || cid[tid] != cid[tid - 1]);
    const unsigned mask = __ballot_sync(kFullMask, first);
    if (lane == 0) wcount[warp] = __popc(mask);
    if (tid == 0) open[0] = edge >= 0 && edge == cid[0];
    if (tid == kWarp) open[1] = edge >= 0 && edge == cid[x.rows - 1];
    __syncthreads();
    int before = 0, runs = 0;
#pragma unroll
    for (int w = 0; w < kSweepWarps; ++w) {
      before += w < warp ? wcount[w] : 0;
      runs += wcount[w];
    }
    if (first) rstart[before + __popc(mask & ((1u << lane) - 1))] = tid;
    if (tid == 0) rstart[runs] = x.rows;
    const bool head_open = open[0];
    // a chunk wholly inside one run keeps it in the head slot only
    const bool tail_open = open[1] && !(runs == 1 && head_open);
    if (tid == 0 && x.pass == 0) {
      part_id[2 * x.chunk] = head_open ? cid[0] : -1;
      part_id[2 * x.chunk + 1] = tail_open ? cid[x.rows - 1] : -1;
    }
    __syncthreads();

    // runs r = warp, warp + 8, ...: kBatch rows in flight, then the sums
    const Lane4<kTma> cols(lane, x.w);
    float* ptable = table + x.pass * kPassCols;
    float* ppart = part + x.pass * kPassCols;
    for (int base = warp; base < runs; base += kSweepWarps * kBatch) {
      float4 old[kBatch];
      float* dst[kBatch];   // the row or the slot the run's sum goes to
      bool to_table[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int r = base + b * kSweepWarps;
        dst[b] = nullptr;
        to_table[b] = false;
        const int32_t id = r < runs ? cid[rstart[r]] : -1;
        if (id < 0) continue;
        if (r == 0 && head_open) {
          dst[b] = ppart + 2 * x.chunk * s.d;
        } else if (r == runs - 1 && tail_open) {
          dst[b] = ppart + (2 * x.chunk + 1) * s.d;
        } else {
          dst[b] = ptable + static_cast<int64_t>(id) * s.d;
          to_table[b] = true;
          old[b] = cols.load(dst[b]);
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (dst[b] == nullptr) continue;
        const int r = base + b * kSweepWarps;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int q = rstart[r]; q < rstart[r + 1]; ++q) {
          acc = add4(acc, cols.load(rows + q * s.pcols));
        }
        cols.store(dst[b], to_table[b] ? add4(old[b], acc) : acc);
      }
    }
    __syncthreads();   // the stage, cid and rstart are free again

    if (kTma && warp == 0) {
      const int64_t next = it + static_cast<int64_t>(kStages) * gridDim.x;
      if (next < s.items) {
        // the stage was read through the generic proxy; TMA writes it next
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        issue(next, st);
      }
    }
  }
}

// One warp per (chunk, pass) whose tail slot holds a run: the run's part
// there plus the head parts of the chunks it goes on into, in chunk order,
// added to its row once.
template <bool kVec>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
sweep_combine_kernel(float* __restrict__ table,
                     const int32_t* __restrict__ part_id,
                     const float* __restrict__ part, SweepShape s) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                    threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int64_t t = g / s.passes;
  const int pass = static_cast<int>(g % s.passes);
  if (t >= s.chunks) return;
  const int32_t id = part_id[2 * t + 1];
  if (id < 0) return;
  // chunks t + 1 .. t + m go on with the run (32 looked at a time)
  int64_t m = 0;
  for (;;) {
    const int64_t tt = t + 1 + m + lane;
    const bool same = tt < s.chunks && part_id[2 * tt] == id;
    const unsigned ballot = __ballot_sync(kFullMask, same);
    const int c = ballot == kFullMask ? kWarp : __ffs(~ballot) - 1;
    m += c;
    if (c < kWarp) break;
  }
  const int64_t left = s.d - static_cast<int64_t>(pass) * kPassCols;
  const Lane4<kVec> cols(lane, static_cast<int>(left < kPassCols ? left : kPassCols));
  const float* p = part + pass * kPassCols;
  float4 acc = cols.load(p + (2 * t + 1) * s.d);
#pragma unroll 4
  for (int64_t j = 1; j <= m; ++j) {
    acc = add4(acc, cols.load(p + 2 * (t + j) * s.d));
  }
  float* row = table + static_cast<int64_t>(id) * s.d + pass * kPassCols;
  cols.store(row, add4(cols.load(row), acc));
}

dim3 row_grid(int64_t n) {
  return dim3(static_cast<unsigned>((n + kWarpsPerBlock - 1) /
                                    kWarpsPerBlock));
}

template <typename Id>
void launch_gather(const float* table, const void* ids, float* out, int64_t n,
                   int64_t v, int64_t d, int vec, cudaStream_t s) {
  const Id* i = static_cast<const Id*>(ids);
  const dim3 block(kWarp * kWarpsPerBlock);
  if (vec) {
    gather_rows_kernel<Id, true><<<row_grid(n), block, 0, s>>>(table, i, out,
                                                               n, v, d);
  } else {
    gather_rows_kernel<Id, false><<<row_grid(n), block, 0, s>>>(table, i,
                                                                out, n, v, d);
  }
}

template <typename Id>
void launch_rmw(float* table, const void* ids, const float* upd, int64_t n,
                int64_t v, int64_t d, int vec, cudaStream_t s) {
  const Id* i = static_cast<const Id*>(ids);
  const dim3 block(kWarp * kWarpsPerBlock);
  if (vec) {
    rmw_rows_kernel<Id, true><<<row_grid(n), block, 0, s>>>(table, i, upd, n,
                                                            v, d);
  } else {
    rmw_rows_kernel<Id, false><<<row_grid(n), block, 0, s>>>(table, i, upd,
                                                             n, v, d);
  }
}

template <typename Id, bool kTma>
cudaError_t launch_sweep(float* table, const void* ids, const float* upd,
                         int32_t* part_id, float* part, const SweepShape& sh,
                         cudaStream_t s) {
  auto kernel = sweep_chunks_kernel<Id, kTma>;
  const size_t smem = kBarBytes + (kTma ? kStages : 1) * sh.stage_bytes;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // every chunk_rows() chunk fits kSweepMinCtas CTAs on an SM (registers
  // allow no more), so these are all resident at once
  const int64_t ctas = static_cast<int64_t>(kSweepMinCtas) * sms;
  const unsigned grid =
      static_cast<unsigned>(sh.items < ctas ? sh.items : ctas);
  kernel<<<grid, kSweepThreads, smem, s>>>(
      table, static_cast<const Id*>(ids), upd, part_id, part, sh);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const unsigned combine = static_cast<unsigned>(
      (sh.items + kWarpsPerBlock - 1) / kWarpsPerBlock);
  sweep_combine_kernel<kTma><<<combine, kWarp * kWarpsPerBlock, 0, s>>>(
      table, part_id, part, sh);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// wide: 1 for int64 ids, 0 for int32. vec: 1 when d % 4 == 0 and every
// row pointer is aligned for 4-float vectors. Each returns
// cudaGetLastError() after its launch (0 on success).
int gv_gather_rows(const void* table, const void* ids, int wide, void* out,
                   long long n, long long v, long long d, int vec,
                   void* stream) {
  if (n <= 0 || d <= 0) return 0;
  if (v <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(table);
  float* o = static_cast<float*>(out);
  if (wide) {
    launch_gather<int64_t>(t, ids, o, n, v, d, vec, s);
  } else {
    launch_gather<int32_t>(t, ids, o, n, v, d, vec, s);
  }
  return static_cast<int>(cudaGetLastError());
}

int gv_rmw_rows(void* table, const void* ids, int wide, const void* upd,
                long long n, long long v, long long d, int vec,
                void* stream) {
  if (n <= 0 || d <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* t = static_cast<float*>(table);
  const float* u = static_cast<const float*>(upd);
  if (wide) {
    launch_rmw<int64_t>(t, ids, u, n, v, d, vec, s);
  } else {
    launch_rmw<int32_t>(t, ids, u, n, v, d, vec, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// chunk: positions per chunk, a multiple of 4 up to 256
// (ops/row_access.py: chunk_rows). part_id: [ceil(n / chunk), 2] int32
// and part: [ceil(n / chunk), 2, d] float32, uninitialized scratch. vec:
// the TMA route (d % 4 == 0, table, upd and part 16-byte aligned).
int gv_sweep_add_sorted(void* table, const void* ids, int wide,
                        const void* upd, void* part_id, void* part,
                        long long n, long long v, long long d, int chunk,
                        int vec, void* stream) {
  if (n <= 0 || d <= 0) return 0;
  if (v <= 0 || v > INT32_MAX || chunk < 4 || chunk > kMaxChunk ||
      chunk % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* t = static_cast<float*>(table);
  const float* u = static_cast<const float*>(upd);
  int32_t* pid = static_cast<int32_t*>(part_id);
  float* p = static_cast<float*>(part);
  const SweepShape sh = sweep_shape(n, v, d, chunk);
  cudaError_t err;
  if (wide) {
    err = vec ? launch_sweep<int64_t, true>(t, ids, u, pid, p, sh, s)
              : launch_sweep<int64_t, false>(t, ids, u, pid, p, sh, s);
  } else {
    err = vec ? launch_sweep<int32_t, true>(t, ids, u, pid, p, sh, s)
              : launch_sweep<int32_t, false>(t, ids, u, pid, p, sh, s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
