// Random row access for Hopper (sm_90a): three kernels of the row-access
// bench (graphvite_tpu_torch/tools/row_access_bench.py), on float32
// tables [V, D]:
//
//   gather_rows        out[j] = table[ids[j]]
//   rmw_rows           table[ids[j]] += upd[j]      ids unique in the call
//   sweep_add_sorted   table[ids[j]] += upd[j]      ids ascending, repeats
//                                                   summed in sorted order
//
// They replace the TPU kernels of tools/pallas_bench.py, the reference's
// experiments on whether hand-rolled DMA pipelines beat XLA's gather and
// scatter: make_pallas_gather (per-row DMAs HBM -> VMEM with `depth` in
// flight), make_pallas_rmw (per-row DMA in, add, DMA out) and
// make_pallas_sweep (one grid step per 8192-row table tile in VMEM, the
// tile's sorted update slab DMA'd in, a scalar loop adding rows). A TPU
// core reaches device memory through DMAs it must keep in flight itself;
// a Hopper SM keeps its warps' loads in flight, so each kernel here is a
// plain warp-per-row loop and the hardware does the pipelining.
//
// Contract (the callers are in graphvite_tpu_torch/ops/row_access.py):
//   table  [V, D] float32, contiguous (updated in place by the two adds);
//   ids    [N] int32 or int64;
//   upd    [N, D] float32, contiguous;
//   gather: ids outside [0, V) clamp to the nearest row;
//   rmw: ids outside [0, V) are dropped; repeated ids lose updates (the
//        reference's contract; the wrapper can check it);
//   sweep: ids ascending; per tile of `tile_rows` table rows, [bounds[t],
//        bounds[t + 1]) are the positions of its ids (the caller's
//        searchsorted, as the reference computes its lo and cnt outside
//        its kernel); ids >= V are dropped. One CTA per tile; its warps
//        split the tile's positions evenly, and the warp in whose share a
//        run of equal ids starts sums the whole run in float32 in sorted
//        order and writes the row once. No atomics, no cap on a tile's
//        updates, and the partial last tile is a tile like the others.
//
// What bounds them: memory. gather moves N rows in and N rows out; rmw
// reads N rows and N update rows and writes N rows; sweep reads and
// writes the U distinct rows and reads the N update rows; each also
// reads the ids. They do at most N*D adds, far below the card's rate.
// One warp moves a 128-column float32 row as one 16-byte load a lane
// (4-column vectors where D % 4 == 0 and the pointers allow), so a
// 128-column row is one load instruction a lane.

#include "common.cuh"

namespace {

using gv::kWarp;
using gv::kWarpsPerBlock;

constexpr int kSweepWarps = 16;

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

template <typename Id, bool kVec>
__global__ void __launch_bounds__(kWarp * kSweepWarps)
sweep_add_sorted_kernel(float* __restrict__ table, const Id* __restrict__ ids,
                        const float* __restrict__ upd,
                        const int64_t* __restrict__ bounds, int64_t v,
                        int64_t d) {
  const int64_t lo = bounds[blockIdx.x];
  const int64_t hi = bounds[blockIdx.x + 1];
  if (lo >= hi) return;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int64_t share = (hi - lo + kSweepWarps - 1) / kSweepWarps;
  const int64_t begin = lo + warp * share;
  const int64_t end = begin + share < hi ? begin + share : hi;
  for (int64_t p = begin; p < end; ++p) {
    const int64_t id = static_cast<int64_t>(ids[p]);
    if (p > lo && static_cast<int64_t>(ids[p - 1]) == id) continue;
    if (id >= v) return;  // ascending: every later id is past the table
    // the run of `id` starts here; it ends inside the tile, at `hi` at most
    int64_t q = p + 1;
    while (q < hi && static_cast<int64_t>(ids[q]) == id) ++q;
    float* row = table + id * d;
    if (kVec) {
      for (int64_t c = 4 * lane; c < d; c += 4 * kWarp) {
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int64_t r = p; r < q; ++r) {
          acc = add4(acc, gv::load4(upd + r * d + c));
        }
        gv::store4(row + c, add4(gv::load4(row + c), acc));
      }
    } else {
      for (int64_t c = lane; c < d; c += kWarp) {
        float acc = 0.f;
        for (int64_t r = p; r < q; ++r) acc += upd[r * d + c];
        row[c] = row[c] + acc;
      }
    }
  }
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

template <typename Id>
void launch_sweep(float* table, const void* ids, const float* upd,
                  const int64_t* bounds, int64_t tiles, int64_t v, int64_t d,
                  int vec, cudaStream_t s) {
  const Id* i = static_cast<const Id*>(ids);
  const dim3 grid(static_cast<unsigned>(tiles));
  const dim3 block(kWarp * kSweepWarps);
  if (vec) {
    sweep_add_sorted_kernel<Id, true><<<grid, block, 0, s>>>(table, i, upd,
                                                             bounds, v, d);
  } else {
    sweep_add_sorted_kernel<Id, false><<<grid, block, 0, s>>>(table, i, upd,
                                                              bounds, v, d);
  }
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

// bounds: [tiles + 1] int64 positions, tile t's ids at [bounds[t],
// bounds[t + 1]).
int gv_sweep_add_sorted(void* table, const void* ids, int wide,
                        const void* upd, const void* bounds, long long tiles,
                        long long v, long long d, int vec, void* stream) {
  if (tiles <= 0 || d <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* t = static_cast<float*>(table);
  const float* u = static_cast<const float*>(upd);
  const int64_t* b = static_cast<const int64_t*>(bounds);
  if (wide) {
    launch_sweep<int64_t>(t, ids, u, b, tiles, v, d, vec, s);
  } else {
    launch_sweep<int32_t>(t, ids, u, b, tiles, v, d, vec, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
