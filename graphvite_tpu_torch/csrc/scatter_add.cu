// Segmented scatter-add for Hopper (sm_90a):
//     table[ids[j]] += upd[j]   for every j, duplicate ids summed.
//
// Replaces the TPU kernel graphvite_tpu/ops/pallas_scatter.py:
// sweep_scatter_add (and its front end sweep_scatter_add_unsorted). The
// TPU version streams the whole table through VMEM and selects rows with
// one-hot MXU matmuls, because the TPU has no cheap random row access.
// Hopper has it, so this kernel touches only the rows the updates name.
//
// Contract (the callers in graphvite_tpu_torch/ops/scatter.py pass ids
// that are sorted: scatter_add_sorted_ takes them sorted, scatter_add_
// sorts them with a stable sort and permutes the update rows to match):
//   table  [V, W] float32 or bfloat16, contiguous, updated in place;
//   ids    [N] int32, ascending; ids < 0 or >= V are dropped;
//   upd    [N, W] float32, row j belongs to ids[j].
// Each row's updates are summed in float32 registers in sorted order,
// added to the row's value, and the row is written once, cast to the
// table's type. One warp owns each run of equal ids, so every row has
// exactly one writer: no atomics, and the result is deterministic. Ids
// that are not ascending break that: two warps would own one row.
//
// What bounds it: memory. It must read N*W*4 bytes of updates and 4*N
// bytes of ids and read and write the U touched rows (2*U*W*s bytes for
// s-byte elements); it does N*W adds, far below the card's float rate.
// The design reads every byte once: 16-byte vector loads across the
// columns (32 lanes x 4 columns = 128 columns a pass), each run's rows
// streamed once per 128-column pass, and one read-modify-write per row.
// A hub id's long run is summed by a single warp; at the main path's
// sizes (N ~ 12k-28k rows) that serial run, not bandwidth, sets the time.

#include "common.cuh"

namespace {

using gv::kWarp;
using gv::kWarpsPerBlock;

// One warp per sorted position j. The warp whose position heads a run of
// equal in-range ids sums the whole run (past its own position, however
// long) and writes the row; every other warp returns at once.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
scatter_add_kernel(T* __restrict__ table, const int32_t* __restrict__ ids,
                   const float* __restrict__ upd, int64_t n, int64_t v,
                   int64_t w) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                    threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  // j is the same for all lanes of a warp, so every branch below is
  // warp-uniform and the ballot in run_end sees all 32 lanes
  if (j >= n) return;
  const int32_t id = ids[j];
  if (id < 0 || id >= v) return;
  if (j > 0 && ids[j - 1] == id) return;
  const int64_t end = gv::run_end(ids, j, n, id, lane);

  T* row = table + static_cast<int64_t>(id) * w;
  const float* first = upd + j * w;
  if (kVec) {
    for (int64_t c = 4 * lane; c < w; c += 4 * kWarp) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      const float* u = first + c;
#pragma unroll 4
      for (int64_t r = j; r < end; ++r, u += w) {
        const float4 x = gv::load4(u);
        acc.x += x.x;
        acc.y += x.y;
        acc.z += x.z;
        acc.w += x.w;
      }
      const float4 old = gv::load4(row + c);
      gv::store4(row + c, make_float4(old.x + acc.x, old.y + acc.y,
                                      old.z + acc.z, old.w + acc.w));
    }
  } else {
    for (int64_t c = lane; c < w; c += kWarp) {
      float acc = 0.f;
      const float* u = first + c;
#pragma unroll 4
      for (int64_t r = j; r < end; ++r, u += w) acc += *u;
      gv::store1(row + c, gv::to_float(row[c]) + acc);
    }
  }
}

template <typename T>
void launch(void* table, const int32_t* ids, const float* upd, int64_t n,
            int64_t v, int64_t w, int vec, cudaStream_t stream) {
  const dim3 block(kWarp * kWarpsPerBlock);
  const dim3 grid(static_cast<unsigned>((n + kWarpsPerBlock - 1) /
                                        kWarpsPerBlock));
  if (vec) {
    scatter_add_kernel<T, true><<<grid, block, 0, stream>>>(
        static_cast<T*>(table), ids, upd, n, v, w);
  } else {
    scatter_add_kernel<T, false><<<grid, block, 0, stream>>>(
        static_cast<T*>(table), ids, upd, n, v, w);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32 table, 1 = bfloat16 table. vec: 1 when w % 4 == 0
// and the table and update pointers are aligned for 4-element vectors.
// Returns cudaGetLastError() after the launch (0 on success).
int gv_scatter_add(void* table, int dtype, const void* ids, const void* upd,
                   long long n, long long v, long long w, int vec,
                   void* stream) {
  if (n <= 0 || w <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* sid = static_cast<const int32_t*>(ids);
  const float* u = static_cast<const float*>(upd);
  if (dtype == 0) {
    launch<float>(table, sid, u, n, v, w, vec, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(table, sid, u, n, v, w, vec, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
