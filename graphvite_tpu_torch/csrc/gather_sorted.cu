// Row gather for Hopper (sm_90a):
//     out[j] = table[clamp(ids[j], 0, V - 1)]   for every j,
// converted to the output's type (float32 or bfloat16) in the kernel.
//
// Replaces the TPU kernel graphvite_tpu/ops/pallas_scatter.py:
// sweep_gather_sorted. The TPU version streams the table tiles that a
// sorted id chunk spans through VMEM and selects rows with one-hot MXU
// matmuls, because the TPU's per-row gather is slow. Hopper reads rows
// at random cheaply, so this kernel reads only the rows the ids name.
//
// Contract (the caller, graphvite_tpu_torch/ops/gather.py):
//   table  [V, W] float32 or bfloat16, contiguous;
//   ids    [N] int32; any order is right, ascending (the sorted heads of
//          the edge route) keeps neighbouring warps on neighbouring rows;
//          ids outside [0, V) clamp to the nearest row, as JAX clamps a
//          gather;
//   out    [N, W] float32 or bfloat16, contiguous.
//
// What bounds it: memory. It must read the U distinct rows it names
// (U*W*s bytes for s-byte elements), the ids (4*N bytes) and write N*W
// output elements; it computes nothing. One warp copies each output row:
// 16-byte vector loads and stores of 4 float32 columns a lane (8-byte
// loads for bfloat16 rows), 128 columns a pass, so a row of 128 float32
// values is one load and one store per lane. Rows repeated by a hub id
// are read again from L2.

#include "common.cuh"

namespace {

using gv::kWarp;
using gv::kWarpsPerBlock;

template <typename Tin, typename Tout, bool kVec>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
gather_kernel(const Tin* __restrict__ table, const int32_t* __restrict__ ids,
              Tout* __restrict__ out, int64_t n, int64_t v, int64_t w) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                    threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (j >= n) return;
  int64_t id = ids[j];
  id = id < 0 ? 0 : (id >= v ? v - 1 : id);
  const Tin* row = table + id * w;
  Tout* dst = out + j * w;
  if (kVec) {
    for (int64_t c = 4 * lane; c < w; c += 4 * kWarp) {
      gv::store4(dst + c, gv::load4(row + c));
    }
  } else {
    for (int64_t c = lane; c < w; c += kWarp) {
      gv::store1(dst + c, gv::to_float(row[c]));
    }
  }
}

template <typename Tin, typename Tout>
void launch(const void* table, const int32_t* ids, void* out, int64_t n,
            int64_t v, int64_t w, int vec, cudaStream_t stream) {
  const dim3 block(kWarp * kWarpsPerBlock);
  const dim3 grid(static_cast<unsigned>((n + kWarpsPerBlock - 1) /
                                        kWarpsPerBlock));
  const Tin* t = static_cast<const Tin*>(table);
  Tout* o = static_cast<Tout*>(out);
  if (vec) {
    gather_kernel<Tin, Tout, true><<<grid, block, 0, stream>>>(t, ids, o, n,
                                                               v, w);
  } else {
    gather_kernel<Tin, Tout, false><<<grid, block, 0, stream>>>(t, ids, o, n,
                                                                v, w);
  }
}

}  // namespace

extern "C" {

// in_dtype / out_dtype: 0 = float32, 1 = bfloat16. vec: 1 when w % 4 == 0
// and the table and output pointers are aligned for 4-element vectors.
// Returns cudaGetLastError() after the launch (0 on success).
int gv_gather_sorted(const void* table, int in_dtype, const void* ids,
                     void* out, int out_dtype, long long n, long long v,
                     long long w, int vec, void* stream) {
  if (n <= 0 || w <= 0) return 0;
  if (v <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* i = static_cast<const int32_t*>(ids);
  if (in_dtype == 0 && out_dtype == 0) {
    launch<float, float>(table, i, out, n, v, w, vec, s);
  } else if (in_dtype == 1 && out_dtype == 0) {
    launch<__nv_bfloat16, float>(table, i, out, n, v, w, vec, s);
  } else if (in_dtype == 1 && out_dtype == 1) {
    launch<__nv_bfloat16, __nv_bfloat16>(table, i, out, n, v, w, vec, s);
  } else if (in_dtype == 0 && out_dtype == 1) {
    launch<float, __nv_bfloat16>(table, i, out, n, v, w, vec, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
