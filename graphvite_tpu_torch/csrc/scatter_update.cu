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
// Contract (the callers in graphvite_tpu_torch/ops/scatter.py pass sorted
// ids: scatter_update_sorted_ takes them sorted, scatter_update_ sorts them
// and permutes grads, counts and squares to match):
//   table   [V, W] float32 or bfloat16, contiguous, updated in place;
//   m1, m2  [V, W] float32 moment tables, in place (m2 only for Adam);
//   ids     [N] int32, ascending; ids < 0 or >= V are dropped;
//   grads   [N, W] float32 summed regularized gradient of each entry;
//   counts  [N] float32 touch count of each entry, or null for 1 each;
//   sqs     [N, W] float32 summed squared gradients, or null for grad^2.
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
// table -= round_to_table_type(lr_scale * d). One warp owns each run of
// equal ids and writes the row and each moment row once: no atomics.
//
// What bounds it: memory. It must read the entries (N*W*4 bytes of grads,
// as many of squares when given, 4*N of counts and 4*N of ids) and read
// and write the U touched rows of the table and of each moment
// (2*U*W*(s + 4*n_moment) bytes); its arithmetic (a few dozen operations
// per element, one expf per row) is far below the card's float rate. The
// design reads every byte once: 16-byte vector loads across the columns,
// each run's entries streamed once per 128-column pass, and one
// read-modify-write per table and moment row.

#include "common.cuh"

namespace {

using gv::kWarp;
using gv::kWarpsPerBlock;

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

// One warp per sorted position j; the warp that heads a run of equal
// in-range ids sums the run and updates the row, the others return.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
scatter_update_kernel(T* __restrict__ table, float* __restrict__ m1,
                      float* __restrict__ m2,
                      const int32_t* __restrict__ ids,
                      const float* __restrict__ grads,
                      const float* __restrict__ counts,
                      const float* __restrict__ sqs, int64_t n, int64_t v,
                      int64_t w, Moment o) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                    threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  // warp-uniform branches: j, id and the reduced count are the same in
  // every lane
  if (j >= n) return;
  const int32_t id = ids[j];
  if (id < 0 || id >= v) return;
  if (j > 0 && ids[j - 1] == id) return;
  const int64_t end = gv::run_end(ids, j, n, id, lane);

  float cnt = 0.f;
  for (int64_t r = j + lane; r < end; r += kWarp) {
    cnt += counts ? counts[r] : 1.f;
  }
  for (int off = kWarp / 2; off > 0; off /= 2) {
    cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
  }
  if (!(cnt > 0.f)) return;
  const float c = fmaxf(cnt, 1.f);
  const float w1 = o.type == kAdaGrad ? 0.f : one_minus_pow(o.log_b1, c);
  const float w2 = o.type == kAdam ? one_minus_pow(o.log_b2, c) : 0.f;
  const bool has_m2 = o.type == kAdam;

  const int64_t base = static_cast<int64_t>(id) * w;
  T* row = table + base;
  float* r1 = m1 + base;
  float* r2 = has_m2 ? m2 + base : nullptr;
  if (kVec) {
    for (int64_t col = 4 * lane; col < w; col += 4 * kWarp) {
      float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 s = g;
#pragma unroll 4
      for (int64_t r = j; r < end; ++r) {
        const float4 x = gv::load4(grads + r * w + col);
        g.x += x.x;
        g.y += x.y;
        g.z += x.z;
        g.w += x.w;
        if (sqs) {
          const float4 q = gv::load4(sqs + r * w + col);
          s.x += q.x;
          s.y += q.y;
          s.z += q.z;
          s.w += q.w;
        } else {
          s.x += x.x * x.x;
          s.y += x.y * x.y;
          s.z += x.z * x.z;
          s.w += x.w * x.w;
        }
      }
      float4 t = gv::load4(row + col);
      float4 a = gv::load4(r1 + col);
      float4 b = has_m2 ? gv::load4(r2 + col) : make_float4(0.f, 0.f, 0.f, 0.f);
      t.x -= gv::round_as(update(o, g.x, s.x, c, w1, w2, a.x, b.x), row);
      t.y -= gv::round_as(update(o, g.y, s.y, c, w1, w2, a.y, b.y), row);
      t.z -= gv::round_as(update(o, g.z, s.z, c, w1, w2, a.z, b.z), row);
      t.w -= gv::round_as(update(o, g.w, s.w, c, w1, w2, a.w, b.w), row);
      gv::store4(row + col, t);
      gv::store4(r1 + col, a);
      if (has_m2) gv::store4(r2 + col, b);
    }
  } else {
    for (int64_t col = lane; col < w; col += kWarp) {
      float g = 0.f, s = 0.f;
#pragma unroll 4
      for (int64_t r = j; r < end; ++r) {
        const float x = grads[r * w + col];
        g += x;
        s += sqs ? sqs[r * w + col] : x * x;
      }
      float a = r1[col];
      float b = has_m2 ? r2[col] : 0.f;
      const float t = gv::to_float(row[col]) -
                      gv::round_as(update(o, g, s, c, w1, w2, a, b), row);
      gv::store1(row + col, t);
      r1[col] = a;
      if (has_m2) r2[col] = b;
    }
  }
}

template <typename T>
void launch(void* table, float* m1, float* m2, const int32_t* ids,
            const float* grads, const float* counts, const float* sqs,
            int64_t n, int64_t v, int64_t w, int vec, const Moment& o,
            cudaStream_t stream) {
  const dim3 block(kWarp * kWarpsPerBlock);
  const dim3 grid(static_cast<unsigned>((n + kWarpsPerBlock - 1) /
                                        kWarpsPerBlock));
  T* t = static_cast<T*>(table);
  if (vec) {
    scatter_update_kernel<T, true><<<grid, block, 0, stream>>>(
        t, m1, m2, ids, grads, counts, sqs, n, v, w, o);
  } else {
    scatter_update_kernel<T, false><<<grid, block, 0, stream>>>(
        t, m1, m2, ids, grads, counts, sqs, n, v, w, o);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32 table, 1 = bfloat16 table. type: 1 Momentum,
// 2 AdaGrad, 3 RMSprop, 4 Adam. log_b1: log of momentum (Momentum), alpha
// (RMSprop) or beta1 (Adam); log_b2: log of beta2 (Adam). m2, counts and
// sqs may be null (m2 must not be for Adam). vec: 1 when w % 4 == 0 and
// every row pointer is aligned for 4-element vectors. Returns
// cudaGetLastError() after the launch (0 on success).
int gv_scatter_update(void* table, int dtype, void* m1, void* m2,
                      const void* ids, const void* grads, const void* counts,
                      const void* sqs, long long n, long long v, long long w,
                      int type, float lr, float lr_scale, float log_b1,
                      float log_b2, float eps, int vec, void* stream) {
  if (n <= 0 || w <= 0) return 0;
  if (type < kMomentum || type > kAdam || m1 == nullptr ||
      (type == kAdam && m2 == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Moment o{type, lr, lr_scale, log_b1, log_b2, eps};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* a = static_cast<float*>(m1);
  float* b = static_cast<float*>(m2);
  const int32_t* i = static_cast<const int32_t*>(ids);
  const float* g = static_cast<const float*>(grads);
  const float* c = static_cast<const float*>(counts);
  const float* q = static_cast<const float*>(sqs);
  if (dtype == 0) {
    launch<float>(table, a, b, i, g, c, q, n, v, w, vec, o, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(table, a, b, i, g, c, q, n, v, w, vec, o, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
