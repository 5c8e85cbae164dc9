// The positive band of the banded walk step (ops/walk_band.py:walk_band,
// called by ops/steps.py:make_graph_banded_core on SGD): for every walk,
// every position's T (head, tail) pair logits, their gradients and loss,
// and the band's share of dv and dc, in one launch, in the float32
// arithmetic of the plain version (walk_band_plain).
//
// It replaces no TPU kernel: the JAX package's core
// (graphvite_tpu/ops/steps.py:make_graph_banded_core) is jnp that XLA fuses.
// Eagerly, PyTorch made ~210 launches a DeepWalk batch of it (per offset a
// shift, a product, a row sum, a sigmoid, a mask and a softplus; then the
// sums over the offsets, each shift a fill and a copy), so the host's
// launches, not the device, set the band's pace.
//
// What bounds it: latency. The work is a few MB a batch (v and c read, dv
// and dc written: 192 x 41 x 128 x 16 bytes, 16 MB, on the DeepWalk batch)
// and ~40 MFLOP. The least any one-launch band pays is a launch, one load
// of a row, one warp reduction, one barrier and one store (floor_kernel
// below, which chip_smoke.py times as the bound); this design adds a walk's
// chain of dependent steps (stage its rows, a dot product and a warp
// reduction per pair, run T after T, one barrier, the sums over the
// offsets). The design: one block a walk (192 in DeepWalk, 576 a mesh
// worker-batch); the walk's v and c rows staged in shared memory (41 x 128
// x 4 B x 2 = 42 KB; past the default 48 KB a launch opts into the card's
// larger limit, up to ~227 KB, D ~690 at L1 41), each row read once, and
// its pair flags beside them; one warp a position, the lanes over the
// columns, its T dots reduced by shuffles; the gradients g [L1, T] kept in
// shared memory; after one barrier each warp writes its positions' dv and
// dc rows, summing over the offsets in the plain version's order. Each
// walk's loss and pair count are written to its own slot (no atomics), so
// the result does not depend on the order the blocks run in.
//
// Arithmetic (as walk_band_plain and PyTorch's kernels do it): no
// contraction into fused multiply-adds; a logit is the float32 row sum of
// v * c (rounded to bf16 first with kBf16, GRAPHVITE_BF16_BAND); sigmoid
// 1 / (1 + exp(-x)); softplus x > 20 ? x : log1p(exp(x)); a pair whose
// tail lies past the walk's end has logit 0. Sums over the offsets run in
// offset order, starting from 0, a walk's loss and pairs over its
// positions in order; only the dot products' order and the loss's order
// over the positions differ from the plain version's.
#include "common.cuh"

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * gv::kWarp;
constexpr int kMaxOffsets = 64;

struct Args {
  const float* v;        // [B, L1, D], rows of stride v_row
  const float* c;        // [B, L1, D], rows of stride c_row
  const float* mask;     // [B, L1, T] contiguous
  int64_t v_walk, v_row, c_walk, c_row;  // strides in elements
  int L1, D, T;
  int offs[kMaxOffsets];
  float wd;              // the context rows' weight decay
  float head_wd;         // wd * (1 + M * neg_w), the head rows'
  float* dv;             // [B, L1, D] contiguous
  float* dc;             // [B, L1, D] contiguous
  float* cnt;            // [B, L1]
  float* cntc;           // [B, L1]
  float* sums;           // [B, 2]: the walk's loss, its pair count
};

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = gv::kWarp / 2; o > 0; o >>= 1) {
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
  }
  return s;
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads) walk_band_kernel(Args a) {
  extern __shared__ float smem[];
  __shared__ int offs[kMaxOffsets];
  const int L1 = a.L1, D = a.D, T = a.T;
  const int warp = threadIdx.x / gv::kWarp;
  const int lane = threadIdx.x % gv::kWarp;
  const int64_t b = blockIdx.x;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int t = 0; t < kMaxOffsets; ++t) offs[t] = a.offs[t];
  }
  // the walk's rows, read once
  const float* gv_rows = a.v + b * a.v_walk;
  const float* gc_rows = a.c + b * a.c_walk;
  float* vb = smem;
  float* cb = smem + L1 * D;
  for (int i = warp; i < L1; i += kWarps) {
    for (int d = lane; d < D; d += gv::kWarp) {
      vb[i * D + d] = __ldg(gv_rows + i * a.v_row + d);
      cb[i * D + d] = __ldg(gc_rows + i * a.c_row + d);
    }
  }
  float* g = cb + L1 * D;
  // the walk's pair flags, read once
  float* m = g + L1 * T;
  const float* gm = a.mask + b * L1 * T;
  for (int e = threadIdx.x; e < L1 * T; e += kThreads) m[e] = __ldg(gm + e);
  float* row_loss = m + L1 * T;
  float* row_cnt = row_loss + L1;
  __syncthreads();

  // each position's T pairs: logit, gradient, loss
  for (int i = warp; i < L1; i += kWarps) {
    const float* vi = vb + i * D;
    float loss = 0.f, cnt = 0.f;
    for (int t = 0; t < T; ++t) {
      const int j = i + offs[t];
      float part = 0.f;
      if (j >= 0 && j < L1) {
        const float* cj = cb + j * D;
        for (int d = lane; d < D; d += gv::kWarp) {
          float p = __fmul_rn(vi[d], cj[d]);
          if (kBf16) p = __bfloat162float(__float2bfloat16_rn(p));
          part = __fadd_rn(part, p);
        }
      }
      const float logit = warp_sum(part);
      const float mt = m[i * T + t];
      const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-logit)));
      const float x = -logit;
      const float sp = x > 20.f ? x : log1pf(expf(x));
      loss = __fadd_rn(loss, __fmul_rn(mt, sp));
      cnt = __fadd_rn(cnt, mt);
      if (lane == 0) g[i * T + t] = __fmul_rn(__fsub_rn(sig, 1.f), mt);
    }
    if (lane == 0) {
      row_loss[i] = loss;
      row_cnt[i] = cnt;
      a.cnt[b * L1 + i] = cnt;
    }
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    float loss = 0.f, pairs = 0.f;
    for (int i = 0; i < L1; ++i) {
      loss = __fadd_rn(loss, row_loss[i]);
      pairs = __fadd_rn(pairs, row_cnt[i]);
    }
    a.sums[2 * b] = loss;
    a.sums[2 * b + 1] = pairs;
  }
  // dv[i] = sum_t g[i, t] c[i + off_t] + head_wd cnt[i] v[i]
  // dc[j] = sum_t g[j - off_t, t] v[j - off_t] + wd cntc[j] c[j]
  for (int i = warp; i < L1; i += kWarps) {
    float cc = 0.f;
    for (int t = 0; t < T; ++t) {
      const int h = i - offs[t];
      if (h >= 0 && h < L1) cc = __fadd_rn(cc, m[h * T + t]);
    }
    const float hv = __fmul_rn(a.head_wd, row_cnt[i]);
    const float hc = __fmul_rn(a.wd, cc);
    float* dvi = a.dv + (b * L1 + i) * D;
    float* dci = a.dc + (b * L1 + i) * D;
    for (int d = lane; d < D; d += gv::kWarp) {
      float sv = 0.f, sc = 0.f;
      for (int t = 0; t < T; ++t) {
        const int j = i + offs[t];
        if (j >= 0 && j < L1) {
          sv = __fadd_rn(sv, __fmul_rn(g[i * T + t], cb[j * D + d]));
        }
        const int h = i - offs[t];
        if (h >= 0 && h < L1) {
          sc = __fadd_rn(sc, __fmul_rn(g[h * T + t], vb[h * D + d]));
        }
      }
      dvi[d] = __fadd_rn(sv, __fmul_rn(hv, vb[i * D + d]));
      dci[d] = __fadd_rn(sc, __fmul_rn(hc, cb[i * D + d]));
    }
    if (lane == 0) a.cntc[b * L1 + i] = cc;
  }
}

template <bool kBf16>
cudaError_t launch(const Args& a, int B, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        walk_band_kernel<kBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) {
      cudaGetLastError();    // leave no error for the next launch to find
      return e;
    }
  }
  walk_band_kernel<kBf16><<<B, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The latency floor of any one-launch band at this grid (chip_smoke.py
// times it as the band's bound): B blocks of kThreads threads, and in each
// the least a walk's block must do in sequence, one load of a row, one
// warp reduction, one barrier to share it, one store.
__global__ void __launch_bounds__(kThreads)
    floor_kernel(const float* v, int64_t v_walk, int64_t v_row, int L1,
                 int D, float* out) {
  __shared__ float part[kWarps];
  const int warp = threadIdx.x / gv::kWarp;
  const int lane = threadIdx.x % gv::kWarp;
  const float x = __ldg(v + blockIdx.x * v_walk + (warp % L1) * v_row
                        + lane % D);
  const float s = warp_sum(x);
  if (lane == 0) part[warp] = s;
  __syncthreads();
  if (threadIdx.x < kWarps) {
    out[blockIdx.x * kWarps + threadIdx.x] = part[kWarps - 1 - threadIdx.x];
  }
}

}  // namespace

// Launch the band of B walks on `stream`. v and c: float32 rows of D
// columns, the column stride 1, walk and row strides in elements; mask
// contiguous [B, L1, T]; offs: T <= 64 offsets (host memory, copied into
// the launch); bf16: round each product to bf16 before the logit's sum.
// Outputs contiguous. A walk's rows, gradients and flags take 4 L1 (2 D +
// 2 T + 2) bytes of shared memory; past the card's limit the launch is
// refused. Returns a CUDA error code (0: none).
extern "C" int gv_walk_band(
    const void* v, const void* c, const void* mask, int64_t v_walk,
    int64_t v_row, int64_t c_walk, int64_t c_row, int B, int L1, int D,
    int T, const int* offs, float wd, float head_wd, int bf16, void* dv,
    void* dc, void* cnt, void* cntc, void* sums, void* stream) {
  if (T < 0 || T > kMaxOffsets) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.v = static_cast<const float*>(v);
  a.c = static_cast<const float*>(c);
  a.mask = static_cast<const float*>(mask);
  a.v_walk = v_walk;
  a.v_row = v_row;
  a.c_walk = c_walk;
  a.c_row = c_row;
  a.L1 = L1;
  a.D = D;
  a.T = T;
  for (int t = 0; t < kMaxOffsets; ++t) a.offs[t] = t < T ? offs[t] : 0;
  a.wd = wd;
  a.head_wd = head_wd;
  a.dv = static_cast<float*>(dv);
  a.dc = static_cast<float*>(dc);
  a.cnt = static_cast<float*>(cnt);
  a.cntc = static_cast<float*>(cntc);
  a.sums = static_cast<float*>(sums);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * static_cast<size_t>(L1)
                      * (2 * static_cast<size_t>(D) + 2 * T + 2);
  return static_cast<int>(bf16 ? launch<true>(a, B, smem, s)
                               : launch<false>(a, B, smem, s));
}

// floor_kernel over B walks of v (rows of D >= 1 columns, walk and row
// strides in elements), out [B, 16]. Returns a CUDA error code.
extern "C" int gv_walk_band_floor(const void* v, int64_t v_walk,
                                  int64_t v_row, int B, int L1, int D,
                                  void* out, void* stream) {
  floor_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), v_walk, v_row, L1, D,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
