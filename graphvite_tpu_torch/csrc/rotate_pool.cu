// The RotatE isometry body of the pooled knowledge-graph step for Hopper
// (sm_90a): the logits and the gradient sums of every (sample, candidate)
// pair of every pool group, with no [G, Bg, M/2, Dh] tensor in device
// memory. Two kernels, each over all G groups in one launch:
//
//   pool_logits   logits [G, Bg, M]
//   pool_grads    E sums [Qe, slices, 2, G, Bg, Dh], B sums [Qb, G, M, Dh]
//
// What it replaces. The JAX package has no Pallas kernel here: its
// fast_rotate_body (graphvite_tpu/ops/steps.py, make_kg_pool_step) is jnp
// that XLA fuses under a scan over the groups. The port ran the same
// mathematics as ~45 unfused PyTorch passes over [g, Bg, M/2, Dh] float32
// tensors (ops/rotate_pool.py: pool_sums_plain), a stream of ~240 GB a
// batch at the rotate_wikidata5m.yaml shape.
//
// The mathematics, per group g, side (0: head corrupted, 1: tail
// corrupted), sample i, candidate j of the side and complex dimension k:
//   f    the sample's frame, u = t e^{-i phi} (side 0) or w = h e^{i phi}
//        (side 1), [G, Bg, Dh] as (re, im) halves
//   c    the candidate, rows 0..M2-1 of the pool (side 0), M2..M-1 (side 1)
//   d'   c - f; the side's difference d is d' (side 0) or -d' (side 1)
//   sq   |d'|^2,  r = rsqrt(max(sq, eps^2))
//   logit[i, j] = margin - sum_k sq r
//   z    gn[i, j] r d   (gn, the per-pair gradient scale, is computed from
//        the logits between the two kernels)
//   E[i, k] = sum_j z, B[j, k] = sum_i z, and with need_sq the sums of the
//   squares: S_rr, S_ii, S_ri over j, B_rr, B_ii over i.
// The side's sign is applied once to each finished E and B sum (negating
// a float32 sum is exact). Masked samples carry gn = 0 and add nothing.
//
// What bounds it: per pair and dimension the logits take ~7 FP32
// operations and one MUFU rsqrt, the gradients ~12 (~17 with the squares)
// and one rsqrt: FP32 issue (128 lanes a clock an SM) and the MUFU (16 a
// clock an SM), not bytes. A group's frames and candidates (a few MB) stay
// in L2; the outputs are [G, Bg, Dh]-sized.
//
// The design.
//   * pool_logits is shaped like a matrix product with a per-dimension
//     modulus for the dot product, so it runs on CUDA cores: a CTA of 128
//     threads owns 32 samples x 64 candidates of one (group, side), each
//     thread a 4 x 4 block of pairs (samples ty + 8 a, candidates tx + 16
//     b). Chunks of 16 dimensions of the frames and candidates are staged
//     in shared memory by cp.async, two stages deep; each thread reads
//     four dimensions of a row as one float4, 16 float4 reads for 64 pairs
//     x dims. Row pitch 20 floats: the eight rows a quarter-warp reads fall
//     in distinct bank groups.
//   * pool_grads: a CTA owns one (group, side, 32 dimensions, slice of up
//     to 64 candidates); lane = dimension, warp w = candidates 8 w..8 w+7 of
//     the slice, held in registers with their B sums. The group's samples
//     stream through shared memory in chunks of 16 (frames and gn, cp.async,
//     two stages); each warp writes its partial E sums of a chunk to shared
//     memory and the CTA adds the warps' partials in warp order. Every E
//     and B entry is written once (E once per slice; the wrapper adds the
//     slices in order).
//   * No float atomics: every sum runs in an order fixed by the shape
//     (logits and S over k or j ascending in a thread, B over i ascending,
//     E over j within a warp, then warps, then slices), so a repeated batch
//     gives the same bits.
//   * Any Dh, Bg and M2: ragged rows and dimensions load as zeros (they
//     add exact zeros) and are not stored. Dh % 4 != 0 or an unaligned
//     pointer stages with 4-byte copies instead of 16-byte ones.

#include "common.cuh"

namespace gv {
namespace {

constexpr int kLogitSamples = 32;
constexpr int kLogitCands = 64;
constexpr int kLogitDims = 16;
constexpr int kLogitPitch = kLogitDims + 4;
constexpr int kLogitThreads = 128;

constexpr int kGradDims = 32;      // one per lane
constexpr int kGradCands = 8;      // per warp
constexpr int kGradSlice = 64;     // candidates of a CTA: 8 warps at most
constexpr int kGradSamples = 16;   // per staged chunk

__device__ __forceinline__ float rsqrt_approx(float x) {
  // the instruction rsqrtf gives; x >= eps^2 is a normal float here
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;   // 0: fill with zeros, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// kRows rows from row0 of the [rows, Dh] matrix at `src`, kDims columns
// from k0, into shared memory, as 16-byte copies (kVec) or 4-byte ones;
// rows past rows_valid and columns past Dh are filled with zeros. The
// threads split the copies.
template <bool kVec, int kRows, int kDims, int kPitch>
__device__ __forceinline__ void stage_rows(float (*dst)[kPitch],
                                           const float* src, int row0,
                                           int rows_valid, int k0, int Dh,
                                           int tid, int nthreads) {
  if (kVec) {
    constexpr int kQuads = kDims / 4;
    for (int q = tid; q < kRows * kQuads; q += nthreads) {
      const int row = q / kQuads, col = (q % kQuads) * 4;
      const bool ok = row < rows_valid && k0 + col < Dh;
      const float* p = ok ? src + static_cast<size_t>(row0 + row) * Dh + k0 +
                                col
                          : src;
      cp_async16(&dst[row][col], p, ok);
    }
  } else {
    for (int q = tid; q < kRows * kDims; q += nthreads) {
      const int row = q / kDims, col = q % kDims;
      const bool ok = row < rows_valid && k0 + col < Dh;
      const float* p = ok ? src + static_cast<size_t>(row0 + row) * Dh + k0 +
                                col
                          : src;
      cp_async4(&dst[row][col], p, ok);
    }
  }
}

// grid (ceil(Bg / 32), ceil(M2 / 64), 2 G), block 128
template <bool kVec>
__global__ void __launch_bounds__(kLogitThreads)
pool_logits_kernel(const float* __restrict__ u_re,
                   const float* __restrict__ u_im,
                   const float* __restrict__ w_re,
                   const float* __restrict__ w_im,
                   const float* __restrict__ c_re,
                   const float* __restrict__ c_im,
                   float* __restrict__ logits, int Bg, int M2, int Dh,
                   float margin, float eps2) {
  __shared__ __align__(16) float sf[2][2][kLogitSamples][kLogitPitch];
  __shared__ __align__(16) float sc[2][2][kLogitCands][kLogitPitch];

  const int side = blockIdx.z & 1;
  const int g = blockIdx.z >> 1;
  const int i0 = blockIdx.x * kLogitSamples;
  const int j0 = blockIdx.y * kLogitCands;
  const int M = 2 * M2;
  const size_t frame_off = static_cast<size_t>(g) * Bg * Dh;
  const float* f_re = (side ? w_re : u_re) + frame_off;
  const float* f_im = (side ? w_im : u_im) + frame_off;
  const size_t cand_row0 = static_cast<size_t>(g) * M + side * M2;
  const float* cr_src = c_re + cand_row0 * Dh;
  const float* ci_src = c_im + cand_row0 * Dh;
  const int rows_i = min(kLogitSamples, Bg - i0);
  const int rows_j = min(kLogitCands, M2 - j0);

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;

  auto stage = [&](int buf, int k0) {
    stage_rows<kVec, kLogitSamples, kLogitDims, kLogitPitch>(
        sf[buf][0], f_re, i0, rows_i, k0, Dh, tid, kLogitThreads);
    stage_rows<kVec, kLogitSamples, kLogitDims, kLogitPitch>(
        sf[buf][1], f_im, i0, rows_i, k0, Dh, tid, kLogitThreads);
    stage_rows<kVec, kLogitCands, kLogitDims, kLogitPitch>(
        sc[buf][0], cr_src, j0, rows_j, k0, Dh, tid, kLogitThreads);
    stage_rows<kVec, kLogitCands, kLogitDims, kLogitPitch>(
        sc[buf][1], ci_src, j0, rows_j, k0, Dh, tid, kLogitThreads);
    cp_async_commit();
  };

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

  const int chunks = (Dh + kLogitDims - 1) / kLogitDims;
  stage(0, 0);
  for (int kc = 0; kc < chunks; ++kc) {
    if (kc + 1 < chunks) {
      stage((kc + 1) & 1, (kc + 1) * kLogitDims);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int buf = kc & 1;
#pragma unroll
    for (int kk = 0; kk < kLogitDims; kk += 4) {
      float4 fr[4], fi[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        fr[a] = *reinterpret_cast<const float4*>(&sf[buf][0][ty + 8 * a][kk]);
        fi[a] = *reinterpret_cast<const float4*>(&sf[buf][1][ty + 8 * a][kk]);
      }
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float4 cr =
            *reinterpret_cast<const float4*>(&sc[buf][0][tx + 16 * b][kk]);
        const float4 ci =
            *reinterpret_cast<const float4*>(&sc[buf][1][tx + 16 * b][kk]);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          // dimensions kk .. kk + 3 in order
          const float dr[4] = {cr.x - fr[a].x, cr.y - fr[a].y,
                               cr.z - fr[a].z, cr.w - fr[a].w};
          const float di[4] = {ci.x - fi[a].x, ci.y - fi[a].y,
                               ci.z - fi[a].z, ci.w - fi[a].w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float sq = dr[e] * dr[e] + di[e] * di[e];
            acc[a][b] += sq * rsqrt_approx(fmaxf(sq, eps2));
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty + 8 * a;
    if (i >= Bg) continue;
    float* row = logits + (static_cast<size_t>(g) * Bg + i) * M + side * M2;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = j0 + tx + 16 * b;
      if (j < M2) row[j] = margin - acc[a][b];
    }
  }
}

// Shared memory of pool_grads, in floats: two stages of frames (re, im) and
// gn for a chunk of samples, then the warps' partial E sums.
constexpr int kGradStageFloats =
    kGradSamples * (2 * kGradDims + kGradSlice);

__host__ __device__ constexpr int grad_smem_floats(int qe, int warps) {
  return 2 * kGradStageFloats + qe * warps * kGradSamples * kGradDims;
}

// grid (ceil(Dh / 32), ceil(M2 / 64), 2 G), block 32 x ceil(min(M2, 64) / 8)
template <bool kSq>
__global__ void __launch_bounds__(256)
pool_grads_kernel(const float* __restrict__ u_re,
                  const float* __restrict__ u_im,
                  const float* __restrict__ w_re,
                  const float* __restrict__ w_im,
                  const float* __restrict__ c_re,
                  const float* __restrict__ c_im,
                  const float* __restrict__ gn, float* __restrict__ e_out,
                  float* __restrict__ b_out, int G, int Bg, int M2, int Dh,
                  float eps2) {
  constexpr int kQe = kSq ? 5 : 2;
  constexpr int kQb = kSq ? 4 : 2;
  extern __shared__ __align__(16) float smem[];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int k0 = blockIdx.x * kGradDims;
  const int k = k0 + lane;
  const bool k_in = k < Dh;
  const int slice = blockIdx.y, slices = gridDim.y;
  const int side = blockIdx.z & 1;
  const int g = blockIdx.z >> 1;
  const int M = 2 * M2;
  const int jslice = slice * kGradSlice;          // first candidate of slice
  const int jw = jslice + warp * kGradCands;      // first of this warp
  const size_t frame_off = static_cast<size_t>(g) * Bg * Dh;
  const float* f_re = (side ? w_re : u_re) + frame_off;
  const float* f_im = (side ? w_im : u_im) + frame_off;
  const size_t cand_row0 = static_cast<size_t>(g) * M + side * M2;
  const float* gn_g = gn + static_cast<size_t>(g) * Bg * M + side * M2;
  const int slice_cands = min(kGradSlice, M2 - jslice);

  float cr[kGradCands], ci[kGradCands];
  float br[kGradCands], bi[kGradCands], brr[kGradCands], bii[kGradCands];
#pragma unroll
  for (int j = 0; j < kGradCands; ++j) {
    const bool ok = jw + j < M2 && k_in;
    const size_t at = (cand_row0 + jw + j) * Dh + k;
    cr[j] = ok ? c_re[at] : 0.f;
    ci[j] = ok ? c_im[at] : 0.f;
    br[j] = bi[j] = brr[j] = bii[j] = 0.f;
  }

  float* stage_base = smem;
  float* partial = smem + 2 * kGradStageFloats;   // [kQe][warps][16][32]
  auto stage_fr = [&](int buf) {
    return reinterpret_cast<float(*)[kGradDims]>(stage_base +
                                                 buf * kGradStageFloats);
  };
  auto stage_fi = [&](int buf) {
    return reinterpret_cast<float(*)[kGradDims]>(
        stage_base + buf * kGradStageFloats + kGradSamples * kGradDims);
  };
  auto stage_gn = [&](int buf) {
    return reinterpret_cast<float(*)[kGradSlice]>(
        stage_base + buf * kGradStageFloats + 2 * kGradSamples * kGradDims);
  };

  auto stage = [&](int buf, int i0) {
    const int rows = min(kGradSamples, Bg - i0);
    stage_rows<false, kGradSamples, kGradDims, kGradDims>(
        stage_fr(buf), f_re, i0, rows, k0, Dh, tid, nthreads);
    stage_rows<false, kGradSamples, kGradDims, kGradDims>(
        stage_fi(buf), f_im, i0, rows, k0, Dh, tid, nthreads);
    // gn rows of the chunk, the slice's columns (a [Bg, M] matrix seen
    // from column side * M2 + jslice)
    float(*dst)[kGradSlice] = stage_gn(buf);
    for (int q = tid; q < kGradSamples * kGradSlice; q += nthreads) {
      const int row = q / kGradSlice, col = q % kGradSlice;
      const bool ok = row < rows && col < slice_cands;
      const float* p =
          ok ? gn_g + static_cast<size_t>(i0 + row) * M + jslice + col : gn;
      cp_async4(&dst[row][col], p, ok);
    }
    cp_async_commit();
  };

  const int chunks = (Bg + kGradSamples - 1) / kGradSamples;
  stage(0, 0);
  for (int ch = 0; ch < chunks; ++ch) {
    if (ch + 1 < chunks) {
      stage((ch + 1) & 1, (ch + 1) * kGradSamples);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int buf = ch & 1;
    float(*fr_s)[kGradDims] = stage_fr(buf);
    float(*fi_s)[kGradDims] = stage_fi(buf);
    float(*gn_s)[kGradSlice] = stage_gn(buf);
    for (int s = 0; s < kGradSamples; ++s) {
      const float fr = fr_s[s][lane], fi = fi_s[s][lane];
      const float4 g0 =
          *reinterpret_cast<const float4*>(&gn_s[s][warp * kGradCands]);
      const float4 g1 =
          *reinterpret_cast<const float4*>(&gn_s[s][warp * kGradCands + 4]);
      const float gv[kGradCands] = {g0.x, g0.y, g0.z, g0.w,
                                    g1.x, g1.y, g1.z, g1.w};
      float er = 0.f, ei = 0.f, err = 0.f, eii = 0.f, eri = 0.f;
#pragma unroll
      for (int j = 0; j < kGradCands; ++j) {
        const float dr = cr[j] - fr, di = ci[j] - fi;
        const float sq = dr * dr + di * di;
        const float alpha = gv[j] * rsqrt_approx(fmaxf(sq, eps2));
        const float zr = alpha * dr, zi = alpha * di;
        br[j] += zr;
        bi[j] += zi;
        er += zr;
        ei += zi;
        if (kSq) {
          brr[j] += zr * zr;
          bii[j] += zi * zi;
          err += zr * zr;
          eii += zi * zi;
          eri += zr * zi;
        }
      }
      float* p = partial + (warp * kGradSamples + s) * kGradDims + lane;
      const int q_stride = warps * kGradSamples * kGradDims;
      p[0] = er;
      p[q_stride] = ei;
      if (kSq) {
        p[2 * q_stride] = err;
        p[3 * q_stride] = eii;
        p[4 * q_stride] = eri;
      }
    }
    __syncthreads();
    // the warps' partials of each (sample, dimension), added in warp order
    const int i0 = ch * kGradSamples;
    for (int q = tid; q < kGradSamples * kGradDims; q += nthreads) {
      const int s = q / kGradDims, kk = q % kGradDims;
      const int i = i0 + s;
      if (i >= Bg || k0 + kk >= Dh) continue;
#pragma unroll
      for (int e = 0; e < kQe; ++e) {
        const float* p = partial + (e * warps * kGradSamples + s) * kGradDims
                         + kk;
        float v = p[0];
        for (int w = 1; w < warps; ++w) v += p[w * kGradSamples * kGradDims];
        if (e < 2 && side) v = -v;
        const size_t at =
            ((((static_cast<size_t>(e) * slices + slice) * 2 + side) * G + g)
                 * Bg + i) * Dh + k0 + kk;
        e_out[at] = v;
      }
    }
  }

  // the B sums of this warp's candidates
  const size_t b_plane = static_cast<size_t>(G) * M * Dh;
#pragma unroll
  for (int j = 0; j < kGradCands; ++j) {
    if (jw + j >= M2 || !k_in) continue;
    const size_t at = (cand_row0 + jw + j) * Dh + k;
    b_out[at] = side ? -br[j] : br[j];
    b_out[b_plane + at] = side ? -bi[j] : bi[j];
    if (kQb == 4) {
      b_out[2 * b_plane + at] = brr[j];
      b_out[3 * b_plane + at] = bii[j];
    }
  }
}

}  // namespace
}  // namespace gv

extern "C" int gv_rotate_pool_logits(const float* u_re, const float* u_im,
                                     const float* w_re, const float* w_im,
                                     const float* c_re, const float* c_im,
                                     float* logits, int G, int Bg, int M2,
                                     int Dh, float margin, float eps2,
                                     int vec, cudaStream_t stream) {
  using namespace gv;
  const dim3 grid((Bg + kLogitSamples - 1) / kLogitSamples,
                  (M2 + kLogitCands - 1) / kLogitCands, 2 * G);
  if (vec) {
    pool_logits_kernel<true><<<grid, kLogitThreads, 0, stream>>>(
        u_re, u_im, w_re, w_im, c_re, c_im, logits, Bg, M2, Dh, margin,
        eps2);
  } else {
    pool_logits_kernel<false><<<grid, kLogitThreads, 0, stream>>>(
        u_re, u_im, w_re, w_im, c_re, c_im, logits, Bg, M2, Dh, margin,
        eps2);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gv_rotate_pool_grads(const float* u_re, const float* u_im,
                                    const float* w_re, const float* w_im,
                                    const float* c_re, const float* c_im,
                                    const float* gn, float* e_out,
                                    float* b_out, int G, int Bg, int M2,
                                    int Dh, float eps2, int need_sq,
                                    cudaStream_t stream) {
  using namespace gv;
  const int slice_cands = M2 < kGradSlice ? M2 : kGradSlice;
  const int warps = (slice_cands + kGradCands - 1) / kGradCands;
  const dim3 grid((Dh + kGradDims - 1) / kGradDims,
                  (M2 + kGradSlice - 1) / kGradSlice, 2 * G);
  const size_t smem =
      sizeof(float) * grad_smem_floats(need_sq ? 5 : 2, warps);
  // set on every launch: the attribute belongs to the current device
  cudaError_t rc;
  if (need_sq) {
    rc = cudaFuncSetAttribute(pool_grads_kernel<true>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
    pool_grads_kernel<true><<<grid, 32 * warps, smem, stream>>>(
        u_re, u_im, w_re, w_im, c_re, c_im, gn, e_out, b_out, G, Bg, M2, Dh,
        eps2);
  } else {
    rc = cudaFuncSetAttribute(pool_grads_kernel<false>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
    pool_grads_kernel<false><<<grid, 32 * warps, smem, stream>>>(
        u_re, u_im, w_re, w_im, c_re, c_im, gn, e_out, b_out, G, Bg, M2, Dh,
        eps2);
  }
  return static_cast<int>(cudaGetLastError());
}
