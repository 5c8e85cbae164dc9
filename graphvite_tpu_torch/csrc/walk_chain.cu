// The first-order walk chain (ops/device_sampler.py:walk_chain): every
// lane's start edge and its L - 1 alias steps in one launch, bit-equal to
// the plain chain (walk_chain_plain) from the same draws.
//
// It replaces no TPU kernel: the JAX package's chain
// (graphvite_tpu/ops/device_sampler.py:make_walk_chain_fn) is jnp that XLA
// fuses into a few programs. Eagerly, PyTorch made ~16 launches a step,
// each over only W lanes (192 on the Youtube DeepWalk batch), so the host's
// launches, not the device, set the chain's pace.
//
// What bounds it: latency. A lane makes L - 1 dependent steps, each two
// (three on weighted graphs) dependent random loads: the 16-byte (row
// start, degree) of its vertex, then the neighbour at the picked CSR
// position (its alias prob and entry first on weighted graphs). The bytes
// are a few kB a step, so at 39 steps the floor is ~78-117 dependent loads
// for any lane count below the card's saturation: one lane's chain took
// 0.03-0.04 ms on an H100 80GB HBM3, as did 192 and 576 lanes. The design:
// one thread a lane, the whole chain in registers, no shared memory and no
// synchronisation; the draws w1s[i, lane] and w2s[i, lane] are read, and
// chain[j, lane] and valid[j, lane] written, coalesced across the lanes of
// a warp; a lane at a dead end stops loading. Many lanes in flight (the
// episode-bulk walks: 96,000) hide the latency; at 192 lanes the chain of
// dependent loads is the time.
//
// Bit-equality with the plain chain (float32 arithmetic as PyTorch's
// kernels do it, with no contraction): a pick is
// min(trunc(u * float(deg)), deg - 1) with the multiply rounded once; the
// float start rule min(trunc(u * float(n)), n - 1); positions, row starts
// and aliases of the start table are 64-bit (3.6e9 directed edges); vertex
// ids are read as int32 and written as int64.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

// start modes: where a lane's first edge comes from
constexpr int kFlat = 0;       // a flat column, kept (equal weights)
constexpr int kFlatAlias = 1;  // a flat column through the start alias table
constexpr int kCsr = 2;        // a CSR position; its head by binary search

struct Args {
  const void* u1;          // [W] float32 or int64
  const float* u2;         // [W] (kFlatAlias)
  const float* w1s;        // [L - 1, W]
  const float* w2s;        // [L - 1, W] (weighted picks)
  const float* edge_prob;  // [E] (kFlatAlias)
  const void* edge_alias;  // [E] int32 or int64 (kFlatAlias)
  const void* heads;       // [E] int32; kCsr: [V] int64 row starts
  const int32_t* tails;    // [E] (flat modes)
  const longlong2* vdeg;   // [V] (row start, degree)
  const int32_t* indices;  // [Ed]
  const float* nbr_prob;   // [Ed] (weighted picks)
  const int32_t* nbr_alias;
  int64_t num_heads;
  int64_t num_indices;
  int64_t n_start;         // start columns
  float n_start_f;         // float(n_start), the float rule's factor
  int W;
  int L;
  int64_t* chain;          // [L + 1, W]
  bool* valid;             // [L + 1, W]
};

template <bool kFloatU1>
__device__ __forceinline__ int64_t start_column(const Args& a, int lane) {
  if (kFloatU1) {
    const float u = __ldg(static_cast<const float*>(a.u1) + lane);
    const int64_t c = static_cast<int64_t>(__fmul_rn(u, a.n_start_f));
    return c < a.n_start - 1 ? c : a.n_start - 1;
  }
  return __ldg(static_cast<const long long*>(a.u1) + lane);
}

// searchsorted(starts, e, right=True) - 1: the last row starting at or
// before e (rows of degree 0 share their start with the next row)
__device__ __forceinline__ int64_t row_of(const long long* starts,
                                          int64_t n, int64_t e) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (__ldg(starts + mid) <= e) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo - 1;
}

template <bool kFloatU1, int kStart, typename AliasT, bool kUniform>
__global__ void __launch_bounds__(kThreads) walk_chain_kernel(Args a) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= a.W) return;
  const int64_t W = a.W;
  int64_t e = start_column<kFloatU1>(a, lane);
  int64_t v0, v;
  if (kStart == kCsr) {
    v0 = row_of(static_cast<const long long*>(a.heads), a.num_heads, e);
    v = __ldg(a.indices + e);
  } else {
    if (kStart == kFlatAlias) {
      if (!(__ldg(a.u2 + lane) < __ldg(a.edge_prob + e))) {
        e = static_cast<int64_t>(
            __ldg(static_cast<const AliasT*>(a.edge_alias) + e));
      }
    }
    v0 = __ldg(static_cast<const int32_t*>(a.heads) + e);
    v = __ldg(a.tails + e);
  }
  a.chain[lane] = v0;
  a.chain[W + lane] = v;
  a.valid[lane] = true;
  a.valid[W + lane] = true;
  // a dead vertex's row start may be the end of `indices`: clamp as the
  // plain chain does (only live rows are read here, so it never binds)
  const int64_t last = a.num_indices > 0 ? a.num_indices - 1 : 0;
  bool alive = true;
  for (int i = 0; i < a.L - 1; ++i) {
    const int64_t at = i * W + lane;
    if (alive) {
      const longlong2 row = __ldg(a.vdeg + v);
      const int64_t start = row.x, deg = row.y;
      if (deg > 0) {
        const float u = __ldg(a.w1s + at);
        int64_t idx =
            static_cast<int64_t>(__fmul_rn(u, __ll2float_rn(deg)));
        idx = idx < deg - 1 ? idx : deg - 1;
        int64_t flat = start + idx;
        flat = flat < last ? flat : last;
        if (!kUniform) {
          const int64_t local =
              __ldg(a.w2s + at) < __ldg(a.nbr_prob + flat)
                  ? idx
                  : static_cast<int64_t>(__ldg(a.nbr_alias + flat));
          flat = start + local;
          flat = flat < last ? flat : last;
        }
        v = __ldg(a.indices + flat);
      } else {
        alive = false;
      }
    }
    a.chain[(i + 2) * W + lane] = v;
    a.valid[(i + 2) * W + lane] = alive;
  }
}

template <bool kFloatU1, int kStart, typename AliasT>
cudaError_t launch_picks(const Args& a, bool uniform, cudaStream_t stream) {
  const int blocks = (a.W + kThreads - 1) / kThreads;
  if (uniform) {
    walk_chain_kernel<kFloatU1, kStart, AliasT, true>
        <<<blocks, kThreads, 0, stream>>>(a);
  } else {
    walk_chain_kernel<kFloatU1, kStart, AliasT, false>
        <<<blocks, kThreads, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

template <bool kFloatU1>
cudaError_t launch_start(const Args& a, int start_mode, bool alias64,
                         bool uniform, cudaStream_t stream) {
  if (start_mode == kCsr) {
    return launch_picks<kFloatU1, kCsr, int32_t>(a, uniform, stream);
  }
  if (start_mode == kFlatAlias) {
    return alias64
               ? launch_picks<kFloatU1, kFlatAlias, long long>(a, uniform,
                                                             stream)
               : launch_picks<kFloatU1, kFlatAlias, int32_t>(a, uniform,
                                                             stream);
  }
  return launch_picks<kFloatU1, kFlat, int32_t>(a, uniform, stream);
}

}  // namespace

// Launch the chain of W lanes and L - 1 steps on `stream`. start_mode:
// 0 flat, 1 flat through the start alias table (int64 entries with
// alias64), 2 CSR; float_u1: u1 is float32 (else int64); uniform: equal
// weights (no nbr_prob / nbr_alias). Returns a CUDA error code (0: none).
extern "C" int gv_walk_chain(
    const void* u1, int float_u1, const void* u2, const void* w1s,
    const void* w2s, const void* edge_prob, const void* edge_alias,
    int start_mode, int alias64, const void* heads, const void* tails,
    int64_t num_heads, const void* vdeg, const void* indices,
    int64_t num_indices, const void* nbr_prob, const void* nbr_alias,
    int uniform, int64_t n_start, float n_start_f, int W, int L, void* chain,
    void* valid, void* stream) {
  Args a;
  a.u1 = u1;
  a.u2 = static_cast<const float*>(u2);
  a.w1s = static_cast<const float*>(w1s);
  a.w2s = static_cast<const float*>(w2s);
  a.edge_prob = static_cast<const float*>(edge_prob);
  a.edge_alias = edge_alias;
  a.heads = heads;
  a.tails = static_cast<const int32_t*>(tails);
  a.vdeg = static_cast<const longlong2*>(vdeg);
  a.indices = static_cast<const int32_t*>(indices);
  a.nbr_prob = static_cast<const float*>(nbr_prob);
  a.nbr_alias = static_cast<const int32_t*>(nbr_alias);
  a.num_heads = num_heads;
  a.num_indices = num_indices;
  a.n_start = n_start;
  a.n_start_f = n_start_f;
  a.W = W;
  a.L = L;
  a.chain = static_cast<int64_t*>(chain);
  a.valid = static_cast<bool*>(valid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return float_u1
             ? static_cast<int>(launch_start<true>(a, start_mode, alias64 != 0,
                                                   uniform != 0, s))
             : static_cast<int>(launch_start<false>(a, start_mode,
                                                    alias64 != 0,
                                                    uniform != 0, s));
}
