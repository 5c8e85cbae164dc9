// The balanced segmented reduction that the scatter-add and the moment
// update share (scatter_add.cu, scatter_update.cu), and their front end's
// sort.
//
// The N sorted positions are cut into tiles of R consecutive rows, and one
// warp streams one tile's rows over one 128-column pass, keeping a running
// sum that it closes whenever the id changes. Every warp has the same work,
// whatever the lengths of the runs of equal ids:
//   * a run that begins and ends inside the tile has this warp as its only
//     writer, and is written at once;
//   * a run that crosses a tile's edge is not written. The warp stores its
//     partial sum in scratch, in one of the tile's two slots: slot 0 (head)
//     for the run that came in from the tile before, slot 1 (tail) for the
//     run that starts here and goes on into the next tile. A tile that lies
//     whole inside one run stores that sum once, in slot 0. Each slot has an
//     id beside it, -1 when the slot is empty, and every tile writes both
//     ids, so the scratch needs no zero fill.
// A second, small kernel on the same stream has one warp per crossing run
// (the warp of the tile whose tail slot holds it) add the run's partials in
// tile order and write the row once. The stream orders the two kernels; a
// last-block-done tail inside the first kernel would put every crossing run
// on one block, and on the edge route's heads most runs cross an edge.
// R depends only on the shape (ops/scatter.py: tile_rows), so the order of
// every sum is fixed: the result is a pure function of the inputs.
//
// Rows are read through an optional permutation (row r of the sorted order
// is entry order[r]), so the front end for unsorted ids permutes nothing.
// Its sort is CUB's radix sort of (id, position) pairs over only the bits
// that V needs; radix sort is stable, so equal ids keep their positions'
// order. Dropped ids (outside [0, V)) get the key V: they sort to the end,
// read as dropped again, touch no row and leave no live partial.
#pragma once

#include <cub/device/device_radix_sort.cuh>

#include "common.cuh"

namespace gv {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kPassCols = 4 * kWarp;   // columns one warp covers in a pass
constexpr int kMaxTileRows = kWarp;    // a lane holds one row's id

// The ids as a wrapper hands them over: int32 or int64, any value.
struct Ids {
  const void* p;
  int wide;   // 1: int64
  // id i, or -1 for an id outside [0, v)
  __device__ __forceinline__ int32_t at(int64_t i, int64_t v) const {
    const int64_t x = wide ? static_cast<const int64_t*>(p)[i]
                           : static_cast<const int32_t*>(p)[i];
    return (x < 0 || x >= v) ? -1 : static_cast<int32_t>(x);
  }
};

// The 4 columns of a row that a lane owns in one pass.
struct Frag {
  float x[4];
};

__device__ __forceinline__ Frag zero_frag() {
  Frag f;
  f.x[0] = f.x[1] = f.x[2] = f.x[3] = 0.f;
  return f;
}

__device__ __forceinline__ void add(Frag& a, const Frag& b) {
#pragma unroll
  for (int k = 0; k < 4; ++k) a.x[k] += b.x[k];
}

// Column map of a lane: with vectors, 4 neighbouring columns (one 16-byte
// load of float32); without, 4 columns a warp's width apart (coalesced
// scalar loads, any width and alignment). Columns >= w load 0 and are not
// stored.
template <bool kVec>
struct Cols {
  int64_t c0, w;
  __device__ __forceinline__ Cols(int pass, int lane, int64_t width)
      : c0(static_cast<int64_t>(pass) * kPassCols + (kVec ? 4 * lane : lane)),
        w(width) {}
  __device__ __forceinline__ int64_t col(int k) const {
    return kVec ? c0 + k : c0 + kWarp * k;
  }
  template <typename T>
  __device__ __forceinline__ Frag load(const T* row) const {
    Frag f = zero_frag();
    if (kVec) {
      if (c0 < w) {
        const float4 v = load4(row + c0);
        f.x[0] = v.x;
        f.x[1] = v.y;
        f.x[2] = v.z;
        f.x[3] = v.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (col(k) < w) f.x[k] = to_float(row[col(k)]);
      }
    }
    return f;
  }
  template <typename T>
  __device__ __forceinline__ void store(T* row, const Frag& f) const {
    if (kVec) {
      if (c0 < w) {
        store4(row + c0, make_float4(f.x[0], f.x[1], f.x[2], f.x[3]));
      }
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (col(k) < w) store1(row + col(k), f.x[k]);
      }
    }
  }
};

// Which (tile, pass) a warp works on; tile >= tiles means none.
struct WarpJob {
  int64_t tile;
  int pass, lane;
  __device__ __forceinline__ explicit WarpJob(int passes) {
    const int64_t warp = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                         threadIdx.x / kWarp;
    tile = warp / passes;
    pass = static_cast<int>(warp % passes);
    lane = threadIdx.x % kWarp;
  }
};

// One tile's rows, one per lane: id (-1 when dropped), source row, and
// whether the first and the last run go on beyond the tile's edges. Lanes
// past the tile's last row repeat its last id, so they open no run.
struct Tile {
  int rows;
  int32_t id;
  int64_t src;
  int32_t first_id;
  bool first_open, last_open;
  __device__ __forceinline__ Tile(const Ids& ids,
                                  const uint32_t* __restrict__ order,
                                  int64_t n, int64_t v, int64_t tile, int r,
                                  int lane) {
    const int64_t start = tile * r;
    rows = static_cast<int>(n - start < r ? n - start : r);
    const int64_t j = start + (lane < rows ? lane : rows - 1);
    id = ids.at(j, v);
    src = order ? static_cast<int64_t>(order[j]) : j;
    first_id = __shfl_sync(kFullMask, id, 0);
    const int32_t last_id = __shfl_sync(kFullMask, id, rows - 1);
    // ids, not positions, say whether two neighbours are one run
    first_open = first_id >= 0 && start > 0 &&
                 ids.at(start - 1, v) == first_id;
    last_open = last_id >= 0 && start + rows < n &&
                ids.at(start + rows, v) == last_id;
  }
};

// How many of the head partials of tiles t, t + 1, ... (at most 32) go on
// with run `id`. Warp-collective.
__device__ __forceinline__ int continuing(const int32_t* __restrict__ part_id,
                                          int64_t t, int64_t tiles,
                                          int32_t id, int lane) {
  const int64_t tt = t + lane;
  const bool same = tt < tiles && part_id[2 * tt] == id;
  const unsigned ballot = __ballot_sync(kFullMask, same);
  return ballot == kFullMask ? kWarp : __ffs(~ballot) - 1;
}

inline int64_t num_tiles(int64_t n, int r) { return (n + r - 1) / r; }
inline int num_passes(int64_t w) {
  return static_cast<int>((w + kPassCols - 1) / kPassCols);
}
inline unsigned num_blocks(int64_t tiles, int passes) {
  return static_cast<unsigned>((tiles * passes + kWarpsPerBlock - 1) /
                               kWarpsPerBlock);
}

// ---------------------------------------------------------------------------
// scratch: one allocation of the wrapper's, cut up here
// ---------------------------------------------------------------------------

inline size_t align_up(size_t x) { return (x + 255) & ~static_cast<size_t>(255); }

inline int key_bits(int64_t v) {   // the sort's keys are 0 .. v
  int b = 1;
  while ((static_cast<int64_t>(1) << b) <= v) ++b;
  return b;
}

struct Scratch {
  // byte offsets; with a sort, `temp` to the end of the scratch is the
  // radix sort's temporary storage
  size_t part_id, part_c, part[2], keys[2], pos[2], temp;
};

// n_part partial arrays of [tiles, 2, w] floats (1: sums; 2: sums and
// squares), ids and counts of [tiles, 2], and, with `sort`, the radix
// sort's two key and two position buffers; its temporary storage follows.
inline Scratch plan_scratch(int64_t n, int64_t w, int r, int n_part,
                            bool sort) {
  Scratch s{};
  const size_t slots = static_cast<size_t>(num_tiles(n, r)) * 2;
  size_t at = 0;
  auto take = [&at](size_t bytes) {
    const size_t here = at;
    at += align_up(bytes);
    return here;
  };
  s.part_id = take(slots * sizeof(int32_t));
  s.part_c = take(slots * sizeof(float));
  for (int k = 0; k < n_part; ++k) s.part[k] = take(slots * w * sizeof(float));
  if (sort) {
    for (int k = 0; k < 2; ++k) s.keys[k] = take(n * sizeof(uint32_t));
    for (int k = 0; k < 2; ++k) s.pos[k] = take(n * sizeof(uint32_t));
  }
  s.temp = at;
  return s;
}

// Bytes of scratch for one call (the wrapper allocates them), or -1 - (a
// CUDA error code).
inline long long scratch_bytes(int64_t n, int64_t v, int64_t w, int r,
                               int n_part, bool sort) {
  size_t temp_bytes = 0;
  if (sort) {
    cub::DoubleBuffer<uint32_t> keys(nullptr, nullptr), pos(nullptr, nullptr);
    const cudaError_t err = cub::DeviceRadixSort::SortPairs(
        nullptr, temp_bytes, keys, pos, n, 0, key_bits(v));
    if (err != cudaSuccess) return -1 - static_cast<long long>(err);
  }
  return static_cast<long long>(plan_scratch(n, w, r, n_part, sort).temp +
                                align_up(temp_bytes));
}

__global__ void sort_keys_kernel(Ids ids, int64_t n, int64_t v,
                                 uint32_t* __restrict__ keys,
                                 uint32_t* __restrict__ pos) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t id = ids.at(i, v);
  keys[i] = id < 0 ? static_cast<uint32_t>(v) : static_cast<uint32_t>(id);
  pos[i] = static_cast<uint32_t>(i);
}

// Stable order of the ids: on return `sorted` reads the ascending keys (as
// int32 ids; the key v of a dropped id reads as dropped) and `order` the
// position each came from, both inside the scratch.
inline cudaError_t sort_ids(const Ids& ids, int64_t n, int64_t v, char* base,
                            size_t bytes, const Scratch& s,
                            cudaStream_t stream, Ids& sorted,
                            const uint32_t*& order) {
  uint32_t* k0 = reinterpret_cast<uint32_t*>(base + s.keys[0]);
  uint32_t* k1 = reinterpret_cast<uint32_t*>(base + s.keys[1]);
  uint32_t* p0 = reinterpret_cast<uint32_t*>(base + s.pos[0]);
  uint32_t* p1 = reinterpret_cast<uint32_t*>(base + s.pos[1]);
  const int threads = 256;
  sort_keys_kernel<<<static_cast<unsigned>((n + threads - 1) / threads),
                     threads, 0, stream>>>(ids, n, v, k0, p0);
  cub::DoubleBuffer<uint32_t> keys(k0, k1), pos(p0, p1);
  // the sort refuses storage smaller than it needs
  size_t temp_bytes = bytes - s.temp;
  const cudaError_t err = cub::DeviceRadixSort::SortPairs(
      base + s.temp, temp_bytes, keys, pos, n, 0, key_bits(v), stream);
  sorted = Ids{keys.Current(), 0};
  order = pos.Current();
  return err;
}

}  // namespace gv
