// Segmented scatter-add for Hopper (sm_90a):
//     table[ids[j]] += upd[j]   for every j, duplicate ids summed.
//
// Replaces the TPU kernel graphvite_tpu/ops/pallas_scatter.py:
// sweep_scatter_add (and its front end sweep_scatter_add_unsorted). The
// TPU version streams the whole table through VMEM and selects rows with
// one-hot MXU matmuls, because the TPU has no cheap random row access.
// Hopper has it, so this kernel touches only the rows the updates name.
//
// Contract (the callers are in graphvite_tpu_torch/ops/scatter.py):
//   table  [V, W] float32 or bfloat16, contiguous, updated in place;
//   ids    [N] int32 or int64; ids < 0 or >= V are dropped. Ascending
//          (scatter_add_sorted_), or in any order with `sort` set
//          (scatter_add_), or ascending with the permutation `order` that
//          made them so;
//   upd    [N, W] float32; entry j belongs to ids[j] (with a sort or an
//          order: row r of the sorted order is upd[order[r]], read in
//          place, never copied).
// Each row's updates are summed in float32 in stable-sorted order, added
// to the row's value, and the row is written once, cast to the table's
// type, by one warp: no float atomics, and the same inputs give the same
// bits. Ids that are not ascending break that: two warps would own a row.
//
// What bounds it: memory. It must read N*W*4 bytes of updates and the ids
// and read and write the U touched rows (2*U*W*s bytes for s-byte
// elements); it does N*W adds, far below the card's float rate. What held
// the first version (one warp per run of equal ids) far from that bound
// was one warp's latency chain: the edge route's sorted stream hands a
// batch runs of 1024-2048 rows of one hub id, read row after row by one
// warp while the others had left. The design is segmented.cuh's: tiles of
// R rows, one warp per tile and 128-column pass, every warp with the same
// work and 8 rows' 16-byte loads in flight; runs inside a tile written at
// once; runs across tile edges left as partial sums, which a second small
// kernel adds in tile order, one warp per such run. R is 32, 16 or 8, the
// largest that still gives 16 warps for each of the 132 SMs
// (ops/scatter.py: tile_rows): 32 at the edge route's 99,328 x 128, 8 at
// DeepWalk's 11,968 x 256 (two passes a row).

#include "segmented.cuh"

namespace {

using gv::Cols;
using gv::Frag;
using gv::Ids;
using gv::kFullMask;
using gv::kWarp;
using gv::kWarpsPerBlock;

constexpr int kRowsInFlight = 8;
constexpr int kPartsInFlight = 16;

template <typename T, bool kVec>
__device__ __forceinline__ void add_to_row(T* __restrict__ table, int32_t id,
                                           int64_t w, const Cols<kVec>& cols,
                                           const Frag& sum) {
  T* row = table + static_cast<int64_t>(id) * w;
  Frag value = cols.load(row);
  gv::add(value, sum);
  cols.store(row, value);
}

// First kernel: one warp per (tile, pass). Runs inside the tile are added
// to their rows; the runs that cross its edges go to the tile's slots.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
scatter_add_tiles(T* __restrict__ table, Ids ids,
                  const uint32_t* __restrict__ order,
                  const float* __restrict__ upd, int64_t n, int64_t v,
                  int64_t w, int r, int passes, int64_t tiles,
                  float* __restrict__ part, int32_t* __restrict__ part_id) {
  // tile, pass and every id below are the same in all lanes of a warp, so
  // the branches are warp-uniform and the shuffles see all 32 lanes
  const gv::WarpJob job(passes);
  if (job.tile >= tiles) return;
  const gv::Tile tile(ids, order, n, v, job.tile, r, job.lane);
  const Cols<kVec> cols(job.pass, job.lane, w);

  int32_t slot_id[2] = {-1, -1};
  auto close = [&](int32_t id, const Frag& sum, int slot) {
    if (id < 0) return;   // a run of dropped ids
    if (slot < 0) {
      add_to_row(table, id, w, cols, sum);
    } else {
      cols.store(part + (2 * job.tile + slot) * w, sum);
      slot_id[slot] = id;
    }
  };

  Frag sum = gv::zero_frag();
  int32_t cur = tile.first_id;
  bool first_run = true;
  for (int i0 = 0; i0 < tile.rows; i0 += kRowsInFlight) {
    Frag x[kRowsInFlight];
    int32_t id[kRowsInFlight];
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      const int i = (i0 + u) % kWarp;
      id[u] = __shfl_sync(kFullMask, tile.id, i);
      const int64_t src = __shfl_sync(kFullMask, tile.src, i);
      x[u] = (i0 + u < tile.rows && id[u] >= 0) ? cols.load(upd + src * w)
                                                : gv::zero_frag();
    }
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      if (i0 + u < tile.rows) {
        if (id[u] != cur) {
          close(cur, sum, first_run && tile.first_open ? 0 : -1);
          first_run = false;
          cur = id[u];
          sum = gv::zero_frag();
        }
        gv::add(sum, x[u]);
      }
    }
  }
  // a tile that lies whole inside a longer run stores its sum once, as a
  // head partial
  close(cur, sum,
        first_run && tile.first_open ? 0 : (tile.last_open ? 1 : -1));
  if (job.pass == 0 && job.lane == 0) {
    part_id[2 * job.tile] = slot_id[0];
    part_id[2 * job.tile + 1] = slot_id[1];
  }
}

// Second kernel: the warp of a tile whose tail slot is live owns that run.
// It adds the head partials of the tiles after it, in tile order, for as
// long as they carry the run's id, and writes the row.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
scatter_add_runs(T* __restrict__ table, int64_t w, int passes, int64_t tiles,
                 const float* __restrict__ part,
                 const int32_t* __restrict__ part_id) {
  const gv::WarpJob job(passes);
  if (job.tile >= tiles) return;
  const int32_t id = part_id[2 * job.tile + 1];
  if (id < 0) return;
  const Cols<kVec> cols(job.pass, job.lane, w);
  Frag sum = cols.load(part + (2 * job.tile + 1) * w);
  for (int64_t t = job.tile + 1;; t += kWarp) {
    const int m = gv::continuing(part_id, t, tiles, id, job.lane);
    for (int k0 = 0; k0 < m; k0 += kPartsInFlight) {
      Frag x[kPartsInFlight];
#pragma unroll
      for (int u = 0; u < kPartsInFlight; ++u) {
        if (k0 + u < m) x[u] = cols.load(part + 2 * (t + k0 + u) * w);
      }
#pragma unroll
      for (int u = 0; u < kPartsInFlight; ++u) {
        if (k0 + u < m) gv::add(sum, x[u]);
      }
    }
    if (m < kWarp) break;
  }
  add_to_row(table, id, w, cols, sum);
}

template <typename T, bool kVec>
void launch(void* table, const Ids& ids, const uint32_t* order,
            const float* upd, int64_t n, int64_t v, int64_t w, int r,
            char* base, const gv::Scratch& s, cudaStream_t stream) {
  const int64_t tiles = gv::num_tiles(n, r);
  const int passes = gv::num_passes(w);
  const dim3 block(kWarp * kWarpsPerBlock);
  const dim3 grid(gv::num_blocks(tiles, passes));
  T* t = static_cast<T*>(table);
  float* part = reinterpret_cast<float*>(base + s.part[0]);
  int32_t* part_id = reinterpret_cast<int32_t*>(base + s.part_id);
  scatter_add_tiles<T, kVec><<<grid, block, 0, stream>>>(
      t, ids, order, upd, n, v, w, r, passes, tiles, part, part_id);
  scatter_add_runs<T, kVec><<<grid, block, 0, stream>>>(t, w, passes, tiles,
                                                        part, part_id);
}

}  // namespace

extern "C" {

// Bytes of scratch gv_scatter_add needs at this shape (the wrapper
// allocates them with torch.empty), or -1 - (a CUDA error code).
long long gv_scatter_add_scratch(long long n, long long v, long long w, int r,
                                 int sort) {
  if (n <= 0 || w <= 0) return 0;
  return gv::scratch_bytes(n, v, w, r, 1, sort != 0);
}

// dtype: 0 = float32 table, 1 = bfloat16 table. ids64: 1 for int64 ids.
// sort: 1 sorts the ids here (any order allowed); else they are ascending
// and `order` is null (rows in place) or their [N] uint32 permutation. r:
// rows a tile, 1..32. vec: 1 when w % 4 == 0 and the table and update
// pointers are aligned for 4-element vectors. scratch: scratch_bytes >=
// gv_scatter_add_scratch(n, v, w, r, sort) bytes, 256-byte aligned.
// Returns the first CUDA error of the launches (0 on success).
int gv_scatter_add(void* table, int dtype, const void* ids, int ids64,
                   int sort, const void* order, const void* upd, long long n,
                   long long v, long long w, int r, int vec, void* scratch,
                   long long scratch_bytes, void* stream) {
  if (n <= 0 || w <= 0) return 0;
  if (r < 1 || r > gv::kMaxTileRows || v <= 0 || v >= (1ll << 31) ||
      n >= (1ll << 31) || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const gv::Scratch s = gv::plan_scratch(n, w, r, 1, sort != 0);
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
  const float* u = static_cast<const float*>(upd);
  auto fn = dtype == 0 ? (vec ? launch<float, true> : launch<float, false>)
                       : (vec ? launch<__nv_bfloat16, true>
                              : launch<__nv_bfloat16, false>);
  fn(table, sid, ord, u, n, v, w, r, base, s, st);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
