// K4: kd-tile work-list nearest neighbour — each scene tile folds only the
// model tiles that can hold a nearest neighbour of one of its points.
//
// Replaces icp_tpu/kernels/nn_grid.py:240 _pruned_kernel.
//
// What bounds it on the H100: the distance fold over the candidate tiles,
// the same 8 float32 operations per (point, model row) pair as K1 (horse's
// first iteration: ~1e9 pairs, 0.12 ms at the float32 peak).  The card
// issues one instruction per lane and cycle, so the fold's compare makes a
// pair cost ~10 issue slots: ~2.5x the bound is the floor of this design.
//
// The search, one C call: a memset of the keys, then five kernels:
//  1. plan (one block): each scene tile's fold list (its candidates, or all
//     Nj tiles when its count passes the table's capacity) becomes one work
//     item per model tile; an exclusive scan of the lists' lengths gives
//     each tile's first item, the total, and zeroed work and skip counters.
//  2. near tiles (one warp a scene tile): each scene tile's F (the
//     wrapper's NEAR_TILES, 2) model tiles whose boxes lie nearest its own,
//     by the table's box distance, then by the distance between the boxes'
//     centres; -1 where one is not in the tile's fold list.
//  3. near pass: the fold below over the Ni x F near tiles.  They run
//     before any other item, so every point holds a tight best before the
//     main pass starts.
//  4. main pass: the same fold over the plan's items; an item whose model
//     tile is one of its scene tile's near tiles is not folded again.
//     Fold (persistent blocks, as many as the SMs hold): a block takes the
//     next item from its pass's counter, finds its scene tile by binary
//     search in the scan, and first tests the item: each thread reads its
//     points' current keys (the high word is the best d2 so far) and the
//     squared distance from each point to the model tile's box, rounded as
//     the fold rounds and deflated; the block folds the item only if some
//     point's box distance is at most its best (__syncthreads_or), and
//     otherwise counts it as skipped and takes the next.  The fold streams
//     the item's model tile through a kStages-deep ring of 128-row float4
//     stages in shared memory filled by cp.async (the next
//     stages load while this one is folded; the TPU kernel's double-buffered
//     copies, nn_grid.py:285-295).  Each thread holds kPoints = 2 scene
//     points, so one broadcast shared-memory row feeds two independent
//     compare chains; a ragged tile masks its last points.  The fold
//     carries only (d2, original index); its result merges into the
//     point's 64-bit key by
//     atomicMin: d2's float bits (d2 >= 0 orders as an unsigned integer) in
//     the high word, the original index in the low word, so the winner is
//     the lexicographic minimum of (d2, original index) whatever the order
//     of the items (nn_grid.py:320-323).  A tile past the capacity folds all
//     Nj tiles as Nj items spread over the card, not as one straggler
//     block.  One-tile items balance best at horse (48,485 points: one wave
//     of items on the card) and cost nothing at a million points.
//  5. epilogue (a thread per point): unpacks the key into d2 and the index,
//     and reads the winner's kd row from the grid's inverse permutation
//     (kd_row), then its point from the tiles and, when given, its payload
//     row (nn_grid.py:432-472, the plane engines' normals) from the
//     kd-ordered (Nj * tm) float4 payload.  A null payload pointer means no
//     payload (the point-to-point engines).
//
// Why the skip is exact: the box distance is a lower bound on the distance
// the fold computes to any real row of the tile.  Per axis the gap
// max(lo - p, p - hi, 0) is at most |p - q| for q in [lo, hi], and a
// rounded difference, square and sum are monotone in their operands, so in
// the fold's order and rounding (sqdist_rn) the box's d2 is at most every
// row's; the deflation only lowers it.  The test is strict: an item is
// skipped only where every point's box distance is greater than its best,
// so no row of it can win or tie, and the lowest index still wins a tie.
// A key read beside another block's atomicMin is stale only upward, so it
// only skips less.  A point with no match yet holds the all-ones key, above
// every distance, and a NaN coordinate gives a zero gap: both fold.  The
// union of the near and main passes' items is the fold list, so the answer
// is the fold list's whatever the table.  (Padding rows, at 1e17, lie
// outside their tile's box, but farther from any point of a registration
// than the box is, so the box bounds them too.)
#include "common.cuh"

namespace {

constexpr int kPoints = 2;        // scene points a thread
constexpr int kStageRows = 128;  // float4 rows per ring stage (tm is a multiple of 128)
constexpr int kStages = 4;       // ring depth: 8 KB of shared memory
constexpr int kMaxThreads = 512;
constexpr unsigned kNoIndex = 0xffffffffu;
// nn_grid.py's _LOWER_DEFLATE: the box distance is a lower bound through
// float32 rounding, as the candidate table's
constexpr float kLowerDeflate = 1.0f - 1e-5f;
constexpr int kNearTiles = 2;     // nn_grid.py's NEAR_TILES: most near tiles a scene tile

// The length of a scene tile's fold list: its work items.
__device__ __forceinline__ int n_items(int cnt, int cap, int nj) {
  return cnt > cap ? nj : max(cnt, 1);
}

// offsets[0..ni): each scene tile's first work item; offsets[ni]: the total;
// offsets[ni + 1], offsets[ni + 2]: the main and near passes' work counters;
// offsets[ni + 3]: the items skipped; all three zeroed.
__global__ void __launch_bounds__(1024)
nn_grid_plan_kernel(const int* __restrict__ counts, int ni, int cap, int nj,
                    int* __restrict__ offsets) {
  __shared__ int warp_sums[32];
  const int per = (ni + blockDim.x - 1) / blockDim.x;
  const int lo = min(ni, static_cast<int>(threadIdx.x) * per);
  const int hi = min(ni, lo + per);
  int sum = 0;
  for (int t = lo; t < hi; ++t) sum += n_items(counts[t], cap, nj);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < static_cast<int>(blockDim.x >> 5) ? warp_sums[lane] : 0;
    int wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, wi, o);
      if (lane >= o) wi += v;
    }
    warp_sums[lane] = wi - w;
  }
  __syncthreads();
  int run = warp_sums[warp] + incl - sum;
  for (int t = lo; t < hi; ++t) {
    offsets[t] = run;
    run += n_items(counts[t], cap, nj);
  }
  if (threadIdx.x == blockDim.x - 1) {
    offsets[ni] = run;
    offsets[ni + 1] = 0;
    offsets[ni + 2] = 0;
    offsets[ni + 3] = 0;
  }
}

// Squared distance from p to the box [lo, hi], in sqdist_rn's order and
// rounding, deflated: at most sqdist_rn(p, q) for every q in the box.  A
// NaN coordinate gives a zero gap (fmaxf drops NaN).
__device__ __forceinline__ float box_d2_rn(float px, float py, float pz,
                                           const float* lo, const float* hi) {
  const float gx = fmaxf(fmaxf(__fsub_rn(lo[0], px), __fsub_rn(px, hi[0])), 0.f);
  const float gy = fmaxf(fmaxf(__fsub_rn(lo[1], py), __fsub_rn(py, hi[1])), 0.f);
  const float gz = fmaxf(fmaxf(__fsub_rn(lo[2], pz), __fsub_rn(pz, hi[2])), 0.f);
  const float d = __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)), __fmul_rn(gz, gz));
  return __fmul_rn(d, kLowerDeflate);
}

// (box distance, centre distance) bits, each >= 0 so its float bits order
// as an unsigned integer, and the model tile: a near-tile candidate; the
// least key wins, then the lower tile.
struct NearKey {
  unsigned long long key;
  int tile;
};

__device__ __forceinline__ bool near_before(const NearKey& a, const NearKey& b) {
  return a.key < b.key || (a.key == b.key && a.tile < b.tile);
}

// Keep the kNearTiles least of best[] and c, in order.
__device__ __forceinline__ void near_insert(NearKey (&best)[kNearTiles], NearKey c) {
#pragma unroll
  for (int f = 0; f < kNearTiles; ++f) {
    if (near_before(c, best[f])) {
      const NearKey t = best[f];
      best[f] = c;
      c = t;
    }
  }
}

// One warp a scene tile: its box from its tn rows, then, over the nj model
// tiles, the nf (<= kNearTiles) of least squared box-box distance (in
// tile_box_dists' order and rounding), ties by the squared distance between
// the boxes' centres, then by the lower tile; near[ti * nf + f] is that
// tile where it is a candidate of the table or the tile is past the
// capacity (so in its fold list), else -1.
__global__ void __launch_bounds__(256)
nn_grid_near_kernel(const float* __restrict__ scene, int tn, int ni,
                    const float* __restrict__ tile_lo, const float* __restrict__ tile_hi, int nj,
                    const int* __restrict__ cand, const int* __restrict__ counts, int cap, int nf,
                    int* __restrict__ near) {
  const int lane = threadIdx.x & 31;
  const int ti = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (ti >= ni) return;
  const float inf = __int_as_float(0x7f800000);
  float lo[3] = {inf, inf, inf}, hi[3] = {-inf, -inf, -inf};
  for (int r = lane; r < tn; r += 32) {
    const float* q = scene + 3 * (static_cast<long long>(ti) * tn + r);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = fminf(lo[a], q[a]);
      hi[a] = fmaxf(hi[a], q[a]);
    }
  }
  float mid[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo[a] = fminf(lo[a], __shfl_xor_sync(0xffffffffu, lo[a], o));
      hi[a] = fmaxf(hi[a], __shfl_xor_sync(0xffffffffu, hi[a], o));
    }
    mid[a] = __fmul_rn(__fadd_rn(lo[a], hi[a]), 0.5f);
  }
  NearKey best[kNearTiles];
#pragma unroll
  for (int f = 0; f < kNearTiles; ++f) best[f] = NearKey{~0ull, nj};
  for (int j = lane; j < nj; j += 32) {
    float g[3], c[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float tl = tile_lo[3 * j + a], th = tile_hi[3 * j + a];
      const float gap = fmaxf(fmaxf(__fsub_rn(tl, hi[a]), __fsub_rn(lo[a], th)), 0.f);
      g[a] = __fmul_rn(gap, gap);
      const float dm = __fsub_rn(mid[a], __fmul_rn(__fadd_rn(tl, th), 0.5f));
      c[a] = __fmul_rn(dm, dm);
    }
    const float d = __fmul_rn(__fadd_rn(__fadd_rn(g[0], g[1]), g[2]), kLowerDeflate);
    const float m = __fadd_rn(__fadd_rn(c[0], c[1]), c[2]);
    near_insert(best, NearKey{(static_cast<unsigned long long>(__float_as_uint(d)) << 32) |
                                  __float_as_uint(m), j});
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    NearKey other[kNearTiles];
#pragma unroll
    for (int f = 0; f < kNearTiles; ++f) {
      other[f].key = __shfl_xor_sync(0xffffffffu, best[f].key, o);
      other[f].tile = __shfl_xor_sync(0xffffffffu, best[f].tile, o);
    }
#pragma unroll
    for (int f = 0; f < kNearTiles; ++f) near_insert(best, other[f]);
  }
  if (lane != 0) return;
  const int cnt = counts[ti];
  const int* row = cand + static_cast<long long>(ti) * cap;
#pragma unroll
  for (int f = 0; f < kNearTiles; ++f) {
    if (f >= nf) break;
    const int j = best[f].tile;
    bool listed = j < nj && cnt > cap;
    if (j < nj && !listed) {  // the candidates ascend: a binary search
      int a = 0, b = min(cnt, cap);
      while (a < b) {
        const int h = (a + b) >> 1;
        if (row[h] < j) a = h + 1;
        else b = h;
      }
      listed = a < min(cnt, cap) && row[a] == j;
    }
    near[ti * nf + f] = listed ? j : -1;
  }
}

// One pass over work items: the near pass (near_pass, ni * nf items, item
// t * nf + f folding near[t * nf + f], none where it is -1) or the main
// pass (the plan's items but its scene tile's near tiles).
__global__ void __launch_bounds__(kMaxThreads)
nn_grid_fold_kernel(const int* __restrict__ cand, const int* __restrict__ counts, int ni, int cap,
                    const int* __restrict__ near, int nf, bool near_pass,
                    const float* __restrict__ scene, int tn, int nj, int tm,
                    const float4* __restrict__ tiles, const float* __restrict__ tile_lo,
                    const float* __restrict__ tile_hi, int* __restrict__ offsets,
                    unsigned long long* __restrict__ keys) {
  constexpr int P = kPoints;
  __shared__ __align__(16) float4 ring[kStages][kStageRows];
  __shared__ int s_item, s_ti, s_tile;
  __shared__ float s_lo[3], s_hi[3];
  const int total = near_pass ? ni * nf : offsets[ni];
  int* const next = offsets + ni + (near_pass ? 2 : 1);
  const int nb = tm / kStageRows;  // ring stages a model tile
  const float inf = __int_as_float(0x7f800000);

  for (;;) {
    if (threadIdx.x == 0) {
      const int item = atomicAdd(next, 1);
      s_item = item;
      if (item < total) {
        int ti, tile;
        if (near_pass) {
          ti = item / nf;
          tile = near[item];
        } else {
          int lo = 0, hi = ni - 1;  // the last tile whose first item is <= item
          while (lo < hi) {
            const int mid = (lo + hi + 1) >> 1;
            if (offsets[mid] <= item) lo = mid;
            else hi = mid - 1;
          }
          const int c = item - offsets[lo];  // the c-th tile of the fold list
          ti = lo;
          tile = counts[lo] > cap ? c : cand[lo * cap + c];
          for (int f = 0; f < nf; ++f)  // folded in the near pass
            if (near[lo * nf + f] == tile) tile = -1;
        }
        s_ti = ti;
        s_tile = tile;
        if (tile >= 0) {
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            s_lo[a] = tile_lo[3 * tile + a];
            s_hi[a] = tile_hi[3 * tile + a];
          }
        }
      }
    }
    __syncthreads();
    if (s_item >= total) break;
    const int ti = s_ti;
    const int tile = s_tile;

    float px[P], py[P], pz[P], best[P], bw[P];
    bool near_enough = false;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int r = threadIdx.x + p * blockDim.x;
      const long long row = static_cast<long long>(ti) * tn + r;
      px[p] = r < tn ? scene[3 * row] : 0.f;
      py[p] = r < tn ? scene[3 * row + 1] : 0.f;
      pz[p] = r < tn ? scene[3 * row + 2] : 0.f;
      best[p] = inf;
      bw[p] = inf;
      if (tile >= 0 && r < tn) {
        // the high word of the key: the best d2 so far, all ones before any
        const unsigned held = __ldcg(reinterpret_cast<const unsigned*>(keys + row) + 1);
        near_enough |= __float_as_uint(box_d2_rn(px[p], py[p], pz[p], s_lo, s_hi)) <= held;
      }
    }
    // every thread has read s_*; the ring is free (the last item's barrier)
    if (!__syncthreads_or(near_enough)) {
      if (threadIdx.x == 0 && tile >= 0) atomicAdd(offsets + ni + 3, 1);
      continue;
    }
    const float4* src_tile = tiles + static_cast<long long>(tile) * tm;

    auto issue = [&](int b) {
      const float4* src = src_tile + b * kStageRows;
      float4* dst = ring[b % kStages];
      for (int k = threadIdx.x; k < kStageRows; k += blockDim.x) cp_async16(dst + k, src + k);
    };
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nb) issue(s);
      cp_async_commit();
    }
    for (int b = 0; b < nb; ++b) {
      cp_async_wait<kStages - 2>();  // stage b has landed (this thread's copies)
      __syncthreads();               // ... everyone's; stage b-1 is no longer read
      if (b + kStages - 1 < nb) issue(b + kStages - 1);
      cp_async_commit();
      const float4* buf = ring[b % kStages];
#pragma unroll 4
      for (int k = 0; k < kStageRows; ++k) {
        const float4 q = buf[k];
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const float d = sqdist_rn(px[p], py[p], pz[p], q);
          if (d <= best[p]) {
            bw[p] = d < best[p] ? q.w : fminf(bw[p], q.w);
            best[p] = d;
          }
        }
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int r = threadIdx.x + p * blockDim.x;
      if (r < tn) {
        // original indices are exact float32 integers below 2^24; padding
        // rows carry 3e38 and never win against a real row
        const unsigned lo = bw[p] < 16777216.f ? static_cast<unsigned>(bw[p]) : kNoIndex;
        const unsigned long long key =
            (static_cast<unsigned long long>(__float_as_uint(best[p])) << 32) | lo;
        atomicMin(keys + static_cast<long long>(ti) * tn + r, key);
      }
    }
    __syncthreads();  // the ring and s_* are rewritten by the next item
  }
}

__global__ void nn_grid_epilogue_kernel(const unsigned long long* __restrict__ keys, int n,
                                        const int* __restrict__ kd_row,
                                        const float4* __restrict__ tiles,
                                        const float4* __restrict__ payload,
                                        float* __restrict__ d2_out, int* __restrict__ idx_out,
                                        float* __restrict__ y_out, float4* __restrict__ pl_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned long long key = keys[i];
  const unsigned lo = static_cast<unsigned>(key);
  const int idx = lo < 16777216u ? static_cast<int>(lo) : -1;
  d2_out[i] = __uint_as_float(static_cast<unsigned>(key >> 32));
  idx_out[i] = idx;
  float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 pl = q;
  if (idx >= 0) {
    const int row = kd_row[idx];
    q = tiles[row];
    if (payload) pl = payload[row];
  }
  y_out[3 * i] = q.x;
  y_out[3 * i + 1] = q.y;
  y_out[3 * i + 2] = q.z;
  if (payload) pl_out[i] = pl;
}

cudaError_t launch_near(const float* scene, int tn, int ni, const float* tile_lo,
                        const float* tile_hi, int nj, const int* cand, const int* counts, int cap,
                        int nf, int* near, cudaStream_t stream) {
  const int warps = 256 / 32;
  nn_grid_near_kernel<<<(ni + warps - 1) / warps, 256, 0, stream>>>(
      scene, tn, ni, tile_lo, tile_hi, nj, cand, counts, cap, nf, near);
  return cudaGetLastError();
}

}  // namespace

// The near tiles alone (nn_grid_launch picks its own): near, (ni, nf) int32.
ICP_EXPORT int nn_grid_near_launch(const float* scene, int tn, int ni, const float* tile_lo,
                                   const float* tile_hi, int nj, const int* cand,
                                   const int* counts, int cap, int nf, int* near,
                                   cudaStream_t stream) {
  if (tn < 1 || ni < 1 || nj < 1 || nf < 1 || nf > kNearTiles || nf > nj)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_near(scene, tn, ni, tile_lo, tile_hi, nj, cand, counts, cap, nf,
                                      near, stream));
}

// nf: near tiles a scene tile, min(kNearTiles, nj); tile_lo, tile_hi:
// (nj, 3) float32 boxes of the model tiles' real rows.  scratch: ni + 4 +
// ni * nf ints (the plan's offsets, the two passes' counters, the skipped
// items at scratch[ni + 3], then the near tiles); keys: n 64-bit words of
// scratch.
ICP_EXPORT int nn_grid_launch(const int* cand, const int* counts, int ni, int cap, int nf,
                              const float* scene, int tn, int nj, int tm, const float4* tiles,
                              const float* tile_lo, const float* tile_hi, const int* kd_row,
                              const float4* payload, int* scratch, unsigned long long* keys,
                              float* d2_out, int* idx_out, float* y_out, float4* pl_out,
                              cudaStream_t stream) {
  if (tn < 1 || ni < 1 || nj < 1 || nf < 1 || nf > kNearTiles || nf > nj ||
      tm % kStageRows != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = ((tn + kPoints - 1) / kPoints + 31) / 32 * 32;
  if (threads > kMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  const int n = ni * tn;
  int* const offsets = scratch;
  int* const near = scratch + ni + 4;
  cudaError_t e = cudaMemsetAsync(keys, 0xff, sizeof(unsigned long long) * n, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  nn_grid_plan_kernel<<<1, 1024, 0, stream>>>(counts, ni, cap, nj, offsets);
  e = cudaGetLastError();
  if (e == cudaSuccess)
    e = launch_near(scene, tn, ni, tile_lo, tile_hi, nj, cand, counts, cap, nf, near, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  // persistent: as many blocks as the SMs hold, at most one an item
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, nn_grid_fold_kernel, threads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long resident = static_cast<long long>(sms) * max(per_sm, 1);
  for (int pass = 0; pass < 2; ++pass) {  // the near pass, then the main pass
    const bool near_pass = pass == 0;
    const long long max_items = static_cast<long long>(ni) * (near_pass ? nf : nj);
    nn_grid_fold_kernel<<<static_cast<int>(max_items < resident ? max_items : resident), threads,
                          0, stream>>>(cand, counts, ni, cap, near, nf, near_pass, scene, tn, nj,
                                       tm, tiles, tile_lo, tile_hi, offsets, keys);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  nn_grid_epilogue_kernel<<<(n + 255) / 256, 256, 0, stream>>>(keys, n, kd_row, tiles, payload,
                                                               d2_out, idx_out, y_out, pl_out);
  return static_cast<int>(cudaGetLastError());
}
