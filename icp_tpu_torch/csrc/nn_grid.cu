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
// The design, one C call: a memset of the keys, then three kernels:
//  1. plan (one block): each scene tile's fold list (its candidates, or all
//     Nj tiles when its count passes the table's capacity) becomes one work
//     item per model tile; an exclusive scan of the lists' lengths gives
//     each tile's first item, the total, and a zeroed work counter.
//  2. fold (persistent blocks, as many as the SMs hold): a block takes the
//     next item from the counter, finds its scene tile by binary search in
//     the scan, and folds the item's model tile through a kStages-deep ring
//     of 128-row float4 stages in shared memory filled by cp.async (the next
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
//  3. epilogue (a thread per point): unpacks the key into d2 and the index,
//     and reads the winner's kd row from the grid's inverse permutation
//     (kd_row), then its point from the tiles and, when given, its payload
//     row (nn_grid.py:432-472, the plane engines' normals) from the
//     kd-ordered (Nj * tm) float4 payload.  A null payload pointer means no
//     payload (the point-to-point engines).
#include "common.cuh"

namespace {

constexpr int kPoints = 2;        // scene points a thread
constexpr int kStageRows = 128;  // float4 rows per ring stage (tm is a multiple of 128)
constexpr int kStages = 4;       // ring depth: 8 KB of shared memory
constexpr int kMaxThreads = 512;
constexpr unsigned kNoIndex = 0xffffffffu;

// The length of a scene tile's fold list: its work items.
__device__ __forceinline__ int n_items(int cnt, int cap, int nj) {
  return cnt > cap ? nj : max(cnt, 1);
}

// offsets[0..ni): each scene tile's first work item; offsets[ni]: the total;
// offsets[ni + 1]: the fold's work counter, zeroed.
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
  }
}

__global__ void __launch_bounds__(kMaxThreads)
nn_grid_fold_kernel(const int* __restrict__ cand, const int* __restrict__ counts, int ni, int cap,
                    const float* __restrict__ scene, int tn, int nj, int tm,
                    const float4* __restrict__ tiles, int* __restrict__ offsets,
                    unsigned long long* __restrict__ keys) {
  constexpr int P = kPoints;
  __shared__ __align__(16) float4 ring[kStages][kStageRows];
  __shared__ int s_item, s_ti, s_tile;
  const int total = offsets[ni];
  const int nb = tm / kStageRows;  // ring stages a model tile
  const float inf = __int_as_float(0x7f800000);

  for (;;) {
    if (threadIdx.x == 0) {
      const int item = atomicAdd(offsets + ni + 1, 1);
      s_item = item;
      if (item < total) {
        int lo = 0, hi = ni - 1;  // the last tile whose first item is <= item
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (offsets[mid] <= item) lo = mid;
          else hi = mid - 1;
        }
        const int c = item - offsets[lo];  // the c-th tile of the fold list
        s_tile = counts[lo] > cap ? c : cand[lo * cap + c];
        s_ti = lo;
      }
    }
    __syncthreads();
    if (s_item >= total) break;
    const int ti = s_ti;
    const float4* src_tile = tiles + static_cast<long long>(s_tile) * tm;

    float px[P], py[P], pz[P], best[P], bw[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int r = threadIdx.x + p * blockDim.x;
      const long long row = static_cast<long long>(ti) * tn + r;
      px[p] = r < tn ? scene[3 * row] : 0.f;
      py[p] = r < tn ? scene[3 * row + 1] : 0.f;
      pz[p] = r < tn ? scene[3 * row + 2] : 0.f;
      best[p] = inf;
      bw[p] = inf;
    }

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


}  // namespace

// offsets: ni + 2 ints of scratch; keys: n 64-bit words of scratch.
ICP_EXPORT int nn_grid_launch(const int* cand, const int* counts, int ni, int cap,
                              const float* scene, int tn, int nj, int tm,
                              const float4* tiles, const int* kd_row, const float4* payload,
                              int* offsets, unsigned long long* keys,
                              float* d2_out, int* idx_out, float* y_out,
                              float4* pl_out, cudaStream_t stream) {
  if (tn < 1 || ni < 1 || tm % kStageRows != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = ((tn + kPoints - 1) / kPoints + 31) / 32 * 32;
  if (threads > kMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  const int n = ni * tn;
  cudaError_t e = cudaMemsetAsync(keys, 0xff, sizeof(unsigned long long) * n, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  nn_grid_plan_kernel<<<1, 1024, 0, stream>>>(counts, ni, cap, nj, offsets);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  // persistent: as many blocks as the SMs hold, at most one an item
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, nn_grid_fold_kernel, threads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long max_items = static_cast<long long>(ni) * nj;
  const long long resident = static_cast<long long>(sms) * max(per_sm, 1);
  nn_grid_fold_kernel<<<static_cast<int>(max_items < resident ? max_items : resident), threads, 0,
                        stream>>>(cand, counts, ni, cap, scene, tn, nj, tm, tiles, offsets, keys);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  nn_grid_epilogue_kernel<<<(n + 255) / 256, 256, 0, stream>>>(keys, n, kd_row, tiles, payload,
                                                               d2_out, idx_out, y_out, pl_out);
  return static_cast<int>(cudaGetLastError());
}
