// K7: kd-tile work-list exact k nearest neighbours — each query tile folds
// only the point tiles that can hold one of its points' k nearest.
//
// Replaces icp_tpu/kernels/knn_grid.py:53 _knn_worklist_kernel (via
// _run_worklist and knn_grid, :115-219), the neighbour search of the normal
// estimation from 16,384 points.  The torch side (kernels/knn_grid.py)
// launches it twice: the seed pass over each tile's nearest boxes, then the
// exact pass over the culled candidates.
//
// What bounds it on the H100: float32 arithmetic over the candidate tiles
// (horse: 1,024 query tiles of 48 points x a few candidate tiles of 256
// rows), 8 operations and one compare per pair, plus one shared-memory load
// of each candidate tile per block.  The design is K4's: one block per query
// tile and one thread per point; the block reads its own candidate row
// (the JAX kernel's scalar prefetch) and stages each candidate tile of
// (x, y, z, original index) float4 rows in shared memory with a plain
// synchronous load (double buffering is later work).  Each thread keeps its
// k best (d2, original index) pairs in registers (TopK in
// common.cuh, compile-time length K in {4, 16, 24, 32}).  The kd order is
// not index order, so both the test against the k-th best and the insertion
// chain compare (d2, original index) lexicographically, with the index read
// from the float4's w lane (an exact float32 integer below 2^24; padding
// rows carry 3e38 and sit ~3e34 away).  A tile whose candidate count passes
// the table's capacity folds all tiles (the per-tile fallback: exact, and
// only that tile pays).  With the default 64-point query tiles a block has
// 64 threads (48 on horse): low occupancy, accepted here and measured.
#include <climits>

#include "common.cuh"

namespace {

template <int K>
__global__ void knn_grid_kernel(const int* __restrict__ cand, const int* __restrict__ counts,
                                int cap, const float* __restrict__ query, int tn, int nj,
                                int tm, const float4* __restrict__ tiles, int k,
                                float* __restrict__ d2_out, int* __restrict__ idx_out) {
  extern __shared__ float4 tile[];
  const int ti = blockIdx.x;
  const int r = threadIdx.x;
  const bool valid = r < tn;
  const int row = ti * tn + r;
  float px = 0.f, py = 0.f, pz = 0.f;
  if (valid) {
    px = query[3 * row];
    py = query[3 * row + 1];
    pz = query[3 * row + 2];
  }
  const int cnt_raw = counts[ti];
  const bool use_all = cnt_raw > cap;
  const int cnt = use_all ? nj : max(cnt_raw, 1);

  TopK<K, float> best;
  best.init(ICP_BIG, ICP_BIG);
  for (int c = 0; c < cnt; ++c) {
    const int j = use_all ? c : cand[ti * cap + min(c, cap - 1)];
    const float4* src = tiles + static_cast<long long>(j) * tm;
    for (int q = threadIdx.x; q < tm; q += blockDim.x) tile[q] = src[q];
    __syncthreads();
    if (valid) {
      for (int q = 0; q < tm; ++q) {
        const float4 pt = tile[q];
        const float d = sqdist_rn(px, py, pz, pt);
        if (best.beats_kth(d, pt.w)) best.insert(d, pt.w, k);
      }
    }
    __syncthreads();
  }
  if (valid) {
    float* dst_d = d2_out + static_cast<long long>(row) * k;
    int* dst_i = idx_out + static_cast<long long>(row) * k;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (j < k) {
        dst_d[j] = best.d[j];
        dst_i[j] = best.i[j] < 16777216.f ? static_cast<int>(best.i[j]) : INT_MAX;
      }
    }
  }
}

template <int K>
int launch(const int* cand, const int* counts, int ni, int cap, const float* query, int tn,
           int nj, int tm, const float4* tiles, int k, float* d2_out, int* idx_out,
           cudaStream_t stream) {
  const int threads = (tn + 31) / 32 * 32;
  const size_t smem = static_cast<size_t>(tm) * sizeof(float4);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        knn_grid_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  knn_grid_kernel<K><<<ni, threads, smem, stream>>>(cand, counts, cap, query, tn, nj, tm, tiles,
                                                    k, d2_out, idx_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

ICP_EXPORT int knn_grid_launch(const int* cand, const int* counts, int ni, int cap,
                               const float* query, int tn, int nj, int tm,
                               const float4* tiles, int k, float* d2_out, int* idx_out,
                               cudaStream_t stream) {
  if (ni < 1 || tn > 1024 || k < 1 || k > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (k <= 4) return launch<4>(cand, counts, ni, cap, query, tn, nj, tm, tiles, k, d2_out,
                               idx_out, stream);
  if (k <= 16) return launch<16>(cand, counts, ni, cap, query, tn, nj, tm, tiles, k, d2_out,
                                 idx_out, stream);
  if (k <= 24) return launch<24>(cand, counts, ni, cap, query, tn, nj, tm, tiles, k, d2_out,
                                 idx_out, stream);
  return launch<32>(cand, counts, ni, cap, query, tn, nj, tm, tiles, k, d2_out, idx_out,
                    stream);
}
