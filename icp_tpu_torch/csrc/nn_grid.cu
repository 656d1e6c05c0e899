// K4: kd-tile work-list nearest neighbour — each scene tile folds only the
// model tiles that can hold a nearest neighbour of one of its points.
//
// Replaces icp_tpu/kernels/nn_grid.py:240 _pruned_kernel.
//
// What bounds it on the H100: the distance fold over the candidate tiles
// (horse: 256 scene tiles x ~3-10 candidates x 768 rows x 192 points), the
// same 8 float32 operations per pair as K1, plus one shared-memory load of
// each candidate tile per block.  The design: one block per scene tile and
// one thread per point; the block loads its own candidate list (the JAX
// kernel's scalar prefetch), stages each candidate tile of (x, y, z,
// original index) float4 rows in shared memory with a plain synchronous
// load (double buffering is later work), and every thread folds it.  A
// tile whose candidate count passes the table's capacity folds all tiles
// (the per-tile fallback: exact, and only that tile pays).  Ties go to the
// lowest ORIGINAL model index: d < best || (d == best && idx < best_idx),
// as nn_grid.py:320-323.  Outputs: d2, index and the matched point.
//
// The payload slot (nn_grid.py:432-472, the point-to-plane engine's
// normals): the JAX kernel carries the payload sublanes of the winning lane
// through its fold.  Here each thread tracks its winner's kd row, and after
// the fold reads that one 16-byte row of the kd-ordered (Nj * tm) float4
// payload from device memory: one extra load per point, no second shared
// tile and no payload work inside the fold.  A null payload pointer means
// no payload (the point-to-point engines).
#include "common.cuh"

namespace {

__global__ void nn_grid_kernel(const int* __restrict__ cand, const int* __restrict__ counts,
                               int cap, const float* __restrict__ scene, int tn, int nj,
                               int tm, const float4* __restrict__ tiles,
                               const float4* __restrict__ payload,
                               float* __restrict__ d2_out, int* __restrict__ idx_out,
                               float* __restrict__ y_out, float4* __restrict__ pl_out) {
  extern __shared__ float4 tile[];
  const int ti = blockIdx.x;
  const int r = threadIdx.x;
  const bool valid = r < tn;
  const int row = ti * tn + r;
  float px = 0.f, py = 0.f, pz = 0.f;
  if (valid) {
    px = scene[3 * row];
    py = scene[3 * row + 1];
    pz = scene[3 * row + 2];
  }
  const int cnt_raw = counts[ti];
  const bool use_all = cnt_raw > cap;
  const int cnt = use_all ? nj : max(cnt_raw, 1);

  float best = ICP_BIG, best_i = ICP_BIG;
  float bx = 0.f, by = 0.f, bz = 0.f;
  long long best_row = 0;  // kd row of the winner (payload lookup)
  for (int c = 0; c < cnt; ++c) {
    const int j = use_all ? c : cand[ti * cap + min(c, cap - 1)];
    const float4* src = tiles + static_cast<long long>(j) * tm;
    for (int k = threadIdx.x; k < tm; k += blockDim.x) tile[k] = src[k];
    __syncthreads();
    if (valid) {
      for (int k = 0; k < tm; ++k) {
        const float4 q = tile[k];
        const float d = sqdist_rn(px, py, pz, q);
        if (d < best || (d == best && q.w < best_i)) {
          best = d;
          best_i = q.w;
          bx = q.x;
          by = q.y;
          bz = q.z;
          best_row = static_cast<long long>(j) * tm + k;
        }
      }
    }
    __syncthreads();
  }
  if (valid) {
    d2_out[row] = best;
    // original indices are exact float32 integers below 2^24
    idx_out[row] = best_i < 16777216.f ? static_cast<int>(best_i) : -1;
    y_out[3 * row] = bx;
    y_out[3 * row + 1] = by;
    y_out[3 * row + 2] = bz;
    if (payload) pl_out[row] = payload[best_row];
  }
}

}  // namespace

ICP_EXPORT int nn_grid_launch(const int* cand, const int* counts, int ni, int cap,
                              const float* scene, int tn, int nj, int tm,
                              const float4* tiles, const float4* payload,
                              float* d2_out, int* idx_out, float* y_out,
                              float4* pl_out, cudaStream_t stream) {
  if (tn > 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = (tn + 31) / 32 * 32;
  const size_t smem = static_cast<size_t>(tm) * sizeof(float4);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nn_grid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  nn_grid_kernel<<<ni, threads, smem, stream>>>(cand, counts, cap, scene, tn, nj, tm, tiles,
                                                payload, d2_out, idx_out, y_out, pl_out);
  return static_cast<int>(cudaGetLastError());
}
