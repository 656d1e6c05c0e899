// K8: lane-chunked exact nearest neighbour — for every scene point the model
// index of the least squared distance, ties to the lowest index; indices
// only.
//
// Replaces icp_tpu/kernels/nn_pallas.py:49 _nn_kernel_chunked (reached
// through the pallas_call at nn_pallas.py:244 with distance_impl="chunked").
//
// What bounds it on the H100: float32 arithmetic, as K1 — 3 subtractions, 3
// multiplications, 2 additions and a compare per (scene, model) pair; the
// bytes are N*12 + M*12 in and N*4 out.  The TPU kernel splits the model
// axis over 128 vector lanes, keeps a per-lane (best, chunk) carry in
// registers and does one cross-lane lowest-index argmin at the end.  The
// Hopper form of that idea splits the model axis over the 32 lanes of a
// warp: a block stages model tiles in shared memory as float4 (as K1 does),
// each warp holds kPoints scene points in registers, and lane l folds model
// rows base+l, base+l+32, ... with strict <, so each lane keeps the lowest
// index of its own minimum.  Five __shfl_xor_sync steps then reduce the 32
// (d, idx) pairs by the lexicographic rule (smaller d, or equal d and
// smaller idx).  Where K1 gives one thread to a scene point (cow's 2,903
// points fill 12 blocks of 256), this puts a warp on kPoints of them.
// Distances are sqdist_rn under --fmad=false, so the indices equal K1's and
// the plain version's bit for bit.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPoints = 4;  // scene points per warp
constexpr int kTile = 1024;

__global__ void __launch_bounds__(kThreads)
nn_chunked_kernel(const float* __restrict__ scene, int n, const float* __restrict__ model,
                  int m, int* __restrict__ idx_out) {
  __shared__ float4 tile[kTile];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int first = (blockIdx.x * kWarps + warp) * kPoints;
  float px[kPoints], py[kPoints], pz[kPoints], best[kPoints];
  int best_i[kPoints];
#pragma unroll
  for (int q = 0; q < kPoints; ++q) {
    const int i = first + q;
    px[q] = i < n ? scene[3 * i] : 0.f;
    py[q] = i < n ? scene[3 * i + 1] : 0.f;
    pz[q] = i < n ? scene[3 * i + 2] : 0.f;
    best[q] = __int_as_float(0x7f800000);  // +inf
    best_i[q] = INT_MAX;
  }
  for (int base = 0; base < m; base += kTile) {
    const int cnt = min(kTile, m - base);
    for (int k = threadIdx.x; k < cnt; k += kThreads) {
      const float* r = model + 3 * (base + k);
      tile[k] = make_float4(r[0], r[1], r[2], 0.f);
    }
    __syncthreads();
    for (int k = lane; k < cnt; k += 32) {
      const float4 row = tile[k];
#pragma unroll
      for (int q = 0; q < kPoints; ++q) {
        const float d = sqdist_rn(px[q], py[q], pz[q], row);
        if (d < best[q]) {
          best[q] = d;
          best_i[q] = base + k;
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < kPoints; ++q) {
    float d = best[q];
    int i = best_i[q];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, d, off);
      const int oi = __shfl_xor_sync(0xffffffffu, i, off);
      if (od < d || (od == d && oi < i)) {
        d = od;
        i = oi;
      }
    }
    // no finite distance anywhere: index 0, as K1's untouched carry
    if (lane == q && first + q < n) idx_out[first + q] = i == INT_MAX ? 0 : i;
  }
}

}  // namespace

ICP_EXPORT int nn_chunked_launch(const float* scene, int n, const float* model, int m,
                                 int* idx_out, cudaStream_t stream) {
  const int per_block = kWarps * kPoints;
  const int blocks = (n + per_block - 1) / per_block;
  nn_chunked_kernel<<<blocks, kThreads, 0, stream>>>(scene, n, model, m, idx_out);
  return static_cast<int>(cudaGetLastError());
}
