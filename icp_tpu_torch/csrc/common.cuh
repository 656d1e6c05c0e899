// Shared device helpers of the ICP kernels.
//
// Every float32 distance is written with explicit round-to-nearest
// intrinsics, so no multiply-add contraction can make a kernel's distance
// differ from its plain PyTorch version's (the library is built with
// --fmad=false besides).  Equal distances then pick equal winners, and
// kernel and plain indices can be compared exactly.
#pragma once

#include <cuda_runtime.h>

#define ICP_EXPORT extern "C" __attribute__((visibility("default")))

// Sentinel of the grid kernel's carry (icp_tpu/kernels/nn_grid.py _BIG).
#define ICP_BIG 3.0e38f

// Diff-squares distance (dx*dx + dy*dy) + dz*dz, the order of
// icp_tpu/kernels/nn_pallas.py _nn_kernel and nn_grid.py _pruned_kernel.
__device__ __forceinline__ float sqdist_rn(float px, float py, float pz,
                                           float4 q) {
  const float dx = __fsub_rn(px, q.x);
  const float dy = __fsub_rn(py, q.y);
  const float dz = __fsub_rn(pz, q.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Expansion form ((|m|^2 + px*m2x) + py*m2y) + pz*m2z against pre-scaled
// q = (-2mx, -2my, -2mz, |m|^2), the order of icp_fused.py _fold_chunk.
__device__ __forceinline__ float expdist_rn(float px, float py, float pz,
                                            float4 q) {
  return __fadd_rn(
      __fadd_rn(__fadd_rn(q.w, __fmul_rn(px, q.x)), __fmul_rn(py, q.y)),
      __fmul_rn(pz, q.z));
}

// The k-best list of one thread for the kd-tile kNN kernel (K7): K slots in
// registers, ascending by (d, i), of which the first k (k <= K, a run-time
// value) are live.  `kd`/`ki` mirror slot k-1, so the caller's test "does
// (d, i) beat the k-th best" needs no run-time index into the list.
template <int K, typename I>
struct TopK {
  float d[K];
  I i[K];
  float kd;
  I ki;

  __device__ __forceinline__ void init(float big_d, I big_i) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      d[j] = big_d;
      i[j] = big_i;
    }
    kd = big_d;
    ki = big_i;
  }

  __device__ __forceinline__ bool beats_kth(float dc, I ic) const {
    return dc < kd || (dc == kd && ic < ki);
  }

  // Insert (dc, ic), which beats slot k-1: a fully unrolled compare-and-swap
  // chain over the live slots (a run-time index into d[] or i[] would put
  // the list in local memory).  The candidate sinks to its place and every
  // later live entry moves down one slot; slot k-1's entry drops out.
  __device__ __forceinline__ void insert(float dc, I ic, int k) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const bool lt = j < k && (dc < d[j] || (dc == d[j] && ic < i[j]));
      const float td = lt ? d[j] : dc;
      const I ti = lt ? i[j] : ic;
      d[j] = lt ? dc : d[j];
      i[j] = lt ? ic : i[j];
      dc = td;
      ic = ti;
      if (j == k - 1) {
        kd = d[j];
        ki = i[j];
      }
    }
  }
};

// Deterministic block sum of K doubles per thread: a warp-shuffle tree,
// then the warps' sums added in warp order by thread k.  No atomics, so a
// run repeats bit for bit.  `scratch` holds (blockDim.x / 32) * K doubles;
// the result lands in out[0..K) (written by threads 0..K-1).
template <int K>
__device__ void block_sum(double (&v)[K], double* scratch, double* out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    double x = v[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) scratch[warp * K + k] = x;
  }
  __syncthreads();
  if (threadIdx.x < K) {
    double acc = 0.0;
    for (int w = 0; w < n_warps; ++w) acc += scratch[w * K + threadIdx.x];
    out[threadIdx.x] = acc;
  }
}
