// K1: dense exact nearest neighbour — for every scene point the model index
// of the least squared distance, ties to the lowest index.
//
// Replaces icp_tpu/kernels/nn_pallas.py:99 _nn_kernel (the distance_impl
// "vpu" form its entry points use by default).
//
// What bounds it on the H100: float32 arithmetic — 3 subtractions, 3
// multiplications, 2 additions and a compare per (scene, model) pair; the
// bytes are N*12 + M*12 read once per block.  The design: one thread per
// scene point, held in registers; the model is staged through shared memory
// as float4 tiles of 1,024 rows and read by every thread of the block as a
// broadcast, so device memory sees each model row once per block.  The fold
// is strict < in ascending model order, which keeps the lowest index of a
// tie as the JAX kernel's masked index-min does; padding is not needed
// because the tile loop stops at the true model size.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;

__global__ void __launch_bounds__(kThreads)
nn_dense_kernel(const float* __restrict__ scene, int n, const float* __restrict__ model,
                int m, int* __restrict__ idx_out, float* __restrict__ d2_out) {
  __shared__ float4 tile[kTile];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool valid = i < n;
  float px = 0.f, py = 0.f, pz = 0.f;
  if (valid) {
    px = scene[3 * i];
    py = scene[3 * i + 1];
    pz = scene[3 * i + 2];
  }
  float best = __int_as_float(0x7f800000);  // +inf
  int best_i = 0;
  for (int base = 0; base < m; base += kTile) {
    const int cnt = min(kTile, m - base);
    for (int k = threadIdx.x; k < cnt; k += kThreads) {
      const float* r = model + 3 * (base + k);
      tile[k] = make_float4(r[0], r[1], r[2], 0.f);
    }
    __syncthreads();
    if (valid) {
      for (int k = 0; k < cnt; ++k) {
        const float d = sqdist_rn(px, py, pz, tile[k]);
        if (d < best) {
          best = d;
          best_i = base + k;
        }
      }
    }
    __syncthreads();
  }
  if (valid) {
    idx_out[i] = best_i;
    if (d2_out) d2_out[i] = best;
  }
}

}  // namespace

ICP_EXPORT int nn_dense_launch(const float* scene, int n, const float* model, int m,
                               int* idx_out, float* d2_out, cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  nn_dense_kernel<<<blocks, kThreads, 0, stream>>>(scene, n, model, m, idx_out, d2_out);
  return static_cast<int>(cudaGetLastError());
}
