// K9: bf16-prefiltered nearest neighbour — for every scene point the argmin
// of the approximate distance d~ = |m|^2 - 2 fl16(p).fl16(m), the second
// order statistic of d~, and the exact float32 distance to the winner.
//
// Replaces icp_tpu/kernels/nn_bf16.py:60 _nn_bf16_kernel (the pallas_call
// at nn_bf16.py:175, via closest_point_indices_bf16).
//
// The function does not depend on the TPU kernel's tiles: best is the
// minimum of d~ and idx the lowest index reaching it; second is the second
// order statistic counted with multiplicity (a duplicate of the best value
// gives second == best); d_exact is the diff-squares float32 distance from
// the scene point to model[idx].  The certificate second - best > 2B is
// computed after the kernel, in torch.
//
// What bounds it on the H100: float32 arithmetic — per (scene, model) pair
// 3 multiplications and 2 additions of the cross term, a doubling and a
// subtraction, and two compares (8 counted operations, as K1); the bytes are
// N*12 + M*12 in and N*16 out.  The design is K1's: one thread per scene
// point, held in registers (its coordinates rounded to bf16 and widened
// back); the model staged through shared memory as float4 tiles of
// (bf16-rounded x, y, z, exact norm (x*x + y*y) + z*z) and read by every
// thread of the block as a broadcast.  Products of two bf16 values are exact
// in float32, so the cross term (pbx*mbx + pby*mby) + pbz*mbz differs from a
// tensor-core product only in the rounding of its two additions; all of it
// is written with _rn intrinsics (no contraction), so the outputs equal the
// plain version's bit for bit.  The carry is
//   d < best:        second = best, best = d, idx = j
//   else d < second: second = d
// in ascending j.  The winner's exact row is read once after the fold, as
// K4 reads its payload.  Tensor cores (mma/wgmma on bf16, K padded to 16)
// are the later redesign.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__global__ void __launch_bounds__(kThreads)
nn_bf16_kernel(const float* __restrict__ scene, int n, const float* __restrict__ model, int m,
               int* __restrict__ idx_out, float* __restrict__ best_out,
               float* __restrict__ second_out, float* __restrict__ dex_out) {
  __shared__ float4 tile[kTile];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool valid = i < n;
  float px = 0.f, py = 0.f, pz = 0.f;
  if (valid) {
    px = scene[3 * i];
    py = scene[3 * i + 1];
    pz = scene[3 * i + 2];
  }
  const float bx = bf16_round(px), by = bf16_round(py), bz = bf16_round(pz);
  const float inf = __int_as_float(0x7f800000);
  float best = inf, second = inf;
  int best_i = 0;
  for (int base = 0; base < m; base += kTile) {
    const int cnt = min(kTile, m - base);
    for (int k = threadIdx.x; k < cnt; k += kThreads) {
      const float* r = model + 3 * (base + k);
      const float norm = __fadd_rn(__fadd_rn(__fmul_rn(r[0], r[0]), __fmul_rn(r[1], r[1])),
                                   __fmul_rn(r[2], r[2]));
      tile[k] = make_float4(bf16_round(r[0]), bf16_round(r[1]), bf16_round(r[2]), norm);
    }
    __syncthreads();
    if (valid) {
      for (int k = 0; k < cnt; ++k) {
        const float4 q = tile[k];
        const float cross = __fadd_rn(__fadd_rn(__fmul_rn(bx, q.x), __fmul_rn(by, q.y)),
                                      __fmul_rn(bz, q.z));
        const float d = __fsub_rn(q.w, __fmul_rn(2.f, cross));
        if (d < best) {
          second = best;
          best = d;
          best_i = base + k;
        } else if (d < second) {
          second = d;
        }
      }
    }
    __syncthreads();
  }
  if (valid) {
    const float* r = model + 3 * best_i;
    idx_out[i] = best_i;
    best_out[i] = best;
    second_out[i] = second;
    dex_out[i] = sqdist_rn(px, py, pz, make_float4(r[0], r[1], r[2], 0.f));
  }
}

}  // namespace

ICP_EXPORT int nn_bf16_launch(const float* scene, int n, const float* model, int m,
                              int* idx_out, float* best_out, float* second_out,
                              float* dex_out, cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  nn_bf16_kernel<<<blocks, kThreads, 0, stream>>>(scene, n, model, m, idx_out, best_out,
                                                  second_out, dex_out);
  return static_cast<int>(cudaGetLastError());
}
