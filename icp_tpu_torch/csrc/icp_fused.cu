// K3: one whole dense ICP iteration up to the alignment sums — apply the
// cumulative similarity, exact nearest neighbour in expansion form, and the
// Horn sufficient statistics, reduced per block.
//
// Replaces icp_tpu/kernels/icp_fused.py:128 _icp_iter_kernel.  The solve
// and composition it ran on its last grid step are K2 (qcp.cu), launched
// right after this kernel on the same stream, which reduces this kernel's
// per-block partial sums in block order.
//
// What bounds it on the H100: the N x M distance fold — 4 float32
// operations and a compare per pair (cow: 2,903^2 = 8.4 M pairs an
// iteration), a few microseconds of the card's float32 rate, so at cow size
// the launch and the tail of 23 blocks dominate.  The design: one thread
// per scene point, which applies the transform in registers (the moved
// cloud is never written); the model, pre-scaled to (-2m, |m|^2) float4
// rows, is staged through shared memory a tile at a time and read by all
// threads of the block as a broadcast; each thread carries (best distance,
// winning pre-scaled coordinates) and un-scales them by -0.5 (exact).  The
// 17 sums are taken in float64 and reduced by block_sum in a fixed order —
// no float atomics — so a run repeats bit for bit.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;  // model rows per shared-memory tile (16 KB)
constexpr int kSums = 18;    // 17 Horn sums + the row count

__global__ void __launch_bounds__(kThreads)
icp_fused_kernel(const float* __restrict__ p0, int n, const float4* __restrict__ mt,
                 int m, const double* __restrict__ state, const int* __restrict__ ctl,
                 double* __restrict__ partials) {
  __shared__ float4 tile[kTile];
  __shared__ double scratch[(kThreads / 32) * kSums];
  if (ctl[1]) return;  // converged: K2 writes the identity step

  // Cumulative transform, cast to float32 as the plain version does.
  const float s = static_cast<float>(state[13]);
  float R[9], t[3];
  for (int k = 0; k < 9; ++k) R[k] = static_cast<float>(state[14 + k]);
  for (int k = 0; k < 3; ++k) t[k] = static_cast<float>(state[23 + k]);

  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool valid = i < n;
  float x = 0.f, y = 0.f, z = 0.f;
  if (valid) {
    x = p0[3 * i];
    y = p0[3 * i + 1];
    z = p0[3 * i + 2];
  }
  float p[3];
  for (int r = 0; r < 3; ++r) {
    const float rp = __fadd_rn(__fadd_rn(__fmul_rn(R[3 * r], x), __fmul_rn(R[3 * r + 1], y)),
                               __fmul_rn(R[3 * r + 2], z));
    p[r] = __fadd_rn(__fmul_rn(s, rp), t[r]);
  }

  float best = __int_as_float(0x7f800000);  // +inf
  float bx = 0.f, by = 0.f, bz = 0.f;
  for (int base = 0; base < m; base += kTile) {
    const int cnt = min(kTile, m - base);
    for (int k = threadIdx.x; k < cnt; k += kThreads) tile[k] = mt[base + k];
    __syncthreads();
    if (valid) {
      for (int k = 0; k < cnt; ++k) {
        const float4 q = tile[k];
        const float d = expdist_rn(p[0], p[1], p[2], q);
        if (d < best) {  // strict <: the lowest model index keeps a tie
          best = d;
          bx = q.x;
          by = q.y;
          bz = q.z;
        }
      }
    }
    __syncthreads();
  }

  double v[kSums];
  const double P[3] = {p[0], p[1], p[2]};
  const double Y[3] = {-0.5f * bx, -0.5f * by, -0.5f * bz};
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) v[3 * r + c] = P[r] * Y[c];
  for (int k = 0; k < 3; ++k) {
    v[9 + k] = P[k];
    v[12 + k] = Y[k];
  }
  v[15] = P[0] * P[0] + P[1] * P[1] + P[2] * P[2];
  v[16] = Y[0] * Y[0] + Y[1] * Y[1] + Y[2] * Y[2];
  v[17] = 1.0;
  if (!valid)
    for (int k = 0; k < kSums; ++k) v[k] = 0.0;
  block_sum<kSums>(v, scratch, partials + blockIdx.x * kSums);
}

}  // namespace

ICP_EXPORT int icp_fused_blocks(int n) { return (n + kThreads - 1) / kThreads; }

ICP_EXPORT int icp_fused_launch(const float* p0, int n, const float4* mt, int m,
                                const double* state, const int* ctl,
                                double* partials, cudaStream_t stream) {
  icp_fused_kernel<<<icp_fused_blocks(n), kThreads, 0, stream>>>(p0, n, mt, m, state,
                                                                 ctl, partials);
  return static_cast<int>(cudaGetLastError());
}
