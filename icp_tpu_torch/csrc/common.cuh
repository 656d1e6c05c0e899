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

// |m|^2 = (x*x + y*y) + z*z, the norm of the "mxu" form below.
__device__ __forceinline__ float norm3_rn(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// Expansion form |m|^2 - 2 p.m against q = (mx, my, mz, |m|^2), with
// p.m = (px*mx + py*my) + pz*mz: the distance of nn_pallas.py _nn_kernel's
// distance_impl "mxu" (its |p|^2 is added back after the argmin).  2 p.m is
// exact, so this rounds as |m|^2 - 2 * p.m in plain float32 arithmetic.
__device__ __forceinline__ float mxudist_rn(float px, float py, float pz, float4 q) {
  const float c = __fadd_rn(__fadd_rn(__fmul_rn(px, q.x), __fmul_rn(py, q.y)),
                            __fmul_rn(pz, q.z));
  return __fsub_rn(q.w, __fmul_rn(2.f, c));
}

// A float's bits mapped so that unsigned integer order is float order,
// negative values included (-0 sorts just below +0; no distance here is
// -0), and its inverse.  +inf maps to 0xff800000, below every NaN and below
// the all-ones word the merge keys use for "empty".
__device__ __forceinline__ unsigned ordered_bits(float f) {
  const unsigned u = __float_as_uint(f);
  return u ^ ((u >> 31) ? 0xffffffffu : 0x80000000u);
}

__device__ __forceinline__ float from_ordered_bits(unsigned u) {
  return __uint_as_float(u ^ ((u >> 31) ? 0x80000000u : 0xffffffffu));
}

// cp.async: a copy from device memory to shared memory that the issuing
// thread does not wait for; commit closes a group of copies, and
// wait<N> returns once at most N of this thread's groups are in flight.
// The 16-byte form needs both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

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
