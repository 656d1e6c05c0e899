// K2: the scalar alignment step — Horn/QCP solve, composition, closed-form
// residual and the ICP loop's convergence test, on one warp.
// K5: the rotation-only solve of the same device function.
//
// K2 replaces icp_tpu/kernels/qcp_pallas.py:122 _alignment_step_kernel
// (with its shared scalar math alignment_update_scalars :47 and
// _qcp_rotation_scalar :143).
// K5 replaces icp_tpu/kernels/qcp_pallas.py:32 _qcp_kernel (via
// horn_rotation_pallas): (1, 16) slots [S (9, row major), gp, gy, 0...] in,
// [R (9, row major), q (4), lambda, 0, 0] out, the JAX kernel's layout.  It
// solves in float64 (the JAX kernel in float32), like K2.
//
// What bounds it on the H100: latency.  The work is ~600 float64 scalar
// operations on 18 input sums (and a column sum of the partial rows) — no
// memory traffic worth counting.  The design keeps the iteration's scalar
// work in one launch instead of hundreds of tiny tensor ops, and it never
// leaves the card: the kernel also writes errs[it], advances the iteration
// counter and raises the done flag, so the host reads the flag once per
// chunk of iterations, not the error every iteration.  The step runs on
// one warp (qcp_warp.cuh): the serial chains (Newton, the normalisations)
// on every lane alike, the independent pieces (the column sums, the terms
// of c0, the 16 cofactors, the column norms, the rows of each power step
// and the 32 output slots) spread over the lanes.  The fused dense
// iteration (icp_fused.cu) runs the same device function in its last
// block, so on that path K2 has no launch of its own; this launch serves
// the pipeline and grid paths (one row from pack_stats).  K5 is bound the
// same way (~500 dependent float64 operations on 11 inputs): the rotation
// solve of an ICP step that computes its own error (solver "qcp_fused"
// with the bcast or matmul NN) is one launch, read by the torch ops that
// follow it on the stream, with no host read.  It runs K2's warp solve
// (qcp_rotation_warp): the earlier one-thread kernel of the same
// operations took the same 3.15 us on the H100 (scripts/kernel_ab.py, in
// turns), so the solve has one copy.  The cost of the step is on the
// host, and its entry qcp_rotation_from takes S, gp and gy as the caller
// holds them (float32 or float64, widened in registers) and writes R back
// in their type, so the caller packs, casts and slices nothing on the host
// (kernels/qcp.py).
//
// The pair axis (the counterpart of JAX's vmap over the pallas_call): a
// launch is one warp a pair, <<<B, 32>>>, each warp offsetting its inputs
// and outputs by its pair (K2: the (B, rows, 18) partials, the (B, 32)
// states, the (B, 4) controls and the (B, errs_len) error buffers; K5: the
// (B, 3, 3) S, the (B,) gp and gy, the (B, 16) blocks and the (B, 3, 3) R),
// so each pair's warp runs the single-pair solve on its own slots and the
// single-pair entry points are the B = 1 launch.
//
// Numerics: float64 throughout.  The JAX kernel is float32, and its
// closed-form residual gy + s^2 gp - 2 s lambda cancels to noise near
// convergence (gp ~ gy ~ 8.4e3 against a residual of ~2e-2 on cow); in
// float64 it matches the reference binary's trace.  The operation order is
// the plain version's (kernels/qcp.py), and the library is built with
// --fmad=false, so the two agree to the last bits.
//
// Loop control ctl (int32): [0] iterations done, [1] done flag, [2] bound,
// [3] guard status.  The flag rises at the bound and, when `converge` is
// set (icp), also when !(err >= threshold), so a NaN error stops the loop;
// with `converge` 0 (icp_fixed_iters, JAX's fori_loop) only the bound
// raises it.  With `guard` set (icp(guard="device"), JAX's
// _icp_while_guarded) a non-finite error (status 1) or one above 100 times
// the least so far (status 2, the least kept in state slot 28) raises it
// too and writes the status; unguarded launches are as before.  Once done
// is set the kernel writes the identity step and returns, so a later apply
// of the step is an exact no-op.
#include "qcp_warp.cuh"

namespace {

using qcp_warp::StepArgs;

constexpr int kStateSlots = 32;
constexpr int kCtlSlots = 4;
constexpr int kRotSlots = 16;
constexpr int kMaxPairs = 1 << 30;

// K2: one warp a pair (blockIdx.x).
__global__ void __launch_bounds__(32)
qcp_step_kernel(const double* __restrict__ partials, int n_rows, double* state, int* ctl,
                double* errs, int errs_len, StepArgs args) {
  __shared__ double sm[qcp_warp::kWarpScratch];
  const long long pair = blockIdx.x;
  qcp_warp::qcp_step_warp(partials + pair * n_rows * qcp_warp::kSums, n_rows,
                          state + pair * kStateSlots, ctl + pair * kCtlSlots,
                          errs + pair * errs_len, args, sm);
}

// K5: one warp a pair (blockIdx.x).  S (3 x 3, row major), gp and gy in T
// (float or double), widened to double exactly; out: the (1, 16) float64
// block [R, q, lambda, 0, 0]; r_out, when given: R again in T (the
// conversion rounds to nearest, as .to(float32)).  in_stride: the T slots
// from one pair's S to the next's (9; the packed entry's blocks, 16), gp
// and gy likewise.
template <typename T>
__global__ void __launch_bounds__(32)
qcp_rotation_kernel(const T* __restrict__ S_in, const T* __restrict__ gp,
                    const T* __restrict__ gy, int in_stride, int g_stride,
                    double* __restrict__ out, T* __restrict__ r_out) {
  __shared__ double sm[qcp_warp::kWarpScratch];
  const long long pair = blockIdx.x;
  S_in += pair * in_stride;
  gp += pair * g_stride;
  gy += pair * g_stride;
  out += pair * kRotSlots;
  if (r_out) r_out += pair * 9;
  double S[9], R[9], q[4], lam;
#pragma unroll
  for (int k = 0; k < 9; ++k) S[k] = static_cast<double>(S_in[k]);
  qcp_warp::qcp_rotation_warp(S, static_cast<double>(*gp), static_cast<double>(*gy), sm, R, q,
                              &lam);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) out[k] = R[k];
#pragma unroll
    for (int k = 0; k < 4; ++k) out[9 + k] = q[k];
    out[13] = lam;
    out[14] = 0.0;
    out[15] = 0.0;
    if (r_out) {
#pragma unroll
      for (int k = 0; k < 9; ++k) r_out[k] = static_cast<T>(R[k]);
    }
  }
}

bool valid(int pairs) { return pairs >= 1 && pairs <= kMaxPairs; }

}  // namespace

// K5 on the JAX kernel's (1, 16) slots: `pairs` blocks [S (9), gp, gy,
// 0...] in, as many out.
ICP_EXPORT int qcp_rotation_launch(const double* in, int pairs, double* out,
                                   cudaStream_t stream) {
  if (!valid(pairs)) return static_cast<int>(cudaErrorInvalidValue);
  qcp_rotation_kernel<double><<<pairs, 32, 0, stream>>>(in, in + 9, in + 10, kRotSlots,
                                                        kRotSlots, out, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// K5 from `pairs` S (3 x 3), gp and gy as the caller holds them: float64
// (f64 != 0) or float32; r_out (`pairs` R in that type) may be null.
ICP_EXPORT int qcp_rotation_from_launch(const void* S, const void* gp, const void* gy, int f64,
                                        int pairs, double* out, void* r_out,
                                        cudaStream_t stream) {
  if (!valid(pairs)) return static_cast<int>(cudaErrorInvalidValue);
  if (f64)
    qcp_rotation_kernel<double><<<pairs, 32, 0, stream>>>(
        static_cast<const double*>(S), static_cast<const double*>(gp),
        static_cast<const double*>(gy), 9, 1, out, static_cast<double*>(r_out));
  else
    qcp_rotation_kernel<float><<<pairs, 32, 0, stream>>>(
        static_cast<const float*>(S), static_cast<const float*>(gp),
        static_cast<const float*>(gy), 9, 1, out, static_cast<float*>(r_out));
  return static_cast<int>(cudaGetLastError());
}

// K2 on `pairs` pairs: partials (pairs, n_rows, 18), state (pairs, 32), ctl
// (pairs, 4), errs (pairs, errs_len).
ICP_EXPORT int qcp_step_launch(const double* partials, int pairs, int n_rows, double* state,
                               int* ctl, double* errs, int errs_len, int with_scale,
                               double threshold, double err_factor, int converge, int guard,
                               cudaStream_t stream) {
  if (!valid(pairs) || n_rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const StepArgs args{with_scale, threshold, err_factor, converge, guard};
  qcp_step_kernel<<<pairs, 32, 0, stream>>>(partials, n_rows, state, ctl, errs, errs_len, args);
  return static_cast<int>(cudaGetLastError());
}
