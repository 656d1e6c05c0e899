// K2: the scalar alignment step — Horn/QCP solve, composition, closed-form
// residual and the ICP loop's convergence test, in one thread.
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
// What bounds it on the H100: latency.  The work is ~600 dependent float64
// scalar operations on 18 input sums — no memory traffic worth counting,
// and nothing to spread over threads.  The design keeps the whole chain in
// one thread of one block, so that the iteration's scalar work is one
// launch instead of hundreds of tiny tensor ops, and it never leaves the
// card: the kernel also writes errs[it], advances the iteration counter and
// raises the done flag, so the host reads the flag once per chunk of
// iterations, not the error every iteration.  K5 is bound the same way
// (~500 dependent float64 operations on 11 inputs) and takes the same
// design: the rotation solve of an ICP step that computes its own error
// (solver "qcp_fused" with the bcast or matmul NN) is one launch, read by
// the torch ops that follow it on the stream, with no host read.
//
// Numerics: float64 throughout.  The JAX kernel is float32, and its
// closed-form residual gy + s^2 gp - 2 s lambda cancels to noise near
// convergence (gp ~ gy ~ 8.4e3 against a residual of ~2e-2 on cow); in
// float64 it matches the reference binary's trace.  The operation order is
// the plain version's (kernels/qcp.py), and the library is built with
// --fmad=false, so the two agree to the last bits.
//
// Loop control ctl (int32): [0] iterations done, [1] done flag, [2] bound.
// The flag rises at the bound and, when `converge` is set (icp), also when
// !(err >= threshold), so a NaN error stops the loop; with `converge` 0
// (icp_fixed_iters, JAX's fori_loop) only the bound raises it.  Once done
// is set the kernel writes the identity step and returns, so a later apply
// of the step is an exact no-op.
#include "common.cuh"

namespace {

constexpr int kNewtonIters = 12;
constexpr int kPowerIters = 2;
constexpr int kSums = 18;

// max that lets a NaN in `a` through (as jnp.maximum does).
__device__ __forceinline__ double mx(double a, double b) { return a < b ? b : a; }

__device__ double minor3(const double M[4][4], int r0, int r1, int r2, int c0,
                         int c1, int c2) {
  return M[r0][c0] * (M[r1][c1] * M[r2][c2] - M[r1][c2] * M[r2][c1]) -
         M[r0][c1] * (M[r1][c0] * M[r2][c2] - M[r1][c2] * M[r2][c0]) +
         M[r0][c2] * (M[r1][c0] * M[r2][c1] - M[r1][c1] * M[r2][c0]);
}

// The three of {0,1,2,3} other than `skip`, ascending.
__device__ void others(int skip, int out[3]) {
  int k = 0;
  for (int x = 0; x < 4; ++x)
    if (x != skip) out[k++] = x;
}

// _qcp_rotation_scalar: rotation R, unit quaternion q (w, x, y, z) and the
// un-scaled lambda_max.
__device__ void qcp_rotation(double S[3][3], double gp, double gy,
                             double R[3][3], double q_out[4], double* lam_out) {
  const double total = mx(gp + gy, 1e-30);
  const double norm = 1.0 / total;
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) S[r][c] = S[r][c] * norm;
  gp = gp * norm;
  gy = gy * norm;
  const double S00 = S[0][0], S01 = S[0][1], S02 = S[0][2];
  const double S10 = S[1][0], S11 = S[1][1], S12 = S[1][2];
  const double S20 = S[2][0], S21 = S[2][1], S22 = S[2][2];
  const double tr = S00 + S11 + S22;
  const double A = S12 - S21, B = S20 - S02, C = S01 - S10;
  double N[4][4] = {
      {tr, A, B, C},
      {A, S00 - S11 - S22, S01 + S10, S02 + S20},
      {B, S01 + S10, S11 - S00 - S22, S12 + S21},
      {C, S02 + S20, S12 + S21, S22 - S00 - S11},
  };
  const double c2 = -2.0 * (S00 * S00 + S01 * S01 + S02 * S02 + S10 * S10 +
                            S11 * S11 + S12 * S12 + S20 * S20 + S21 * S21 +
                            S22 * S22);
  const double detS = S00 * (S11 * S22 - S12 * S21) -
                      S01 * (S10 * S22 - S12 * S20) +
                      S02 * (S10 * S21 - S11 * S20);
  const double c1 = -8.0 * detS;
  double c0 = 0.0;
  for (int j = 0; j < 4; ++j) {
    int cols[3];
    others(j, cols);
    const double sgn = (j % 2) ? -1.0 : 1.0;
    c0 = c0 + (sgn * N[0][j]) * minor3(N, 1, 2, 3, cols[0], cols[1], cols[2]);
  }
  double lam = sqrt(mx(gp * gy, 0.0));
  for (int it = 0; it < kNewtonIters; ++it) {
    const double p = ((lam * lam + c2) * lam + c1) * lam + c0;
    double dp = (4.0 * lam * lam + 2.0 * c2) * lam + c1;
    dp = fabs(dp) < 1e-30 ? 1.0 : dp;
    lam = lam - p / dp;
  }
  double M[4][4];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) M[i][j] = (i == j) ? N[i][j] - lam : N[i][j];
  double adj[4][4];
  for (int i = 0; i < 4; ++i) {
    int r[3];
    others(i, r);
    for (int j = 0; j < 4; ++j) {
      int c[3];
      others(j, c);
      const double sgn = ((i + j) % 2) ? -1.0 : 1.0;
      adj[j][i] = sgn * minor3(M, r[0], r[1], r[2], c[0], c[1], c[2]);
    }
  }
  double best = 0.0, q[4];
  for (int j = 0; j < 4; ++j) {
    const double nj = adj[0][j] * adj[0][j] + adj[1][j] * adj[1][j] +
                      adj[2][j] * adj[2][j] + adj[3][j] * adj[3][j];
    if (j == 0 || nj > best) {
      best = nj;
      for (int k = 0; k < 4; ++k) q[k] = adj[k][j];
    }
  }
  if (best < 1e-16)  // degenerate adjugate: all-ones seed
    for (int k = 0; k < 4; ++k) q[k] = 1.0;
  const double shift = sqrt(mx(gp * gy, 0.0)) + 1.0;
  for (int it = 0; it < kPowerIters; ++it) {
    double w[4];
    for (int i = 0; i < 4; ++i)
      w[i] = N[i][0] * q[0] + N[i][1] * q[1] + N[i][2] * q[2] + N[i][3] * q[3] +
             shift * q[i];
    const double inv =
        1.0 / sqrt(mx(w[0] * w[0] + w[1] * w[1] + w[2] * w[2] + w[3] * w[3], 1e-30));
    for (int i = 0; i < 4; ++i) q[i] = w[i] * inv;
  }
  const double inv =
      1.0 / sqrt(mx(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3], 1e-30));
  const double w_ = q[0] * inv, x_ = q[1] * inv, y_ = q[2] * inv, z_ = q[3] * inv;
  R[0][0] = w_ * w_ + x_ * x_ - y_ * y_ - z_ * z_;
  R[0][1] = 2.0 * (x_ * y_ - w_ * z_);
  R[0][2] = 2.0 * (x_ * z_ + w_ * y_);
  R[1][0] = 2.0 * (x_ * y_ + w_ * z_);
  R[1][1] = w_ * w_ - x_ * x_ + y_ * y_ - z_ * z_;
  R[1][2] = 2.0 * (y_ * z_ - w_ * x_);
  R[2][0] = 2.0 * (x_ * z_ - w_ * y_);
  R[2][1] = 2.0 * (y_ * z_ + w_ * x_);
  R[2][2] = w_ * w_ - x_ * x_ - y_ * y_ + z_ * z_;
  q_out[0] = w_;
  q_out[1] = x_;
  q_out[2] = y_;
  q_out[3] = z_;
  *lam_out = lam * total;
}

__global__ void qcp_step_kernel(const double* __restrict__ partials, int n_rows,
                                double* state, int* ctl, double* errs,
                                int with_scale, double threshold,
                                double err_factor, int converge) {
  double* out = state;  // (32,) block, updated in place by this one thread
  if (ctl[1]) {
    out[0] = 1.0;
    for (int k = 1; k < 13; ++k) out[k] = 0.0;
    out[1] = out[5] = out[9] = 1.0;
    return;
  }
  double a[kSums];
  for (int k = 0; k < kSums; ++k) a[k] = 0.0;
  for (int r = 0; r < n_rows; ++r)
    for (int k = 0; k < kSums; ++k) a[k] += partials[r * kSums + k];

  const double prev_s = state[13];
  double prev_R[3][3], prev_t[3];
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c) prev_R[r][c] = state[14 + 3 * r + c];
    prev_t[r] = state[23 + r];
  }
  const double n = a[17];
  const double inv_n = 1.0 / n;
  double mu_p[3], mu_y[3];
  for (int k = 0; k < 3; ++k) {
    mu_p[k] = a[9 + k] * inv_n;
    mu_y[k] = a[12 + k] * inv_n;
  }
  double S[3][3];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) S[r][c] = a[3 * r + c] - n * mu_p[r] * mu_y[c];
  const double gp =
      a[15] - n * (mu_p[0] * mu_p[0] + mu_p[1] * mu_p[1] + mu_p[2] * mu_p[2]);
  const double gy =
      a[16] - n * (mu_y[0] * mu_y[0] + mu_y[1] * mu_y[1] + mu_y[2] * mu_y[2]);

  double R[3][3], q[4], lam;
  qcp_rotation(S, gp, gy, R, q, &lam);
  const double s = with_scale ? sqrt(mx(gy / mx(gp, 1e-30), 0.0)) : 1.0;
  double t[3];
  for (int r = 0; r < 3; ++r)
    t[r] = mu_y[r] - s * (R[r][0] * mu_p[0] + R[r][1] * mu_p[1] + R[r][2] * mu_p[2]);
  const double resid = mx(gy + s * s * gp - 2.0 * s * lam, 0.0);

  out[0] = s;
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) out[1 + 3 * r + c] = R[r][c];
  for (int r = 0; r < 3; ++r) out[10 + r] = t[r];
  out[13] = s * prev_s;
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c)
      out[14 + 3 * r + c] =
          R[r][0] * prev_R[0][c] + R[r][1] * prev_R[1][c] + R[r][2] * prev_R[2][c];
  for (int r = 0; r < 3; ++r)
    out[23 + r] =
        s * (R[r][0] * prev_t[0] + R[r][1] * prev_t[1] + R[r][2] * prev_t[2]) + t[r];
  out[26] = resid;
  out[27] = lam;
  for (int k = 28; k < 32; ++k) out[k] = 0.0;

  const double err = err_factor * resid / n;
  const int it = ctl[0];
  errs[it] = err;
  ctl[0] = it + 1;
  if (it + 1 >= ctl[2] || (converge && !(err >= threshold))) ctl[1] = 1;
}

// K5: one thread; `in` and `out` are the (1, 16) float64 slot blocks.
__global__ void qcp_rotation_kernel(const double* __restrict__ in, double* __restrict__ out) {
  double S[3][3], R[3][3], q[4], lam;
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) S[r][c] = in[3 * r + c];
  qcp_rotation(S, in[9], in[10], R, q, &lam);
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) out[3 * r + c] = R[r][c];
  for (int k = 0; k < 4; ++k) out[9 + k] = q[k];
  out[13] = lam;
  out[14] = 0.0;
  out[15] = 0.0;
}

}  // namespace

ICP_EXPORT int qcp_rotation_launch(const double* in, double* out, cudaStream_t stream) {
  qcp_rotation_kernel<<<1, 1, 0, stream>>>(in, out);
  return static_cast<int>(cudaGetLastError());
}

ICP_EXPORT int qcp_step_launch(const double* partials, int n_rows, double* state,
                               int* ctl, double* errs, int with_scale,
                               double threshold, double err_factor, int converge,
                               cudaStream_t stream) {
  qcp_step_kernel<<<1, 1, 0, stream>>>(partials, n_rows, state, ctl, errs,
                                       with_scale, threshold, err_factor, converge);
  return static_cast<int>(cudaGetLastError());
}
