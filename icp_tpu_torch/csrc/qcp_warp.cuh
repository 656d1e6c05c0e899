// The alignment step on one warp: the QCP rotation solve (K5's function)
// and the whole step of K2 — column sums of the partial rows, Horn/QCP
// solve, composition, closed-form residual and the loop's convergence test.
// K2's launch (qcp.cu) and the last block of K3's launch (icp_fused.cu) call
// qcp_step_warp; K5's launch calls qcp_rotation_warp.
//
// Every value keeps the expression and operation order of the plain Python
// version (kernels/qcp.py), and the library is built with --fmad=false, so
// the result is bit-equal to it.  The 32 lanes compute the serial chains
// (the 12 Newton steps, the normalisations) redundantly, all with the same
// values, and split the independent work: lane k < 18 adds column k of the
// rows; lanes 0-3 the four terms of c0; lanes 0-15 the 16 cofactors of the
// adjugate; lanes 0-3 its column norms and the rows of each power step;
// lane k writes state slot k.  The 4 x 4 matrices are staged in the warp's
// shared scratch (kWarpScratch doubles), so a lane picks its entries by a
// run-time index without a local-memory array; values move between lanes by
// shuffles.
#pragma once

#include "common.cuh"

namespace qcp_warp {

constexpr int kSums = 18;
constexpr int kNewtonIters = 12;
constexpr int kPowerIters = 2;
constexpr int kWarpScratch = 64;  // doubles: N, M, adj (16 each), R and t
constexpr unsigned kFull = 0xffffffffu;

// K2's loop arguments (kernels/qcp.py qcp_step).
struct StepArgs {
  int with_scale;
  double threshold;
  double err_factor;
  int converge;
  int guard;  // icp(guard="device"): stop on a non-finite or diverged error
};

constexpr double kDivergeFactor = 100.0;  // err > factor * best error: diverged

// max that lets a NaN in `a` through (as jnp.maximum does).
__device__ __forceinline__ double mx(double a, double b) { return a < b ? b : a; }

// The k-th (k < 3) of {0, 1, 2, 3} other than `skip`, ascending.
__device__ __forceinline__ int other(int skip, int k) { return k < skip ? k : k + 1; }

// The 3 x 3 minor of the row-major 4 x 4 matrix M on rows r0 < r1 < r2 and
// columns c0 < c1 < c2, in kernels/qcp.py _minor3's order.
__device__ __forceinline__ double minor3(const double* M, int r0, int r1, int r2, int c0,
                                         int c1, int c2) {
  return M[4 * r0 + c0] * (M[4 * r1 + c1] * M[4 * r2 + c2] - M[4 * r1 + c2] * M[4 * r2 + c1]) -
         M[4 * r0 + c1] * (M[4 * r1 + c0] * M[4 * r2 + c2] - M[4 * r1 + c2] * M[4 * r2 + c0]) +
         M[4 * r0 + c2] * (M[4 * r1 + c0] * M[4 * r2 + c1] - M[4 * r1 + c1] * M[4 * r2 + c0]);
}

// _qcp_rotation: rotation R (row major), unit quaternion q (w, x, y, z) and
// the un-scaled lambda_max of the centred cross-covariance S (row major),
// by all 32 lanes of a warp with the same inputs; every lane returns the
// same outputs.  `sm`: kWarpScratch doubles of shared memory of this warp.
__device__ __forceinline__ void qcp_rotation_warp(const double (&S_in)[9], double gp, double gy,
                                                  double* sm, double (&R)[9], double (&q_out)[4],
                                                  double* lam_out) {
  const int lane = threadIdx.x & 31;
  const double total = mx(gp + gy, 1e-30);
  const double norm = 1.0 / total;
  double S[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) S[k] = S_in[k] * norm;
  gp = gp * norm;
  gy = gy * norm;
  const double S00 = S[0], S01 = S[1], S02 = S[2];
  const double S10 = S[3], S11 = S[4], S12 = S[5];
  const double S20 = S[6], S21 = S[7], S22 = S[8];
  const double tr = S00 + S11 + S22;
  const double A = S12 - S21, B = S20 - S02, C = S01 - S10;
  const double c2 = -2.0 * (S00 * S00 + S01 * S01 + S02 * S02 + S10 * S10 + S11 * S11 +
                            S12 * S12 + S20 * S20 + S21 * S21 + S22 * S22);
  const double detS = S00 * (S11 * S22 - S12 * S21) - S01 * (S10 * S22 - S12 * S20) +
                      S02 * (S10 * S21 - S11 * S20);
  const double c1 = -8.0 * detS;
  double* N = sm;       // the key matrix, row major
  double* M = sm + 16;  // N - lambda I
  double* adj = sm + 32;  // adj(M), row major
  if (lane == 0) {
    const double n[16] = {tr, A, B, C,
                          A, S00 - S11 - S22, S01 + S10, S02 + S20,
                          B, S01 + S10, S11 - S00 - S22, S12 + S21,
                          C, S02 + S20, S12 + S21, S22 - S00 - S11};
#pragma unroll
    for (int k = 0; k < 16; ++k) N[k] = n[k];
  }
  __syncwarp();

  // c0 = det N by its first row: lane j < 4 takes term j; added in j order.
  const int j4 = lane & 3;
  const double term = ((j4 % 2) ? -N[j4] : N[j4]) *
                      minor3(N, 1, 2, 3, other(j4, 0), other(j4, 1), other(j4, 2));
  double c0 = 0.0;
#pragma unroll
  for (int j = 0; j < 4; ++j) c0 = c0 + __shfl_sync(kFull, term, j);

  double lam = sqrt(mx(gp * gy, 0.0));
#pragma unroll 1
  for (int it = 0; it < kNewtonIters; ++it) {
    const double p = ((lam * lam + c2) * lam + c1) * lam + c0;
    double dp = (4.0 * lam * lam + 2.0 * c2) * lam + c1;
    dp = fabs(dp) < 1e-30 ? 1.0 : dp;
    lam = lam - p / dp;
  }

  // M = N - lam I, then adj(M): lane 4i + j computes adj[j][i].
  const int i16 = (lane >> 2) & 3;
  if (lane < 16) M[lane] = i16 == j4 ? N[lane] - lam : N[lane];
  __syncwarp();
  const double cof = ((i16 + j4) % 2 ? -1.0 : 1.0) *
                     minor3(M, other(i16, 0), other(i16, 1), other(i16, 2), other(j4, 0),
                            other(j4, 1), other(j4, 2));
  if (lane < 16) adj[4 * j4 + i16] = cof;
  __syncwarp();

  // The column of largest norm, the lowest j on ties (j == 0 || nj > best).
  const double nrm = adj[j4] * adj[j4] + adj[4 + j4] * adj[4 + j4] +
                     adj[8 + j4] * adj[8 + j4] + adj[12 + j4] * adj[12 + j4];
  double best = 0.0;
  int jb = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const double nj = __shfl_sync(kFull, nrm, j);
    if (j == 0 || nj > best) {
      best = nj;
      jb = j;
    }
  }
  double q[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = best < 1e-16 ? 1.0 : adj[4 * k + jb];  // degenerate: ones

  // Power steps on N + shift I: lane i < 4 computes row i.
  const double shift = sqrt(mx(gp * gy, 0.0)) + 1.0;
#pragma unroll
  for (int it = 0; it < kPowerIters; ++it) {
    const double qi = j4 == 0 ? q[0] : j4 == 1 ? q[1] : j4 == 2 ? q[2] : q[3];
    const double wi = N[4 * j4] * q[0] + N[4 * j4 + 1] * q[1] + N[4 * j4 + 2] * q[2] +
                      N[4 * j4 + 3] * q[3] + shift * qi;
    double w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = __shfl_sync(kFull, wi, k);
    const double inv =
        1.0 / sqrt(mx(w[0] * w[0] + w[1] * w[1] + w[2] * w[2] + w[3] * w[3], 1e-30));
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = w[k] * inv;
  }
  const double inv =
      1.0 / sqrt(mx(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3], 1e-30));
  const double w_ = q[0] * inv, x_ = q[1] * inv, y_ = q[2] * inv, z_ = q[3] * inv;
  R[0] = w_ * w_ + x_ * x_ - y_ * y_ - z_ * z_;
  R[1] = 2.0 * (x_ * y_ - w_ * z_);
  R[2] = 2.0 * (x_ * z_ + w_ * y_);
  R[3] = 2.0 * (x_ * y_ + w_ * z_);
  R[4] = w_ * w_ - x_ * x_ + y_ * y_ - z_ * z_;
  R[5] = 2.0 * (y_ * z_ - w_ * x_);
  R[6] = 2.0 * (x_ * z_ - w_ * y_);
  R[7] = 2.0 * (y_ * z_ + w_ * x_);
  R[8] = w_ * w_ - x_ * x_ - y_ * y_ + z_ * z_;
  q_out[0] = w_;
  q_out[1] = x_;
  q_out[2] = y_;
  q_out[3] = z_;
  *lam_out = lam * total;
  __syncwarp();  // sm is free again
}

// K2's step by all 32 lanes of a warp: the (n_rows, 18) partial rows, read
// through L2 (another block may have written them in this launch), update
// the (32,) state block, the loop control and the error buffer in place.
// Loop control ctl (int32): [0] iterations done, [1] done flag, [2] bound,
// [3] guard status; the flag rises at the bound and, when `converge` is
// set, also when !(err >= threshold), so a NaN error stops the loop.  With
// `guard` set it also rises on a status other than 0: 1 when the error is
// not finite, 2 when it exceeds kDivergeFactor times the least error so
// far, which the step keeps in state slot 28 (read as +inf at iteration 0);
// unguarded, slot 28 is written 0 as before.  Once done, the identity step
// is written and nothing else changes, so a later apply of the step is an
// exact no-op.
__device__ __forceinline__ void qcp_step_warp(const double* rows, int n_rows, double* state,
                                              int* ctl, double* errs, const StepArgs& args,
                                              double* sm) {
  const int lane = threadIdx.x & 31;
  // Every global read first, so they share one round trip: the control,
  // the columns of the rows, the previous transform (lanes 14-22 also the
  // column of R_tot their slot composes).
  const int done = ctl[1], it = ctl[0], bound = ctl[2];
  double col = 0.0;
  if (lane < kSums)
    for (int r = 0; r < n_rows; ++r) col += __ldcg(rows + r * kSums + lane);
  const double prev_s = state[13];
  const double best = it == 0 ? __longlong_as_double(0x7ff0000000000000LL) : state[28];
  const double pt0 = state[23], pt1 = state[24], pt2 = state[25];
  const int c3 = lane >= 14 && lane < 23 ? (lane - 14) % 3 : 0;
  const double pr0 = state[14 + c3], pr1 = state[17 + c3], pr2 = state[20 + c3];
  if (done) {
    if (lane < 13) state[lane] = (lane == 0 || lane == 1 || lane == 5 || lane == 9) ? 1.0 : 0.0;
    return;
  }
  double a[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) a[k] = __shfl_sync(kFull, col, k);

  const double n = a[17];
  const double inv_n = 1.0 / n;
  double mu_p[3], mu_y[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    mu_p[k] = a[9 + k] * inv_n;
    mu_y[k] = a[12 + k] * inv_n;
  }
  double S[9];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) S[3 * r + c] = a[3 * r + c] - n * mu_p[r] * mu_y[c];
  const double gp = a[15] - n * (mu_p[0] * mu_p[0] + mu_p[1] * mu_p[1] + mu_p[2] * mu_p[2]);
  const double gy = a[16] - n * (mu_y[0] * mu_y[0] + mu_y[1] * mu_y[1] + mu_y[2] * mu_y[2]);

  double R[9], q[4], lam;
  qcp_rotation_warp(S, gp, gy, sm, R, q, &lam);
  const double s = args.with_scale ? sqrt(mx(gy / mx(gp, 1e-30), 0.0)) : 1.0;
  double t[3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
    t[r] = mu_y[r] - s * (R[3 * r] * mu_p[0] + R[3 * r + 1] * mu_p[1] + R[3 * r + 2] * mu_p[2]);
  const double resid = mx(gy + s * s * gp - 2.0 * s * lam, 0.0);
  const double err = args.err_factor * resid / n;
  int status = 0;
  if (args.guard) status = !isfinite(err) ? 1 : err > kDivergeFactor * best ? 2 : 0;

  // Lane k computes state slot k: [s, R (9), t (3), s_tot, R_tot (9),
  // t_tot (3), residual, lambda, 0 (4)].
  double* Rs = sm;      // R, row major
  double* ts = sm + 9;  // t
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) Rs[k] = R[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) ts[k] = t[k];
  }
  __syncwarp();
  double v = 0.0;
  if (lane == 0) {
    v = s;
  } else if (lane < 10) {
    v = Rs[lane - 1];
  } else if (lane < 13) {
    v = ts[lane - 10];
  } else if (lane == 13) {
    v = s * prev_s;
  } else if (lane < 23) {
    const int r = (lane - 14) / 3;
    v = Rs[3 * r] * pr0 + Rs[3 * r + 1] * pr1 + Rs[3 * r + 2] * pr2;
  } else if (lane < 26) {
    const int r = lane - 23;
    v = s * (Rs[3 * r] * pt0 + Rs[3 * r + 1] * pt1 + Rs[3 * r + 2] * pt2) + ts[r];
  } else if (lane == 26) {
    v = resid;
  } else if (lane == 27) {
    v = lam;
  } else if (lane == 28 && args.guard) {
    v = err < best ? err : best;
  }
  state[lane] = v;  // every lane read the previous state at the start
  if (lane == 0) {
    errs[it] = err;
    ctl[0] = it + 1;
    if (it + 1 >= bound || (args.converge && !(err >= args.threshold)) || status) ctl[1] = 1;
    if (status) ctl[3] = status;
  }
}

}  // namespace qcp_warp
