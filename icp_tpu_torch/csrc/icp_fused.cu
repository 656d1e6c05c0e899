// K3: one whole dense ICP iteration in one launch — apply the cumulative
// similarity, exact nearest neighbour in expansion form, the Horn
// sufficient statistics, and the alignment step (K2's solve, composition,
// residual and convergence test) in the last block to finish.
//
// Replaces icp_tpu/kernels/icp_fused.py:128 _icp_iter_kernel, which does
// the same in one pallas_call (its solve on the last grid step).
//
// What bounds it on the H100: the N x M distance fold — 6 float32
// operations and a compare per pair (cow: 2,903^2 = 8.4 M pairs an
// iteration), about a microsecond of the card's float32 rate; at cow's size
// the launch, the tail and the serial float64 solve set the time.
//
// The design: a grid of (scene block x model chunk) blocks sized to one
// wave, as K1's (dense_fold.cuh), so a small scene still fills the card
// (cow: 6 scene blocks of 512 points x 23 chunks of 128 rows).
//  * Apply and fold: each block applies the cumulative transform, cast to
//    float32 as the plain version does, to its scene points in registers
//    (four a thread; every chunk block of a scene block computes them bit
//    for bit alike, and the moved cloud is never written), and streams its
//    chunk of pre-scaled (-2m, |m|^2) float4 rows through a 4-stage
//    cp.async ring.  Distances are expdist_rn, JAX's _fold_chunk order;
//    each point takes the least of a group of four rows first (fold4).
//  * Merge: a chunk's per-point (least distance, its lowest row) goes into
//    the point's 64-bit key by atomicMin (order-preserving distance bits
//    high, row low): the lowest row of the least distance wins in any
//    order, a NaN never wins, and a point with no distance below +inf
//    keeps the empty key.
//  * Sums: the last chunk block of a scene block to finish (a counter per
//    scene block: __threadfence, then atomicAdd by thread 0) reads the
//    block's keys through L2, gathers the winners from the pre-scaled rows
//    (times -0.5, exact; the empty key is y = 0), takes the 17 sums in
//    float64 with block_sum into the scene block's row, and resets its keys
//    and its counter for the next launch.
//  * Solve: the last scene block to finish (a second counter) runs K2's
//    warp step (qcp_warp.cuh) on the rows in scene-block order: it solves,
//    composes, writes errs[it], advances ctl[0], raises ctl[1] with K2's
//    rule (with `guard`, also on K2's status word in ctl[3]) and resets the
//    counter.
// The pair axis (the counterpart of JAX's vmap over the pallas_call): a
// launch takes B pairs, each with its own scene, model rows, state block,
// loop control, error buffer and workspace (keys, counters, rows), laid out
// one pair after another.  The grid gains blockIdx.z, the pair, and every
// block offsets all of these by it; gridDim.x stays one pair's scene
// blocks, so the counters, the "last block" tests and the solve's row count
// are each pair's, and each pair's last block runs that pair's step.  The
// chunk is sized to one wave over B x scene blocks.  A single pair is B = 1.
// No grid barrier, no spin-wait and no float atomics: the last block to
// arrive needs none, and a run repeats bit for bit.  When ctl[1] is up at
// the start every block returns and block (0, 0) writes the identity step,
// so a later apply of the step is an exact no-op.  The workspace (keys,
// counters, rows) is the caller's, zeroed (keys: all ones) once a run; every
// launch leaves it so, except for the rows, which keep this launch's sums.
#include "dense_fold.cuh"
#include "qcp_warp.cuh"

namespace {

using qcp_warp::StepArgs;

constexpr int kThreads = 128;
constexpr int kPoints = 4;  // scene points a thread: 512 a scene block
constexpr int kBlockPoints = kThreads * kPoints;
constexpr int kStageRows = 128;  // model rows a ring stage (2 KB)
constexpr int kStages = 4;
constexpr int kSums = qcp_warp::kSums;  // 17 Horn sums + the row count
constexpr unsigned long long kEmpty = dense_fold::kEmpty;
constexpr int kStateSlots = 32;
constexpr int kCtlSlots = 4;
constexpr int kMaxPairs = 65535;  // gridDim.z

__global__ void __launch_bounds__(kThreads)
icp_fused_kernel(const float* __restrict__ p0, int n, const float4* __restrict__ mt, int m,
                 int chunk_rows, double* state, int* ctl, double* errs, int errs_len,
                 unsigned long long* keys, unsigned* counts, double* rows, StepArgs args) {
  constexpr int P = kPoints;
  __shared__ __align__(16) float4 ring[kStages][kStageRows];
  __shared__ double scratch[(kThreads / 32) * kSums];  // block_sum; then the solve's
  __shared__ bool last;
  static_assert((kThreads / 32) * kSums >= qcp_warp::kWarpScratch, "solve scratch");
  const long long pair = blockIdx.z;  // this pair's slice of every array
  p0 += pair * 3 * n;
  mt += pair * m;
  state += pair * kStateSlots;
  ctl += pair * kCtlSlots;
  errs += pair * errs_len;
  keys += pair * n;
  counts += pair * (gridDim.x + 1);
  rows += pair * gridDim.x * kSums;
  if (ctl[1]) {  // done: the identity step, once
    if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x < 13)
      state[threadIdx.x] =
          (threadIdx.x == 0 || threadIdx.x == 1 || threadIdx.x == 5 || threadIdx.x == 9) ? 1.0
                                                                                          : 0.0;
    return;
  }

  // The cumulative transform, cast to float32 (icp_fused.py's apply).
  const float s = static_cast<float>(state[13]);
  float R[9], t[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = static_cast<float>(state[14 + k]);
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = static_cast<float>(state[23 + k]);
  const int first = blockIdx.x * kBlockPoints + threadIdx.x;  // point p: first + p * kThreads
  float px[P], py[P], pz[P], best[P];
  int bi[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int i = first + p * kThreads;
    const float x = i < n ? p0[3 * i] : 0.f;
    const float y = i < n ? p0[3 * i + 1] : 0.f;
    const float z = i < n ? p0[3 * i + 2] : 0.f;
    float v[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float rp = __fadd_rn(__fadd_rn(__fmul_rn(R[3 * r], x), __fmul_rn(R[3 * r + 1], y)),
                                 __fmul_rn(R[3 * r + 2], z));
      v[r] = __fadd_rn(__fmul_rn(s, rp), t[r]);
    }
    px[p] = v[0];
    py[p] = v[1];
    pz[p] = v[2];
    best[p] = __int_as_float(0x7f800000);  // +inf
    bi[p] = 0;
  }

  // Fold the chunk through the ring.
  const int base = blockIdx.y * chunk_rows;
  const int rows_here = min(chunk_rows, m - base);
  const int nb = (rows_here + kStageRows - 1) / kStageRows;
  auto issue = [&](int b) {
    const int r0 = b * kStageRows;
    const int cnt = min(kStageRows, rows_here - r0);
    if (threadIdx.x < cnt) cp_async16(&ring[b % kStages][threadIdx.x], mt + base + r0 + threadIdx.x);
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nb) issue(st);
    cp_async_commit();
  }
  for (int b = 0; b < nb; ++b) {
    cp_async_wait<kStages - 2>();  // stage b has landed (this thread's copies)
    __syncthreads();               // ... everyone's; stage b-1 is no longer read
    if (b + kStages - 1 < nb) issue(b + kStages - 1);
    cp_async_commit();
    const float4* buf = ring[b % kStages];
    const int cnt = min(kStageRows, rows_here - b * kStageRows);
    const int r0 = base + b * kStageRows;
    const int groups = cnt / 4;
#pragma unroll 2
    for (int g = 0; g < groups; ++g) {
      const float4 q[4] = {buf[4 * g], buf[4 * g + 1], buf[4 * g + 2], buf[4 * g + 3]};
      float d[P][4];
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int u = 0; u < 4; ++u) d[p][u] = expdist_rn(px[p], py[p], pz[p], q[u]);
      dense_fold::fold4(d, r0 + 4 * g, best, bi);
    }
    for (int k = 4 * groups; k < cnt; ++k) {
      const float4 q = buf[k];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float dk = expdist_rn(px[p], py[p], pz[p], q);
        if (dk < best[p]) {
          best[p] = dk;
          bi[p] = r0 + k;
        }
      }
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int i = first + p * kThreads;
    if (i < n) dense_fold::merge(keys + i, best[p], bi[p]);
  }

  // The last chunk block of this scene block takes its sums.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counts + blockIdx.x, 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  double v[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) v[k] = 0.0;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int i = first + p * kThreads;
    if (i >= n) continue;
    const unsigned long long key = __ldcg(keys + i);
    keys[i] = kEmpty;
    float yx = 0.f, yy = 0.f, yz = 0.f;
    if (key != kEmpty) {
      const float4 q = mt[static_cast<unsigned>(key)];
      yx = -0.5f * q.x;
      yy = -0.5f * q.y;
      yz = -0.5f * q.z;
    }
    const double P3[3] = {px[p], py[p], pz[p]};
    const double Y3[3] = {yx, yy, yz};
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) v[3 * r + c] += P3[r] * Y3[c];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      v[9 + k] += P3[k];
      v[12 + k] += Y3[k];
    }
    v[15] += P3[0] * P3[0] + P3[1] * P3[1] + P3[2] * P3[2];
    v[16] += Y3[0] * Y3[0] + Y3[1] * Y3[1] + Y3[2] * Y3[2];
    v[17] += 1.0;
  }
  block_sum<kSums>(v, scratch, rows + blockIdx.x * kSums);
  if (threadIdx.x == 0) counts[blockIdx.x] = 0;

  // The last scene block to finish solves.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counts + gridDim.x, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last || threadIdx.x >= 32) return;
  __threadfence();
  qcp_warp::qcp_step_warp(rows, gridDim.x, state, ctl, errs, args, scratch);
  if (threadIdx.x == 0) counts[gridDim.x] = 0;
}

int chunk_rows_for(int pairs, int n, int m, int* out) {
  static int waves[64];  // the wave of each device, asked once
  const long long scene_blocks = (n + kBlockPoints - 1) / kBlockPoints;
  return dense_fold::chunk_rows(icp_fused_kernel, kThreads, waves,
                                static_cast<long long>(pairs) * scene_blocks, m, kStageRows,
                                out);
}

bool valid(int pairs, int n, int m) { return pairs >= 1 && pairs <= kMaxPairs && n >= 1 && m >= 1; }

}  // namespace

// Scene blocks of an n-point pair: the rows of its sums and its counters
// (one more: the solve's) in the workspace.
ICP_EXPORT int icp_fused_scene_blocks(int n) { return (n + kBlockPoints - 1) / kBlockPoints; }

// The model rows of one chunk for a launch of `pairs` (n, m) pairs on the
// current card.
ICP_EXPORT int icp_fused_chunk_rows(int pairs, int n, int m, int* chunk_rows) {
  if (!valid(pairs, n, m)) return static_cast<int>(cudaErrorInvalidValue);
  return chunk_rows_for(pairs, n, m, chunk_rows);
}

// `pairs` pairs, each array laid out pair after pair: p0 (n, 3); mt (m, 4)
// float32 rows [-2x, -2y, -2z, |m|^2], 16-byte aligned; state (32,); ctl
// (4,); errs (errs_len,); keys: n words, all ones; counts: scene blocks + 1
// words, zero; rows: (scene blocks, 18) float64, this launch's sums on
// return.
ICP_EXPORT int icp_fused_launch(const float* p0, int pairs, int n, const float4* mt, int m,
                                double* state, int* ctl, double* errs, int errs_len,
                                unsigned long long* keys, unsigned* counts, double* rows,
                                int with_scale, double threshold, double err_factor,
                                int converge, int guard, cudaStream_t stream) {
  if (!valid(pairs, n, m)) return static_cast<int>(cudaErrorInvalidValue);
  int chunk_rows = 0;
  const int code = chunk_rows_for(pairs, n, m, &chunk_rows);
  if (code != 0) return code;
  const dim3 grid(icp_fused_scene_blocks(n), (m + chunk_rows - 1) / chunk_rows, pairs);
  const StepArgs args{with_scale, threshold, err_factor, converge, guard};
  icp_fused_kernel<<<grid, kThreads, 0, stream>>>(p0, n, mt, m, chunk_rows, state, ctl, errs,
                                                   errs_len, keys, counts, rows, args);
  return static_cast<int>(cudaGetLastError());
}
