// K8: lane-chunked exact nearest neighbour — for every scene point the model
// index of the least squared distance, ties to the lowest index; indices
// only.
//
// Replaces icp_tpu/kernels/nn_pallas.py:49 _nn_kernel_chunked (reached
// through the pallas_call at nn_pallas.py:244 with distance_impl="chunked").
//
// What bounds it on the H100: float32 arithmetic, as K1 — 3 subtractions, 3
// multiplications, 2 additions and a compare per (scene, model) pair; the
// bytes are N*12 + M*12 in and N*4 out.  Under --fmad=false a distance is 8
// separately rounded instructions, so no exact fold beats ~2x the printed
// bound.  The TPU kernel splits the model axis over 128 vector lanes, keeps
// a per-lane (best, chunk) carry in registers and does one cross-lane
// lowest-index argmin at the end.  The Hopper form splits the model axis
// over the 32 lanes of a warp: lane l folds rows base+l, base+l+32, ...,
// keeps the lowest row of its own least distance, and shuffles then take
// the least (d, row) of the lanes.
//
// The design, one launch and no memset:
//  * Grid: (scene block x model chunk) blocks, sized to one wave of
//    resident blocks by dense_fold::chunk_rows (cow's 2,903 points make 46
//    scene blocks of 64 points; the model is cut into as many chunks of
//    whole 512-row stages as the wave needs; the grid seed and the 1M seed
//    have scene blocks enough for one chunk), so a small scene still fills
//    the card.  A chunk holds at least kMinChunkRows = 1,024 model rows:
//    at cow 2 chunks of 1,536 rows took 10.8 us on the device against 11.8
//    for the wave's 6 of 512, 12.7 for 3 and 14.6 for one (more chunks
//    add blocks but also merges and a finish each; scripts/tune_kernels.py,
//    H100).  A warp holds kPoints = 8 scene points in
//    registers (every lane the same eight), so one shared-memory row feeds
//    eight independent chains.  (128 threads a block: 7% faster at cow, 4%
//    slower at the grid seed and on the 1M seed; scripts/tune_kernels.py,
//    H100.)
//  * Staging: the chunk streams through a kStages-deep ring of 512-row
//    stages filled by cp.async, the raw (x, y, z) floats, 16 bytes at a
//    time where the model is 16-byte aligned (a stage is 6,144 bytes and a
//    chunk starts on a stage), else 4 (K1's ring).  512 rows a stage give a
//    lane 128 pairs between two block barriers (128 rows: 32, and 10-20%
//    more time at the grid seed and on the 1M seed).
//  * Fold: lane l's rows l, l+32, l+64, l+96 (of each 128) make a group:
//    the least of the four first (3 fminf a point, which drops a NaN), and
//    one strict < against the lane's best, which records the group's first
//    row: 1.5 instructions a pair beside the distance's 8, with no branch
//    and no divergence.  The row within the group is found once, after the
//    fold (below).  K1's group-of-four (dense_fold::fold4) compares row by
//    row when a group beats the best; a lane here sees 1/32 of the rows,
//    so its own best is beaten in most groups of some lane and point, and
//    that form took 79.8 us at the grid seed against this one's 75.5 at
//    the same 128-row stages (chip_smoke.py, scripts/tune_kernels.py;
//    H100).  Rows past a chunk's last whole group (and m < 32, where some
//    lanes have no rows) fold row by row.
//  * Rows: per point, the lanes' least distance by shuffles; each lane
//    holding it computes its group's four distances again alike (one
//    round of loads) and takes the first equal one; the least such row of
//    the lanes wins, so ties go to the lowest index.
//  * Merge: lane p merges point p's (least distance, its row) into the
//    point's 64-bit key by atomicMin (dense_fold::merge: order-preserving
//    distance bits high, row low), once a point a chunk; the lowest row of
//    the least distance wins in any order, a NaN never wins, and a point
//    with no distance below +inf keeps the empty key.  With one chunk lane
//    p writes the index itself and the keys are not used.
//  * Finish: the last chunk block of a scene block to arrive (a counter per
//    scene block: __threadfence, then atomicAdd by thread 0) reads the
//    block's keys through L2, writes its indices (the empty key gives index
//    0, as the plain version and K1 give for such rows) and resets its keys
//    and its counter, so the workspace is clean after every launch.
// Distances are sqdist_rn under --fmad=false, so the indices equal K1's and
// the plain version's bit for bit.
#include <climits>

#include "dense_fold.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPoints = 8;       // scene points a warp
constexpr int kStageRows = 512;  // model rows a ring stage
constexpr int kGroup = 4;        // a lane's rows a group: 32 apart
constexpr int kStages = 4;       // ring depth
constexpr int kMinChunkRows = 1024;  // a chunk's model rows at least, where m has them
constexpr int kBlockPoints = kThreads / 32 * kPoints;
constexpr int kStageFloats = 3 * kStageRows;
constexpr unsigned long long kEmpty = dense_fold::kEmpty;
static_assert(kStageRows % (32 * kGroup) == 0, "a stage holds whole groups");

__global__ void __launch_bounds__(kThreads)
nn_chunked_kernel(const float* __restrict__ scene, int n, const float* __restrict__ model, int m,
                  int chunk_rows, bool aligned16, unsigned long long* __restrict__ keys,
                  unsigned* __restrict__ counts, int* __restrict__ idx_out) {
  constexpr int P = kPoints;
  __shared__ __align__(16) float ring[kStages][kStageFloats];
  __shared__ bool last;
  const int lane = threadIdx.x & 31;
  const int first = blockIdx.x * kBlockPoints + (threadIdx.x >> 5) * P;  // the warp's points
  const int base = blockIdx.y * chunk_rows;  // the chunk's first model row
  const int rows = min(chunk_rows, m - base);
  const int nb = (rows + kStageRows - 1) / kStageRows;
  const float inf = __int_as_float(0x7f800000);

  // best[p]: the least distance of the lane's rows; at[p]: the first row of
  // the first group (or the row) that reached it
  float px[P], py[P], pz[P], best[P];
  int at[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int i = first + p;
    px[p] = i < n ? scene[3 * i] : 0.f;
    py[p] = i < n ? scene[3 * i + 1] : 0.f;
    pz[p] = i < n ? scene[3 * i + 2] : 0.f;
    best[p] = inf;
    at[p] = 0;
  }

  auto issue = [&](int b) {
    const int r0 = b * kStageRows;
    const int nf = 3 * min(kStageRows, rows - r0);  // floats of this stage
    const float* src = model + 3LL * (base + r0);  // 16-byte aligned when the model is
    float* dst = ring[b % kStages];
    const int n16 = aligned16 ? nf / 4 : 0;
    for (int t = threadIdx.x; t < n16; t += kThreads) cp_async16(dst + 4 * t, src + 4 * t);
    for (int t = 4 * n16 + threadIdx.x; t < nf; t += kThreads) cp_async4(dst + t, src + t);
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nb) issue(s);
    cp_async_commit();
  }
  for (int b = 0; b < nb; ++b) {
    cp_async_wait<kStages - 2>();  // stage b has landed (this thread's copies)
    __syncthreads();               // ... everyone's; stage b-1 is no longer read
    if (b + kStages - 1 < nb) issue(b + kStages - 1);
    cp_async_commit();
    const float* buf = ring[b % kStages];
    const int cnt = min(kStageRows, rows - b * kStageRows);
    const int r0 = base + b * kStageRows;
    // group g: rows lane + 32 (g kGroup + u), u < kGroup; the group's least
    // distance first (fminf drops a NaN), and a strict < against the lane's
    // best keeps the first group that reaches it
    auto group = [&](int g) {
      float4 q[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const float* r = buf + 3 * (lane + 32 * (g * kGroup + u));
        q[u] = make_float4(r[0], r[1], r[2], 0.f);
      }
#pragma unroll
      for (int p = 0; p < P; ++p) {
        float mn = sqdist_rn(px[p], py[p], pz[p], q[0]);
#pragma unroll
        for (int u = 1; u < kGroup; ++u) mn = fminf(mn, sqdist_rn(px[p], py[p], pz[p], q[u]));
        if (mn < best[p]) {
          best[p] = mn;
          at[p] = r0 + lane + 32 * g * kGroup;
        }
      }
    };
    if (cnt == kStageRows) {
#pragma unroll
      for (int g = 0; g < kStageRows / (32 * kGroup); ++g) group(g);
    } else {  // the chunk's last stage: its whole groups, then row by row
      const int groups = cnt / (32 * kGroup);
      for (int g = 0; g < groups; ++g) group(g);
      for (int k = 32 * kGroup * groups + lane; k < cnt; k += 32) {
        const float4 q = make_float4(buf[3 * k], buf[3 * k + 1], buf[3 * k + 2], 0.f);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const float d = sqdist_rn(px[p], py[p], pz[p], q);
          if (d < best[p]) {
            best[p] = d;
            at[p] = r0 + k;
          }
        }
      }
    }
  }

  // Per point: the lanes' least distance, then the lanes that hold it find
  // its row — the first of their group's rows (32 apart, all loads at once)
  // whose distance, computed again alike, equals it (a row folded on its
  // own is its group's first) — and the least such row wins.  No d
  // is NaN from here on; a point with no distance below +inf keeps +inf.
#pragma unroll
  for (int p = 0; p < P; ++p) {
    float d = best[p];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) d = fminf(d, __shfl_xor_sync(0xffffffffu, d, off));
    int row = INT_MAX;
    if (best[p] == d && d < inf) {
#pragma unroll
      for (int u = kGroup - 1; u >= 0; --u) {  // the lowest match is written last
        const int r = at[p] + 32 * u;
        if (r < m) {
          const float4 q = make_float4(model[3 * r], model[3 * r + 1], model[3 * r + 2], 0.f);
          if (sqdist_rn(px[p], py[p], pz[p], q) == d) row = r;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) row = min(row, __shfl_xor_sync(0xffffffffu, row, off));
    best[p] = d;
    at[p] = row;
  }
  if (gridDim.y == 1) {  // one chunk: the warp's winners are final
#pragma unroll
    for (int p = 0; p < P; ++p)
      if (lane == p && first + p < n) idx_out[first + p] = best[p] < inf ? at[p] : 0;
    return;
  }
#pragma unroll
  for (int p = 0; p < P; ++p)
    if (lane == p && first + p < n) dense_fold::merge(keys + first + p, best[p], at[p]);

  // The last chunk block of this scene block writes its indices.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counts + blockIdx.x, 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int i = blockIdx.x * kBlockPoints + threadIdx.x;
  if (threadIdx.x < kBlockPoints && i < n) {
    const unsigned long long key = __ldcg(keys + i);
    idx_out[i] = key == kEmpty ? 0 : static_cast<int>(static_cast<unsigned>(key));
    keys[i] = kEmpty;
  }
  if (threadIdx.x == 0) counts[blockIdx.x] = 0;
}

int waves[64];  // the wave of each device, asked once

int chunk_rows_for(int n, int m, int* out) {
  const int code = dense_fold::chunk_rows(nn_chunked_kernel, kThreads, waves,
                                          (n + kBlockPoints - 1) / kBlockPoints, m, kStageRows,
                                          out);
  const int most = m / kMinChunkRows > 1 ? m / kMinChunkRows : 1;  // chunks
  if (code == 0 && (m + *out - 1) / *out > most) {
    const int per = (m + most - 1) / most;
    *out = (per + kStageRows - 1) / kStageRows * kStageRows;
  }
  return code;
}

}  // namespace

// K8's workspace on the current card: `points` key words and `blocks`
// counters.  A launch splits the model into chunks only while its scene
// blocks are fewer than a wave, so that many serve every launch.
ICP_EXPORT int nn_chunked_workspace(int* points, int* blocks) {
  int chunk_rows = 0;  // asks the wave
  const int code = chunk_rows_for(1, kStageRows, &chunk_rows);
  if (code != 0) return code;
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  *blocks = waves[dev];
  *points = waves[dev] * kBlockPoints;
  return 0;
}

// keys: `capacity` 64-bit words, all ones; counts: capacity / kBlockPoints
// words, zero (nn_chunked_workspace); both left so.
ICP_EXPORT int nn_chunked_launch(const float* scene, int n, const float* model, int m,
                                 unsigned long long* keys, unsigned* counts, int capacity,
                                 int* idx_out, cudaStream_t stream) {
  if (n < 1 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  int chunk_rows = 0;
  const int code = chunk_rows_for(n, m, &chunk_rows);
  if (code != 0) return code;
  const dim3 grid((n + kBlockPoints - 1) / kBlockPoints, (m + chunk_rows - 1) / chunk_rows);
  if (grid.y > 1 && n > capacity) return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned16 = reinterpret_cast<unsigned long long>(model) % 16 == 0;
  nn_chunked_kernel<<<grid, kThreads, 0, stream>>>(scene, n, model, m, chunk_rows, aligned16,
                                                   keys, counts, idx_out);
  return static_cast<int>(cudaGetLastError());
}

// The model rows of one chunk for an (n, m) launch on the current card.
ICP_EXPORT int nn_chunked_chunk_rows(int n, int m, int* chunk_rows) {
  if (n < 1 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  return chunk_rows_for(n, m, chunk_rows);
}
