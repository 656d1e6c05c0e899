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
// the scene point to model[idx].  A NaN d~ never counts; a row with no d~
// below +inf gets index 0.  The certificate second - best > 2B is computed
// after the kernel, in torch.
//
// What bounds it on the H100: the cross term is a bf16 product, which the
// TPU kernel runs on its matrix unit (nn_bf16.py:67-73) and this one on the
// tensor cores; what is left for the float32 units is the norm add and the
// fold's compares (3 operations a pair at the float32 peak), and the bytes
// (N*12 + M*12 in, N*16 out) are far below either.  As written, the fold
// spends a multiply-add and five compare/min/max/select instructions a pair
// (below); the latter issue on the SM's integer/compare pipe, at half the
// float32 rate (16 lanes a cycle a scheduler), which makes ~0.7 ms the floor
// of this form at horse (48,485^2) on a 1.98 GHz H100.
//
// The design, one C call of two kernels:
//  1. prep: the model staged once a call as 16-byte records (bf16 (x, y),
//     bf16 (z, 0), 0, 0) and a float32 array of exact norms
//     (x*x + y*y) + z*z, padded to whole 128-row stages with zero records
//     and +inf norms (d~ = +inf: they never count).
//  2. fold: a grid of (scene block x model chunk) blocks, sized to about one
//     wave as K1's is, so cow (23 blocks of 128 rows) and a 500-point cloud
//     still fill the card.  A warp holds 32 scene rows as two m16 tiles of
//     the A operand of mma.sync.m16n8k16 (bf16 in, float32 accumulate; K
//     padded from 3 to 16 with zeros), kept in registers for the whole fold.
//     The chunk's records and norms stream through a 4-deep cp.async ring of
//     128-row stages; a lane reads one 32-bit word of a record as its B
//     fragment (lane 4g + t reads word t of row g: conflict-free) and two
//     norms.  Each mma leaves a thread 2 rows x 2 columns of the cross term
//     c; it forms d~ = fmaf(-2, c, norm) — the same rounding as
//     norm - 2c, since 2c is exact — and folds it into one (best, second,
//     idx) triple per (row, column parity) with the branch-free update
//       idx = d < best ? tile : idx;  second = min(second, max.NaN(d, best));
//       best = min(best, d)
//     (max.NaN lets a NaN through, so min drops it: NaN never counts).  In
//     ascending tiles with strict <, a triple keeps its lowest index.  At the
//     end each row's eight triples (two parities on four lanes) merge by the
//     exact, order-free rule
//       best = min;  second = min(max(b1, b2), min(s1, s2));
//       idx = the lowest index among equal bests
//     (JAX's fold, nn_bf16.py:110-112), two of them by shuffles, and lane 0
//     of the four writes the chunk's triple to scratch (chunks x N x 12
//     bytes: at horse 48,485 rows, 3 chunks, 1.7 MB).  The last of a scene
//     block's chunk blocks to finish (a counter a scene block, zeroed by the
//     prep kernel) then joins the chunks' triples, a thread a scene row, by
//     the same rule and recomputes d_exact = sqdist_rn(p, model[idx]), so
//     no third launch waits on the host (cow is host-bound: two launches).
//
// The pair axis (the counterpart of JAX's vmap over the pallas_call, as in
// K1 and K3): one launch takes B pairs of (n, 3) scenes and (m, 3) models
// laid out one after another.  The prep kernel stages pair b's records and
// norms at b * m_pad (a whole number of 128-row stages, so every pair's
// ring stays 16-byte aligned) and zeroes its counters; the fold's grid is
// (scene blocks, chunks, B) with the pair in blockIdx.z, and each pair has
// its own counters, chunk triples (B x chunks x n x 12 bytes) and outputs,
// so the last of a scene block's gridDim.y chunk blocks counts its own
// pair's arrivals only.  Indices are pair-local.  The chunk plan sizes one
// wave over B x scene blocks; the result does not depend on it (the merge
// is exact and order-free), so every pair is bit-equal to its own
// single-pair launch, which is the B = 1 case of the same kernels.
//
// Rounding: the tensor cores add the three exact bf16 products (and the
// zero padding) in float32 in their own way, which need not round as the
// plain version's (x + y) + z with two round-to-nearest adds does, so a d~
// may differ from the plain version's by an ulp of the cross term.  The
// bound 2B of the certificate (B = 2^-4 Pmax Mmax) is ~20,000x that.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMTiles = 2;                         // m16 tiles a warp
constexpr int kBlockRows = kWarps * kMTiles * 16;  // 128 scene rows a block
constexpr int kStageRows = 128;                    // model rows a ring stage
constexpr int kNTiles = kStageRows / 8;            // n8 tiles a stage
constexpr int kStages = 4;                         // ring depth: 10 KB of shared memory
constexpr int kNone = 0x7fffffff;                  // index of a triple that saw no d~ < best
constexpr int kMaxPairs = 65535;                   // gridDim.z (fold), gridDim.y (prep)

struct Triple {
  float best, second;
  int idx;
};

// The order-free merge of two triples over disjoint column sets.
__device__ __forceinline__ Triple merge(Triple u, Triple v) {
  const bool take_v = v.best < u.best || (v.best == u.best && v.idx < u.idx);
  return {take_v ? v.best : u.best, fminf(fmaxf(u.best, v.best), fminf(u.second, v.second)),
          take_v ? v.idx : u.idx};
}

__device__ __forceinline__ Triple shfl_xor(Triple t, int mask) {
  return {__shfl_xor_sync(0xffffffffu, t.best, mask),
          __shfl_xor_sync(0xffffffffu, t.second, mask),
          __shfl_xor_sync(0xffffffffu, t.idx, mask)};
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(lo)))
         | (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// c = A (16 x 16, rows of the warp's m-tile) x B (16 x 8); only the low K
// half of A (a_lo: row g, a_hi: row g + 8) and of B (b) is nonzero.
__device__ __forceinline__ void mma_bf16(float (&c)[4], unsigned a_lo, unsigned a_hi, unsigned b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a_lo), "r"(a_hi), "r"(0u), "r"(0u), "r"(b), "r"(0u), "f"(0.f), "f"(0.f), "f"(0.f),
        "f"(0.f));
}

// Pair blockIdx.y: its model staged at pair * m_pad, its counters zeroed.
__global__ void nn_bf16_prep_kernel(const float* __restrict__ model, int m, int m_pad,
                                    uint4* __restrict__ rec, float* __restrict__ norm,
                                    unsigned* __restrict__ arrived, int scene_blocks) {
  const long long pair = blockIdx.y;
  model += pair * 3 * m;
  rec += pair * m_pad;
  norm += pair * m_pad;
  arrived += pair * scene_blocks;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < scene_blocks) arrived[i] = 0u;
  if (i >= m_pad) return;
  if (i < m) {
    const float x = model[3 * i], y = model[3 * i + 1], z = model[3 * i + 2];
    rec[i] = make_uint4(pack_bf16(x, y), pack_bf16(z, 0.f), 0u, 0u);
    norm[i] = norm3_rn(x, y, z);
  } else {
    rec[i] = make_uint4(0u, 0u, 0u, 0u);
    norm[i] = __int_as_float(0x7f800000);
  }
}

// Grid (scene blocks, chunks, pairs): each pointer is offset to pair
// blockIdx.z's slice where it is first used (not all at the top, which
// would keep a dozen 64-bit registers live across the fold); the rest is
// the single-pair fold.
__global__ void __launch_bounds__(kThreads)
nn_bf16_fold_kernel(const float* __restrict__ scene, int n, const float* __restrict__ model,
                    int m, const uint4* __restrict__ rec, const float* __restrict__ norm,
                    int m_pad, int chunk_rows, float* part_best, float* part_second,
                    int* part_idx, unsigned* __restrict__ arrived, int* __restrict__ idx_out,
                    float* __restrict__ best_out, float* __restrict__ second_out,
                    float* __restrict__ dex_out) {
  __shared__ __align__(16) uint4 ring_rec[kStages][kStageRows];
  __shared__ __align__(16) float ring_norm[kStages][kStageRows];
  __shared__ bool last;
  scene += 3LL * n * blockIdx.z;
  rec += static_cast<long long>(m_pad) * blockIdx.z;
  norm += static_cast<long long>(m_pad) * blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int base = blockIdx.y * chunk_rows;  // the chunk's first model row
  const int nb = min(chunk_rows, m_pad - base) / kStageRows;
  const int row0 = blockIdx.x * kBlockRows + warp * (kMTiles * 16);
  const float inf = __int_as_float(0x7f800000);

  // A fragments: words 2t4, 2t4 + 1 of rows g and g + 8 of each m-tile; only
  // k 0..2 are nonzero: (x, y) on lane t4 = 0, (z, 0) on lane t4 = 1.
  unsigned a[kMTiles][2];
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + mt * 16 + g + 8 * h;
      a[mt][h] = 0u;
      if (r < n && t4 < 2) {
        const float* p = scene + 3LL * r;
        a[mt][h] = t4 == 0 ? pack_bf16(p[0], p[1]) : pack_bf16(p[2], 0.f);
      }
    }
  }
  // one triple a (m-tile, row half, column parity); idx = the n8 tile
  float best[kMTiles][2][2], second[kMTiles][2][2];
  int tile[kMTiles][2][2];
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        best[mt][h][q] = second[mt][h][q] = inf;
        tile[mt][h][q] = -1;
      }

  auto issue = [&](int b) {
    const int r0 = base + b * kStageRows;
    for (int t = threadIdx.x; t < kStageRows; t += kThreads)
      cp_async16(&ring_rec[b % kStages][t], rec + r0 + t);
    for (int t = threadIdx.x; t < kStageRows / 4; t += kThreads)
      cp_async16(&ring_norm[b % kStages][4 * t], norm + r0 + 4 * t);
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
    const unsigned* words = reinterpret_cast<const unsigned*>(ring_rec[b % kStages]);
    const float* nrm = ring_norm[b % kStages];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      const unsigned bw = words[4 * (8 * j + g) + t4];
      const float2 nn = *reinterpret_cast<const float2*>(nrm + 8 * j + 2 * t4);
      const int tj = b * kNTiles + j;
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt) {
        float c[4];
        mma_bf16(c, a[mt][0], a[mt][1], bw);
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // c[e]: row half e / 2, column parity e % 2
          const int h = e >> 1, q = e & 1;
          const float d = __fmaf_rn(-2.f, c[e], q ? nn.y : nn.x);
          tile[mt][h][q] = d < best[mt][h][q] ? tj : tile[mt][h][q];
          second[mt][h][q] = fminf(second[mt][h][q], max_nan(d, best[mt][h][q]));
          best[mt][h][q] = fminf(best[mt][h][q], d);
        }
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      Triple u = {inf, inf, kNone};
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int col = tile[mt][h][q] < 0 ? kNone : base + 8 * tile[mt][h][q] + 2 * t4 + q;
        u = merge(u, {best[mt][h][q], second[mt][h][q], col});
      }
      u = merge(u, shfl_xor(u, 1));
      u = merge(u, shfl_xor(u, 2));
      const int r = row0 + mt * 16 + g + 8 * h;
      if (t4 == 0 && r < n) {
        const long long chunk = static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y;
        const long long slot = chunk * n + r;  // the pair's chunks, one after another
        part_best[slot] = u.best;
        part_second[slot] = u.second;
        part_idx[slot] = u.idx;
      }
    }
  }
  // The last of the scene block's chunks to arrive merges their triples (the
  // threadFenceReduction pattern: stores, fence, count; the last block
  // fences and reads the others' stores from L2), in chunk order.  The
  // counter is this pair's: it counts gridDim.y arrivals, its own chunks.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(arrived + static_cast<long long>(blockIdx.z) * gridDim.x + blockIdx.x, 1u)
           == gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  {
    const long long pair = blockIdx.z, parts = pair * gridDim.y * n;  // its chunk triples
    part_best += parts;
    part_second += parts;
    part_idx += parts;
    model += pair * 3 * m;
    idx_out += pair * n;
    best_out += pair * n;
    second_out += pair * n;
    dex_out += pair * n;
  }
  for (int t = threadIdx.x; t < kBlockRows; t += kThreads) {
    const int i = blockIdx.x * kBlockRows + t;
    if (i >= n) break;
    Triple u = {__ldcg(part_best + i), __ldcg(part_second + i), __ldcg(part_idx + i)};
#pragma unroll 4
    for (int c = 1; c < static_cast<int>(gridDim.y); ++c) {
      const long long slot = static_cast<long long>(c) * n + i;
      u = merge(u, {__ldcg(part_best + slot), __ldcg(part_second + slot), __ldcg(part_idx + slot)});
    }
    const int idx = u.best < inf ? u.idx : 0;
    const float* r = model + 3LL * idx;
    idx_out[i] = idx;
    best_out[i] = u.best;
    second_out[i] = u.second;
    dex_out[i] = sqdist_rn(scene[3LL * i], scene[3LL * i + 1], scene[3LL * i + 2],
                           make_float4(r[0], r[1], r[2], 0.f));
  }
}

struct Plan {
  int chunks, chunk_rows, m_pad;
};

// (scene block x model chunk) for `pairs` (n, m) pairs: chunks of whole
// stages, as many as one wave of resident fold blocks over all the pairs'
// scene blocks needs, at least one.
int plan_for(int pairs, int n, int m, Plan* out) {
  static int waves[64];  // the wave of each device, asked once
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int wave = dev < 64 ? waves[dev] : 0;
  if (wave == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, nn_bf16_fold_kernel, kThreads, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    wave = sms * (per_sm > 0 ? per_sm : 1);
    if (dev < 64) waves[dev] = wave;
  }
  const long long blocks = static_cast<long long>(pairs) * ((n + kBlockRows - 1) / kBlockRows);
  const long long stages = (m + kStageRows - 1) / kStageRows;
  long long chunks = (wave + blocks - 1) / blocks;
  chunks = chunks < 1 ? 1 : (chunks > stages ? stages : chunks);
  const long long per = (stages + chunks - 1) / chunks;  // stages a chunk
  out->chunk_rows = static_cast<int>(per * kStageRows);
  out->chunks = static_cast<int>((stages + per - 1) / per);
  out->m_pad = static_cast<int>(stages * kStageRows);
  return 0;
}

bool valid(int pairs, int n, int m) {
  return pairs >= 1 && pairs <= kMaxPairs && n >= 1 && m >= 1;
}

long long scratch_bytes_for(int pairs, int n, const Plan& p) {
  return static_cast<long long>(pairs)
         * (20LL * p.m_pad + 4LL * ((n + kBlockRows - 1) / kBlockRows) + 12LL * p.chunks * n);
}

}  // namespace

// A launch of `pairs` (n, m) pairs: its model chunks, rows a chunk and
// scratch bytes: the staged models (pairs * m_pad 16-byte records, then
// pairs * m_pad norms), a counter a scene block of each pair and the
// chunks' partial triples (pairs * chunks * n bests, seconds, indices).
ICP_EXPORT int nn_bf16_batched_plan(int pairs, int n, int m, int* chunks, int* chunk_rows,
                                    long long* scratch_bytes) {
  if (!valid(pairs, n, m)) return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  const int code = plan_for(pairs, n, m, &p);
  if (code != 0) return code;
  *chunks = p.chunks;
  *chunk_rows = p.chunk_rows;
  *scratch_bytes = scratch_bytes_for(pairs, n, p);
  return 0;
}

// `pairs` (n, 3) scenes and (m, 3) models, each laid out after the other;
// scratch: nn_bf16_batched_plan's bytes, 16-byte aligned; the four outputs
// pairs * n each, the indices pair-local.  A single pair is pairs = 1.
ICP_EXPORT int nn_bf16_batched_launch(const float* scene, int pairs, int n, const float* model,
                                      int m, void* scratch, int* idx_out, float* best_out,
                                      float* second_out, float* dex_out, cudaStream_t stream) {
  if (!valid(pairs, n, m) || reinterpret_cast<unsigned long long>(scratch) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  const int code = plan_for(pairs, n, m, &p);
  if (code != 0) return code;
  const int scene_blocks = (n + kBlockRows - 1) / kBlockRows;
  const long long staged = static_cast<long long>(pairs) * p.m_pad;
  const long long parts = static_cast<long long>(pairs) * p.chunks * n;
  uint4* rec = static_cast<uint4*>(scratch);
  float* norm = reinterpret_cast<float*>(rec + staged);
  unsigned* arrived = reinterpret_cast<unsigned*>(norm + staged);
  float* part_best =
      reinterpret_cast<float*>(arrived + static_cast<long long>(pairs) * scene_blocks);
  float* part_second = part_best + parts;
  int* part_idx = reinterpret_cast<int*>(part_second + parts);
  const int prep_threads = p.m_pad > scene_blocks ? p.m_pad : scene_blocks;
  nn_bf16_prep_kernel<<<dim3((prep_threads + 255) / 256, pairs), 256, 0, stream>>>(
      model, m, p.m_pad, rec, norm, arrived, scene_blocks);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  nn_bf16_fold_kernel<<<dim3(scene_blocks, p.chunks, pairs), kThreads, 0, stream>>>(
      scene, n, model, m, rec, norm, p.m_pad, p.chunk_rows, part_best, part_second, part_idx,
      arrived, idx_out, best_out, second_out, dex_out);
  return static_cast<int>(cudaGetLastError());
}
