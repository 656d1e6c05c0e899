// K1: dense exact nearest neighbour — for every scene point the model index
// of the least squared distance, ties to the lowest index.
//
// Replaces icp_tpu/kernels/nn_pallas.py:99 _nn_kernel (the distance_impl
// "vpu" form its entry points use by default).
//
// What bounds it on the H100: float32 arithmetic — 3 subtractions, 3
// multiplications, 2 additions and a compare per (scene, model) pair; the
// bytes are N*12 + M*12 in and N*4 (+ N*4) out.  Under --fmad=false each
// of the 8 roundings is its own instruction, against the bound's 8 at the
// float32 peak (which only multiply-adds reach); a strict-< fold adds a
// compare and two selects a pair (~11 issue slots).  This one takes the
// least of four rows' distances first (3 min instructions a point) and
// compares row by row only when that least beats the point's best: ~9
// issue slots a pair, so ~1.2x the printed bound is this form's floor.
//
// The design, one C call: a memset of the keys, then two kernels.
//  1. fold: a grid of (scene block x model chunk) blocks, so that small
//     scenes still fill the card (cow's 2,903 points make 6 scene blocks;
//     the model is cut into as many chunks of whole 128-row stages as one
//     wave of resident blocks needs, at least one, nn_dense_chunk_rows).
//     A thread holds kPoints = 4 scene points, so one broadcast
//     shared-memory row feeds four independent compare chains.  The chunk
//     streams through a kStages-deep ring of 128-row stages filled by
//     cp.async (the next stages load while this one is folded), copied as
//     the raw (x, y, z) floats: 16 bytes at a time where the model is
//     16-byte aligned (a stage of 128 rows is 1,536 bytes), else 4.  Four
//     rows are read as three float4 loads and folded as a group (above):
//     in ascending row order with strict <, so a chunk keeps the lowest
//     index of its least distance; the chunks' minima merge into the point's 64-bit key by
//     atomicMin: d2's float bits (d2 >= 0 orders as an unsigned integer)
//     in the high word, the model index in the low word, so the lowest
//     index of the least distance wins in any order.  A chunk emits a key
//     only when it found d2 < +inf: NaN never wins, and a point with no
//     finite distance keeps the empty key.
//  2. epilogue (a thread a point): writes the index and, when asked, d2
//     from the key; the empty key gives index 0 and d2 = +inf, as the
//     plain version and the JAX kernel give for such rows.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kPoints = 4;        // scene points a thread: 512 a block
constexpr int kStageRows = 128;   // model rows a ring stage
constexpr int kStages = 4;        // ring depth: 6 KB of shared memory
constexpr int kStageFloats = 3 * kStageRows;
constexpr unsigned long long kEmpty = ~0ull;

__global__ void __launch_bounds__(kThreads)
nn_dense_fold_kernel(const float* __restrict__ scene, int n, const float* __restrict__ model,
                     int m, int chunk_rows, bool aligned16, unsigned long long* __restrict__ keys) {
  constexpr int P = kPoints;
  __shared__ __align__(16) float ring[kStages][kStageFloats];
  const int base = blockIdx.y * chunk_rows;  // the chunk's first model row
  const int rows = min(chunk_rows, m - base);
  const int nb = (rows + kStageRows - 1) / kStageRows;
  const float inf = __int_as_float(0x7f800000);

  float px[P], py[P], pz[P], best[P];
  int bi[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const long long i = static_cast<long long>(blockIdx.x) * (kThreads * P) + p * kThreads
                        + threadIdx.x;
    px[p] = i < n ? scene[3 * i] : 0.f;
    py[p] = i < n ? scene[3 * i + 1] : 0.f;
    pz[p] = i < n ? scene[3 * i + 2] : 0.f;
    best[p] = inf;
    bi[p] = 0;
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
  auto fold = [&](float x, float y, float z, int r) {
    const float4 q = make_float4(x, y, z, 0.f);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float d = sqdist_rn(px[p], py[p], pz[p], q);
      if (d < best[p]) {
        best[p] = d;
        bi[p] = r;
      }
    }
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
    const float4* buf4 = reinterpret_cast<const float4*>(buf);
    const int cnt = min(kStageRows, rows - b * kStageRows);
    const int r0 = base + b * kStageRows;
    const int groups = cnt / 4;
#pragma unroll 2
    for (int g = 0; g < groups; ++g) {  // rows 4g..4g+3 are floats 12g..12g+11
      const float4 a = buf4[3 * g], c = buf4[3 * g + 1], e = buf4[3 * g + 2];
      const int r = r0 + 4 * g;
      const float4 q[4] = {make_float4(a.x, a.y, a.z, 0.f), make_float4(a.w, c.x, c.y, 0.f),
                           make_float4(c.z, c.w, e.x, 0.f), make_float4(e.y, e.z, e.w, 0.f)};
      // the four distances of each point, and their least: only when it
      // beats a point's best (rarely) are they compared one by one, in row
      // order, so the result is the eager strict-< fold's
      float d[P][4];
      bool hit = false;
#pragma unroll
      for (int p = 0; p < P; ++p) {
#pragma unroll
        for (int u = 0; u < 4; ++u) d[p][u] = sqdist_rn(px[p], py[p], pz[p], q[u]);
        hit |= fminf(fminf(d[p][0], d[p][1]), fminf(d[p][2], d[p][3])) < best[p];
      }
      if (hit) {
#pragma unroll
        for (int p = 0; p < P; ++p) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (d[p][u] < best[p]) {
              best[p] = d[p][u];
              bi[p] = r + u;
            }
          }
        }
      }
    }
    for (int k = 4 * groups; k < cnt; ++k) fold(buf[3 * k], buf[3 * k + 1], buf[3 * k + 2], r0 + k);
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const long long i = static_cast<long long>(blockIdx.x) * (kThreads * P) + p * kThreads
                        + threadIdx.x;
    if (i < n && best[p] < inf) {
      const unsigned long long key =
          (static_cast<unsigned long long>(__float_as_uint(best[p])) << 32)
          | static_cast<unsigned>(bi[p]);
      atomicMin(keys + i, key);
    }
  }
}

__global__ void nn_dense_epilogue_kernel(const unsigned long long* __restrict__ keys, int n,
                                         int* __restrict__ idx_out, float* __restrict__ d2_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned long long key = keys[i];
  idx_out[i] = key == kEmpty ? 0 : static_cast<int>(static_cast<unsigned>(key));
  if (d2_out)
    d2_out[i] = key == kEmpty ? __int_as_float(0x7f800000)
                              : __uint_as_float(static_cast<unsigned>(key >> 32));
}

// Model rows a chunk: one wave of resident fold blocks, at least one chunk
// and at most one a 128-row stage; a multiple of the stage.
int chunk_rows_for(int n, int m, int* out) {
  static int waves[64];  // the wave of each device, asked once
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int wave = dev < 64 ? waves[dev] : 0;
  if (wave == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, nn_dense_fold_kernel, kThreads, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    wave = sms * (per_sm > 0 ? per_sm : 1);
    if (dev < 64) waves[dev] = wave;
  }
  const long long scene_blocks = (n + kThreads * kPoints - 1) / (kThreads * kPoints);
  const long long stages = (m + kStageRows - 1) / kStageRows;
  long long chunks = (wave + scene_blocks - 1) / scene_blocks;
  chunks = chunks < 1 ? 1 : (chunks > stages ? stages : chunks);
  const long long per = (m + chunks - 1) / chunks;
  *out = static_cast<int>((per + kStageRows - 1) / kStageRows * kStageRows);
  return 0;
}

}  // namespace

// The model rows of one chunk of the fold for an (n, m) launch.
ICP_EXPORT int nn_dense_chunk_rows(int n, int m, int* chunk_rows) {
  if (n < 1 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  return chunk_rows_for(n, m, chunk_rows);
}

// keys: n 64-bit words of scratch; d2_out may be null.
ICP_EXPORT int nn_dense_launch(const float* scene, int n, const float* model, int m,
                               unsigned long long* keys, int* idx_out, float* d2_out,
                               cudaStream_t stream) {
  if (n < 1 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  int chunk_rows = 0;
  int code = chunk_rows_for(n, m, &chunk_rows);
  if (code != 0) return code;
  cudaError_t e = cudaMemsetAsync(keys, 0xff, sizeof(unsigned long long) * n, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool aligned16 = reinterpret_cast<unsigned long long>(model) % 16 == 0;
  const dim3 grid((n + kThreads * kPoints - 1) / (kThreads * kPoints),
                  (m + chunk_rows - 1) / chunk_rows);
  nn_dense_fold_kernel<<<grid, kThreads, 0, stream>>>(scene, n, model, m, chunk_rows, aligned16,
                                                      keys);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  nn_dense_epilogue_kernel<<<(n + 255) / 256, 256, 0, stream>>>(keys, n, idx_out, d2_out);
  return static_cast<int>(cudaGetLastError());
}
