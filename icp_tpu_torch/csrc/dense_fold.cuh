// The dense exact-NN fold shared by K1/K10 (nn_dense.cu) and K3
// (icp_fused.cu): a grid of (scene block x model chunk) blocks, each thread
// carrying several scene points against a chunk of model rows streamed
// through shared memory; each point's (least distance, its lowest row) per
// chunk merges into a 64-bit key by atomicMin, so the lowest index of the
// least distance wins whatever order the chunks finish in.  K8
// (nn_chunked.cu) takes the merge and the chunk size.
#pragma once

#include "common.cuh"

namespace dense_fold {

constexpr unsigned long long kEmpty = ~0ull;  // a point no chunk has keyed yet

// The group-of-four update: d[p][u] is point p's distance to row r + u.
// Each point's least of the four is taken first (fminf drops a NaN), and
// only when one beats its point's best are they compared one by one, in
// row order with strict < (a NaN never wins), so the result is the eager
// strict-< fold's, at ~2 compare instructions a pair fewer.
template <int P>
__device__ __forceinline__ void fold4(const float (&d)[P][4], int r, float (&best)[P],
                                      int (&bi)[P]) {
  bool hit = false;
#pragma unroll
  for (int p = 0; p < P; ++p)
    hit |= fminf(fminf(d[p][0], d[p][1]), fminf(d[p][2], d[p][3])) < best[p];
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

// The merge key of a chunk's (least distance, its row): the distance's bits
// mapped so that unsigned order is float order (expansion distances are
// negative for most pairs) in the high word, the row in the low word.  A
// chunk emits one only for a distance < +inf, so the map never gives kEmpty.
__device__ __forceinline__ void merge(unsigned long long* key, float best, int row) {
  if (best < __int_as_float(0x7f800000))
    atomicMin(key, (static_cast<unsigned long long>(ordered_bits(best)) << 32)
                       | static_cast<unsigned>(row));
}

// Model rows a chunk: as many chunks as one wave of resident blocks of
// `kernel` needs beside `scene_blocks`, at least one and at most one a
// `stage_rows` stage; a multiple of the stage.  `waves` caches the wave of
// each device (64 of them), asked once.
template <typename Kernel>
int chunk_rows(Kernel kernel, int threads, int* waves, long long scene_blocks, int m,
               int stage_rows, int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int wave = dev < 64 ? waves[dev] : 0;
  if (wave == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    wave = sms * (per_sm > 0 ? per_sm : 1);
    if (dev < 64) waves[dev] = wave;
  }
  const long long stages = (m + stage_rows - 1) / stage_rows;
  long long chunks = (wave + scene_blocks - 1) / scene_blocks;
  chunks = chunks < 1 ? 1 : (chunks > stages ? stages : chunks);
  const long long per = (m + chunks - 1) / chunks;
  *out = static_cast<int>((per + stage_rows - 1) / stage_rows * stage_rows);
  return 0;
}

}  // namespace dense_fold
