// K1, K10 and K11: dense exact nearest neighbour — for every scene point the
// model index of the least distance, ties to the lowest index.
//
// K1 replaces icp_tpu/kernels/nn_pallas.py:99 _nn_kernel in its
// distance_impl "vpu" form (the one its entry points use by default): the
// diff-squares distance (dx*dx + dy*dy) + dz*dz.  K10 replaces the same
// kernel in its "mxu" form (nn_pallas.py:105-118): the expansion
// |m|^2 - 2 p.m, whose |p|^2 term cannot change the argmin and is added back
// after the fold when distances are asked for (nn_pallas.py:263-265), with
// no clamp, so that value can be slightly negative.  The JAX package runs
// that form on the TPU's matrix unit at Precision.HIGHEST; here it feeds an
// argmin, so it stays on the float32 units, never TF32 or bf16 tensor
// cores.  One kernel body serves both, with the form as a template
// parameter (Form below).
//
// What bounds it on the H100: float32 arithmetic — K1: 3 subtractions, 3
// multiplications, 2 additions and a compare per (scene, model) pair; K10:
// 3 multiplications, 2 additions, the exact doubling and a subtraction (the
// row's |m|^2, 5 operations, once for the thread's four points).  The bytes
// are N*12 + M*12 in and N*4 (+ N*4) out.  Under --fmad=false each rounding
// is its own instruction, against the bound's 8 at the float32 peak (which
// only multiply-adds reach); a strict-< fold adds a compare and two selects
// a pair (~11 issue slots).  This one takes the least of four rows'
// distances first (3 min instructions a point) and compares row by row only
// when that least beats the point's best: ~9 issue slots a pair, so ~1.2x
// the printed bound is this form's floor.
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
//     rows are read as three float4 loads and folded as a group (above;
//     the group update, the merge and the chunk size are dense_fold.cuh's,
//     shared with K3):
//     in ascending row order with strict <, so a chunk keeps the lowest
//     index of its least distance; the chunks' minima merge into the
//     point's 64-bit key by atomicMin: the distance's bits in the high
//     word, mapped so that unsigned order is float order (ordered_bits in
//     common.cuh: K10's distance is negative for most pairs, K1's never),
//     the model index in the low word, so the lowest index of the least
//     distance wins in any order.  A chunk emits a key only when it found a
//     distance < +inf: NaN never wins, and a point with no such distance
//     keeps the empty key, which the map cannot produce.
//  2. epilogue (a thread a point): writes the index and, when asked, the
//     distance from the key (K10: plus |p|^2); the empty key gives index 0
//     and +inf, as the plain version and the JAX kernel give for such rows.
//
// K11 replaces the same kernel's with_points form (nn_pallas.py:99-101,
// :141-170, its third output at :239-243): the winning model point beside
// the index.  On the TPU that gather is an exact one-hot matmul inside the
// fold, so that no row-gather follows in HBM; here the fold stays K1's, and
// the epilogue's thread that writes idx_out[i] also copies the winner's 12
// bytes, model[3 idx .. 3 idx + 2], to y_out[3i .. 3i + 2]: a plain copy,
// so y is model[idx] bit for bit (the empty key's index 0 gives model[0]).
// What bounds it is K1's fold; the copy adds 12 bytes read and written a
// scene point.  One pair a launch (nn_dense_points_launch), as JAX calls it.
//
// The pair axis (the counterpart of JAX's vmap over the pallas_call): a
// launch takes B pairs of (n, 3) scenes and (m, 3) models laid out one
// after another, and the fold's grid gains blockIdx.z, the pair; each
// block offsets its scene, model and keys by its pair, so every index is
// pair-local and every pair folds exactly as a launch of its own (the keys'
// minimum does not depend on the chunking).  The chunk is sized to one wave
// over B x scene blocks, the keys of all B x n points are cleared by one
// memset and one epilogue covers them all.  A single pair is B = 1.
#include "dense_fold.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kPoints = 4;        // scene points a thread: 512 a block
constexpr int kStageRows = 128;   // model rows a ring stage
constexpr int kStages = 4;        // ring depth: 6 KB of shared memory
constexpr int kStageFloats = 3 * kStageRows;
constexpr unsigned long long kEmpty = dense_fold::kEmpty;

// The distance forms (the C entry points' `form`): 0 diff-squares (K1),
// 1 expansion (K10).
enum Form : int { kDiff = 0, kExpansion = 1 };

// A model row for the fold: (x, y, z) and, for the expansion form, |m|^2.
template <int F>
__device__ __forceinline__ float4 model_row(float x, float y, float z) {
  return make_float4(x, y, z, F == kExpansion ? norm3_rn(x, y, z) : 0.f);
}

template <int F>
__device__ __forceinline__ float dist(float px, float py, float pz, float4 q) {
  return F == kExpansion ? mxudist_rn(px, py, pz, q) : sqdist_rn(px, py, pz, q);
}

template <int F>
__global__ void __launch_bounds__(kThreads)
nn_dense_fold_kernel(const float* __restrict__ scene, int n, const float* __restrict__ model,
                     int m, int chunk_rows, bool aligned16, unsigned long long* __restrict__ keys) {
  constexpr int P = kPoints;
  __shared__ __align__(16) float ring[kStages][kStageFloats];
  const long long pair = blockIdx.z;
  scene += pair * 3 * n;
  model += pair * 3 * m;
  keys += pair * n;
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
    const float* src = model + 3LL * (base + r0);  // 16-byte aligned when aligned16
    float* dst = ring[b % kStages];
    const int n16 = aligned16 ? nf / 4 : 0;
    for (int t = threadIdx.x; t < n16; t += kThreads) cp_async16(dst + 4 * t, src + 4 * t);
    for (int t = 4 * n16 + threadIdx.x; t < nf; t += kThreads) cp_async4(dst + t, src + t);
  };
  auto fold = [&](float x, float y, float z, int r) {
    const float4 q = model_row<F>(x, y, z);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float d = dist<F>(px[p], py[p], pz[p], q);
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
      const float4 q[4] = {model_row<F>(a.x, a.y, a.z), model_row<F>(a.w, c.x, c.y),
                           model_row<F>(c.z, c.w, e.x), model_row<F>(e.y, e.z, e.w)};
      float d[P][4];
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int u = 0; u < 4; ++u) d[p][u] = dist<F>(px[p], py[p], pz[p], q[u]);
      dense_fold::fold4(d, r, best, bi);
    }
    for (int k = 4 * groups; k < cnt; ++k) fold(buf[3 * k], buf[3 * k + 1], buf[3 * k + 2], r0 + k);
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const long long i = static_cast<long long>(blockIdx.x) * (kThreads * P) + p * kThreads
                        + threadIdx.x;
    if (i < n) dense_fold::merge(keys + i, best[p], bi[p]);
  }
}

// add_pn: the expansion form's distance is |m|^2 - 2 p.m; |p|^2 goes back on.
// A thread a point of all the pairs: keys, scene and outputs are (B, n)
// in one run, and a key's index is already pair-local.  y_out (K11, one
// pair, or null): the winner's row of `model`, copied.
__global__ void nn_dense_epilogue_kernel(const unsigned long long* __restrict__ keys,
                                         long long total, const float* __restrict__ scene,
                                         bool add_pn, int* __restrict__ idx_out,
                                         float* __restrict__ d2_out,
                                         const float* __restrict__ model,
                                         float* __restrict__ y_out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const unsigned long long key = keys[i];
  const int idx = key == kEmpty ? 0 : static_cast<int>(static_cast<unsigned>(key));
  idx_out[i] = idx;
  if (y_out) {
    const float* row = model + 3LL * idx;
    y_out[3 * i] = row[0];
    y_out[3 * i + 1] = row[1];
    y_out[3 * i + 2] = row[2];
  }
  if (!d2_out) return;
  if (key == kEmpty) {
    d2_out[i] = __int_as_float(0x7f800000);
    return;
  }
  const float d = from_ordered_bits(static_cast<unsigned>(key >> 32));
  d2_out[i] = add_pn ? __fadd_rn(d, norm3_rn(scene[3 * i], scene[3 * i + 1], scene[3 * i + 2]))
                     : d;
}

using FoldKernel = void (*)(const float*, int, const float*, int, int, bool,
                            unsigned long long*);

FoldKernel fold_kernel(int form) {
  return form == kExpansion ? nn_dense_fold_kernel<kExpansion> : nn_dense_fold_kernel<kDiff>;
}

// Model rows a chunk: one wave of resident fold blocks over all the pairs'
// scene blocks (dense_fold.cuh).
int chunk_rows_for(int pairs, int n, int m, int form, int* out) {
  static int waves[2][64];  // the wave of each form and device, asked once
  const long long scene_blocks = (n + kThreads * kPoints - 1) / (kThreads * kPoints);
  return dense_fold::chunk_rows(fold_kernel(form), kThreads, waves[form],
                                static_cast<long long>(pairs) * scene_blocks, m, kStageRows,
                                out);
}

constexpr int kMaxPairs = 65535;  // gridDim.z

bool valid(int pairs, int n, int m, int form) {
  return pairs >= 1 && pairs <= kMaxPairs && n >= 1 && m >= 1 &&
         (form == kDiff || form == kExpansion);
}

// The memset of the keys, the fold and the epilogue (y_out: K11's points,
// one pair, or null).
int launch(const float* scene, int pairs, int n, const float* model, int m, int form,
           unsigned long long* keys, int* idx_out, float* d2_out, float* y_out,
           cudaStream_t stream) {
  int chunk_rows = 0;
  int code = chunk_rows_for(pairs, n, m, form, &chunk_rows);
  if (code != 0) return code;
  const long long total = static_cast<long long>(pairs) * n;
  cudaError_t e = cudaMemsetAsync(keys, 0xff, sizeof(unsigned long long) * total, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  // each pair's model starts 12 m bytes after the last: 16-byte aligned
  // with the first when m is a multiple of 4
  const bool aligned16 =
      reinterpret_cast<unsigned long long>(model) % 16 == 0 && (pairs == 1 || m % 4 == 0);
  const dim3 grid((n + kThreads * kPoints - 1) / (kThreads * kPoints),
                  (m + chunk_rows - 1) / chunk_rows, pairs);
  fold_kernel(form)<<<grid, kThreads, 0, stream>>>(scene, n, model, m, chunk_rows, aligned16,
                                                   keys);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  nn_dense_epilogue_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, stream>>>(
      keys, total, scene, form == kExpansion, idx_out, d2_out, model, y_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The model rows of one chunk of the fold for a launch of `pairs` (n, m)
// pairs of `form`.
ICP_EXPORT int nn_dense_chunk_rows(int pairs, int n, int m, int form, int* chunk_rows) {
  if (!valid(pairs, n, m, form)) return static_cast<int>(cudaErrorInvalidValue);
  return chunk_rows_for(pairs, n, m, form, chunk_rows);
}

// `pairs` (n, 3) scenes and (m, 3) models, each laid out after the other;
// form: 0 diff-squares (K1), 1 expansion (K10); keys: pairs * n 64-bit
// words of scratch; idx_out (and d2_out, which may be null): pairs * n,
// the indices pair-local.
ICP_EXPORT int nn_dense_launch(const float* scene, int pairs, int n, const float* model, int m,
                               int form, unsigned long long* keys, int* idx_out, float* d2_out,
                               cudaStream_t stream) {
  if (!valid(pairs, n, m, form)) return static_cast<int>(cudaErrorInvalidValue);
  return launch(scene, pairs, n, model, m, form, keys, idx_out, d2_out, nullptr, stream);
}

// K11: an (n, 3) scene against an (m, 3) model in K1's diff-squares form;
// keys: n 64-bit words of scratch; idx_out: n indices; y_out: (n, 3), the
// winners' rows of the model.
ICP_EXPORT int nn_dense_points_launch(const float* scene, int n, const float* model, int m,
                                      unsigned long long* keys, int* idx_out, float* y_out,
                                      cudaStream_t stream) {
  if (!valid(1, n, m, kDiff) || !y_out) return static_cast<int>(cudaErrorInvalidValue);
  return launch(scene, 1, n, model, m, kDiff, keys, idx_out, nullptr, y_out, stream);
}
