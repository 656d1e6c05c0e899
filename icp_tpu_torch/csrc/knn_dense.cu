// K6: dense exact k nearest neighbours — for every query point the k point
// indices of the least squared distances, ascending by (d2, index).
//
// Replaces icp_tpu/kernels/knn_pallas.py:59 _knn_kernel (via knn_pallas,
// :90-149), the neighbour search of the normal estimation below 16,384
// points.
//
// What bounds it on the H100: float32 arithmetic — the same 8 operations per
// (query, point) pair as K1 plus one compare against the k-th best; the
// bytes are N*12 + M*12 in and N*k*8 out.  The design is K1's: one thread
// per query point, held in registers; the points staged through shared
// memory as float4 tiles of 1,024 rows and read by every thread of the
// block as a broadcast.  Where the TPU kernel extracts the k best of each
// (tile x tile) block by k masked minima and merges them with its carry,
// each thread here keeps its k best (d2, index) pairs in registers, sorted,
// and a pair that beats the k-th best sinks into place through a fully
// unrolled compare-and-swap chain (TopK in common.cuh).  The list has a
// compile-time length K in {4, 16, 24, 32}, the smallest that holds k,
// so it never spills to local memory.  Points are scanned in ascending
// index and the chain compares (d2, index) lexicographically, so the lowest
// index wins among equal distances, the order of the JAX kernel's
// lexicographic extraction.  Distances are sqdist_rn (no contraction), so
// indices equal the plain version's bit for bit.
#include <climits>

#include "common.cuh"

namespace {

// 64 threads a block: the normals' clouds start at a few thousand points
// (cow: 46 blocks, where 256 threads would fill 12 of the 132 SMs).
constexpr int kThreads = 64;
constexpr int kTile = 1024;

template <int K>
__global__ void __launch_bounds__(kThreads)
knn_dense_kernel(const float* __restrict__ query, int n, const float* __restrict__ points,
                 int m, int k, float* __restrict__ d2_out, int* __restrict__ idx_out) {
  __shared__ float4 tile[kTile];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool valid = i < n;
  float px = 0.f, py = 0.f, pz = 0.f;
  if (valid) {
    px = query[3 * i];
    py = query[3 * i + 1];
    pz = query[3 * i + 2];
  }
  TopK<K, int> best;
  best.init(__int_as_float(0x7f800000), INT_MAX);  // +inf
  for (int base = 0; base < m; base += kTile) {
    const int cnt = min(kTile, m - base);
    for (int r = threadIdx.x; r < cnt; r += kThreads) {
      const float* src = points + 3 * (base + r);
      tile[r] = make_float4(src[0], src[1], src[2], 0.f);
    }
    __syncthreads();
    if (valid) {
      for (int r = 0; r < cnt; ++r) {
        const float d = sqdist_rn(px, py, pz, tile[r]);
        if (best.beats_kth(d, base + r)) best.insert(d, base + r, k);
      }
    }
    __syncthreads();
  }
  if (valid) {
    float* dst_d = d2_out + static_cast<long long>(i) * k;
    int* dst_i = idx_out + static_cast<long long>(i) * k;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (j < k) {
        dst_d[j] = best.d[j];
        dst_i[j] = best.i[j];
      }
    }
  }
}

template <int K>
void launch(const float* query, int n, const float* points, int m, int k, float* d2_out,
            int* idx_out, cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  knn_dense_kernel<K><<<blocks, kThreads, 0, stream>>>(query, n, points, m, k, d2_out, idx_out);
}

}  // namespace

ICP_EXPORT int knn_dense_launch(const float* query, int n, const float* points, int m, int k,
                                float* d2_out, int* idx_out, cudaStream_t stream) {
  if (n < 1 || k < 1 || k > 32 || k > m) return static_cast<int>(cudaErrorInvalidValue);
  if (k <= 4) {
    launch<4>(query, n, points, m, k, d2_out, idx_out, stream);
  } else if (k <= 16) {
    launch<16>(query, n, points, m, k, d2_out, idx_out, stream);
  } else if (k <= 24) {
    launch<24>(query, n, points, m, k, d2_out, idx_out, stream);
  } else {
    launch<32>(query, n, points, m, k, d2_out, idx_out, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
