// K6: dense exact k nearest neighbours — for every query point the k point
// indices of the least squared distances, ascending by (d2, index).
//
// Replaces icp_tpu/kernels/knn_pallas.py:59 _knn_kernel (via knn_pallas,
// :90-149), the neighbour search of the normal estimation below 16,384
// points.
//
// What bounds it on the H100: float32 arithmetic — the same 8 operations per
// (query, point) pair as K1 plus one compare against the k-th best; the
// bytes are N*12 + M*12 in and N*k*8 out.  The design: one warp per query.
// Lane l takes point rows l, l+32, ... of 1,024-row float4 tiles that the
// block's 8 warps (8 queries) share in shared memory.  The k-best list
// lives across the warp in SLOTS = ceil(k / 32) register slots a lane
// (a template parameter, 1, 2 or 4, so k <= 128): entry e = 32 s + l is
// slot s of lane l, ascending in e, and every slot index is a compile-time
// constant (a list indexed at run time spills to local memory).  Each
// batch of 32 distances is filtered against entry k-1 (held in every lane)
// with one integer compare and one __ballot_sync, four batches a step for
// independent distance chains; the survivors are inserted in ascending
// lane order: a ballot a slot of the entries ahead of the survivor and
// __popc give its position, __shfl_up_sync moves each slot's tail down one
// place (lane 31 of slot s carries into lane 0 of slot s + 1), and entry
// k-1 is read back with __shfl_sync.
// Every lane runs the same instructions (no divergent insertion chain, no
// per-thread list, no local memory).  An insertion is a chain of dependent
// shuffles and ballots, and in a cloud stored in scan order a query meets
// its neighbours gradually (hundreds of insertions for k = 17), so a first,
// cheap pass bounds the k-th distance: each lane keeps the SLOTS least
// distances of its rows in a quarter of the batches, the lanes' largest
// kept values are sorted across the warp, and the j-th of them, j + 1 =
// ceil(k / SLOTS), has (j + 1) * SLOTS >= k distinct points at or below it.
// The filter then lets through only points within that bound, a few times
// k of them.  The list ends as the k
// smallest (d2, index) pairs under that total order, whatever the insertion
// order: the lowest index wins among equal distances, the order of the JAX
// kernel's lexicographic extraction (knn_pallas.py:39-56).
// Distances are sqdist_rn (no contraction), so the outputs equal the plain
// version's bit for bit.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;  // queries a block
constexpr int kTile = 1024;
constexpr int kUnroll = 4;  // 32-row batches a step: independent distance chains
constexpr int kSeedEvery = 4;  // the bound pass reads one 32-row batch in four
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kEmpty = 0xffffffffu;  // an empty entry: above every distance's bits
constexpr int kMaxK = 128;  // 4 slots a lane

// Distances are compared as their float32 bits: d2 >= 0 orders as an
// unsigned integer (and +inf, then NaN, above every finite distance, as
// torch.sort orders them).  Points are scanned in ascending index, so every
// entry's index is below the candidate's: a candidate beats entry e iff its
// bits are below entry e's, and ties keep the earlier (lower) index.
template <int SLOTS, typename T>
__device__ __forceinline__ T slot_at(const T (&a)[SLOTS], int s) {
  T v = a[0];
#pragma unroll
  for (int t = 1; t < SLOTS; ++t)
    if (t == s) v = a[t];  // selects: no run-time index into the list
  return v;
}

template <int SLOTS>
__global__ void __launch_bounds__(kWarps * 32)
knn_dense_kernel(const float* __restrict__ query, int n, const float* __restrict__ points,
                 int m, int k, float* __restrict__ d2_out, int* __restrict__ idx_out) {
  __shared__ float4 tile[kTile];
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool valid = qi < n;  // uniform in the warp
  const int kslot = (k - 1) >> 5, klane = (k - 1) & 31;  // entry k-1
  float px = 0.f, py = 0.f, pz = 0.f;
  if (valid) {
    px = query[3 * qi];
    py = query[3 * qi + 1];
    pz = query[3 * qi + 2];
  }
  // Bound pass: each lane's SLOTS least distances over rows l, l+128,
  // l+256, ... (every fourth 32-row batch), ascending.  The lanes' last
  // kept values, sorted across the warp: the j-th is at or above
  // (j + 1) * SLOTS distinct points' distances, so with (j + 1) * SLOTS >= k
  // it bounds the k-th nearest distance from above.
  unsigned lim = kEmpty;
  if (valid) {
    unsigned lmin[SLOTS];
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) lmin[s] = kEmpty;
    for (int r = lane; r < m; r += 32 * kSeedEvery) {
      const float4 q = make_float4(__ldg(points + 3 * r), __ldg(points + 3 * r + 1),
                                   __ldg(points + 3 * r + 2), 0.f);
      unsigned v = __float_as_uint(sqdist_rn(px, py, pz, q));
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {  // insert into the lane's ascending few
        const unsigned lo = min(lmin[s], v);
        v = max(lmin[s], v);
        lmin[s] = lo;
      }
    }
    unsigned col = lmin[SLOTS - 1];
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1) {  // bitonic sort across the warp
#pragma unroll
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        const unsigned other = __shfl_xor_sync(kFull, col, stride);
        const bool up = (lane & size) == 0 || size == 32;
        const bool low = (lane & stride) == 0;
        col = low == up ? min(col, other) : max(col, other);
      }
    }
    const unsigned kth = __shfl_sync(kFull, col, (k + SLOTS - 1) / SLOTS - 1);
    lim = kth == kEmpty ? kEmpty : kth + 1;
  }
  unsigned sb[SLOTS];  // this lane's entries: distance bits and index
  int si[SLOTS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    sb[s] = kEmpty;
    si[s] = INT_MAX;
  }
  unsigned kb = lim;  // min(entry k-1's bits, the bound + 1), in every lane
  for (int base = 0; base < m; base += kTile) {
    const int cnt = min(kTile, m - base);
    for (int r = threadIdx.x; r < cnt; r += blockDim.x) {
      const float* src = points + 3 * (base + r);
      tile[r] = make_float4(src[0], src[1], src[2], 0.f);
    }
    __syncthreads();
    if (valid) {
      for (int b = 0; b < cnt; b += 32 * kUnroll) {
        unsigned bits[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int r = b + 32 * u + lane;
          bits[u] = r < cnt ? __float_as_uint(sqdist_rn(px, py, pz, tile[r])) : kEmpty;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          unsigned survivors = __ballot_sync(kFull, bits[u] < kb);
          while (survivors) {
            const int src = __ffs(survivors) - 1;
            survivors &= survivors - 1;
            const unsigned cb = __shfl_sync(kFull, bits[u], src);
            int pos = 0;
#pragma unroll
            for (int s = 0; s < SLOTS; ++s) pos += __popc(__ballot_sync(kFull, sb[s] <= cb));
            if (pos < k) {  // uniform: it still beats entry k-1
              const int ci = base + b + 32 * u + src;
              unsigned carry_b = kEmpty;  // slot s-1's lane 31, before the shift
              int carry_i = INT_MAX;
#pragma unroll
              for (int s = 0; s < SLOTS; ++s) {
                unsigned ub = __shfl_up_sync(kFull, sb[s], 1);
                int ui = __shfl_up_sync(kFull, si[s], 1);
                if (s > 0 && lane == 0) {  // entry 0 is never behind pos
                  ub = carry_b;
                  ui = carry_i;
                }
                if (s + 1 < SLOTS) {
                  carry_b = __shfl_sync(kFull, sb[s], 31);
                  carry_i = __shfl_sync(kFull, si[s], 31);
                }
                const int e = 32 * s + lane;
                if (e == pos) {
                  sb[s] = cb;
                  si[s] = ci;
                } else if (e > pos) {
                  sb[s] = ub;
                  si[s] = ui;
                }
              }
              kb = min(__shfl_sync(kFull, slot_at(sb, kslot), klane), lim);
            }
          }
        }
      }
    }
    __syncthreads();
  }
  if (valid) {
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const int e = 32 * s + lane;
      if (e < k) {
        d2_out[static_cast<long long>(qi) * k + e] = __uint_as_float(sb[s]);
        idx_out[static_cast<long long>(qi) * k + e] = si[s];
      }
    }
  }
}

template <int SLOTS>
int launch(const float* query, int n, const float* points, int m, int k, float* d2_out,
           int* idx_out, cudaStream_t stream) {
  const int blocks = (n + kWarps - 1) / kWarps;
  knn_dense_kernel<SLOTS><<<blocks, kWarps * 32, 0, stream>>>(query, n, points, m, k, d2_out,
                                                              idx_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// k <= kMaxK (128): lists of 1, 2 or 4 slots a lane.
ICP_EXPORT int knn_dense_launch(const float* query, int n, const float* points, int m, int k,
                                float* d2_out, int* idx_out, cudaStream_t stream) {
  if (n < 1 || k < 1 || k > kMaxK || k > m) return static_cast<int>(cudaErrorInvalidValue);
  if (k <= 32) return launch<1>(query, n, points, m, k, d2_out, idx_out, stream);
  if (k <= 64) return launch<2>(query, n, points, m, k, d2_out, idx_out, stream);
  return launch<4>(query, n, points, m, k, d2_out, idx_out, stream);
}
