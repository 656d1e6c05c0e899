// K7: kd-tile work-list exact k nearest neighbours — each query tile folds
// only the point tiles that can hold one of its points' k nearest.
//
// Replaces icp_tpu/kernels/knn_grid.py:53 _knn_worklist_kernel (via
// _run_worklist and knn_grid, :115-219), the neighbour search of the normal
// estimation from 16,384 points.  The torch side (kernels/knn_grid.py)
// launches it twice: the seed pass over each tile's nearest boxes, then the
// exact pass over the culled candidates, bounded by the seed's k-th
// distance of each point.
//
// What bounds it on the H100: float32 arithmetic over the folded pairs, 8
// operations a pair (horse: ~78 M pairs in both passes, 9 us at the
// float32 peak).  A pair costs ~11 issue slots here (8 roundings under
// --fmad=false, the filter's compare, the ballot and the loop's share), so
// ~1.4x the printed bound is this design's floor; on horse the launches
// are set by latency (the plan's host read, an item's set-up, the sorts)
// rather than by the pairs.
//
// The design, two C calls (the wrapper sizes the merge scratch between
// them, the one host read of a launch):
//  1. plan (one block): each query tile's fold list (its candidates, or all
//     Nj tiles when its count passes the table's capacity) is cut into work
//     items of `g` tiles (`gf` for a list of all tiles, so that a straggler
//     becomes at most a few dozen items); an exclusive scan gives each
//     tile's first item, the total and a zeroed work counter, and a second
//     scan gives the tiles of more than one item their first scratch slot
//     (kernels/knn_grid.py knn_work_items mirrors both).
//  2. fold (persistent blocks, as many as the SMs hold): a block takes the
//     next item from the counter (a 32-way search finds its tile) and
//     streams its tiles through a kStages-deep ring of 128-row float4
//     stages filled by cp.async.  Each warp holds Q queries of the tile
//     (8 at one slot, 4 at more), and for each a k-best list across its 32 lanes
//     in SLOTS = ceil(k / 32) register slots a lane (a template parameter,
//     1, 2 or 4, so k <= 128; entry e = 32 s + l is slot s of lane l, and
//     every slot index is a compile-time constant: a list indexed at run
//     time spills to local memory): one 64-bit key an entry (d2 bits high,
//     original index low), ascending, so the lexicographic (d2, index)
//     order is one compare.  Lane l reads row l of a 32-row batch once and
//     computes its distance to each of the warp's queries (Q independent
//     chains); each query filters the batch with one integer compare
//     against min(entry k-1's bits, its limit) and one ballot.  Survivors
//     are appended to the query's 32-key buffer in shared memory (the
//     ballot's prefix count is a lane's place); a full buffer, and the last
//     at the item's end, is sorted across the warp (bitonic) and merged
//     into the list in one step: the element-wise least of the list and
//     the reversed buffer (which touches the last slot only) holds the
//     32 SLOTS least keys as a bitonic sequence, and log2(32 SLOTS)
//     half-cleaner stages sort it (across slots in registers, within a slot
//     by shuffles).  No lane runs a chain alone, and there is no local
//     memory.  The limit is the caller's bound (the seed pass's k-th
//     distance of the point: every true neighbour is within it, so rows
//     beyond it are no candidates) or, without one, a bound from the
//     lanes' SLOTS least distances over the item's rows (the lanes' last
//     kept values sorted across the warp: the j-th is at or above
//     (j + 1) SLOTS distinct rows, j + 1 = ceil(k / SLOTS), so no row
//     beyond it is among the item's k nearest).  A tile of one item writes
//     its lists to the output; the items of a longer list write theirs to
//     scratch slots.
//  3. merge (a block a query tile of more than one item, a warp a query):
//     the k lexicographically least keys of the query's partial lists, 32
//     keys a sort and merge, into the output.  Every partial list holds its
//     item's k least admitted rows, so the merge is exact, and the result
//     does not depend on the order in which items ran.
// Original indices are exact float32 integers below 2^24 in the tiles' w
// lane; padding rows (3e38) become INT_MAX, as the plain version writes
// them.  An empty slot is (+inf bits, 0xffffffff): after every real row,
// written as d2 = +inf and index -1 (only where fewer than k rows are
// admitted, which a valid bound excludes).
#include <climits>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;         // a block of the fold: Q queries a warp, 8 Q a pass
constexpr int kMaxK = 128;        // 4 slots a lane
constexpr int kStageRows = 128;   // float4 rows a ring stage (tm is a multiple of 128)
constexpr int kStages = 4;        // ring depth: 8 KB of shared memory
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kEmptyBits = 0x7f800000u;  // +inf
constexpr unsigned kEmptyIdx = 0xffffffffu;

// A query tile's fold list: its length and the tiles an item takes.
struct Fold {
  int len, per, items;
};

__device__ __forceinline__ Fold fold_of(int cnt, int cap, int nj, int g, int gf) {
  Fold f;
  f.len = cnt > cap ? nj : max(cnt, 1);
  f.per = cnt > cap ? gf : g;
  f.items = (f.len + f.per - 1) / f.per;
  return f;
}

// Inclusive block scan of two ints (blockDim.x a multiple of 32, <= 1024).
__device__ __forceinline__ int2 block_scan2(int2 v, int2* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int a = __shfl_up_sync(kFull, v.x, o);
    const int b = __shfl_up_sync(kFull, v.y, o);
    if (lane >= o) {
      v.x += a;
      v.y += b;
    }
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int2 w = lane < static_cast<int>(blockDim.x >> 5) ? warp_sums[lane] : make_int2(0, 0);
    int2 s = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int a = __shfl_up_sync(kFull, s.x, o);
      const int b = __shfl_up_sync(kFull, s.y, o);
      if (lane >= o) {
        s.x += a;
        s.y += b;
      }
    }
    warp_sums[lane] = make_int2(s.x - w.x, s.y - w.y);  // exclusive
  }
  __syncthreads();
  return make_int2(v.x + warp_sums[warp].x, v.y + warp_sums[warp].y);
}

// plan[0..ni): each query tile's first item; plan[ni]: the items; plan[ni+1]:
// the fold's work counter, zeroed; plan[ni+2+t]: tile t's first scratch
// slot (tiles of more than one item); plan[2ni+2]: the slots.
__global__ void __launch_bounds__(1024)
knn_grid_plan_kernel(const int* __restrict__ counts, int ni, int cap, int nj, int g, int gf,
                     int* __restrict__ plan) {
  __shared__ int2 warp_sums[32];
  const int per = (ni + blockDim.x - 1) / blockDim.x;
  const int lo = min(ni, static_cast<int>(threadIdx.x) * per);
  const int hi = min(ni, lo + per);
  int2 sum = make_int2(0, 0);
  for (int t = lo; t < hi; ++t) {
    const int items = fold_of(counts[t], cap, nj, g, gf).items;
    sum.x += items;
    sum.y += items > 1 ? items : 0;
  }
  const int2 incl = block_scan2(sum, warp_sums);
  int2 run = make_int2(incl.x - sum.x, incl.y - sum.y);
  for (int t = lo; t < hi; ++t) {
    const int items = fold_of(counts[t], cap, nj, g, gf).items;
    plan[t] = run.x;
    plan[ni + 2 + t] = run.y;
    run.x += items;
    run.y += items > 1 ? items : 0;
  }
  if (threadIdx.x == blockDim.x - 1) {
    plan[ni] = run.x;
    plan[ni + 1] = 0;
    plan[2 * ni + 2] = run.y;
  }
}

using u64 = unsigned long long;
constexpr u64 kEmptyKey = (static_cast<u64>(kEmptyBits) << 32) | kEmptyIdx;
constexpr u64 kNoKey = ~0ull;  // a buffer's unused place: after every key

__device__ __forceinline__ u64 umin64(u64 a, u64 b) { return a < b ? a : b; }
__device__ __forceinline__ u64 umax64(u64 a, u64 b) { return a < b ? b : a; }
__device__ __forceinline__ unsigned key_bits(u64 key) { return static_cast<unsigned>(key >> 32); }

// Ascending bitonic sort of one value a lane across the warp.
template <typename T>
__device__ __forceinline__ T warp_sort(T v, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const T other = __shfl_xor_sync(kFull, v, stride);
      const bool up = (lane & size) == 0;  // the last size sorts the whole warp ascending
      const bool low = (lane & stride) == 0;
      const T lo = v < other ? v : other;
      const T hi = v < other ? other : v;
      v = low == up ? lo : hi;
    }
  }
  return v;
}

// Entry s of a lane's slots, selected without a run-time index.
template <int S>
__device__ __forceinline__ u64 slot_at(const u64 (&key)[S], int s) {
  u64 v = key[0];
#pragma unroll
  for (int t = 1; t < S; ++t)
    if (t == s) v = key[t];
  return v;
}

// Entry k-1 of the list, in every lane.
template <int S>
__device__ __forceinline__ u64 kth_key(const u64 (&key)[S], int k) {
  return __shfl_sync(kFull, slot_at(key, (k - 1) >> 5), (k - 1) & 31);
}

// The list (entry e = 32 s + lane, ascending) becomes the 32 S least keys
// of itself and the sorted batch b (one key a lane): the element-wise least
// of the list and b reversed (b's 32 keys, reversed, face the last slot;
// the rest of the reversed batch is empty) is a bitonic sequence that holds
// them, and the half-cleaner stages sort it: strides of 32 and more across
// slots in registers, then five shuffle stages within each slot.
template <int S>
__device__ __forceinline__ void list_merge(u64 (&key)[S], u64 b, int lane) {
  key[S - 1] = umin64(key[S - 1], __shfl_sync(kFull, b, 31 - lane));
#pragma unroll
  for (int half = S / 2; half > 0; half >>= 1) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if ((s & half) == 0) {
        const u64 lo = umin64(key[s], key[s + half]);
        key[s + half] = umax64(key[s], key[s + half]);
        key[s] = lo;
      }
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int stride = 16; stride > 0; stride >>= 1) {
      const u64 other = __shfl_xor_sync(kFull, key[s], stride);
      key[s] = (lane & stride) == 0 ? umin64(key[s], other) : umax64(key[s], other);
    }
  }
}

// One query's k-best list across the warp (S slots a lane, ascending by
// (d2 bits, original index)), its filter kb = min(entry k-1's bits, lim)
// and its buffer of admitted rows in shared memory (cnt of 32 used).
template <int S>
struct QueryList {
  u64 key[S];
  unsigned kb;
  int cnt;

  // Merge the buffer into the list and tighten the filter.
  __device__ __forceinline__ void flush(const u64* buf, unsigned lim, int k, int lane) {
    __syncwarp();
    const u64 b = lane < cnt ? buf[lane] : kNoKey;
    list_merge(key, warp_sort(b, lane), lane);
    kb = min(lim, key_bits(kth_key(key, k)));
    cnt = 0;
    __syncwarp();
  }

  // Append the lanes' rows flagged in `surv` (flushing first if they do not
  // fit): their positions are the counts of the flagged lanes before them.
  __device__ __forceinline__ void append(u64* buf, unsigned lim, unsigned surv, u64 row_key,
                                         int k, int lane) {
    const int n = __popc(surv);
    if (cnt + n > 32) flush(buf, lim, k, lane);
    if ((surv >> lane) & 1u) buf[cnt + __popc(surv & ((1u << lane) - 1u))] = row_key;
    cnt += n;
  }
};

__device__ __forceinline__ unsigned row_index(float w) {
  return w < 16777216.f ? static_cast<unsigned>(w) : static_cast<unsigned>(INT_MAX);
}

template <int S, int Q>
__global__ void __launch_bounds__(kWarps * 32)
knn_grid_fold_kernel(const int* __restrict__ cand, const int* __restrict__ counts, int ni, int cap,
                     int g, int gf, const float* __restrict__ query,
                     const float* __restrict__ bound, int tn, int nj, int tm,
                     const float4* __restrict__ tiles, int k, int* __restrict__ plan,
                     u64* __restrict__ scratch, float* __restrict__ d2_out,
                     int* __restrict__ idx_out) {
  constexpr int kGroup = kWarps * Q;  // queries a block folds in one pass over its rows
  __shared__ __align__(16) float4 ring[kStages][kStageRows];
  __shared__ u64 s_buf[kGroup][32];   // each query's buffer of admitted rows
  __shared__ unsigned s_lim[kGroup];  // each query's limit
  __shared__ int s_item, s_ti;
  const int total = plan[ni];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nb = tm / kStageRows;  // ring stages a tile

  for (;;) {
    if (warp == 0) {
      int item = 0;
      if (lane == 0) item = atomicAdd(plan + ni + 1, 1);
      item = __shfl_sync(kFull, item, 0);
      if (item < total) {
        // the last tile whose first item is <= item: a 32-way search, one
        // round of loads a level (3 rounds for 32,768 tiles)
        int lo = 0, span = ni;
        while (span > 1) {
          const int step = (span + 31) / 32;
          const int t = lo + lane * step;
          const bool le = t < lo + span && plan[t] <= item;
          const int last = 31 - __clz(__ballot_sync(kFull, le));  // lane 0 always holds
          lo += last * step;
          span = min(step, span - last * step);
        }
        if (lane == 0) s_ti = lo;
      }
      if (lane == 0) s_item = item;
    }
    __syncthreads();
    const int item = s_item;
    if (item >= total) break;
    const int ti = s_ti;
    const int cnt = counts[ti];
    const Fold f = fold_of(cnt, cap, nj, g, gf);
    const int c = item - plan[ti];  // the c-th item of the tile's fold list
    const int t0 = c * f.per;
    const int n_tiles = min(f.len, t0 + f.per) - t0;
    const int stages = n_tiles * nb;
    auto tile_of = [&](int t) { return cnt > cap ? t : cand[ti * cap + t]; };
    auto issue = [&](int s) {
      const float4* src = tiles + static_cast<long long>(tile_of(t0 + s / nb)) * tm
                          + (s % nb) * kStageRows;
      float4* dst = ring[s % kStages];
      for (int r = threadIdx.x; r < kStageRows; r += blockDim.x) cp_async16(dst + r, src + r);
    };

    for (int q0 = 0; q0 < tn; q0 += kGroup) {  // one pass over the rows a group of queries
      const int qw = q0 + warp * Q;             // the warp's first query
      const int nq = max(0, min(Q, tn - qw));   // uniform in the warp
      unsigned* lim = s_lim + warp * Q;
      u64* const buf = &s_buf[warp * Q][0];  // query j's buffer: buf + 32 * j
      float px[Q], py[Q], pz[Q];
      QueryList<S> L[Q];
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        const long long row = static_cast<long long>(ti) * tn + qw + j;
        px[j] = j < nq ? query[3 * row] : 0.f;
        py[j] = j < nq ? query[3 * row + 1] : 0.f;
        pz[j] = j < nq ? query[3 * row + 2] : 0.f;
#pragma unroll
        for (int s = 0; s < S; ++s) L[j].key[s] = kEmptyKey;
        L[j].cnt = 0;
        L[j].kb = bound != nullptr && j < nq ? min(kEmptyBits, __float_as_uint(bound[row]))
                                             : kEmptyBits;
      }
      if (bound == nullptr && nq > 0) {
        // each lane's S least distances over its rows of the item (distinct
        // rows), ascending; the lanes' last kept values sorted across the
        // warp bound the item's k-th distance
        unsigned lmin[Q][S];
#pragma unroll
        for (int j = 0; j < Q; ++j)
#pragma unroll
          for (int s = 0; s < S; ++s) lmin[j][s] = kFull;
        for (int t = 0; t < n_tiles; ++t) {
          const float4* rows = tiles + static_cast<long long>(tile_of(t0 + t)) * tm;
#pragma unroll 4
          for (int r = lane; r < tm; r += 32) {
            const float4 q = __ldg(rows + r);
#pragma unroll
            for (int j = 0; j < Q; ++j) {
              unsigned v = __float_as_uint(sqdist_rn(px[j], py[j], pz[j], q));
#pragma unroll
              for (int s = 0; s < S; ++s) {
                const unsigned lo = min(lmin[j][s], v);
                v = max(lmin[j][s], v);
                lmin[j][s] = lo;
              }
            }
          }
        }
        const int kr = (k + S - 1) / S - 1;
#pragma unroll
        for (int j = 0; j < Q; ++j)  // no branch: the Q sorts interleave
          L[j].kb = min(kEmptyBits, __shfl_sync(kFull, warp_sort(lmin[j][S - 1], lane), kr));
      }
#pragma unroll
      for (int j = 0; j < Q; ++j)
        if (j < nq && lane == 0) lim[j] = L[j].kb;
      __syncwarp();

#pragma unroll
      for (int s = 0; s < kStages - 1; ++s) {
        if (s < stages) issue(s);
        cp_async_commit();
      }
      for (int s = 0; s < stages; ++s) {
        cp_async_wait<kStages - 2>();  // stage s has landed (this thread's copies)
        __syncthreads();               // ... everyone's; stage s-1 is no longer read
        if (s + kStages - 1 < stages) issue(s + kStages - 1);
        cp_async_commit();
        const float4* ring_s = ring[s % kStages];
        for (int r0 = 0; r0 < kStageRows; r0 += 32) {
          const float4 q = ring_s[r0 + lane];
          // every query's distance and filter first (independent chains),
          // then the appends of the few survivors
          unsigned bits[Q], surv[Q], any = 0;
#pragma unroll
          for (int j = 0; j < Q; ++j) bits[j] = __float_as_uint(sqdist_rn(px[j], py[j], pz[j], q));
#pragma unroll
          for (int j = 0; j < Q; ++j) {
            surv[j] = j < nq ? __ballot_sync(kFull, bits[j] <= L[j].kb) : 0u;
            any |= surv[j];
          }
          if (any) {
            const unsigned ri = row_index(q.w);
#pragma unroll
            for (int j = 0; j < Q; ++j) {
              const u64 row_key = (static_cast<u64>(bits[j]) << 32) | ri;
              if (surv[j]) L[j].append(buf + 32 * j, lim[j], surv[j], row_key, k, lane);
            }
          }
        }
      }
      cp_async_wait<0>();  // no copy of this pass stays in flight

#pragma unroll
      for (int j = 0; j < Q; ++j)  // no branch: the Q sorts and merges interleave
        L[j].flush(buf + 32 * j, lim[j], k, lane);
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        if (j < nq) {
          const long long qi = qw + j;
#pragma unroll
          for (int s = 0; s < S; ++s) {
            const int e = 32 * s + lane;
            if (e >= k) continue;
            if (f.items == 1) {
              const long long o = (static_cast<long long>(ti) * tn + qi) * k + e;
              d2_out[o] = __uint_as_float(key_bits(L[j].key[s]));
              idx_out[o] = static_cast<int>(static_cast<unsigned>(L[j].key[s]));
            } else {
              const long long slot = plan[ni + 2 + ti] + c;
              scratch[(slot * tn + qi) * k + e] = L[j].key[s];
            }
          }
        }
      }
      __syncthreads();  // the ring, buffers and limits are rewritten by the next pass
    }
  }
}

template <int S>
__global__ void __launch_bounds__(256)
knn_grid_merge_kernel(const int* __restrict__ counts, int ni, int cap, int g, int gf, int tn,
                      int nj, int k, const int* __restrict__ plan,
                      const u64* __restrict__ scratch, float* __restrict__ d2_out,
                      int* __restrict__ idx_out) {
  const int ti = blockIdx.x;
  const Fold f = fold_of(counts[ti], cap, nj, g, gf);
  if (f.items == 1) return;  // written by its one item
  const int lane = threadIdx.x & 31;
  const long long slot0 = plan[ni + 2 + ti];
  const int n_keys = f.items * k;
  for (int qi = threadIdx.x >> 5; qi < tn; qi += blockDim.x >> 5) {
    u64 list[S];
#pragma unroll
    for (int s = 0; s < S; ++s) list[s] = kEmptyKey;
    unsigned kb = kEmptyBits;
    for (int e0 = 0; e0 < n_keys; e0 += 32) {
      const int e = e0 + lane;
      u64 key = e < n_keys ? scratch[((slot0 + e / k) * tn + qi) * k + e % k] : kNoKey;
      if (key == kEmptyKey || key_bits(key) > kb) key = kNoKey;
      if (__ballot_sync(kFull, key != kNoKey)) {  // 32 partial keys a step
        list_merge(list, warp_sort(key, lane), lane);
        kb = key_bits(kth_key(list, k));
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int e = 32 * s + lane;
      if (e < k) {
        const long long o = (static_cast<long long>(ti) * tn + qi) * k + e;
        d2_out[o] = __uint_as_float(key_bits(list[s]));
        idx_out[o] = static_cast<int>(static_cast<unsigned>(list[s]));
      }
    }
  }
}

// Blocks of `threads` threads of the fold kernel with S slots the card
// holds at once (the SMs' count times the blocks an SM holds), asked once
// a device and instantiation.
template <int S, typename F>
int resident_blocks(F kernel, int threads, int* out) {
  static int cached[64][2];  // (threads, blocks) per device, one table per S
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 64 && cached[dev][0] == threads) {
    *out = cached[dev][1];
    return 0;
  }
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  *out = sms * max(per_sm, 1);
  if (dev < 64) {
    cached[dev][1] = *out;
    cached[dev][0] = threads;
  }
  return 0;
}

// The fold and, where a tile has more than one item, the merge, with S
// slots a lane (Q = 8 queries a warp at one slot, 4 at two and four: at
// two slots and 8 queries ptxas spills the lists at its 128 registers).
template <int S>
int fold_and_merge(const int* cand, const int* counts, int ni, int cap, int g, int gf,
                   const float* query, const float* bound, int tn, int nj, int tm,
                   const float4* tiles, int k, int* plan, int items, unsigned long long* scratch,
                   float* d2_out, int* idx_out, cudaStream_t stream) {
  constexpr int Q = S >= 2 ? 4 : 8;
  const int threads = (min(tn, kWarps * Q) + Q - 1) / Q * 32;
  int resident = 0;  // persistent: at most one block an item
  int code = resident_blocks<S>(knn_grid_fold_kernel<S, Q>, threads, &resident);
  if (code != 0) return code;
  knn_grid_fold_kernel<S, Q><<<min(items, resident), threads, 0, stream>>>(
      cand, counts, ni, cap, g, gf, query, bound, tn, nj, tm, tiles, k, plan, scratch, d2_out,
      idx_out);
  code = static_cast<int>(cudaGetLastError());
  if (code != 0 || scratch == nullptr) return code;
  knn_grid_merge_kernel<S><<<ni, 256, 0, stream>>>(counts, ni, cap, g, gf, tn, nj, k, plan,
                                                   scratch, d2_out, idx_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// plan: 2 * ni + 3 ints of scratch; totals (host): the items and the scratch
// slots.  Waits for the plan on the stream.
ICP_EXPORT int knn_grid_plan(const int* counts, int ni, int cap, int nj, int g, int gf, int* plan,
                             int* totals, cudaStream_t stream) {
  if (ni < 1 || cap < 1 || g < 1 || gf < 1) return static_cast<int>(cudaErrorInvalidValue);
  knn_grid_plan_kernel<<<1, 1024, 0, stream>>>(counts, ni, cap, nj, g, gf, plan);
  cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess)
    e = cudaMemcpyAsync(totals, plan + ni, sizeof(int), cudaMemcpyDeviceToHost, stream);
  if (e == cudaSuccess)
    e = cudaMemcpyAsync(totals + 1, plan + 2 * ni + 2, sizeof(int), cudaMemcpyDeviceToHost,
                        stream);
  if (e == cudaSuccess) e = cudaStreamSynchronize(stream);
  return static_cast<int>(e);
}

// items: the plan's total; scratch: its slots x tn x k 64-bit words (null
// when there are none); bound: (ni * tn,) float32 or null; k <= kMaxK.
ICP_EXPORT int knn_grid_launch(const int* cand, const int* counts, int ni, int cap, int g, int gf,
                               const float* query, const float* bound, int tn, int nj, int tm,
                               const float4* tiles, int k, int* plan, int items,
                               unsigned long long* scratch, float* d2_out, int* idx_out,
                               cudaStream_t stream) {
  if (ni < 1 || tn < 1 || k < 1 || k > kMaxK || tm % kStageRows != 0 || items < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (k <= 32)
    return fold_and_merge<1>(cand, counts, ni, cap, g, gf, query, bound, tn, nj, tm, tiles, k,
                             plan, items, scratch, d2_out, idx_out, stream);
  if (k <= 64)
    return fold_and_merge<2>(cand, counts, ni, cap, g, gf, query, bound, tn, nj, tm, tiles, k,
                             plan, items, scratch, d2_out, idx_out, stream);
  return fold_and_merge<4>(cand, counts, ni, cap, g, gf, query, bound, tn, nj, tm, tiles, k,
                           plan, items, scratch, d2_out, idx_out, stream);
}
