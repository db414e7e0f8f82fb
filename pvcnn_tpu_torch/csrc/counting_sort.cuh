// A stable counting sort of one cloud's points by bin, run by one block of
// kSortThreads: the glue of K1 (voxelize.cu: the points' bin ids) and of K5
// (devoxelize_bwd.cu: the points' clamped base bins).
//
// Three passes over the cloud's counters (nbins + 1 ints, in shared memory
// where they fit, else in the caller's bounds buffer in global memory):
//   1. histogram: cnt[u + 2] counts bin u (the last bin's count is not
//      needed), cnt[0] = cnt[1] = 0;
//   2. scan: each thread sums a run of consecutive counters, one block-wide
//      scan of the 1024 sums, and each thread rewrites its run: now
//      cnt[u + 1] is the first slot of bin u's run;
//   3. placement, in point order: a round of kSortThreads * kSub points,
//      warp w's are the 32 * kSub after the first w warps'. Warp by warp
//      (one block barrier a turn), each warp places its kSub steps of 32
//      points in order: __match_any_sync ranks the lanes that share a bin,
//      and their leader moves the bin's cursor cnt[u + 1] by an atomicAdd
//      that returns the run's next slot (a warp's atomics, ordered by
//      __syncwarp, follow each other without waiting for their results).
//      So the order is the stable sort's, the same every run.
// After the placement each cursor cnt[u + 1] ends bin u's run: cnt is the
// bounds, bin u's run is slots [cnt[u], cnt[u + 1]), and it is copied to the
// caller's bounds buffer where it lived in shared memory.
#pragma once

#include "common.cuh"

namespace pvcnn {

constexpr int kSortThreads = 1024;
constexpr int kSortWarps = kSortThreads / 32;   // 32: one warp scans them
// counters in shared memory up to this many bytes (nbins + 1 ints)
constexpr size_t kMaxSharedCounts = 200 * 1024;

inline bool counts_fit_shared(int nbins) {
  return (static_cast<size_t>(nbins) + 1) * sizeof(int) <= kMaxSharedCounts;
}

// load(i) -> an item whose .key is point i's bin in [0, nbins), or -1 to
// drop the point; emit(item, i, slot) writes point i at its sorted slot.
// cnt: nbins + 1 counters, s_counts (dynamic shared memory) if shared, else
// bounds itself; bounds [nbins + 1] receives the runs' bounds. kSub: the
// 32-point steps a warp places in its turn (each holds kSub items).
template <int kSub, class Load, class Emit>
__device__ void counting_sort(int n, int nbins, bool shared, int* s_counts,
                              int* __restrict__ bounds, Load load,
                              Emit emit) {
  constexpr unsigned kFull = 0xffffffffu;
  __shared__ int s_warp[kSortWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* cnt = shared ? s_counts : bounds;
  // in the bounds buffer, the counters are read from L2, where the
  // histogram's atomics land
  auto count_at = [&](int i) { return shared ? cnt[i] : __ldcg(cnt + i); };

  for (int i = tid; i <= nbins; i += kSortThreads) cnt[i] = 0;
  __syncthreads();
  for (int i = tid; i < n; i += kSortThreads) {
    const int u = load(i).key;
    if (u >= 0 && u + 2 <= nbins) atomicAdd(cnt + u + 2, 1);
  }
  __syncthreads();

  // inclusive scan of cnt[0 .. nbins]: a run of `per` counters a thread
  const int total = nbins + 1;
  const int per = (total + kSortThreads - 1) / kSortThreads;
  const int lo = min(total, tid * per), hi = min(total, lo + per);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += count_at(i);
  int x = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = s_warp[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += y;
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  int run = x - sum + (warp > 0 ? s_warp[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    run += count_at(i);
    cnt[i] = run;
  }
  __syncthreads();

  // stable placement
  using Item = decltype(load(0));
  constexpr int kRound = kSortThreads * kSub;
  for (int i0 = 0; i0 < n; i0 += kRound) {
    const int first = i0 + warp * 32 * kSub;     // this warp's first point
    Item item[kSub];
    unsigned peers[kSub];
    int slot[kSub];
#pragma unroll
    for (int s = 0; s < kSub; ++s) {
      const int i = first + 32 * s + lane;
      item[s].key = -1;
      if (i < n) item[s] = load(i);
      peers[s] = __match_any_sync(kFull, item[s].key);
      slot[s] = 0;
    }
    for (int w = 0; w < kSortWarps && i0 + w * 32 * kSub < n; ++w) {
      if (warp == w) {
#pragma unroll
        for (int s = 0; s < kSub; ++s) {
          const int u = item[s].key;
          if (u >= 0 && lane == __ffs(peers[s]) - 1) {
            slot[s] = atomicAdd(cnt + u + 1, __popc(peers[s]));
          }
          __syncwarp();
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int s = 0; s < kSub; ++s) {
      const int leader = __ffs(peers[s]) - 1;
      const int at = __shfl_sync(kFull, slot[s], leader) +
                     __popc(peers[s] & ((1u << lane) - 1u));
      if (item[s].key >= 0) emit(item[s], first + 32 * s + lane, at);
    }
  }

  if (shared) {
    __syncthreads();
    for (int i = tid; i <= nbins; i += kSortThreads) bounds[i] = cnt[i];
  }
}

}  // namespace pvcnn
