// quorum_slice: the vectorized gang-quorum pass, written for Hopper
// (sm_90a).
//
// It replaces kube_scheduler_simulator_tpu/framework/gang.py:195
// `quorum_slice` (B8): over one pending slice of n pods with wave-local
// group ids gid[n] (-1 ungrouped) and replayed selections selected[n]
// (-1 infeasible), and per group G the members already waiting or bound
// and minMember,
//
//   feas[i]  = selected[i] >= 0 and gid[i] >= 0
//   wave[g]  = sum of feas over the members of g     (segment_sum)
//   admit[g] = wave[g] + already[g] >= min_member[g]
//   cf       = inclusive cumsum of feas
//   first[g] = the lowest slice index of g            (segment_min; an
//              empty segment gives INT_MAX, clipped to n - 1)
//   gbase[g] = cf[first[g]] - feas[first[g]]
//   rank[i]  = cf[i] - gbase[gid[i]]                  (gid -1 reads g 0)
//   wait[i]  = feas[i] and already[g] + rank[i] < min_member[g]
//
// exactly as the JAX package computes it, in int32, on any gid layout:
// groups absent from the slice, split into several runs or interleaved
// with others (rank is then the formula's, not a count of the group's
// own members, as in the reference).  n == 0 or G == 0 never reaches the
// kernel: the wrapper answers it (gang.py:222-223).
//
// What bounds it on this card: its launch, then one SM's instruction
// issue.  A wave's slice is at most ~10^4 pods, 8 bytes in and 4 out per
// pod, 16 a group: well under a microsecond of bandwidth, less than a
// launch, and a few tens of instructions a row of 32 pods.  So it is one
// CTA of 1024 threads that waits on as few round trips as it can:
//
//   * the tables (per group the feasible count, the first index and then
//     gbase, already and min_member, 16 bytes; per pod its gid, 4 bytes;
//     per 32 pods a feasibility word and its exclusive prefix, 8 bytes)
//     live in shared memory wherever they fit (60 KB at phase 18's n =
//     10,000 and G = 1,250; kernels/gang.py quorum_path picks the path
//     from (n, G)), else in the wrapper's scratch in device memory, by the
//     same code;
//   * the input is read once, in two overlapping round trips: warp w
//     reads pods [32 k + 32 w ...) coalesced, GANG_UNROLL rows of 32 in
//     flight a lane, issued before the group rows are copied in; after
//     that every pass reads only the tables;
//   * a ballot makes a row's feasibility word; a run of one group's pods
//     in a row adds its count and its first index with one atomic each
//     (its first lane), ungrouped pods none;
//   * cf at any pod is its word's prefix plus a popcount within the word,
//     so the cumsum is a block scan over n / 32 words, not over n pods.
#include <climits>

#include "cluster.cuh"

#define GANG_THREADS 1024
#define GANG_UNROLL 8  // rows of 32 pods a warp loads before it uses them

// The tables, in ints: seg_wave [G], seg_first / gbase [G], already [G],
// min_member [G], the slice's gid [n], the feasibility words [W] and
// their prefix [W], W = ceil(n / 32) (kernels/gang.py quorum_tables
// mirrors it).
__host__ __device__ inline long long quorum_table_ints(int n, int G) {
  return 4LL * G + n + 2LL * ((n + 31) / 32);
}

// in: gid[n], selected[n], already[G], min_member[G] (one int32 buffer)
// out: admit[G], wave[G], wait[n] (one int32 buffer)
// tables: dynamic shared memory (SMEM) or `scratch`
template <bool SMEM>
__global__ void __launch_bounds__(GANG_THREADS) quorum_slice_kernel(const int* __restrict__ in,
                                                                    int n, int G,
                                                                    int* __restrict__ out,
                                                                    int* scratch) {
  extern __shared__ int dyn[];
  __shared__ int sh_warp[GANG_THREADS / 32];
  const unsigned full = 0xffffffffu;
  const int* gid = in;
  const int* selected = in + n;
  const int* already = in + 2 * n;
  const int* min_member = in + 2 * n + G;
  int* admit = out;
  int* wave_out = out + G;
  int* wait = out + 2 * G;
  int* t = SMEM ? dyn : scratch;
  int* seg_wave = t;
  int* seg_first = t + G;  // then gbase[g]
  int* al = t + 2 * G;
  int* mm = t + 3 * G;
  int* gids = t + 4 * G;
  const int words = (n + 31) >> 5;
  unsigned* bits = reinterpret_cast<unsigned*>(gids + n);
  int* wpre = gids + n + words;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // the first rows' loads go out before the tables are set, so the two
  // round trips overlap
  int gv[GANG_UNROLL], sv[GANG_UNROLL];
  const auto load_rows = [&](int r0) {
#pragma unroll
    for (int u = 0; u < GANG_UNROLL; ++u) {
      const int i = r0 + u * GANG_THREADS + lane;
      gv[u] = i < n ? gid[i] : -1;
      sv[u] = i < n ? selected[i] : -1;
    }
  };
  load_rows(warp * 32);
#pragma unroll 2
  for (int g = threadIdx.x; g < G; g += GANG_THREADS) {
    seg_wave[g] = 0;
    seg_first[g] = INT_MAX;
    al[g] = already[g];
    mm[g] = min_member[g];
  }
  __syncthreads();

  // 1. the slice's gid kept, feasibility words; each run's count and
  // first index
  for (int r0 = warp * 32; r0 < n; r0 += GANG_THREADS * GANG_UNROLL) {
    if (r0 != warp * 32) load_rows(r0);
#pragma unroll
    for (int u = 0; u < GANG_UNROLL; ++u) {
      const int row = r0 + u * GANG_THREADS;  // the warp's first pod
      if (row >= n) break;
      const int g = gv[u];
      if (row + lane < n) gids[row + lane] = g;
      const bool grouped = g >= 0 && g < G;
      const unsigned fb = __ballot_sync(full, grouped && sv[u] >= 0);
      if (lane == 0) bits[row >> 5] = fb;
      const int up = __shfl_up_sync(full, g, 1);
      const int down = __shfl_down_sync(full, g, 1);
      const unsigned last = __ballot_sync(full, lane == 31 || down != g);
      if (grouped && (lane == 0 || up != g)) {  // a run's first lane
        const int end = __ffs(last & (full << lane)) - 1;
        const unsigned run = (full >> (31 - end)) & (full << lane);
        const int cnt = __popc(fb & run);
        if (cnt) atomicAdd(&seg_wave[g], cnt);
        atomicMin(&seg_first[g], row + lane);
      }
    }
  }
  __syncthreads();

  // 2. wpre: the words' exclusive prefix, a block scan of 1024 words a tile
  int carry = 0;
  for (int w0 = 0; w0 < words; w0 += GANG_THREADS) {
    const int w = w0 + threadIdx.x;
    const int x = w < words ? __popc(bits[w]) : 0;
    int incl = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(full, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) sh_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int v = sh_warp[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(full, v, o);
        if (lane >= o) v += y;
      }
      sh_warp[lane] = v;
    }
    __syncthreads();
    if (w < words) wpre[w] = carry + (warp ? sh_warp[warp - 1] : 0) + incl - x;
    carry += sh_warp[GANG_THREADS / 32 - 1];
    __syncthreads();  // sh_warp is read before the next tile writes it
  }

  // 3. per group: the decision and gbase
  for (int g = threadIdx.x; g < G; g += GANG_THREADS) {
    const int w = seg_wave[g];
    admit[g] = (int)((unsigned)w + (unsigned)al[g]) >= mm[g];
    wave_out[g] = w;
    int f = seg_first[g];
    f = f < 0 ? 0 : (f > n - 1 ? n - 1 : f);
    seg_first[g] = wpre[f >> 5] + __popc(bits[f >> 5] & ((1u << (f & 31)) - 1));
  }
  __syncthreads();

  // 4. per pod
  for (int i = threadIdx.x; i < n; i += GANG_THREADS) {
    const unsigned word = bits[i >> 5];
    int wv = 0;
    if (word >> (i & 31) & 1) {  // feasible, so grouped
      const int g = gids[i];
      const int cf = wpre[i >> 5] + __popc(word & (full >> (31 - (i & 31))));
      const int rank = cf - seg_first[g];
      wv = (int)((unsigned)al[g] + (unsigned)rank) < mm[g];
    }
    wait[i] = wv;
  }
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

// One launch on the caller's stream, its tables in shared memory
// (`shared`, the card's opt-in limit permitting) or in `scratch`
// (quorum_table_ints(n, G) ints); no synchronisation.  Returns the CUDA
// error, so a refused launch is reported at once.
extern "C" int kss_quorum_slice(const int* in, int n, int G, int* out, int* scratch, int shared,
                                void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (shared) {
    int max_dynamic = 0;
    const cudaError_t e = cluster_attributes<quorum_slice_kernel<true>, false>(&max_dynamic);
    if (e != cudaSuccess) return (int)e;
    const long long bytes = quorum_table_ints(n, G) * (long long)sizeof(int);
    if (bytes > max_dynamic) return (int)cudaErrorInvalidValue;
    quorum_slice_kernel<true><<<1, GANG_THREADS, (size_t)bytes, s>>>(in, n, G, out, nullptr);
  } else {
    quorum_slice_kernel<false><<<1, GANG_THREADS, 0, s>>>(in, n, G, out, scratch);
  }
  return (int)cudaGetLastError();
}
#endif
