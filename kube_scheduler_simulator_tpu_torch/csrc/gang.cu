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
// exactly as the JAX package computes it, absent groups included.  One
// block of 1024 threads: the segment sums and minima by global int32
// atomicAdd / atomicMin into a scratch row (G can exceed what shared
// memory holds), the cumsum by a block-wide exclusive scan over
// contiguous tiles (as spec_round.cu does), then the per-group and the
// per-pod outputs.  n == 0 or G == 0 never reaches the kernel: the
// wrapper answers it (gang.py:222-223).
//
// What bounds it on this card: its launch.  A wave's slice is at most
// ~10^4 pods, 16 bytes in and 9 out per pod, a few microseconds of
// bandwidth; one block's atomics and two barriers cost about as much as
// the launch itself.  The wrapper's one H2D and one D2H dominate.
#include <climits>

#include "common.cuh"

#define GANG_THREADS 1024

// in: gid[n], selected[n], already[G], min_member[G] (one int32 buffer)
// out: admit[G], wave[G], wait[n] (one int32 buffer)
// scratch: cf[n], seg_wave[G + 1], seg_first[G + 1], gbase[G]
__global__ void __launch_bounds__(GANG_THREADS) quorum_slice_kernel(const int* in, int n, int G,
                                                                    int* out, int* scratch) {
  __shared__ int sh[GANG_THREADS / 32];
  const int* gid = in;
  const int* selected = in + n;
  const int* already = in + 2 * n;
  const int* min_member = in + 2 * n + G;
  int* admit = out;
  int* wave_out = out + G;
  int* wait = out + 2 * G;
  int* cf = scratch;
  int* seg_wave = scratch + n;
  int* seg_first = seg_wave + G + 1;
  int* gbase = seg_first + G + 1;

  for (int g = threadIdx.x; g <= G; g += blockDim.x) {
    seg_wave[g] = 0;
    seg_first[g] = INT_MAX;
  }
  __syncthreads();

  // segment sums and minima; ungrouped pods land in the dummy segment G
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int g = gid[i];
    const bool grouped = g >= 0;
    const int seg = grouped ? g : G;
    if (grouped && selected[i] >= 0) atomicAdd(&seg_wave[seg], 1);
    atomicMin(&seg_first[seg], grouped ? i : n);
  }

  // inclusive cumsum of feas over contiguous tiles of the slice, one
  // tile a thread
  const int tile = (n + (int)blockDim.x - 1) / (int)blockDim.x;
  const int i0 = min((int)threadIdx.x * tile, n), i1 = min(i0 + tile, n);
  int mine = 0;
  for (int i = i0; i < i1; ++i) mine += (gid[i] >= 0 && selected[i] >= 0);
  int run = block_exclusive_scan(mine, sh);
  for (int i = i0; i < i1; ++i) {
    run += (gid[i] >= 0 && selected[i] >= 0);
    cf[i] = run;
  }
  __syncthreads();  // cf, seg_wave and seg_first complete

  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    const int w = seg_wave[g];
    admit[g] = (w + already[g]) >= min_member[g];
    wave_out[g] = w;
    int f = seg_first[g];
    f = f < 0 ? 0 : (f > n - 1 ? n - 1 : f);
    const int feas_f = gid[f] >= 0 && selected[f] >= 0;
    gbase[g] = cf[f] - feas_f;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int g = gid[i];
    const bool feas = g >= 0 && selected[i] >= 0;
    const int gs = g >= 0 ? g : 0;
    const int rank = cf[i] - gbase[gs];
    wait[i] = feas && (already[gs] + rank < min_member[gs]);
  }
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

// Launch on the caller's stream; no synchronisation.  Returns
// cudaGetLastError() so a refused launch is reported at once.
extern "C" int kss_quorum_slice(const int* in, int n, int G, int* out, int* scratch,
                                void* stream) {
  quorum_slice_kernel<<<1, GANG_THREADS, 0, (cudaStream_t)stream>>>(in, n, G, out, scratch);
  return (int)cudaGetLastError();
}
#endif
