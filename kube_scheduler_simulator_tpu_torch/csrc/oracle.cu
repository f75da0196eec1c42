// The conflict oracle of the speculative rounds, written for Hopper
// (sm_90a): B3 `spec_oracle` and B11's `spec_oracle_fused` are launches of
// this one kernel over a table of sessions, the solo oracle its
// one-session launch.
//
// It replaces kube_scheduler_simulator_tpu/parallel/speculative.py:299
// `_oracle_core`, the dirty-node prefix (the dense round's, and the one
// `_sparse_round_fn` holds), and inside B11 the oracle of parallel/
// fuse.py:356 `_run_fused`, `jax.vmap` at :365 over K sessions.  Pod k
// conflicts when it is feasible (packed word 0, no PreFilter reject) at
// the node an earlier pod j < k selected (selected[j] >= 0); K is the
// lowest conflicting k, or B.
//
// The work is the B (B - 1) / 2 pairs (j < k).  Each session gets one
// thread-block cluster of C CTAs (kernels/spec.py oracle_ctas picks C
// from B), each CTA stages selected[0, B) in shared memory once, and a
// warp takes a row k at a time: its lanes take j = lane, lane + 32, ...
// < k and gather packed[k N + selected[j]] with no branch between their
// loads, and the warp decides with __any_sync.  Rows go to the cluster's
// warps in ascending k, so a warp stops at its first row past the lowest
// conflict found so far; a row with a PreFilter reject is skipped before
// any gather.  The combine is a minimum over k in the shared memory of the
// cluster's rank 0 (atomicMin through distributed shared memory), which
// rank 0 writes to the session's K after the cluster's last barrier: no
// counter, no memset and no second launch, and nothing shared between
// launches, so sessions on different streams may run it at once.
//
// What bounds it on this card: at small B its launch; at B = 512 the
// latency of a few dependent rounds of gathers per warp (the B x B packed
// words it reads are a fraction of a microsecond of bandwidth).  The
// design turns the old one-block walk (thread k over j < k, each gather
// behind the branch of the one before: 511 in a row at B = 512) into at
// most a few rows a warp, each a round of independent loads.
#include "cluster.cuh"

#define ORACLE_THREADS 512

// One launch's sessions, KM entries (1, 2, 4, 8 or 16: by_table picks the
// smallest that holds them, so a solo launch passes one): session s's
// packed words [B, N] (pack_bytes each), PreFilter rejects [B],
// selections [B] and K (int32).  `staged`: selected[0, B) fits in the
// dynamic shared memory the launch was given.
template <int KM>
struct OracleTable {
  const void* packed[KM];
  const int* reject[KM];
  const int* selected[KM];
  int* out_k[KM];
  int B, N, staged;
};

template <class T, int KM>
__global__ void __launch_bounds__(ORACLE_THREADS)
    spec_oracle_kernel(const __grid_constant__ OracleTable<KM> t) {
  extern __shared__ int sh_sel[];
  __shared__ int sh_k;
  cg::cluster_group cluster = cg::this_cluster();
  // a launch of one CTA a session is no cluster launch: block barriers
  const int ctas = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const bool solo = ctas == 1;
  const int s = KM == 1 ? 0 : (int)blockIdx.x / ctas;
  const int B = t.B;
  const T* packed = (const T*)t.packed[s];
  const int* reject = t.reject[s];
  const int* sel = t.selected[s];
  if (t.staged) {
    for (int j = threadIdx.x; j < B; j += blockDim.x) sh_sel[j] = sel[j];
    sel = sh_sel;
  }
  if (threadIdx.x == 0) sh_k = B;
  // every CTA's rows staged, and rank 0's minimum set, before any gather
  // or atomic
  if (solo) __syncthreads(); else cluster.sync();
  int* k_min = solo ? &sh_k : cluster.map_shared_rank(&sh_k, 0);
  const int lane = threadIdx.x & 31, warps = (int)(blockDim.x >> 5);
  const int step = ctas * warps;
  for (int k = 1 + rank * warps + (int)(threadIdx.x >> 5); k < B; k += step) {
    // one read a warp, so the whole warp leaves together
    int low = 0;
    if (lane == 0) low = *(volatile int*)k_min;
    if (k >= __shfl_sync(0xffffffffu, low, 0)) break;  // every later row is past it
    if (reject[k] != 0) continue;  // feasible nowhere: never conflicts
    const T* row = packed + (long long)k * t.N;
    bool hit = false;
    // up to 16 independent loads a lane in flight: a row of B = 512 in
    // one round trip
#pragma unroll 16
    for (int j = lane; j < k; j += 32) {
      const int c = sel[j];
      const T v = c >= 0 ? row[c] : (T)1;
      hit |= v == 0;
    }
    if (__any_sync(0xffffffffu, hit)) {
      if (lane == 0) atomicMin(k_min, k);
      break;
    }
  }
  // every atomic has landed, and no CTA leaves while another may still
  // write rank 0's minimum
  if (solo) __syncthreads(); else cluster.sync();
  if (rank == 0 && threadIdx.x == 0) *t.out_k[s] = sh_k;
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

extern "C" int kss_fuse_max() { return KSS_MAX_TABLE; }

template <class T, int KM>
static int launch_table(const void* const* packed, const int* const* reject,
                         const int* const* selected, int* const* out_k, int k, int B, int N,
                         int ctas, cudaStream_t stream) {
  int max_dynamic = 0;
  const cudaError_t err = cluster_attributes<spec_oracle_kernel<T, KM>>(&max_dynamic);
  if (err != cudaSuccess) return (int)err;
  OracleTable<KM> t = {};
  for (int i = 0; i < k; ++i) {
    t.packed[i] = packed[i];
    t.reject[i] = reject[i];
    t.selected[i] = selected[i];
    t.out_k[i] = out_k[i];
  }
  t.B = B;
  t.N = N;
  const size_t bytes = (size_t)B * sizeof(int);
  t.staged = bytes <= (size_t)max_dynamic;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(k * ctas), 1, 1);
  cfg.blockDim = dim3(ORACLE_THREADS, 1, 1);
  cfg.dynamicSmemBytes = t.staged ? bytes : 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = ctas > 1 ? 1 : 0;
  return launch_result(cudaLaunchKernelEx(&cfg, spec_oracle_kernel<T, KM>, t));
}

template <class T>
static int launch_oracle(const void* const* packed, const int* const* reject,
                         const int* const* selected, int* const* out_k, int k, int B, int N,
                         int ctas, cudaStream_t stream) {
  return by_table(k, [&](auto km) {
    return launch_table<T, decltype(km)::value>(packed, reject, selected, out_k, k, B, N, ctas,
                                                stream);
  });
}

// Launches on the caller's stream; no synchronisation.  k sessions (1 to
// KSS_MAX_TABLE) of one batch B and node count N, each one cluster of
// `ctas` CTAs (1 to KSS_MAX_CTAS; one CTA, no cluster, at 1), each
// writing its own out_k[i].  Returns the launch's error or
// cudaGetLastError(), so a refused launch is reported at once.
extern "C" int kss_spec_oracle(const void* const* packed, const int* const* reject,
                               const int* const* selected, int* const* out_k, int k,
                               int pack_bytes, int B, int N, int ctas, void* stream) {
  if (k < 1 || k > KSS_MAX_TABLE || ctas < 1 || ctas > KSS_MAX_CTAS || B < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (pack_bytes) {
    case 1:
      return launch_oracle<unsigned char>(packed, reject, selected, out_k, k, B, N, ctas, st);
    case 2:
      return launch_oracle<unsigned short>(packed, reject, selected, out_k, k, B, N, ctas, st);
    case 4:
      return launch_oracle<unsigned int>(packed, reject, selected, out_k, k, B, N, ctas, st);
    case 8:
      return launch_oracle<unsigned long long>(packed, reject, selected, out_k, k, B, N, ctas, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
#endif
