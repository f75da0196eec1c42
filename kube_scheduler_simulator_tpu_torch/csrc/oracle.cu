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
// The commit folded in (B5's core, speculative.py:511 `_commit_fn` in its
// core-only variant).  A session may carry an OracleCommit: the round's
// core carry and the batch's request rows.  The launch leaves the carry
// with the accepted prefix applied, rows b < min(K, m) with selected[b] >=
// 0 (m: the rows that are not pad): requests, non-zero requests and 1 at
// row selected[b], by 64-bit atomicAdd.  It does not wait for K to add:
// row b belongs to thread b / C of the cluster's CTA b % C, which loads
// the row into registers at the kernel's start, adds it after the first
// barrier (the loads have landed by then, so the atomics issue without a
// stall, before the gathers), and once K is known takes back the rows in
// [min(K, m), m) (every row, where the round is "wide", below).  Integer addition wraps exactly, so the carry
// ends as the accepted prefix alone would leave it; nothing reads the
// carry while the launch runs (the stream orders the round's kernels, and
// each session has its own carry).  A round that accepts all its rows,
// the common case, has nothing to take back.  For that every CTA needs K
// itself: where it has a commit, the launch's conflicts and flags go into
// every CTA's shared memory (the COMMIT instantiation), so after the last
// barrier each CTA reads its own.  The accepted pods of a round bind
// distinct nodes (a later pod feasible at an earlier pod's node
// conflicts), so plain adds would give the same sums for the prefix; the
// atomics keep every partial sum exact.  The host sets the commit only
// where it cannot cut K after the launch (parallel/speculative.py
// `_spec_run`, `commit_folds`): a core-only carry, no interaction rule, no
// gang.  A sparse round's commit also carries its feasible counts and
// candidate cap: where a row b < m is feasible at more nodes than the
// cap, the host discards the round and runs it dense, so the launch takes
// back every row (each CTA ORs its rows' verdict into every CTA's flag
// before the last barrier).  Such a round launches no spec_commit_core;
// csrc/spec_commit.cu's standalone kernel stays for the rounds the host
// may cut.  A launch with no commit is the COMMIT = false instantiation,
// the oracle as it was.
//
// What bounds it on this card: at small B its launch; at B = 512 the
// latency of a few dependent rounds of gathers per warp (the B x B packed
// words it reads are a fraction of a microsecond of bandwidth).  The
// design turns the old one-block walk (thread k over j < k, each gather
// behind the branch of the one before: 511 in a row at B = 512) into at
// most a few rows a warp, each a round of independent loads.  The commit
// adds (R + 3) atomics a row, issued under the gathers; after the last
// barrier only a rejected suffix costs anything.  Adding after the last
// barrier instead (by rank 0's CTA, or by every CTA after reading K from
// rank 0 and one more cluster barrier) took 1.5-2 us more than the
// unfolded launch at B = 512; adding at the start with loads that the
// atomics wait for, 1.2 us (each CTA's first warp stalls the first
// barrier).
#include "cluster.cuh"

#define ORACLE_THREADS 512
#define COMMIT_PRE 4  // request columns of a committed row held in registers

// A session's commit (kernels/spec.py OracleCommit): the core carry's
// requested [N, R], nonzero [N, 2] and num_pods [N], the batch's
// pod_requests [B, R] and pod_nonzero [B, 2] (all int64), a sparse
// round's feasible counts [B] (int32; nullptr for a dense round), R, m
// and the candidate cap.  requested == nullptr: the session commits
// nothing.
struct OracleCommit {
  long long* requested;
  long long* nonzero;
  long long* num_pods;
  const long long* pod_requests;
  const long long* pod_nonzero;
  const int* counts;
  int R, m, kcand;
};

// One launch's sessions, KM entries (1, 2, 4, 8 or 16: by_table picks the
// smallest that holds them, so a solo launch passes one): session s's
// packed words [B, N] (pack_bytes each), PreFilter rejects [B],
// selections [B], K (int32) and its commit.  `staged`: selected[0, B)
// fits in the dynamic shared memory the launch was given.
template <int KM>
struct OracleTable {
  const void* packed[KM];
  const int* reject[KM];
  const int* selected[KM];
  int* out_k[KM];
  OracleCommit commit[KM];
  int B, N, staged;
};

// Adds row b of a commit's batch at `node` to the carry, `sign` times
// (1, or -1 to take it back).
__device__ inline void commit_row(const OracleCommit& cm, int b, int node, long long sign) {
  if (node < 0) return;
  const int R = cm.R;
  unsigned long long* req = (unsigned long long*)&cm.requested[(long long)node * R];
  for (int r = 0; r < R; ++r)
    atomicAdd(&req[r], (unsigned long long)(sign * cm.pod_requests[(long long)b * R + r]));
  for (int j = 0; j < 2; ++j)
    atomicAdd((unsigned long long*)&cm.nonzero[(long long)node * 2 + j],
              (unsigned long long)(sign * cm.pod_nonzero[(long long)b * 2 + j]));
  atomicAdd((unsigned long long*)&cm.num_pods[node], (unsigned long long)sign);
}

template <class T, int KM, bool COMMIT>
__global__ void __launch_bounds__(ORACLE_THREADS)
    spec_oracle_kernel(const __grid_constant__ OracleTable<KM> t) {
  extern __shared__ int sh_sel[];
  __shared__ int sh_k, sh_wide;
  cg::cluster_group cluster = cg::this_cluster();
  // a launch of one CTA a session is no cluster launch: block barriers
  const int ctas = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const bool solo = ctas == 1;
  const int s = KM == 1 ? 0 : (int)blockIdx.x / ctas;
  const int B = t.B;
  const T* packed = (const T*)t.packed[s];
  const int* reject = t.reject[s];
  const int* sel = t.selected[s];
  // B5's commit: thread i of CTA `rank` owns rows rank + C i, + C
  // blockDim, ...; it loads its first row now and adds it after the first
  // barrier, by when the loads have landed, so the adds wait for nothing
  const OracleCommit& cm = t.commit[s];
  const bool commit = COMMIT && cm.requested != nullptr;  // the same in every CTA
  const int b0 = rank + ctas * (int)threadIdx.x, stride = ctas * (int)blockDim.x;
  const bool own = commit && b0 < cm.m;
  int pre_node = -1;
  long long pre[COMMIT ? COMMIT_PRE + 2 : 1] = {};
  if constexpr (COMMIT) {
    if (own) {
      pre_node = sel[b0];
#pragma unroll
      for (int r = 0; r < COMMIT_PRE; ++r)
        if (r < cm.R) pre[r] = cm.pod_requests[(long long)b0 * cm.R + r];
      pre[COMMIT_PRE] = cm.pod_nonzero[(long long)b0 * 2];
      pre[COMMIT_PRE + 1] = cm.pod_nonzero[(long long)b0 * 2 + 1];
    }
  }
  if (t.staged) {
    for (int j = threadIdx.x; j < B; j += blockDim.x) sh_sel[j] = sel[j];
    sel = sh_sel;
  }
  if (threadIdx.x == 0) {
    sh_k = B;
    if constexpr (COMMIT) sh_wide = 0;
  }
  // every CTA's rows staged, and its minimum set, before any gather or
  // atomic
  if (solo) __syncthreads(); else cluster.sync();
  if constexpr (COMMIT) {
    if (own && pre_node >= 0) {  // the thread's first row, from its registers
      const int R = cm.R;
      unsigned long long* req = (unsigned long long*)&cm.requested[(long long)pre_node * R];
#pragma unroll
      for (int r = 0; r < COMMIT_PRE; ++r)
        if (r < R) atomicAdd(&req[r], (unsigned long long)pre[r]);
      for (int r = COMMIT_PRE; r < R; ++r)
        atomicAdd(&req[r], (unsigned long long)cm.pod_requests[(long long)b0 * R + r]);
      atomicAdd((unsigned long long*)&cm.nonzero[(long long)pre_node * 2],
                (unsigned long long)pre[COMMIT_PRE]);
      atomicAdd((unsigned long long*)&cm.nonzero[(long long)pre_node * 2 + 1],
                (unsigned long long)pre[COMMIT_PRE + 1]);
      atomicAdd((unsigned long long*)&cm.num_pods[pre_node], 1ULL);
    }
    if (commit)  // rows past the cluster's threads
      for (int b = b0 + stride; b < cm.m; b += stride) commit_row(cm, b, sel[b], 1);
  }
  // the minimum: rank 0's alone, or with a commit every CTA's copy
  int* k_min = solo || COMMIT ? &sh_k : cluster.map_shared_rank(&sh_k, 0);
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
      if (lane == 0) {
        if constexpr (COMMIT) {
          for (int r = 0; r < ctas; ++r)
            atomicMin(solo ? &sh_k : cluster.map_shared_rank(&sh_k, r), k);
        } else {
          atomicMin(k_min, k);
        }
      }
      break;
    }
  }
  if constexpr (COMMIT) {
    if (commit && cm.counts != nullptr) {
      // a row past the candidate cap: the host runs this round dense
      bool wide = false;
      for (int b = b0; b < cm.m; b += stride) wide |= cm.counts[b] > cm.kcand;
      if (__any_sync(0xffffffffu, wide) && lane == 0)
        for (int r = 0; r < ctas; ++r)
          atomicOr(solo ? &sh_wide : cluster.map_shared_rank(&sh_wide, r), 1);
    }
  }
  // every atomic has landed, and no CTA leaves while another may still
  // write its shared memory
  if (solo) __syncthreads(); else cluster.sync();
  if (rank == 0 && threadIdx.x == 0) *t.out_k[s] = sh_k;
  if constexpr (COMMIT) {
    if (commit) {
      // take back the rows past the accepted prefix (all, where wide)
      const int keep = sh_wide ? 0 : min(sh_k, cm.m);
      for (int b = b0; b < cm.m; b += stride)
        if (b >= keep) commit_row(cm, b, sel[b], -1);
    }
  }
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

extern "C" int kss_fuse_max() { return KSS_MAX_TABLE; }

template <class T, int KM, bool COMMIT>
static int launch_table(const void* const* packed, const int* const* reject,
                         const int* const* selected, int* const* out_k,
                         const OracleCommit* commits, int k, int B, int N, int ctas,
                         cudaStream_t stream) {
  int max_dynamic = 0;
  const cudaError_t err = cluster_attributes<spec_oracle_kernel<T, KM, COMMIT>>(&max_dynamic);
  if (err != cudaSuccess) return (int)err;
  OracleTable<KM> t = {};
  for (int i = 0; i < k; ++i) {
    t.packed[i] = packed[i];
    t.reject[i] = reject[i];
    t.selected[i] = selected[i];
    t.out_k[i] = out_k[i];
    if (commits != nullptr) t.commit[i] = commits[i];
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
  return launch_result(cudaLaunchKernelEx(&cfg, spec_oracle_kernel<T, KM, COMMIT>, t));
}

template <class T>
static int launch_oracle(const void* const* packed, const int* const* reject,
                         const int* const* selected, int* const* out_k,
                         const OracleCommit* commits, int k, int B, int N, int ctas,
                         cudaStream_t stream) {
  bool commit = false;
  for (int i = 0; commits != nullptr && i < k; ++i) commit |= commits[i].requested != nullptr;
  return by_table(k, [&](auto km) {
    constexpr int KM = decltype(km)::value;
    return commit ? launch_table<T, KM, true>(packed, reject, selected, out_k, commits, k, B, N,
                                              ctas, stream)
                  : launch_table<T, KM, false>(packed, reject, selected, out_k, commits, k, B,
                                               N, ctas, stream);
  });
}

extern "C" int kss_oracle_commit_size() { return (int)sizeof(OracleCommit); }

// Launches on the caller's stream; no synchronisation.  k sessions (1 to
// KSS_MAX_TABLE) of one batch B and node count N, each one cluster of
// `ctas` CTAs (1 to KSS_MAX_CTAS; one CTA, no cluster, at 1), each
// writing its own out_k[i] and, where commits[i].requested is set,
// committing its accepted prefix (commits may be null: no session
// commits).  Returns the launch's error or cudaGetLastError(), so a
// refused launch is reported at once.
extern "C" int kss_spec_oracle(const void* const* packed, const int* const* reject,
                               const int* const* selected, int* const* out_k,
                               const OracleCommit* commits, int k, int pack_bytes, int B,
                               int N, int ctas, void* stream) {
  if (k < 1 || k > KSS_MAX_TABLE || ctas < 1 || ctas > KSS_MAX_CTAS || B < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (pack_bytes) {
    case 1:
      return launch_oracle<unsigned char>(packed, reject, selected, out_k, commits, k, B, N,
                                          ctas, st);
    case 2:
      return launch_oracle<unsigned short>(packed, reject, selected, out_k, commits, k, B, N,
                                           ctas, st);
    case 4:
      return launch_oracle<unsigned int>(packed, reject, selected, out_k, commits, k, B, N,
                                         ctas, st);
    case 8:
      return launch_oracle<unsigned long long>(packed, reject, selected, out_k, commits, k, B,
                                               N, ctas, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
#endif
