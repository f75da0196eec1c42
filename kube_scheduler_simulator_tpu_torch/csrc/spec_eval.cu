// spec_eval_cluster and spec_oracle: the dense round of the speculative
// wave and the host path's evaluation, written for Hopper (sm_90a).
//
// spec_eval_cluster replaces two JAX functions, one per output layout
// (StepArgs.compact):
//
//   * kube_scheduler_simulator_tpu/parallel/speculative.py:318 `_eval_fn`
//     (B2): the step's compact evaluation, vmapped over a batch of B pods
//     against ONE frozen carry, with no bind (kernels/spec.py spec_eval);
//   * kube_scheduler_simulator_tpu/framework/pipeline.py:446
//     `build_phased`'s eval_fn (B10): one pod's evaluation against the
//     carry as it stands, writing the UNCOMPACTED StepOut the host loop
//     reads: every filter's code at every node, every scorer's raw and
//     final row as int32 (kernels/phased.py phased_eval).
//
// One pod per thread-block cluster: the grid is B x S CTAs, and CTA r of
// pod b's cluster owns the node slice [r W, (r + 1) W), W = ceil(N / S)
// (cluster.cuh; a ragged last slice, an empty one where N < S).  The
// per-pod body is pod.cuh's eval_pod under ClusterScope (scope.cuh): the
// spread minima, the node loop's statistics and the argmax are three
// combines, each one cluster barrier and one warp reading the S partials
// through distributed shared memory.  The pod's raw, feasibility and
// ignore rows of the slice stay in the CTA's dynamic shared memory (in its
// slot of StepArgs.spill past the card's limit, as at S = 1 on a 5,000-node
// fleet).  Where the workload has them, NodeVolumeLimits walks the pod's
// own volumes against its slice's per-(node, driver) counts and
// VolumeBinding the pod's own candidate PVs, compacted as step_chunk
// compacts them (volumes.cuh).  Nothing writes the carry, so the clusters
// share it.  Each CTA writes its slice of every [.., N] output; the
// cluster's leader writes the pod's scalars.
//
// S comes from the batch (kernels/spec.py eval_shards): the largest S of
// 1, 2, 4, 8, 16 at which all B clusters are resident on the card at once
// (kss_eval_plan asks cudaOccupancyMaxActiveClusters, once per card and
// per launch shape), else 1.  So a small batch (the contended round's 8
// pods, the host path's 1) spreads each pod over many SMs, and a large one
// (512 pods) keeps one CTA per pod.
//
// What bounds it on this card: the latency of one pod's dependent phases
// (the node loop, InterPod's 40 terms a node, three combines), as in
// step_chunk; the bytes (a few [N] rows a pod) are microseconds.  The
// cluster divides the node loop by S, and B x S CTAs fill the SMs a small
// batch left idle.
//
// Exactness: as step_chunk.  Integer math is int64 with floor division,
// the float64 paths are built with -fmad=false, and no float sum runs over
// the node axis, so the split gives the bytes of one CTA per pod.
//
// spec_oracle replaces speculative.py:299 `_oracle_core`, the dirty-node
// prefix (spec.cuh spec_oracle_block), one block.  It runs after the
// dense round's eval on the same stream; it reads B x B packed words and
// is bound by its launch.
#include "cluster.cuh"
#include "spec.cuh"

__global__ void __launch_bounds__(KSS_STEP_THREADS, 1)
    spec_eval_cluster_kernel(const __grid_constant__ StepArgs a, int width) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ PodShared sh;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), shards = (int)cluster.num_blocks();
  const int c = (int)blockIdx.x / shards;
  const int lo = min(rank * width, a.N), hi = min(lo + width, a.N);
  const StepSmem m = step_smem(a, width, false);
  unsigned char* smem = a.spill != nullptr ? a.spill + (size_t)blockIdx.x * m.total : dyn;
  ClusterScope scope{lo, hi, rank, shards,
                     PodRows{(long long*)(smem + m.raw), smem + m.feas, smem + m.ign, lo, width},
                     &sh, PodVolumes{}, 0};
  // the pod's volume lists and the slice's counts, before the node loop
  if (a.has_nvl && !a.nvl_filter_skip[c]) {
    int* count = (int*)(smem + m.count);
    int* vols = (int*)(smem + m.nvl);
    nvl_counts(a, lo, hi, count);
    scope.vols.nvl_count = count;
    scope.vols.count_lo = lo;
    scope.vols.nvl_vols = vols;
    scope.vols.nvl_n = nvl_compact(a, c, vols, sh.i);
  }
  if (a.has_vb) {
    int* pvs = (int*)(smem + m.vb_pvs);
    unsigned char* slots = smem + m.vb_slots;
    scope.vols.vb_pvs = pvs;
    scope.vols.vb_slots = slots;
    scope.vols.vb_n = vb_compact(a, c, pvs, slots, sh.i);
  }
  __syncthreads();
  eval_pod(a, c, scope);
  // no CTA leaves while another may still read its slots
  cluster.sync();
}

__global__ void __launch_bounds__(SPEC_THREADS) spec_oracle_kernel(
    const void* packed, int pack_bytes, const int* reject, const int* selected, int B, int N,
    int* out_k) {
  __shared__ int sh_k;
  spec_oracle_block(packed, pack_bytes, reject, selected, B, N, out_k, sh_k);
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

#include <map>
#include <tuple>

#define KSS_EVAL_SIZES 5  // S = 1, 2, 4, 8, 16

extern "C" int kss_step_args_size() { return (int)sizeof(StepArgs); }

// cudaOccupancyMaxActiveClusters of the kernel at plan p, asked once per
// card and per (S, CTA width, shared memory) for the process; a refused
// query counts as no room (0).
static int eval_clusters(const ClusterPlan& p, int shards, int dev) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, int, size_t>, int> memo;
  const auto key = std::make_tuple(dev, shards, p.threads, p.spill ? (size_t)0 : p.bytes);
  std::lock_guard<std::mutex> lock(mu);
  auto it = memo.find(key);
  if (it == memo.end()) {
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg;
    cluster_config(p, 1, shards, nullptr, attr, &cfg);
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, spec_eval_cluster_kernel, &cfg) != cudaSuccess) {
      cudaGetLastError();
      clusters = 0;
    }
    it = memo.emplace(key, clusters).first;
  }
  return it->second;
}

// The plan of a launch over these arguments at each S = 2^k, k < 5: to
// clusters[k] how many clusters of S CTAs the card holds at once, to
// cta_spill[k] the device memory each CTA's state takes in a.spill (0
// where it fits in shared memory).
extern "C" int kss_eval_plan(const StepArgs* args, int* clusters, long long* cta_spill) {
  int max_dynamic = 0, dev = 0;
  cudaError_t err = cluster_attributes<spec_eval_cluster_kernel>(&max_dynamic);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  for (int k = 0; k < KSS_EVAL_SIZES; ++k) {
    const ClusterPlan p = cluster_plan(*args, 1 << k, max_dynamic, false);
    clusters[k] = eval_clusters(p, 1 << k, dev);
    cta_spill[k] = p.spill ? (long long)p.bytes : 0;
  }
  return (int)cudaSuccess;
}

// Launches on the caller's stream; no synchronisation.  One cluster of
// `shards` CTAs (1 to KSS_MAX_SHARDS) per pod of args->C, a.spill set
// exactly where kss_eval_plan gave the state bytes of device memory.
// Each returns the launch's error or cudaGetLastError(), so a refused
// launch is reported at once.
extern "C" int kss_spec_eval(const StepArgs* args, int shards, void* stream) {
  if (shards < 1 || shards > KSS_MAX_SHARDS || args->C < 1) return (int)cudaErrorInvalidValue;
  int max_dynamic = 0;
  const cudaError_t err = cluster_attributes<spec_eval_cluster_kernel>(&max_dynamic);
  if (err != cudaSuccess) return (int)err;
  const ClusterPlan p = cluster_plan(*args, shards, max_dynamic, false);
  if (p.spill != (args->spill != nullptr)) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  cluster_config(p, args->C, shards, (cudaStream_t)stream, attr, &cfg);
  return launch_result(cudaLaunchKernelEx(&cfg, spec_eval_cluster_kernel, *args, p.width));
}

extern "C" int kss_spec_oracle(const void* packed, int pack_bytes, const int* reject,
                               const int* selected, int B, int N, int* out_k, void* stream) {
  spec_oracle_kernel<<<1, SPEC_THREADS, 0, (cudaStream_t)stream>>>(packed, pack_bytes, reject,
                                                                   selected, B, N, out_k);
  return (int)cudaGetLastError();
}
#endif
