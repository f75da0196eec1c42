// B12: the node-sharded step and dense eval, written for Hopper (sm_90a),
// with each "nodes" shard one CTA of a thread-block cluster.
//
// spec_eval_sharded replaces kube_scheduler_simulator_tpu/parallel/mesh.py:143
// `speculative_scores` (B2's eval with every [.., N] tensor sharded over
// the mesh's "nodes" axis, the pod batch placed over "dp"; GSPMD turns
// the node-axis reductions into all-reduces over the devices).  On one
// card the mesh's S "nodes" shards are the S CTAs of a cluster: CTA r owns
// the contiguous nodes [r N/S, (r+1) N/S), the slices `_node_axis_spec`
// gives on a device mesh.  Grid B x S, one cluster per pod of the batch,
// against one frozen carry, no bind; each CTA reads and writes only its
// slice of every [.., N] tensor.  The mesh's "dp" groups of pods are
// disjoint runs of clusters of this one grid.
//
// B12's sharded step, mesh.py:130 `sharded_step`, is step_chunk's cluster
// kernel (step_kernel.cuh, documented in step.cu) launched with the mesh's
// S: step_chunk_sharded below.
//
// The per-pod body is pod.cuh's eval_pod under ClusterScope (scope.cuh):
// three combines per pod, each one cluster barrier and one warp reading
// the S partials through distributed shared memory.  The pod's rows stay
// in its global scratch slot, each CTA on its own slice.
//
// Exactness: no float sum runs over the node axis (balanced allocation,
// the spread sum and the InterPod normalization are per node, given the
// integer min and max), so the sharded kernel gives the unsharded
// kernel's bytes.  Built with -fmad=false like every kernel here.
//
// What bounds it: the same per-pod latency as spec_eval, its node loop
// divided over S SMs, plus three cluster barriers per pod.  512 pods
// already fill the card, so sharding adds barriers, not parallelism.
#include "spec.cuh"
#include "step_kernel.cuh"

#define KSS_MAX_CLUSTER 8  // a portable cluster
#define MESH_EVAL_THREADS SPEC_THREADS

__global__ void __launch_bounds__(MESH_EVAL_THREADS)
    spec_eval_sharded_kernel(const __grid_constant__ StepArgs a, int shards) {
  __shared__ PodShared sh;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int width = a.N / shards;  // the wrapper checks N % shards == 0
  const int c = blockIdx.x / shards;
  const PodScratch sc = pod_scratch(a, c);
  ClusterScope scope{rank * width, (rank + 1) * width, rank, shards,
                     PodRows{sc.raw, sc.feas, sc.ign, 0, a.N}, &sh, PodVolumes{}, 0};
  eval_pod(a, c, scope);
  // no CTA leaves while another may still read its slots
  cluster.sync();
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

extern "C" int kss_step_args_size() { return (int)sizeof(StepArgs); }
extern "C" int kss_mesh_max_shards() { return KSS_MAX_CLUSTER; }

// Launches on the caller's stream; no synchronisation.  Each returns the
// launch's error or cudaGetLastError(), so a refused launch is reported at
// once: a portable cluster (1 to 8 CTAs) over slices that divide N.
extern "C" int kss_step_chunk_sharded(const StepArgs* args, int shards, void* stream) {
  if (shards < 1 || shards > KSS_MAX_CLUSTER || args->N % shards != 0)
    return (int)cudaErrorInvalidValue;
  return launch_step_cluster(args, shards, stream);
}

extern "C" int kss_spec_eval_sharded(const StepArgs* args, int shards, void* stream) {
  if (shards < 1 || shards > KSS_MAX_CLUSTER || args->N % shards != 0 || args->C < 1)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(args->C * shards), 1, 1);
  cfg.blockDim = dim3((unsigned)MESH_EVAL_THREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)shards;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return launch_result(cudaLaunchKernelEx(&cfg, spec_eval_sharded_kernel, *args, shards));
}
#endif
