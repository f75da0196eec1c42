// B12: the node-sharded step and the node-sharded dense eval, written
// for Hopper (sm_90a), with each "nodes" shard one CTA of a thread-block
// cluster.
//
// They replace kube_scheduler_simulator_tpu/parallel/mesh.py:130
// `sharded_step` (B1's step with every [.., N] tensor sharded over the
// mesh's "nodes" axis; GSPMD turns the node-axis reductions into
// all-reduces over the devices) and :143 `speculative_scores` (B2's eval
// with the pod batch placed over "dp").  On one card the mesh's S
// "nodes" shards are the S CTAs of a cluster: CTA r owns the contiguous
// nodes [r N/S, (r+1) N/S), the slices `_node_axis_spec` gives on a
// device mesh.  Statics, carries, outputs and scratch stay one copy in
// HBM; each CTA reads and writes only its slice of every [.., N] tensor,
// apart from the statics' columns at the selected node and the
// cluster-wide carries (InterPod's matched_total, the ReadWriteOncePod
// bits, VolumeBinding's PV claims).
//
//   step_chunk_sharded   grid S, one cluster: the cluster walks a
//                        chunk's pods in order, as step_chunk does, with
//                        the per-pod body of pod.cuh in ClusterScope and
//                        the bind split by shard (pod.cuh bind_pod);
//   spec_eval_sharded    grid B x S, one cluster per pod of the batch,
//                        against one frozen carry, no bind.  The mesh's
//                        "dp" groups of pods are disjoint runs of
//                        clusters of this one grid.
//
// ClusterScope: every reduction over the node axis (the spread minima,
// the feasible count, the raw-overflow OR, the normalizing min/max/any,
// the argmax) is first the CTA's block reduction, then a combine through
// distributed shared memory: thread 0 writes the CTA's partial to its
// own shared slot, cluster.sync(), and every thread reads the S partials
// in rank order through cluster.map_shared_rank.  The argmax keeps
// (value desc, index asc) over the partials, so a tie between shards
// goes to the lower node.  The slots alternate between two buffers, so
// the next combine's write cannot overwrite a partial another CTA is
// still reading: reaching it means every CTA passed the barrier of the
// combine in between.  The bind's exactly-once updates are made by the
// CTA that owns the selected node; after it a fence and a cluster
// barrier make the carry whole for the next pod.
//
// Exactness: no float sum runs over the node axis (balanced allocation,
// the spread sum and the InterPod normalization are per node, given the
// integer min and max), so the sharded kernels give the unsharded
// kernels' bytes.  Built with -fmad=false like every kernel here.
//
// What bounds them: the same per-pod latency as step_chunk / spec_eval,
// divided over S SMs for the node loops, plus about ten cluster barriers
// per pod.  A simple kernel: tuning the CTA width to N/S nodes per shard
// is later work.
#include <cooperative_groups.h>

#include "spec.cuh"

namespace cg = cooperative_groups;

#define KSS_MAX_CLUSTER 8  // a portable cluster
#define MESH_STEP_THREADS KSS_THREADS
#define MESH_EVAL_THREADS SPEC_THREADS

struct MinOp {
  __device__ long long operator()(long long x, long long y) const { return ll_min(x, y); }
};
struct MaxOp {
  __device__ long long operator()(long long x, long long y) const { return ll_max(x, y); }
};
struct SumOp {
  __device__ long long operator()(long long x, long long y) const { return x + y; }
};
struct OrOp {
  __device__ long long operator()(long long x, long long y) const { return x | y; }
};

struct ClusterScope {
  int lo, hi;          // this shard's nodes
  int rank, shards;
  long long* slot_ll;  // __shared__ [2]: this CTA's partial, double-buffered
  int* slot_i;         // __shared__ [2]: the argmax partial's index
  int phase;           // combines done; picks the buffer

  __device__ bool leader() const { return threadIdx.x == 0 && rank == 0; }
  __device__ bool owns(int n) const { return n >= lo && n < hi; }

  template <class Op>
  __device__ long long combine(long long v, Op op) {
    cg::cluster_group cluster = cg::this_cluster();
    long long* mine = slot_ll + (phase & 1);
    if (threadIdx.x == 0) *mine = v;
    cluster.sync();
    long long r = *cluster.map_shared_rank(mine, 0);
    for (int k = 1; k < shards; ++k) r = op(r, *cluster.map_shared_rank(mine, k));
    ++phase;
    return r;
  }

  __device__ long long min(long long v, long long* sh) { return combine(block_min_ll(v, sh), MinOp()); }
  __device__ long long max(long long v, long long* sh) { return combine(block_max_ll(v, sh), MaxOp()); }
  __device__ long long sum(long long v, long long* sh) { return combine(block_sum_ll(v, sh), SumOp()); }
  __device__ int any(int v) { return (int)combine(__syncthreads_or(v) ? 1 : 0, OrOp()); }

  __device__ int argmax(long long v, int i, long long* shv, int* shi) {
    block_argmax_pair(v, i, shv, shi);
    cg::cluster_group cluster = cg::this_cluster();
    const int b = phase & 1;
    if (threadIdx.x == 0) { slot_ll[b] = v; slot_i[b] = i; }
    cluster.sync();
    long long bv = *cluster.map_shared_rank(slot_ll + b, 0);
    int bi = *cluster.map_shared_rank(slot_i + b, 0);
    for (int k = 1; k < shards; ++k)
      argmax_pair(bv, bi, *cluster.map_shared_rank(slot_ll + b, k),
                  *cluster.map_shared_rank(slot_i + b, k));
    ++phase;
    return bi;
  }

  __device__ void bind_sync() {
    __threadfence();
    cg::this_cluster().sync();
  }
};

__device__ __forceinline__ ClusterScope shard_scope(const StepArgs& a, int shards,
                                                    long long* slot_ll, int* slot_i) {
  const int rank = (int)cg::this_cluster().block_rank();
  const int width = a.N / shards;  // the wrapper checks N % shards == 0
  return ClusterScope{rank * width, (rank + 1) * width, rank, shards, slot_ll, slot_i, 0};
}

__global__ void __launch_bounds__(MESH_STEP_THREADS, 1)
    step_chunk_sharded_kernel(const StepArgs a, int shards) {
  __shared__ long long sh_ll[KSS_THREADS / 32];
  __shared__ int sh_i[KSS_THREADS / 32];
  __shared__ long long slot_ll[2];
  __shared__ int slot_i[2];
  ClusterScope scope = shard_scope(a, shards, slot_ll, slot_i);
  const PodScratch sc = pod_scratch(a, 0);
  for (int c = 0; c < a.C; ++c) {
    // ---- 0-4. filter, score, normalize, select over this shard's nodes,
    // each reduction combined across the cluster (pod.cuh)
    const int sel = eval_pod(a, c, sc, sh_ll, sh_i, scope);
    // ---- 5. bind.  Every CTA's reads of the carry for this pod happened
    // before the argmax's cluster barrier.
    bind_pod(a, c, sel, scope);
    scope.bind_sync();  // the next pod reads the carry this one wrote
  }
}

__global__ void __launch_bounds__(MESH_EVAL_THREADS)
    spec_eval_sharded_kernel(const StepArgs a, int shards) {
  __shared__ long long sh_ll[KSS_THREADS / 32];
  __shared__ int sh_i[KSS_THREADS / 32];
  __shared__ long long slot_ll[2];
  __shared__ int slot_i[2];
  ClusterScope scope = shard_scope(a, shards, slot_ll, slot_i);
  const int c = blockIdx.x / shards;
  eval_pod(a, c, pod_scratch(a, c), sh_ll, sh_i, scope);
  // no CTA leaves while another may still read its slots
  cg::this_cluster().sync();
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

extern "C" int kss_step_args_size() { return (int)sizeof(StepArgs); }
extern "C" int kss_mesh_max_shards() { return KSS_MAX_CLUSTER; }

static int launch_clustered(void (*kernel)(const StepArgs, int), const StepArgs* args,
                            int shards, int clusters, int threads, void* stream) {
  if (shards < 1 || shards > KSS_MAX_CLUSTER || args->N % shards != 0 || clusters < 1)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * shards), 1, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)shards;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, *args, shards);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the return value reports it
    return (int)err;
  }
  return (int)cudaGetLastError();
}

// Launches on the caller's stream; no synchronisation.  Each returns
// cudaGetLastError() (or the launch's own error) so a refused launch is
// reported at once.
extern "C" int kss_step_chunk_sharded(const StepArgs* args, int shards, void* stream) {
  return launch_clustered(step_chunk_sharded_kernel, args, shards, 1, MESH_STEP_THREADS, stream);
}

extern "C" int kss_spec_eval_sharded(const StepArgs* args, int shards, void* stream) {
  return launch_clustered(spec_eval_sharded_kernel, args, shards, args->C, MESH_EVAL_THREADS,
                          stream);
}
#endif
