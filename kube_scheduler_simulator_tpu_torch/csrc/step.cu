// step_chunk: the scheduling step of a chunk of pods, written for Hopper
// (sm_90a).
//
// It replaces kube_scheduler_simulator_tpu/framework/pipeline.py:378
// `build_step.step`, which the JAX package runs as a `lax.scan` over a
// chunk of pods (framework/replay.py:1130 `_scan_for`).  The TPU's
// sequential scan becomes a loop inside ONE thread block of 1024 threads:
// pods run in queue order, nodes are spread over the threads, and
// __syncthreads separates the phases of each pod:
//
//   0. pre-reductions over N: the per-slot spread minima and InterPod's
//      cluster-wide matched total;
//   1. per node, each filter in config order with its filter_skip, the
//      first-fail word and feasibility; a block sum -> feasible_count;
//   2. per node, each raw score with its score_skip, written to the
//      outputs and an int64 [S, N] scratch; the raw_overflow check;
//   3. block min/max reductions for the normalizing scorers;
//   4. per node, normalize x weight summed into the int64 total (-1 where
//      infeasible); a block argmax (value desc, index asc); feasible_count
//      > 0 and is_pad applied;
//   5. the bind into the carry, in place (pod.cuh bind_pod): the core row
//      at `selected`, the spread same-domain increments, the InterPod
//      five-matrix increments and matched_total, the NodePorts, disk and
//      CSI-volume bits at `selected`, the cluster-wide ReadWriteOncePod
//      bits, and the PVs VolumeBinding's greedy choice claims there.
//
// A pod a PreFilter rejected (pod.cuh prefilter_reject: VolumeRestrictions'
// ReadWriteOncePod conflict, or a compile-time reject) still writes its
// filter and score outputs, with feasible_count 0, and selects -1.
//
// What bounds it on this card: per-pod latency on one SM.  The bytes a pod
// touches (a few rows of [N] per plugin plus the compact outputs) are
// small against the card's bandwidth; the time goes to the dependent
// chain of phases and block barriers, pod after pod, on one of 132 SMs.
// B12 (mesh.cu step_chunk_sharded) spreads a pod over a thread-block
// cluster, one node slice per CTA; a persistent grid with grid-wide
// phases is later work.
//
// Phases 0-4 are the per-pod body in pod.cuh, which the speculative
// wave's kernels share.
//
// Exactness: integer math is int64 as in the reference, with floor
// division where jnp floors (common.cuh floordiv); the float64 paths
// (balanced allocation, the spread weighted sum, the InterPod
// normalization) are built with -fmad=false so no multiply-add contracts.
#include "pod.cuh"

__global__ void __launch_bounds__(KSS_THREADS, 1) step_chunk_kernel(const StepArgs a) {
  __shared__ long long sh_ll[KSS_THREADS / 32];
  __shared__ int sh_i[KSS_THREADS / 32];
  const PodScratch sc = pod_scratch(a, 0);
  for (int c = 0; c < a.C; ++c) {
    // ---- 0-4. filter, score, normalize, select (pod.cuh)
    const int sel = eval_pod(a, c, sc, sh_ll, sh_i);

    // ---- 5. bind.  Every read of the carry for this pod happened before
    // the barriers of block_argmax; a rejected or padded pod binds nothing.
    bind_pod(a, c, sel);
    __syncthreads();  // the next pod reads the carry this one wrote
  }
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

extern "C" int kss_step_args_size() { return (int)sizeof(StepArgs); }

// Launch on the caller's stream; no synchronisation.  Returns
// cudaGetLastError() so a refused launch is reported at once.
extern "C" int kss_step_chunk(const StepArgs* args, void* stream) {
  step_chunk_kernel<<<1, KSS_THREADS, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
#endif
