// step_chunk: the scheduling step of a chunk of pods, written for Hopper
// (sm_90a), with a pod's nodes spread over a thread-block cluster.
//
// It replaces kube_scheduler_simulator_tpu/framework/pipeline.py:378
// `build_step.step`, which the JAX package runs as a `lax.scan` over a
// chunk of pods (framework/replay.py:1130 `_scan_for`), and B12's
// parallel/mesh.py:130 `sharded_step` (the same step with the node axis
// sharded over the mesh's "nodes" extent).  The TPU's sequential scan
// becomes a loop inside ONE cluster of S CTAs: the cluster walks the
// chunk's pods in queue order, and CTA r owns the contiguous node slice
// [r W, (r + 1) W), W = ceil(N / S) (the last slice may be ragged, and a
// slice empty, so any N is taken).  A CTA is sized to its slice, about
// one thread per node.  S is 16 where cudaOccupancyMaxActiveClusters
// finds room for a non-portable cluster of 16, else 8; the mesh's
// wrapper (kernels/mesh.py step_chunk_sharded) passes its own S <= 8.
//
// Per pod (pod.cuh eval_pod, three combines of ClusterScope, scope.cuh):
//
//   0. the pod's NodeVolumeLimits volumes and VolumeBinding candidates
//      compacted into shared memory (volumes.cuh nvl_compact, vb_compact);
//   1. the pre-pass: every checked spread slot's minimum, one combine;
//   2. one node loop: filters in config order, raw scores, the node
//      statistics (feasible count, raw overflow, the normalizers' min, max
//      and any), one combine;
//   3. normalize x weight, total, local argmax, one argmax combine;
//   4. the bind (pod.cuh bind_pod), then a block barrier.
//
// The bind needs no cluster barrier.  The cluster-wide carries (InterPod's
// matched_total, the ReadWriteOncePod bits, VolumeBinding's claims) are
// replicated in every CTA's shared memory: every CTA applies the same
// increments from (pod, selected), and rank 0 writes them back once, at
// the end of the launch.  Every other carry row a pod reads at node n is
// read only by the CTA that owns n: Fit's requested / nonzero / num_pods,
// NodePorts' bits, VolumeRestrictions' disk rows, NodeVolumeLimits' bitmap
// row and the slice's per-(node, driver) counts, the spread counts and the
// InterPod matrices of the node; the spread minima and the argmax read
// other slices only through the combines, after the cluster barrier of the
// pod.  The owner of `selected` makes the exactly-once row updates there
// (core, NodePorts, disk and CSI rows); each CTA updates its slice of the
// spread counts and the InterPod matrices.  So a block barrier orders a
// bind before the next pod's reads.
//
// A pod a PreFilter rejected (VolumeRestrictions' ReadWriteOncePod
// conflict, or a compile-time reject) still writes its filter and score
// outputs, with feasible_count 0, and selects -1.
//
// What bounds it on this card: per-pod latency.  The bytes a pod touches
// (a few rows of [N] per plugin plus the compact outputs) are small
// against the card's bandwidth; the time is the chain of the node loop
// over a CTA's slice, three cluster barriers and the bind, pod after pod.
// The design spreads the node work over S SMs, keeps the raw scores in
// shared memory (in device memory only past about 227 KB a CTA, where
// kss_step_plan gives each CTA a slot of StepArgs.spill: at S = 16 and
// eight scorers, fleets past roughly 45,000 nodes), makes every reduction of a
// pod one of three vector combines (one warp reads the S partials through
// distributed shared memory and broadcasts them through the block's own),
// and walks only a pod's own volumes and candidate PVs.
//
// The phase clock (-DKSS_PHASE_CLOCK, the "step_clock" build of
// kernels/build.py) has rank 0's thread 0 stamp each phase of each pod
// (common.cuh KSS_CLOCK_SLOTS); every other build compiles it out.
//
// Exactness: integer math is int64 as in the reference, with floor
// division where jnp floors (common.cuh floordiv); the float64 paths
// (balanced allocation, the spread weighted sum, the InterPod
// normalization) are built with -fmad=false so no multiply-add contracts;
// no float sum runs over the node axis, so the slicing changes no bit.
#include "step_kernel.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>

extern "C" int kss_step_args_size() { return (int)sizeof(StepArgs); }

// Launch on the caller's stream; no synchronisation.  `shards` (1 to
// KSS_MAX_SHARDS) and a.spill as kss_step_plan (step_kernel.cuh) gave
// them.  Returns the launch's error or cudaGetLastError(), so a refused
// launch is reported at once.
extern "C" int kss_step_chunk(const StepArgs* args, int shards, void* stream) {
  if (shards < 1 || shards > KSS_MAX_SHARDS) return (int)cudaErrorInvalidValue;
  return launch_step_cluster(args, shards, stream);
}
#endif
