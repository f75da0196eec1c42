// spec_commit: the speculative wave's commit of a round's accepted
// binds into the carry, in place, written for Hopper (sm_90a).
//
// It replaces kube_scheduler_simulator_tpu/parallel/speculative.py:501
// `_commit_fn`, in its two variants; the rows b < k of the batch are the
// accepted prefix.
//
//   * core-only (the carry holds nothing but "core"): one thread per
//     batch row adds the pod's requests, its non-zero requests and 1 at
//     row `selected` with 64-bit atomicAdd.  Integer addition is exact in
//     any order (and accepted pods bind distinct nodes anyway), so this
//     is the JAX package's one batched scatter-add.
//   * general (any other carry: NodePorts, spread, InterPod, and on the
//     host path's bind of one pod (framework/pipeline.py Phased.bind) the
//     volume family): a grid of CTAs over node slices, ceil(N / 128) CTAs
//     of 128 nodes.  Each CTA walks the accepted binds b < k in batch
//     order and applies the step's bind (pod.cuh bind_pod) to its own
//     slice: the spread counts' and the InterPod matrices' same-domain
//     increments.  The CTA that owns `selected` makes that bind's
//     exactly-once row updates there (core, NodePorts, disk and CSI rows),
//     and the last CTA walks every bind for the cluster-wide carries
//     (InterPod's matched_total, the ReadWriteOncePod bits, VolumeBinding's
//     claims), so they are set without atomics and in batch order: the JAX
//     package's lax.scan of `_bind_phase`.  A bind's node-axis updates
//     read only statics (at `selected` and at the node itself) and write
//     only the node itself, so node slices never depend on each other
//     across the batch, and no CTA waits for another.  Within a CTA each
//     element is always updated by the same thread, so consecutive binds
//     need no barrier.  The stream never carries the volume family
//     (parallel/speculative.py speculation_ok admits no volume plugin);
//     the host path's bind does, and its claims run in batch order on the
//     last CTA.
//
// On a card mesh (B12b, kernels/mesh.py spec_commit_cards) each card
// launches it over its own node slice, `selected` holding the mesh's node
// indices: a card adds only the rows of the nodes it owns (core), or
// makes the exactly-once updates where it owns `selected` and its slice's
// same-domain increments (general, the domain rows whole on every card:
// common.cuh whole_at); every card keeps the cluster-wide carries, so
// each one's last CTA walks every bind for them.
//
// What bounds it on this card: the core-only variant is a few hundred
// 8-byte atomics, bound by its launch; the general one is the chain of
// the k binds within one CTA, each a ballot over the pod's groups and
// terms (a warp finds the ones it changes, 32 at a time) and a pass of
// 128 nodes for each of them, with the CTAs in parallel over the nodes.
//
// Where the host will not cut a round's K (a core-only carry, no
// interaction rule, no gang: parallel/speculative.py `commit_folds`), the
// core-only commit is not launched at all: csrc/oracle.cu applies it in
// the oracle's launch, which knows K on the device (its rows are added
// while the oracle's gathers run, and the rows past K taken back), and
// only those atomics remain of its cost.  The standalone core kernel
// stays for the core-only rounds the host may cut after reading K (the
// interaction rule of label-coupled plugins never applies to a core-only
// carry, but a gang boundary does).
#include "pod.cuh"

#define COMMIT_THREADS 256

__global__ void __launch_bounds__(COMMIT_THREADS) spec_commit_core_kernel(
    const StepArgs a, const int* selected, int k) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.C || b >= k) return;
  const int sel = selected[b] - a.node_base;  // local; a card mesh's other cards own the rest
  if (selected[b] < 0 || sel < 0 || sel >= a.N) return;
  for (int r = 0; r < a.R; ++r)
    atomicAdd((unsigned long long*)&a.requested[(long long)sel * a.R + r],
              (unsigned long long)a.pod_requests[(long long)b * a.R + r]);
  for (int j = 0; j < 2; ++j)
    atomicAdd((unsigned long long*)&a.nonzero[(long long)sel * 2 + j],
              (unsigned long long)a.pod_nonzero[(long long)b * 2 + j]);
  atomicAdd((unsigned long long*)&a.num_pods[sel], 1ULL);
}

#define COMMIT_SLICE 128  // nodes (and threads) of a general commit's CTA

template <bool W>
__global__ void __launch_bounds__(COMMIT_SLICE) spec_commit_bind_kernel(
    const __grid_constant__ StepArgs a, const int* selected, int k) {
  const int lo = min((int)blockIdx.x * COMMIT_SLICE, a.N), hi = min(lo + COMMIT_SLICE, a.N);
  const bool cluster_wide = blockIdx.x == gridDim.x - 1;
  const PodVolumes none{};
  for (int b = 0; b < min(k, a.C); ++b) {
    const int sel = selected[b] - a.node_base;
    bind_pod<W>(a, b, sel, lo, hi, sel >= lo && sel < hi, cluster_wide, none);
  }
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

extern "C" int kss_step_args_size() { return (int)sizeof(StepArgs); }

static int commit_blocks(const StepArgs* args) {
  return args->N > 0 ? (args->N + COMMIT_SLICE - 1) / COMMIT_SLICE : 1;
}

// The device memory a general commit's launch needs in a.vb_masks
// (common.cuh vb_mask_words), to *mask_bytes.
extern "C" int kss_commit_plan(const StepArgs* args, long long* mask_bytes) {
  *mask_bytes = vb_mask_words(args, 1) * 8 * commit_blocks(args) * COMMIT_SLICE;
  return 0;
}

// Launch on the caller's stream; no synchronisation; a.vb_masks set where
// kss_commit_plan gave mask bytes.  Returns cudaGetLastError() so a refused
// launch is reported at once.
extern "C" int kss_spec_commit(const StepArgs* args, const int* selected, int k, int core_only,
                               void* stream) {
  if (core_only) {
    const int blocks = (args->C + COMMIT_THREADS - 1) / COMMIT_THREADS;
    spec_commit_core_kernel<<<blocks, COMMIT_THREADS, 0, (cudaStream_t)stream>>>(*args, selected,
                                                                                 k);
  } else {
    if (vb_masks_missing(args, 1)) return (int)cudaErrorInvalidValue;
    const int blocks = commit_blocks(args);
    // W as common.cuh's: a pod past KSS_MAX_VBK claims binds by the wide walk
    by_wide(args, 1, [&](auto wide) {
      constexpr bool W = decltype(wide)::value;
      spec_commit_bind_kernel<W><<<blocks, COMMIT_SLICE, 0, (cudaStream_t)stream>>>(
          *args, selected, k);
      return 0;
    });
  }
  return (int)cudaGetLastError();
}
#endif
