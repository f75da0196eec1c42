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
//   * general (any other carry: NodePorts, spread, InterPod): one block
//     walks the batch in order and applies the step's bind (pod.cuh
//     bind_pod) with the selection masked to -1 past the accepted
//     prefix: the JAX package's lax.scan of `_bind_phase`.
//
// What bounds it on this card: the core-only variant is a few hundred
// 8-byte atomics, bound by its launch; the general one walks up to B
// binds one after another on one SM, each a pass over the [G, N] and
// [T, N] domain rows of the pod's groups and terms.
#include "pod.cuh"

#define COMMIT_THREADS 256

__global__ void __launch_bounds__(COMMIT_THREADS) spec_commit_core_kernel(
    const StepArgs a, const int* selected, int k) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.C || b >= k) return;
  const int sel = selected[b];
  if (sel < 0) return;
  for (int r = 0; r < a.R; ++r)
    atomicAdd((unsigned long long*)&a.requested[(long long)sel * a.R + r],
              (unsigned long long)a.pod_requests[(long long)b * a.R + r]);
  for (int j = 0; j < 2; ++j)
    atomicAdd((unsigned long long*)&a.nonzero[(long long)sel * 2 + j],
              (unsigned long long)a.pod_nonzero[(long long)b * 2 + j]);
  atomicAdd((unsigned long long*)&a.num_pods[sel], 1ULL);
}

__global__ void __launch_bounds__(KSS_THREADS, 1) spec_commit_bind_kernel(
    const StepArgs a, const int* selected, int k) {
  for (int b = 0; b < a.C; ++b) {
    const int sel = b < k ? selected[b] : -1;
    bind_pod(a, b, sel);
    __syncthreads();  // the next bind may touch the rows this one wrote
  }
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

extern "C" int kss_step_args_size() { return (int)sizeof(StepArgs); }

// Launch on the caller's stream; no synchronisation.  Returns
// cudaGetLastError() so a refused launch is reported at once.
extern "C" int kss_spec_commit(const StepArgs* args, const int* selected, int k, int core_only,
                               void* stream) {
  if (core_only) {
    const int blocks = (args->C + COMMIT_THREADS - 1) / COMMIT_THREADS;
    spec_commit_core_kernel<<<blocks, COMMIT_THREADS, 0, (cudaStream_t)stream>>>(*args, selected,
                                                                                 k);
  } else {
    spec_commit_bind_kernel<<<1, KSS_THREADS, 0, (cudaStream_t)stream>>>(*args, selected, k);
  }
  return (int)cudaGetLastError();
}
#endif
