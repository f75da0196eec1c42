// spec_eval and spec_oracle: the dense round of the speculative wave,
// written for Hopper (sm_90a).
//
// spec_eval replaces kube_scheduler_simulator_tpu/parallel/speculative.py:318
// `_eval_fn`: the step's compact evaluation, vmapped over a batch of B
// pods against ONE frozen carry, with no bind.  Here the batch axis is
// the grid: block b runs the step's evaluation (pod.cuh eval_pod, three block
// combines) for
// pod b and writes the compact outputs at row b.  Each block has its own
// scratch slot; nothing writes the carry, so the blocks share it safely.
//
// spec_oracle replaces speculative.py:299 `_oracle_core`, the dirty-node
// prefix (spec.cuh spec_oracle_block), one block.  It runs after
// spec_eval and after spec_round, on the same stream.
//
// What bounds spec_eval on this card: like step_chunk, the latency of one
// pod's dependent phases on one SM; but B pods now run at once on up to
// B SMs, so a round of B pods costs about one pod's latency per wave of
// blocks.  spec_oracle reads B x B packed words and is bound by its
// launch.
#include "spec.cuh"

__global__ void __launch_bounds__(SPEC_THREADS) spec_eval_kernel(const __grid_constant__ StepArgs a) {
  __shared__ PodShared sh;
  const int c = blockIdx.x;
  eval_pod(a, c, pod_scratch(a, c), sh);
}

__global__ void __launch_bounds__(SPEC_THREADS) spec_oracle_kernel(
    const void* packed, int pack_bytes, const int* reject, const int* selected, int B, int N,
    int* out_k) {
  __shared__ int sh_k;
  spec_oracle_block(packed, pack_bytes, reject, selected, B, N, out_k, sh_k);
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

extern "C" int kss_step_args_size() { return (int)sizeof(StepArgs); }

// Launches on the caller's stream; no synchronisation.  Each returns
// cudaGetLastError() so a refused launch is reported at once.
extern "C" int kss_spec_eval(const StepArgs* args, void* stream) {
  spec_eval_kernel<<<args->C, SPEC_THREADS, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

extern "C" int kss_spec_oracle(const void* packed, int pack_bytes, const int* reject,
                               const int* selected, int B, int N, int* out_k, void* stream) {
  spec_oracle_kernel<<<1, SPEC_THREADS, 0, (cudaStream_t)stream>>>(packed, pack_bytes, reject,
                                                                   selected, B, N, out_k);
  return (int)cudaGetLastError();
}
#endif
