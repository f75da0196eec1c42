// spec_round: the sparse round of the speculative wave, written for
// Hopper (sm_90a).  One block per pod of the batch runs spec_round_pod
// (spec.cuh), which documents the round; the conflict oracle that the
// JAX package fuses into the same jit is spec_oracle in spec_eval.cu,
// launched right after on the same stream.
#include "spec.cuh"

__global__ void __launch_bounds__(SPEC_THREADS) spec_round_kernel(const __grid_constant__ StepArgs a) {
  __shared__ PodShared sh;
  spec_round_pod(a, blockIdx.x, sh);
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

extern "C" int kss_step_args_size() { return (int)sizeof(StepArgs); }

// Launch on the caller's stream; no synchronisation.  Returns
// cudaGetLastError() so a refused launch is reported at once.
extern "C" int kss_spec_round(const StepArgs* args, void* stream) {
  spec_round_kernel<<<args->C, SPEC_THREADS, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
#endif
