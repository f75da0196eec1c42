// B11's oracle: the conflict oracle of K sessions' rounds in one launch,
// written for Hopper (sm_90a).
//
// It replaces the oracle inside kube_scheduler_simulator_tpu/parallel/
// fuse.py:356 `FuseCoordinator._run_fused`, the `jax.jit(jax.vmap(solo_fn))`
// at :365 over K sessions stacked on a leading axis, where solo_fn's
// oracle is speculative.py:299 `_oracle_core` (the dense round's, and the
// one `_sparse_round_fn` holds).  Here nothing is stacked: block s runs
// spec_oracle_block (spec.cuh) over session s's own batch, so each
// session's K equals its solo spec_oracle launch bit for bit.  The fused
// rounds' other kernels are table launches of the solo kernels: the dense
// eval is spec_eval_cluster (spec_eval.cu), the sparse round its pod
// groups (spec_round.cu).
//
// What bounds it: as the solo oracle, its launch; K sessions share one.
#include "spec.cuh"

struct FusedOracleArgs {
  const void* packed[KSS_MAX_TABLE];
  const int* reject[KSS_MAX_TABLE];
  const int* selected[KSS_MAX_TABLE];
  int* out_k[KSS_MAX_TABLE];
  int pack_bytes, B, N;
};

__global__ void __launch_bounds__(SPEC_THREADS)
    spec_oracle_fused_kernel(const __grid_constant__ FusedOracleArgs fa) {
  __shared__ int sh_k;
  const int s = blockIdx.x;
  spec_oracle_block(fa.packed[s], fa.pack_bytes, fa.reject[s], fa.selected[s], fa.B, fa.N,
                    fa.out_k[s], sh_k);
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

extern "C" int kss_fuse_max() { return KSS_MAX_TABLE; }

// Launches on the caller's stream; no synchronisation.  Returns
// cudaGetLastError() so a refused launch is reported at once.
extern "C" int kss_spec_oracle_fused(const void* const* packed, const int* const* reject,
                                     const int* const* selected, int* const* out_k, int k,
                                     int pack_bytes, int B, int N, void* stream) {
  if (k < 1 || k > KSS_MAX_TABLE) return (int)cudaErrorInvalidValue;
  FusedOracleArgs fa;
  for (int i = 0; i < k; ++i) {
    fa.packed[i] = packed[i];
    fa.reject[i] = reject[i];
    fa.selected[i] = selected[i];
    fa.out_k[i] = out_k[i];
  }
  fa.pack_bytes = pack_bytes;
  fa.B = B;
  fa.N = N;
  spec_oracle_fused_kernel<<<k, SPEC_THREADS, 0, (cudaStream_t)stream>>>(fa);
  return (int)cudaGetLastError();
}
#endif
