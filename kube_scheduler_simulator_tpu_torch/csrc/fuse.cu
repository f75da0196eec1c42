// B11: one speculative round of K sessions in one launch, written for
// Hopper (sm_90a).
//
// It replaces kube_scheduler_simulator_tpu/parallel/fuse.py:356
// `FuseCoordinator._run_fused`, the `jax.jit(jax.vmap(solo_fn))` at :365
// over K sessions' carries and pod batches stacked on a leading session
// axis, where solo_fn is the dense round (`_eval_fn` + `_oracle_core`)
// or the sparse round (`_sparse_round_fn`, which holds the oracle).
// Here nothing is stacked: each session keeps its own statics, carry,
// batch, outputs and scratch, and the kernel takes a table of K StepArgs
// (csrc/common.cuh), one per session, as a __grid_constant__ parameter.
// The session index picks the entry:
//
//   spec_eval_fused    grid (B, K): block (b, s) runs eval_pod for pod b
//                      of session s (spec_eval's body, one block a pod);
//   spec_round_fused   grid (B, K): block (b, s) runs spec_round_pod for
//                      pod b of session s, with s's own candidate
//                      scratch (spec_round's body);
//   spec_oracle_fused  grid K: block s runs spec_oracle_block over
//                      session s's batch (spec_oracle's body).
//
// Every block runs a solo kernel's device body (spec.cuh, pod.cuh) on
// one session's own arguments, so each session's outputs equal its solo
// launch bit for bit (spec_eval's cluster split changes no bit either).
// The members share B, N, the output widths, the pack width and the
// candidate cap (the fuse family guarantees it; the wrapper in
// kernels/fuse.py checks it).
//
// The table: K x sizeof(StepArgs) = K x 1,640 bytes, at most 26,240 for
// K = 16, inside the 32,764 bytes CUDA 12.1+ allows a kernel's
// parameters on this card.  The table's size is templated on K rounded
// up to 2, 4, 8 or 16, so a small batch does not pass 26 KB.  Being a
// __grid_constant__, it is read in place from the parameter space,
// indexed by blockIdx.y, never copied per thread.
//
// What bounds it: as the solo kernels, the latency of one pod's phases
// on one SM per wave of blocks; K sessions give the card K times the
// blocks of one launch, which is the point when B alone does not fill
// 132 SMs.
#include "spec.cuh"

#define KSS_MAX_FUSE 16

template <int KM>
struct FusedStepArgs {
  StepArgs s[KM];
};

struct FusedOracleArgs {
  const void* packed[KSS_MAX_FUSE];
  const int* reject[KSS_MAX_FUSE];
  const int* selected[KSS_MAX_FUSE];
  int* out_k[KSS_MAX_FUSE];
  int pack_bytes, B, N;
};

template <int KM>
__global__ void __launch_bounds__(SPEC_THREADS)
    spec_eval_fused_kernel(const __grid_constant__ FusedStepArgs<KM> fa) {
  __shared__ PodShared sh;
  const StepArgs& a = fa.s[blockIdx.y];
  const int c = blockIdx.x;
  eval_pod(a, c, pod_scratch(a, c), sh);
}

template <int KM>
__global__ void __launch_bounds__(SPEC_THREADS)
    spec_round_fused_kernel(const __grid_constant__ FusedStepArgs<KM> fa) {
  __shared__ PodShared sh;
  spec_round_pod(fa.s[blockIdx.y], blockIdx.x, sh);
}

__global__ void __launch_bounds__(SPEC_THREADS)
    spec_oracle_fused_kernel(const __grid_constant__ FusedOracleArgs fa) {
  __shared__ int sh_k;
  const int s = blockIdx.x;
  spec_oracle_block(fa.packed[s], fa.pack_bytes, fa.reject[s], fa.selected[s], fa.B, fa.N,
                    fa.out_k[s], sh_k);
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

extern "C" int kss_step_args_size() { return (int)sizeof(StepArgs); }
extern "C" int kss_fuse_max() { return KSS_MAX_FUSE; }

template <int KM, bool ROUND>
static int launch_table(const StepArgs* table, int k, cudaStream_t stream) {
  FusedStepArgs<KM> fa;
  for (int i = 0; i < k; ++i) fa.s[i] = table[i];
  const dim3 grid(table[0].C, k);
  if (ROUND) spec_round_fused_kernel<KM><<<grid, SPEC_THREADS, 0, stream>>>(fa);
  else spec_eval_fused_kernel<KM><<<grid, SPEC_THREADS, 0, stream>>>(fa);
  return (int)cudaGetLastError();
}

template <bool ROUND>
static int launch(const StepArgs* table, int k, void* stream) {
  if (k < 1 || k > KSS_MAX_FUSE || table[0].C < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (k <= 2) return launch_table<2, ROUND>(table, k, st);
  if (k <= 4) return launch_table<4, ROUND>(table, k, st);
  if (k <= 8) return launch_table<8, ROUND>(table, k, st);
  return launch_table<16, ROUND>(table, k, st);
}

// Launches on the caller's stream; no synchronisation.  Each returns
// cudaGetLastError() so a refused launch is reported at once.
extern "C" int kss_spec_eval_fused(const StepArgs* table, int k, void* stream) {
  return launch<false>(table, k, stream);
}

extern "C" int kss_spec_round_fused(const StepArgs* table, int k, void* stream) {
  return launch<true>(table, k, stream);
}

extern "C" int kss_spec_oracle_fused(const void* const* packed, const int* const* reject,
                                     const int* const* selected, int* const* out_k, int k,
                                     int pack_bytes, int B, int N, void* stream) {
  if (k < 1 || k > KSS_MAX_FUSE) return (int)cudaErrorInvalidValue;
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
