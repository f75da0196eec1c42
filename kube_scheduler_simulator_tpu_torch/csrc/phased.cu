// renormalize_row: the engine's host-interleaved path (webhook extenders,
// plugin-extender hooks), written for Hopper (sm_90a).  The path's
// evaluation, build_phased's eval_fn (B10), is spec_eval.cu's cluster
// kernel writing the uncompacted StepOut (kernels/phased.py phased_eval);
// its bind is B5's spec_commit_bind on a batch of one (spec_commit.cu).
//
// renormalize_row replaces kube_scheduler_simulator_tpu/framework/pipeline.py:198
// `renormalize`: one plugin's NormalizeScore over [N] raw scores that a
// host hook may have edited, against a host-edited feasibility, with
// pod.cuh's normalizers: DefaultNormalizeScore max-scaling (NodeAffinity),
// its reverse form (TaintToleration), InterPodAffinity's float64 min/max
// with truncation (this file is built with -fmad=false), and
// PodTopologySpread's min/max over scored nodes, whose `ignored` mask it
// first recomputes from the carry (pipeline.py:225-229, spread.cuh
// spread_score).  A plugin without ScoreExtensions never reaches it: the
// wrapper returns the raws, as the reference does.  One block of 1024
// threads: two block reductions and one pass over N.
//
// What bounds it on this card: its launch; the bytes (a few rows of [N])
// are microseconds of bandwidth at 5,000 nodes.  The host loop around it,
// one pod at a time with a D2H between its phases, is what the path
// costs.
#include "pod.cuh"

__global__ void __launch_bounds__(KSS_THREADS) renormalize_row_kernel(
    const StepArgs a, int pid, const long long* raw, const unsigned char* feas,
    unsigned char* ign, long long* out) {
  __shared__ long long sh_ll[KSS_THREADS / 32];
  const int N = a.N;
  long long l = LLONG_MAX, h = LLONG_MIN;
  int any = 0;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const long long r = raw[n];
    const bool f = feas[n] != 0;
    if (pid == P_SPREAD) {
      bool ignored = false;
      spread_score(a, 0, n, ignored);
      ign[n] = ignored;
      const bool scored = f && !ignored;
      l = ll_min(l, scored ? r : KSS_BIG);
      h = ll_max(h, scored ? r : 0);
      any |= scored;
    } else if (pid == P_INTERPOD) {
      l = ll_min(l, f ? r : KSS_BIG);
      h = ll_max(h, f ? r : -KSS_BIG);
    } else {  // DefaultNormalizeScore: max over raw masked to 0
      h = ll_max(h, f ? r : 0);
    }
  }
  long long lo = 0;
  if (pid == P_SPREAD || pid == P_INTERPOD) lo = block_min_ll(l, sh_ll);
  const long long hi = block_max_ll(h, sh_ll);
  const bool any_scored = pid == P_SPREAD && __syncthreads_or(any) != 0;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const long long r = raw[n];
    long long v;
    if (pid == P_AFFINITY) v = default_normalize(r, hi, false);
    else if (pid == P_TAINT) v = default_normalize(r, hi, true);
    else if (pid == P_SPREAD) v = spread_normalize(r, ign[n] != 0, lo, hi, any_scored);
    else v = interpod_normalize(r, lo, hi);
    out[n] = v;
  }
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

extern "C" int kss_step_args_size() { return (int)sizeof(StepArgs); }

// Launch on the caller's stream; no synchronisation.  Returns
// cudaGetLastError() so a refused launch is reported at once.
extern "C" int kss_renormalize_row(const StepArgs* args, int pid, const long long* raw,
                                   const unsigned char* feas, unsigned char* ign, long long* out,
                                   void* stream) {
  renormalize_row_kernel<<<1, KSS_THREADS, 0, (cudaStream_t)stream>>>(*args, pid, raw, feas, ign,
                                                                      out);
  return (int)cudaGetLastError();
}
#endif
