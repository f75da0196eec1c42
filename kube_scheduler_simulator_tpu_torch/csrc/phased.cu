// renormalize_rows: the engine's host-interleaved path (webhook
// extenders, plugin-extender hooks), written for Hopper (sm_90a).  The
// path's evaluation, build_phased's eval_fn (B10), is spec_eval.cu's
// cluster kernel writing the uncompacted StepOut (kernels/phased.py
// phased_eval); its bind is B5's spec_commit_bind on a batch of one
// (spec_commit.cu).
//
// renormalize_rows replaces kube_scheduler_simulator_tpu/framework/
// pipeline.py:198 `renormalize` for R scorers of one pod at once: each
// row is one plugin's NormalizeScore over [N] raw scores that a host hook
// may have edited, against a host-edited feasibility, with pod.cuh's
// normalizers: DefaultNormalizeScore max-scaling (NodeAffinity), its
// reverse form (TaintToleration), InterPodAffinity's float64 min/max with
// truncation (this file is built with -fmad=false), and
// PodTopologySpread's min/max over scored nodes, whose `ignored` mask it
// recomputes from the carry (pipeline.py:225-229, spread.cuh
// spread_score).  A plugin without ScoreExtensions never reaches it: the
// wrapper returns the raws, as the reference does.
//
// Shape: one thread-block cluster of G CTAs per row, CTA r the node slice
// r of slices.cuh (kernels/phased.py renorm_ctas picks G from N); a row's
// min, max and any-scored end in one ClusterScope combine through
// distributed shared memory (scope.cuh), then each CTA writes its slice.
// The engine defers its pod's rows and flushes them in one launch
// (framework/engine.py _hooked_score_phase): one H2D of the stacked raws,
// one launch, one D2H.
//
// What bounds it on this card: its launch and the cluster's barrier; the
// bytes (R rows of [N] int64 in and out) are microseconds of bandwidth at
// 5,000 nodes.  So the parameter is the few fields it reads (RenormArgs)
// and G is small (renorm_ctas: a CTA takes up to three passes of its
// slice).  The host loop around it, one pod at a time, is what the path
// costs.
#include "cluster.cuh"

#define RENORM_THREADS 512

// What a launch reads of the pod's StepArgs (its pod 0): PodTopologySpread's
// rows for spread_score, and N; and the rows' plugin ids (P_AFFINITY,
// P_TAINT, P_SPREAD or P_INTERPOD), R <= KSS_MAX_S.  A parameter of 112
// bytes where StepArgs takes 1,944.
struct RenormArgs {
  const int* sp_c_id;
  const unsigned char* sp_is_score;
  const int* sp_dom_idx;
  const int* sp_counts;
  const double* sp_weight;
  int N;
  int pid[KSS_MAX_S];
};

constexpr unsigned long long kRenormOps = combine_ops(OP_MIN, OP_MAX, OP_OR);

__global__ void __launch_bounds__(RENORM_THREADS) renormalize_rows_kernel(
    const __grid_constant__ RenormArgs a, const long long* raws, const unsigned char* feas,
    long long* out, int width) {
  __shared__ PodShared sh;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), ctas = (int)cluster.num_blocks();
  const int row = (int)blockIdx.x / ctas;
  const int pid = a.pid[row];
  const int N = a.N;
  const NodeSlice ns = node_slice(N, 1, ctas, width, rank);
  const long long* raw = raws + (long long)row * N;
  long long* dst = out + (long long)row * N;
  ClusterScope scope{ns.lo, ns.hi, rank, ctas, PodRows{}, &sh, PodVolumes{}, 0};
  long long v[3] = {LLONG_MAX, LLONG_MIN, 0};  // min, max, any scored
  for (int n = ns.lo + threadIdx.x; n < ns.hi; n += blockDim.x) {
    const long long r = raw[n];
    const bool f = feas[n] != 0;
    if (pid == P_SPREAD) {
      bool ignored = false;
      spread_score(a, 0, n, ignored);
      const bool scored = f && !ignored;
      v[0] = ll_min(v[0], scored ? r : KSS_BIG);
      v[1] = ll_max(v[1], scored ? r : 0);
      v[2] |= scored;
    } else if (pid == P_INTERPOD) {
      v[0] = ll_min(v[0], f ? r : KSS_BIG);
      v[1] = ll_max(v[1], f ? r : -KSS_BIG);
    } else {  // DefaultNormalizeScore: max over raw masked to 0
      v[1] = ll_max(v[1], f ? r : 0);
    }
  }
  const long long* res = scope_combine<3, kRenormOps>(v, scope);
  const long long lo = res[0], hi = res[1];
  const bool any_scored = res[2] != 0;
  // this CTA has read every CTA's slot: it tells the cluster so now, and
  // waits at its end for the others (no CTA leaves while another may
  // still read its slot), so the barrier overlaps the write pass
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  for (int n = ns.lo + threadIdx.x; n < ns.hi; n += blockDim.x) {
    const long long r = raw[n];
    long long o;
    if (pid == P_AFFINITY) {
      o = default_normalize(r, hi, false);
    } else if (pid == P_TAINT) {
      o = default_normalize(r, hi, true);
    } else if (pid == P_SPREAD) {
      bool ignored = false;
      spread_score(a, 0, n, ignored);
      o = spread_normalize(r, ignored, lo, hi, any_scored);
    } else {
      o = interpod_normalize(r, lo, hi);
    }
    dst[n] = o;
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

extern "C" int kss_step_args_size() { return (int)sizeof(StepArgs); }

// Launches on the caller's stream; no synchronisation.  r rows (1 to
// KSS_MAX_S) of args->N nodes, each one cluster of `ctas` CTAs (1 to
// KSS_MAX_CTAS) over the node slices of slices.cuh, with the pod of
// args (its pod 0) and the feasibility feas [N].  Returns the launch's
// error or cudaGetLastError(), so a refused launch is reported at once.
extern "C" int kss_renormalize_rows(const StepArgs* args, const int* pids, int r,
                                    const long long* raws, const unsigned char* feas,
                                    long long* out, int ctas, void* stream) {
  if (r < 1 || r > KSS_MAX_S || ctas < 1 || ctas > KSS_MAX_CTAS || args->N < 1)
    return (int)cudaErrorInvalidValue;
  int max_dynamic = 0;
  const cudaError_t err = cluster_attributes<renormalize_rows_kernel>(&max_dynamic);
  if (err != cudaSuccess) return (int)err;
  RenormArgs ra = {};
  ra.sp_c_id = args->sp_c_id;
  ra.sp_is_score = args->sp_is_score;
  ra.sp_dom_idx = args->sp_dom_idx;
  ra.sp_counts = args->sp_counts;
  ra.sp_weight = args->sp_weight;
  ra.N = args->N;
  for (int i = 0; i < r; ++i) ra.pid[i] = pids[i];
  const int width = slice_width(args->N, 1, ctas);
  const int t = (width + 31) / 32 * 32;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(r * ctas), 1, 1);
  cfg.blockDim = dim3((unsigned)(t > RENORM_THREADS ? RENORM_THREADS : t), 1, 1);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return launch_result(cudaLaunchKernelEx(&cfg, renormalize_rows_kernel, ra, raws, feas, out,
                                          width));
}
#endif
