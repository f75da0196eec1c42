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
//   5. the bind into the carry, in place: the core row at `selected`,
//      the spread same-domain increments, the InterPod five-matrix
//      increments and matched_total.
//
// What bounds it on this card: per-pod latency on one SM.  The bytes a pod
// touches (a few rows of [N] per plugin plus the compact outputs) are
// small against the card's bandwidth; the time goes to the dependent
// chain of phases and block barriers, pod after pod, on one of 132 SMs.
// Spreading a pod over a thread-block cluster, or a persistent grid with
// grid-wide phases, is later work.
//
// Exactness: integer math is int64 as in the reference, with floor
// division where jnp floors (common.cuh floordiv); the float64 paths
// (balanced allocation, the spread weighted sum, the InterPod
// normalization) are built with -fmad=false so no multiply-add contracts.
#include "common.cuh"
#include "fit.cuh"
#include "affinity.cuh"
#include "taints.cuh"
#include "spread.cuh"
#include "interpod.cuh"

__device__ int filter_code(const StepArgs& a, int pid, int c, int n, const long long* sp_mins,
                           bool ip_any_aff, int ip_total_any) {
  switch (pid) {
    case P_FIT:
      return fit_filter(a, c, n);
    case P_AFFINITY:
      return a.aff_filter_skip[c] ? 0 : affinity_filter(a, c, n);
    case P_TAINT:
      return taint_filter(a, c, n);
    case P_SPREAD:
      return a.sp_filter_skip[c] ? 0 : spread_filter(a, c, n, sp_mins);
    case P_INTERPOD:
      return a.ip_filter_skip[c] ? 0 : interpod_filter(a, c, n, ip_any_aff, ip_total_any);
  }
  return 0;
}

__device__ __forceinline__ bool score_skipped(const StepArgs& a, int pid, int c) {
  if (pid == P_AFFINITY) return a.aff_score_skip[c] != 0;
  if (pid == P_SPREAD) return a.sp_score_skip[c] != 0;
  return false;
}

__device__ long long score_raw(const StepArgs& a, int pid, int c, int n, bool& ignored) {
  switch (pid) {
    case P_FIT:
      return fit_score(a, c, n);
    case P_BALANCED:
      return balanced_score(a, c, n);
    case P_AFFINITY:
      return affinity_score(a, c, n);
    case P_TAINT:
      return taint_score(a, c, n);
    case P_SPREAD:
      return spread_score(a, c, n, ignored);
    case P_INTERPOD:
      return interpod_score(a, c, n);
  }
  return 0;
}

__device__ __forceinline__ bool normalizes(int pid) {
  return pid == P_AFFINITY || pid == P_TAINT || pid == P_SPREAD || pid == P_INTERPOD;
}

__device__ __forceinline__ void store_packed(const StepArgs& a, long long idx, long long word) {
  switch (a.pack_bytes) {
    case 1: ((unsigned char*)a.out_packed)[idx] = (unsigned char)word; break;
    case 2: ((unsigned short*)a.out_packed)[idx] = (unsigned short)word; break;
    case 4: ((int*)a.out_packed)[idx] = (int)word; break;
    default: ((long long*)a.out_packed)[idx] = word; break;
  }
}

// Compact raw store; returns 1 when the value does not survive the
// narrowing that is checked (the i16 group on the first tier, the i32
// group on the second; pipeline.py:412-421).  The i8 group is in range
// by its compile-time bound.
__device__ __forceinline__ int store_raw(const StepArgs& a, int s, int c, int n, long long raw) {
  const int row = a.score_row[s];
  switch (a.score_group[s]) {
    case G_RAW8:
      a.out_raw8[((long long)c * a.S8 + row) * a.N + n] = (signed char)raw;
      return 0;
    case G_RAW16: {
      short v = (short)raw;
      a.out_raw16[((long long)c * a.S16 + row) * a.N + n] = v;
      return a.check_group == G_RAW16 && (long long)v != raw;
    }
    case G_RAW32: {
      long long idx = ((long long)c * a.S32 + row) * a.N + n;
      if (a.raw32_bytes == 8) {
        ((long long*)a.out_raw32)[idx] = raw;
        return 0;
      }
      int v = (int)raw;
      ((int*)a.out_raw32)[idx] = v;
      return a.check_group == G_RAW32 && (long long)v != raw;
    }
  }
  return 0;  // G_NONE: a precompiled host row, never written
}

__global__ void __launch_bounds__(KSS_THREADS, 1) step_chunk_kernel(const StepArgs a) {
  __shared__ long long sh_ll[KSS_THREADS / 32];
  __shared__ int sh_i[KSS_THREADS / 32];
  const int N = a.N;
  for (int c = 0; c < a.C; ++c) {
    // ---- 0. pre-reductions over N
    long long sp_mins[KSS_MC];
    for (int m = 0; m < KSS_MC; ++m) sp_mins[m] = 0;
    bool ip_any_aff = false;
    int ip_total_any = 0;
    for (int f = 0; f < a.F; ++f) {
      if (a.filter_ids[f] == P_SPREAD && !a.sp_filter_skip[c]) spread_minima(a, c, sp_mins, sh_ll);
      if (a.filter_ids[f] == P_INTERPOD) interpod_pod_scalars(a, c, ip_any_aff, ip_total_any);
    }

    // ---- 1. filters, first-fail pack, feasibility
    long long local_feasible = 0;
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
      int first = -1, first_code = 0;
      for (int f = 0; f < a.F; ++f) {
        int code = filter_code(a, a.filter_ids[f], c, n, sp_mins, ip_any_aff, ip_total_any);
        if (!a.compact) a.out_codes[((long long)c * a.F + f) * N + n] = code;
        if (code != 0 && first < 0) { first = f; first_code = code; }
      }
      a.scratch_feas[n] = first < 0;
      local_feasible += first < 0;
      if (a.compact) {
        long long word = first < 0 ? 0
            : (((long long)(first + 1)) << a.pack_code_bits) | (long long)first_code;
        store_packed(a, (long long)c * N + n, word);
      }
    }
    const int feasible_count = (int)block_sum_ll(local_feasible, sh_ll);

    // ---- 2. raw scores
    int local_ovf = 0;
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
      bool ignored = false;
      for (int s = 0; s < a.S; ++s) {
        const int pid = a.score_ids[s];
        bool ign = false;
        long long raw = score_skipped(a, pid, c) ? 0 : score_raw(a, pid, c, n, ign);
        if (pid == P_SPREAD) ignored = ign;
        a.scratch_raw[(long long)s * N + n] = raw;
        if (a.compact) local_ovf |= store_raw(a, s, c, n, raw);
        else a.out_raw[((long long)c * a.S + s) * N + n] = (int)raw;
      }
      a.scratch_ign[n] = ignored;
    }
    const int overflow = __syncthreads_or(local_ovf);

    // ---- 3. reductions of the normalizing scorers over the feasible set
    long long lo[KSS_MAX_S], hi[KSS_MAX_S];
    bool any_scored[KSS_MAX_S];
    for (int s = 0; s < a.S; ++s) {
      const int pid = a.score_ids[s];
      lo[s] = 0;
      hi[s] = 0;
      any_scored[s] = false;
      if (!normalizes(pid) || score_skipped(a, pid, c)) continue;  // uniform
      long long l = LLONG_MAX, h = LLONG_MIN;
      int any = 0;
      for (int n = threadIdx.x; n < N; n += blockDim.x) {
        const long long raw = a.scratch_raw[(long long)s * N + n];
        const bool feas = a.scratch_feas[n] != 0;
        if (pid == P_SPREAD) {
          const bool scored = feas && !a.scratch_ign[n];
          l = ll_min(l, scored ? raw : KSS_BIG);
          h = ll_max(h, scored ? raw : 0);
          any |= scored;
        } else if (pid == P_INTERPOD) {
          l = ll_min(l, feas ? raw : KSS_BIG);
          h = ll_max(h, feas ? raw : -KSS_BIG);
        } else {  // DefaultNormalizeScore: max over raw masked to 0
          h = ll_max(h, feas ? raw : 0);
        }
      }
      if (pid == P_SPREAD || pid == P_INTERPOD) lo[s] = block_min_ll(l, sh_ll);
      hi[s] = block_max_ll(h, sh_ll);
      if (pid == P_SPREAD) any_scored[s] = __syncthreads_or(any) != 0;
    }

    // ---- 4. normalize x weight, total, argmax
    long long best_v = LLONG_MIN;
    int best_i = INT_MAX;
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
      long long total = 0;
      for (int s = 0; s < a.S; ++s) {
        const int pid = a.score_ids[s];
        long long final_ = 0;
        if (!score_skipped(a, pid, c)) {
          const long long raw = a.scratch_raw[(long long)s * N + n];
          long long normed = raw;
          if (pid == P_AFFINITY) normed = default_normalize(raw, hi[s], false);
          else if (pid == P_TAINT) normed = default_normalize(raw, hi[s], true);
          else if (pid == P_SPREAD)
            normed = spread_normalize(raw, a.scratch_ign[n] != 0, lo[s], hi[s], any_scored[s]);
          else if (pid == P_INTERPOD) normed = interpod_normalize(raw, lo[s], hi[s]);
          final_ = normed * a.score_weight[s];
        }
        if (!a.compact) a.out_final[((long long)c * a.S + s) * N + n] = (int)final_;
        total += final_;
      }
      if (!a.scratch_feas[n]) total = -1;
      argmax_pair(best_v, best_i, total, n);
    }
    int sel = block_argmax(best_v, best_i, sh_ll, sh_i);
    if (feasible_count == 0 || a.is_pad[c]) sel = -1;
    if (threadIdx.x == 0) {
      a.out_selected[c] = sel;
      a.out_feasible_count[c] = feasible_count;
      a.out_prefilter_reject[c] = 0;  // none of the six plugins rejects in PreFilter
      if (a.compact) a.out_overflow[c] = overflow != 0;
    }

    // ---- 5. bind.  Every read of the carry for this pod happened before
    // the barriers of block_argmax; a rejected or padded pod binds nothing.
    if (sel >= 0) {
      core_bind(a, c, sel);
      if (a.has_spread) spread_bind(a, c, sel);
      if (a.has_interpod) interpod_bind(a, c, sel);
    }
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
