// B1e: PodTopologySpread for one pod — the per-slot minima (one combine
// over the scope's nodes), filter, score and normalize at one node, and the
// same-domain bind.  Counterparts: plugins/topologyspread.py
// _per_constraint :318, filter_kernel :338, score_kernel :352,
// normalize :365, bind_update :379 (line numbers in the JAX package).
// Counts are node-space [G, N] int32; the _BIG sentinel is int64.
#pragma once

#include "scope.cuh"

// Spread eligibility comes in two layouts: [P, N] shared by every slot,
// or [P, MC, N] when a constraint sets a non-default inclusion policy
// (topologyspread.py:312-316).
__device__ __forceinline__ bool spread_eligible(const StepArgs& a, int c, int m, int n) {
  if (a.sp_elig_per_slot) return a.sp_eligible[((long long)c * KSS_MC + m) * a.N + n] != 0;
  return a.sp_eligible[(long long)c * a.N + n] != 0;
}

__device__ __forceinline__ bool spread_checks(const StepArgs& a, int c, int m) {
  return a.sp_c_id[c * KSS_MC + m] >= 0 && a.sp_is_filter[c * KSS_MC + m];
}

// Per-slot minimum count over eligible keyed nodes, for the slots the
// filter checks (min_match of _per_constraint); minDomains unsatisfied
// forces 0.  Every thread of the scope calls this and gets every slot's
// minimum: each walks the scope's nodes for all slots at once, and one
// combine reduces the four minima together; a CTA with no eligible keyed
// node contributes KSS_BIG.
template <class Scope>
__device__ void spread_minima(const StepArgs& a, int c, long long* mins, Scope& scope) {
  bool checks[KSS_MC];
  bool any = false;
  long long v[KSS_MC];
#pragma unroll
  for (int m = 0; m < KSS_MC; ++m) {
    checks[m] = spread_checks(a, c, m);  // uniform across the scope
    any |= checks[m];
    v[m] = KSS_BIG;
    mins[m] = 0;
  }
  if (!any) return;
  for (int n = scope.lo + threadIdx.x; n < scope.hi; n += blockDim.x) {
#pragma unroll
    for (int m = 0; m < KSS_MC; ++m) {
      if (!checks[m]) continue;
      const long long cid = a.sp_c_id[c * KSS_MC + m];
      if (a.sp_dom_idx[cid * a.N + n] >= 0 && spread_eligible(a, c, m, n))
        v[m] = ll_min(v[m], (long long)a.sp_counts[cid * a.N + n]);
    }
  }
  constexpr unsigned long long kOps = combine_ops(OP_MIN, OP_MIN, OP_MIN, OP_MIN);
  const long long* r = scope_combine<KSS_MC, kOps>(v, scope);
#pragma unroll
  for (int m = 0; m < KSS_MC; ++m)
    mins[m] = checks[m] && !a.sp_md_unsat[c * KSS_MC + m] ? r[m] : 0;
}

// 0 pass; 1+2m missing label at slot m; 2+2m skew at slot m; the first
// violating slot wins.
__device__ int spread_filter(const StepArgs& a, int c, int n, const long long* mins) {
  int code = 0;
  for (int m = 0; m < KSS_MC; ++m) {
    if (!spread_checks(a, c, m)) continue;
    const long long cid = a.sp_c_id[c * KSS_MC + m];
    bool has_key = a.sp_dom_idx[cid * a.N + n] >= 0;
    long long self_match = a.sp_pm[(long long)c * a.G + cid] ? 1 : 0;
    long long skew = (long long)a.sp_counts[cid * a.N + n] + self_match - mins[m];
    int viol = has_key ? (skew > a.sp_max_skew[c * KSS_MC + m] ? 2 + 2 * m : 0) : 1 + 2 * m;
    if (code == 0 && viol > 0) code = viol;
  }
  return code;
}

// float64 sum of count * weight in slot order m = 0..3 (the file is built
// with -fmad=false: no contraction of total + cnt * w), then Go
// math.Round of a non-negative value: floor(total + 0.5).  Args is
// StepArgs, or any struct with its sp_c_id, sp_is_score, sp_dom_idx,
// sp_counts, sp_weight and N (phased.cu RenormArgs).
template <class Args>
__device__ long long spread_score(const Args& a, int c, int n, bool& ignored) {
  double total = 0.0;
  ignored = false;
  for (int m = 0; m < KSS_MC; ++m) {
    const long long cid = a.sp_c_id[c * KSS_MC + m];
    if (cid < 0 || !a.sp_is_score[c * KSS_MC + m]) continue;
    if (a.sp_dom_idx[cid * a.N + n] >= 0)
      total = total + (double)a.sp_counts[cid * a.N + n] * a.sp_weight[c * KSS_MC + m];
    else
      ignored = true;
  }
  long long raw = (long long)floor(total + 0.5);
  return ignored ? 0 : raw;
}

// mn / mx: min and max of raw over scored (feasible, not ignored) nodes,
// _BIG and 0 where none is scored.  mx + mn - raw >= 0 at every scored
// node; floordiv keeps the other positions exact too.
__device__ __forceinline__ long long spread_normalize(long long raw, bool ignored, long long mn,
                                                      long long mx, bool any_scored) {
  if (!any_scored) mn = 0;
  long long out = mx == 0 ? MAX_NODE_SCORE
                          : floordiv(MAX_NODE_SCORE * (mx + mn - raw), ll_max(mx, 1));
  return ignored ? 0 : out;
}

// Node-space bind: every node of [lo, hi) sharing the selected node's
// domain, in every group the pod matches, takes +1.  Only called with
// sel >= 0; the selected node's domain is read from the statics, which
// every block sees whole.  Each warp finds the pod's groups 32 at a time
// with a ballot (the same mask in every warp), so groups the pod does not
// match cost no load of their domain row.
__device__ void spread_bind(const StepArgs& a, int c, int sel, int lo, int hi) {
  const int lane = threadIdx.x & 31;
  for (int g0 = 0; g0 < a.G; g0 += 32) {
    const int gl = g0 + lane;
    unsigned mask = __ballot_sync(0xffffffffu, gl < a.G && a.sp_pm[(long long)c * a.G + gl]);
    while (mask) {
      const int g = g0 + __ffs(mask) - 1;
      mask &= mask - 1;
      const int dcol = a.sp_dom_idx[(long long)g * a.N + sel];
      if (dcol < 0) continue;
      for (int n = lo + threadIdx.x; n < hi; n += blockDim.x)
        if (a.sp_dom_idx[(long long)g * a.N + n] == dcol) a.sp_counts[(long long)g * a.N + n] += 1;
    }
  }
}
