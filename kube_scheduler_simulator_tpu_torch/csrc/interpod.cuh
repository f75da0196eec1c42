// B1f: InterPodAffinity for one pod — filter, score and normalize at one
// node and the five-matrix same-domain bind.  Counterparts:
// plugins/interpod.py filter_kernel :290, score_kernel :312,
// normalize :321, bind_update :334 (line numbers in the JAX package).
// The carry is node-space [T, N] int32; per-term products stay int32 as
// in the reference and the sum over terms is int64.
#pragma once

#include "common.cuh"

// Per-pod scalars of the filter: does the pod carry required affinity
// terms, and how many pods match them CLUSTER-WIDE.  The self-match
// escape (interpod.py:293-300) needs that cluster-wide matched_total,
// not the node's row.
__device__ void interpod_pod_scalars(const StepArgs& a, int c, bool& any_aff, int& total_any) {
  any_aff = false;
  total_any = 0;
  for (int t = 0; t < a.T; ++t) {
    if (a.ip_h_req_aff[(long long)c * a.T + t] > 0) {
      any_aff = true;
      total_any += a.ip_matched_total[t];
    }
  }
}

// 1 pod affinity, 2 pod anti-affinity, 3 existing pods' anti-affinity;
// the lowest code that applies wins, in upstream check order.
__device__ int interpod_filter(const StepArgs& a, int c, int n, bool any_aff, int total_any) {
  bool aff_ok_all = true, node_has_keys = true, fail_anti = false;
  int existing = 0;
  for (int t = 0; t < a.T; ++t) {
    const long long ct = (long long)c * a.T + t;
    const long long tn = (long long)t * a.N + n;
    if (a.ip_h_req_aff[ct] > 0) {
      aff_ok_all = aff_ok_all && a.ip_matched[tn] > 0;
      node_has_keys = node_has_keys && a.ip_dom_idx[whole_at(a, t, n)] >= 0;
    }
    if (a.ip_h_req_anti[ct] > 0 && a.ip_matched[tn] > 0) fail_anti = true;
    if (a.ip_t_matches[ct]) existing += a.ip_have_req_anti[tn];
  }
  bool self_escape = total_any == 0 && a.ip_self_ok[c] && node_has_keys;
  if (any_aff && !(aff_ok_all || self_escape)) return 1;
  if (fail_anti) return 2;
  if (existing > 0) return 3;
  return 0;
}

__device__ long long interpod_score(const StepArgs& a, int c, int n) {
  const int hard = (int)a.ip_hard_weight;
  long long sum = 0;
  for (int t = 0; t < a.T; ++t) {
    const long long ct = (long long)c * a.T + t;
    const long long tn = (long long)t * a.N + n;
    int coef = (int)(a.ip_h_pref_aff_w[ct] - a.ip_h_pref_anti_w[ct]);
    int own = coef != 0 ? coef * a.ip_matched[tn] : 0;
    int sym = a.ip_t_matches[ct]
                  ? a.ip_sym_pref_aff[tn] - a.ip_sym_pref_anti[tn] + hard * a.ip_have_req_aff[tn]
                  : 0;
    sum += (long long)(own + sym);
  }
  return sum;
}

// float64 min/max scaling over feasible nodes, truncated (Go int64()):
// 100 * ((raw - mn) / diff), each operation rounded on its own
// (-fmad=false).  mn / mx are the feasible min and max, reduced by the
// caller with +-2^40 where nothing is feasible.
__device__ __forceinline__ long long interpod_normalize(long long raw, long long mn, long long mx) {
  double diff = (double)(mx - mn);
  double f = diff > 0.0 ? 100.0 * ((double)(raw - mn) / fmax(diff, 1.0)) : 0.0;
  return (long long)f;
}

// Node-space bind: for every term whose key the selected node carries,
// every node of [lo, hi) in the same domain takes the pod's five
// increments, and matched_total the match bit, once per block that keeps
// the cluster-wide counters, from its thread 0.  Terms with all-zero
// increments change nothing: each warp finds the others 32 at a time with
// a ballot (the same mask in every warp), so they cost no load of their
// domain row.  Only called for a bound pod, `sel` its local index (the
// domain rows are whole on every card of a card mesh: whole_at).
__device__ void interpod_bind(const StepArgs& a, int c, int sel, int lo, int hi,
                              bool cluster_wide) {
  const int lane = threadIdx.x & 31;
  for (int t0 = 0; t0 < a.T; t0 += 32) {
    const int tl = t0 + lane;
    bool live = false;
    if (tl < a.T) {
      const long long ct = (long long)c * a.T + tl;
      live = a.ip_t_matches[ct] || a.ip_h_req_anti[ct] != 0 || a.ip_h_req_aff[ct] != 0 ||
             (int)a.ip_h_pref_aff_w[ct] != 0 || (int)a.ip_h_pref_anti_w[ct] != 0;
    }
    unsigned mask = __ballot_sync(0xffffffffu, live);
    while (mask) {
      const int t = t0 + __ffs(mask) - 1;
      mask &= mask - 1;
      const int dcol = a.ip_dom_idx[whole_at(a, t, sel)];
      if (dcol < 0) continue;  // uniform across the block
      const long long ct = (long long)c * a.T + t;
      const int inc_m = a.ip_t_matches[ct] ? 1 : 0;
      const int inc_anti = a.ip_h_req_anti[ct];
      const int inc_aff = a.ip_h_req_aff[ct];
      const int inc_pa = (int)a.ip_h_pref_aff_w[ct];
      const int inc_pn = (int)a.ip_h_pref_anti_w[ct];
      if (cluster_wide && threadIdx.x == 0) a.ip_matched_total[t] += inc_m;
      for (int n = lo + threadIdx.x; n < hi; n += blockDim.x) {
        const long long tn = (long long)t * a.N + n;
        if (a.ip_dom_idx[whole_at(a, t, n)] != dcol) continue;
        a.ip_matched[tn] += inc_m;
        a.ip_have_req_anti[tn] += inc_anti;
        a.ip_have_req_aff[tn] += inc_aff;
        a.ip_sym_pref_aff[tn] += inc_pa;
        a.ip_sym_pref_anti[tn] += inc_pn;
      }
    }
  }
}
