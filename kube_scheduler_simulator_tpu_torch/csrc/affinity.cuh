// B1d (part): NodeAffinity filter, score and normalize for one pod at one
// node.  Counterparts: plugins/affinity.py filter_kernel :155,
// score_kernel :160, normalize :164 and plugins/base.py
// default_normalize_score :45 (line numbers in the JAX package).
#pragma once

#include "common.cuh"

__device__ __forceinline__ int affinity_filter(const StepArgs& a, int c, int n) {
  long long row = a.aff_req_idx[c];
  return a.aff_req_rows[row * a.N + n] ? 0 : 1;
}

__device__ __forceinline__ long long affinity_score(const StepArgs& a, int c, int n) {
  long long row = a.aff_pref_idx[c];
  return (long long)a.aff_pref_rows[row * a.N + n];
}

// helper.DefaultNormalizeScore over the feasible set; max_count is the
// max of raw at feasible nodes and 0 elsewhere, reduced by the caller.
// raw >= 0 here, but floordiv keeps infeasible positions exact too.
__device__ __forceinline__ long long default_normalize(long long raw, long long max_count,
                                                       bool reverse) {
  long long scaled = floordiv(raw * MAX_NODE_SCORE, ll_max(max_count, 1));
  if (reverse) {
    scaled = MAX_NODE_SCORE - scaled;
    return max_count == 0 ? MAX_NODE_SCORE : scaled;
  }
  return max_count == 0 ? raw : scaled;
}
