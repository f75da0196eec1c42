// B1a-B1c: NodeResourcesFit filter, score and bind, and
// NodeResourcesBalancedAllocation score, for one pod at one node.
// Counterparts: plugins/noderesources.py fit_filter :87, fit_score :157,
// balanced_score :191, core_bind_update :228 and
// plugins/fitscoring.py score_resource_vec :142, _broken_linear_vec :129,
// _jnp_trunc_div :124 (line numbers in the JAX package).
#pragma once

#include "common.cuh"

// [bit 0] too many pods, [bit r+1] resource column r short.
__device__ int fit_filter(const StepArgs& a, int c, int n) {
  const long long* req = a.pod_requests + (long long)c * a.R;
  bool any_request = false;
  int code = 0;
  for (int r = 0; r < a.R; ++r) {
    any_request |= req[r] != 0;
    long long free_r = a.allocatable[(long long)n * a.R + r] - a.requested[(long long)n * a.R + r];
    if (req[r] > free_r && !a.fit_ignored[r]) code += 2 << r;
  }
  // Zero-request pods pass Fit even on overcommitted nodes (free < 0):
  // upstream fitsRequest returns after the pod-count check
  // (noderesources.py:94-97).
  if (!any_request) code = 0;
  if (a.num_pods[n] + 1 > a.allowed_pods[n]) code += 1;
  return code;
}

// One scored resource at node n -> (requested incl. the pod, allocatable).
__device__ __forceinline__ void res_req_alloc(const StepArgs& a, int c, int n, int src, int col,
                                              long long& req, long long& alloc) {
  if (src == RES_NONE) { req = 0; alloc = 0; return; }
  alloc = a.allocatable[(long long)n * a.R + col];
  if (src == RES_NONZERO)
    req = a.nonzero[(long long)n * 2 + col] + a.pod_nonzero[(long long)c * 2 + col];
  else
    req = a.requested[(long long)n * a.R + col] + a.pod_requests[(long long)c * a.R + col];
}

__device__ __forceinline__ bool res_active(const StepArgs& a, int c, int src, int col,
                                           int need_request, long long alloc) {
  if (src == RES_NONE) return false;
  bool active = alloc > 0;
  if (need_request) active = active && a.pod_requests[(long long)c * a.R + col] > 0;
  return active;
}

__device__ long long broken_linear(const StepArgs& a, long long p) {
  // the first shape point with p <= u wins (the reverse where-loop of
  // _broken_linear_vec); past the last point, its score
  for (int i = 0; i < a.fit_nshape; ++i) {
    long long u = a.shape_u[i], s = a.shape_s[i];
    if (p <= u) {
      if (i == 0) return s;
      long long up = a.shape_u[i - 1], sp = a.shape_s[i - 1];
      return sp + truncdiv((s - sp) * (p - up), u - up);
    }
  }
  return a.shape_s[a.fit_nshape - 1];
}

__device__ long long score_resource(const StepArgs& a, long long req, long long cap) {
  if (a.fit_type == FIT_RTCR) {
    bool over = cap == 0 || req > cap;
    long long util = over ? MAX_NODE_SCORE : floordiv(req * MAX_NODE_SCORE, ll_max(cap, 1));
    return broken_linear(a, util);
  }
  bool ok = cap > 0 && req <= cap;
  if (!ok) return 0;
  long long capd = ll_max(cap, 1);
  if (a.fit_type == FIT_MOST) return floordiv(req * MAX_NODE_SCORE, capd);
  return floordiv((cap - req) * MAX_NODE_SCORE, capd);
}

__device__ long long fit_score(const StepArgs& a, int c, int n) {
  const bool rtcr = a.fit_type == FIT_RTCR;
  long long total = 0, wsum = 0;
  for (int k = 0; k < a.fit_nres; ++k) {
    long long req, alloc;
    res_req_alloc(a, c, n, a.fit_src[k], a.fit_col[k], req, alloc);
    bool active = res_active(a, c, a.fit_src[k], a.fit_col[k], a.fit_need_request[k], alloc);
    long long s = score_resource(a, req, alloc);
    if (rtcr) active = active && s > 0;
    if (active) { total += s * a.fit_weight[k]; wsum += a.fit_weight[k]; }
  }
  if (wsum <= 0) return 0;
  if (rtcr) return floordiv(2 * total + wsum, ll_max(2 * wsum, 1));  // round half up
  return floordiv(total, ll_max(wsum, 1));
}

// float64 without contraction: the file is built with -fmad=false, so
// (1 - std) * 100 and the sums below round after every operation, as the
// reference's separate jnp ops do.  Sums over resources run in resource
// order, as the plain version's explicit loop.
__device__ long long balanced_score(const StepArgs& a, int c, int n) {
  double f[KSS_MAX_RES];
  bool m[KSS_MAX_RES];
  int cnt = 0;
  const int K = a.bal_nres;
  for (int k = 0; k < K; ++k) {
    long long req, alloc;
    res_req_alloc(a, c, n, a.bal_src[k], a.bal_col[k], req, alloc);
    double ad = (double)alloc;
    f[k] = fmin((double)req / fmax(ad, 1.0), 1.0);
    m[k] = res_active(a, c, a.bal_src[k], a.bal_col[k], a.bal_need_request[k], alloc);
    cnt += m[k] ? 1 : 0;
  }
  double std_ = 0.0;
  if (K == 2) {
    // the two-resource closed form |f0 - f1| / 2 (noderesources.py:207-211)
    if (cnt == 2) std_ = fabs(f[0] - f[1]) / 2.0;
  } else {
    double denom = (double)(cnt > 1 ? cnt : 1);
    double s1 = 0.0, s2 = 0.0;
    bool first = true;
    for (int k = 0; k < K; ++k) {
      double fm = m[k] ? f[k] : 0.0;
      double f2 = m[k] ? f[k] * f[k] : 0.0;
      if (first) { s1 = fm; s2 = f2; first = false; }
      else { s1 = s1 + fm; s2 = s2 + f2; }
    }
    double mean = s1 / denom;
    double var = 0.0;
    first = true;
    for (int k = 0; k < K; ++k) {
      double d = f[k] - mean;
      double term = m[k] ? d * d : 0.0;
      var = first ? term : var + term;
      first = false;
    }
    var = var / denom;
    if (cnt > 2) std_ = sqrt(var);
    else if (cnt == 2) std_ = sqrt(fmax(2.0 * s2 - s1 * s1, 0.0)) / 2.0;
  }
  return (long long)((1.0 - std_) * MAX_NODE_SCORE);
}

// Bind after a rejected or padded pod (sel == -1) is a no-op
// (noderesources.py:228-238): the caller only calls this with sel >= 0.
__device__ void core_bind(const StepArgs& a, int c, int sel) {
  for (int r = threadIdx.x; r < a.R; r += blockDim.x)
    a.requested[(long long)sel * a.R + r] += a.pod_requests[(long long)c * a.R + r];
  for (int k = threadIdx.x; k < 2; k += blockDim.x)
    a.nonzero[(long long)sel * 2 + k] += a.pod_nonzero[(long long)c * 2 + k];
  if (threadIdx.x == 0) a.num_pods[sel] += 1;
}
