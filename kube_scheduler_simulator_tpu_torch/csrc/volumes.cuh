// B9d-B9g: the volume family for one pod at one node — VolumeZone,
// NodeVolumeLimits, VolumeRestrictions and VolumeBinding — with their
// binds and VolumeRestrictions' dynamic PreFilter reject.  Counterparts
// (line numbers in the JAX package): plugins/volumezone.py filter_kernel
// :97; plugins/nodevolumelimits.py filter_kernel :125, bind_update :137;
// plugins/volumerestrictions.py prefilter_reject :173, filter_kernel :178,
// bind_update :191; plugins/volumebinding.py _greedy_choices :222,
// filter_kernel :249, bind_update :254 (its score_kernel :265 is the
// constant 0, pod.cuh score_raw).
//
// The JAX package evaluates each over all nodes with array ops (an int64
// [N, C] @ [C, D] product for the limits, a [V, N] argmin per claim slot
// for the binding); here each node's thread loops over the few volumes,
// drivers, disks and PVs itself, in int64, in the same order, so the
// results are the same at every node.
#pragma once

#include "common.cuh"

// ---- VolumeZone: the precompiled row; [C, 1] when every pod Skips.
__device__ __forceinline__ int volzone_filter(const StepArgs& a, int c, int n) {
  return a.vz_codes[(long long)c * a.vz_width + (a.vz_width == 1 ? 0 : n)];
}

// ---- NodeVolumeLimits.  Per driver d with a limit at n: the pod's
// volumes not yet on n (added) and the unique volumes already there
// (existing); only drivers the pod adds volumes for are checked, so the
// count of what is there is taken only then.
__device__ int nvl_filter(const StepArgs& a, int c, int n) {
  const unsigned char* on = a.nvl_on_node + (long long)n * a.VC;
  const unsigned char* pod = a.nvl_pod_vols + (long long)c * a.VC;
  for (int d = 0; d < a.VD; ++d) {
    const long long lim = a.nvl_limits[(long long)n * a.VD + d];
    if (lim < 0) continue;  // unlimited on this node
    long long added = 0;
    for (int v = 0; v < a.VC; ++v)
      added += (pod[v] && a.nvl_onehot[(long long)v * a.VD + d] && !on[v]) ? 1 : 0;
    if (added == 0) continue;
    long long existing = 0;
    for (int v = 0; v < a.VC; ++v)
      existing += (on[v] && a.nvl_onehot[(long long)v * a.VD + d]) ? 1 : 0;
    if (existing + added > lim) return 1;
  }
  return 0;
}

__device__ void nvl_bind(const StepArgs& a, int c, int sel) {
  for (int v = threadIdx.x; v < a.VC; v += blockDim.x)
    if (a.nvl_pod_vols[(long long)c * a.VC + v]) a.nvl_on_node[(long long)sel * a.VC + v] = 1;
}

// ---- VolumeRestrictions
// Bit 0 of the PreFilter reject: the pod's ReadWriteOncePod claim is in
// use anywhere in the cluster.
__device__ __forceinline__ int vr_prefilter_reject(const StepArgs& a, int c) {
  for (int r = 0; r < a.RR; ++r)
    if (a.vr_rwop[(long long)c * a.RR + r] && a.vr_rwop_used[r]) return 1;
  return 0;
}

// An inline disk conflicts when it is on the node with a writer, when the
// pod writes a disk on the node, or when a strict (EBS) disk is on both.
__device__ int vr_filter(const StepArgs& a, int c, int n) {
  const unsigned char* w_any = a.vr_w_any + (long long)c * a.RD;
  const unsigned char* w_rw = a.vr_w_rw + (long long)c * a.RD;
  const unsigned char* used_any = a.vr_used_any + (long long)n * a.RD;
  const unsigned char* used_rw = a.vr_used_rw + (long long)n * a.RD;
  for (int d = 0; d < a.RD; ++d) {
    if (w_any[d] && used_rw[d]) return 1;
    if (w_rw[d] && used_any[d]) return 1;
    if (w_any[d] && a.vr_strict[d] && used_any[d]) return 1;
  }
  return 0;
}

// rwop_used is cluster-wide: set whatever the node.  Only called with
// sel >= 0, as the JAX bind's did_bind.
__device__ void vr_bind(const StepArgs& a, int c, int sel) {
  for (int d = threadIdx.x; d < a.RD; d += blockDim.x) {
    const long long cd = (long long)c * a.RD + d, nd = (long long)sel * a.RD + d;
    if (a.vr_w_any[cd]) a.vr_used_any[nd] = 1;
    if (a.vr_w_rw[cd]) a.vr_used_rw[nd] = 1;
  }
  for (int r = threadIdx.x; r < a.RR; r += blockDim.x)
    if (a.vr_rwop[(long long)c * a.RR + r]) a.vr_rwop_used[r] = 1;
}

// ---- VolumeBinding.  The greedy choice at node n: per active claim slot
// k in order, the unclaimed, not-yet-chosen, wanted PV allowed at n with
// the least capacity, ties to the lowest PV index (jnp.argmin's first
// minimum); a slot with no such PV needs dynamic provisioning at n.
// Writes the chosen PVs (-1 for none) and returns whether some active
// slot can do neither.
__device__ bool vb_greedy(const StepArgs& a, int c, int n, int* chosen) {
  bool bindfail = false;
  for (int k = 0; k < a.VK; ++k) {
    chosen[k] = -1;
    if (!a.vb_active[(long long)c * a.VK + k]) continue;
    const unsigned char* want = a.vb_want + ((long long)c * a.VK + k) * a.VV;
    int pick = -1;
    long long best = LLONG_MAX;
    for (int v = 0; v < a.VV; ++v) {
      if (!want[v] || a.vb_claimed[v] || !a.vb_pv_node_ok[(long long)v * a.N + n]) continue;
      bool taken = false;
      for (int j = 0; j < k; ++j) taken |= chosen[j] == v;
      if (taken) continue;
      const long long cap = a.vb_pv_cap[v];
      if (cap < best) { best = cap; pick = v; }
    }
    chosen[k] = pick;
    const bool ok = pick >= 0 || a.vb_provision_ok[((long long)c * a.VK + k) * a.N + n];
    bindfail |= !ok;
  }
  return bindfail;
}

__device__ int vb_filter(const StepArgs& a, int c, int n) {
  int chosen[KSS_MAX_VBK];
  const int code = a.vb_bound_code[(long long)c * a.vb_width + (a.vb_width == 1 ? 0 : n)];
  return code | (vb_greedy(a, c, n, chosen) ? 2 : 0);
}

// The bind claims the PVs the greedy choice picks at the selected node,
// against the carry as it was before this bind (only called with
// sel >= 0).  One thread: a handful of claim slots over the PVs.
__device__ void vb_bind(const StepArgs& a, int c, int sel) {
  if (threadIdx.x != 0 || a.VV == 0 || a.VK == 0) return;
  int chosen[KSS_MAX_VBK];
  vb_greedy(a, c, sel, chosen);
  for (int k = 0; k < a.VK; ++k)
    if (chosen[k] >= 0) a.vb_claimed[chosen[k]] = 1;
}
