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
// drivers, disks and PVs itself, in int64, so the results are the same at
// every node.  NodeVolumeLimits and VolumeBinding walk what is the pod's
// own, not the fleet's: step_chunk compacts, once per pod, the pod's
// volumes and its candidate PVs (unclaimed, wanted by an active slot, in
// (capacity, index) order) into shared memory, and keeps per (node,
// driver) the count of unique volumes of its node slice, built from the
// bitmap once per launch and raised by each bind.  A kernel without the
// lists (one pod per block) walks the pod's rows and the PV order.
#pragma once

#include "common.cuh"

// ---- VolumeZone: the precompiled row; [C, 1] when every pod Skips.
__device__ __forceinline__ int volzone_filter(const StepArgs& a, int c, int n) {
  return a.vz_codes[(long long)c * a.vz_width + (a.vz_width == 1 ? 0 : n)];
}

// ---- what the node loop reads of the volume family for one pod.  A
// kernel that walks a pod's nodes over a cluster compacts them once per
// pod into shared memory (step.cu); one that does not leaves the lists
// null, and the filters walk the pod's rows.
struct PodVolumes {
  const int* nvl_vols;             // the pod's NodeVolumeLimits volumes
  int nvl_n;
  int* nvl_count;                  // unique volumes per (node - count_lo, driver), or null
  int count_lo;
  const int* vb_pvs;               // VolumeBinding candidates in (capacity, index) order
  const unsigned char* vb_slots;   // per candidate, the active claim slots that want it
  int vb_n;
};

__device__ __forceinline__ int nvl_driver(const StepArgs& a, int v) {
  for (int d = 0; d < a.VD; ++d)
    if (a.nvl_onehot[(long long)v * a.VD + d]) return d;
  return -1;  // an interned volume always has a limited driver
}

// ---- NodeVolumeLimits.  Per driver d with a limit at n: the pod's
// volumes not yet on n (added) and the unique volumes already there
// (existing); only drivers the pod adds volumes for are checked.  With a
// compacted pod list, `added` walks that short list and `existing` is the
// slice's count; without, both walk the rows.
__device__ int nvl_filter(const StepArgs& a, int c, int n, const PodVolumes& pv) {
  const unsigned char* on = a.nvl_on_node + (long long)n * a.VC;
  const unsigned char* pod = a.nvl_pod_vols + (long long)c * a.VC;
  if (pv.nvl_vols != nullptr && pv.nvl_n == 0) return 0;  // the pod adds no volume
  for (int d = 0; d < a.VD; ++d) {
    const long long lim = a.nvl_limits[(long long)n * a.VD + d];
    if (lim < 0) continue;  // unlimited on this node
    long long added = 0;
    if (pv.nvl_vols != nullptr) {
      for (int i = 0; i < pv.nvl_n; ++i) {
        const int v = pv.nvl_vols[i];
        added += (a.nvl_onehot[(long long)v * a.VD + d] && !on[v]) ? 1 : 0;
      }
    } else {
      for (int v = 0; v < a.VC; ++v)
        added += (pod[v] && a.nvl_onehot[(long long)v * a.VD + d] && !on[v]) ? 1 : 0;
    }
    if (added == 0) continue;
    long long existing = 0;
    if (pv.nvl_count != nullptr) {
      existing = pv.nvl_count[(long long)(n - pv.count_lo) * a.VD + d];
    } else {
      for (int v = 0; v < a.VC; ++v)
        existing += (on[v] && a.nvl_onehot[(long long)v * a.VD + d]) ? 1 : 0;
    }
    if (existing + added > lim) return 1;
  }
  return 0;
}

// The pod's volumes marked on the selected node (only called with
// sel >= 0, by the block that owns it); with a count, each volume newly
// on the node raises its driver's count there.
__device__ void nvl_bind(const StepArgs& a, int c, int sel, const PodVolumes& pv) {
  if (pv.nvl_vols != nullptr) {
    if (threadIdx.x != 0) return;
    for (int i = 0; i < pv.nvl_n; ++i) {
      const int v = pv.nvl_vols[i];
      unsigned char* on = a.nvl_on_node + (long long)sel * a.VC + v;
      if (*on) continue;
      *on = 1;
      const int d = nvl_driver(a, v);
      if (pv.nvl_count != nullptr && d >= 0)
        pv.nvl_count[(long long)(sel - pv.count_lo) * a.VD + d] += 1;
    }
    return;
  }
  for (int v = threadIdx.x; v < a.VC; v += blockDim.x)
    if (a.nvl_pod_vols[(long long)c * a.VC + v]) a.nvl_on_node[(long long)sel * a.VC + v] = 1;
}

// The per-(node, driver) counts of unique volumes on the nodes [lo, hi),
// from the carry's bitmap: one warp per node, lanes over the volumes.
__device__ void nvl_counts(const StepArgs& a, int lo, int hi, int* count) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = (int)(blockDim.x >> 5);
  for (int n = lo + w; n < hi; n += nw) {
    const unsigned char* on = a.nvl_on_node + (long long)n * a.VC;
    for (int d = 0; d < a.VD; ++d) {
      int k = 0;
      for (int v = lane; v < a.VC; v += 32) k += (on[v] && a.nvl_onehot[(long long)v * a.VD + d]);
      for (int o = 16; o > 0; o >>= 1) k += __shfl_xor_sync(0xffffffffu, k, o);
      if (lane == 0) count[(long long)(n - lo) * a.VD + d] = k;
    }
  }
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

// The pod's disks marked on the selected node (only called with sel >= 0,
// by the block that owns it).
__device__ void vr_bind_rows(const StepArgs& a, int c, int sel) {
  for (int d = threadIdx.x; d < a.RD; d += blockDim.x) {
    const long long cd = (long long)c * a.RD + d, nd = (long long)sel * a.RD + d;
    if (a.vr_w_any[cd]) a.vr_used_any[nd] = 1;
    if (a.vr_w_rw[cd]) a.vr_used_rw[nd] = 1;
  }
}

// rwop_used is cluster-wide: set whatever the node.  Only called with
// sel >= 0, as the JAX bind's did_bind.
__device__ void vr_bind_rwop(const StepArgs& a, int c) {
  for (int r = threadIdx.x; r < a.RR; r += blockDim.x)
    if (a.vr_rwop[(long long)c * a.RR + r]) a.vr_rwop_used[r] = 1;
}

// ---- VolumeBinding.  The greedy choice at node n: per active claim slot
// k in order, the unclaimed, not-yet-chosen, wanted PV allowed at n with
// the least capacity, ties to the lowest PV index (jnp.argmin's first
// minimum): the first such PV in (capacity, index) order, a.vb_order.  A
// slot with no such PV needs dynamic provisioning at n.  With the pod's
// candidates compacted (wanted by some active slot and unclaimed, in that
// order), the walk reads only them, KSS_VB_BATCH allowed-bytes at a time;
// without, it walks the whole order.  Writes the chosen PVs (-1 for none)
// and returns whether some active slot can do neither.
#define KSS_VB_BATCH 16

__device__ __forceinline__ bool vb_taken(const int* chosen, int k, int v) {
  for (int j = 0; j < k; ++j)
    if (chosen[j] == v) return true;
  return false;
}

__device__ bool vb_greedy(const StepArgs& a, int c, int n, int* chosen, const PodVolumes& pv) {
  bool bindfail = false;
  for (int k = 0; k < a.VK; ++k) {
    chosen[k] = -1;
    if (!a.vb_active[(long long)c * a.VK + k]) continue;
    int pick = -1;
    if (pv.vb_pvs != nullptr) {
      for (int e0 = 0; e0 < pv.vb_n && pick < 0; e0 += KSS_VB_BATCH) {
        unsigned char ok[KSS_VB_BATCH];
#pragma unroll
        for (int j = 0; j < KSS_VB_BATCH; ++j) {
          const int e = e0 + j;
          ok[j] = e < pv.vb_n && ((pv.vb_slots[e] >> k) & 1)
                      ? a.vb_pv_node_ok[(long long)pv.vb_pvs[e] * a.N + n] : 0;
        }
#pragma unroll
        for (int j = 0; j < KSS_VB_BATCH; ++j)
          if (pick < 0 && ok[j] && !vb_taken(chosen, k, pv.vb_pvs[e0 + j])) pick = pv.vb_pvs[e0 + j];
      }
    } else {
      const unsigned char* want = a.vb_want + ((long long)c * a.VK + k) * a.VV;
      for (int e = 0; e < a.VV && pick < 0; ++e) {
        const int v = a.vb_order[e];
        if (want[v] && !a.vb_claimed[v] && a.vb_pv_node_ok[(long long)v * a.N + n] &&
            !vb_taken(chosen, k, v))
          pick = v;
      }
    }
    chosen[k] = pick;
    const bool ok = pick >= 0 || a.vb_provision_ok[((long long)c * a.VK + k) * a.N + n];
    bindfail |= !ok;
  }
  return bindfail;
}

__device__ int vb_filter(const StepArgs& a, int c, int n, const PodVolumes& pv) {
  int chosen[KSS_MAX_VBK];
  const int code = a.vb_bound_code[(long long)c * a.vb_width + (a.vb_width == 1 ? 0 : n)];
  return code | (vb_greedy(a, c, n, chosen, pv) ? 2 : 0);
}

// The bind claims the PVs the greedy choice picks at the selected node,
// against the claims as they were before this bind (only called with
// sel >= 0, by every block that keeps the cluster-wide claims).  One
// thread: a handful of claim slots.
__device__ void vb_bind(const StepArgs& a, int c, int sel, const PodVolumes& pv) {
  if (threadIdx.x != 0 || a.VV == 0 || a.VK == 0) return;
  int chosen[KSS_MAX_VBK];
  vb_greedy(a, c, sel, chosen, pv);
  for (int k = 0; k < a.VK; ++k)
    if (chosen[k] >= 0) a.vb_claimed[chosen[k]] = 1;
}

// ---- the per-pod compactions (a kernel with the pod's lists in shared
// memory).  Each thread takes a contiguous tile of the input, counts what
// it keeps, a block scan gives each tile its first position, and the tile
// writes its entries there, in input order.  Every thread calls them and
// gets the count.

__device__ __forceinline__ int block_scan_total(int v, int* sh, int& total) {
  const int pos = block_exclusive_scan(v, sh);
  total = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += sh[w];
  return pos;
}

// The pod's NodeVolumeLimits volumes, in index order.
__device__ int nvl_compact(const StepArgs& a, int c, int* out, int* sh) {
  const unsigned char* pod = a.nvl_pod_vols + (long long)c * a.VC;
  const int tile = (a.VC + (int)blockDim.x - 1) / (int)blockDim.x;
  const int v0 = min((int)threadIdx.x * tile, a.VC), v1 = min(v0 + tile, a.VC);
  int mine = 0;
  for (int v = v0; v < v1; ++v) mine += pod[v] != 0;
  int total;
  int pos = block_scan_total(mine, sh, total);
  for (int v = v0; v < v1; ++v)
    if (pod[v]) out[pos++] = v;
  return total;
}

// The pod's VolumeBinding candidates: the unclaimed PVs that some active
// slot of the pod wants, in (capacity, index) order, each with the bits
// of the slots that want it.
__device__ int vb_compact(const StepArgs& a, int c, int* out, unsigned char* slots, int* sh) {
  unsigned active = 0;
  for (int k = 0; k < a.VK; ++k)
    if (a.vb_active[(long long)c * a.VK + k]) active |= 1u << k;
  if (active == 0) return 0;  // uniform: no claim slot to fill
  const int tile = (a.VV + (int)blockDim.x - 1) / (int)blockDim.x;
  const int e0 = min((int)threadIdx.x * tile, a.VV), e1 = min(e0 + tile, a.VV);
  const unsigned char* want = a.vb_want + (long long)c * a.VK * a.VV;
  int mine = 0;
  for (int e = e0; e < e1; ++e) {
    const int v = a.vb_order[e];
    if (a.vb_claimed[v]) continue;
    for (int k = 0; k < a.VK; ++k)
      if (((active >> k) & 1) && want[(long long)k * a.VV + v]) { ++mine; break; }
  }
  int total;
  int pos = block_scan_total(mine, sh, total);
  for (int e = e0; e < e1; ++e) {
    const int v = a.vb_order[e];
    if (a.vb_claimed[v]) continue;
    unsigned m = 0;
    for (int k = 0; k < a.VK; ++k)
      if (((active >> k) & 1) && want[(long long)k * a.VV + v]) m |= 1u << k;
    if (m) { out[pos] = v; slots[pos] = (unsigned char)m; ++pos; }
  }
  return total;
}
