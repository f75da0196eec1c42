// The per-pod body of the scheduling step, shared by step_chunk
// (step.cu, a chunk's pods in order over one thread-block cluster) and the
// speculative wave's and the host path's kernels (spec_eval.cu:
// one pod per cluster; spec_round.cu: the plugin dispatch under a group
// of pods a block): the plugin dispatch, the compact stores, the step's
// evaluation of one pod against the carry as it stands, and its bind.
//
// The body is templated on its reduction scope (scope.cuh): the node
// loops walk the scope's [lo, hi), the pod's rows are kept where the scope
// says, and each reduction over the node axis is one of the scope's
// combines.  A pod takes three:
//
//   1. the pre-pass: the minima of every spread slot the filter checks,
//      one vector (spread.cuh spread_minima); InterPod's pod scalars come
//      from the cluster-wide matched_total, which every block reads whole;
//   2. one node loop runs each node's filters in config order, its raw
//      scores, and its share of the feasible count, the raw-overflow OR
//      and each normalizer's min, max and any, all reduced in one vector
//      (NodeStat below).  A thread's filter and score results at node n
//      depend only on node n, the pod and the pre-pass, so filters and
//      scores share the loop;
//   3. normalize x weight, the total and the local argmax; one argmax
//      combine.
//
// Nothing in the evaluation writes the carry; bind_pod does.
#pragma once

#include "common.cuh"
#include "fit.cuh"
#include "affinity.cuh"
#include "taints.cuh"
#include "spread.cuh"
#include "interpod.cuh"
#include "ports.cuh"
#include "volumes.cuh"
#include "scope.cuh"

// What a pod's filters read besides the node: the pre-pass's results and
// the pod's volume lists.
struct PodPre {
  long long sp_mins[KSS_MC];
  bool ip_any_aff;
  int ip_total_any;
  PodVolumes vols;
};

template <bool W>
__device__ int filter_code(const StepArgs& a, int pid, int c, int n, const PodPre& pre) {
  switch (pid) {
    case P_FIT:
      return fit_filter(a, c, n);
    case P_AFFINITY:
      return a.aff_filter_skip[c] ? 0 : affinity_filter(a, c, n);
    case P_TAINT:
      return taint_filter(a, c, n);
    case P_SPREAD:
      return a.sp_filter_skip[c] ? 0 : spread_filter(a, c, n, pre.sp_mins);
    case P_INTERPOD:
      return a.ip_filter_skip[c] ? 0 : interpod_filter(a, c, n, pre.ip_any_aff, pre.ip_total_any);
    case P_UNSCHED:
      return unsched_filter(a, c, n);
    case P_NODENAME:
      return nodename_filter(a, c, n);
    case P_PORTS:
      return a.np_filter_skip[c] ? 0 : ports_filter(a, c, n);
    case P_VOLRESTR:
      return a.vr_filter_skip[c] ? 0 : vr_filter(a, c, n);
    case P_VOLLIMITS:
      return a.nvl_filter_skip[c] ? 0 : nvl_filter(a, c, n, pre.vols);
    case P_VOLBIND:
      return a.vb_filter_skip[c] ? 0 : vb_filter<W>(a, c, n, pre.vols);
    case P_VOLZONE:
      return a.vz_filter_skip[c] ? 0 : volzone_filter(a, c, n);
  }
  // B13: a custom plugin's precompiled code (JAX pipeline.py:107-109)
  if (pid >= P_CUSTOM) return custom_codes<W>(a, pid - P_CUSTOM)[(long long)c * a.N + n];
  return 0;
}

__device__ __forceinline__ bool score_skipped(const StepArgs& a, int pid, int c) {
  if (pid == P_AFFINITY) return a.aff_score_skip[c] != 0;
  if (pid == P_SPREAD) return a.sp_score_skip[c] != 0;
  return false;
}

template <bool W>
__device__ long long score_raw(const StepArgs& a, int pid, int c, int n, bool& ignored) {
  switch (pid) {
    case P_FIT:
      return fit_score<W>(a, c, n);
    case P_BALANCED:
      return balanced_score<W>(a, c, n);
    case P_AFFINITY:
      return affinity_score(a, c, n);
    case P_TAINT:
      return taint_score(a, c, n);
    case P_SPREAD:
      return spread_score(a, c, n, ignored);
    case P_INTERPOD:
      return interpod_score(a, c, n);
    case P_IMAGE:  // B9c: the precompiled int64 row
      return a.image_score[(long long)c * a.N + n];
    case P_VOLBIND:  // VolumeCapacityPriority is off: Score returns 0
      return 0;
  }
  // B13: a custom plugin's precompiled int64 raw, which is also its
  // normalized score (a custom NormalizeScore runs on the host;
  // pipeline.py:150-156)
  if (pid >= P_CUSTOM) return custom_scores<W>(a, pid - P_CUSTOM)[(long long)c * a.N + n];
  return 0;
}

// Scorers with ScoreExtensions (ImageLocality, VolumeBinding and the
// custom plugins' rows have none here).
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
template <bool W>
__device__ __forceinline__ int store_raw(const StepArgs& a, int s, int c, int n, long long raw) {
  const int row = score_row_of<W>(a, s);
  switch (score_group_of<W>(a, s)) {
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

// store_raw's narrowing check alone: 1 when scorer s's raw would not
// survive its group's checked narrowing.
template <bool W>
__device__ __forceinline__ int raw_narrows(const StepArgs& a, int s, long long raw) {
  switch (score_group_of<W>(a, s)) {
    case G_RAW16:
      return a.check_group == G_RAW16 && (long long)(short)raw != raw;
    case G_RAW32:
      return a.raw32_bytes == 4 && a.check_group == G_RAW32 && (long long)(int)raw != raw;
  }
  return 0;
}

// The PreFilter reject of pod c (pipeline.py _prefilter_reject): bit 0
// VolumeRestrictions' ReadWriteOncePod conflict against the cluster-wide
// carry, bit 1 the compile-time reject.  Uniform across the scope.
__device__ __forceinline__ int prefilter_reject(const StepArgs& a, int c) {
  int code = a.has_vr ? vr_prefilter_reject(a, c) : 0;
  if (a.force_unsched != nullptr && a.force_unsched[c]) code |= 2;
  return code;
}

#ifdef KSS_PHASE_CLOCK
#define KSS_CLOCK_ADD(slot, since) \
  do { if (ck) ck[slot] += kss_now() - (since); } while (0)
#endif

// The pod's PreFilter reject (its leader writes it), its volume lists
// (the scope's, compacted by the caller) and pass 1: the spread minima
// and InterPod's pod scalars.
template <bool W, class Scope>
__device__ PodPre pod_prepass(const StepArgs& a, int c, Scope& scope, int& reject) {
  reject = prefilter_reject(a, c);
  if (scope.leader()) a.out_prefilter_reject[c] = reject;
  PodPre pre;
  pre.vols = scope.vols;
  pre.ip_any_aff = false;
  pre.ip_total_any = 0;
  for (int m = 0; m < KSS_MC; ++m) pre.sp_mins[m] = 0;
  for (int f = 0; f < a.F; ++f) {
    const int pid = filter_id<W>(a, f);
    if (pid == P_SPREAD && !a.sp_filter_skip[c])
      spread_minima(a, c, pre.sp_mins, scope);
    if (pid == P_INTERPOD)
      interpod_pod_scalars(a, c, pre.ip_any_aff, pre.ip_total_any);
  }
  return pre;
}

// Each filter at node n in config order with its filter_skip: the codes
// (full) or the first-fail word (compact) stored; -> feasible.
template <bool W>
__device__ __forceinline__ bool node_filters(const StepArgs& a, int c, int n, const PodPre& pre
                                             KSS_CLOCK(, unsigned long long* ck)) {
  int first = -1, first_code = 0;
  for (int f = 0; f < a.F; ++f) {
    KSS_CLOCK(const unsigned long long tv = kss_now();)
    const int pid = filter_id<W>(a, f);
    const int code = filter_code<W>(a, pid, c, n, pre);
    KSS_CLOCK(if (pid == P_VOLLIMITS) KSS_CLOCK_ADD(CK_NVL, tv);
              if (pid == P_VOLBIND) KSS_CLOCK_ADD(CK_VB, tv);)
    if (!a.compact) a.out_codes[((long long)c * a.F + f) * a.N + n] = code;
    if (code != 0 && first < 0) { first = f; first_code = code; }
  }
  if (a.compact) {
    const long long word = first < 0 ? 0
        : (((long long)(first + 1)) << a.pack_code_bits) | (long long)first_code;
    store_packed(a, (long long)c * a.N + n, word);
  }
  return first < 0;
}

// The node loop's partials, one combine: the feasible count, the
// raw-overflow OR, and the normalizers' statistics over the feasible set
// (over the scored nodes for PodTopologySpread); a scorer appears once in
// a profile.
enum NodeStat {
  NS_FEASIBLE = 0, NS_OVERFLOW, NS_AFF_MAX, NS_TAINT_MAX, NS_SPREAD_MIN, NS_SPREAD_MAX,
  NS_SPREAD_ANY, NS_IP_MIN, NS_IP_MAX, NS_COUNT
};
constexpr unsigned long long kNodeStatOps =
    combine_ops(OP_SUM, OP_OR, OP_MAX, OP_MAX, OP_MIN, OP_MAX, OP_OR, OP_MIN, OP_MAX);

// Passes 2-3 for pod c against the carry as it stands: the node loop
// (filters, raw scores into the outputs and the scope's rows, the node
// statistics), one combine, normalize x weight into the int64 total (-1
// where infeasible), the argmax (value desc, index asc) with
// feasible_count > 0 and is_pad applied; the scope's leader writes the
// pod's scalar outputs (feasible_count is 0 for a pod a PreFilter
// rejected).  Every thread of the scope calls it and gets the selection.
template <bool W, class Scope>
__device__ int eval_pod(const StepArgs& a, int c, Scope& scope) {
  KSS_CLOCK(unsigned long long* ck = scope.leader() && a.clock
                ? a.clock + (long long)c * KSS_CLOCK_SLOTS : nullptr;
            const unsigned long long t0 = kss_now();)
  int reject;
  const PodPre pre = pod_prepass<W>(a, c, scope, reject);
  KSS_CLOCK(const unsigned long long t1 = kss_now(); if (ck) ck[CK_PRE] += t1 - t0;)
  const PodRows& rows = scope.rows;

  // ---- 2. the node loop
  long long st[NS_COUNT] = {0, 0, LLONG_MIN, LLONG_MIN, LLONG_MAX, LLONG_MIN, 0, LLONG_MAX,
                            LLONG_MIN};
  for (int n = scope.lo + threadIdx.x; n < scope.hi; n += blockDim.x) {
    KSS_CLOCK(const unsigned long long tf = kss_now();)
    const bool feas = node_filters<W>(a, c, n, pre KSS_CLOCK(, ck));
    KSS_CLOCK(const unsigned long long ts = kss_now(); if (ck) ck[CK_FILTER] += ts - tf;)
    bool ignored = false;
    for (int s = 0; s < a.S; ++s) {
      const int pid = score_id<W>(a, s);
      const bool skip = score_skipped(a, pid, c);
      bool ign = false;
      const long long raw = skip ? 0 : score_raw<W>(a, pid, c, n, ign);
      if (pid == P_SPREAD) ignored = ign;
      rows.raw[(long long)s * rows.stride + (n - rows.base)] = raw;
      if (a.compact) st[NS_OVERFLOW] |= store_raw<W>(a, s, c, n, raw);
      else a.out_raw[((long long)c * a.S + s) * a.N + n] = (int)raw;
      if (skip) continue;
      switch (pid) {
        case P_AFFINITY:  // DefaultNormalizeScore: max over raw masked to 0
          st[NS_AFF_MAX] = ll_max(st[NS_AFF_MAX], feas ? raw : 0);
          break;
        case P_TAINT:
          st[NS_TAINT_MAX] = ll_max(st[NS_TAINT_MAX], feas ? raw : 0);
          break;
        case P_SPREAD: {
          const bool scored = feas && !ign;
          st[NS_SPREAD_MIN] = ll_min(st[NS_SPREAD_MIN], scored ? raw : KSS_BIG);
          st[NS_SPREAD_MAX] = ll_max(st[NS_SPREAD_MAX], scored ? raw : 0);
          st[NS_SPREAD_ANY] |= scored;
          break;
        }
        case P_INTERPOD:
          st[NS_IP_MIN] = ll_min(st[NS_IP_MIN], feas ? raw : KSS_BIG);
          st[NS_IP_MAX] = ll_max(st[NS_IP_MAX], feas ? raw : -KSS_BIG);
          break;
      }
    }
    rows.feas[n - rows.base] = feas;
    rows.ign[n - rows.base] = ignored;
    st[NS_FEASIBLE] += feas;
    KSS_CLOCK(if (ck) ck[CK_SCORE] += kss_now() - ts;)
  }
  KSS_CLOCK(const unsigned long long t2 = kss_now();)
  const long long* r = scope_combine<NS_COUNT, kNodeStatOps>(st, scope);
  const int feasible_count = reject > 0 ? 0 : (int)r[NS_FEASIBLE];
  const bool overflow = r[NS_OVERFLOW] != 0;
  const long long aff_hi = r[NS_AFF_MAX], taint_hi = r[NS_TAINT_MAX];
  const long long sp_lo = r[NS_SPREAD_MIN], sp_hi = r[NS_SPREAD_MAX];
  const bool sp_any = r[NS_SPREAD_ANY] != 0;
  const long long ip_lo = r[NS_IP_MIN], ip_hi = r[NS_IP_MAX];
  KSS_CLOCK(const unsigned long long t3 = kss_now(); if (ck) ck[CK_REDUCE] += t3 - t2;)

  // ---- 3. normalize x weight, total, argmax
  long long best_v = LLONG_MIN;
  int best_i = INT_MAX;
  for (int n = scope.lo + threadIdx.x; n < scope.hi; n += blockDim.x) {
    const bool ign = rows.ign[n - rows.base] != 0;
    long long total = 0;
    for (int s = 0; s < a.S; ++s) {
      const int pid = score_id<W>(a, s);
      long long final_ = 0;
      if (!score_skipped(a, pid, c)) {
        const long long raw = rows.raw[(long long)s * rows.stride + (n - rows.base)];
        long long normed = raw;
        if (pid == P_AFFINITY) normed = default_normalize(raw, aff_hi, false);
        else if (pid == P_TAINT) normed = default_normalize(raw, taint_hi, true);
        else if (pid == P_SPREAD) normed = spread_normalize(raw, ign, sp_lo, sp_hi, sp_any);
        else if (pid == P_INTERPOD) normed = interpod_normalize(raw, ip_lo, ip_hi);
        final_ = normed * score_weight_of<W>(a, s);
      }
      if (!a.compact) a.out_final[((long long)c * a.S + s) * a.N + n] = (int)final_;
      total += final_;
    }
    if (!rows.feas[n - rows.base]) total = -1;
    argmax_pair(best_v, best_i, total, n);
  }
  int sel = scope_argmax(best_v, best_i, scope);
  if (feasible_count == 0 || a.is_pad[c]) sel = -1;
  if (scope.leader()) {
    a.out_selected[c] = sel;
    a.out_feasible_count[c] = feasible_count;
    if (a.compact) a.out_overflow[c] = overflow;
  }
  KSS_CLOCK(if (ck) ck[CK_ARGMAX] += kss_now() - t3;)
  return sel;
}

// The bind of pod c at `sel` into the carry, in place, for every carry the
// workload has (pipeline.py _bind_phase).  Every thread of the block calls
// it; a rejected or padded pod (selected -1) binds nothing.  `sel` is the
// selected node's local index, selected - a.node_base (on a card mesh it
// lies outside [0, N) where the node is another card's).  The node-space
// rows (spread counts, the InterPod matrices) take their same-domain
// increments over the block's nodes [lo, hi); the selected node's rows
// (core, NodePorts, disk and CSI rows) are updated by the block that owns
// it (`owner`), and the cluster-wide carries (InterPod's matched_total,
// the ReadWriteOncePod bits, VolumeBinding's claims) by every block that
// keeps them (`cluster_wide`).  Each element is always updated by the
// same thread of a block, so binds in a row need no barrier between them;
// the caller puts one between the evaluation's last read of the carry and
// this call, and after it.
template <bool W>
__device__ void bind_pod(const StepArgs& a, int c, int sel, int lo, int hi, bool owner,
                         bool cluster_wide, const PodVolumes& vols) {
  if (sel + a.node_base < 0) return;
  if (owner) {
    core_bind(a, c, sel);
    if (a.has_ports) ports_bind(a, c, sel);
    if (a.has_vr) vr_bind_rows(a, c, sel);
    if (a.has_nvl) nvl_bind(a, c, sel, vols);
  }
  if (a.has_spread) spread_bind(a, c, sel, lo, hi);
  if (a.has_interpod) interpod_bind(a, c, sel, lo, hi, cluster_wide);
  if (cluster_wide) {
    if (a.has_vr) vr_bind_rwop(a, c);
    if (a.has_vb) vb_bind<W>(a, c, sel, vols);
  }
}
