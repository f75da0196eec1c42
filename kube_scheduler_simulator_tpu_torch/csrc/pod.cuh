// The per-pod body of the scheduling step, shared by step_chunk
// (step.cu, one pod after another in one block) and the speculative
// wave's kernels (spec_eval.cu, spec_round.cu, one pod per block):
// the plugin dispatch, the compact stores, and the step's phases 0-4 for
// one pod against the carry as it stands.  Nothing here writes the carry.
//
// Scratch: each pod in flight needs its own [S, N] raw rows and [N]
// feasibility and spread-ignore bytes.  step_chunk has one pod in flight
// and uses slot 0; a kernel with one pod per block gives block b slot b,
// so blocks never share scratch.
//
// The body is templated on its reduction scope (common.cuh BlockScope;
// B12's ClusterScope in mesh.cu): the node loops walk the scope's
// [lo, hi), each reduction over the node axis is the scope's, the pod's
// scalar outputs are written by the scope's leader, and the bind's
// exactly-once updates (the selected node's rows, the cluster-wide bits)
// are made only by the scope that owns the selected node.  The
// non-templated overloads are the block scope's, which every kernel but
// B12 calls.  Shards of a cluster write disjoint slices of a pod's
// scratch.
#pragma once

#include "common.cuh"
#include "fit.cuh"
#include "affinity.cuh"
#include "taints.cuh"
#include "spread.cuh"
#include "interpod.cuh"
#include "ports.cuh"
#include "volumes.cuh"

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
    case P_UNSCHED:
      return unsched_filter(a, c, n);
    case P_NODENAME:
      return nodename_filter(a, c, n);
    case P_PORTS:
      return a.np_filter_skip[c] ? 0 : ports_filter(a, c, n);
    case P_VOLRESTR:
      return a.vr_filter_skip[c] ? 0 : vr_filter(a, c, n);
    case P_VOLLIMITS:
      return a.nvl_filter_skip[c] ? 0 : nvl_filter(a, c, n);
    case P_VOLBIND:
      return a.vb_filter_skip[c] ? 0 : vb_filter(a, c, n);
    case P_VOLZONE:
      return a.vz_filter_skip[c] ? 0 : volzone_filter(a, c, n);
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
    case P_IMAGE:  // B9c: the precompiled int64 row
      return a.image_score[(long long)c * a.N + n];
    case P_VOLBIND:  // VolumeCapacityPriority is off: Score returns 0
      return 0;
  }
  return 0;
}

// Scorers with ScoreExtensions (ImageLocality and VolumeBinding have none).
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

struct PodScratch {
  long long* raw;        // [max(S, 1), N]
  unsigned char* feas;   // [N]
  unsigned char* ign;    // [N]
};

__device__ __forceinline__ PodScratch pod_scratch(const StepArgs& a, long long slot) {
  const long long n = a.N;
  const long long s = a.S > 0 ? a.S : 1;
  return PodScratch{a.scratch_raw + slot * s * n, a.scratch_feas + slot * n,
                    a.scratch_ign + slot * n};
}

// The PreFilter reject of pod c (pipeline.py _prefilter_reject): bit 0
// VolumeRestrictions' ReadWriteOncePod conflict against the cluster-wide
// carry, bit 1 the compile-time reject.  Uniform across the block.
__device__ __forceinline__ int prefilter_reject(const StepArgs& a, int c) {
  int code = a.has_vr ? vr_prefilter_reject(a, c) : 0;
  if (a.force_unsched != nullptr && a.force_unsched[c]) code |= 2;
  return code;
}

// Phases 0 and 1 of the step for pod c: the pre-reductions over N, then
// per node each filter in config order with its filter_skip, the
// first-fail word (compact) or the codes (full), and feasibility into
// sc.feas; the scope's leader writes the PreFilter reject.  Every thread
// of the scope calls it and gets the feasible count before the reject is
// applied, and the reject in `reject`; the scope's slice of sc.feas is
// complete when it returns (the sum's barrier).
template <class Scope>
__device__ int pod_filter(const StepArgs& a, int c, const PodScratch& sc, long long* sh_ll,
                          int& reject, Scope& scope) {
  const int N = a.N;
  reject = prefilter_reject(a, c);
  if (scope.leader()) a.out_prefilter_reject[c] = reject;
  long long sp_mins[KSS_MC];
  for (int m = 0; m < KSS_MC; ++m) sp_mins[m] = 0;
  bool ip_any_aff = false;
  int ip_total_any = 0;
  for (int f = 0; f < a.F; ++f) {
    if (a.filter_ids[f] == P_SPREAD && !a.sp_filter_skip[c])
      spread_minima(a, c, sp_mins, sh_ll, scope);
    if (a.filter_ids[f] == P_INTERPOD) interpod_pod_scalars(a, c, ip_any_aff, ip_total_any);
  }
  long long local_feasible = 0;
  for (int n = scope.lo + threadIdx.x; n < scope.hi; n += blockDim.x) {
    int first = -1, first_code = 0;
    for (int f = 0; f < a.F; ++f) {
      int code = filter_code(a, a.filter_ids[f], c, n, sp_mins, ip_any_aff, ip_total_any);
      if (!a.compact) a.out_codes[((long long)c * a.F + f) * N + n] = code;
      if (code != 0 && first < 0) { first = f; first_code = code; }
    }
    sc.feas[n] = first < 0;
    local_feasible += first < 0;
    if (a.compact) {
      long long word = first < 0 ? 0
          : (((long long)(first + 1)) << a.pack_code_bits) | (long long)first_code;
      store_packed(a, (long long)c * N + n, word);
    }
  }
  return (int)scope.sum(local_feasible, sh_ll);
}

__device__ __forceinline__ int pod_filter(const StepArgs& a, int c, const PodScratch& sc,
                                          long long* sh_ll, int& reject) {
  BlockScope scope(a);
  return pod_filter(a, c, sc, sh_ll, reject, scope);
}

// Phases 2-4 for pod c: raw scores (outputs and sc.raw) with the
// raw_overflow check, the normalizing reductions over the feasible set,
// normalize x weight into the int64 total (-1 where infeasible), the
// argmax (value desc, index asc) with feasible_count > 0 and is_pad
// applied; the scope's leader writes the pod's scalar outputs.
// feasible_count is 0 for a pod a PreFilter rejected.  Returns the
// selection to every thread.
template <class Scope>
__device__ int pod_score_select(const StepArgs& a, int c, int feasible_count,
                                const PodScratch& sc, long long* sh_ll, int* sh_i,
                                Scope& scope) {
  const int N = a.N;
  // ---- 2. raw scores
  int local_ovf = 0;
  for (int n = scope.lo + threadIdx.x; n < scope.hi; n += blockDim.x) {
    bool ignored = false;
    for (int s = 0; s < a.S; ++s) {
      const int pid = a.score_ids[s];
      bool ign = false;
      long long raw = score_skipped(a, pid, c) ? 0 : score_raw(a, pid, c, n, ign);
      if (pid == P_SPREAD) ignored = ign;
      sc.raw[(long long)s * N + n] = raw;
      if (a.compact) local_ovf |= store_raw(a, s, c, n, raw);
      else a.out_raw[((long long)c * a.S + s) * N + n] = (int)raw;
    }
    sc.ign[n] = ignored;
  }
  const int overflow = scope.any(local_ovf);

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
    for (int n = scope.lo + threadIdx.x; n < scope.hi; n += blockDim.x) {
      const long long raw = sc.raw[(long long)s * N + n];
      const bool feas = sc.feas[n] != 0;
      if (pid == P_SPREAD) {
        const bool scored = feas && !sc.ign[n];
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
    if (pid == P_SPREAD || pid == P_INTERPOD) lo[s] = scope.min(l, sh_ll);
    hi[s] = scope.max(h, sh_ll);
    if (pid == P_SPREAD) any_scored[s] = scope.any(any) != 0;
  }

  // ---- 4. normalize x weight, total, argmax
  long long best_v = LLONG_MIN;
  int best_i = INT_MAX;
  for (int n = scope.lo + threadIdx.x; n < scope.hi; n += blockDim.x) {
    long long total = 0;
    for (int s = 0; s < a.S; ++s) {
      const int pid = a.score_ids[s];
      long long final_ = 0;
      if (!score_skipped(a, pid, c)) {
        const long long raw = sc.raw[(long long)s * N + n];
        long long normed = raw;
        if (pid == P_AFFINITY) normed = default_normalize(raw, hi[s], false);
        else if (pid == P_TAINT) normed = default_normalize(raw, hi[s], true);
        else if (pid == P_SPREAD)
          normed = spread_normalize(raw, sc.ign[n] != 0, lo[s], hi[s], any_scored[s]);
        else if (pid == P_INTERPOD) normed = interpod_normalize(raw, lo[s], hi[s]);
        final_ = normed * a.score_weight[s];
      }
      if (!a.compact) a.out_final[((long long)c * a.S + s) * N + n] = (int)final_;
      total += final_;
    }
    if (!sc.feas[n]) total = -1;
    argmax_pair(best_v, best_i, total, n);
  }
  int sel = scope.argmax(best_v, best_i, sh_ll, sh_i);
  if (feasible_count == 0 || a.is_pad[c]) sel = -1;
  if (scope.leader()) {
    a.out_selected[c] = sel;
    a.out_feasible_count[c] = feasible_count;
    if (a.compact) a.out_overflow[c] = overflow != 0;
  }
  return sel;
}

// Phases 0-4 for pod c against the carry as it stands; returns the
// selection.  The caller binds (step_chunk) or does not (spec_eval).
template <class Scope>
__device__ __forceinline__ int eval_pod(const StepArgs& a, int c, const PodScratch& sc,
                                        long long* sh_ll, int* sh_i, Scope& scope) {
  int reject;
  const int total = pod_filter(a, c, sc, sh_ll, reject, scope);
  return pod_score_select(a, c, reject > 0 ? 0 : total, sc, sh_ll, sh_i, scope);
}

__device__ __forceinline__ int eval_pod(const StepArgs& a, int c, const PodScratch& sc,
                                        long long* sh_ll, int* sh_i) {
  BlockScope scope(a);
  return eval_pod(a, c, sc, sh_ll, sh_i, scope);
}

// Phase 5: the bind of pod c at `sel` into the carry, in place, for every
// carry the workload has (pipeline.py _bind_phase).  Every thread of the
// scope calls it; a rejected or padded pod (sel == -1) binds nothing.
// The node-space rows (spread counts, the InterPod matrices) take their
// same-domain increments over the scope's slice; everything that must
// happen exactly once (the selected node's core, NodePorts, disk and CSI
// rows, InterPod's matched_total, the cluster-wide ReadWriteOncePod bits
// and the PVs VolumeBinding claims) is done by the scope that owns the
// selected node.  The caller puts a barrier between the evaluation's
// last read of the carry and this call, and after it.
template <class Scope>
__device__ __forceinline__ void bind_pod(const StepArgs& a, int c, int sel, const Scope& scope) {
  if (sel < 0) return;
  const bool owner = scope.owns(sel);
  if (owner) core_bind(a, c, sel);
  if (a.has_ports && owner) ports_bind(a, c, sel);
  if (a.has_spread) spread_bind(a, c, sel, scope.lo, scope.hi);
  if (a.has_interpod) interpod_bind(a, c, sel, scope.lo, scope.hi, owner);
  if (a.has_vr && owner) vr_bind(a, c, sel);
  if (a.has_nvl && owner) nvl_bind(a, c, sel);
  if (a.has_vb && owner) vb_bind(a, c, sel);
}

__device__ __forceinline__ void bind_pod(const StepArgs& a, int c, int sel) {
  bind_pod(a, c, sel, BlockScope(a));
}
