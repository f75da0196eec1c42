// Shared definitions of the step kernel and the speculative wave's
// kernels: the argument block the Python wrappers fill (kernels/step.py
// mirrors it field for field as a ctypes.Structure), plugin ids, integer
// helpers, block reductions and the phase clock.  The reduction scopes of
// the per-pod body are in scope.cuh.
#pragma once

#include <climits>

#define KSS_MAX_F 16       // filter plugins per step
#define KSS_MAX_S 16       // score plugins per step
#define KSS_MAX_CUSTOM 8   // custom plugins with rows per step (B13)
#define KSS_MAX_RES 8      // scored resources per strategy
#define KSS_MAX_SHAPE 16   // RequestedToCapacityRatio shape points
#define KSS_MC 4           // topologyspread.MAX_CONSTRAINTS
#define KSS_MAX_VBK 8      // VolumeBinding: unbound claims per pod
#define KSS_VB_WORDS 4     // ... past KSS_MAX_VBK: open-slot mask words in a thread's own
                           // array; past KSS_VB_WORDS * 64 claims in StepArgs.vb_masks
#define KSS_THREADS 1024

enum PluginId {
  P_FIT = 0,        // NodeResourcesFit
  P_BALANCED = 1,   // NodeResourcesBalancedAllocation
  P_AFFINITY = 2,   // NodeAffinity
  P_TAINT = 3,      // TaintToleration
  P_SPREAD = 4,     // PodTopologySpread
  P_INTERPOD = 5,   // InterPodAffinity
  P_UNSCHED = 6,    // NodeUnschedulable
  P_NODENAME = 7,   // NodeName
  P_PORTS = 8,      // NodePorts
  P_IMAGE = 9,      // ImageLocality
  P_VOLRESTR = 10,  // VolumeRestrictions
  P_VOLLIMITS = 11, // NodeVolumeLimits
  P_VOLBIND = 12,   // VolumeBinding
  P_VOLZONE = 13,   // VolumeZone
  // a custom plugin (plugins/custom.py, B13): P_CUSTOM + its slot, its
  // index among the step's custom plugins in name order
  P_CUSTOM = 16,
};

enum ResSrc { RES_NONZERO = 0, RES_REQUESTED = 1, RES_NONE = 2 };
enum FitType { FIT_LEAST = 0, FIT_MOST = 1, FIT_RTCR = 2 };
enum RawGroup { G_NONE = 0, G_RAW8 = 1, G_RAW16 = 2, G_RAW32 = 3 };

// All 8-byte members first, then the 4-byte ones: the layout has no
// padding that ctypes and nvcc could place differently.  Shapes: N nodes,
// C pods in the chunk or batch, R resource columns, G spread count groups, T
// InterPod terms, Q/QS NodePorts (protocol, port) and specific-IP slots,
// VC/VD NodeVolumeLimits volumes and drivers, RD/RR VolumeRestrictions
// disks and ReadWriteOncePod claims, VV/VK VolumeBinding PVs and unbound
// claim slots; per-pod arrays are the chunk's or the batch's rows.  A
// pointer of a plugin the workload does not enable is null.
struct StepArgs {
  // --- core (NodeResourcesFit statics, carry and per-pod rows)
  const long long* allocatable;     // [N, R]
  const long long* allowed_pods;    // [N]
  const unsigned char* fit_ignored; // [R] bool
  long long* requested;             // [N, R]  carry, updated in place
  long long* nonzero;               // [N, 2]  carry
  long long* num_pods;              // [N]     carry
  const long long* pod_requests;    // [C, R]
  const long long* pod_nonzero;     // [C, 2]
  const unsigned char* is_pad;      // [C] bool
  // --- NodeAffinity
  const unsigned char* aff_req_rows;     // [U, N] bool
  const int* aff_pref_rows;              // [V, N]
  const int* aff_req_idx;                // [C]
  const int* aff_pref_idx;               // [C]
  const unsigned char* aff_filter_skip;  // [C]
  const unsigned char* aff_score_skip;   // [C]
  // --- TaintToleration
  const short* taint_code;               // [C, N]
  const short* taint_prefer;             // [C, N]
  // --- PodTopologySpread
  const int* sp_dom_idx;                 // [G, N]
  int* sp_counts;                        // [G, N] carry
  const unsigned char* sp_pm;            // [C, G] bool
  const int* sp_c_id;                    // [C, MC]
  const int* sp_max_skew;                // [C, MC]
  const unsigned char* sp_is_filter;     // [C, MC]
  const unsigned char* sp_is_score;      // [C, MC]
  const double* sp_weight;               // [C, MC]
  const unsigned char* sp_eligible;      // [C, N] or [C, MC, N]
  const unsigned char* sp_md_unsat;      // [C, MC]
  const unsigned char* sp_filter_skip;   // [C]
  const unsigned char* sp_score_skip;    // [C]
  // --- InterPodAffinity
  const int* ip_dom_idx;                 // [T, N]
  int* ip_matched;                       // [T, N] carry
  int* ip_have_req_anti;                 // [T, N] carry
  int* ip_have_req_aff;                  // [T, N] carry
  int* ip_sym_pref_aff;                  // [T, N] carry
  int* ip_sym_pref_anti;                 // [T, N] carry
  int* ip_matched_total;                 // [T]    carry
  const unsigned char* ip_t_matches;     // [C, T] bool
  const int* ip_h_req_aff;               // [C, T]
  const int* ip_h_req_anti;              // [C, T]
  const long long* ip_h_pref_aff_w;      // [C, T]
  const long long* ip_h_pref_anti_w;     // [C, T]
  const unsigned char* ip_self_ok;       // [C]
  const unsigned char* ip_filter_skip;   // [C]
  // --- NodeUnschedulable, NodeName
  const unsigned char* unsched_fail;     // [C, N] bool
  const unsigned char* nodename_fail;    // [C, N] bool
  // --- NodePorts
  const int* np_sq;                      // [QS] specific slot -> its (protocol, port) slot
  const unsigned char* np_w_wild;        // [C, Q]
  const unsigned char* np_w_spec;        // [C, QS]
  const unsigned char* np_w_any;         // [C, Q]
  const unsigned char* np_filter_skip;   // [C]
  unsigned char* np_used_any;            // [N, Q]  carry
  unsigned char* np_used_wild;           // [N, Q]  carry
  unsigned char* np_used_spec;           // [N, QS] carry
  // --- ImageLocality
  const long long* image_score;          // [C, N]
  // --- VolumeZone
  const int* vz_codes;                   // [C, vz_width]
  const unsigned char* vz_filter_skip;   // [C]
  // --- NodeVolumeLimits
  const unsigned char* nvl_onehot;       // [VC, VD]
  const long long* nvl_limits;           // [N, VD], -1 = unlimited
  const unsigned char* nvl_pod_vols;     // [C, VC]
  const unsigned char* nvl_filter_skip;  // [C]
  unsigned char* nvl_on_node;            // [N, VC] carry
  // --- VolumeRestrictions
  const unsigned char* vr_strict;        // [RD]
  const unsigned char* vr_w_any;         // [C, RD]
  const unsigned char* vr_w_rw;          // [C, RD]
  const unsigned char* vr_rwop;          // [C, RR]
  const unsigned char* vr_filter_skip;   // [C]
  unsigned char* vr_used_any;            // [N, RD] carry
  unsigned char* vr_used_rw;             // [N, RD] carry
  unsigned char* vr_rwop_used;           // [RR]    carry, cluster-wide
  // --- VolumeBinding
  const long long* vb_pv_cap;            // [VV]
  const unsigned char* vb_pv_node_ok;    // [VV, N]
  const int* vb_bound_code;              // [C, vb_width]
  const unsigned char* vb_want;          // [C, VK, VV]
  const unsigned char* vb_active;        // [C, VK]
  const unsigned char* vb_provision_ok;  // [C, VK, N]
  const unsigned char* vb_filter_skip;   // [C]
  unsigned char* vb_claimed;             // [VV] carry, cluster-wide
  const int* vb_order;                   // [VV] PV indices by (capacity, index)
  // --- compile-time PreFilter rejects (xs["force_unsched"])
  const unsigned char* force_unsched;    // [C] bool, or null
  // --- custom plugins (B13): slot k's precompiled rows, or null
  const int* cu_codes[KSS_MAX_CUSTOM];         // [C, N] 0 pass, else 1 + message id
  const long long* cu_scores[KSS_MAX_CUSTOM];  // [C, N] raw scores
  // --- outputs, "full" mode (StepOut)
  int* out_codes;                        // [C, F, N]
  int* out_raw;                          // [C, S, N]
  int* out_final;                        // [C, S, N]
  // --- outputs, "compact" mode (CompactOut)
  void* out_packed;                      // [C, N] of pack_bytes
  signed char* out_raw8;                 // [C, S8, N]
  short* out_raw16;                      // [C, S16, N]
  void* out_raw32;                       // [C, S32, N] of raw32_bytes
  unsigned char* out_overflow;           // [C] bool
  // --- outputs, both modes
  int* out_selected;                     // [C]
  int* out_feasible_count;               // [C]
  int* out_prefilter_reject;             // [C]
  // --- the phase clock (built with -DKSS_PHASE_CLOCK only): per pod
  // KSS_CLOCK_SLOTS durations in ns, then the launch's start and end
  // (the sparse round: RoundClockSlot, no launch stamps)
  unsigned long long* clock;             // [C * KSS_CLOCK_SLOTS (+ 2)], or null
  // --- a kernel's per-CTA state in device memory, where it does not fit
  // in shared memory (cluster.cuh cluster_plan, spec_round.cu
  // round_smem): [CTAs, the state's bytes]
  unsigned char* spill;                  // or null: shared memory
  // --- the step's tables where they pass the fixed arrays below (step_tables)
  const long long* ext;                  // or null: the fixed arrays
  // --- VolumeBinding's open-slot masks past KSS_VB_WORDS * 64 claims a pod
  // (volumes.cuh vb_greedy_wide): [vb_mask_words, the launch's threads],
  // sized by the launch's plan (its mask bytes) and allocated by its caller
  unsigned long long* vb_masks;          // or null: no pod past the threads' own arrays
  // --- 8-byte scalars
  long long ip_hard_weight;
  long long score_weight[KSS_MAX_S];
  long long fit_weight[KSS_MAX_RES];
  long long shape_u[KSS_MAX_SHAPE];      // RTCR utilization points
  long long shape_s[KSS_MAX_SHAPE];      // RTCR scores (x10)
  // --- 4-byte scalars
  int C, N, R, G, T;
  int K;                                 // spec_round: candidates per pod
  int F, S, S8, S16, S32;
  int filter_ids[KSS_MAX_F];
  int score_ids[KSS_MAX_S];
  int score_group[KSS_MAX_S];            // RawGroup, compact mode
  int score_row[KSS_MAX_S];              // row within its group
  int compact;                           // 0 "full", 1 "compact"
  int pack_code_bits;
  int pack_bytes;                        // 1, 2, 4 or 8
  int raw32_bytes;                       // 4 or 8
  int check_group;                       // group whose narrowing is checked
  int fit_type;                          // FitType
  int fit_nres;
  int fit_src[KSS_MAX_RES];              // ResSrc
  int fit_col[KSS_MAX_RES];
  int fit_need_request[KSS_MAX_RES];     // scalar resource: pod must request it
  int fit_nshape;
  int bal_nres;
  int bal_src[KSS_MAX_RES];
  int bal_col[KSS_MAX_RES];
  int bal_need_request[KSS_MAX_RES];
  int has_spread;                        // carry holds PodTopologySpread
  int has_interpod;                      // carry holds InterPodAffinity
  int sp_elig_per_slot;                  // eligible is [C, MC, N]
  int Q, QS, VC, VD, RD, RR, VV, VK;
  int vz_width;                          // 1 (every pod Skips) or N
  int vb_width;                          // 1 (no pod has a bound claim) or N
  int has_ports;                         // carry holds NodePorts
  int has_nvl;                           // carry holds NodeVolumeLimits
  int has_vr;                            // carry holds VolumeRestrictions
  int has_vb;                            // carry holds VolumeBinding
  // --- a card of a card mesh (B12b, kernels/mesh.py): its nodes are the
  // mesh's [node_base, node_base + N); the tables whole_at reads are
  // whole_n wide.  Without a card mesh node_base is 0 and whole_n is N.
  int node_base;
  int whole_n;
};

// A card mesh gives each card its node slice of every [.., N] tensor but
// the rows that a bind reads at a selected node on another card: the
// spread and InterPod node-to-domain rows (sp_dom_idx, ip_dom_idx) and
// VolumeBinding's PV and provision rows (vb_pv_node_ok, vb_provision_ok)
// stay whole on every card.  Local node n (negative or past N where the
// node is another card's) is column node_base + n of such a row.  Args is
// StepArgs or any struct with node_base and whole_n (phased.cu RenormArgs).
template <class Args>
__device__ __forceinline__ long long whole_at(const Args& a, long long row, int n) {
  return row * a.whole_n + a.node_base + n;
}

// A launch's table of sessions: one StepArgs per session, KM entries (1,
// 2, 4, 8 or 16), taken by a kernel as one __grid_constant__ parameter
// and read in place from the parameter space, indexed by the session of
// the CTA.  16 x 1,944 bytes = 31,104 (kernels/step.py checks
// sizeof(StepArgs) against its mirror), inside the 32,764 bytes CUDA
// 12.1+ allows a kernel's parameters on this card, with room for the
// kernel's other parameters.  The members share the batch, the node count
// and the output widths (kernels/fuse.py checks them); KM = 1 is a solo
// launch.  A workload past the fixed arrays keeps its tables in device
// memory (StepArgs.ext), so the table's size does not depend on them.
#define KSS_MAX_TABLE 16

template <int KM>
struct StepTable {
  StepArgs s[KM];
};
static_assert(sizeof(StepTable<KSS_MAX_TABLE>) <= 32764 - 64,
              "a table of KSS_MAX_TABLE StepArgs passes a kernel's parameter space");

// ---- the step's tables.  A workload within the fixed arrays keeps them
// in StepArgs (the parameter space, or the CTA's copy in shared memory);
// past any of them (more than KSS_MAX_F filters, KSS_MAX_S scorers,
// KSS_MAX_CUSTOM custom plugins with rows, KSS_MAX_RES resources of a
// strategy or KSS_MAX_SHAPE shape points) kernels/step.py make_args puts
// every table in a.ext, one int64 array in device memory:
//   filter ids [F]; score ids, weights, raw groups, rows [S each];
//   NodeResourcesFit's source, column, need-request, weight [fit_nres
//   each]; shape utilizations, scores [fit_nshape each];
//   BalancedAllocation's source, column, need-request [bal_nres each];
//   then each custom slot's codes and scores addresses, in slot order.
// The kernels read them only through these accessors, whose template flag
// W ("wide") is the kernel instantiation's: W = false reads the fixed
// arrays alone, the code of a launch within them; W = true reads a.ext
// where it is set (a table launch may mix members), and also takes a pod
// past KSS_MAX_VBK claims (volumes.cuh).  The launch functions pick W
// from the StepArgs (step_wide).
struct ResDesc {
  int src, col, need;  // ResSrc, the column, a scalar the pod must request
  long long weight;    // NodeResourcesFit only
};

__device__ __forceinline__ const long long* ext_fit(const StepArgs& a) {
  return a.ext + a.F + 4 * a.S;
}
__device__ __forceinline__ const long long* ext_shape(const StepArgs& a) {
  return ext_fit(a) + 4 * a.fit_nres;
}
__device__ __forceinline__ const long long* ext_bal(const StepArgs& a) {
  return ext_shape(a) + 2 * a.fit_nshape;
}
template <bool W>
__device__ __forceinline__ int filter_id(const StepArgs& a, int f) {
  if constexpr (W) if (a.ext) return (int)a.ext[f];
  return a.filter_ids[f];
}
template <bool W>
__device__ __forceinline__ int score_id(const StepArgs& a, int s) {
  if constexpr (W) if (a.ext) return (int)a.ext[a.F + s];
  return a.score_ids[s];
}
template <bool W>
__device__ __forceinline__ long long score_weight_of(const StepArgs& a, int s) {
  if constexpr (W) if (a.ext) return a.ext[a.F + a.S + s];
  return a.score_weight[s];
}
template <bool W>
__device__ __forceinline__ int score_group_of(const StepArgs& a, int s) {
  if constexpr (W) if (a.ext) return (int)a.ext[a.F + 2 * a.S + s];
  return a.score_group[s];
}
template <bool W>
__device__ __forceinline__ int score_row_of(const StepArgs& a, int s) {
  if constexpr (W) if (a.ext) return (int)a.ext[a.F + 3 * a.S + s];
  return a.score_row[s];
}
template <bool W>
__device__ __forceinline__ ResDesc fit_desc(const StepArgs& a, int k) {
  if constexpr (W) {
    if (a.ext) {
      const long long* t = ext_fit(a);
      const int r = a.fit_nres;
      return ResDesc{(int)t[k], (int)t[r + k], (int)t[2 * r + k], t[3 * r + k]};
    }
  }
  return ResDesc{a.fit_src[k], a.fit_col[k], a.fit_need_request[k], a.fit_weight[k]};
}
template <bool W>
__device__ __forceinline__ void shape_point(const StepArgs& a, int i, long long& u, long long& s) {
  if constexpr (W) {
    if (a.ext) {
      const long long* t = ext_shape(a);
      u = t[i];
      s = t[a.fit_nshape + i];
      return;
    }
  }
  u = a.shape_u[i];
  s = a.shape_s[i];
}
template <bool W>
__device__ __forceinline__ ResDesc bal_desc(const StepArgs& a, int k) {
  if constexpr (W) {
    if (a.ext) {
      const long long* t = ext_bal(a);
      const int r = a.bal_nres;
      return ResDesc{(int)t[k], (int)t[r + k], (int)t[2 * r + k], 0};
    }
  }
  return ResDesc{a.bal_src[k], a.bal_col[k], a.bal_need_request[k], 0};
}
template <bool W>
__device__ __forceinline__ const int* custom_codes(const StepArgs& a, int slot) {
  if constexpr (W) if (a.ext) return (const int*)ext_bal(a)[3 * a.bal_nres + 2 * slot];
  return a.cu_codes[slot];
}
template <bool W>
__device__ __forceinline__ const long long* custom_scores(const StepArgs& a, int slot) {
  if constexpr (W) if (a.ext) return (const long long*)ext_bal(a)[3 * a.bal_nres + 2 * slot + 1];
  return a.cu_scores[slot];
}

#ifdef __CUDACC__
#include <type_traits>

// f(std::integral_constant<int, KM>) for the smallest table that holds k
// sessions, so a solo launch passes one StepArgs and a pair two.
template <class F>
static int by_table(int k, F&& f) {
  if (k <= 1) return f(std::integral_constant<int, 1>{});
  if (k <= 2) return f(std::integral_constant<int, 2>{});
  if (k <= 4) return f(std::integral_constant<int, 4>{});
  if (k <= 8) return f(std::integral_constant<int, 8>{});
  return f(std::integral_constant<int, KSS_MAX_TABLE>{});
}

static inline bool step_wide(const StepArgs& a) {
  return a.ext != nullptr || a.VK > KSS_MAX_VBK;
}

// f(std::integral_constant<bool, W>): W = true where any of the k
// sessions is wide (step_wide).
template <class F>
static int by_wide(const StepArgs* args, int k, F&& f) {
  for (int i = 0; i < k; ++i)
    if (step_wide(args[i])) return f(std::integral_constant<bool, true>{});
  return f(std::integral_constant<bool, false>{});
}

// by_table for the wide instantiations, which are built at KM = 1 and
// KSS_MAX_TABLE only (a wide launch is rare; each instantiation is build
// time).
template <bool W, class F>
static int by_table_of(int k, F&& f) {
  if constexpr (W) {
    if (k <= 1) return f(std::integral_constant<int, 1>{});
    return f(std::integral_constant<int, KSS_MAX_TABLE>{});
  } else {
    return by_table(k, f);
  }
}

template <int KM>
static StepTable<KM> make_table(const StepArgs* args, int k) {
  StepTable<KM> t;
  for (int i = 0; i < k; ++i) t.s[i] = args[i];
  return t;
}

// The open-slot mask words a thread of a launch over the k sessions keeps
// in StepArgs.vb_masks: ceil(VK / 64) at the widest session's VK where a
// pod passes KSS_VB_WORDS * 64 claims, else 0 (the threads' own arrays).
// A plan's mask bytes are these words x 8 x its threads; a launch with
// words and no vb_masks is refused.
static inline long long vb_mask_words(const StepArgs* args, int k) {
  int words = 0;
  for (int i = 0; i < k; ++i)
    if (args[i].VK > KSS_VB_WORDS * 64 && (args[i].VK + 63) >> 6 > words)
      words = (args[i].VK + 63) >> 6;
  return words;
}

static inline bool vb_masks_missing(const StepArgs* args, int k) {
  if (vb_mask_words(args, k) == 0) return false;
  for (int i = 0; i < k; ++i)
    if (args[i].vb_masks == nullptr) return true;
  return false;
}
#endif

// ---- the phase clock.  Under -DKSS_PHASE_CLOCK, thread 0 of the
// leading block reads %globaltimer at each phase boundary of each pod and
// adds the phase's nanoseconds to a.clock[c * KSS_CLOCK_SLOTS + slot]:
//   0 pre-reductions (with the pod's volume lists), 1 filter and 2 score
//   (the thread's own nodes), 3 normalize reductions (the node loop's
//   combine, waits for the other threads and CTAs included), 4 normalize
//   x weight and argmax, 5 bind; 6 NodeVolumeLimits' share and 7
//   VolumeBinding's (inside 0-5: the thread's filter calls, the pod's
//   list and, for VolumeBinding, the bind).  a.clock[C * KSS_CLOCK_SLOTS]
//   and the next are the launch's first and last stamps.  Every other
//   build compiles the stamps out.
#define KSS_CLOCK_SLOTS 8
enum ClockSlot { CK_PRE = 0, CK_FILTER, CK_SCORE, CK_REDUCE, CK_ARGMAX, CK_BIND, CK_NVL, CK_VB };
// The sparse round's (spec_round, spec_round_fused) use of a pod's slots,
// by thread 0 of each CTA in the slots of the CTA's first pod: the ns of
// its phases, a filter, b/c candidates, d scores, e normalize and argmax,
// f/g rows and overflow; then the CTA's first and last stamps.
enum RoundClockSlot { CR_FILTER = 0, CR_CAND, CR_SCORE, CR_NORM, CR_ROWS, CR_START, CR_END };
#ifdef KSS_PHASE_CLOCK
__device__ __forceinline__ unsigned long long kss_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define KSS_CLOCK(...) __VA_ARGS__
#else
#define KSS_CLOCK(...)
#endif

static constexpr long long KSS_BIG = 1LL << 40;   // topologyspread._BIG
static constexpr int MAX_NODE_SCORE = 100;

// Floor vs truncation: jnp's (and torch's) `//` floors, C's `/`
// truncates.  Every `//` of the reference goes through floordiv, so the
// results agree at every node, feasible or not.
__device__ __forceinline__ long long floordiv(long long a, long long b) {
  long long q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) q -= 1;
  return q;
}

// fitscoring._jnp_trunc_div: Go's truncating division, on purpose.
__device__ __forceinline__ long long truncdiv(long long a, long long b) {
  long long q = (a < 0 ? -a : a) / (b < 0 ? -b : b);
  return ((a >= 0) == (b >= 0)) ? q : -q;
}

__device__ __forceinline__ long long ll_min(long long a, long long b) { return a < b ? a : b; }
__device__ __forceinline__ long long ll_max(long long a, long long b) { return a > b ? a : b; }

// ---- block reductions.  Every thread of the block calls them with its
// partial; every thread gets the result.  `sh` holds one slot per warp.
// The leading __syncthreads keeps a reduction from overwriting slots the
// previous one is still reading.

__device__ __forceinline__ long long block_min_ll(long long v, long long* sh) {
  for (int o = warpSize / 2; o > 0; o >>= 1) v = ll_min(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  long long r = sh[0];
  for (int w = 1; w < (int)((blockDim.x + 31) >> 5); ++w) r = ll_min(r, sh[w]);
  return r;
}

__device__ __forceinline__ long long block_max_ll(long long v, long long* sh) {
  for (int o = warpSize / 2; o > 0; o >>= 1) v = ll_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  long long r = sh[0];
  for (int w = 1; w < (int)((blockDim.x + 31) >> 5); ++w) r = ll_max(r, sh[w]);
  return r;
}

// Argmax ties go to the LOWEST node index (pipeline.py:385, jnp.argmax
// returns the first maximum): the pair order is (value desc, index asc).
__device__ __forceinline__ void argmax_pair(long long& v, int& i, long long ov, int oi) {
  if (ov > v || (ov == v && oi < i)) { v = ov; i = oi; }
}

// Exclusive prefix sum of one int per thread, in thread order; every
// thread gets its own prefix.  blockDim.x must be a multiple of 32; `sh`
// holds one slot per warp.
__device__ __forceinline__ int block_exclusive_scan(int v, int* sh) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  __syncthreads();
  if (lane == 31) sh[w] = x;
  __syncthreads();
  int off = 0;
  for (int k = 0; k < w; ++k) off += sh[k];
  return off + x - v;
}
