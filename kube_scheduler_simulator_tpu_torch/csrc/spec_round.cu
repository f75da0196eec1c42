// spec_round: the sparse round of the speculative wave as pod groups,
// written for Hopper (sm_90a).
//
// It replaces two JAX functions:
//
//   * kube_scheduler_simulator_tpu/parallel/speculative.py:381
//     `_sparse_round_fn` (B4): its per-pod pass over a batch of B pods
//     against ONE frozen carry (kernels/spec.py spec_round; the conflict
//     oracle that the JAX package fuses into the same jit is spec_oracle
//     in oracle.cu, launched right after on the same stream);
//   * kube_scheduler_simulator_tpu/parallel/fuse.py:356 `_run_fused` over
//     the sparse round (B11): `_sparse_round_fn` vmapped over K sessions'
//     carries and batches stacked on a leading axis (kernels/fuse.py
//     spec_round_fused).
//
// The kernel takes a table of sessions (common.cuh StepTable); B4 is its
// one-session launch.  One CTA takes a group of P pods of one session (P
// of 1, 2, 4, 8: the launch's plan) over every node of the fleet; the
// grid is K x ceil(B / P) CTAs.  For each group, against its session's
// frozen carry:
//
//   a. one node pass for the P pods: threads walk the nodes in
//      warp-contiguous order (node it x blockDim + tid), and a thread
//      runs the P pods' filters at its node (pod.cuh node_filters, in
//      config order with filter_skip), the node's statics and carry from
//      L1 for the group's second pod; it writes each pod's packed
//      first-fail word, and one __ballot_sync per pod and 32 nodes writes
//      the pod's feasibility word to a bitmask in shared memory, ceil(N /
//      32) words a pod;
//   b. the first K feasible nodes in ASCENDING node order, from ranks
//      (the JAX cumsum + searchsorted): one warp a pod scans its words'
//      popcounts into each word's first rank and the feasible count (0
//      for a pod a PreFilter rejected), and node n of word w has rank
//      prefix[w] + popc(word & lanemask_lt), so a feasible node of rank
//      r < K is candidate r;
//   c. candidate slots past the feasible count hold node N-1 (the
//      searchsorted result clamped to n-1) and are invalid;
//   d. raw scores at the valid candidates, one (pod, slot) a thread, into
//      shared memory as [P, S, K] int64: score_raw at node cand[k], which
//      is what the JAX gather of every node-axis row computes for the
//      node-local plugins this round admits (kernels/spec.py check_round);
//   e. one warp a pod: DefaultNormalizeScore over the valid slots, total
//      = -1 at invalid ones, argmax over the slots with ties to the lowest
//      slot (the lowest node); selected = cand[slot], -1 with no feasible
//      node or on a pad row; raw_overflow, the OR over the valid
//      candidates of the checked narrowing;
//   f. every raw row written once, four nodes a thread a step in one
//      aligned store: node n gets its candidate's value where it is
//      feasible with rank below the valid count, 0 elsewhere (the JAX
//      scatter onto a zero grid).
//
// A group's state (the bitmasks, each word's first rank, the candidates
// and their scores) lives in dynamic shared memory, or where it passes
// the card's limit (a candidate cap near a wide fleet's N) in the CTA's
// slot of its session's StepArgs.spill: the same layout, the same kernel.
// Three block barriers a group, against eight or more a pod in one block
// a pod.
//
// What bounds it on this card: the filter pass, about 30 us a pod of
// thread 0's time (the phase clock, the -DKSS_PHASE_CLOCK build: 5,000
// nodes, three plugins; NVIDIA H100 80GB HBM3, 700.00 W, PERF.md §6),
// latency-bound per warp, so the kernel keeps four CTAs an SM (at most 64
// registers a thread); the bytes (a packed word and three raw rows a
// node) are microseconds.  A group of 2 runs its node pass about 5 %
// cheaper a pod than a pod alone; groups of 4 and 8 with four CTAs an SM
// cost 1.5 to 1.8 times as much, so the
// plan (kernels/spec.py round_pods, from kss_round_plan's residency) takes
// P = 2 where the launch's CTAs still fill half the card's resident slots,
// else 1; `_pods` forces any of 1, 2, 4, 8.
//
// Exactness: the same plugins and arithmetic as the step (int64 with
// floor division, float64 under -fmad=false), candidates ascending by
// node, integer normalize; every pod of a group, pad rows included,
// writes its own rows.
#include "cluster.cuh"

#define ROUND_THREADS 256
#define ROUND_BLOCKS 4      // CTAs an SM: at most 64 registers a thread
#define KSS_MAX_GROUP 8     // pods a CTA
#define KSS_GROUP_SIZES 4   // P = 1, 2, 4, 8

// A group's state, each part 16-byte aligned: per pod ceil(N / 32)
// feasibility words and each word's first rank, K candidates and
// max(S, 1) x K raw scores.
struct RoundSmem {
  size_t bits, prefix, cand, raw, total;
};

__host__ __device__ inline RoundSmem round_smem(const StepArgs& a, int pods) {
  const size_t p = (size_t)pods, w = (size_t)(a.N + 31) / 32, k = (size_t)a.K;
  RoundSmem m;
  size_t o = 0;
  m.bits = o;    o = align16(o + p * w * 4);
  m.prefix = o;  o = align16(o + p * w * 4);
  m.cand = o;    o = align16(o + p * k * 4);
  m.raw = o;     o = align16(o + p * (size_t)(a.S > 0 ? a.S : 1) * k * 8);
  m.total = o;
  return m;
}

__device__ __forceinline__ long long warp_max_ll(long long v) {
  for (int o = 16; o > 0; o >>= 1) v = ll_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Four consecutive elements of a row as one store (4, 8 or 16 bytes).
template <class T>
struct Quad;
template <> struct Quad<signed char> { using V = char4; };
template <> struct Quad<short> { using V = short4; };
template <> struct Quad<int> { using V = int4; };

// Node n's value in a raw row: its candidate's where it is feasible with
// rank below valid_n, else 0.  Bit `b` of `word`, whose first rank is
// `first`.
__device__ __forceinline__ long long row_value(unsigned word, int first, int b,
                                               const long long* r, int valid_n) {
  const int rank = first + __popc(word & ((1u << b) - 1u));
  return ((word >> b) & 1u) && rank < valid_n ? r[rank] : 0;
}

// One raw row of a pod over every node: four nodes a thread a step, in
// warp-contiguous order, one aligned store of four where the row allows
// it (N % 4 == 0 and a 4-byte element or narrower), else one node a
// thread a step.
template <class T>
__device__ __forceinline__ void round_row(T* row, const unsigned* pb, const int* pp,
                                          const long long* r, int valid_n, int N) {
  if constexpr (sizeof(T) <= 4) {
    if (N % 4 == 0 && ((size_t)row % (4 * sizeof(T))) == 0) {
      using V = typename Quad<T>::V;
      for (int n = 4 * threadIdx.x; n < N; n += 4 * blockDim.x) {
        const unsigned word = pb[n >> 5];
        const int first = pp[n >> 5], b = n & 31;
        V q;
        q.x = (T)row_value(word, first, b, r, valid_n);
        q.y = (T)row_value(word, first, b + 1, r, valid_n);
        q.z = (T)row_value(word, first, b + 2, r, valid_n);
        q.w = (T)row_value(word, first, b + 3, r, valid_n);
        *(V*)(row + n) = q;
      }
      return;
    }
  }
  for (int n = threadIdx.x; n < N; n += blockDim.x)
    row[n] = (T)row_value(pb[n >> 5], pp[n >> 5], n & 31, r, valid_n);
}

// The P = np pods c0 .. c0 + np - 1 of session a, their state at `base`.
// Inlined into each table size's kernel, so a session's arguments are
// read from the parameter space.
__device__ __forceinline__ void round_group(const StepArgs& a, int c0, int np,
                                            unsigned char* base) {
  __shared__ int sh_reject[KSS_MAX_GROUP], sh_count[KSS_MAX_GROUP];
  const int N = a.N, K = a.K, W = (N + 31) >> 5;
  const long long S1 = a.S > 0 ? a.S : 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = (int)(blockDim.x >> 5);
  const unsigned lt = (1u << lane) - 1u;  // lanemask_lt
  const RoundSmem m = round_smem(a, np);
  unsigned* bits = (unsigned*)(base + m.bits);      // [np, W]
  int* prefix = (int*)(base + m.prefix);             // [np, W]
  int* cand = (int*)(base + m.cand);                 // [np, K]
  long long* raw = (long long*)(base + m.raw);       // [np, S1, K]
  KSS_CLOCK(unsigned long long* ck = tid == 0 && a.clock
                ? a.clock + (long long)c0 * KSS_CLOCK_SLOTS : nullptr;
            unsigned long long tk = kss_now(); if (ck) ck[CR_START] = tk;)

  // ---- a. the P pods' filters in one node pass; the bitmasks
  if (tid < np) {
    const int reject = prefilter_reject(a, c0 + tid);
    a.out_prefilter_reject[c0 + tid] = reject;
    sh_reject[tid] = reject;
  }
  const PodPre pre{};  // the admitted plugins read no pre-pass
  for (int n0 = 0; n0 < N; n0 += blockDim.x) {
    const int n = n0 + tid;
    for (int p = 0; p < np; ++p) {
      const bool feas = n < N && node_filters(a, c0 + p, n, pre KSS_CLOCK(, nullptr));
      const unsigned word = __ballot_sync(0xffffffffu, feas);
      if (lane == 0 && n < N) bits[p * W + (n >> 5)] = word;
    }
  }
  __syncthreads();
  KSS_CLOCK(if (ck) { const unsigned long long t = kss_now(); ck[CR_FILTER] += t - tk; tk = t; })

  // ---- b/c. one warp a pod: each word's first rank, the feasible count,
  // the first K feasible nodes at their ranks, N-1 past the count
  for (int p = warp; p < np; p += nwarps) {
    const unsigned* pb = bits + p * W;
    int* pp = prefix + p * W;
    int* pc = cand + p * K;
    const int q = (W + 31) / 32;  // words a lane
    const int w0 = min(lane * q, W), w1 = min(w0 + q, W);
    int mine = 0;
    for (int w = w0; w < w1; ++w) mine += __popc(pb[w]);
    int x = mine;  // the warp's inclusive scan
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    const int total = __shfl_sync(0xffffffffu, x, 31);
    int run = x - mine;
    for (int w = w0; w < w1; ++w) {
      pp[w] = run;
      run += __popc(pb[w]);
    }
    __syncwarp();
    // the words holding candidates, 32 at a time: a ballot of those with
    // a feasible node of rank < K, then each of them by the whole warp
    for (int v0 = 0; v0 < W && pp[v0] < K; v0 += 32) {
      const int v = v0 + lane;
      unsigned todo = __ballot_sync(0xffffffffu, v < W && pb[v] != 0u && pp[v] < K);
      while (todo != 0u) {
        const int w = v0 + __ffs(todo) - 1;
        todo &= todo - 1u;
        const unsigned word = pb[w];
        const int rank = pp[w] + __popc(word & lt);
        if (((word >> lane) & 1u) && rank < K) pc[rank] = w * 32 + lane;
      }
    }
    for (int k = total + lane; k < K; k += 32) pc[k] = N - 1;
    if (lane == 0) sh_count[p] = sh_reject[p] > 0 ? 0 : total;
  }
  __syncthreads();
  KSS_CLOCK(if (ck) { const unsigned long long t = kss_now(); ck[CR_CAND] += t - tk; tk = t; })

  // ---- d. raw scores at the valid candidates, one (pod, slot) a thread
  for (int i = tid; i < np * K; i += blockDim.x) {
    const int p = i / K, k = i - p * K, c = c0 + p;
    const bool valid = k < min(sh_count[p], K);
    const int n = cand[i];
    long long* r = raw + (long long)p * S1 * K + k;
    for (int s = 0; s < a.S; ++s) {
      const int pid = a.score_ids[s];
      bool ign = false;
      r[(long long)s * K] = !valid || score_skipped(a, pid, c) ? 0 : score_raw(a, pid, c, n, ign);
    }
  }
  __syncthreads();
  KSS_CLOCK(if (ck) { const unsigned long long t = kss_now(); ck[CR_SCORE] += t - tk; tk = t; })

  // ---- e. one warp a pod: normalize over the valid slots, the total,
  // the argmax over the slots, the overflow; the pod's scalars.  The
  // admitted scorers that normalize are NodeAffinity's and
  // TaintToleration's (DefaultNormalizeScore), each at most once.
  for (int p = warp; p < np; p += nwarps) {
    const int c = c0 + p, count = sh_count[p], valid_n = min(count, K);
    const long long* r = raw + (long long)p * S1 * K;
    long long aff_hi = 0, taint_hi = 0;
    for (int s = 0; s < a.S; ++s) {
      const int pid = a.score_ids[s];
      if ((pid != P_AFFINITY && pid != P_TAINT) || score_skipped(a, pid, c)) continue;
      long long h = LLONG_MIN;
      for (int k = lane; k < K; k += 32) h = ll_max(h, k < valid_n ? r[(long long)s * K + k] : 0);
      h = warp_max_ll(h);
      if (pid == P_AFFINITY) aff_hi = h;
      else taint_hi = h;
    }
    long long best_v = LLONG_MIN;
    int best_k = INT_MAX, ovf = 0;
    for (int k = lane; k < K; k += 32) {
      long long tot = 0;
      for (int s = 0; s < a.S; ++s) {
        const int pid = a.score_ids[s];
        if (score_skipped(a, pid, c)) continue;
        const long long v = r[(long long)s * K + k];
        if (k < valid_n) ovf |= raw_narrows(a, s, v);
        long long normed = v;
        if (pid == P_AFFINITY) normed = default_normalize(v, aff_hi, false);
        else if (pid == P_TAINT) normed = default_normalize(v, taint_hi, true);
        tot += normed * a.score_weight[s];
      }
      if (k >= valid_n) tot = -1;
      argmax_pair(best_v, best_k, tot, k);
    }
    for (int o = 16; o > 0; o >>= 1) {
      const long long ov = __shfl_xor_sync(0xffffffffu, best_v, o);
      const int ok = __shfl_xor_sync(0xffffffffu, best_k, o);
      argmax_pair(best_v, best_k, ov, ok);
    }
    ovf = __any_sync(0xffffffffu, ovf);
    if (lane == 0) {
      int sel = count > 0 ? cand[p * K + best_k] : -1;
      if (a.is_pad[c]) sel = -1;
      a.out_selected[c] = sel;
      a.out_feasible_count[c] = count;
      a.out_overflow[c] = ovf != 0;
    }
  }
  KSS_CLOCK(if (ck) { const unsigned long long t = kss_now(); ck[CR_NORM] += t - tk; tk = t; })

  // ---- f. every raw row once, row by row, each in the node pass's order
  for (int p = 0; p < np; ++p) {
    const int c = c0 + p, valid_n = min(sh_count[p], K);
    const unsigned* pb = bits + p * W;
    const int* pp = prefix + p * W;
    for (int s = 0; s < a.S; ++s) {
      const long long* r = raw + ((long long)p * S1 + s) * K;
      const long long at = (long long)a.score_row[s] * N;
      switch (a.score_group[s]) {
        case G_RAW8:
          round_row(a.out_raw8 + (long long)c * a.S8 * N + at, pb, pp, r, valid_n, N);
          break;
        case G_RAW16:
          round_row(a.out_raw16 + (long long)c * a.S16 * N + at, pb, pp, r, valid_n, N);
          break;
        case G_RAW32:
          if (a.raw32_bytes == 8)
            round_row((long long*)a.out_raw32 + (long long)c * a.S32 * N + at, pb, pp, r,
                      valid_n, N);
          else
            round_row((int*)a.out_raw32 + (long long)c * a.S32 * N + at, pb, pp, r, valid_n, N);
          break;
      }  // G_NONE: a precompiled host row, never written
    }
  }
  KSS_CLOCK(if (ck) { const unsigned long long t = kss_now(); ck[CR_ROWS] += t - tk; ck[CR_END] = t; })
}

template <int KM>
__global__ void __launch_bounds__(ROUND_THREADS, ROUND_BLOCKS)
    spec_round_kernel(const __grid_constant__ StepTable<KM> t, int pods) {
  extern __shared__ __align__(16) unsigned char dyn[];
  const int groups = (t.s[0].C + pods - 1) / pods;
  const int session = KM == 1 ? 0 : (int)blockIdx.x / groups;
  const StepArgs& a = t.s[session];
  const int g = (int)blockIdx.x - session * groups;
  const int c0 = g * pods;
  unsigned char* base =
      a.spill != nullptr ? a.spill + (size_t)g * round_smem(a, pods).total : dyn;
  round_group(a, c0, min(pods, a.C - c0), base);
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

#include <map>
#include <tuple>

extern "C" int kss_step_args_size() { return (int)sizeof(StepArgs); }

// The members of one launch: the same batch, nodes, candidate cap and
// scorers, so one plan holds for all.
static bool same_shape(const StepArgs* table, int k) {
  for (int i = 1; i < k; ++i)
    if (table[i].C != table[0].C || table[i].N != table[0].N || table[i].K != table[0].K ||
        table[i].S != table[0].S)
      return false;
  return true;
}

// cudaOccupancyMaxActiveBlocksPerMultiprocessor of the table size KM's
// kernel with `bytes` of dynamic shared memory, asked once per card and
// per (KM, bytes) for the process; a refused query counts as none (0).
template <int KM>
static int round_resident(size_t bytes, int dev) {
  static std::mutex mu;
  static std::map<std::tuple<int, size_t>, int> memo;
  std::lock_guard<std::mutex> lock(mu);
  auto it = memo.find(std::make_tuple(dev, bytes));
  if (it == memo.end()) {
    int blocks = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, spec_round_kernel<KM>,
                                                      ROUND_THREADS, bytes) != cudaSuccess) {
      cudaGetLastError();
      blocks = 0;
    }
    it = memo.emplace(std::make_tuple(dev, bytes), blocks).first;
  }
  return it->second;
}

// The plan of a launch over a table of k sessions at each P = 2^j, j < 4:
// to resident[j] how many CTAs of that group size an SM holds at once (0
// where the group's state passes shared memory: the plan takes such a P
// only as P = 1), to cta_spill[j] the device memory a CTA's state then
// takes in its session's spill (else 0); to *sms the card's SMs.
extern "C" int kss_round_plan(const StepArgs* table, int k, int* resident,
                              long long* cta_spill, int* sms) {
  if (k < 1 || k > KSS_MAX_TABLE || !same_shape(table, k)) return (int)cudaErrorInvalidValue;
  return by_table(k, [&](auto km) {
    constexpr int KM = decltype(km)::value;
    int max_dynamic = 0, dev = 0;
    cudaError_t err = cluster_attributes<spec_round_kernel<KM>, false>(&max_dynamic);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
    for (int j = 0; j < KSS_GROUP_SIZES && err == cudaSuccess; ++j) {
      const size_t bytes = round_smem(table[0], 1 << j).total;
      const bool spill = bytes > (size_t)max_dynamic;
      resident[j] = spill ? 0 : round_resident<KM>(bytes, dev);
      cta_spill[j] = spill ? (long long)bytes : 0;
    }
    return (int)err;
  });
}

// Launches on the caller's stream; no synchronisation.  ceil(B / pods)
// CTAs per session, `pods` one of 1, 2, 4, 8, each session's spill set
// exactly where kss_round_plan gave the state bytes of device memory (a
// slot per CTA of the session).  Returns the launch's error, so a refused
// launch is reported at once.
extern "C" int kss_spec_round(const StepArgs* table, int k, int pods, void* stream) {
  if (k < 1 || k > KSS_MAX_TABLE || pods < 1 || pods > KSS_MAX_GROUP || (pods & (pods - 1)) ||
      table[0].C < 1 || table[0].K < 1 || !same_shape(table, k))
    return (int)cudaErrorInvalidValue;
  return by_table(k, [&](auto km) {
    constexpr int KM = decltype(km)::value;
    int max_dynamic = 0;
    const cudaError_t err = cluster_attributes<spec_round_kernel<KM>, false>(&max_dynamic);
    if (err != cudaSuccess) return (int)err;
    const size_t bytes = round_smem(table[0], pods).total;
    const bool spill = bytes > (size_t)max_dynamic;
    for (int i = 0; i < k; ++i)
      if (spill != (table[i].spill != nullptr)) return (int)cudaErrorInvalidValue;
    const int groups = (table[0].C + pods - 1) / pods;
    spec_round_kernel<KM><<<k * groups, ROUND_THREADS, spill ? 0 : bytes, (cudaStream_t)stream>>>(
        make_table<KM>(table, k), pods);
    return (int)cudaGetLastError();
  });
}
#endif
