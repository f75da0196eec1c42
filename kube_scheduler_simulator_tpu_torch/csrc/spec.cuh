// The per-block bodies of the speculative round's kernels, shared by the
// solo kernels (spec_round.cu, spec_eval.cu's oracle) and their fused,
// cross-session forms (fuse.cu): a body reads only the StepArgs (or the
// oracle's pointers) it is given, so a fused launch that hands each
// session's block that session's arguments computes, block for block,
// what the session's solo launch computes.
//
// spec_round_pod: one pod of the sparse round (below).
// spec_oracle_block: the dirty-node prefix of one batch (below).
#pragma once

#include "pod.cuh"

#define SPEC_THREADS 256

// spec_round_pod, the sparse round of the speculative wave.  It
// replaces kube_scheduler_simulator_tpu/parallel/speculative.py:381
// `_sparse_round_fn` (its per-pod pass; the conflict oracle that the JAX
// package fuses into the same jit is spec_oracle in spec_eval.cu,
// launched right after on the same stream).  The pod of one
// block, against one frozen carry:
//
//   a. dense filters and the packed first-fail word at every node
//      (pod.cuh pod_filter), the feasible count;
//   b. the first K feasible nodes in ASCENDING node order: each thread
//      counts the feasible nodes of a contiguous tile, a block-wide
//      exclusive scan gives each tile its first rank, and the tile writes
//      its nodes at their ranks (the JAX cumsum + searchsorted);
//   c. candidate slots past the feasible count hold node N-1 (the
//      searchsorted result clamped to n-1) and are invalid;
//   d. raw scores at the candidates only: score_raw at node cand[k],
//      which is what the JAX gather of every node-axis row computes for
//      the node-local plugins this round admits;
//   e. DefaultNormalizeScore over the valid slots, total = -1 at invalid
//      ones, argmax over the slots with ties to the lowest slot (the
//      lowest node); selected = cand[slot], -1 with no feasible node or
//      on a pad row;
//   f. every raw row written in full: 0, then the valid candidates'
//      values at their nodes (the JAX scatter onto a zero grid);
//   g. raw_overflow over the valid candidates only.
//
// What bounds it on this card: the dense filter pass over N nodes per
// pod (bytes: a packed word written, a few statics read per node); the
// score tail is K = 128 nodes.  B blocks spread the batch over the SMs.
__device__ void spec_round_pod(const StepArgs& a, int c, PodShared& sh) {
  long long* sh_ll = sh.ll;
  int* sh_i = sh.i;
  const int N = a.N, K = a.K;
  const long long S1 = a.S > 0 ? a.S : 1;
  long long* raw = a.scratch_raw + (long long)c * S1 * K;   // [S, K]
  int* cand = a.scratch_cand + (long long)c * K;             // [K]
  const PodScratch sc = pod_scratch(a, c);                   // feas [N]

  // ---- a. filters and the packed word at every node; the feasible count
  // is 0 for a pod a PreFilter rejected, and every slot is then invalid
  int reject;
  const int total = pod_filter(a, c, sc, sh, reject);
  const int count = reject > 0 ? 0 : total;

  // ---- b/c. the first K feasible nodes, ascending
  const int tile = (N + (int)blockDim.x - 1) / (int)blockDim.x;
  const int n0 = min((int)threadIdx.x * tile, N), n1 = min(n0 + tile, N);
  int mine = 0;
  for (int n = n0; n < n1; ++n) mine += sc.feas[n];
  int rank = block_exclusive_scan(mine, sh_i);
  for (int n = n0; n < n1 && rank < K; ++n)
    if (sc.feas[n]) cand[rank++] = n;
  for (int k = total + threadIdx.x; k < K; k += blockDim.x) cand[k] = N - 1;
  __syncthreads();
  const int valid_n = min(count, K);  // slots k < valid_n are valid

  // ---- d. raw scores at the candidates
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const int n = cand[k];
    for (int s = 0; s < a.S; ++s) {
      const int pid = a.score_ids[s];
      bool ign = false;
      raw[(long long)s * K + k] = score_skipped(a, pid, c) ? 0 : score_raw(a, pid, c, n, ign);
    }
  }

  // ---- e. normalize over the valid slots, total, argmax over slots
  long long hi[KSS_MAX_S];
  for (int s = 0; s < a.S; ++s) {
    const int pid = a.score_ids[s];
    hi[s] = 0;
    if (!normalizes(pid) || score_skipped(a, pid, c)) continue;  // uniform
    long long h = LLONG_MIN;
    for (int k = threadIdx.x; k < K; k += blockDim.x)
      h = ll_max(h, k < valid_n ? raw[(long long)s * K + k] : 0);
    hi[s] = block_max_ll(h, sh_ll);
  }
  long long best_v = LLONG_MIN;
  int best_k = INT_MAX;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    long long tot = 0;
    for (int s = 0; s < a.S; ++s) {
      const int pid = a.score_ids[s];
      if (score_skipped(a, pid, c)) continue;
      const long long r = raw[(long long)s * K + k];
      long long normed = r;
      if (pid == P_AFFINITY) normed = default_normalize(r, hi[s], false);
      else if (pid == P_TAINT) normed = default_normalize(r, hi[s], true);
      tot += normed * a.score_weight[s];
    }
    if (k >= valid_n) tot = -1;
    argmax_pair(best_v, best_k, tot, k);
  }
  const int sel_k = block_argmax(best_v, best_k, sh_ll, sh_i);
  int sel = count > 0 ? cand[sel_k] : -1;
  if (a.is_pad[c]) sel = -1;

  // ---- f/g. raw rows in full, then the valid candidates; overflow
  for (long long i = threadIdx.x; i < (long long)a.S8 * N; i += blockDim.x)
    a.out_raw8[(long long)c * a.S8 * N + i] = 0;
  for (long long i = threadIdx.x; i < (long long)a.S16 * N; i += blockDim.x)
    a.out_raw16[(long long)c * a.S16 * N + i] = 0;
  for (long long i = threadIdx.x; i < (long long)a.S32 * N; i += blockDim.x) {
    if (a.raw32_bytes == 8) ((long long*)a.out_raw32)[(long long)c * a.S32 * N + i] = 0;
    else ((int*)a.out_raw32)[(long long)c * a.S32 * N + i] = 0;
  }
  __syncthreads();
  int local_ovf = 0;
  for (int k = threadIdx.x; k < valid_n; k += blockDim.x)
    for (int s = 0; s < a.S; ++s) local_ovf |= store_raw(a, s, c, cand[k], raw[(long long)s * K + k]);
  const int overflow = __syncthreads_or(local_ovf);
  if (threadIdx.x == 0) {
    a.out_selected[c] = sel;
    a.out_feasible_count[c] = count;
    a.out_overflow[c] = overflow != 0;
  }
}

__device__ __forceinline__ long long packed_at(const void* packed, int pack_bytes, long long i) {
  switch (pack_bytes) {
    case 1: return ((const unsigned char*)packed)[i];
    case 2: return ((const unsigned short*)packed)[i];
    case 4: return ((const int*)packed)[i];
    default: return ((const long long*)packed)[i];
  }
}

// spec_oracle_block replaces speculative.py:299 `_oracle_core`, the
// dirty-node prefix: pod k conflicts when it is feasible (packed word 0,
// no PreFilter reject) at the node an earlier pod j < k selected; K is
// the lowest conflicting k, or B.  One block; thread k walks j < k.
__device__ void spec_oracle_block(const void* packed, int pack_bytes, const int* reject,
                                  const int* selected, int B, int N, int* out_k, int& sh_k) {
  if (threadIdx.x == 0) sh_k = B;
  __syncthreads();
  for (int k = threadIdx.x; k < B; k += blockDim.x) {
    if (reject[k] != 0) continue;  // feasible nowhere: never conflicts
    const long long row = (long long)k * N;
    for (int j = 0; j < k; ++j) {
      const int s = selected[j];
      if (s >= 0 && packed_at(packed, pack_bytes, row + s) == 0) {
        atomicMin(&sh_k, k);
        break;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) *out_k = sh_k;
}
