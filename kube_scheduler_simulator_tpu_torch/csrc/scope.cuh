// The reduction scope of the per-pod body (pod.cuh) and the combine that
// ends every reduction over the node axis.
//
// A scope says which nodes the calling block walks, where the pod's raw
// scores, feasibility and spread-ignore bytes are kept between the node
// loop and the normalize pass, which thread writes the pod's scalar
// outputs, and how a reduction over the node axis ends.  ClusterScope:
// CTA r of a thread-block cluster walks the node slice [lo, hi); a
// combine ends with one cluster barrier and one warp reading the S
// partials through distributed shared memory (step_chunk and
// spec_eval_cluster, with or without a mesh).
//
// A combine takes a vector of up to KSS_CV integer partials, each with its
// own operation (min, max, sum or or): every thread folds its values over
// its warp with shuffles, lane 0 of each warp writes them to shared
// memory, a block barrier, warp 0 folds the warps' partials into the
// block's slot, and the scope ends it.  ClusterScope's slots alternate
// between two buffers, so the next combine's write cannot overwrite a
// partial another CTA is still reading: a CTA that reaches that write has
// passed the cluster barrier of the combine in between, and so has every
// reader.  The values are integers, so the order of the reduction cannot
// change a result; it stays in rank order all the same.
#pragma once

#include <cooperative_groups.h>

#include "volumes.cuh"

namespace cg = cooperative_groups;

#define KSS_CV 9          // values of the widest combine (pod.cuh NodeStat)
#define KSS_MAX_WARPS 32

enum CombineOp { OP_MIN = 0, OP_MAX = 1, OP_SUM = 2, OP_OR = 3 };

// A combine's operations, two bits per value, value j at bits 2j.
__host__ __device__ constexpr unsigned long long combine_ops() { return 0; }
template <class... Rest>
__host__ __device__ constexpr unsigned long long combine_ops(int op, Rest... rest) {
  return (unsigned long long)op | (combine_ops(rest...) << 2);
}

__device__ __forceinline__ long long op_apply(int op, long long x, long long y) {
  switch (op) {
    case OP_MIN: return ll_min(x, y);
    case OP_MAX: return ll_max(x, y);
    case OP_SUM: return x + y;
    default: return x | y;
  }
}

__device__ __forceinline__ int op_of(unsigned long long ops, int j) {
  return (int)((ops >> (2 * j)) & 3ULL);
}

// Per-block shared buffers of the per-pod body: the block scans' slots
// (the volume lists' compaction), the warps' partials of a combine, the
// block's double-buffered partial and the combined result.
struct PodShared {
  int i[KSS_MAX_WARPS];
  long long warp[KSS_MAX_WARPS][KSS_CV];
  int warp_i[KSS_MAX_WARPS];
  long long slot[2][KSS_CV];
  int slot_i[2];
  long long res[KSS_CV];
  long long res_v;
  int res_i;
};

// Where a scope keeps the pod's rows: raw score s at node n is
// raw[s * stride + n - base].
struct PodRows {
  long long* raw;
  unsigned char* feas;
  unsigned char* ign;
  int base, stride;
};

struct ClusterScope {
  int lo, hi;          // this CTA's nodes
  int rank, ctas;       // this CTA's place in the cluster, the cluster's size
  PodRows rows;
  PodShared* sh;
  PodVolumes vols;
  int phase;           // combines done; picks the slot buffer

  __device__ bool leader() const { return threadIdx.x == 0 && rank == 0; }
  __device__ bool owns(int n) const { return n >= lo && n < hi; }

  // One cluster barrier; lane j of warp 0 folds value j of the R slots in
  // rank order and leaves it in sh->res for every thread of the block.
  __device__ const long long* combine(const long long* slot, int nv, unsigned long long ops) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int lane = threadIdx.x;
    if (lane < nv) {
      long long* mine = const_cast<long long*>(slot) + lane;
      const int op = op_of(ops, lane);
      long long r = *cluster.map_shared_rank(mine, 0);
      for (int k = 1; k < ctas; ++k) r = op_apply(op, r, *cluster.map_shared_rank(mine, k));
      sh->res[lane] = r;
    }
    __syncthreads();
    ++phase;
    return sh->res;
  }

  // Lane k of warp 0 reads rank k's (value, index); a warp argmax keeps
  // (value desc, index asc), so a tie between CTAs goes to the lower node.
  __device__ void combine_argmax(long long& v, int& i) {
    cg::cluster_group cluster = cg::this_cluster();
    const int b = phase & 1;
    cluster.sync();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      long long bv = LLONG_MIN;
      int bi = INT_MAX;
      for (int k = lane; k < ctas; k += 32)
        argmax_pair(bv, bi, *cluster.map_shared_rank(sh->slot[b], k),
                    *cluster.map_shared_rank(sh->slot_i + b, k));
      for (int o = 16; o > 0; o >>= 1) {
        const long long ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        argmax_pair(bv, bi, ov, oi);
      }
      if (lane == 0) { sh->res_v = bv; sh->res_i = bi; }
    }
    __syncthreads();
    v = sh->res_v;
    i = sh->res_i;
    ++phase;
  }
};

// A combine of NV values: every thread of the scope calls it with its
// partials and gets the results (in shared memory, valid until the scope's
// next combine).
template <int NV, unsigned long long OPS, class Scope>
__device__ const long long* scope_combine(long long (&v)[NV], Scope& scope) {
  static_assert(NV <= KSS_CV, "combine wider than KSS_CV");
  PodShared& sh = *scope.sh;
#pragma unroll
  for (int j = 0; j < NV; ++j)
    for (int o = 16; o > 0; o >>= 1)
      v[j] = op_apply(op_of(OPS, j), v[j], __shfl_xor_sync(0xffffffffu, v[j], o));
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < NV; ++j) sh.warp[w][j] = v[j];
  }
  __syncthreads();
  long long* slot = sh.slot[scope.phase & 1];
  if (w == 0 && lane < NV) {
    const int nw = (int)((blockDim.x + 31) >> 5), op = op_of(OPS, lane);
    long long r = sh.warp[0][lane];
    for (int k = 1; k < nw; ++k) r = op_apply(op, r, sh.warp[k][lane]);
    slot[lane] = r;
  }
  return scope.combine(slot, NV, OPS);
}

// The argmax over the scope, (value desc, index asc); every thread gets
// the winning index.
template <class Scope>
__device__ int scope_argmax(long long v, int i, Scope& scope) {
  PodShared& sh = *scope.sh;
  for (int o = 16; o > 0; o >>= 1) {
    const long long ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    argmax_pair(v, i, ov, oi);
  }
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) { sh.warp[w][0] = v; sh.warp_i[w] = i; }
  __syncthreads();
  const int b = scope.phase & 1;
  if (threadIdx.x == 0) {
    long long bv = sh.warp[0][0];
    int bi = sh.warp_i[0];
    const int nw = (int)((blockDim.x + 31) >> 5);
    for (int k = 1; k < nw; ++k) argmax_pair(bv, bi, sh.warp[k][0], sh.warp_i[k]);
    sh.slot[b][0] = bv;
    sh.slot_i[b] = bi;
  }
  scope.combine_argmax(v, i);
  return i;
}
