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
//
// PeerScope (B12b): the "nodes" shards of a mesh on separate cards, each
// card's shard served by its own cluster under ClusterScope.  Each combine
// first ends inside the card (ClusterScope::combine), then the card's
// leader CTA publishes the card's partial into its entry of an exchange
// buffer held on every card of its group (the cards of one "dp" row): the
// values with plain stores, then the entry's epoch with a system-scope
// release store, so a peer that reads the epoch with a system-scope
// acquire load sees the values.  Every CTA's thread 0 then polls its own
// card's buffer for the group's entries of that epoch and folds them in
// card order (cards ascend in node order, so an argmax tie goes to the
// lowest node, and the integer folds are order-free anyway).  Entries are
// double-buffered by the epoch's parity: a card that publishes epoch e + 2
// into an entry has seen every card's epoch e + 1, which each card
// publishes only after all its CTAs read epoch e (the cluster barrier that
// opens every combine).  Epochs only grow, across launches too (the host
// gives each launch a base past the last one's, kernels/mesh.py
// Exchange), and a launch ends with a barrier over the group, so no card
// starts its next launch while a peer may still read this one's values.
// A wait past `bound` clock64() cycles writes the error word of the
// card's buffer (1 + the card waited for) and skips the waits after it;
// the wrapper raises on it.  The same code serves cards that are peers
// over NVLink and "virtual cards", clusters of one launch on one card
// each with buffers of its own, for tests and measurement.
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

  // The end of a launch: no CTA leaves while another may still read its
  // slots.
  __device__ void finish() { cg::this_cluster().sync(); }
};

// ---- B12b: the cross-card exchange (kernels/mesh.py Exchange)
#define KSS_MAX_CARDS 8
#define KSS_XW 16     // 8-byte words an entry: the epoch, KSS_CV values, an argmax index
#define KSS_XHEAD 16  // words of a buffer's header: [0] the error word

// A launch's view of its mesh's exchange: card k's buffer is xbuf[k], in
// card k's memory, KSS_XHEAD words then [slots][2 parities][cards][KSS_XW].
struct PeerArgs {
  unsigned long long* xbuf[KSS_MAX_CARDS];
  long long epoch;  // the launch's base: its combines take epoch + 1, + 2, ...
  long long bound;  // clock64() cycles a wait may take
  int cards;        // the cards of a group (a "dp" row of the mesh)
  int slots;        // pod slots of a buffer (one pod a slot at a time)
  int card0;        // the mesh index of the launch's table entry 0
};

__device__ __forceinline__ void st_release_sys(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long ld_acquire_sys(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

struct PeerScope : ClusterScope {
  const PeerArgs* peer;
  int card;        // this card's index in the mesh
  int slot;        // the pod slot of this cluster
  int node_base;   // this card's first node
  long long ep;    // the last epoch taken
  bool dead;       // a wait of this thread ran past the bound

  __device__ int group0() const { return card / peer->cards * peer->cards; }

  __device__ unsigned long long* entry(int owner, int parity, int j) const {
    return peer->xbuf[owner] + KSS_XHEAD +
           (((long long)slot * 2 + parity) * peer->cards + j) * KSS_XW;
  }

  // The card's leader thread: nv values and an index into this card's
  // entry on every card of the group, the epoch last.
  __device__ void publish(const long long* v, int nv, long long idx, long long e) {
    if (rank != 0 || threadIdx.x != 0) return;
    const int g0 = group0(), j = card - g0, b = (int)(e & 1);
    for (int k = 0; k < peer->cards; ++k) {
      unsigned long long* x = entry(g0 + k, b, j);
      for (int q = 0; q < nv; ++q) x[1 + q] = (unsigned long long)v[q];
      x[1 + KSS_CV] = (unsigned long long)idx;
      st_release_sys(x, (unsigned long long)e);
    }
  }

  // Thread 0: wait until every entry of the group on this card's buffer
  // holds epoch e or later.
  __device__ void await(long long e) {
    const int b = (int)(e & 1);
    for (int j = 0; j < peer->cards && !dead; ++j) {
      const unsigned long long* x = entry(card, b, j);
      const long long t0 = clock64();
      while ((long long)ld_acquire_sys(x) < e) {
        if (clock64() - t0 > peer->bound) {
          atomicCAS(peer->xbuf[card], 0ULL, (unsigned long long)(group0() + j + 1));
          dead = true;
          break;
        }
      }
    }
  }

  __device__ const volatile unsigned long long* value(long long e, int j) const {
    return entry(card, (int)(e & 1), j);
  }

  // The card's combine, then the group's: every thread gets the fold.
  __device__ const long long* combine(const long long* slot_, int nv, unsigned long long ops) {
    ClusterScope::combine(slot_, nv, ops);
    const long long e = ++ep;
    publish(sh->res, nv, 0, e);
    if (threadIdx.x == 0) {
      await(e);
      long long acc[KSS_CV];
      for (int j = 0; j < peer->cards; ++j) {
        const volatile unsigned long long* x = value(e, j);
        for (int q = 0; q < nv; ++q) {
          const long long y = (long long)x[1 + q];
          acc[q] = j == 0 ? y : op_apply(op_of(ops, q), acc[q], y);
        }
      }
      for (int q = 0; q < nv; ++q) sh->res[q] = acc[q];
    }
    __syncthreads();
    return sh->res;
  }

  // The card's argmax (local index), then the group's over the mesh's
  // node indices, (value desc, index asc).
  __device__ void combine_argmax(long long& v, int& i) {
    ClusterScope::combine_argmax(v, i);
    __syncthreads();  // every thread has read the card's result
    const long long e = ++ep;
    publish(&v, 1, i == INT_MAX ? (long long)INT_MAX : (long long)i + node_base, e);
    if (threadIdx.x == 0) {
      await(e);
      long long bv = LLONG_MIN;
      int bi = INT_MAX;
      for (int j = 0; j < peer->cards; ++j) {
        const volatile unsigned long long* x = value(e, j);
        argmax_pair(bv, bi, (long long)x[1], (int)(long long)x[1 + KSS_CV]);
      }
      sh->res_v = bv;
      sh->res_i = bi;
    }
    __syncthreads();
    v = sh->res_v;
    i = sh->res_i;
  }

  // The end of a launch: a barrier over the group's cards.
  __device__ void finish() {
    cg::this_cluster().sync();
    const long long e = ++ep;
    publish(nullptr, 0, 0, e);
    if (threadIdx.x == 0) await(e);
    __syncthreads();
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
