// The cluster kernel of the scheduling step, step_chunk's (step.cu, which
// documents it) and B12's step_chunk_sharded's: one kernel, the widest
// slice and the mesh's "nodes" shards S its parameters (S = 1 without a
// mesh), from which each CTA computes its node slice (slices.cuh
// node_slice).  Its launch plan (the width, the CTA's threads and state)
// is cluster.cuh's.  Its template flag W is common.cuh's: a launch past
// the fixed tables (step_wide) takes the W = true instantiation.
//
// B12b's step over a card mesh, step_cards_kernel, is the same body under
// PeerScope (scope.cuh): a cluster a card, each card's StepArgs its own
// node slice; step.cu documents it.
#pragma once

#include "cluster.cuh"

// The chunk's pods in order under the scope `make_scope` builds from the
// CTA's ClusterScope: a's replicated cluster-wide carries copied into the
// CTA's state (b holds a with its replicas' pointers), each pod evaluated
// (pod.cuh eval_pod) and bound, the scope finished, and rank 0's replicas
// written back.  eval_pod's selection is the mesh's node index; the bind
// takes it less a.node_base.
template <bool W, class MakeScope>
__device__ __forceinline__ void step_chunk_body(const StepArgs& a, int width, int shards,
                                                unsigned char* dyn, PodShared& sh, StepArgs& b,
                                                MakeScope make_scope) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), ctas = (int)cluster.num_blocks();
  const NodeSlice ns = node_slice(a.N, shards, ctas / shards, width, rank);
  const int lo = ns.lo, hi = ns.hi;
  const StepSmem m = step_smem(a, width, true);
  unsigned char* smem = a.spill != nullptr ? a.spill + (size_t)rank * m.total : dyn;
  unsigned char* claimed = smem + m.claimed;
  unsigned char* rwop = smem + m.rwop;
  int* matched = (int*)(smem + m.matched);
  int* count = (int*)(smem + m.count);
  int* nvl_list = (int*)(smem + m.nvl);
  int* vb_pvs = (int*)(smem + m.vb_pvs);
  unsigned char* vb_slots = smem + m.vb_slots;

  if (threadIdx.x == 0) {
    b = a;
    if (a.has_vb) b.vb_claimed = claimed;
    if (a.has_vr) b.vr_rwop_used = rwop;
    if (a.has_interpod) b.ip_matched_total = matched;
  }
  if (a.has_vb)
    for (int v = threadIdx.x; v < a.VV; v += blockDim.x) claimed[v] = a.vb_claimed[v];
  if (a.has_vr)
    for (int r = threadIdx.x; r < a.RR; r += blockDim.x) rwop[r] = a.vr_rwop_used[r];
  if (a.has_interpod)
    for (int t = threadIdx.x; t < a.T; t += blockDim.x) matched[t] = a.ip_matched_total[t];
  if (a.has_nvl) nvl_counts(a, lo, hi, count);
  __syncthreads();

  KSS_CLOCK(unsigned long long* ck0 = threadIdx.x == 0 && rank == 0 ? a.clock : nullptr;
            if (ck0) ck0[(long long)a.C * KSS_CLOCK_SLOTS] = kss_now();)
  auto scope = make_scope(ClusterScope{
      lo, hi, rank, ctas,
      PodRows{(long long*)(smem + m.raw), smem + m.feas, smem + m.ign, lo, width}, &sh,
      PodVolumes{}, 0});
  scope.vols.nvl_count = a.has_nvl ? count : nullptr;
  scope.vols.count_lo = lo;
  for (int c = 0; c < a.C; ++c) {
    KSS_CLOCK(unsigned long long* ck = ck0 ? ck0 + (long long)c * KSS_CLOCK_SLOTS : nullptr;
              const unsigned long long t0 = kss_now();)
    // ---- 0. the pod's volume lists (uniform across the cluster)
    bool listed = false;
    if (a.has_nvl) {
      scope.vols.nvl_vols = nvl_list;
      scope.vols.nvl_n = a.nvl_filter_skip[c] ? 0 : nvl_compact(a, c, nvl_list, sh.i);
      listed = true;
    }
    KSS_CLOCK(const unsigned long long t1 = kss_now(); if (ck && a.has_nvl) ck[CK_NVL] += t1 - t0;)
    if (a.has_vb) {
      scope.vols.vb_pvs = vb_pvs;
      scope.vols.vb_slots = vb_slots;
      scope.vols.vb_n = vb_compact(b, c, vb_pvs, vb_slots, sh.i);
      listed = true;
    }
    if (listed) __syncthreads();  // the lists, written, before the node loop reads them
    KSS_CLOCK(const unsigned long long t2 = kss_now();
              if (ck) {
                if (a.has_vb) ck[CK_VB] += t2 - t1;
                ck[CK_PRE] += t2 - t0;
              })

    // ---- 1-3. pre-pass, node loop, normalize and argmax (pod.cuh)
    const int sel = eval_pod<W>(b, c, scope) - a.node_base;

    // ---- 4. the bind.  Every read of the carry for this pod happened
    // before the argmax's cluster barrier; a rejected or padded pod binds
    // nothing.
    KSS_CLOCK(const unsigned long long tb = kss_now();)
    bind_pod<W>(b, c, sel, lo, hi, scope.owns(sel), true, scope.vols);
    __syncthreads();  // the next pod reads the rows and replicas this one wrote
    KSS_CLOCK(if (ck) {
      const unsigned long long dt = kss_now() - tb;
      ck[CK_BIND] += dt;
      if (a.has_vb && a.VK > 0) ck[CK_VB] += dt;  // vb_bind's walk is most of it
    })
  }
  // no CTA leaves while another may still read its slots
  scope.finish();
  KSS_CLOCK(if (ck0) ck0[(long long)a.C * KSS_CLOCK_SLOTS + 1] = kss_now();)
  if (rank == 0) {
    if (a.has_vb)
      for (int v = threadIdx.x; v < a.VV; v += blockDim.x) a.vb_claimed[v] = claimed[v];
    if (a.has_vr)
      for (int r = threadIdx.x; r < a.RR; r += blockDim.x) a.vr_rwop_used[r] = rwop[r];
    if (a.has_interpod)
      for (int t = threadIdx.x; t < a.T; t += blockDim.x) a.ip_matched_total[t] = matched[t];
  }
}

template <bool W>
__global__ void __launch_bounds__(KSS_STEP_THREADS, 1)
    step_chunk_kernel(const __grid_constant__ StepArgs a, int width, int shards) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ PodShared sh;
  __shared__ StepArgs b;  // a, with the cluster-wide carries at this CTA's replicas
  step_chunk_body<W>(a, width, shards, dyn, sh, b, [](const ClusterScope& s) { return s; });
}

// B12b: table entry i (a card of the mesh, card peer.card0 + i) is
// cluster i; each card's cluster walks the chunk over its own node slice,
// the cards of a "dp" row combining through PeerScope.
template <bool W>
__global__ void __launch_bounds__(KSS_STEP_THREADS, 1)
    step_cards_kernel(const __grid_constant__ StepTable<KSS_MAX_CARDS> t, int width,
                      const __grid_constant__ PeerArgs peer) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ PodShared sh;
  __shared__ StepArgs b;
  const int i = (int)(blockIdx.x / cg::this_cluster().num_blocks());
  const StepArgs& a = t.s[i];
  step_chunk_body<W>(a, width, 1, dyn, sh, b, [&](const ClusterScope& s) {
    return PeerScope{s, &peer, peer.card0 + i, 0, a.node_base, peer.epoch, false};
  });
}

#ifdef __CUDACC__
// The cluster size step_chunk takes when not told: 16 where a
// non-portable cluster of 16 CTAs fits on the card, else 8, each rounded
// down to whole groups of the mesh's `shards` (16 / S CTAs a shard, or
// 8 / S; 16 or 8 without a mesh).
template <bool W>
static int step_auto_ctas(const StepArgs& a, int shards, int max_dynamic) {
  const int wide = KSS_MAX_CTAS / shards * shards;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  int clusters = 0;
  cluster_config(cluster_plan(a, wide, shards, max_dynamic, true), 1, wide, nullptr, attr, &cfg);
  if (cudaOccupancyMaxActiveClusters(&clusters, step_chunk_kernel<W>, &cfg) == cudaSuccess &&
      clusters >= 1)
    return wide;
  cudaGetLastError();  // a refused query only means 8
  return 8 / shards * shards;
}

// The plan of a launch over `shards` "nodes" shards, before it: the
// cluster size (`ctas` 0 picks it, step_auto_ctas; else it is taken as it
// is) to *out_ctas, and to *spill_bytes the device memory the launch needs
// in a.spill: 0 where each CTA's state fits in shared memory, else R times
// step_smem's total (cluster.cuh); to *mask_bytes the device memory it
// needs in a.vb_masks (common.cuh vb_mask_words, R CTAs).  A launch
// cluster_takes refuses is cudaErrorInvalidValue.
extern "C" int kss_step_plan(const StepArgs* args, int ctas, int shards, int* out_ctas,
                             long long* spill_bytes, long long* mask_bytes) {
  return by_wide(args, 1, [&](auto wide) {
    constexpr bool W = decltype(wide)::value;
    int max_dynamic = 0;
    const cudaError_t err = cluster_attributes<step_chunk_kernel<W>>(&max_dynamic);
    if (err != cudaSuccess) return (int)err;
    if (ctas == 0 && cluster_takes(*args, shards, shards))
      ctas = step_auto_ctas<W>(*args, shards, max_dynamic);
    if (!cluster_takes(*args, ctas, shards)) return (int)cudaErrorInvalidValue;
    const ClusterPlan p = cluster_plan(*args, ctas, shards, max_dynamic, true);
    *out_ctas = ctas;
    *spill_bytes = p.spill ? (long long)p.bytes * ctas : 0;
    *mask_bytes = vb_mask_words(args, 1) * 8 * ctas * p.threads;
    return (int)cudaSuccess;
  });
}

// One launch of a cluster of `ctas` CTAs over `shards` "nodes" shards on
// `stream`, its state where kss_step_plan put it (a.spill set exactly
// where the plan asked for it).  Returns the launch's error or
// cudaGetLastError(), so a refused launch is reported at once.
static int launch_step_cluster(const StepArgs* args, int ctas, int shards, void* stream) {
  if (!cluster_takes(*args, ctas, shards) || vb_masks_missing(args, 1))
    return (int)cudaErrorInvalidValue;
  return by_wide(args, 1, [&](auto wide) {
    constexpr bool W = decltype(wide)::value;
    int max_dynamic = 0;
    cudaError_t err = cluster_attributes<step_chunk_kernel<W>>(&max_dynamic);
    if (err != cudaSuccess) return (int)err;
    const ClusterPlan p = cluster_plan(*args, ctas, shards, max_dynamic, true);
    if (p.spill != (args->spill != nullptr)) return (int)cudaErrorInvalidValue;
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg;
    cluster_config(p, 1, ctas, (cudaStream_t)stream, attr, &cfg);
    return launch_result(cudaLaunchKernelEx(&cfg, step_chunk_kernel<W>, *args, p.width, shards));
  });
}

// ---- B12b: the step over a card mesh's cards (kernels/mesh.py
// step_chunk_cards).  A launch runs k of the mesh's cards, one cluster of
// R CTAs each (k = 1 on a card of its own; all the mesh's cards on
// virtual cards).  The clusters spin on each other, so the card must hold
// all k at once.

// The plan of a launch over the k cards of `table` on card `device`: R (`ctas` 0: the
// largest of 16, 8, 4, 2, 1 at which the card holds k clusters) to
// *out_ctas, the spill bytes of EACH card to *spill_bytes (0: shared
// memory), the launch's VolumeBinding mask bytes (one buffer, every entry
// pointing at it) to *mask_bytes and the clusters of R CTAs the card holds
// at once to *resident.
extern "C" int kss_step_cards_plan(const StepArgs* table, int k, int ctas, int device,
                                   int* out_ctas, long long* spill_bytes,
                                   long long* mask_bytes, int* resident) {
  if (k < 1 || k > KSS_MAX_CARDS) return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  return by_wide(table, k, [&](auto wide) {
    constexpr bool W = decltype(wide)::value;
    int max_dynamic = 0;
    const cudaError_t err = cluster_attributes<step_cards_kernel<W>>(&max_dynamic);
    if (err != cudaSuccess) return (int)err;
    if (ctas == 0) {
      ctas = 1;
      for (int r = KSS_MAX_CTAS; r > 1; r /= 2) {
        const ClusterPlan p = cluster_plan(table[0], r, 1, max_dynamic, true);
        if (active_clusters<step_cards_kernel<W>>(p, r) >= k) {
          ctas = r;
          break;
        }
      }
    }
    if (!cluster_takes(table[0], ctas, 1)) return (int)cudaErrorInvalidValue;
    const ClusterPlan p = cluster_plan(table[0], ctas, 1, max_dynamic, true);
    if (!cards_alike(table, k, p.width, true)) return (int)cudaErrorInvalidValue;
    *out_ctas = ctas;
    *spill_bytes = p.spill ? (long long)p.bytes * ctas : 0;
    *mask_bytes = vb_mask_words(table, k) * 8 * k * ctas * p.threads;
    *resident = active_clusters<step_cards_kernel<W>>(p, ctas);
    return (int)cudaSuccess;
  });
}

// One launch of k clusters of `ctas` CTAs, table entry i the mesh's card
// peer->card0 + i, on `stream` of the current card; KSS_ERR_RESIDENT where
// the card does not hold the k clusters at once.
static int launch_step_cards(const StepArgs* table, int k, int ctas, const PeerArgs* peer,
                             void* stream) {
  if (k < 1 || k > KSS_MAX_CARDS || !cluster_takes(table[0], ctas, 1) ||
      vb_masks_missing(table, k))
    return (int)cudaErrorInvalidValue;
  return by_wide(table, k, [&](auto wide) {
    constexpr bool W = decltype(wide)::value;
    int max_dynamic = 0;
    const cudaError_t err = cluster_attributes<step_cards_kernel<W>>(&max_dynamic);
    if (err != cudaSuccess) return (int)err;
    const ClusterPlan p = cluster_plan(table[0], ctas, 1, max_dynamic, true);
    if (!cards_alike(table, k, p.width, true)) return (int)cudaErrorInvalidValue;
    for (int i = 0; i < k; ++i)
      if (p.spill != (table[i].spill != nullptr)) return (int)cudaErrorInvalidValue;
    if (active_clusters<step_cards_kernel<W>>(p, ctas) < k) return KSS_ERR_RESIDENT;
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg;
    cluster_config(p, k, ctas, (cudaStream_t)stream, attr, &cfg);
    return launch_result(cudaLaunchKernelEx(&cfg, step_cards_kernel<W>,
                                            make_table<KSS_MAX_CARDS>(table, k), p.width,
                                            *peer));
  });
}
#endif
