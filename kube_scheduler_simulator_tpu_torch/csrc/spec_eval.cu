// spec_eval_cluster: the dense round of the speculative wave and the
// host path's evaluation, written for Hopper (sm_90a).
//
// spec_eval_cluster replaces four JAX functions, one per output layout
// (StepArgs.compact), one across sessions and one over a mesh:
//
//   * kube_scheduler_simulator_tpu/parallel/speculative.py:318 `_eval_fn`
//     (B2): the step's compact evaluation, vmapped over a batch of B pods
//     against ONE frozen carry, with no bind (kernels/spec.py spec_eval);
//   * kube_scheduler_simulator_tpu/framework/pipeline.py:446
//     `build_phased`'s eval_fn (B10): one pod's evaluation against the
//     carry as it stands, writing the UNCOMPACTED StepOut the host loop
//     reads: every filter's code at every node, every scorer's raw and
//     final row as int32 (kernels/phased.py phased_eval);
//   * kube_scheduler_simulator_tpu/parallel/fuse.py:356 `_run_fused` over
//     the dense round (B11): `_eval_fn` vmapped over K sessions' carries
//     and batches stacked on a leading axis (kernels/fuse.py
//     spec_eval_fused);
//   * kube_scheduler_simulator_tpu/parallel/mesh.py:143
//     `speculative_scores` (B12): `_eval_fn` with every [.., N] tensor
//     sharded over the mesh's "nodes" axis, GSPMD's all-reduces between
//     the shards (kernels/mesh.py spec_eval_sharded; a fused round of
//     members on one mesh too), and, with the shards on separate cards,
//     B12b (spec_eval_cards_kernel below, kernels/mesh.py
//     spec_eval_cards).
//
// The kernel takes a table of sessions (common.cuh StepTable: one
// StepArgs each, nothing stacked); B2 and B10 are its one-session launch.
// One pod per thread-block cluster: the grid is K x B x R CTAs, cluster i
// is pod i % B of session i / B, and each CTA of a pod's cluster owns a
// node slice (slices.cuh: [r W, (r + 1) W), W = ceil(N / R), without a
// mesh; a ragged last slice, an empty one where N < R).  On a mesh of S
// "nodes" shards each shard is a group of G = R / S CTAs over its own
// N / S nodes, so the mesh is the same plan.  The per-pod body is pod.cuh's
// eval_pod under ClusterScope (scope.cuh): the spread minima, the node
// loop's statistics and the argmax are three combines, each one cluster
// barrier and one warp reading the R partials through distributed shared
// memory.  The pod's raw, feasibility and ignore rows of the slice stay in
// the CTA's dynamic shared memory (in its slot of its session's
// StepArgs.spill past the card's limit, as at S = 1 on a 5,000-node
// fleet).  Where the workload has them, NodeVolumeLimits walks the pod's
// own volumes against its slice's per-(node, driver) counts and
// VolumeBinding the pod's own candidate PVs, compacted as step_chunk
// compacts them (volumes.cuh).  Nothing writes the carry, so the clusters
// of a session share it.  Each CTA writes its slice of every [.., N]
// output; the cluster's leader writes the pod's scalars.  A CTA's state
// depends on its session's volume widths, so every member of a table
// takes the same bytes (kss_eval_plan refuses a mix).
//
// G comes from the launch's K x B clusters (kernels/spec.py eval_shards):
// the largest G of 1, 2, 4, 8, 16, R = S G <= 16, at which all of them are
// resident on the card at once (kss_eval_plan asks
// cudaOccupancyMaxActiveClusters of the table size that runs, once per
// card and per launch shape), else 1.  So a small batch (the contended
// round's 8 pods, the host path's 1, a contended pair of sessions' 2 x 8)
// spreads each pod over many SMs, and a large one (512 pods, or 2 x 512)
// keeps one CTA per pod, or one per shard on a mesh.
//
// The kernel has two CTA shapes, one body: the default (up to 512
// threads, about one a node, at most 128 registers: one CTA an SM) and the
// light one (up to 256 threads at most 85 registers: three CTAs an SM,
// their state in device memory where three CTAs' state does not fit in
// shared memory).  A launch whose clusters the card does not hold all at
// once in the default shape takes the light one where the card holds more
// of them that way (kernels/spec.py eval_light, from kss_eval_plan's
// occupancy of both shapes): past the resident clusters each CTA's three
// combines and barriers weigh on an SM that holds only one; three an SM
// overlap them.
//
// What bounds it on this card: the latency of one pod's dependent phases
// (the node loop, InterPod's 40 terms a node, three combines), as in
// step_chunk; the bytes (a few [N] rows a pod) are microseconds.  The
// cluster divides the node loop by R, and K x B x R CTAs fill the SMs a
// small batch left idle.
//
// Exactness: as step_chunk.  Integer math is int64 with floor division,
// the float64 paths are built with -fmad=false, and no float sum runs over
// the node axis, so the split gives the bytes of one CTA per pod, and each
// session's outputs are its solo launch's.  The round's conflict oracle
// (oracle.cu) runs after it on the same stream.
#include "cluster.cuh"

#define KSS_LIGHT_THREADS 256
#define KSS_LIGHT_CTAS 3

// The kernel's two CTA shapes, one body: the default (up to 512 threads,
// one CTA an SM at up to 128 registers) and the light one (up to 256
// threads, three CTAs an SM at up to 85 registers; its state in shared
// memory where three CTAs' state fits there, else in device memory).
template <int KM, bool LIGHT, bool W>
__global__ void __launch_bounds__(LIGHT ? KSS_LIGHT_THREADS : KSS_STEP_THREADS,
                                  LIGHT ? KSS_LIGHT_CTAS : 1)
    spec_eval_cluster_kernel(const __grid_constant__ StepTable<KM> t, int width,
                             int shards) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ PodShared sh;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), ctas = (int)cluster.num_blocks();
  const int i = (int)blockIdx.x / ctas;  // the cluster
  const int session = KM == 1 ? 0 : i / t.s[0].C;
  const StepArgs& a = t.s[session];
  const int c = i - session * a.C;
  const NodeSlice ns = node_slice(a.N, shards, ctas / shards, width, rank);
  const int lo = ns.lo, hi = ns.hi;
  const StepSmem m = step_smem(a, width, false);
  unsigned char* smem = a.spill != nullptr
      ? a.spill + (size_t)(blockIdx.x - session * a.C * ctas) * m.total : dyn;
  ClusterScope scope{lo, hi, rank, ctas,
                     PodRows{(long long*)(smem + m.raw), smem + m.feas, smem + m.ign, lo, width},
                     &sh, PodVolumes{}, 0};
  // the pod's volume lists and the slice's counts, before the node loop
  if (a.has_nvl && !a.nvl_filter_skip[c]) {
    int* count = (int*)(smem + m.count);
    int* vols = (int*)(smem + m.nvl);
    nvl_counts(a, lo, hi, count);
    scope.vols.nvl_count = count;
    scope.vols.count_lo = lo;
    scope.vols.nvl_vols = vols;
    scope.vols.nvl_n = nvl_compact(a, c, vols, sh.i);
  }
  if (a.has_vb) {
    int* pvs = (int*)(smem + m.vb_pvs);
    unsigned char* slots = smem + m.vb_slots;
    scope.vols.vb_pvs = pvs;
    scope.vols.vb_slots = slots;
    scope.vols.vb_n = vb_compact(a, c, pvs, slots, sh.i);
  }
  __syncthreads();
  eval_pod<W>(a, c, scope);
  // no CTA leaves while another may still read its slots
  cluster.sync();
}

// B12b (kernels/mesh.py spec_eval_cards): the dense eval over a card
// mesh.  Table entry e is a card of the mesh (card peer.card0 + e), its
// StepArgs the card's node slice and the pods of its "dp" row's group;
// each card holds `peer.slots` clusters of R CTAs, and slot q walks the
// pods q, q + slots, ...  The slot-q clusters of a row's cards combine
// through PeerScope (scope.cuh), so the launch's clusters spin on each
// other and kss_eval_cards_plan sizes `slots` so that the card holds
// every one of them at once.
template <bool W>
__global__ void __launch_bounds__(KSS_STEP_THREADS, 1)
    spec_eval_cards_kernel(const __grid_constant__ StepTable<KSS_MAX_CARDS> t, int width,
                           const __grid_constant__ PeerArgs peer) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ PodShared sh;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), ctas = (int)cluster.num_blocks();
  const int i = (int)blockIdx.x / ctas;  // the cluster
  const int e = i / peer.slots, slot = i - e * peer.slots;
  const StepArgs& a = t.s[e];
  const NodeSlice ns = node_slice(a.N, 1, ctas, width, rank);
  const int lo = ns.lo, hi = ns.hi;
  const StepSmem m = step_smem(a, width, false);
  unsigned char* smem =
      a.spill != nullptr ? a.spill + ((size_t)slot * ctas + rank) * m.total : dyn;
  PeerScope scope{ClusterScope{lo, hi, rank, ctas,
                               PodRows{(long long*)(smem + m.raw), smem + m.feas, smem + m.ign,
                                       lo, width},
                               &sh, PodVolumes{}, 0},
                  &peer, peer.card0 + e, slot, a.node_base, peer.epoch, false};
  int* count = (int*)(smem + m.count);
  if (a.has_nvl) nvl_counts(a, lo, hi, count);  // no bind: the slice's counts hold for every pod
  for (int c = slot; c < a.C; c += peer.slots) {
    scope.vols = PodVolumes{};
    if (a.has_nvl && !a.nvl_filter_skip[c]) {
      int* vols = (int*)(smem + m.nvl);
      scope.vols.nvl_count = count;
      scope.vols.count_lo = lo;
      scope.vols.nvl_vols = vols;
      scope.vols.nvl_n = nvl_compact(a, c, vols, sh.i);
    }
    if (a.has_vb) {
      int* pvs = (int*)(smem + m.vb_pvs);
      unsigned char* slots = smem + m.vb_slots;
      scope.vols.vb_pvs = pvs;
      scope.vols.vb_slots = slots;
      scope.vols.vb_n = vb_compact(a, c, pvs, slots, sh.i);
    }
    __syncthreads();
    eval_pod<W>(a, c, scope);
  }
  scope.finish();
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

#include <map>
#include <tuple>

#define KSS_EVAL_SIZES 5  // G = 1, 2, 4, 8, 16

// f(std::integral_constant<bool, light>): the kernel of either shape.
template <class F>
static int by_shape(int light, F&& f) {
  if (light) return f(std::integral_constant<bool, true>{});
  return f(std::integral_constant<bool, false>{});
}

extern "C" int kss_step_args_size() { return (int)sizeof(StepArgs); }

// cudaOccupancyMaxActiveClusters of the table size KM's kernel at plan p,
// asked once per card and per (KM, shape, W, R, CTA width, shared memory)
// for the process; a refused query counts as no room (0).
template <int KM, bool LIGHT, bool W>
static int eval_clusters(const ClusterPlan& p, int ctas, int dev) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, bool, int, int, size_t>, int> memo;
  const auto key =
      std::make_tuple(dev, KM, LIGHT, ctas, p.threads, p.spill ? (size_t)0 : p.bytes);
  std::lock_guard<std::mutex> lock(mu);
  auto it = memo.find(key);
  if (it == memo.end()) {
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg;
    cluster_config(p, 1, ctas, nullptr, attr, &cfg);
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, spec_eval_cluster_kernel<KM, LIGHT, W>, &cfg) !=
        cudaSuccess) {
      cudaGetLastError();
      clusters = 0;
    }
    it = memo.emplace(key, clusters).first;
  }
  return it->second;
}

// The members' CTA state at `ctas` CTAs a cluster over `shards` "nodes"
// shards, in the `light` shape or the default one: one plan for the
// table, refused (cudaErrorInvalidValue) where cluster_takes refuses the
// launch, or two members' state bytes differ (their volume widths:
// step_smem) or their batch or nodes do.
static cudaError_t table_plan(const StepArgs* table, int k, int ctas, int shards, bool light,
                              int max_dynamic, ClusterPlan* p) {
  if (!cluster_takes(table[0], ctas, shards)) return cudaErrorInvalidValue;
  *p = light ? cluster_plan(table[0], ctas, shards, max_dynamic / KSS_LIGHT_CTAS, false,
                            KSS_LIGHT_THREADS)
             : cluster_plan(table[0], ctas, shards, max_dynamic, false);
  for (int i = 1; i < k; ++i)
    if (table[i].C != table[0].C || table[i].N != table[0].N ||
        step_smem(table[i], p->width, false).total != p->bytes)
      return cudaErrorInvalidValue;
  return cudaSuccess;
}

// The plan of a launch over a table of k sessions and `shards` "nodes"
// shards, in the `light` CTA shape or the default one, at each G = 2^j,
// j < 5, R = S G: to clusters[j] how many clusters of R CTAs the card
// holds at once (0 past KSS_MAX_CTAS), to cta_spill[j] the device memory
// each CTA's state takes in its session's spill (0 where it stays in
// shared memory), to cta_masks[j] the bytes each CTA of the launch takes
// in vb_masks (common.cuh vb_mask_words).
extern "C" int kss_eval_plan(const StepArgs* table, int k, int shards, int light,
                             int* clusters, long long* cta_spill, long long* cta_masks) {
  if (k < 1 || k > KSS_MAX_TABLE || !cluster_takes(table[0], shards, shards))
    return (int)cudaErrorInvalidValue;
  return by_shape(light, [&](auto shape) {
    constexpr bool LIGHT = decltype(shape)::value;
    return by_wide(table, k, [&](auto wide) {
      constexpr bool W = decltype(wide)::value;
      return by_table_of<W>(k, [&](auto km) {
        constexpr int KM = decltype(km)::value;
        int max_dynamic = 0, dev = 0;
        cudaError_t err =
            cluster_attributes<spec_eval_cluster_kernel<KM, LIGHT, W>>(&max_dynamic);
        if (err == cudaSuccess) err = cudaGetDevice(&dev);
        for (int j = 0; j < KSS_EVAL_SIZES && err == cudaSuccess; ++j) {
          const int ctas = shards << j;
          clusters[j] = 0;
          cta_spill[j] = cta_masks[j] = 0;
          if (ctas > KSS_MAX_CTAS) continue;
          ClusterPlan p;
          err = table_plan(table, k, ctas, shards, LIGHT, max_dynamic, &p);
          clusters[j] = eval_clusters<KM, LIGHT, W>(p, ctas, dev);
          cta_spill[j] = p.spill ? (long long)p.bytes : 0;
          cta_masks[j] = vb_mask_words(table, k) * 8 * p.threads;
        }
        return (int)err;
      });
    });
  });
}

// Launches on the caller's stream; no synchronisation.  One cluster of
// `ctas` CTAs (1 to KSS_MAX_CTAS, whole groups of the `shards` "nodes"
// shards) of the `light` shape or the default one per pod of each of the
// k sessions, each session's spill set exactly where kss_eval_plan gave
// the state bytes of device memory (a slot per CTA of the session), and
// vb_masks where it gave mask bytes (one buffer of the launch's CTAs,
// every session's pointing at it).  Each returns the launch's error or
// cudaGetLastError(), so a refused launch is reported at once.
extern "C" int kss_spec_eval(const StepArgs* table, int k, int ctas, int shards, int light,
                             void* stream) {
  if (k < 1 || k > KSS_MAX_TABLE || table[0].C < 1 || vb_masks_missing(table, k))
    return (int)cudaErrorInvalidValue;
  return by_shape(light, [&](auto shape) {
    constexpr bool LIGHT = decltype(shape)::value;
    return by_wide(table, k, [&](auto wide) {
      constexpr bool W = decltype(wide)::value;
      return by_table_of<W>(k, [&](auto km) {
        constexpr int KM = decltype(km)::value;
        int max_dynamic = 0;
        cudaError_t err =
            cluster_attributes<spec_eval_cluster_kernel<KM, LIGHT, W>>(&max_dynamic);
        ClusterPlan p;
        if (err == cudaSuccess) err = table_plan(table, k, ctas, shards, LIGHT, max_dynamic, &p);
        if (err != cudaSuccess) return (int)err;
        for (int i = 0; i < k; ++i)
          if (p.spill != (table[i].spill != nullptr)) return (int)cudaErrorInvalidValue;
        cudaLaunchAttribute attr[1];
        cudaLaunchConfig_t cfg;
        cluster_config(p, k * table[0].C, ctas, (cudaStream_t)stream, attr, &cfg);
        return launch_result(cudaLaunchKernelEx(&cfg, spec_eval_cluster_kernel<KM, LIGHT, W>,
                                                make_table<KM>(table, k), p.width, shards));
      });
    });
  });
}

// B12b: the plan of an eval over the k cards of `table` on card `device`:
// R (`ctas` 0: the largest of 16, 8, 4, 2, 1, at most the card's nodes, at
// which the card holds a cluster for every pod of every entry, else 1) to
// *out_ctas; the pod slots a card (at most its pods, as many as the card
// holds k times over) to *slots; a CTA's spill bytes (0: shared memory)
// to *cta_spill; the launch's VolumeBinding mask bytes to *mask_bytes; and
// the clusters the card holds at once to *resident.
extern "C" int kss_eval_cards_plan(const StepArgs* table, int k, int ctas, int device,
                                   int* out_ctas, int* slots, long long* cta_spill,
                                   long long* mask_bytes, int* resident) {
  if (k < 1 || k > KSS_MAX_CARDS || table[0].C < 1) return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  return by_wide(table, k, [&](auto wide) {
    constexpr bool W = decltype(wide)::value;
    int max_dynamic = 0;
    const cudaError_t err = cluster_attributes<spec_eval_cards_kernel<W>>(&max_dynamic);
    if (err != cudaSuccess) return (int)err;
    if (ctas == 0) {
      ctas = 1;
      for (int r = KSS_MAX_CTAS; r > 1; r /= 2) {
        if (r > table[0].N) continue;
        const ClusterPlan p = cluster_plan(table[0], r, 1, max_dynamic, false);
        if (active_clusters<spec_eval_cards_kernel<W>>(p, r) >= k * table[0].C) {
          ctas = r;
          break;
        }
      }
    }
    if (!cluster_takes(table[0], ctas, 1)) return (int)cudaErrorInvalidValue;
    const ClusterPlan p = cluster_plan(table[0], ctas, 1, max_dynamic, false);
    if (!cards_alike(table, k, p.width, false)) return (int)cudaErrorInvalidValue;
    *resident = active_clusters<spec_eval_cards_kernel<W>>(p, ctas);
    const int per_card = *resident / k;
    *slots = per_card < table[0].C ? per_card : table[0].C;
    *out_ctas = ctas;
    *cta_spill = p.spill ? (long long)p.bytes : 0;
    *mask_bytes = vb_mask_words(table, k) * 8 * k * (*slots) * ctas * p.threads;
    return (int)cudaSuccess;
  });
}

// B12b: one launch of k x peer->slots clusters of `ctas` CTAs on `stream`
// of card `device`; KSS_ERR_RESIDENT where the card does not hold them all
// at once.
extern "C" int kss_eval_cards(const StepArgs* table, int k, int ctas, const PeerArgs* peer,
                              int device, void* stream) {
  if (k < 1 || k > KSS_MAX_CARDS || table[0].C < 1 || peer->slots < 1 ||
      !cluster_takes(table[0], ctas, 1) || vb_masks_missing(table, k))
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  return by_wide(table, k, [&](auto wide) {
    constexpr bool W = decltype(wide)::value;
    int max_dynamic = 0;
    const cudaError_t err = cluster_attributes<spec_eval_cards_kernel<W>>(&max_dynamic);
    if (err != cudaSuccess) return (int)err;
    const ClusterPlan p = cluster_plan(table[0], ctas, 1, max_dynamic, false);
    if (!cards_alike(table, k, p.width, false)) return (int)cudaErrorInvalidValue;
    for (int i = 0; i < k; ++i)
      if (p.spill != (table[i].spill != nullptr)) return (int)cudaErrorInvalidValue;
    if (active_clusters<spec_eval_cards_kernel<W>>(p, ctas) < k * peer->slots)
      return KSS_ERR_RESIDENT;
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg;
    cluster_config(p, k * peer->slots, ctas, (cudaStream_t)stream, attr, &cfg);
    return launch_result(cudaLaunchKernelEx(&cfg, spec_eval_cards_kernel<W>,
                                            make_table<KSS_MAX_CARDS>(table, k), p.width,
                                            *peer));
  });
}
#endif
