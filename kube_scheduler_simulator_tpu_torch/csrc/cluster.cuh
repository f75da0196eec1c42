// The launch plan of the cluster kernels, which spread one pod's nodes
// over the R CTAs of a thread-block cluster: step_chunk's (step_kernel.cuh:
// a chunk's pods in order, each bound) and spec_eval_cluster (spec_eval.cu:
// one pod per cluster, no bind).  The CTAs serve S "nodes" shards, a group
// of R / S CTAs each (S = 1 without a mesh); CTA r owns slice r of
// slices.cuh (a last slice may be ragged and a slice empty, so any N is
// taken) and is about one thread per node of the widest slice.
#pragma once

#include "pod.cuh"
#include "slices.cuh"

#define KSS_STEP_THREADS 512  // the widest CTA; at most 128 registers a thread
#define KSS_MESH_MAX_SHARDS 8  // a mesh's "nodes" shards: a group each at R = 8 or 16

// The state of a CTA of `width` nodes: the pod's rows, NodeVolumeLimits'
// counts and pod list, VolumeBinding's candidates and, for a kernel that
// binds (`replicas`), the replicated cluster-wide carries, each 16-byte
// aligned.  It lives in dynamic shared memory where `total` fits there,
// else in the CTA's slot of a.spill in device memory (cluster_plan): the
// same layout, the same kernel.
struct StepSmem {
  size_t raw, feas, ign, count, nvl, vb_pvs, vb_slots, claimed, rwop, matched, total;
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

__host__ __device__ inline StepSmem step_smem(const StepArgs& a, int width, bool replicas) {
  StepSmem m;
  const size_t w = (size_t)width;
  size_t o = 0;
  m.raw = o;      o = align16(o + w * (size_t)(a.S > 0 ? a.S : 1) * 8);
  m.feas = o;     o = align16(o + w);
  m.ign = o;      o = align16(o + w);
  m.count = o;    if (a.has_nvl) o = align16(o + w * (size_t)a.VD * 4);
  m.nvl = o;      if (a.has_nvl) o = align16(o + (size_t)a.VC * 4);
  m.vb_pvs = o;   if (a.has_vb) o = align16(o + (size_t)a.VV * 4);
  m.vb_slots = o; if (a.has_vb) o = align16(o + (size_t)a.VV);
  m.claimed = o;  if (replicas && a.has_vb) o = align16(o + (size_t)a.VV);
  m.rwop = o;     if (replicas && a.has_vr) o = align16(o + (size_t)a.RR);
  m.matched = o;  if (replicas && a.has_interpod) o = align16(o + (size_t)a.T * 4);
  m.total = o;
  return m;
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>

#define KSS_MAX_DEVICES 64

// A kernel's function attributes, set once per card for the process:
// dynamic shared memory up to the card's opt-in maximum less the kernel's
// static shared memory and, for a cluster kernel (Clusters), non-portable
// clusters allowed.  A function attribute is one per process, so no
// launch changes it (two threads launching fleets of different widths
// cannot race on it).  -> the dynamic shared memory a launch may take, in
// *max_dynamic.
template <auto Kernel, bool Clusters = true>
static cudaError_t cluster_attributes(int* max_dynamic) {
  static std::once_flag once[KSS_MAX_DEVICES];
  static cudaError_t err[KSS_MAX_DEVICES];
  static int limit[KSS_MAX_DEVICES];
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= KSS_MAX_DEVICES) return cudaErrorInvalidDevice;
  std::call_once(once[dev], [dev] {
    int optin = 0;
    cudaFuncAttributes fa;
    cudaError_t r = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (r == cudaSuccess) r = cudaFuncGetAttributes(&fa, Kernel);
    if (r == cudaSuccess) {
      limit[dev] = optin - (int)fa.sharedSizeBytes;
      r = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit[dev]);
    }
    if (r == cudaSuccess && Clusters)
      r = cudaFuncSetAttribute(Kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    err[dev] = r;
  });
  *max_dynamic = limit[dev];
  return err[dev];
}

// One launch's shape at `ctas` CTAs a cluster over `shards` "nodes"
// shards: its CTA the widest slice's nodes (slices.cuh slice_width) in
// threads rounded up to a warp (at most `most`), its state step_smem's
// `bytes`, in shared memory unless that is more than `max_dynamic` (then
// `spill`: in device memory).
struct ClusterPlan {
  int width, threads;
  size_t bytes;
  bool spill;
};

static ClusterPlan cluster_plan(const StepArgs& a, int ctas, int shards, int max_dynamic,
                                bool replicas, int most = KSS_STEP_THREADS) {
  ClusterPlan p;
  p.width = slice_width(a.N, shards, ctas / shards);
  const int t = (p.width + 31) / 32 * 32;
  p.threads = t < 32 ? 32 : (t > most ? most : t);
  p.bytes = step_smem(a, p.width, replicas).total;
  p.spill = p.bytes > (size_t)max_dynamic;
  return p;
}

// The launch of `clusters` clusters of `ctas` CTAs each, at plan p.
static void cluster_config(const ClusterPlan& p, int clusters, int ctas, cudaStream_t stream,
                           cudaLaunchAttribute* attr, cudaLaunchConfig_t* cfg) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)(clusters * ctas), 1, 1);
  cfg->blockDim = dim3((unsigned)p.threads, 1, 1);
  cfg->dynamicSmemBytes = p.spill ? 0 : p.bytes;
  cfg->stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// Whether a launch of `ctas` CTAs a cluster serves `shards` "nodes"
// shards: 1 to KSS_MESH_MAX_SHARDS shards that divide N (a mesh's; any N
// at S = 1), each a group of the same number of CTAs.
static bool cluster_takes(const StepArgs& a, int ctas, int shards) {
  return ctas >= 1 && ctas <= KSS_MAX_CTAS && shards >= 1 && shards <= KSS_MESH_MAX_SHARDS &&
         ctas % shards == 0 && (shards == 1 || a.N % shards == 0);
}

// cudaOccupancyMaxActiveClusters of Kernel at `ctas` CTAs a cluster and
// plan p on the current card, asked once per card and per (R, CTA width,
// shared memory) for the process; a refused query counts as no room (0).
template <auto Kernel>
static int active_clusters(const ClusterPlan& p, int ctas) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, int, size_t>, int> memo;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  const auto key = std::make_tuple(dev, ctas, p.threads, p.spill ? (size_t)0 : p.bytes);
  std::lock_guard<std::mutex> lock(mu);
  auto it = memo.find(key);
  if (it == memo.end()) {
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg;
    cluster_config(p, 1, ctas, nullptr, attr, &cfg);
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, Kernel, &cfg) != cudaSuccess) {
      cudaGetLastError();
      clusters = 0;
    }
    it = memo.emplace(key, clusters).first;
  }
  return it->second;
}

// A B12b launch whose clusters the card does not hold all at once: they
// spin on each other, so kernels/mesh.py raises, naming the plan.
#define KSS_ERR_RESIDENT 1000

// The entries of a card launch's table share the batch, the node count
// and the CTA state's bytes at width w.
static bool cards_alike(const StepArgs* table, int k, int w, bool replicas) {
  for (int i = 1; i < k; ++i)
    if (table[i].C != table[0].C || table[i].N != table[0].N ||
        step_smem(table[i], w, replicas).total != step_smem(table[0], w, replicas).total)
      return false;
  return true;
}

// The launch's error, or cudaGetLastError() when it was accepted, so a
// refused launch is reported at once.
static int launch_result(cudaError_t err) {
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the return value reports it
    return (int)err;
  }
  return (int)cudaGetLastError();
}
#endif
