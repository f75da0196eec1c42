// The cluster kernel of the scheduling step, shared by step_chunk
// (step.cu, which documents it) and B12's step_chunk_sharded (mesh.cu):
// one kernel, S a parameter of its launch.
#pragma once

#include "pod.cuh"

#define KSS_STEP_THREADS 512  // the widest CTA; at most 128 registers a thread
#define KSS_MAX_SHARDS 16

// The state of a CTA of `width` nodes: the pod's rows, NodeVolumeLimits'
// counts and pod list, VolumeBinding's candidates, and the replicated
// cluster-wide carries, each 16-byte aligned.  It lives in dynamic shared
// memory where `total` fits there, else in the CTA's slot of a.spill in
// device memory (step_plan): the same layout, the same kernel.
struct StepSmem {
  size_t raw, feas, ign, count, nvl, vb_pvs, vb_slots, claimed, rwop, matched, total;
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

__host__ __device__ inline StepSmem step_smem(const StepArgs& a, int width) {
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
  m.claimed = o;  if (a.has_vb) o = align16(o + (size_t)a.VV);
  m.rwop = o;     if (a.has_vr) o = align16(o + (size_t)a.RR);
  m.matched = o;  if (a.has_interpod) o = align16(o + (size_t)a.T * 4);
  m.total = o;
  return m;
}

__global__ void __launch_bounds__(KSS_STEP_THREADS, 1)
    step_chunk_kernel(const __grid_constant__ StepArgs a, int width) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ PodShared sh;
  __shared__ StepArgs b;  // a, with the cluster-wide carries at this CTA's replicas
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), shards = (int)cluster.num_blocks();
  const int lo = min(rank * width, a.N), hi = min(lo + width, a.N);
  const StepSmem m = step_smem(a, width);
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
  ClusterScope scope{lo, hi, rank, shards,
                     PodRows{(long long*)(smem + m.raw), smem + m.feas, smem + m.ign, lo, width},
                     &sh, PodVolumes{}, 0};
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
    const int sel = eval_pod(b, c, scope);

    // ---- 4. the bind.  Every read of the carry for this pod happened
    // before the argmax's cluster barrier; a rejected or padded pod binds
    // nothing.
    KSS_CLOCK(const unsigned long long tb = kss_now();)
    bind_pod(b, c, sel, lo, hi, scope.owns(sel), true, scope.vols);
    __syncthreads();  // the next pod reads the rows and replicas this one wrote
    KSS_CLOCK(if (ck) {
      const unsigned long long dt = kss_now() - tb;
      ck[CK_BIND] += dt;
      if (a.has_vb && a.VK > 0) ck[CK_VB] += dt;  // vb_bind's walk is most of it
    })
  }
  // no CTA leaves while another may still read its slots
  cluster.sync();
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

#ifdef __CUDACC__
#include <cuda_runtime.h>

#include <mutex>

#define KSS_MAX_DEVICES 64

// The kernel's function attributes, set once per card for the process:
// non-portable clusters allowed, and dynamic shared memory up to the
// card's opt-in maximum less the kernel's static shared memory.  A
// function attribute is one per process, so no launch changes it (two
// threads launching fleets of different widths cannot race on it).
// -> the dynamic shared memory a launch may take, in *max_dynamic.
static cudaError_t step_attributes(int* max_dynamic) {
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
    if (r == cudaSuccess) r = cudaFuncGetAttributes(&fa, step_chunk_kernel);
    if (r == cudaSuccess) {
      limit[dev] = optin - (int)fa.sharedSizeBytes;
      r = cudaFuncSetAttribute(step_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               limit[dev]);
    }
    if (r == cudaSuccess)
      r = cudaFuncSetAttribute(step_chunk_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    err[dev] = r;
  });
  *max_dynamic = limit[dev];
  return err[dev];
}

// One launch's shape at `shards` CTAs: each slice ceil(N / shards) nodes
// wide, its CTA that many threads rounded up to a warp (at most
// KSS_STEP_THREADS), its state step_smem's `bytes`, in shared memory
// unless that is more than `max_dynamic` (then `spill`: in device memory).
struct StepPlan {
  int width, threads;
  size_t bytes;
  bool spill;
};

static StepPlan step_plan(const StepArgs& a, int shards, int max_dynamic) {
  StepPlan p;
  p.width = a.N > 0 ? (a.N + shards - 1) / shards : 1;
  const int t = (p.width + 31) / 32 * 32;
  p.threads = t < 32 ? 32 : (t > KSS_STEP_THREADS ? KSS_STEP_THREADS : t);
  p.bytes = step_smem(a, p.width).total;
  p.spill = p.bytes > (size_t)max_dynamic;
  return p;
}

static void step_config(const StepPlan& p, int shards, cudaStream_t stream,
                        cudaLaunchAttribute* attr, cudaLaunchConfig_t* cfg) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)shards, 1, 1);
  cfg->blockDim = dim3((unsigned)p.threads, 1, 1);
  cfg->dynamicSmemBytes = p.spill ? 0 : p.bytes;
  cfg->stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)shards;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// The cluster size step_chunk takes when not told: 16 where a
// non-portable cluster of 16 CTAs fits on the card, else 8.
static int step_auto_shards(const StepArgs& a, int max_dynamic) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  int clusters = 0;
  step_config(step_plan(a, KSS_MAX_SHARDS, max_dynamic), KSS_MAX_SHARDS, nullptr, attr, &cfg);
  if (cudaOccupancyMaxActiveClusters(&clusters, step_chunk_kernel, &cfg) == cudaSuccess &&
      clusters >= 1)
    return KSS_MAX_SHARDS;
  cudaGetLastError();  // a refused query only means 8
  return 8;
}

// The plan of a launch, before it: the cluster size (`shards` 0 picks it,
// step_auto_shards; 1 to KSS_MAX_SHARDS is taken as it is) to
// *out_shards, and to *spill_bytes the device memory the launch needs in
// a.spill: 0 where each CTA's state fits in shared memory, else S times
// step_smem's total.
extern "C" int kss_step_plan(const StepArgs* args, int shards, int* out_shards,
                             long long* spill_bytes) {
  if (shards < 0 || shards > KSS_MAX_SHARDS) return (int)cudaErrorInvalidValue;
  int max_dynamic = 0;
  const cudaError_t err = step_attributes(&max_dynamic);
  if (err != cudaSuccess) return (int)err;
  if (shards == 0) shards = step_auto_shards(*args, max_dynamic);
  const StepPlan p = step_plan(*args, shards, max_dynamic);
  *out_shards = shards;
  *spill_bytes = p.spill ? (long long)p.bytes * shards : 0;
  return (int)cudaSuccess;
}

// One launch of a cluster of `shards` CTAs on `stream`, its state where
// kss_step_plan put it (a.spill set exactly where the plan asked for it).
// Returns the launch's error or cudaGetLastError(), so a refused launch
// is reported at once.
static int launch_step_cluster(const StepArgs* args, int shards, void* stream) {
  int max_dynamic = 0;
  cudaError_t err = step_attributes(&max_dynamic);
  if (err != cudaSuccess) return (int)err;
  const StepPlan p = step_plan(*args, shards, max_dynamic);
  if (p.spill != (args->spill != nullptr)) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  step_config(p, shards, (cudaStream_t)stream, attr, &cfg);
  err = cudaLaunchKernelEx(&cfg, step_chunk_kernel, *args, p.width);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the return value reports it
    return (int)err;
  }
  return (int)cudaGetLastError();
}
#endif
