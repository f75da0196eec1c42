// The cluster kernel of the scheduling step, shared by step_chunk
// (step.cu, which documents it) and B12's step_chunk_sharded (mesh.cu):
// one kernel, S a parameter of its launch.  Its launch plan (the node
// slices, the CTA's width and state) is cluster.cuh's.
#pragma once

#include "cluster.cuh"

__global__ void __launch_bounds__(KSS_STEP_THREADS, 1)
    step_chunk_kernel(const __grid_constant__ StepArgs a, int width) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ PodShared sh;
  __shared__ StepArgs b;  // a, with the cluster-wide carries at this CTA's replicas
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), shards = (int)cluster.num_blocks();
  const int lo = min(rank * width, a.N), hi = min(lo + width, a.N);
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
// The cluster size step_chunk takes when not told: 16 where a
// non-portable cluster of 16 CTAs fits on the card, else 8.
static int step_auto_shards(const StepArgs& a, int max_dynamic) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  int clusters = 0;
  cluster_config(cluster_plan(a, KSS_MAX_SHARDS, max_dynamic, true), 1, KSS_MAX_SHARDS, nullptr,
                 attr, &cfg);
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
// step_smem's total (cluster.cuh).
extern "C" int kss_step_plan(const StepArgs* args, int shards, int* out_shards,
                             long long* spill_bytes) {
  if (shards < 0 || shards > KSS_MAX_SHARDS) return (int)cudaErrorInvalidValue;
  int max_dynamic = 0;
  const cudaError_t err = cluster_attributes<step_chunk_kernel>(&max_dynamic);
  if (err != cudaSuccess) return (int)err;
  if (shards == 0) shards = step_auto_shards(*args, max_dynamic);
  const ClusterPlan p = cluster_plan(*args, shards, max_dynamic, true);
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
  cudaError_t err = cluster_attributes<step_chunk_kernel>(&max_dynamic);
  if (err != cudaSuccess) return (int)err;
  const ClusterPlan p = cluster_plan(*args, shards, max_dynamic, true);
  if (p.spill != (args->spill != nullptr)) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  cluster_config(p, 1, shards, (cudaStream_t)stream, attr, &cfg);
  return launch_result(cudaLaunchKernelEx(&cfg, step_chunk_kernel, *args, p.width));
}
#endif
