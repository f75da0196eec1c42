// step_chunk: the scheduling step of a chunk of pods, written for Hopper
// (sm_90a), with a pod's nodes spread over a thread-block cluster.
//
// It replaces kube_scheduler_simulator_tpu/framework/pipeline.py:378
// `build_step.step`, which the JAX package runs as a `lax.scan` over a
// chunk of pods (framework/replay.py:1130 `_scan_for`), and B12's
// parallel/mesh.py:130 `sharded_step` (the same step with the node axis
// sharded over the mesh's "nodes" extent; on separate cards B12b, below).  The TPU's sequential scan
// becomes a loop inside ONE cluster of R CTAs: the cluster walks the
// chunk's pods in queue order, and each CTA owns a contiguous node slice
// (slices.cuh: without a mesh [r W, (r + 1) W), W = ceil(N / R); on a
// mesh of S "nodes" shards, each shard's nodes split over a group of R / S
// CTAs; a last slice may be ragged and a slice empty, so any N is taken).
// A CTA is sized to the widest slice, about one thread per node.  R is 16
// where cudaOccupancyMaxActiveClusters finds room for a non-portable
// cluster of 16, else 8, in whole groups of the mesh's S <= 8
// (step_kernel.cuh step_auto_ctas).  So a mesh runs the unsharded plan:
// its shards only name which CTAs' slices are whose.
//
// Per pod (pod.cuh eval_pod, three combines of ClusterScope, scope.cuh):
//
//   0. the pod's NodeVolumeLimits volumes and VolumeBinding candidates
//      compacted into shared memory (volumes.cuh nvl_compact, vb_compact);
//   1. the pre-pass: every checked spread slot's minimum, one combine;
//   2. one node loop: filters in config order, raw scores, the node
//      statistics (feasible count, raw overflow, the normalizers' min, max
//      and any), one combine;
//   3. normalize x weight, total, local argmax, one argmax combine;
//   4. the bind (pod.cuh bind_pod), then a block barrier.
//
// The bind needs no cluster barrier.  The cluster-wide carries (InterPod's
// matched_total, the ReadWriteOncePod bits, VolumeBinding's claims) are
// replicated in every CTA's shared memory: every CTA applies the same
// increments from (pod, selected), and rank 0 writes them back once, at
// the end of the launch.  Every other carry row a pod reads at node n is
// read only by the CTA that owns n: Fit's requested / nonzero / num_pods,
// NodePorts' bits, VolumeRestrictions' disk rows, NodeVolumeLimits' bitmap
// row and the slice's per-(node, driver) counts, the spread counts and the
// InterPod matrices of the node; the spread minima and the argmax read
// other slices only through the combines, after the cluster barrier of the
// pod.  The owner of `selected` makes the exactly-once row updates there
// (core, NodePorts, disk and CSI rows); each CTA updates its slice of the
// spread counts and the InterPod matrices.  So a block barrier orders a
// bind before the next pod's reads.
//
// A pod a PreFilter rejected (VolumeRestrictions' ReadWriteOncePod
// conflict, or a compile-time reject) still writes its filter and score
// outputs, with feasible_count 0, and selects -1.
//
// What bounds it on this card: per-pod latency.  The bytes a pod touches
// (a few rows of [N] per plugin plus the compact outputs) are small
// against the card's bandwidth; the time is the chain of the node loop
// over a CTA's slice, three cluster barriers and the bind, pod after pod.
// The design spreads the node work over R SMs, keeps the raw scores in
// shared memory (in device memory only past about 227 KB a CTA, where
// kss_step_plan gives each CTA a slot of StepArgs.spill: at R = 16 and
// eight scorers, fleets past roughly 45,000 nodes), makes every reduction of a
// pod one of three vector combines (one warp reads the R partials through
// distributed shared memory and broadcasts them through the block's own),
// and walks only a pod's own volumes and candidate PVs.
//
// B12b: the "nodes" shards of a mesh on separate cards (kernels/mesh.py
// step_chunk_cards; JAX parallel/mesh.py:130 with the shards on separate
// devices).  step_kernel.cuh step_cards_kernel is the same body under
// PeerScope (scope.cuh): each card runs the chunk on one cluster of R
// CTAs over its own node slice (its StepArgs: N the card's nodes,
// node_base its first), and each of a pod's three combines ends inside
// the card, then across the cards of its "dp" row through their
// exchange buffers, folded in card order.  Across distinct cards it is one
// launch a card, all issued before any is awaited; on virtual cards one
// launch of a cluster a card, which the card must hold at once
// (kss_step_cards_plan: the largest R at which
// cudaOccupancyMaxActiveClusters admits every card).  The bind is
// bind_pod's: the owner card (it owns `selected`) makes the exactly-once
// row updates; every card applies the replicated increments (InterPod's
// matched_total, the ReadWriteOncePod bits, VolumeBinding's claims) to
// its own replicas; each card updates its slice of the spread counts and
// the InterPod matrices.  Those read rows of the selected node that a
// card need not own: its spread and InterPod domains (sp_dom_idx,
// ip_dom_idx) and, for the claims, VolumeBinding's PV and provision rows
// at it.  These tables stay whole on every card (common.cuh whole_at)
// rather than travelling in the argmax exchange: they are static (the
// provision rows are the pod's own), a few int32 or byte rows of N, and
// the node loop reads them at its own nodes anyway; publishing them would
// make the argmax entry as wide as the workload's groups and terms, every
// pod.  So no exchange follows the argmax, and the bind needs no barrier
// across cards, as it needs none across CTAs.
//
// The phase clock (-DKSS_PHASE_CLOCK, the "step_clock" build of
// kernels/build.py) has rank 0's thread 0 stamp each phase of each pod
// (common.cuh KSS_CLOCK_SLOTS); every other build compiles it out.
//
// Exactness: integer math is int64 as in the reference, with floor
// division where jnp floors (common.cuh floordiv); the float64 paths
// (balanced allocation, the spread weighted sum, the InterPod
// normalization) are built with -fmad=false so no multiply-add contracts;
// no float sum runs over the node axis, so the slicing changes no bit.
#include "step_kernel.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>

#include <cstring>

extern "C" int kss_step_args_size() { return (int)sizeof(StepArgs); }

// Launch on the caller's stream; no synchronisation.  `ctas` and a.spill
// as kss_step_plan (step_kernel.cuh) gave them for the `shards` "nodes"
// shards (1 without a mesh; 1 to KSS_MESH_MAX_SHARDS that divide N).
// Returns the launch's error or cudaGetLastError(), so a refused launch is
// reported at once.
extern "C" int kss_step_chunk(const StepArgs* args, int ctas, int shards, void* stream) {
  return launch_step_cluster(args, ctas, shards, stream);
}

extern "C" int kss_mesh_max_shards() { return KSS_MESH_MAX_SHARDS; }

// B12b: one launch of the step over k cards of a card mesh (step_kernel.cuh
// launch_step_cards) on `stream` of card `device`.
extern "C" int kss_step_cards(const StepArgs* table, int k, int ctas, const PeerArgs* peer,
                              int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return launch_step_cards(table, k, ctas, peer, stream);
}

extern "C" int kss_peer_args_size() { return (int)sizeof(PeerArgs); }

// Card `device` may read and write card `peer`'s memory (once per pair a
// process; an access already enabled is no error).
extern "C" int kss_enable_peer(int device, int peer) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    err = cudaSuccess;
  }
  return (int)err;
}

// B12c: a card mesh across the processes of one host.  Each process
// allocates the exchange buffers of its own cards here, with cudaMalloc
// and zeroed, and exports an IPC handle of each (64 bytes); every other
// process of the mesh opens it, so a launch's PeerArgs.xbuf holds local
// and opened pointers alike and scope.cuh PeerScope runs unchanged.  A
// handle names a whole allocation: a tensor of PyTorch's caching
// allocator sits at an offset inside a larger block, so the buffers are
// allocations of their own.  Two processes may name the same card: each
// is a context with memory of its own, and a handle opens on the card it
// came from.  `opened` handles are closed (kss_ipc_close with opened = 1)
// before the exporting process frees its buffer (opened = 0).
static_assert(sizeof(cudaIpcMemHandle_t) == 64, "kernels/mesh.py IPC_HANDLE_BYTES");

extern "C" int kss_ipc_export(int device, long long bytes, void** ptr, void* handle) {
  *ptr = nullptr;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaMalloc(ptr, (size_t)bytes);
  if (err == cudaSuccess) err = cudaMemset(*ptr, 0, (size_t)bytes);
  // the zeros are in place before a peer can open the buffer
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  cudaIpcMemHandle_t h;
  if (err == cudaSuccess) err = cudaIpcGetMemHandle(&h, *ptr);
  if (err == cudaSuccess) memcpy(handle, &h, sizeof(h));
  return (int)err;
}

extern "C" int kss_ipc_open(int device, const void* handle, void** ptr) {
  *ptr = nullptr;
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
  return (int)err;
}

extern "C" int kss_ipc_close(int device, void* ptr, int opened) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = opened ? cudaIpcCloseMemHandle(ptr) : cudaFree(ptr);
  return (int)err;
}

// B12c across hosts: a card mesh whose processes span hosts has no peer
// memory, so each process keeps its card's exchange buffer (the inbox)
// and an outbox for each other card of its row in page-locked host
// memory mapped into its card: `*host` the CPU's address, `*dev` the
// card's, zeroed before any launch.  A launch's PeerArgs.xbuf holds the
// card's addresses, so scope.cuh PeerScope runs unchanged: its
// st.release.sys and ld.acquire.sys order the values and the epoch
// across PCIe as they do across NVLink, and the host relay (relay.cpp)
// carries the outboxes' entries to the other processes' inboxes.  Both
// calls may synchronise the device: kernels/mesh.py Exchange makes every
// buffer when it is made and frees them after the last launch.
extern "C" int kss_mapped_alloc(int device, long long bytes, void** host, void** dev) {
  *host = *dev = nullptr;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaHostAlloc(host, (size_t)bytes, cudaHostAllocMapped | cudaHostAllocPortable);
  if (err == cudaSuccess) {
    memset(*host, 0, (size_t)bytes);
    err = cudaHostGetDevicePointer(dev, *host, 0);
  }
  return (int)err;
}

extern "C" int kss_mapped_free(void* host) { return (int)cudaFreeHost(host); }
#endif
