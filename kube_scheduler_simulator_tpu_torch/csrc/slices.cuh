// The node slices of the cluster kernels (step_chunk's, step_kernel.cuh,
// and spec_eval_cluster, spec_eval.cu).
//
// A cluster of R CTAs serves S "nodes" shards (S = 1 without a mesh; B12's
// mesh passes its "nodes" extent), each a group of G = R / S CTAs.  Shard s
// owns [s V, (s + 1) V), V = ceil(N / S) (N / S on a mesh, which S
// divides: kernels/mesh.py node_slices), and CTA g of its group the
// sub-slice [g W, (g + 1) W) of it, W = ceil(V / G), clipped to the shard.
// CTA r = s G + g, so ranks ascend in node order, every slice lies inside
// one shard, a last sub-slice may be ragged and a sub-slice empty.  At
// S = 1 this is [r W, (r + 1) W) clipped to N, W = ceil(N / R).  The host
// sizes the CTA from W and passes W and S to the kernel, where each CTA
// computes its own slice.  kernels/spec.py cta_slices is the same
// function in Python.
#pragma once

#define KSS_MAX_CTAS 16  // CTAs a cluster

// W, the widest CTA slice's nodes (at least 1).
__host__ __device__ inline int slice_width(int n, int shards, int groups) {
  const int w = ((n + shards - 1) / shards + groups - 1) / groups;
  return w > 0 ? w : 1;
}

// CTA `rank`'s nodes [lo, hi), `width` = slice_width(n, shards, groups).
struct NodeSlice {
  int lo, hi;
};

__host__ __device__ inline NodeSlice node_slice(int n, int shards, int groups, int width,
                                                int rank) {
  const int v = (n + shards - 1) / shards, s = rank / groups;
  const int shard_hi = (s + 1) * v < n ? (s + 1) * v : n;
  const int lo = s * v + (rank - s * groups) * width;
  NodeSlice out;
  out.lo = lo < shard_hi ? lo : shard_hi;
  out.hi = lo + width < shard_hi ? lo + width : shard_hi;
  return out;
}
