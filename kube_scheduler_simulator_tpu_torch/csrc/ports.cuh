// B9b: NodePorts filter and bind for one pod.  Counterparts:
// plugins/ports.py filter_kernel :152 and bind_update :161 (line numbers
// in the JAX package).
//
// The carry is three per-node bit sets: used_any[q] and used_wild[q] per
// (protocol, port) slot, used_spec[s] per specific-IP slot.  A pod
// conflicts at node n when it wants a wildcard q that any pod there uses,
// or a specific s whose triple or whose (protocol, port) on 0.0.0.0 is
// used there (the JAX `used_wild[:, sq]` gather is used_wild[n * Q +
// sq[s]]).  Q and QS are a few dozen: a loop per node.
#pragma once

#include "common.cuh"

__device__ int ports_filter(const StepArgs& a, int c, int n) {
  const unsigned char* w_wild = a.np_w_wild + (long long)c * a.Q;
  const unsigned char* used_any = a.np_used_any + (long long)n * a.Q;
  for (int q = 0; q < a.Q; ++q)
    if (w_wild[q] && used_any[q]) return 1;
  const unsigned char* w_spec = a.np_w_spec + (long long)c * a.QS;
  const unsigned char* used_spec = a.np_used_spec + (long long)n * a.QS;
  const unsigned char* used_wild = a.np_used_wild + (long long)n * a.Q;
  for (int s = 0; s < a.QS; ++s)
    if (w_spec[s] && (used_spec[s] || used_wild[a.np_sq[s]])) return 1;
  return 0;
}

// The pod's ports marked used on the selected node (only called with
// sel >= 0); every thread of the block calls it.
__device__ void ports_bind(const StepArgs& a, int c, int sel) {
  for (int q = threadIdx.x; q < a.Q; q += blockDim.x) {
    const long long cq = (long long)c * a.Q + q, nq = (long long)sel * a.Q + q;
    if (a.np_w_any[cq]) a.np_used_any[nq] = 1;
    if (a.np_w_wild[cq]) a.np_used_wild[nq] = 1;
  }
  for (int s = threadIdx.x; s < a.QS; s += blockDim.x)
    if (a.np_w_spec[(long long)c * a.QS + s]) a.np_used_spec[(long long)sel * a.QS + s] = 1;
}
