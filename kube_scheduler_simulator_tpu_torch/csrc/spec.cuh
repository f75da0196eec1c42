// The per-block body of the conflict oracle, shared by the solo kernel
// (spec_eval.cu spec_oracle) and its fused, cross-session form (fuse.cu):
// the body reads only the pointers it is given, so a fused launch that
// hands each session's block that session's batch computes, block for
// block, what the session's solo launch computes.
#pragma once

#include "pod.cuh"

#define SPEC_THREADS 256

__device__ __forceinline__ long long packed_at(const void* packed, int pack_bytes, long long i) {
  switch (pack_bytes) {
    case 1: return ((const unsigned char*)packed)[i];
    case 2: return ((const unsigned short*)packed)[i];
    case 4: return ((const int*)packed)[i];
    default: return ((const long long*)packed)[i];
  }
}

// spec_oracle_block replaces speculative.py:299 `_oracle_core`, the
// dirty-node prefix: pod k conflicts when it is feasible (packed word 0,
// no PreFilter reject) at the node an earlier pod j < k selected; K is
// the lowest conflicting k, or B.  One block; thread k walks j < k.
__device__ void spec_oracle_block(const void* packed, int pack_bytes, const int* reject,
                                  const int* selected, int B, int N, int* out_k, int& sh_k) {
  if (threadIdx.x == 0) sh_k = B;
  __syncthreads();
  for (int k = threadIdx.x; k < B; k += blockDim.x) {
    if (reject[k] != 0) continue;  // feasible nowhere: never conflicts
    const long long row = (long long)k * N;
    for (int j = 0; j < k; ++j) {
      const int s = selected[j];
      if (s >= 0 && packed_at(packed, pack_bytes, row + s) == 0) {
        atomicMin(&sh_k, k);
        break;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) *out_k = sh_k;
}
