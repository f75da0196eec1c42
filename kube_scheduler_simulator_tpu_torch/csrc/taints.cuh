// B1d (part): TaintToleration filter and score for one pod at one node;
// both are reads of the precompiled [P, N] int16 rows, and the reverse
// DefaultNormalizeScore is default_normalize(.., reverse=true).
// Counterparts: plugins/taints.py taint_filter :121, taint_score :125,
// taint_normalize :129 (line numbers in the JAX package).
#pragma once

#include "common.cuh"

__device__ __forceinline__ int taint_filter(const StepArgs& a, int c, int n) {
  return (int)a.taint_code[(long long)c * a.N + n];
}

__device__ __forceinline__ long long taint_score(const StepArgs& a, int c, int n) {
  return (long long)a.taint_prefer[(long long)c * a.N + n];
}
