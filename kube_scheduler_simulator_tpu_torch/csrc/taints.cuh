// B1d (part) and B9a: TaintToleration filter and score, NodeUnschedulable
// and NodeName filters, for one pod at one node; all are reads of the
// precompiled [P, N] rows, and TaintToleration's reverse
// DefaultNormalizeScore is default_normalize(.., reverse=true).
// Counterparts: plugins/taints.py taint_filter :121, taint_score :125,
// taint_normalize :129, unsched_filter :139, nodename_filter :143 (line
// numbers in the JAX package).
#pragma once

#include "common.cuh"

__device__ __forceinline__ int taint_filter(const StepArgs& a, int c, int n) {
  return (int)a.taint_code[(long long)c * a.N + n];
}

__device__ __forceinline__ long long taint_score(const StepArgs& a, int c, int n) {
  return (long long)a.taint_prefer[(long long)c * a.N + n];
}

__device__ __forceinline__ int unsched_filter(const StepArgs& a, int c, int n) {
  return a.unsched_fail[(long long)c * a.N + n] ? 1 : 0;
}

__device__ __forceinline__ int nodename_filter(const StepArgs& a, int c, int n) {
  return a.nodename_fail[(long long)c * a.N + n] ? 1 : 0;
}
