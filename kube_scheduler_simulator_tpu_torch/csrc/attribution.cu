// chunk_attribution: the per-chunk plugin work attribution of a replay
// chunk that stays on the card, written for Hopper (sm_90a).
//
// It replaces kube_scheduler_simulator_tpu/framework/replay.py:1217
// `_build_att_fn.fn` (run by `_DeviceAttribution.run`, :1338).  From one
// chunk's compact outputs (the packed first-fail words [C, N] and the raw
// score groups) it computes what ChunkAttribution folds, so the host never
// fetches the heavy arrays for attribution:
//
//   * per pod c < m (the chunk's real pods; pad rows contribute nothing):
//     the feasible-node count, the first-fail histogram rej_pp[f, c], and
//     each device score column's masked row sum in int64 (the pod scored:
//     fc[c] > 1, the scorer not PreScore-skipped; the node feasible);
//   * per pod, when a score column lives on the host, the feasibility
//     bit-packed little-endian into ceil(N/8) bytes (padded bits 0);
//   * per chunk: f_rejects[f] = sum_c rej_pp[f, c];
//     f_evaluated[f] = sum_c !fskip[f, c] * (feas_cnt[c] + sum_{f' >= f}
//     rej_pp[f', c]); s_evaluated[q] = sum_c [scored and not skipped] *
//     feas_cnt[c].
//
// The first-fail index is the FULL packed word shifted right by code_bits
// (unsigned loads for p8 and p16, the int64 word for p64), and the sums
// are int64 over the column's own dtype (int64 in the i64 tier), as the
// host tally ChunkAttribution._tally_chunk computes them.  (The JAX
// function casts the word and the raws to int32 first, which drops the
// first-fail index under p64 and wraps raws past int32.)  CUDA has native
// int64, so the base-2^11 limbs the JAX function ships are not needed.
//
// Two launches: att_pod_kernel, one block of ATT_THREADS per pod, each
// thread owning whole bytes of the node axis (8 consecutive nodes) and
// keeping its counts in registers, then warp shuffles and shared-memory
// atomics; att_total_kernel, one block over the chunk's pods.  Every
// value is an integer, so any reduction order gives the same bits.
//
// What bounds it on this card: bytes.  It reads the packed words and the
// device raw columns of one chunk once (tens of MB at 512 pods x 5,000
// nodes) and writes a few KB.
#include <cstdint>

#define ATT_THREADS 256
#define ATT_MAX_F 16  // KSS_MAX_F
#define ATT_MAX_Q 8   // KSS_MAX_S

// All 8-byte members first, then the 4-byte ones (kernels/attribution.py
// mirrors it as a ctypes.Structure).
struct AttArgs {
  const void* packed;           // [C, N], pack_bytes per word
  const signed char* raw8;      // [C, S8, N]
  const short* raw16;           // [C, S16, N]
  const void* raw32;            // [C, S32, N], raw32_bytes per value
  const int* fc;                // [C] feasible_count
  const unsigned char* fskip;   // [F, C] bool: the filter was PreFilter-skipped
  const unsigned char* sskip;   // [S, C] bool, by scorer index
  int* feas_cnt;                // [C]
  int* rej_pp;                  // [F, C]
  long long* s_sum;             // [C, Q]
  unsigned char* feas_packed;   // [C, NB], or null
  long long* f_rejects;         // [F]
  long long* f_evaluated;       // [F]
  long long* s_evaluated;       // [Q]
  int col_group[ATT_MAX_Q];     // per device column: 1 raw8, 2 raw16, 3 raw32
  int col_row[ATT_MAX_Q];       // its row in that group
  int col_scorer[ATT_MAX_Q];    // its scorer index (the sskip row)
  int c, n, m, f, q;
  int s8, s16, s32;
  int pack_bytes, code_bits, raw32_bytes, want_pack;
};

__device__ __forceinline__ long long first_fail(const AttArgs& a, long long i) {
  switch (a.pack_bytes) {
    case 1: return (long long)((const unsigned char*)a.packed)[i] >> a.code_bits;
    case 2: return (long long)((const unsigned short*)a.packed)[i] >> a.code_bits;
    case 4: return (long long)((const int*)a.packed)[i] >> a.code_bits;
    default: return ((const long long*)a.packed)[i] >> a.code_bits;
  }
}

__device__ __forceinline__ long long raw_at(const AttArgs& a, int q, int c, int node) {
  const long long r = a.col_row[q];
  switch (a.col_group[q]) {
    case 1: return a.raw8[((long long)c * a.s8 + r) * a.n + node];
    case 2: return a.raw16[((long long)c * a.s16 + r) * a.n + node];
    default: {
      const long long i = ((long long)c * a.s32 + r) * a.n + node;
      return a.raw32_bytes == 8 ? ((const long long*)a.raw32)[i]
                                : (long long)((const int*)a.raw32)[i];
    }
  }
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(ATT_THREADS) att_pod_kernel(const AttArgs a) {
  __shared__ int sh_feas;
  __shared__ int sh_rej[ATT_MAX_F];
  __shared__ long long sh_sum[ATT_MAX_Q];
  const int c = blockIdx.x;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) sh_feas = 0;
  if (threadIdx.x < ATT_MAX_F) sh_rej[threadIdx.x] = 0;
  if (threadIdx.x < ATT_MAX_Q) sh_sum[threadIdx.x] = 0;

  const bool valid = c < a.m;
  const bool scored = valid && a.fc[c] > 1;
  bool on[ATT_MAX_Q];
#pragma unroll
  for (int q = 0; q < ATT_MAX_Q; ++q)
    on[q] = q < a.q && scored && !a.sskip[(long long)a.col_scorer[q] * a.c + c];

  int feas = 0;
  int rej[ATT_MAX_F];
  long long sum[ATT_MAX_Q];
#pragma unroll
  for (int f = 0; f < ATT_MAX_F; ++f) rej[f] = 0;
#pragma unroll
  for (int q = 0; q < ATT_MAX_Q; ++q) sum[q] = 0;

  const int nb = (a.n + 7) / 8;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    unsigned bits = 0;
    if (valid) {
      for (int k = 0; k < 8; ++k) {
        const int node = b * 8 + k;
        if (node >= a.n) break;
        const long long ff = first_fail(a, (long long)c * a.n + node);
        if (ff == 0) {
          ++feas;
          bits |= 1u << k;
#pragma unroll
          for (int q = 0; q < ATT_MAX_Q; ++q)
            if (on[q]) sum[q] += raw_at(a, q, c, node);
        } else {
#pragma unroll
          for (int f = 0; f < ATT_MAX_F; ++f) rej[f] += ff == f + 1;
        }
      }
    }
    if (a.want_pack) a.feas_packed[(long long)c * nb + b] = (unsigned char)bits;
  }
  __syncthreads();  // the shared sums are zeroed

  feas = warp_sum(feas);
  if (lane == 0 && feas) atomicAdd(&sh_feas, feas);
#pragma unroll
  for (int f = 0; f < ATT_MAX_F; ++f) {
    const int r = warp_sum(rej[f]);
    if (lane == 0 && r) atomicAdd(&sh_rej[f], r);
  }
#pragma unroll
  for (int q = 0; q < ATT_MAX_Q; ++q) {
    const long long s = warp_sum(sum[q]);
    if (lane == 0 && s) atomicAdd((unsigned long long*)&sh_sum[q], (unsigned long long)s);
  }
  __syncthreads();

  if (threadIdx.x == 0) a.feas_cnt[c] = sh_feas;
  if (threadIdx.x < a.f) a.rej_pp[(long long)threadIdx.x * a.c + c] = sh_rej[threadIdx.x];
  if (threadIdx.x < a.q) a.s_sum[(long long)c * a.q + threadIdx.x] = sh_sum[threadIdx.x];
}

__global__ void __launch_bounds__(ATT_THREADS) att_total_kernel(const AttArgs a) {
  __shared__ long long sh_rej[ATT_MAX_F];
  __shared__ long long sh_ev[ATT_MAX_F];
  __shared__ long long sh_sev[ATT_MAX_Q];
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < ATT_MAX_F) sh_rej[threadIdx.x] = sh_ev[threadIdx.x] = 0;
  if (threadIdx.x < ATT_MAX_Q) sh_sev[threadIdx.x] = 0;

  long long rej[ATT_MAX_F], ev[ATT_MAX_F], sev[ATT_MAX_Q];
#pragma unroll
  for (int f = 0; f < ATT_MAX_F; ++f) rej[f] = ev[f] = 0;
#pragma unroll
  for (int q = 0; q < ATT_MAX_Q; ++q) sev[q] = 0;

  for (int c = threadIdx.x; c < a.m; c += blockDim.x) {
    const long long cnt = a.feas_cnt[c];
    long long suffix = 0;  // sum of rej_pp[f', c] over f' >= f
#pragma unroll
    for (int f = ATT_MAX_F - 1; f >= 0; --f) {
      if (f < a.f) {
        const long long r = a.rej_pp[(long long)f * a.c + c];
        suffix += r;
        rej[f] += r;
        if (!a.fskip[(long long)f * a.c + c]) ev[f] += cnt + suffix;
      }
    }
    const bool scored = a.fc[c] > 1;
#pragma unroll
    for (int q = 0; q < ATT_MAX_Q; ++q)
      if (q < a.q && scored && !a.sskip[(long long)a.col_scorer[q] * a.c + c]) sev[q] += cnt;
  }
  __syncthreads();  // the shared sums are zeroed

#pragma unroll
  for (int f = 0; f < ATT_MAX_F; ++f) {
    const long long r = warp_sum(rej[f]), e = warp_sum(ev[f]);
    if (lane == 0 && r) atomicAdd((unsigned long long*)&sh_rej[f], (unsigned long long)r);
    if (lane == 0 && e) atomicAdd((unsigned long long*)&sh_ev[f], (unsigned long long)e);
  }
#pragma unroll
  for (int q = 0; q < ATT_MAX_Q; ++q) {
    const long long s = warp_sum(sev[q]);
    if (lane == 0 && s) atomicAdd((unsigned long long*)&sh_sev[q], (unsigned long long)s);
  }
  __syncthreads();

  if (threadIdx.x < a.f) {
    a.f_rejects[threadIdx.x] = sh_rej[threadIdx.x];
    a.f_evaluated[threadIdx.x] = sh_ev[threadIdx.x];
  }
  if (threadIdx.x < a.q) a.s_evaluated[threadIdx.x] = sh_sev[threadIdx.x];
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

extern "C" int kss_att_args_size() { return (int)sizeof(AttArgs); }

// Both launches on the caller's stream, in order; no synchronisation.
// Returns cudaGetLastError() after each, so a refused launch is reported
// at once.
extern "C" int kss_chunk_attribution(const AttArgs* args, void* stream) {
  att_pod_kernel<<<args->c, ATT_THREADS, 0, (cudaStream_t)stream>>>(*args);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  att_total_kernel<<<1, ATT_THREADS, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
#endif
