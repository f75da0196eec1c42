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
//     the feasible-node count, the first-fail histogram rej[f], and each
//     device score column's masked row sum in int64 (the pod scored:
//     fc[c] > 1, the scorer not PreScore-skipped; the node feasible);
//   * per pod, when a score column lives on the host, the feasibility
//     bit-packed little-endian into ceil(N/8) bytes (padded bits 0);
//   * per chunk: f_rejects[f] = sum_c rej[f, c]; f_evaluated[f] = sum_c
//     !fskip[f, c] * (feas[c] + sum_{f' >= f} rej[f', c]); s_evaluated[q]
//     = sum_c [scored and not skipped] * feas[c].
//
// The first-fail index is the FULL packed word shifted right by code_bits
// (unsigned loads for p8 and p16, the int64 word for p64), and the sums
// are int64 over the column's own dtype (int64 in the i64 tier), as the
// host tally ChunkAttribution._tally_chunk computes them.  (The JAX
// function casts the word and the raws to int32 first, which drops the
// first-fail index under p64 and wraps raws past int32.)  CUDA has native
// int64, so the base-2^11 limbs the JAX function ships are not needed.
//
// What bounds it on this card: bytes, and a launch's fixed cost.  It
// reads the chunk's packed words once and each scored device column's
// raws at feasible nodes (the bound counts about 11 MB at config 5's 512
// pods x 5,000 nodes; read in whole 32-byte sectors that is about 16 MB)
// and writes a few KB: a few microseconds at 3.35 TB/s, about what the
// launch, the memset node that zeroes the totals and the CTAs' barriers
// cost by themselves (PERF.md §6: the all-pad chunk).  So the design
// keeps the serial chain of each pod short and many loads in flight:
//
//   * one launch: a pod is W warps (`warps`), a CTA P pods (`pods`),
//     chosen on the host (kernels/attribution.py att_shape) so that about
//     2,000 warps run at once; each lane keeps 4 (packed pass) or 8 (raw
//     pass) 16-byte loads in flight, contiguous across the warp (512
//     bytes a warp instruction);
//   * the pod's flags (fc, the columns' score skips, the filters'
//     PreFilter skips) are loaded once at the start, while the packed
//     pass runs, and kept as bit masks in shared memory;
//   * the kernel is a template of the pack word (p8/p16/p32/p64), so a
//     vector's words are decoded without a branch; the first-fail
//     histogram loops over the chunk's F filters only;
//   * the feasibility goes to a bitmap of the pod in shared memory (a
//     word a group of lanes, OR-combined by shuffles); the bitmap's bytes
//     are the output bitmap, and the raw pass reads it;
//   * each score column is resolved once a pod (base pointer and element
//     width), and its raws are read with 16-byte loads only where the
//     vector holds a feasible node, summed in int64;
//   * counts are reduced per warp by one redux instruction, per pod over
//     its warps in shared memory, per CTA by shared atomics, and the chunk
//     totals by one int64 atomic a total a CTA into the call's own output,
//     which the launch function zeroes on the caller's stream just before
//     the kernel: nothing outlives a launch or is shared between streams,
//     and every value is an integer, so any order gives the same bits.
#include <climits>
#include <cstdint>

#define ATT_MAX_F 16     // KSS_MAX_F
#define ATT_MAX_Q 8      // device score columns a chunk
#define ATT_MAX_WARPS 8  // a CTA: pods x warps a pod
#define ATT_UNROLL 4     // 16-byte loads a lane keeps in flight, packed pass
#define ATT_RAW_UNROLL 8 // the same, raw pass
#define ATT_TOTALS (2 * ATT_MAX_F + ATT_MAX_Q)
#define ATT_SMEM (48 * 1024)          // dynamic shared memory without the opt-in
#define ATT_SMEM_MAX (225 * 1024)     // one pod's bitmap, opt-in (kernels/attribution.py)

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
  long long* s_sum;             // [C, Q]
  unsigned char* feas_packed;   // [C, NB], or null
  long long* totals;            // [2F + Q]: f_rejects, f_evaluated, s_evaluated
  unsigned* bits;               // [grid x pods, ceil(N / 32)]: the bitmaps, or null (shared)
  const int* cols;              // [3, Q]: group, row, scorer (the wide kernel), or null
  int col_group[ATT_MAX_Q];     // per device column: 1 raw8, 2 raw16, 3 raw32
  int col_row[ATT_MAX_Q];       // its row in that group
  int col_scorer[ATT_MAX_Q];    // its scorer index (the sskip row)
  int c, n, m, f, q;
  int s8, s16, s32;
  int pack_bytes, code_bits, raw32_bytes, want_pack;
  int warps, pods;              // a pod's warps, a CTA's pods
};

__device__ __forceinline__ int first_fail(unsigned char w, int cb) { return (int)w >> cb; }
__device__ __forceinline__ int first_fail(unsigned short w, int cb) { return (int)w >> cb; }
__device__ __forceinline__ int first_fail(int w, int cb) { return w >> cb; }
__device__ __forceinline__ int first_fail(long long w, int cb) {
  const long long x = w >> cb;
  return x == (long long)(int)x ? (int)x : INT_MIN;  // past int32: neither feasible nor a filter
}

// Elements of size `e` before the first 16-byte boundary of row p (at
// most n).
__device__ __forceinline__ int head_of(const void* p, int e, int n) {
  const int h = (int)(((16 - ((uintptr_t)p & 15)) & 15) / e);
  return h < n ? h : n;
}

// The pod's feasibility bits of nodes [j, j + v) (v <= 16), low bit first.
__device__ __forceinline__ unsigned bits_at(const unsigned* bm, int j, int v) {
  const int w = j >> 5, o = j & 31;
  unsigned x = bm[w] >> o;
  if (o + v > 32) x |= bm[w + 1] << (32 - o);
  return x & ((1u << v) - 1);
}

// Column q's raw row of pod c, and its element width es.
__device__ __forceinline__ const unsigned char* raw_row(const AttArgs& a, int q, int c, int& es) {
  const long long r = a.col_row[q];
  switch (a.col_group[q]) {
    case 1:
      es = 1;
      return reinterpret_cast<const unsigned char*>(a.raw8 + ((long long)c * a.s8 + r) * a.n);
    case 2:
      es = 2;
      return reinterpret_cast<const unsigned char*>(a.raw16 + ((long long)c * a.s16 + r) * a.n);
    default:
      es = a.raw32_bytes;
      return static_cast<const unsigned char*>(a.raw32) + ((long long)c * a.s32 + r) * a.n * es;
  }
}

__device__ __forceinline__ long long warp_sum64(long long v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// The packed pass of one pod's row: the lane's feasible count and
// first-fail histogram in registers, the feasibility into the pod's bitmap
// bm (when not null).  tp: the thread in the pod, nth: the pod's threads.
template <typename T>
__device__ void packed_pass(const T* row, int n, int cb, int nf, int tp, int nth, unsigned* bm,
                            int& feas, int (&rej)[ATT_MAX_F]) {
  constexpr int V = 16 / (int)sizeof(T);  // words a vector
  constexpr int G = 32 / V;               // lanes a bitmap word
  const int lane = tp & 31;
  const int h = head_of(row, sizeof(T), n);
  const int nv = (n - h) / V;
  const uint4* body = reinterpret_cast<const uint4*>(row + h);
  for (int base = tp & ~31; base < nv; base += nth * ATT_UNROLL) {
    uint4 buf[ATT_UNROLL];
#pragma unroll
    for (int u = 0; u < ATT_UNROLL; ++u) {
      const int v = base + u * nth + lane;
      if (v < nv) buf[u] = __ldg(body + v);
    }
#pragma unroll
    for (int u = 0; u < ATT_UNROLL; ++u) {
      const int v0 = base + u * nth;  // the warp's first vector
      if (v0 >= nv) break;
      const int v = v0 + lane;
      unsigned mask = 0;
      if (v < nv) {
        const T* w = reinterpret_cast<const T*>(&buf[u]);
        int ff[V];
#pragma unroll
        for (int k = 0; k < V; ++k) {
          ff[k] = first_fail(w[k], cb);
          mask |= (unsigned)(ff[k] == 0) << k;
        }
        feas += __popc(mask);
#pragma unroll
        for (int f = 0; f < ATT_MAX_F; ++f) {
          if (f >= nf) break;
#pragma unroll
          for (int k = 0; k < V; ++k) rej[f] += ff[k] == f + 1;
        }
      }
      if (bm) {
        // G lanes hold 32 consecutive nodes from h + v * V, which is h
        // modulo 32 at their first lane
        unsigned word = mask << ((lane % G) * V);
#pragma unroll
        for (int o = 1; o < G; o <<= 1) word |= __shfl_xor_sync(0xffffffffu, word, o);
        if (lane % G == 0 && word) {
          const int j = h + v * V, s = j & 31;
          atomicOr(&bm[j >> 5], word << s);
          if (s && (word >> (32 - s))) atomicOr(&bm[(j >> 5) + 1], word >> (32 - s));
        }
      }
    }
  }
  // the head [0, h) and the tail [h + nv V, n): under 2V nodes, a lane each
  if (tp < 32) {
    const int j = lane < h ? lane : h + nv * V + lane - h;
    if (j < n) {
      const int ff = first_fail(row[j], cb);
      if (ff == 0) {
        ++feas;
        if (bm) atomicOr(&bm[j >> 5], 1u << (j & 31));
      }
#pragma unroll
      for (int f = 0; f < ATT_MAX_F; ++f) {
        if (f >= nf) break;
        rej[f] += ff == f + 1;
      }
    }
  }
}

// One score column's raws of the pod summed over its feasible nodes (the
// lane's share).
template <typename R>
__device__ long long raw_pass(const R* row, int n, const unsigned* bm, int tp, int nth) {
  constexpr int V = 16 / (int)sizeof(R);
  const int lane = tp & 31;
  const int h = head_of(row, sizeof(R), n);
  const int nv = (n - h) / V;
  const uint4* body = reinterpret_cast<const uint4*>(row + h);
  long long sum = 0;
  for (int base = tp & ~31; base < nv; base += nth * ATT_RAW_UNROLL) {
    unsigned mask[ATT_RAW_UNROLL];
    uint4 buf[ATT_RAW_UNROLL];
#pragma unroll
    for (int u = 0; u < ATT_RAW_UNROLL; ++u) {
      const int v = base + u * nth + lane;
      mask[u] = v < nv ? bits_at(bm, h + v * V, V) : 0u;
      if (mask[u]) buf[u] = __ldg(body + v);
    }
#pragma unroll
    for (int u = 0; u < ATT_RAW_UNROLL; ++u) {
      if (!mask[u]) continue;
      const R* x = reinterpret_cast<const R*>(&buf[u]);
      if constexpr (sizeof(R) <= 2) {  // 16 int8 or 8 int16 fit an int32
        int s = 0;
#pragma unroll
        for (int k = 0; k < V; ++k) s += (mask[u] >> k & 1) ? (int)x[k] : 0;
        sum += s;
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) sum += (mask[u] >> k & 1) ? (long long)x[k] : 0;
      }
    }
  }
  if (tp < 32) {
    const int j = lane < h ? lane : h + nv * V + lane - h;
    if (j < n && (bm[j >> 5] >> (j & 31) & 1)) sum += (long long)row[j];
  }
  return sum;
}

template <typename T>
__global__ void __launch_bounds__(ATT_MAX_WARPS * 32) att_kernel(const AttArgs a) {
  extern __shared__ unsigned sh_bits[];  // [pods][words], when a bitmap is needed
  __shared__ int sh_feas[ATT_MAX_WARPS];
  __shared__ int sh_rej[ATT_MAX_WARPS][ATT_MAX_F];
  __shared__ long long sh_sum[ATT_MAX_WARPS][ATT_MAX_Q];
  __shared__ unsigned long long sh_tot[ATT_TOTALS];
  __shared__ unsigned sh_on[ATT_MAX_WARPS], sh_fskip[ATT_MAX_WARPS];  // by the pod's place
  const unsigned full = 0xffffffffu;
  const int nth = a.warps * 32;
  const int slot = threadIdx.x / nth;  // the pod's place in the CTA
  const int tp = threadIdx.x - slot * nth;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * a.pods + slot;
  const bool real = c < a.c, valid = c < a.m;
  const int words = (a.n + 31) >> 5;
  unsigned* bm = !(a.q > 0 || a.want_pack) ? nullptr
      : a.bits ? a.bits + (long long)((int)blockIdx.x * a.pods + slot) * words
               : sh_bits + slot * words;

  if (bm)
    for (int i = tp; i < words; i += nth) bm[i] = 0;
  for (int i = threadIdx.x; i < ATT_TOTALS; i += blockDim.x) sh_tot[i] = 0;
  __syncthreads();

  // the pod's flags, in flight during the packed pass: lane q the
  // column q's score skip, lane f the filter f's PreFilter skip
  bool scored = false, skip_q = true, skip_f = true;
  if (valid && tp < 32) {
    scored = a.fc[c] > 1;
    if (lane < a.q) skip_q = a.sskip[(long long)a.col_scorer[lane] * a.c + c];
    if (lane < a.f) skip_f = a.fskip[(long long)lane * a.c + c];
  }
  int feas = 0;
  int rej[ATT_MAX_F];
#pragma unroll
  for (int f = 0; f < ATT_MAX_F; ++f) rej[f] = 0;
  if (valid)
    packed_pass<T>(static_cast<const T*>(a.packed) + (long long)c * a.n, a.n, a.code_bits, a.f,
                   tp, nth, bm, feas, rej);
  if (tp < 32) {
    const unsigned on = __ballot_sync(full, scored && !skip_q), fs = __ballot_sync(full, skip_f);
    if (lane == 0) {
      sh_on[slot] = on;
      sh_fskip[slot] = fs;
    }
  }
  feas = (int)__reduce_add_sync(full, (unsigned)feas);
#pragma unroll
  for (int f = 0; f < ATT_MAX_F; ++f) {
    if (f >= a.f) break;
    rej[f] = (int)__reduce_add_sync(full, (unsigned)rej[f]);
  }
  if (lane == 0) {
    sh_feas[warp] = feas;
#pragma unroll
    for (int f = 0; f < ATT_MAX_F; ++f)
      if (f < a.f) sh_rej[warp][f] = rej[f];
  }
  __syncthreads();  // the pod's bitmap is whole

  if (a.want_pack && real) {
    const unsigned char* bytes = reinterpret_cast<const unsigned char*>(bm);
    const int nb = (a.n + 7) >> 3;
    for (int i = tp; i < nb; i += nth) a.feas_packed[(long long)c * nb + i] = bytes[i];
  }
  const unsigned on = sh_on[slot];  // the columns the pod scores
  for (int q = 0; q < a.q; ++q) {
    long long s = 0;
    if (on >> q & 1) {
      int es;
      const unsigned char* row = raw_row(a, q, c, es);
      switch (es) {  // the column's base and width, once a pod
        case 1: s = raw_pass(reinterpret_cast<const signed char*>(row), a.n, bm, tp, nth); break;
        case 2: s = raw_pass(reinterpret_cast<const short*>(row), a.n, bm, tp, nth); break;
        case 4: s = raw_pass(reinterpret_cast<const int*>(row), a.n, bm, tp, nth); break;
        default: s = raw_pass(reinterpret_cast<const long long*>(row), a.n, bm, tp, nth);
      }
      s = warp_sum64(s);
    }
    if (lane == 0) sh_sum[warp][q] = s;
  }
  __syncthreads();

  // the pod's sums over its warps and its share of the chunk totals, by
  // its first warp: lane f takes filter f, lane q column q
  if (real && tp < 32) {
    const int w0 = slot * a.warps;
    int cnt = 0, r = 0;
    for (int w = 0; w < a.warps; ++w) {
      cnt += sh_feas[w0 + w];
      if (lane < a.f) r += sh_rej[w0 + w][lane];
    }
    int suffix = r;  // sum of rej over f' >= f
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_down_sync(full, suffix, o);
      if (lane + o < 32) suffix += y;
    }
    if (lane < a.f) {
      if (r) atomicAdd(&sh_tot[lane], (unsigned long long)r);
      const long long ev = (long long)cnt + suffix;
      if (ev && !(sh_fskip[slot] >> lane & 1))
        atomicAdd(&sh_tot[a.f + lane], (unsigned long long)ev);
    }
    if (lane < a.q) {
      long long s = 0;
      for (int w = 0; w < a.warps; ++w) s += sh_sum[w0 + w][lane];
      a.s_sum[(long long)c * a.q + lane] = s;
      if (cnt && (on >> lane & 1)) atomicAdd(&sh_tot[2 * a.f + lane], (unsigned long long)cnt);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * a.f + a.q; i += blockDim.x)
    if (sh_tot[i]) atomicAdd(reinterpret_cast<unsigned long long*>(a.totals) + i, sh_tot[i]);
}

// Column q's (group, row, scorer) in the wide kernel: from a.cols.
__device__ __forceinline__ const unsigned char* wide_raw_row(const AttArgs& a, int q, int c,
                                                             int& es) {
  const long long r = a.cols[a.q + q];
  switch (a.cols[q]) {
    case 1:
      es = 1;
      return reinterpret_cast<const unsigned char*>(a.raw8 + ((long long)c * a.s8 + r) * a.n);
    case 2:
      es = 2;
      return reinterpret_cast<const unsigned char*>(a.raw16 + ((long long)c * a.s16 + r) * a.n);
    default:
      es = a.raw32_bytes;
      return static_cast<const unsigned char*>(a.raw32) + ((long long)c * a.s32 + r) * a.n * es;
  }
}

// The wide form: one pod a CTA of a.warps warps; dynamic shared memory
// holds the column sums [q] (int64), the first-fail histogram [f] and,
// unless a.bits is set, the bitmap.
template <typename T>
__global__ void __launch_bounds__(ATT_MAX_WARPS * 32) att_wide_kernel(const AttArgs a) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ int sh_feas;
  long long* sum = reinterpret_cast<long long*>(dyn);
  int* rej = reinterpret_cast<int*>(dyn + 8 * (size_t)a.q);
  const int words = (a.n + 31) >> 5;
  const int c = blockIdx.x;
  const bool valid = c < a.m;
  unsigned* bm = a.bits ? a.bits + (long long)c * words
                        : reinterpret_cast<unsigned*>(dyn + 8 * (size_t)a.q +
                                                      4 * (size_t)((a.f + 3) & ~3));
  for (int i = threadIdx.x; i < a.q; i += blockDim.x) sum[i] = 0;
  for (int i = threadIdx.x; i < a.f; i += blockDim.x) rej[i] = 0;
  for (int i = threadIdx.x; i < words; i += blockDim.x) bm[i] = 0;
  if (threadIdx.x == 0) sh_feas = 0;
  __syncthreads();
  if (valid) {
    const T* row = static_cast<const T*>(a.packed) + (long long)c * a.n;
    int feas = 0;
    for (int j = threadIdx.x; j < a.n; j += blockDim.x) {
      const int ff = first_fail(row[j], a.code_bits);
      if (ff == 0) {
        ++feas;
        atomicOr(&bm[j >> 5], 1u << (j & 31));
      } else if (ff >= 1 && ff <= a.f) {
        atomicAdd(&rej[ff - 1], 1);
      }
    }
    feas = (int)__reduce_add_sync(0xffffffffu, (unsigned)feas);
    if ((threadIdx.x & 31) == 0) atomicAdd(&sh_feas, feas);
  }
  __syncthreads();  // the bitmap is whole
  if (a.want_pack && c < a.c) {
    const unsigned char* bytes = reinterpret_cast<const unsigned char*>(bm);
    const int nb = (a.n + 7) >> 3;
    for (int i = threadIdx.x; i < nb; i += blockDim.x)
      a.feas_packed[(long long)c * nb + i] = bytes[i];
  }
  const bool scored = valid && a.fc[c] > 1;
  for (int q = 0; q < a.q; ++q) {
    if (!scored || a.sskip[(long long)a.cols[2 * a.q + q] * a.c + c]) continue;  // uniform
    int es;
    const unsigned char* raw = wide_raw_row(a, q, c, es);
    long long s = 0;
    for (int j = threadIdx.x; j < a.n; j += blockDim.x) {
      if (!(bm[j >> 5] >> (j & 31) & 1)) continue;
      switch (es) {
        case 1: s += reinterpret_cast<const signed char*>(raw)[j]; break;
        case 2: s += reinterpret_cast<const short*>(raw)[j]; break;
        case 4: s += reinterpret_cast<const int*>(raw)[j]; break;
        default: s += reinterpret_cast<const long long*>(raw)[j];
      }
    }
    s = warp_sum64(s);
    if ((threadIdx.x & 31) == 0 && s)
      atomicAdd(reinterpret_cast<unsigned long long*>(&sum[q]), (unsigned long long)s);
  }
  __syncthreads();
  // the pod's sums and its share of the chunk totals, by one thread
  if (threadIdx.x == 0 && c < a.c) {
    unsigned long long* tot = reinterpret_cast<unsigned long long*>(a.totals);
    const long long feas = sh_feas;
    long long suffix = 0;
    for (int f = a.f - 1; f >= 0; --f) {
      suffix += rej[f];
      if (rej[f]) atomicAdd(&tot[f], (unsigned long long)rej[f]);
      const long long ev = feas + suffix;
      if (ev && valid && !a.fskip[(long long)f * a.c + c])
        atomicAdd(&tot[a.f + f], (unsigned long long)ev);
    }
    for (int q = 0; q < a.q; ++q) {
      a.s_sum[(long long)c * a.q + q] = sum[q];
      const bool on = scored && !a.sskip[(long long)a.cols[2 * a.q + q] * a.c + c];
      if (feas && on) atomicAdd(&tot[2 * a.f + q], (unsigned long long)feas);
    }
  }
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

#include <mutex>

#define ATT_MAX_DEVICES 64

extern "C" int kss_att_args_size() { return (int)sizeof(AttArgs); }

// Kernel's dynamic shared memory opted in to ATT_SMEM_MAX, once per card
// for the process (a function attribute, so no launch changes it): a
// launch's static and dynamic shared memory together may then pass 48 KB.
template <auto Kernel>
static cudaError_t att_optin() {
  static std::once_flag once[ATT_MAX_DEVICES];
  static cudaError_t err[ATT_MAX_DEVICES];
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= ATT_MAX_DEVICES) return cudaErrorInvalidDevice;
  std::call_once(once[dev], [dev] {
    err[dev] = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    ATT_SMEM_MAX);
  });
  return err[dev];
}

template <typename T>
static int att_launch(const AttArgs& a, cudaStream_t s) {
  const bool wide = a.f > ATT_MAX_F || a.q > ATT_MAX_Q;
  const bool bitmap = (a.q > 0 || a.want_pack) && a.bits == nullptr;
  const size_t words = (size_t)(a.n + 31) / 32;
  if (wide) {
    if (a.pods != 1 || (a.cols == nullptr && a.q > 0)) return (int)cudaErrorInvalidValue;
    const size_t smem = 8 * (size_t)a.q + 4 * (size_t)((a.f + 3) & ~3) + (bitmap ? 4 * words : 0);
    if (smem > ATT_SMEM_MAX) return (int)cudaErrorInvalidValue;
    const cudaError_t e = att_optin<att_wide_kernel<T>>();
    if (e != cudaSuccess) return (int)e;
    att_wide_kernel<T><<<a.c, a.warps * 32, smem, s>>>(a);
    return (int)cudaGetLastError();
  }
  const size_t smem = bitmap ? (size_t)a.pods * words * 4 : 0;
  if (smem > ATT_SMEM_MAX || (smem > ATT_SMEM && a.pods != 1)) return (int)cudaErrorInvalidValue;
  if (smem > 0) {
    // the opt-in also at up to 48 KB: the kernel's static shared memory
    // counts against the default limit, so a bitmap of exactly 48 KB
    // (393,216 nodes) needs it too
    const cudaError_t e = att_optin<att_kernel<T>>();
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((a.c + a.pods - 1) / a.pods), block(a.pods * a.warps * 32);
  att_kernel<T><<<grid, block, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// The chunk totals zeroed on the caller's stream, then the one launch:
// ceil(C / pods) CTAs of pods x warps warps (the wide kernel: C CTAs of
// one pod), a bitmap of ceil(N / 32) words a pod in dynamic shared memory
// where one is needed and a.bits is null (past 48 KB, one pod a CTA, in
// the opt-in shared memory up to ATT_SMEM_MAX), else in a.bits.  No
// synchronisation.  Returns the first CUDA error, so a refused launch is
// reported at once.
extern "C" int kss_chunk_attribution(const AttArgs* args, void* stream) {
  const AttArgs& a = *args;
  const cudaStream_t s = (cudaStream_t)stream;
  const int totals = 2 * a.f + a.q;
  if (totals) {
    const cudaError_t e = cudaMemsetAsync(a.totals, 0, totals * sizeof(long long), s);
    if (e != cudaSuccess) return (int)e;
  }
  if (a.warps < 1 || a.pods < 1 || a.warps * a.pods > ATT_MAX_WARPS || a.c < 1)
    return (int)cudaErrorInvalidValue;
  switch (a.pack_bytes) {
    case 1: return att_launch<unsigned char>(a, s);
    case 2: return att_launch<unsigned short>(a, s);
    case 4: return att_launch<int>(a, s);
    default: return att_launch<long long>(a, s);
  }
}
#endif
