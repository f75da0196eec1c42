// grid_append and grid_emit: the speculative wave's chunk-grid
// accumulator, written for Hopper (sm_90a).
//
// They replace kube_scheduler_simulator_tpu/parallel/speculative.py:553
// `_accum_fns`.  The accumulator is five group buffers (packed, raw8,
// raw16, raw32, fc), each [chunk + extra, row] with a row of row_bytes
// bytes:
//
//   * grid_append copies a round's n_rows rows into every buffer at row
//     `fill` (the caller advances fill past the accepted prefix only, so
//     the next round overwrites the rejected suffix);
//   * grid_emit copies rows [0, chunk) out to `head`, and rows
//     [chunk, chunk + extra) to the start of a second buffer `rest`,
//     with zeros after them.  The shift overlaps itself, so it writes
//     into that second buffer and the caller swaps the two: no block
//     reads what another writes.
//
// One launch covers all five buffers: blockIdx.y is the buffer.  Each
// copy moves words of `unit` bytes (16, 8, 4, 2 or 1), the largest that
// divides every address and length of that buffer.  What bounds them on
// this card: bytes, each row read once and written once.
#include <cstdint>

#define GRID_GROUPS 5
#define GRID_THREADS 256

// All 8-byte members first, then the 4-byte ones (kernels/spec.py
// mirrors it as a ctypes.Structure).
struct GridArgs {
  char* buf[GRID_GROUPS];         // the accumulator, [total_rows, row_bytes]
  const char* rows[GRID_GROUPS];  // append: the round's rows
  char* head[GRID_GROUPS];        // emit: rows [0, chunk)
  char* rest[GRID_GROUPS];        // emit: the second buffer
  long long row_bytes[GRID_GROUPS];
  long long n_rows;               // append: rows to copy
  long long fill;                 // append: the destination row
  long long chunk;                // emit: rows split off
  long long total_rows;           // chunk + extra
  int unit[GRID_GROUPS];
  int groups;
};

template <typename W>
__device__ void copy_words(char* dst, const char* src, long long nbytes, long long t, long long step) {
  W* d = (W*)dst;
  const W* s = (const W*)src;
  for (long long i = t; i < nbytes / (long long)sizeof(W); i += step) d[i] = s[i];
}

template <typename W>
__device__ void zero_words(char* dst, long long nbytes, long long t, long long step) {
  W* d = (W*)dst;
  const W z{};
  for (long long i = t; i < nbytes / (long long)sizeof(W); i += step) d[i] = z;
}

__device__ void copy_bytes(char* dst, const char* src, long long nbytes, int unit) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long step = (long long)gridDim.x * blockDim.x;
  switch (unit) {
    case 16: copy_words<uint4>(dst, src, nbytes, t, step); break;
    case 8: copy_words<unsigned long long>(dst, src, nbytes, t, step); break;
    case 4: copy_words<unsigned int>(dst, src, nbytes, t, step); break;
    case 2: copy_words<unsigned short>(dst, src, nbytes, t, step); break;
    default: copy_words<unsigned char>(dst, src, nbytes, t, step); break;
  }
}

__device__ void zero_bytes(char* dst, long long nbytes, int unit) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long step = (long long)gridDim.x * blockDim.x;
  switch (unit) {
    case 16: zero_words<uint4>(dst, nbytes, t, step); break;
    case 8: zero_words<unsigned long long>(dst, nbytes, t, step); break;
    case 4: zero_words<unsigned int>(dst, nbytes, t, step); break;
    case 2: zero_words<unsigned short>(dst, nbytes, t, step); break;
    default: zero_words<unsigned char>(dst, nbytes, t, step); break;
  }
}

__global__ void __launch_bounds__(GRID_THREADS) grid_append_kernel(const GridArgs a) {
  const int g = blockIdx.y;
  const long long rb = a.row_bytes[g];
  copy_bytes(a.buf[g] + a.fill * rb, a.rows[g], a.n_rows * rb, a.unit[g]);
}

__global__ void __launch_bounds__(GRID_THREADS) grid_emit_kernel(const GridArgs a) {
  const int g = blockIdx.y;
  const long long rb = a.row_bytes[g];
  const long long kept = (a.total_rows - a.chunk) * rb;
  copy_bytes(a.head[g], a.buf[g], a.chunk * rb, a.unit[g]);
  copy_bytes(a.rest[g], a.buf[g] + a.chunk * rb, kept, a.unit[g]);
  zero_bytes(a.rest[g] + kept, a.chunk * rb, a.unit[g]);
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

extern "C" int kss_grid_args_size() { return (int)sizeof(GridArgs); }

static dim3 grid_of(const GridArgs* a, long long rows) {
  long long most = 0;
  for (int g = 0; g < a->groups; ++g) {
    const long long words = rows * a->row_bytes[g] / a->unit[g];
    most = most > words ? most : words;
  }
  long long blocks = (most + GRID_THREADS - 1) / GRID_THREADS;
  blocks = blocks < 1 ? 1 : (blocks > 1024 ? 1024 : blocks);
  return dim3((unsigned)blocks, (unsigned)a->groups);
}

// Launches on the caller's stream; no synchronisation.  Each returns
// cudaGetLastError() so a refused launch is reported at once.
extern "C" int kss_grid_append(const GridArgs* args, void* stream) {
  grid_append_kernel<<<grid_of(args, args->n_rows), GRID_THREADS, 0, (cudaStream_t)stream>>>(
      *args);
  return (int)cudaGetLastError();
}

extern "C" int kss_grid_emit(const GridArgs* args, void* stream) {
  grid_emit_kernel<<<grid_of(args, args->total_rows), GRID_THREADS, 0, (cudaStream_t)stream>>>(
      *args);
  return (int)cudaGetLastError();
}
#endif
