// B1 dense_count: the byte-class-compressed DFA count kernel for Hopper.
//
// Replaces the Pallas TPU kernel alfred_margaret_tpu/ops/pallas_scan.py:
// _make_count_kernel (launched from PallasAcEngine._get_count_fn).  It computes
// what that kernel computes, not how: the TPU version gathers 128-lane table
// rows with a select chain and relies on mod-128 lane indexing; here every
// stream is one thread and the packed table sits in shared memory.
//
// Per stream s, per step t over streams[t * S + s]:
//   idx   = sbase + classmap[byte]
//   v     = packing == 1 ? table[idx]
//                        : (table[idx >> 1] >> 16 * (idx & 1)) & 0xFFFF
//   sbase = v & state_mask              (masked on every step: no raw carry)
//   count += v >> state_bits            while warm[s] <= t < vend[s]
// and out[s] = count.  The scan stops at vend[s]: nothing after it counts.
//
// What bounds it: each step is a dependent chain of two shared-memory loads
// (class, then entry) per stream, so the kernel is bound by that latency, not
// by device-memory bandwidth.  The stream bytes are loaded kChunk steps ahead
// into registers so the device-memory loads overlap the chain.  At S = 32768
// streams the card holds about 248 threads per SM, too few to hide the chain.
// Left for later: a tiled [S, T] layout with 16-byte loads, several streams
// per thread, and more streams per SM.
//
// B5 dense_states, the packed entry at every step, replaces the Pallas TPU
// kernel pallas_scan.py:_make_states_kernel (launched from
// PallasAcEngine._get_states_fn).  The same lookup from sbase = 0, with no
// [warm, vend) window: every step t < T writes
//   out[t * S + s] = v
// (a warp's threads hold neighbouring streams, so its stores are coalesced),
// and the host picks the window (match extraction, the final_states stitch).
// It moves 5 bytes per step (one read, one 4-byte write), 692 MB at 128 MiB,
// against B1's one; the lookup chain is B1's.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 16;
// MAX_ROWS (48) rows of 128 int32 entries: 24 KiB of shared memory.
constexpr int kMaxTableWords = 48 * 128;

template <int PACKING>
__device__ __forceinline__ uint32_t lookup(const uint32_t* tab, uint32_t idx) {
  if (PACKING == 1) return tab[idx];
  return (tab[idx >> 1] >> ((idx & 1u) << 4)) & 0xFFFFu;
}

template <int PACKING>
__global__ void __launch_bounds__(kThreads) dense_count_kernel(
    const uint8_t* __restrict__ streams, int T, int S,
    const int32_t* __restrict__ classmap, const int32_t* __restrict__ table,
    int table_words, const int32_t* __restrict__ warm,
    const int32_t* __restrict__ vend, int state_bits,
    int32_t* __restrict__ out) {
  __shared__ uint32_t cm[256];
  extern __shared__ uint32_t tab[];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) cm[i] = (uint32_t)classmap[i];
  for (int i = threadIdx.x; i < table_words; i += blockDim.x) tab[i] = (uint32_t)table[i];
  __syncthreads();

  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const uint32_t mask = (1u << state_bits) - 1u;
  const int w0 = warm[s];
  const int v0 = min(vend[s], T);
  const uint8_t* col = streams + s;
  uint32_t sbase = 0, count = 0;

  int t = 0;
  for (; t + kChunk <= v0; t += kChunk) {
    uint8_t b[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) b[j] = col[(size_t)(t + j) * S];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const uint32_t v = lookup<PACKING>(tab, sbase + cm[b[j]]);
      sbase = v & mask;
      count += (t + j >= w0) ? (v >> state_bits) : 0u;
    }
  }
  for (; t < v0; ++t) {
    const uint32_t v = lookup<PACKING>(tab, sbase + cm[col[(size_t)t * S]]);
    sbase = v & mask;
    count += (t >= w0) ? (v >> state_bits) : 0u;
  }
  out[s] = (int32_t)count;
}

template <int PACKING>
__global__ void __launch_bounds__(kThreads) dense_states_kernel(
    const uint8_t* __restrict__ streams, int T, int S,
    const int32_t* __restrict__ classmap, const int32_t* __restrict__ table,
    int table_words, int state_bits, int32_t* __restrict__ out) {
  __shared__ uint32_t cm[256];
  extern __shared__ uint32_t tab[];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) cm[i] = (uint32_t)classmap[i];
  for (int i = threadIdx.x; i < table_words; i += blockDim.x) tab[i] = (uint32_t)table[i];
  __syncthreads();

  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const uint32_t mask = (1u << state_bits) - 1u;
  const uint8_t* col = streams + s;
  int32_t* dst = out + s;
  uint32_t sbase = 0;

  int t = 0;
  for (; t + kChunk <= T; t += kChunk) {
    uint8_t b[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) b[j] = col[(size_t)(t + j) * S];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const uint32_t v = lookup<PACKING>(tab, sbase + cm[b[j]]);
      sbase = v & mask;
      dst[(size_t)(t + j) * S] = (int32_t)v;
    }
  }
  for (; t < T; ++t) {
    const uint32_t v = lookup<PACKING>(tab, sbase + cm[col[(size_t)t * S]]);
    sbase = v & mask;
    dst[(size_t)t * S] = (int32_t)v;
  }
}

bool args_ok(int T, int S, int table_words, int packing, int state_bits) {
  return T >= 0 && S > 0 && table_words > 0 && table_words <= kMaxTableWords &&
         state_bits > 0 && state_bits < 32 && (packing == 1 || packing == 2);
}

}  // namespace

// Launch on `stream` (a cudaStream_t).  Returns the cudaError_t of the launch;
// the kernel runs asynchronously.
extern "C" int amt_dense_count(const void* streams, int T, int S,
                               const void* classmap, const void* table,
                               int table_words, const void* warm,
                               const void* vend, int packing, int state_bits,
                               void* out, void* stream) {
  if (!args_ok(T, S, table_words, packing, state_bits)) return (int)cudaErrorInvalidValue;
  const dim3 grid((S + kThreads - 1) / kThreads);
  const size_t smem = (size_t)table_words * sizeof(uint32_t);
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* sp = (const uint8_t*)streams;
  const int32_t* cp = (const int32_t*)classmap;
  const int32_t* tp = (const int32_t*)table;
  const int32_t* wp = (const int32_t*)warm;
  const int32_t* vp = (const int32_t*)vend;
  int32_t* op = (int32_t*)out;
  if (packing == 1)
    dense_count_kernel<1><<<grid, kThreads, smem, st>>>(sp, T, S, cp, tp, table_words, wp, vp, state_bits, op);
  else
    dense_count_kernel<2><<<grid, kThreads, smem, st>>>(sp, T, S, cp, tp, table_words, wp, vp, state_bits, op);
  return (int)cudaGetLastError();
}

// B5: out int32 [T, S], the packed entry at every step.  As amt_dense_count
// otherwise.
extern "C" int amt_dense_states(const void* streams, int T, int S,
                                const void* classmap, const void* table,
                                int table_words, int packing, int state_bits,
                                void* out, void* stream) {
  if (!args_ok(T, S, table_words, packing, state_bits)) return (int)cudaErrorInvalidValue;
  const dim3 grid((S + kThreads - 1) / kThreads);
  const size_t smem = (size_t)table_words * sizeof(uint32_t);
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* sp = (const uint8_t*)streams;
  const int32_t* cp = (const int32_t*)classmap;
  const int32_t* tp = (const int32_t*)table;
  int32_t* op = (int32_t*)out;
  if (packing == 1)
    dense_states_kernel<1><<<grid, kThreads, smem, st>>>(sp, T, S, cp, tp, table_words, state_bits, op);
  else
    dense_states_kernel<2><<<grid, kThreads, smem, st>>>(sp, T, S, cp, tp, table_words, state_bits, op);
  return (int)cudaGetLastError();
}
