// B7 bitap_presence: sticky shift-AND end-bit planes for Hopper.
//
// Replaces the Pallas TPU kernel alfred_margaret_tpu/ops/bitap_scan.py:
// _make_bitap_presence_kernel (launched from
// BitapAcEngine._get_bitap_presence_fn), with its trap part.  (B4, the
// sticky hit of the same registers, is the sticky mode of B2's segmented
// scan in bitap_count.cu.)  As in B2 one thread per stream keeps V <= 3
// uint32 registers and the byte -> track-mask tables btab[V][256] sit in
// shared memory.
//
// Per stream s, per step t over b = streams[t * S + s], with no masking:
//   D[w] = ((D[w] << 1) | seed[w]) & btab[w][b]         for every word w
//   H[w] |= D[w] & endmask[w]      -> out[w * S + s]     (one plane per word:
//        the words share bit positions, so one OR would alias their tracks)
// Warm-up bytes are real corpus bytes, so a match there is a real match; the
// right-pad zeros clear every register (no needle holds NUL), so they add
// nothing.
//
// The trap part (TRAP = true) serves the byte-class IgnoreCase layouts,
// whose trap tracks ride the spare high bits of the match words or a
// standalone trap register (one more word, endmask 0): per word a trap mask
// trapmask[w], and H[w] |= D[w] & (endmask[w] | trapmask[w]) (the trap bits
// share the word's plane, as in the TPU kernel).  With TRAP = false the
// template compiles to the kernel without a trap.
//
// What bounds it: as in B2, one byte read from device memory per step plus a
// few ALU operations per word, with stream bytes loaded kChunk steps ahead.
// No early exit: the output is the exact OR over the whole stream, which the
// tests hold bit for bit against the TPU kernel's.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 16;
constexpr int kMaxWords = 3;

template <int V, bool TRAP>
__global__ void __launch_bounds__(kThreads) bitap_presence_kernel(
    const uint8_t* __restrict__ streams, int T, int S,
    const int32_t* __restrict__ btab, const int32_t* __restrict__ seed,
    const int32_t* __restrict__ endmask, const int32_t* __restrict__ trapmask,
    int32_t* __restrict__ out) {
  __shared__ uint32_t bt[V * 256];
  for (int i = threadIdx.x; i < V * 256; i += blockDim.x) bt[i] = (uint32_t)btab[i];
  __syncthreads();

  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  uint32_t sd[V], em[V], D[V], H[V];
#pragma unroll
  for (int w = 0; w < V; ++w) {
    sd[w] = (uint32_t)seed[w];
    em[w] = (uint32_t)endmask[w];
    if constexpr (TRAP) em[w] |= (uint32_t)trapmask[w];
    D[w] = 0u;
    H[w] = 0u;
  }
  const uint8_t* col = streams + s;

  auto step = [&](uint32_t b) {
#pragma unroll
    for (int w = 0; w < V; ++w) {
      D[w] = ((D[w] << 1) | sd[w]) & bt[w * 256 + b];
      H[w] |= D[w] & em[w];
    }
  };

  int t = 0;
  for (; t + kChunk <= T; t += kChunk) {
    uint8_t b[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) b[j] = col[(size_t)(t + j) * S];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) step(b[j]);
  }
  for (; t < T; ++t) step(col[(size_t)t * S]);
#pragma unroll
  for (int w = 0; w < V; ++w) out[(size_t)w * S + s] = (int32_t)H[w];
}

template <bool TRAP>
int launch(const void* streams, int T, int S, const void* btab, const void* seed,
           const void* endmask, const void* trapmask, int n_words, void* out, void* stream) {
  if (T < 0 || S <= 0 || n_words < 1 || n_words > kMaxWords)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((S + kThreads - 1) / kThreads);
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* sp = (const uint8_t*)streams;
  const int32_t* bt = (const int32_t*)btab;
  const int32_t* sd = (const int32_t*)seed;
  const int32_t* em = (const int32_t*)endmask;
  const int32_t* tm = (const int32_t*)trapmask;
  int32_t* op = (int32_t*)out;
  switch (n_words) {
    case 1: bitap_presence_kernel<1, TRAP><<<grid, kThreads, 0, st>>>(sp, T, S, bt, sd, em, tm, op); break;
    case 2: bitap_presence_kernel<2, TRAP><<<grid, kThreads, 0, st>>>(sp, T, S, bt, sd, em, tm, op); break;
    default: bitap_presence_kernel<3, TRAP><<<grid, kThreads, 0, st>>>(sp, T, S, bt, sd, em, tm, op); break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// B7: out is int32 [n_words, S].  Launch on `stream` (a cudaStream_t);
// returns the cudaError_t of the launch; the kernel runs asynchronously.
extern "C" int amt_bitap_presence(const void* streams, int T, int S, const void* btab,
                                  const void* seed, const void* endmask, int n_words,
                                  void* out, void* stream) {
  return launch<false>(streams, T, S, btab, seed, endmask, nullptr, n_words, out, stream);
}

// B7's trap part: out int32 [n_words, S], each plane the OR of D & (endmask |
// trapmask) of its word.
extern "C" int amt_bitap_presence_trap(const void* streams, int T, int S, const void* btab,
                                       const void* seed, const void* endmask,
                                       const void* trapmask, int n_words, void* out,
                                       void* stream) {
  return launch<true>(streams, T, S, btab, seed, endmask, trapmask, n_words, out, stream);
}
