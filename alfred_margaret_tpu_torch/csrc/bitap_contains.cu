// B4 bitap_contains and B7 bitap_presence: sticky shift-AND end bits for Hopper.
//
// Replace the Pallas TPU kernels alfred_margaret_tpu/ops/bitap_scan.py:
// _make_bitap_contains_kernel (B4, launched from
// BitapAcEngine._get_bitap_contains_fn) and _make_bitap_presence_kernel (B7,
// from _get_bitap_presence_fn), with their trap parts.
// As in B2 (bitap_count.cu) one thread per stream keeps V <= 3 uint32
// registers and the byte -> track-mask tables btab[V][256] sit in shared
// memory.
//
// Per stream s, per step t over b = streams[t * S + s], with no masking:
//   D[w] = ((D[w] << 1) | seed[w]) & btab[w][b]         for every word w
//   B4:  hit  |= D[w] & endmask[w]      -> out[s]         (one register)
//   B7:  H[w] |= D[w] & endmask[w]      -> out[w * S + s] (one plane per word:
//        the words share bit positions, so one OR would alias their tracks)
// Warm-up bytes are real corpus bytes, so a match there is a real match; the
// right-pad zeros clear every register (no needle holds NUL), so they add
// nothing.
//
// The trap parts (TRAP = true) serve the byte-class IgnoreCase layouts, whose
// trap tracks ride the spare high bits of the match words or a standalone
// trap register (one more word, endmask 0): per word a trap mask trapmask[w].
//   B4:  tr   |= D[w] & trapmask[w]   -> trap_out[s]     (sticky trap flag)
//   B7:  H[w] |= D[w] & (endmask[w] | trapmask[w])     (the trap bits share
//        the word's plane, as in the TPU kernel)
// With TRAP = false the template compiles to the kernels without a trap.
//
// What bounds it: as in B2, one byte read from device memory per step plus a
// few ALU operations per word, with stream bytes loaded kChunk steps ahead.
// No early exit: the outputs are the exact OR over the whole stream, which the
// tests hold bit for bit against the TPU kernel's.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 16;
constexpr int kMaxWords = 3;

template <int V, bool PER_WORD, bool TRAP>
__global__ void __launch_bounds__(kThreads) bitap_sticky_kernel(
    const uint8_t* __restrict__ streams, int T, int S,
    const int32_t* __restrict__ btab, const int32_t* __restrict__ seed,
    const int32_t* __restrict__ endmask, const int32_t* __restrict__ trapmask,
    int32_t* __restrict__ out, int32_t* __restrict__ trap_out) {
  __shared__ uint32_t bt[V * 256];
  for (int i = threadIdx.x; i < V * 256; i += blockDim.x) bt[i] = (uint32_t)btab[i];
  __syncthreads();

  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  constexpr int H_WORDS = PER_WORD ? V : 1;
  uint32_t sd[V], em[V], D[V], H[H_WORDS], tm[V];
#pragma unroll
  for (int w = 0; w < V; ++w) {
    sd[w] = (uint32_t)seed[w];
    em[w] = (uint32_t)endmask[w];
    if constexpr (TRAP) {
      tm[w] = (uint32_t)trapmask[w];
      if constexpr (PER_WORD) em[w] |= tm[w];
    }
    D[w] = 0u;
  }
  uint32_t tr = 0;
#pragma unroll
  for (int w = 0; w < H_WORDS; ++w) H[w] = 0u;
  const uint8_t* col = streams + s;

  auto step = [&](uint32_t b) {
#pragma unroll
    for (int w = 0; w < V; ++w) {
      D[w] = ((D[w] << 1) | sd[w]) & bt[w * 256 + b];
      H[PER_WORD ? w : 0] |= D[w] & em[w];
      if constexpr (TRAP && !PER_WORD) tr |= D[w] & tm[w];
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
  for (int w = 0; w < H_WORDS; ++w) out[(size_t)w * S + s] = (int32_t)H[w];
  if constexpr (TRAP && !PER_WORD) trap_out[s] = (int32_t)tr;
}

template <bool PER_WORD, bool TRAP = false>
int launch(const void* streams, int T, int S, const void* btab, const void* seed,
           const void* endmask, int n_words, void* out, void* stream,
           const void* trapmask = nullptr, void* trap_out = nullptr) {
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
  int32_t* tp = (int32_t*)trap_out;
  switch (n_words) {
    case 1: bitap_sticky_kernel<1, PER_WORD, TRAP><<<grid, kThreads, 0, st>>>(sp, T, S, bt, sd, em, tm, op, tp); break;
    case 2: bitap_sticky_kernel<2, PER_WORD, TRAP><<<grid, kThreads, 0, st>>>(sp, T, S, bt, sd, em, tm, op, tp); break;
    default: bitap_sticky_kernel<3, PER_WORD, TRAP><<<grid, kThreads, 0, st>>>(sp, T, S, bt, sd, em, tm, op, tp); break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// B4: out is int32 [S].  Launch on `stream` (a cudaStream_t); returns the
// cudaError_t of the launch; the kernel runs asynchronously.
extern "C" int amt_bitap_contains(const void* streams, int T, int S, const void* btab,
                                  const void* seed, const void* endmask, int n_words,
                                  void* out, void* stream) {
  return launch<false>(streams, T, S, btab, seed, endmask, n_words, out, stream);
}

// B7: out is int32 [n_words, S].  As amt_bitap_contains otherwise.
extern "C" int amt_bitap_presence(const void* streams, int T, int S, const void* btab,
                                  const void* seed, const void* endmask, int n_words,
                                  void* out, void* stream) {
  return launch<true>(streams, T, S, btab, seed, endmask, n_words, out, stream);
}

// B4's trap part: hits as amt_bitap_contains, and trap_out int32 [S] the OR of
// every word's D & trapmask.
extern "C" int amt_bitap_contains_trap(const void* streams, int T, int S, const void* btab,
                                       const void* seed, const void* endmask,
                                       const void* trapmask, int n_words, void* out,
                                       void* trap_out, void* stream) {
  return launch<false, true>(streams, T, S, btab, seed, endmask, n_words, out, stream, trapmask,
                             trap_out);
}

// B7's trap part: out int32 [n_words, S], each plane the OR of D & (endmask |
// trapmask) of its word.
extern "C" int amt_bitap_presence_trap(const void* streams, int T, int S, const void* btab,
                                       const void* seed, const void* endmask,
                                       const void* trapmask, int n_words, void* out,
                                       void* stream) {
  return launch<true, true>(streams, T, S, btab, seed, endmask, n_words, out, stream, trapmask);
}
