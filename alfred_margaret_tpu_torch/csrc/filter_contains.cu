// B14 filter_contains: the stride-2 candidate screen for Hopper.
//
// Replaces the Pallas TPU kernel alfred_margaret_tpu/ops/filter_scan.py:
// make_filter_contains_kernel (launched from filter_contains: the screen that
// the comb16 engine asks before its sticky scan, with up to 3 words, and the
// grouped engine before its fused sticky scan, with up to 12).  One thread per
// stream, one step per byte pair (b1, b2) = (streams[t], streams[t + 1]),
// t = 2u < vend[s]:
//   h    = ((b1 & 15) << 3) | (b2 & 7)
//   D[v] = ((D[v] << 1) | seed[v]) & btab[v][h];   cand |= D[v] & endmask[v]
//   roll = (roll << 16) | (b1 << 8) | b2
//   exact |= (roll & mask[k]) == const[k] || ((roll >> 8) & mask[k]) == const[k]
// for V <= 12 candidate words (V a template argument) and K <= 8 short
// needles of at most 3 bytes (masks of at most 24 bits, so the logical shift
// here and the TPU kernel's arithmetic one agree).  From t >= vend[s] the TPU kernel
// freezes D and roll (cut at b1, since a match can end at the last valid
// byte); frozen registers change no plane, so the thread stops there.  The
// TPU kernel freezes on boundary tiles only (_strict_bscal), which equals
// freezing on every step for every stream that has data.  out[s] = exact,
// out[S + s] = cand.
//
// What bounds it: one shared-memory table load per word per TWO bytes, and
// ALU compares for the short needles, against three or four dependent loads
// per byte in the exact sticky scan (B10): the screen reads the stream bytes
// kChunk at a time ahead into registers and is meant to run near the rate at
// which the card streams them.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 16;  // bytes: 8 pair steps
constexpr int kMaxWords = 12;
constexpr int kMaxShorts = 8;

template <int V>
__device__ __forceinline__ void pair_step(uint32_t b1, uint32_t b2, const uint32_t* bt,
                                          const uint32_t (&sd)[kMaxWords + 1],
                                          const uint32_t (&em)[kMaxWords + 1],
                                          uint32_t (&D)[kMaxWords + 1], const uint32_t* sm,
                                          const uint32_t* sc, int n_shorts, uint32_t& roll,
                                          uint32_t& exact, uint32_t& cand) {
  const uint32_t h = ((b1 & 15u) << 3) | (b2 & 7u);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    D[v] = ((D[v] << 1) | sd[v]) & bt[v * 128 + h];
    cand |= D[v] & em[v];
  }
  roll = (roll << 16) | (b1 << 8) | b2;
  for (int k = 0; k < n_shorts; ++k)
    exact |= ((roll & sm[k]) == sc[k] || ((roll >> 8) & sm[k]) == sc[k]) ? 1u : 0u;
}

template <int V>
__global__ void __launch_bounds__(kThreads) filter_contains_kernel(
    const uint8_t* __restrict__ streams, int T, int S, const int32_t* __restrict__ vend,
    const int32_t* __restrict__ btab, const int32_t* __restrict__ seed,
    const int32_t* __restrict__ endmask, const int32_t* __restrict__ short_mask,
    const int32_t* __restrict__ short_const, int n_shorts, int32_t* __restrict__ out) {
  __shared__ uint32_t bt[kMaxWords * 128];
  __shared__ uint32_t sm[kMaxShorts];
  __shared__ uint32_t sc[kMaxShorts];
  for (int i = threadIdx.x; i < V * 128; i += blockDim.x) bt[i] = (uint32_t)btab[i];
  for (int i = threadIdx.x; i < n_shorts; i += blockDim.x) {
    sm[i] = (uint32_t)short_mask[i];
    sc[i] = (uint32_t)short_const[i];
  }
  __syncthreads();

  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  uint32_t sd[kMaxWords + 1] = {}, em[kMaxWords + 1] = {}, D[kMaxWords + 1] = {};
#pragma unroll
  for (int v = 0; v < V; ++v) {
    sd[v] = (uint32_t)seed[v];
    em[v] = (uint32_t)endmask[v];
  }
  const int v0 = min(vend[s], T);
  const uint8_t* col = streams + s;
  uint32_t roll = 0, exact = 0, cand = 0;

  int t = 0;
  for (; t + kChunk <= v0; t += kChunk) {
    uint8_t b[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) b[j] = col[(size_t)(t + j) * S];
#pragma unroll
    for (int j = 0; j < kChunk; j += 2)
      pair_step<V>(b[j], b[j + 1], bt, sd, em, D, sm, sc, n_shorts, roll, exact, cand);
  }
  // T is even, so the pair of the last valid byte lies inside the stream.
  for (; t < v0; t += 2)
    pair_step<V>(col[(size_t)t * S], col[(size_t)(t + 1) * S], bt, sd, em, D, sm, sc, n_shorts,
                 roll, exact, cand);
  out[s] = (int32_t)exact;
  out[(size_t)S + s] = (int32_t)cand;
}

// Launch the instance for V = n_words (V from Vmin up to kMaxWords).
template <int Vmin>
void launch_words(int n_words, dim3 grid, cudaStream_t st, const uint8_t* sp, int T, int S,
                  const int32_t* vp, const int32_t* bp, const int32_t* sdp, const int32_t* ep,
                  const int32_t* mp, const int32_t* cp, int n_shorts, int32_t* op) {
  if constexpr (Vmin < kMaxWords) {
    if (n_words != Vmin)
      return launch_words<Vmin + 1>(n_words, grid, st, sp, T, S, vp, bp, sdp, ep, mp, cp,
                                    n_shorts, op);
  }
  filter_contains_kernel<Vmin><<<grid, kThreads, 0, st>>>(sp, T, S, vp, bp, sdp, ep, mp, cp,
                                                          n_shorts, op);
}

}  // namespace

// out int32 [2, S].  Launch on `stream` (a cudaStream_t); returns the
// cudaError_t of the launch; the kernel runs asynchronously.
extern "C" int amt_filter_contains(const void* streams, int T, int S, const void* vend,
                                   const void* btab, const void* seed, const void* endmask,
                                   int n_words, const void* short_mask,
                                   const void* short_const, int n_shorts, void* out,
                                   void* stream) {
  if (T < 0 || T % 2 || S <= 0 || n_words < 0 || n_words > kMaxWords || n_shorts < 0 ||
      n_shorts > kMaxShorts)
    return (int)cudaErrorInvalidValue;
  launch_words<0>(n_words, dim3((S + kThreads - 1) / kThreads), (cudaStream_t)stream,
                  (const uint8_t*)streams, T, S, (const int32_t*)vend, (const int32_t*)btab,
                  (const int32_t*)seed, (const int32_t*)endmask, (const int32_t*)short_mask,
                  (const int32_t*)short_const, n_shorts, (int32_t*)out);
  return (int)cudaGetLastError();
}
