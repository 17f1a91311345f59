// B10 comb16_contains: the 16-bit three-tier comb DFA sticky scan for Hopper.
// (B8, the comb16 count, and B12, the comb16 states, are one-group modes of
// comb16_grouped.cu's segmented scan.)
//
// Replaces the Pallas TPU kernel alfred_margaret_tpu/ops/comb16_scan.py:
// _make_c16_contains_kernel (launched from Comb16PallasAcEngine.
// _get_contains_fn).  It computes what that kernel computes, not how: the TPU
// version gathers 128-lane table rows with select chains (or compare chains
// for the root row and segment table, AMT_C16_CHAINS) and splits boundary
// tiles from interior ones; here every stream is one thread, the tables (at
// most 48 rows of 128 words, 26 KB with the class map) sit in shared memory,
// and the lookup of comb16.cuh resolves one byte.
//
// B10, on the sticky view's tables (CB = 0), per stream s, per step
// t < vend[s]:
//   cb = lookup(cb, streams[t * S + s]) & (2^BB - 1)
// from cb = root_cb, the base held from t = vend[s] on; out[s] = the final
// base, which is `absorb` iff the stream saw a match.  The absorbing base
// loops to itself, so a thread stops reading once it is there.
//
// What bounds it: per step a dependent chain of shared-memory loads (class,
// then comb and segment table, then aux after the segment table), three to
// four deep against B1's two, so the kernel is latency-bound like B1's first
// port and not bound by device memory.  Stream bytes are loaded kChunk steps
// ahead into registers so that the device-memory loads overlap the chain.
// Left for later: the segmented, staged pipeline of comb16_grouped.cu.

#include <cstdint>
#include <cuda_runtime.h>

#include "comb16.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 16;

__global__ void __launch_bounds__(kThreads) comb16_contains_kernel(
    const uint8_t* __restrict__ streams, int T, int S, const int32_t* __restrict__ vend,
    const int32_t* __restrict__ classmap, const int32_t* __restrict__ comb, int comb_words,
    const int32_t* __restrict__ aux, int aux_words, const int32_t* __restrict__ root_row,
    const int32_t* __restrict__ segtable, int bb, int owner_mask, int root_cb, uint32_t absorb,
    int32_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const amt::Comb16 c = amt::load_comb16(smem, classmap, comb, comb_words, aux, aux_words,
                                         root_row, segtable, bb, owner_mask);
  __syncthreads();

  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const uint32_t bmask = (1u << bb) - 1u;
  const int v0 = min(vend[s], T);
  const uint8_t* col = streams + s;
  uint32_t cb = (uint32_t)root_cb;

  int t = 0;
  for (; t + kChunk <= v0 && cb != absorb; t += kChunk) {
    uint8_t b[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) b[j] = col[(size_t)(t + j) * S];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) cb = c.entry(cb, b[j]) & bmask;
  }
  for (; t < v0 && cb != absorb; ++t) cb = c.entry(cb, col[(size_t)t * S]) & bmask;
  out[s] = (int32_t)cb;
}

}  // namespace

// B10: out int32 [S], the final bases.  Launch on `stream` (a cudaStream_t);
// returns the cudaError_t of the launch; the kernel runs asynchronously.
extern "C" int amt_comb16_contains(const void* streams, int T, int S, const void* vend,
                                   const void* classmap, const void* comb, int comb_words,
                                   const void* aux, int aux_words, const void* root_row,
                                   const void* segtable, int bb, int owner_mask, int root_cb,
                                   int absorb, void* out, void* stream) {
  if (T < 0 || S <= 0 || !amt::comb16_args_ok(comb_words, aux_words, bb, owner_mask, 0, root_cb) ||
      absorb < 0 || absorb >= (1 << bb))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((S + kThreads - 1) / kThreads);
  comb16_contains_kernel<<<grid, kThreads, amt::comb16_smem_bytes(comb_words, aux_words),
                           (cudaStream_t)stream>>>(
      (const uint8_t*)streams, T, S, (const int32_t*)vend, (const int32_t*)classmap,
      (const int32_t*)comb, comb_words, (const int32_t*)aux, aux_words,
      (const int32_t*)root_row, (const int32_t*)segtable, bb, owner_mask, root_cb,
      (uint32_t)absorb, (int32_t*)out);
  return (int)cudaGetLastError();
}
