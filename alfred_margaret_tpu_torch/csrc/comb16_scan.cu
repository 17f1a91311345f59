// B8 comb16_count and B10 comb16_contains: the 16-bit three-tier comb DFA
// scans for Hopper.
//
// Replace the Pallas TPU kernels alfred_margaret_tpu/ops/comb16_scan.py:
// _make_c16_count_kernel (launched from Comb16PallasAcEngine._get_count_fn)
// and _make_c16_contains_kernel (from _get_contains_fn).  They compute what
// those kernels compute, not how: the TPU versions gather 128-lane table rows
// with select chains (or compare chains for the root row and segment table,
// AMT_C16_CHAINS) and split boundary tiles from interior ones; here every
// stream is one thread, the tables (at most 48 rows of 128 words, 26 KB with
// the class map) sit in shared memory, and the lookup of comb16.cuh resolves
// one byte.
//
// B8, per stream s, per step t < vend[s]:
//   e = lookup(cb, streams[t * S + s]);  cb = e & (2^BB - 1)
//   count += count16(e, cb)              while warm[s] <= t
// from cb = root_cb; out[s] = count.  Nothing after vend counts, so the scan
// stops there.
// B10, on the sticky view's tables (CB = 0): the same lookup from root_cb,
// the base held from t = vend[s] on; out[s] = the final base, which is
// `absorb` iff the stream saw a match.  The absorbing base loops to itself,
// so a thread stops reading once it is there.
//
// What bounds them: per step a dependent chain of shared-memory loads (class,
// then comb and segment table, then aux after the segment table), three to
// four deep against B1's two, so the kernels are latency-bound like B1 and
// not bound by device memory.  Stream bytes are loaded kChunk steps ahead
// into registers so that the device-memory loads overlap the chain.  Left
// for later: several streams per thread, and the compare chains of the TPU
// kernel in place of the root and segment loads.

#include <cstdint>
#include <cuda_runtime.h>

#include "comb16.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 16;

__global__ void __launch_bounds__(kThreads) comb16_count_kernel(
    const uint8_t* __restrict__ streams, int T, int S, const int32_t* __restrict__ warm,
    const int32_t* __restrict__ vend, const int32_t* __restrict__ classmap,
    const int32_t* __restrict__ comb, int comb_words, const int32_t* __restrict__ aux,
    int aux_words, const int32_t* __restrict__ root_row, const int32_t* __restrict__ segtable,
    const int32_t* __restrict__ ranges, int bb, int owner_mask, int cbit, int root_cb,
    int32_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const amt::Comb16 c = amt::load_comb16(smem, classmap, comb, comb_words, aux, aux_words,
                                         root_row, segtable, bb, owner_mask);
  __syncthreads();

  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  uint32_t r[amt::kC16Ranges];
#pragma unroll
  for (int i = 0; i < amt::kC16Ranges; ++i) r[i] = (uint32_t)ranges[i];
  const uint32_t bmask = (1u << bb) - 1u;
  const bool counts = cbit != 0;
  const int w0 = warm[s];
  const int v0 = min(vend[s], T);
  const uint8_t* col = streams + s;
  uint32_t cb = (uint32_t)root_cb, count = 0;

  int t = 0;
  for (; t + kChunk <= v0; t += kChunk) {
    uint8_t b[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) b[j] = col[(size_t)(t + j) * S];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const uint32_t e = c.entry(cb, b[j]);
      cb = e & bmask;
      count += (t + j >= w0) ? amt::count16(e, cb, r, counts) : 0u;
    }
  }
  for (; t < v0; ++t) {
    const uint32_t e = c.entry(cb, col[(size_t)t * S]);
    cb = e & bmask;
    count += (t >= w0) ? amt::count16(e, cb, r, counts) : 0u;
  }
  out[s] = (int32_t)count;
}

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

// B8: out int32 [S].  Launch on `stream` (a cudaStream_t); returns the
// cudaError_t of the launch; the kernel runs asynchronously.
extern "C" int amt_comb16_count(const void* streams, int T, int S, const void* warm,
                                const void* vend, const void* classmap, const void* comb,
                                int comb_words, const void* aux, int aux_words,
                                const void* root_row, const void* segtable, const void* ranges,
                                int bb, int owner_mask, int cbit, int root_cb, void* out,
                                void* stream) {
  if (T < 0 || S <= 0 ||
      !amt::comb16_args_ok(comb_words, aux_words, bb, owner_mask, cbit, root_cb))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((S + kThreads - 1) / kThreads);
  comb16_count_kernel<<<grid, kThreads, amt::comb16_smem_bytes(comb_words, aux_words),
                        (cudaStream_t)stream>>>(
      (const uint8_t*)streams, T, S, (const int32_t*)warm, (const int32_t*)vend,
      (const int32_t*)classmap, (const int32_t*)comb, comb_words, (const int32_t*)aux,
      aux_words, (const int32_t*)root_row, (const int32_t*)segtable, (const int32_t*)ranges,
      bb, owner_mask, cbit, root_cb, (int32_t*)out);
  return (int)cudaGetLastError();
}

// B10: out int32 [S], the final bases.  As amt_comb16_count otherwise.
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
